"""The resilience layer: fault injection at the training, loader and
serving seams, transient-I/O retries, the wedge watchdog and the serving
circuit breaker (copies of the JAX package's modules), and the chaos
campaign's training episodes and cross-process fleet drills
(``campaign.py``). ``run_campaign`` with its in-process serve episodes is
ROADMAP.md A9.6, the lock sanitizer A9.7."""
