"""The resilience layer's single-card part: fault injection at the
loader and serving seams, transient-I/O retries, the wedge watchdog and the
serving circuit breaker (copies of the JAX package's modules), and the
gateway half of the chaos campaign (``campaign.py``: the cross-process
fleet drills). The training drills and the multi-device resilience are
ROADMAP.md A9."""
