"""The resilience layer's single-card part: the fault-spec grammar and the
inert injector, transient-I/O retries, the wedge watchdog and the serving
circuit breaker (copies of the JAX package's modules). The drills and the
fleet are ROADMAP.md A9."""
