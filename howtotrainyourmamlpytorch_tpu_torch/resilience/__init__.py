"""The resilience layer's single-card part: the fault-spec grammar and the
inert injector, transient-I/O retries and the wedge watchdog (copies of the
JAX package's modules). The drills, the circuit breaker and the fleet are
ROADMAP.md A9."""
