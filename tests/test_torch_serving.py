"""The port's serving front end against the JAX package's, on the CPU.

- The stdlib copies (cache, batcher, continuous batching, router, breaker):
  the JAX package's tests (``tests/test_serving.py``,
  ``test_serving_fleet.py``, ``test_resilience.py``), each a case per
  package.
- ``support_digest`` (the adaptation id) byte-identical to JAX's.
- ``ServingFrontend`` parity at a small size (VGG with 2 stages and 4
  filters on 14x14x1 images, 5-way 2-shot, K=2; the JAX weights carried
  into the port): the same adaptation ids and cache flags, predictions
  within atol 1e-5 (float32 on both sides, sums in other orders, as in
  ``test_torch_slice.py``), the same ``/metrics`` top-level keys, and the
  same refine guard decisions (commit,
  rollback, quarantine, re-adapt; ``tests/test_sessions_refine.py``).
- The HTTP server end to end on a run directory the port's runner wrote
  (``tests/test_serving.py::test_serve_end_to_end_http``), and the serve
  CLI in a subprocess: adapt, refine, SIGTERM drain, restart, rehydrate.
- The fused update's launch count under concurrent launches; the pool's
  placement over two cards (one clone per card, never per replica) and
  ``clone_for_device`` (``tests/test_serving_fleet.py``), against JAX's
  clone on a second host device.
"""

import contextlib
import dataclasses
import importlib
import json
import os
import queue
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu import config as jcfg
from howtotrainyourmamlpytorch_tpu.core import MAMLSystem as JaxMAMLSystem
from howtotrainyourmamlpytorch_tpu.data.synthetic import synthetic_batch
from howtotrainyourmamlpytorch_tpu.models import build_vgg as jax_build_vgg
from howtotrainyourmamlpytorch_tpu.serving import ServingFrontend as JaxFrontend
from howtotrainyourmamlpytorch_tpu.serving.cache import support_digest as jax_support_digest
from howtotrainyourmamlpytorch_tpu.serving.engine import AdaptationEngine as JaxEngine
from howtotrainyourmamlpytorch_tpu.serving.gateway import rendezvous_score as jax_rendezvous_score
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch import serve
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.core.train_state import TrainState
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentRunner
from howtotrainyourmamlpytorch_tpu_torch.experiment.checkpoint import save_checkpoint
from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg
from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update
from howtotrainyourmamlpytorch_tpu_torch.serving import (
    AdaptationEngine,
    EnginePool,
    ServingFrontend,
    drain_exit_code,
    make_http_server,
    rendezvous_score,
    support_digest,
    tree_bytes,
)
from howtotrainyourmamlpytorch_tpu_torch.serving.errors import SessionQuarantinedError, UnknownAdaptationError
from howtotrainyourmamlpytorch_tpu_torch.serving.metrics import EventCounters
from howtotrainyourmamlpytorch_tpu_torch.utils.interop import state_from_jax
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

from tests.test_torch_runner import runner_config, small_system, toy_dataset  # noqa: F401

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
IMG = (14, 14, 1)
N_WAY = 5

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the stdlib copies: the JAX package's tests, once per package
# ---------------------------------------------------------------------------

PACKAGES = {"jax": "howtotrainyourmamlpytorch_tpu", "torch": "howtotrainyourmamlpytorch_tpu_torch"}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    name = PACKAGES[request.param]
    mod = lambda path: importlib.import_module(f"{name}.{path}")  # noqa: E731
    return types.SimpleNamespace(
        AdaptedWeightCache=mod("serving.cache").AdaptedWeightCache,
        MicroBatcher=mod("serving.batcher").MicroBatcher,
        QueueFullError=mod("serving.batcher").QueueFullError,
        Router=mod("serving.router").Router,
        NoRoutableReplicaError=mod("serving.router").NoRoutableReplicaError,
        ServiceUnavailableError=mod("serving.errors").ServiceUnavailableError,
        CircuitBreaker=mod("resilience.breaker").CircuitBreaker,
        new_request_context=mod("observability.context").new_request_context,
    )


def _tree(kb: int):
    return {"w": np.zeros(kb * 256, np.float32)}  # 1 KiB per 256 f32


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_cache_lru_eviction_under_byte_budget(pkg):
    cache = pkg.AdaptedWeightCache(max_bytes=3 * 1024, ttl_s=0, clock=_FakeClock())
    for name in ("a", "b", "c"):
        cache.put(("ck", name), _tree(1))
    assert len(cache) == 3
    assert cache.get(("ck", "a")) is not None  # refresh a -> b is now LRU
    cache.put(("ck", "d"), _tree(1))
    assert cache.get(("ck", "b")) is None  # evicted
    assert cache.get(("ck", "a")) is not None
    assert cache.get(("ck", "d")) is not None
    stats = cache.stats()
    assert stats["evictions"] == 1
    assert stats["bytes"] <= 3 * 1024
    cache.put(("ck", "huge"), _tree(4))
    assert cache.get(("ck", "huge")) is None


def test_cache_ttl_expiry(pkg):
    clock = _FakeClock()
    cache = pkg.AdaptedWeightCache(max_bytes=1 << 20, ttl_s=10.0, clock=clock)
    cache.put(("ck", "a"), _tree(1))
    clock.t = 5.0
    assert cache.get(("ck", "a")) is not None
    clock.t = 16.0
    assert cache.get(("ck", "a")) is None
    assert cache.stats()["expirations"] == 1


def test_batcher_flushes_at_max_batch(pkg):
    seen = []

    def flush(bucket, payloads):
        seen.append((bucket, list(payloads)))
        return [p * 10 for p in payloads]

    b = pkg.MicroBatcher(flush, max_batch=3, deadline_ms=60_000, name="t")
    try:
        futs = [b.submit("k", i) for i in range(3)]
        assert [f.result(5.0) for f in futs] == [0, 10, 20]
        assert [p for _, p in seen] == [[0, 1, 2]]
        stats = b.stats()
        assert stats["flushes_full"] == 1
        assert stats["flushes_deadline"] == 0
        assert stats["batched_requests"] == 3
    finally:
        b.close()


def test_batcher_splits_oversize_group_at_max_batch(pkg):
    seen = []
    release = threading.Event()

    def flush(bucket, payloads):
        release.wait(5.0)
        seen.append(list(payloads))
        return payloads

    b = pkg.MicroBatcher(flush, max_batch=2, deadline_ms=5, name="t")
    try:
        futs = [b.submit("k", i) for i in range(5)]
        release.set()
        assert [f.result(5.0) for f in futs] == list(range(5))
        assert all(len(batch) <= 2 for batch in seen)
        assert [p for batch in seen for p in batch] == list(range(5))
    finally:
        b.close()


def test_batcher_deadline_flush_and_bucket_isolation(pkg):
    seen = []

    def flush(bucket, payloads):
        seen.append((bucket, list(payloads)))
        return payloads

    b = pkg.MicroBatcher(flush, max_batch=64, deadline_ms=20, name="t")
    try:
        f1 = b.submit("small", "x")
        f2 = b.submit("large", "y")
        assert f1.result(5.0) == "x"
        assert f2.result(5.0) == "y"
        assert sorted(bucket for bucket, _ in seen) == ["large", "small"]
        assert b.stats()["flushes_deadline"] == 2
    finally:
        b.close()


def test_batcher_flush_error_fails_futures(pkg):
    def flush(bucket, payloads):
        raise RuntimeError("device on fire")

    b = pkg.MicroBatcher(flush, max_batch=4, deadline_ms=5, name="t")
    try:
        fut = b.submit("k", 1)
        with pytest.raises(RuntimeError, match="device on fire"):
            fut.result(5.0)
    finally:
        b.close()


def test_batcher_close_drains_queue(pkg):
    b = pkg.MicroBatcher(lambda bucket, payloads: payloads, max_batch=64, deadline_ms=60_000, name="t")
    fut = b.submit("k", 7)
    b.close()
    assert fut.result(1.0) == 7


def test_batcher_sheds_beyond_max_queue_depth(pkg):
    entered, release = threading.Event(), threading.Event()

    def flush(bucket, payloads):
        entered.set()
        release.wait(5.0)
        return payloads

    b = pkg.MicroBatcher(flush, max_batch=1, deadline_ms=0, max_queue_depth=2, name="t")
    try:
        futs = [b.submit("k", 0)]
        assert entered.wait(5.0)
        futs += [b.submit("k", 1), b.submit("k", 2)]
        assert b.queue_depth() == 2
        with pytest.raises(pkg.QueueFullError):
            b.submit("k", 99)
        assert b.stats()["shed"] == 1
        release.set()
        assert [f.result(5.0) for f in futs] == [0, 1, 2]
    finally:
        release.set()
        b.close()


def test_batcher_worker_survives_cancelled_futures(pkg):
    entered, release = threading.Event(), threading.Event()

    def flush(bucket, payloads):
        entered.set()
        release.wait(5.0)
        return payloads

    b = pkg.MicroBatcher(flush, max_batch=1, deadline_ms=0, name="t")
    try:
        inflight = b.submit("k", 1)
        assert entered.wait(5.0)
        queued = b.submit("k", 2)
        assert queued.cancel()
        assert inflight.cancel()
        release.set()
        assert b.submit("k", 3).result(5.0) == 3
    finally:
        release.set()
        b.close()


class _GatedFlush:
    """flush_fn whose completion the test controls."""

    def __init__(self):
        self.entered = queue.Queue()
        self.permits = queue.Queue()
        self.sizes = []

    def __call__(self, bucket, payloads):
        self.sizes.append(len(payloads))
        self.entered.put(len(payloads))
        self.permits.get(timeout=5)
        return payloads


def test_continuous_batching_grows_flushes_toward_max_batch(pkg):
    gate = _GatedFlush()
    b = pkg.MicroBatcher(gate, max_batch=4, deadline_ms=5, name="t", continuous=True)
    try:
        ctx0 = pkg.new_request_context()
        f0 = b.submit("k", 0, ctx=ctx0)
        gate.entered.get(timeout=5)
        ctxs = [pkg.new_request_context() for _ in range(3)]
        futs = [b.submit("k", i + 1, ctx=c) for i, c in enumerate(ctxs)]
        gate.permits.put(None)
        assert gate.entered.get(timeout=5) == 3
        ctxs2 = [pkg.new_request_context() for _ in range(6)]
        futs2 = [b.submit("k", 10 + i, ctx=c) for i, c in enumerate(ctxs2)]
        gate.permits.put(None)
        assert gate.entered.get(timeout=5) == 4
        gate.permits.put(None)
        assert gate.entered.get(timeout=5) == 2
        gate.permits.put(None)
        assert [f.result(5) for f in [f0] + futs + futs2] == [0, 1, 2, 3] + list(range(10, 16))
        assert gate.sizes == [1, 3, 4, 2]
        stats = b.stats()
        assert (stats["flushes_deadline"], stats["flushes_full"], stats["flushes_continuous"]) == (1, 1, 2)
        assert ctx0.flush_batch == 1
        assert all(c.flush_batch == 3 for c in ctxs)
        assert sorted(c.flush_batch for c in ctxs2) == [2, 2, 4, 4, 4, 4]
        assert all(c.queue_wait_s is not None and c.queue_wait_s >= 0.0 for c in [ctx0] + ctxs + ctxs2)
    finally:
        gate.permits.put(None)
        b.close()


def test_continuous_batching_preserves_deadline_for_stragglers(pkg):
    gate = _GatedFlush()
    b = pkg.MicroBatcher(gate, max_batch=8, deadline_ms=40, name="t", continuous=True)
    try:
        f0 = b.submit("k", 0)
        gate.entered.get(timeout=5)
        gate.permits.put(None)
        assert f0.result(5) == 0
        t0 = time.monotonic()
        f1 = b.submit("k", 1)
        gate.entered.get(timeout=5)
        waited = time.monotonic() - t0
        gate.permits.put(None)
        assert f1.result(5) == 1
        assert waited >= 0.03, f"straggler flushed after {waited}s (< deadline)"
        assert b.stats()["flushes_deadline"] == 2
        assert b.stats()["flushes_continuous"] == 0
    finally:
        b.close()


class _FakeReplica:
    def __init__(self, index):
        self.index = index
        self.alive = True
        self.queued = 0

    def routable(self):
        return self.alive

    def load(self):
        return self.queued


def test_router_rendezvous_affinity_and_minimal_remap(pkg):
    replicas = [_FakeReplica(i) for i in range(3)]
    router = pkg.Router(replicas)
    keys = [f"digest{i:03d}" for i in range(240)]
    owners = {k: router.route(k).index for k in keys}
    assert set(owners.values()) == {0, 1, 2}
    assert all(router.route(k).index == owners[k] for k in keys)
    replicas[1].alive = False
    remapped = {k: router.route(k).index for k in keys}
    assert all(remapped[k] == owners[k] for k in keys if owners[k] != 1)
    assert all(remapped[k] != 1 for k in keys)
    assert router.stats()["routed_around"] >= sum(1 for v in owners.values() if v == 1)
    replicas[1].alive = True
    assert all(router.route(k).index == owners[k] for k in keys)


def test_router_admission_shed_429_and_full_outage_503(pkg):
    replicas = [_FakeReplica(0), _FakeReplica(1)]
    router = pkg.Router(replicas, max_queued_per_replica=2)
    target = router.route("session-a")
    target.queued = 2
    with pytest.raises(pkg.ServiceUnavailableError) as exc_info:
        router.admit(target)
    assert exc_info.value.status == 429
    assert exc_info.value.retry_after_s > 0
    assert router.stats()["router_shed"] == 1
    target.queued = 1
    router.admit(target)
    for r in replicas:
        r.alive = False
    with pytest.raises(pkg.NoRoutableReplicaError) as exc_info:
        router.route("session-a")
    assert exc_info.value.status == 503


def test_circuit_breaker_state_machine_fake_clock(pkg):
    t = {"now": 0.0}
    b = pkg.CircuitBreaker(failure_threshold=3, cooldown_s=10.0, half_open_probes=1, clock=lambda: t["now"])
    assert b.state == "closed" and b.allow()
    b.record_failure(); b.record_failure(); b.record_success()  # noqa: E702
    b.record_failure(); b.record_failure()  # noqa: E702
    assert b.state == "closed"
    b.record_failure()
    assert b.state == "open" and not b.allow() and b.opens == 1
    t["now"] = 9.0
    assert not b.allow()
    t["now"] = 11.0
    assert b.state == "half_open"
    assert b.allow()
    assert not b.allow()
    b.record_failure()
    assert b.state == "open" and b.opens == 2
    t["now"] = 22.0
    assert b.allow()
    b.record_success()
    assert b.state == "closed" and b.allow()
    snap = b.snapshot()
    assert snap["state"] == "closed" and snap["opens"] == 2 and snap["rejections"] >= 2


def test_breaker_released_probe_slot_is_not_leaked(pkg):
    t = {"now": 0.0}
    b = pkg.CircuitBreaker(failure_threshold=1, cooldown_s=5.0, half_open_probes=1, clock=lambda: t["now"])
    b.record_failure()
    t["now"] = 6.0
    probe = b.allow()
    assert probe and probe.probe
    assert not b.allow()
    b.release_probe(probe)
    assert b.allow()
    b.record_success()
    assert b.state == "closed"
    permit = b.allow()
    assert permit and not permit.probe
    b.release_probe(permit)
    assert b.state == "closed" and b.allow()


def test_breaker_stale_permit_cannot_release_anothers_probe_slot(pkg):
    t = {"now": 0.0}
    b = pkg.CircuitBreaker(failure_threshold=1, cooldown_s=5.0, half_open_probes=1, clock=lambda: t["now"])
    stale = b.allow()
    assert stale and not stale.probe
    b.record_failure()
    t["now"] = 6.0
    probe = b.allow()
    assert probe and probe.probe
    b.release_probe(stale)
    assert not b.allow()
    b.record_failure()
    t["now"] = 12.0
    probe2 = b.allow()
    assert probe2 and probe2.generation != probe.generation
    b.release_probe(probe)
    assert not b.allow()
    b.record_success()
    assert b.state == "closed"


def test_breaker_stale_verdicts_cannot_move_half_open_probe_state(pkg):
    t = {"now": 0.0}
    b = pkg.CircuitBreaker(failure_threshold=1, cooldown_s=5.0, half_open_probes=1, clock=lambda: t["now"])
    stale = b.allow()
    assert stale and not stale.probe
    b.record_failure()
    t["now"] = 6.0
    probe = b.allow()
    assert probe and probe.probe
    b.record_success(stale)
    assert b.state == "half_open"
    b.record_failure(stale)
    assert b.state == "half_open" and b.opens == 1
    b.record_timeout(stale)
    assert b.state == "half_open"
    assert b.snapshot()["consecutive_timeouts"] == 0
    b.record_success(probe)
    assert b.state == "closed"


def test_breaker_timeouts_trip_under_their_own_threshold(pkg):
    t = {"now": 0.0}
    b = pkg.CircuitBreaker(failure_threshold=5, timeout_threshold=3, cooldown_s=10.0, half_open_probes=1,
                           clock=lambda: t["now"])
    for _ in range(2):
        b.record_timeout(b.allow())
    b.allow()
    b.record_success()
    for _ in range(2):
        b.record_timeout(b.allow())
    assert b.state == "closed"
    b.record_timeout(b.allow())
    assert b.state == "open" and b.opens == 1
    snap = b.snapshot()
    assert snap["timeouts"] == 5 and snap["consecutive_timeouts"] == 0
    t["now"] = 11.0
    probe = b.allow()
    assert probe and probe.probe
    b.record_timeout(probe)
    assert b.state == "open" and b.opens == 2
    t["now"] = 22.0
    assert b.allow()
    b.record_success()
    assert b.state == "closed"


def test_tree_bytes_counts_tensor_and_array_leaves():
    tree = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5, dtype=torch.bfloat16)}, "d": np.zeros(7, np.float64)}
    assert tree_bytes(tree) == 48 + 10 + 56


# ---------------------------------------------------------------------------
# the adaptation id and the routing key: byte-identical to JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["maml++", "fomaml", "anil", "protonet"])
def test_support_digest_matches_jax(strategy):
    batch = synthetic_batch(1, N_WAY, 2, 1, IMG, seed=3)
    x, y = AdaptationEngine._flatten_support(batch["x_support"][0], batch["y_support"][0])
    jx, jy = JaxEngine._flatten_support(batch["x_support"][0], batch["y_support"][0])
    assert (x.dtype, y.dtype) == (jx.dtype, jy.dtype)
    for steps in (2, 5):
        assert support_digest(x, y, steps, strategy) == jax_support_digest(jx, jy, steps, strategy)
    assert support_digest(x, y, 2, strategy, tenant="t1") == jax_support_digest(jx, jy, 2, strategy, tenant="t1")
    assert support_digest(x, y, 2, strategy) != support_digest(x, y, 3, strategy)


def test_rendezvous_score_matches_jax():
    for key in ("a", "digest-0123", "f" * 64):
        for replica in range(4):
            assert rendezvous_score(key, replica) == jax_rendezvous_score(key, replica)


# ---------------------------------------------------------------------------
# the frontend against JAX's, on the same weights
# ---------------------------------------------------------------------------


def _cfg(module, **serving):
    return module.Config(
        num_classes_per_set=N_WAY,
        num_samples_per_class=2,
        num_target_samples=3,
        batch_size=2,
        number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=2,
        use_pallas_inner_update=True,
        serving=module.ServingConfig(support_buckets=[16], query_buckets=[16], max_batch_size=2, **serving),
    )


@pytest.fixture(scope="module")
def weights():
    """The JAX system and state at the small size, and the port's copy."""
    cfg = _cfg(jcfg)
    jsystem = JaxMAMLSystem(cfg, model=jax_build_vgg(IMG, N_WAY, num_stages=2, cnn_num_filters=4))
    jstate = jsystem.init_train_state()
    system = port_system()
    params, bn_state, hparams = state_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.bn_state),
        jax.tree.map(np.asarray, jstate.inner_hparams),
        system.model.feature_shape,
    )
    return jsystem, jstate, TrainState(params, bn_state, hparams, None, torch.zeros((), dtype=torch.int64))


def port_system(**serving):
    return MAMLSystem(_cfg(tcfg, **serving), model=build_vgg(IMG, N_WAY, num_stages=2, cnn_num_filters=4),
                      device="cpu")


def jax_frontend(weights, save_dir=None, **serving):
    """The JAX frontend over ``weights``; with ``save_dir`` it spills and
    rehydrates sessions there."""
    jsystem, jstate, _ = weights
    engine = JaxEngine(jsystem, jstate, serving_cfg=_cfg(jcfg, **serving).serving)
    if save_dir is not None:
        engine.save_dir = str(save_dir)
    return JaxFrontend(engine)


def port_frontend(weights, save_dir=None, **serving):
    """The port's frontend over the same weights, as :func:`jax_frontend`."""
    engine = AdaptationEngine(port_system(**serving), weights[2], serving_cfg=_cfg(tcfg, **serving).serving)
    if save_dir is not None:
        engine.save_dir = str(save_dir)
    return ServingFrontend(engine)


def frontends(weights, **serving):
    """(JAX frontend, port frontend) over the same weights and serving config."""
    return jax_frontend(weights, **serving), port_frontend(weights, **serving)


def episode(seed):
    batch = synthetic_batch(1, N_WAY, 2, 3, IMG, seed=seed)
    return batch["x_support"][0], batch["y_support"][0], batch["x_target"][0].reshape((-1,) + IMG)


def test_frontend_matches_jax(weights):
    jfront, front = frontends(weights)
    try:
        for seed in (1, 2):
            x_s, y_s, x_q = episode(seed)
            for _ in range(2):  # a fresh adapt, then a cache hit
                got, want = front.adapt(x_s, y_s), jfront.adapt(x_s, y_s)
                assert (got["adaptation_id"], got["cached"]) == (want["adaptation_id"], want["cached"])
                assert got["support_size"] == want["support_size"]
            np.testing.assert_allclose(
                front.predict(got["adaptation_id"], x_q), np.asarray(jfront.predict(want["adaptation_id"], x_q)),
                rtol=0, atol=ATOL,
            )
        x_s, y_s, x_q = episode(3)
        got, want = front.adapt_predict(x_s, y_s, x_q), jfront.adapt_predict(x_s, y_s, x_q)
        assert (got["adaptation_id"], got["cached"]) == (want["adaptation_id"], want["cached"])
        np.testing.assert_allclose(got["probs"], np.asarray(want["probs"]), rtol=0, atol=ATOL)
        for f in (front, jfront):
            with pytest.raises(UnknownAdaptationError if f is front else Exception, match="nope"):
                f.predict("nope", x_q)
            with pytest.raises(ValueError, match="tenant"):
                f.adapt(x_s, y_s, tenant="t1")
            assert f.adapt(x_s, y_s, tenant="default")["cached"]
        metrics, jmetrics = front.metrics(), jfront.metrics()
        assert set(metrics) == set(jmetrics)
        for key in ("cache", "adapt_batcher", "predict_batcher", "padding"):
            assert metrics[key] == jmetrics[key], key
        assert metrics["compiled"]["fused_sgd_launches"] == 0  # the CPU runs the twin
        health, jhealth = front.healthz(), jfront.healthz()
        assert set(health) == set(jhealth)
        assert (health["status"], health["platform"]) == ("ok", "cpu")
        assert "htymp_serving_latency" in front.metrics_prometheus()
    finally:
        front.close()
        jfront.close()


def test_refine_guard_decisions_match_jax(weights):
    """The JAX ladder (``tests/test_sessions_refine.py``) with a poisoned
    refinement made by NaN support images instead of the fault injector
    (its drills are not ported): commit, rollback with the cache untouched,
    quarantine (409 on refine and predict), re-adapt, commit."""
    jfront, front = frontends(weights, refine_enabled=True, refine_quarantine_after=2, refine_regress_tol=100.0)
    x_s, y_s, x_q = episode(1)
    poisoned = np.full_like(x_s, np.nan)

    def both(call):
        out = []
        for f in (jfront, front):
            try:
                out.append(call(f))
            except Exception as exc:  # noqa: BLE001 — the decision is compared
                out.append(type(exc).__name__)
        return out

    def decision(r):
        return r if isinstance(r, str) else (r["rolled_back"], r["refine_count"], r["consecutive_regressions"])

    try:
        assert both(lambda f: f.refine("no-such-session", x_s, y_s)) == ["UnknownAdaptationError"] * 2
        sid = front.adapt(x_s, y_s)["adaptation_id"]
        assert jfront.adapt(x_s, y_s)["adaptation_id"] == sid
        want, got = both(lambda f: f.refine(sid, x_s, y_s))
        assert decision(got) == decision(want) == (False, 1, 0)
        assert got["score"] == pytest.approx(want["score"], abs=ATOL)
        good = front.predict(sid, x_q)
        want, got = both(lambda f: f.refine(sid, poisoned, y_s))
        assert decision(got) == decision(want) == (True, 1, 1)
        assert got["score"] is None and want["score"] is None
        np.testing.assert_array_equal(front.predict(sid, x_q), good)
        assert both(lambda f: f.refine(sid, poisoned, y_s)) == ["SessionQuarantinedError"] * 2
        assert both(lambda f: f.predict(sid, x_q)) == ["SessionQuarantinedError"] * 2
        with pytest.raises(SessionQuarantinedError) as exc_info:
            front.refine(sid, x_s, y_s)
        assert exc_info.value.status == 409
        with pytest.raises(Exception, match="quarantined"):
            jfront.refine(sid, x_s, y_s)
        want, got = both(lambda f: f.adapt(x_s, y_s))
        assert (got["adaptation_id"], got["cached"]) == (want["adaptation_id"], want["cached"]) == (sid, False)
        np.testing.assert_allclose(front.predict(sid, x_q), np.asarray(jfront.predict(sid, x_q)), rtol=0, atol=ATOL)
        want, got = both(lambda f: f.refine(sid, x_s, y_s))
        assert decision(got) == decision(want) == (False, 1, 0)
        np.testing.assert_allclose(front.predict(sid, x_q), np.asarray(jfront.predict(sid, x_q)), rtol=0, atol=ATOL)
        refine, jrefine = front.metrics()["sessions"]["refine"], jfront.metrics()["sessions"]["refine"]
        assert refine == jrefine
        assert (refine["refines"], refine["rollbacks"], refine["quarantines"], refine["readapts"]) == (2, 2, 1, 1)
        assert set(front.metrics()) == set(jfront.metrics())
        assert "refine_programs" in front.metrics()["compiled"]
    finally:
        front.close()
        jfront.close()


def test_refine_disabled_is_a_client_error(weights):
    front = ServingFrontend(AdaptationEngine(port_system(), weights[2]))
    try:
        x_s, y_s, _ = episode(6)
        with pytest.raises(ValueError, match="refine_enabled"):
            front.refine("x", x_s, y_s)
        assert "refine_batcher" not in front.metrics()
        assert "refine_programs" not in front.metrics()["compiled"]
    finally:
        front.close()


# ---------------------------------------------------------------------------
# the HTTP server end to end
# ---------------------------------------------------------------------------


def _call(base, path, payload=None, raw=None):
    data = raw if raw is not None else (None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(base + path, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        body = resp.read()
    return body if path.endswith("format=prom") else json.loads(body)


def _status(base, path, payload=None, raw=None) -> int:
    try:
        _call(base, path, payload, raw)
    except urllib.error.HTTPError as exc:
        return exc.code
    return 200


@pytest.fixture(scope="module")
def trained_run(toy_dataset, tmp_path_factory):  # noqa: F811 — the runner tests' fixture
    """A run directory the port's runner wrote (3-way, 2-stage VGG)."""
    cfg = runner_config(toy_dataset, tmp_path_factory.mktemp("serve_run"), total_epochs=1)
    system = small_system(cfg)
    runner = ExperimentRunner(cfg, system=system)
    runner.run_experiment()
    return cfg, system, runner


def test_serve_end_to_end_http(trained_run):
    cfg, system, runner = trained_run
    frontend = serve.build_frontend(runner.run_dir, checkpoint="best", system=system,
                                    overrides=["serving.refine_enabled=true"])
    server = make_http_server(frontend, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        health = _call(base, "/healthz")
        assert (health["status"], health["platform"]) == ("ok", "cpu")
        assert health["checkpoint_fingerprint"] == frontend.engine.fingerprint
        n_way, img = cfg.num_classes_per_set, cfg.image_shape
        batch = synthetic_batch(1, n_way, 2, 2, img, seed=5)
        x_s, y_s = batch["x_support"][0].tolist(), batch["y_support"][0].tolist()
        x_q = batch["x_target"][0].reshape((-1,) + img)

        adapt1 = _call(base, "/adapt", {"x_support": x_s, "y_support": y_s})
        assert adapt1["cached"] is False
        x_flat, y_flat = AdaptationEngine._flatten_support(x_s, y_s)
        assert adapt1["adaptation_id"] == support_digest(x_flat, y_flat, frontend.engine.num_steps, "maml++")
        assert set(adapt1["timing"]) >= {"queue_wait_ms", "dispatch_ms", "total_ms"}
        pred = _call(base, "/predict", {"adaptation_id": adapt1["adaptation_id"], "x_query": x_q.tolist()})
        probs = np.asarray(pred["probs"], np.float32)
        assert probs.shape == (n_way * 2, n_way)
        np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
        # the served predictions are eval_step's target probabilities of the
        # state the runner left loaded (the best checkpoint's)
        out = system.eval_step(runner.state, batch)
        ref = torch.softmax(out.per_task_target_logits[0], -1).numpy()
        np.testing.assert_allclose(probs, ref, atol=ATOL)

        adapt2 = _call(base, "/adapt", {"x_support": x_s, "y_support": y_s})
        assert (adapt2["cached"], adapt2["adaptation_id"]) == (True, adapt1["adaptation_id"])
        refined = _call(base, "/adapt", {"refine": True, "session_id": adapt1["adaptation_id"],
                                         "x_support": x_s, "y_support": y_s})
        assert refined["refined"] and refined["refine_count"] in (0, 1)
        both = _call(base, "/adapt_predict", {"x_support": x_s[::-1], "y_support": y_s[::-1],
                                              "x_query": x_q.tolist()})
        assert both["cached"] is False and np.asarray(both["probs"]).shape == probs.shape

        metrics = _call(base, "/metrics")
        assert metrics["cache"]["hits"] >= 1 and metrics["cache"]["misses"] >= 1
        assert "adapt_cached" in metrics["latency"]
        assert metrics["adapt_batcher"]["flushes"] == 2 and metrics["refine_batcher"]["flushes"] == 1
        assert b"htymp_serving_latency" in _call(base, "/metrics?format=prom")

        assert _status(base, "/predict", {"adaptation_id": "deadbeef", "x_query": x_q.tolist()}) == 404
        assert _status(base, "/adapt", {"x_support": x_s}) == 400  # no labels
        assert _status(base, "/adapt", raw=b"{not json") == 400
        assert _status(base, "/adapt", {"x_support": x_s, "y_support": y_s, "strategy": "nope"}) == 400
        assert _status(base, "/nowhere", {}) == 404
        assert _status(base, "/nowhere") == 404

        info = frontend.begin_drain(reason="test")
        assert drain_exit_code(info) == 0 and info["spilled_sessions"] == 2
        assert _status(base, "/adapt", {"x_support": x_s, "y_support": y_s}) == 503
        assert _status(base, "/healthz") == 503
    finally:
        server.shutdown()
        server.server_close()
        frontend.close()
        thread.join(timeout=5)
    again = serve.build_frontend(runner.run_dir, checkpoint="best", system=system,
                                 overrides=["serving.refine_enabled=true"])
    try:
        assert again.metrics()["sessions"]["rehydrated"] == 2
        assert again.adapt(x_s, y_s)["cached"] is True
    finally:
        again.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_cli_drains_on_sigterm_and_rehydrates(tmp_path):
    """``python -m howtotrainyourmamlpytorch_tpu_torch.serve`` on a run
    directory of the full-width VGG at 3-way: adapt, refine, SIGTERM (rc 0,
    the sessions spilled), restart (rehydrated, a cache hit)."""
    cfg = tcfg.load_config(None, ["num_classes_per_set=3", "num_samples_per_class=2",
                                  "number_of_evaluation_steps_per_iter=2"])
    system = MAMLSystem(cfg, device="cpu")
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    tcfg.save_config(cfg, os.path.join(run_dir, "config.yaml"))
    save_checkpoint(os.path.join(run_dir, "saved_models"), system.init_train_state(seed=0), {"epoch": 0}, epoch=0,
                    feature_shape=system.model.feature_shape)
    batch = synthetic_batch(1, 3, 2, 1, cfg.image_shape, seed=0)
    support = {"x_support": batch["x_support"][0].tolist(), "y_support": batch["y_support"][0].tolist()}
    env = dict(os.environ, PYTHONPATH=_ROOT, OMP_NUM_THREADS="2")

    def start():
        port = _free_port()
        proc = subprocess.Popen(
            [sys.executable, "-m", "howtotrainyourmamlpytorch_tpu_torch.serve", run_dir, "--device", "cpu",
             "--port", str(port), "--checkpoint", "latest", "serving.refine_enabled=true"],
            cwd=_ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 120
        while _status_or_none(base) != 200:
            assert proc.poll() is None and time.monotonic() < deadline, proc.communicate()[0]
            time.sleep(0.2)
        return proc, base

    proc, base = start()
    try:
        adapted = _call(base, "/adapt", support)
        sid = adapted["adaptation_id"]
        assert _call(base, "/adapt", {**support, "refine": True, "session_id": sid})["refined"]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "1 session(s) spilled" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    proc, base = start()
    try:
        assert _call(base, "/metrics")["sessions"]["rehydrated"] == 1
        again = _call(base, "/adapt", support)
        assert (again["adaptation_id"], again["cached"]) == (sid, True)
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=60)


def _status_or_none(base):
    try:
        return _status(base, "/healthz")
    except OSError:
        return None


# ---------------------------------------------------------------------------
# the kernel's launch count under threads; the pool over two cards
# ---------------------------------------------------------------------------


def test_launch_counts_are_exact_under_concurrent_launches(monkeypatch):
    """Batcher workers launch B1 from several threads: every launch counts
    once. The launch itself is replaced (no card here); the count is the
    wrapper's."""
    lib = types.SimpleNamespace(fused_sgd_forward=lambda *args: 0)
    monkeypatch.setattr(fused_update, "_library", lambda source, device: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: types.SimpleNamespace(cuda_stream=0))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    ps, gs = [torch.zeros(4)], [torch.zeros(4)]
    lrs = [torch.tensor(0.1)]
    threads, per_thread = 8, 400
    fused_update.reset_launch_counts()
    try:
        workers = [threading.Thread(target=lambda: [fused_update._launch_forward(ps, gs, lrs)
                                                    for _ in range(per_thread)]) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
    finally:
        sys.setswitchinterval(old)
    assert fused_update.launch_counts["fused_sgd"] == threads * per_thread
    fused_update.reset_launch_counts()
    assert fused_update.launch_counts == {"fused_sgd": 0, "fused_sgd_bwd": 0}


class _StubEngine(types.SimpleNamespace):
    """An engine of the pool tests: records its clones instead of building
    a system on a card."""

    def clone_for_device(self, device, index):
        clone = _StubEngine(device=device, pager=None, clones=[])
        self.clones.append((device, index, clone))
        return clone


def test_pool_refuses_a_replica_on_a_second_card(monkeypatch):
    """A replica on a second card is no longer refused: it gets a clone of
    the engine there (the visible cards are the default device list)."""
    cfg = tcfg.Config()
    engine = _StubEngine(device=torch.device("cuda", 0), pager=None, clones=[])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    args = dict(serving_cfg=cfg.serving, resilience_cfg=cfg.resilience, counters=EventCounters())
    pool = EnginePool.build(engine, 2, **args)
    try:
        (device, index, clone), = engine.clones
        assert (device, index) == (torch.device("cuda", 1), 1)
        assert [r.engine for r in pool.replicas] == [engine, clone]
        assert pool.engines() == [engine, clone] and pool.pager_stats() is None
    finally:
        pool.close()
    pool = EnginePool.build(engine, 1, **args)  # one replica on the engine's card
    try:
        assert len(pool) == 1 and pool.replicas[0].engine is engine
    finally:
        pool.close()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    pool = EnginePool.build(engine, 2, **args)  # two replicas share the one card's engine
    try:
        assert [r.engine for r in pool.replicas] == [engine, engine] and len(engine.clones) == 1
    finally:
        pool.close()


def test_pool_shares_one_engine_per_device(monkeypatch):
    """More replicas than cards: every replica landing on an already-engined
    card reuses its engine — one clone per card, never one per replica
    (``tests/test_serving_fleet.py``). The engine's device without an index
    (what ``resolve_device`` returns) is the current card, not a second
    one."""
    cfg = tcfg.Config()
    args = dict(serving_cfg=cfg.serving, resilience_cfg=cfg.resilience, counters=EventCounters())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    devices = [torch.device("cuda", 0), torch.device("cuda", 1)]
    engine = _StubEngine(device=torch.device("cuda"), pager=None, clones=[])
    pool = EnginePool.build(engine, 5, devices=devices, **args)
    try:
        (device, index, clone), = engine.clones
        assert (device, index) == (torch.device("cuda", 1), 1)
        assert [r.engine for r in pool.replicas] == [engine, clone, engine, clone, engine]
        assert len(pool.engines()) == 2
    finally:
        pool.close()
    pool = EnginePool.build(engine, 0, devices=devices, **args)  # 0 = one replica per card
    try:
        assert len(pool) == 2 and pool.replicas[0].engine is engine
    finally:
        pool.close()


def test_clone_for_device_parity(weights):
    """A clone of the engine on another device serves the same predictions
    as the engine, through its own system, with the engine's fingerprint,
    injector, tracer and registry and a pager of its own; JAX's clone on a
    second host device answers alike (atol 1e-5)."""
    from howtotrainyourmamlpytorch_tpu_torch.serving.registry import synthetic_registry

    jsystem, jstate, state = weights
    system = port_system()
    full = system.init_train_state()._replace(params=state.params, bn_state=state.bn_state,
                                              inner_hparams=state.inner_hparams)
    x_s, y_s, x_q = episode(2)
    with tempfile.TemporaryDirectory() as root:
        registry = synthetic_registry(["acme"], full, root, feature_shape=system.model.feature_shape)
        engine = AdaptationEngine(system, state, registry=registry)
        clone = engine.clone_for_device(torch.device("cpu"), 1)
        assert clone.ledger_tag == "@r1" and clone.system is not engine.system
        assert (clone.fingerprint, clone.injector, clone.tracer, clone.registry) == (
            engine.fingerprint, engine.injector, engine.tracer, engine.registry)
        assert clone.pager is not engine.pager and clone.pager.template is clone.state
        assert all(leaf.device == clone.device for leaf in tree_leaves(clone.state.params))
        fw = engine.adapt(x_s, y_s)
        probs = engine.predict(fw, x_q)
        np.testing.assert_array_equal(clone.predict(fw, x_q), probs)
        np.testing.assert_array_equal(clone.predict(clone.adapt(x_s, y_s, tenant="acme"), x_q, tenant="acme"),
                                      engine.predict(engine.adapt(x_s, y_s, tenant="acme"), x_q, tenant="acme"))
        assert clone.pager.stats()["page_ins"] == engine.pager.stats()["page_ins"] == 1
    jengine = JaxEngine(jsystem, jstate, serving_cfg=_cfg(jcfg).serving)
    jclone = jengine.clone_for_device(jax.local_devices()[1], 1)
    np.testing.assert_allclose(np.asarray(jclone.predict(jclone.adapt(x_s, y_s), x_q)), probs, rtol=0, atol=ATOL)


def test_frontend_refuses_unported_options(weights):
    cfg = _cfg(tcfg)
    for patch, item in ((dict(aot=dataclasses.replace(cfg.aot, enabled=True)), "A10"),
                        (dict(resilience=dataclasses.replace(cfg.resilience, sanitizer=True)), "A9")):
        engine = AdaptationEngine(MAMLSystem(dataclasses.replace(cfg, **patch),
                                             model=build_vgg(IMG, N_WAY, num_stages=2, cnn_num_filters=4),
                                             device="cpu"), weights[2])
        with pytest.raises(NotImplementedError, match=item):
            ServingFrontend(engine)


def test_adapted_trees_own_their_memory(weights):
    """Each request's adapted tree from a flush holds only its own bytes:
    a view of the flush's stack would keep the whole flush alive in the
    cache, past ``cache_max_bytes`` (``tree_bytes`` counts the view)."""
    engine = AdaptationEngine(port_system(), weights[2])
    items = [episode(seed)[:2] for seed in (1, 2)]
    for trees in (engine.adapt_batch(items), engine.refine_batch([(fw, x, y) for fw, (x, y) in
                                                                    zip(engine.adapt_batch(items), items)])):
        for tree in trees:
            for leaf in tree_leaves(tree):
                assert leaf.untyped_storage().nbytes() == leaf.numel() * leaf.element_size()
        assert sum(leaf.untyped_storage().nbytes() for leaf in tree_leaves(trees[0])) == tree_bytes(trees[0])
