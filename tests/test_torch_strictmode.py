"""The port's strict mode (``utils/strictmode.py``) against the JAX
package's, on the CPU: every test of ``tests/test_strictmode.py``, the
guard's pure-Python cases run on both packages' ``RecompileGuard``, the
planned program sets equal to JAX's over a grid of serving and train
configs, the same guard keys as JAX's engine and system on the same
traffic, and the serving prewarm (``AdaptationEngine.prewarm``).

``wrap`` is the one place where the meaning differs: JAX's counts
lowerings of a jitted function, the port's counts first calls per abstract
signature (the first dispatch of a shape in eager torch), so its tests run
on the port alone, against a plain function.
"""

import dataclasses

import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu import config as jcfg
from howtotrainyourmamlpytorch_tpu.core import MAMLSystem as JaxMAMLSystem
from howtotrainyourmamlpytorch_tpu.data.synthetic import synthetic_batch
from howtotrainyourmamlpytorch_tpu.models import build_vgg as jax_build_vgg
from howtotrainyourmamlpytorch_tpu.serving.engine import AdaptationEngine as JaxEngine
from howtotrainyourmamlpytorch_tpu.utils import strictmode as jsm
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg
from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine
from howtotrainyourmamlpytorch_tpu_torch.serving.server import ServingFrontend
from howtotrainyourmamlpytorch_tpu_torch.utils import strictmode as tsm
from howtotrainyourmamlpytorch_tpu_torch.utils.interop import state_from_jax
from howtotrainyourmamlpytorch_tpu_torch.utils.strictmode import (
    RecompileBudgetExceededError,
    RecompileGuard,
    abstract_signature,
    serving_planned_programs,
    train_planned_programs,
)
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

IMG = (28, 28, 1)
BOTH = pytest.mark.parametrize("sm", [jsm, tsm], ids=["jax", "torch"])


def _tiny_cfg(mod, **overrides):
    base = dict(
        num_classes_per_set=5,
        num_samples_per_class=1,
        num_target_samples=2,
        batch_size=2,
        number_of_training_steps_per_iter=1,
        number_of_evaluation_steps_per_iter=1,
        strict_recompile_guard=True,
        serving=mod.ServingConfig(support_buckets=[8], query_buckets=[16], max_batch_size=2),
    )
    base.update(overrides)
    return mod.Config(**base)


def _tiny_system(cfg):
    return MAMLSystem(cfg, model=build_vgg(IMG, cfg.num_classes_per_set, num_stages=1, cnn_num_filters=2),
                      device="cpu")


def _jax_system(cfg):
    return JaxMAMLSystem(cfg, model=jax_build_vgg(IMG, cfg.num_classes_per_set, num_stages=1, cnn_num_filters=2))


def _support(n_shots, seed):
    epi = synthetic_batch(1, 5, n_shots, 2, IMG, seed=seed)
    return epi["x_support"][0], epi["y_support"][0]


def _batch():
    return {k: np.asarray(v) for k, v in synthetic_batch(2, 5, 1, 2, IMG, seed=0).items()}


# ---------------------------------------------------------------------------
# the guard itself
# ---------------------------------------------------------------------------


def test_wrap_counts_lowerings_not_calls():
    """Four calls of one signature are one first dispatch; a new shape is
    the second."""
    guard = RecompileGuard(budget=2, name="t")
    fn = guard.wrap(lambda x: x * 2)
    for _ in range(4):
        fn(torch.zeros(3))
    assert guard.lowerings == 1
    fn(torch.zeros(5))
    assert guard.lowerings == 2


def test_wrap_trips_on_shape_unstable_function():
    """A function whose every call sees a fresh shape dispatches a new
    shape per call: loud at budget + 1."""
    guard = RecompileGuard(budget=3, name="unstable")
    fn = guard.wrap(torch.sum)
    for n in range(1, 4):
        fn(torch.zeros(n))
    with pytest.raises(RecompileBudgetExceededError) as exc:
        fn(torch.zeros(9))
    assert "budget of 3" in str(exc.value)


@BOTH
def test_planned_set_rejects_unplanned_key_immediately(sm):
    guard = sm.RecompileGuard(planned={("a", 1), ("a", 2)}, name="fam")
    guard.note(("a", 1))
    guard.note(("a", 1))  # idempotent
    assert guard.lowerings == 1
    with pytest.raises(sm.RecompileBudgetExceededError) as exc:
        guard.note(("b", 7))
    assert "unplanned program" in str(exc.value)


@BOTH
def test_non_strict_collects_and_check_raises(sm):
    guard = sm.RecompileGuard(budget=1, name="soft", strict=False)
    guard.note("p1")
    guard.note("p2")  # over budget, but observe-only
    assert len(guard.violations) == 1
    with pytest.raises(sm.RecompileBudgetExceededError):
        guard.check()
    with pytest.raises(sm.RecompileBudgetExceededError):
        with sm.RecompileGuard(budget=1, strict=False) as g:
            g.note("x")
            g.note("y")


@BOTH
def test_reset_forgets_seen_programs(sm):
    guard = sm.RecompileGuard(budget=1, name="r")
    guard.note("p1")
    guard.reset()
    guard.note("p2")  # would have tripped without the reset
    assert guard.lowerings == 1


@BOTH
def test_prewarmed_guard_rejects_any_new_key_and_messages_match(sm):
    """After ``mark_prewarmed`` a first-seen key is a violation even when
    planned; a retried rejected key keeps raising; ``reset`` un-seals. The
    port's messages and snapshots are JAX's."""
    guard = sm.RecompileGuard(planned={"a", "b"}, name="seal")
    guard.note("a")
    guard.mark_prewarmed()
    guard.note("a")
    for _ in range(2):
        with pytest.raises(sm.RecompileBudgetExceededError, match="OUTSIDE prewarm"):
            guard.note("b")
    snap = guard.snapshot()
    assert snap == {"name": "seal", "budget": 2, "lowerings": 1, "prewarmed": True,
                    "violations": ["RecompileGuard[seal]: program 'b' compiled OUTSIDE prewarm (the prewarmed set "
                                   "of 1 programs was declared complete)"]}
    guard.reset()
    guard.note("b")
    assert not guard.prewarmed and guard.lowerings == 1


@pytest.mark.parametrize(
    "value",
    [
        {"x": np.zeros((2, 3), np.float32), "k": 5},
        ({"x": np.zeros((2, 3), np.float32)}, [np.zeros(4, np.int32), 3, "s"]),
        ("opaque", {1, 2}),
    ],
    ids=["dict", "nested", "unhashable"],
)
def test_abstract_signature_matches_jax(value):
    """The same arguments give the JAX package's signature; a torch tensor
    gives its numpy twin's shape (the dtype spells torch's name)."""
    assert abstract_signature(value) == jsm.abstract_signature(value)
    t = abstract_signature(torch.zeros((2, 3)))
    assert t == ("arr", (2, 3), "torch.float32")


def test_abstract_signature_distinguishes_shape_dtype_and_statics():
    a = abstract_signature({"x": torch.zeros((2, 3)), "k": 5})
    same = abstract_signature({"x": torch.ones((2, 3)), "k": 5})
    other_shape = abstract_signature({"x": torch.zeros((2, 4)), "k": 5})
    other_dtype = abstract_signature({"x": torch.zeros((2, 3), dtype=torch.int32), "k": 5})
    other_static = abstract_signature({"x": torch.zeros((2, 3)), "k": 6})
    assert a == same
    assert len({a, other_shape, other_dtype, other_static}) == 4


@pytest.mark.parametrize("max_batch", [1, 2, 6, 8])
def test_batch_buckets_shapes(max_batch):
    assert tsm.batch_buckets(max_batch) == jsm.batch_buckets(max_batch)
    assert tsm.batch_buckets(8) == (1, 2, 4, 8) and tsm.batch_buckets(6) == (1, 2, 4, 6)


# ---------------------------------------------------------------------------
# the planned sets
# ---------------------------------------------------------------------------

SERVING_GRID = {
    "default": {},
    "buckets": dict(support_buckets=[8, 30], query_buckets=[4, 16, 64]),
    "batch6": dict(max_batch_size=6),
    "batch1": dict(max_batch_size=1),
    "strategies": dict(strategies=["maml++", "protonet", "anil"]),
    "refine": dict(refine_enabled=True),
    "refine_strategies": dict(refine_enabled=True, strategies=["fomaml", "protonet"], max_batch_size=4),
}


@pytest.mark.parametrize("name", sorted(SERVING_GRID))
def test_serving_planned_programs_equal_jax(name):
    knobs = SERVING_GRID[name]
    assert serving_planned_programs(tcfg.ServingConfig(**knobs)) == jsm.serving_planned_programs(
        jcfg.ServingConfig(**knobs))


TRAIN_GRID = {
    "default": {},
    "first_order": dict(second_order=False),
    "no_msl": dict(use_multi_step_loss_optimization=False),
    "fomaml": dict(strategy="fomaml"),
    "anil": dict(strategy="anil"),
    "anil_first_order_no_msl": dict(strategy="anil", second_order=False, use_multi_step_loss_optimization=False),
}


@pytest.mark.parametrize("name", sorted(TRAIN_GRID))
def test_train_planned_programs_equal_jax(name):
    knobs = TRAIN_GRID[name]
    assert train_planned_programs(tcfg.Config(**knobs)) == jsm.train_planned_programs(jcfg.Config(**knobs))


# ---------------------------------------------------------------------------
# serving engine under strict mode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """The port's strict engine and JAX's, on the JAX weights."""
    jsystem = _jax_system(_tiny_cfg(jcfg))
    jstate = jsystem.init_train_state()
    system = _tiny_system(_tiny_cfg(tcfg))
    params, bn_state, hparams = state_from_jax(jstate.params, jstate.bn_state, jstate.inner_hparams,
                                               system.model.feature_shape, device="cpu")
    state = system.init_train_state()._replace(params=params, bn_state=bn_state, inner_hparams=hparams)
    return AdaptationEngine(system, state), JaxEngine(jsystem, jstate)


def test_engine_guard_enabled_via_config(engines):
    engine, _ = engines
    assert engine.recompile_guard is not None
    planned = serving_planned_programs(engine.serving)
    assert ("adapt", 8, 1) in planned and ("predict", 16, 2) in planned
    assert engine.compile_counts()["recompile_guard"]["budget"] == len(planned)


def test_engine_passes_repeated_mixed_shape_traffic(engines):
    """Support sizes 5 and 8 pad to one bucket, single and paired requests
    to the batch buckets: the whole stream stays inside the planned family,
    and the port's guard notes the keys JAX's does, on the same traffic."""
    for engine in engines:
        for seed in range(3):
            fw = engine.adapt(*_support(1, seed))  # support 5 -> bucket 8
            engine.adapt_batch([_support(1, 10 + seed), _support(1, 20 + seed)])
            q = synthetic_batch(1, 5, 1, 2, IMG, seed=seed)["x_target"][0]
            engine.predict(fw, q.reshape(-1, *IMG))  # query 10 -> bucket 16
    port, jax_engine = engines
    snap = port.recompile_guard.snapshot()
    assert snap["violations"] == []
    assert set(port.recompile_guard._seen) == set(jax_engine.recompile_guard._seen)
    assert snap["lowerings"] == jax_engine.recompile_guard.snapshot()["lowerings"] >= 2
    assert port.compile_counts()["adapt_programs"] <= len(serving_planned_programs(port.serving))
    assert set(port._adapt_programs) == set(jax_engine._adapt_jit)


def test_engine_trips_on_oversize_request_even_on_retry(engines):
    """A rejected key is never recorded as seen: a client retrying the same
    oversize request keeps getting refused, before anything dispatches."""
    engine, _ = engines
    x, y = _support(4, 99)  # support 20 > largest bucket 8: unplanned
    programs = set(engine._adapt_programs)
    for _ in range(2):
        with pytest.raises(RecompileBudgetExceededError) as exc:
            engine.adapt(x, y)
        assert "unplanned program" in str(exc.value)
    assert set(engine._adapt_programs) == programs


def test_engine_default_is_permissive():
    system = _tiny_system(_tiny_cfg(tcfg, strict_recompile_guard=False))
    engine = AdaptationEngine(system, system.init_train_state())
    assert engine.recompile_guard is None and "recompile_guard" not in engine.compile_counts()
    x, y = _support(4, 7)  # oversize dispatches on demand, as documented
    engine.adapt(x, y)
    assert engine.compile_counts()["adapt_programs"] == 1


# ---------------------------------------------------------------------------
# the train family under strict mode
# ---------------------------------------------------------------------------


def test_train_family_within_plan_across_msl_boundary():
    """Four epochs across the MSL-annealing boundary: the port's guard
    holds the two variants JAX's system compiles, plus the eval kind."""
    knobs = dict(total_epochs=4, multi_step_loss_num_epochs=2, second_order=True)
    system = _tiny_system(_tiny_cfg(tcfg, **knobs))
    jsystem = _jax_system(_tiny_cfg(jcfg, **knobs))
    assert ("train", True, True) in train_planned_programs(system.cfg)
    state, jstate, batch = system.init_train_state(), jsystem.init_train_state(), _batch()
    for epoch in (0, 1, 2, 3):
        state, _ = system.train_step(state, batch, epoch=epoch)
        jstate, _ = jsystem.train_step(jstate, batch, epoch=epoch)
    assert system.recompile_guard.snapshot()["violations"] == []
    assert set(system.recompile_guard._seen) == set(jsystem.recompile_guard._seen)
    assert {k for k in system.recompile_guard._seen if k[0] == "train"} == {
        ("train",) + k for k in jsystem._train_step_cache}


def test_wrap_on_prewarmed_function_sees_no_false_recompile():
    """A function already dispatched before it is wrapped: the guard counts
    signatures from the wrap on, so the warm shape is one signature."""
    fn = lambda x: x + 1  # noqa: E731
    fn(torch.zeros(2))
    fn(torch.zeros(3))
    guard = RecompileGuard(budget=1, name="warm")
    wrapped = guard.wrap(fn)
    wrapped(torch.zeros(2))
    assert guard.lowerings == 1 and guard.violations == []


def test_wrap_counts_static_kwarg_value_changes():
    guard = RecompileGuard(budget=2, name="kw")
    fn = guard.wrap(lambda x, mode=0: x)
    fn(torch.zeros(2), mode=1)
    fn(torch.zeros(2), mode=1)
    assert guard.lowerings == 1
    fn(torch.zeros(2), mode=2)
    assert guard.lowerings == 2


def test_train_plan_covers_msl_window_corner():
    """MSL on with a zero-length annealing window: msl_active is always
    False at run time, and the planned family still covers it."""
    cfg = _tiny_cfg(tcfg, total_epochs=2, use_multi_step_loss_optimization=True, multi_step_loss_num_epochs=0)
    assert ("train", True, False) in train_planned_programs(cfg)
    system = _tiny_system(cfg)
    system.train_step(system.init_train_state(), _batch(), epoch=0)  # must not trip
    assert system.recompile_guard.snapshot()["violations"] == []


def test_scale_meta_lr_reset_replans_the_family():
    system = _tiny_system(_tiny_cfg(tcfg, total_epochs=2))
    state, batch = system.init_train_state(), _batch()
    state, _ = system.train_step(state, batch, epoch=0)
    system.scale_meta_lr(0.5)  # re-plans on purpose
    assert system.recompile_guard.lowerings == 1  # the eval kind, noted again
    state, _ = system.train_step(state, batch, epoch=0)
    assert system.recompile_guard.snapshot()["violations"] == []


# ---------------------------------------------------------------------------
# the serving prewarm
# ---------------------------------------------------------------------------


def _prewarm_engine(**serving):
    cfg = _tiny_cfg(tcfg, serving=tcfg.ServingConfig(support_buckets=[8], query_buckets=[16], max_batch_size=2,
                                                     **serving))
    system = _tiny_system(cfg)
    return AdaptationEngine(system, system.init_train_state())


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("serving", [{}, {"strategies": ["maml++", "protonet"], "refine_enabled": True}],
                         ids=["default", "strategies_refine"])
def test_prewarm_dispatches_the_plan_and_seals(workers, serving):
    """Every planned key dispatched once (JAX's program names and summary
    keys), the guard sealed, then in-plan traffic passes and nothing new
    is noted. ``max_workers`` keeps JAX's signature and is ignored: the
    grid runs inline for any value."""
    engine = _prewarm_engine(**serving)
    planned = serving_planned_programs(engine.serving)
    named = []
    summary = engine.prewarm(max_workers=workers, on_program=named.append)
    assert summary["programs"] == len(planned) == len(summary["by_program"]) == len(named)
    assert summary["errors"] == 0 and {"seconds", "cache_hits", "store_hits"} <= set(summary)
    assert set(summary["by_program"]) == {f"serve_{k}/{b}/{n}" for k, b, n in planned}
    snap = engine.recompile_guard.snapshot()
    assert snap["prewarmed"] and snap["lowerings"] == len(planned) and snap["violations"] == []
    fw = engine.adapt(*_support(1, 3))
    engine.predict(fw, synthetic_batch(1, 5, 1, 2, IMG, seed=3)["x_target"][0].reshape(-1, *IMG))
    assert engine.recompile_guard.snapshot()["lowerings"] == len(planned)


def test_prewarm_leaves_the_engine_cache_sessions_and_state_untouched():
    """The prewarm keeps no result: the engine's state tensors are
    bit-identical, the frontend's cache, lineages and session counters are
    empty, the fault seams did not fire and no dispatch span was
    recorded."""
    engine = _prewarm_engine(refine_enabled=True)
    frontend = ServingFrontend(engine)
    try:
        def leaves():
            st = engine.state
            return tree_leaves({"p": st.params, "bn": st.bn_state, "h": st.inner_hparams}) + [st.step]

        before = [t.clone() for t in leaves()]
        spans = []
        engine.tracer = type("Rec", (), {"span": lambda self, name, **kw: spans.append(name)})()
        engine.prewarm(max_workers=1)
        after = leaves()
        assert len(before) == len(after) and all(torch.equal(a, b) for a, b in zip(before, after))
        assert frontend.cache.stats()["entries"] == 0 and frontend._lineages == {}
        assert frontend.counters.snapshot().get("refines", 0) == 0
        assert engine.injector.stats() == {} or not any(engine.injector.stats().values())
        assert spans == []
    finally:
        frontend.close()


def test_prewarm_without_a_guard_still_dispatches():
    engine = _prewarm_engine()
    engine.recompile_guard = None
    summary = engine.prewarm(max_workers=1)
    assert summary["programs"] == 4 and engine.compile_counts()["adapt_programs"] == 2


def test_strict_clone_keeps_its_guard():
    engine = _prewarm_engine()
    clone = engine.clone_for_device("cpu", 1)
    assert clone.recompile_guard is not None and clone.recompile_guard is not engine.recompile_guard
    assert dataclasses.asdict(clone.serving) == dataclasses.asdict(engine.serving)
