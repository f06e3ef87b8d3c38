"""The serving engine's programs (``serving/engine.py``, ``core/programs.py``:
``ServingCall``, ``StaticBuffers``) against the JAX engine's jitted bucket
programs, on the CPU.

On the CPU nothing is captured: each program runs its static-buffer path
eagerly (the master, the inputs and the outputs in buffers shared by the
engine's programs), so everything but the CUDA graph itself is exercised
here; ``chip_smoke.py`` phase ``serve_programs`` checks the graphs on the
card. Both engines get the same numpy inputs made from a seed, and the
port's weights come from JAX's through ``utils/interop.py::state_from_jax``.
Probabilities are compared within ``ATOL`` (1e-5, float32 through a
2-step first-order rollout of a tiny VGG); the port's results among
themselves (a flush against a second flush, a tenant against its own
engine) are compared exactly.
"""

import threading
import types

import jax
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu import config as jcfg
from howtotrainyourmamlpytorch_tpu.core import MAMLSystem as JaxMAMLSystem
from howtotrainyourmamlpytorch_tpu.data.synthetic import synthetic_batch
from howtotrainyourmamlpytorch_tpu.models import build_vgg as jax_build_vgg
from howtotrainyourmamlpytorch_tpu.serving.engine import AdaptationEngine as JaxEngine
from howtotrainyourmamlpytorch_tpu.serving.registry import synthetic_registry as jax_synthetic_registry
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch.core import programs
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.core.programs import ServingCall, StaticBuffers
from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg
from howtotrainyourmamlpytorch_tpu_torch.observability.compile_ledger import CompileLedger
from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine
from howtotrainyourmamlpytorch_tpu_torch.serving.registry import synthetic_registry
from howtotrainyourmamlpytorch_tpu_torch.serving.tenancy import master_bytes
from howtotrainyourmamlpytorch_tpu_torch.utils.interop import state_from_jax
from howtotrainyourmamlpytorch_tpu_torch.utils.strictmode import RecompileBudgetExceededError, serving_planned_programs
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

IMG = (14, 14, 1)
N_WAY = 5
ATOL = 1e-5
STRATEGIES = ("maml++", "anil")
TENANTS = ["acme", "bravo"]


def _config(module, **overrides):
    serving = dict(support_buckets=[8, 16], query_buckets=[16], max_batch_size=4, strategies=list(STRATEGIES),
                   refine_enabled=True)
    serving.update(overrides.pop("serving", {}))
    return module.Config(
        num_classes_per_set=N_WAY, num_samples_per_class=1, num_target_samples=2, batch_size=2,
        number_of_training_steps_per_iter=2, number_of_evaluation_steps_per_iter=2,
        serving=module.ServingConfig(**serving), **overrides,
    )


def _systems(**overrides):
    """JAX's system and state, and the port's with JAX's weights."""
    jsystem = JaxMAMLSystem(_config(jcfg, **overrides),
                            model=jax_build_vgg(IMG, N_WAY, num_stages=2, cnn_num_filters=4))
    jstate = jsystem.init_train_state()
    system = MAMLSystem(_config(tcfg, **overrides), model=build_vgg(IMG, N_WAY, num_stages=2, cnn_num_filters=4),
                        device="cpu")
    params, bn_state, hparams = state_from_jax(
        jax.tree.map(np.asarray, jstate.params), jax.tree.map(np.asarray, jstate.bn_state),
        jax.tree.map(np.asarray, jstate.inner_hparams), system.model.feature_shape,
    )
    state = system.init_train_state()._replace(params=params, bn_state=bn_state, inner_hparams=hparams)
    return system, state, jsystem, jstate


def _support(shots, seed):
    b = synthetic_batch(1, N_WAY, shots, 3, IMG, seed=seed)
    return b["x_support"][0], b["y_support"][0], b["x_target"][0].reshape((-1,) + IMG)


def _numpy(tree):
    return [np.asarray(leaf) for leaf in tree_leaves(tree)]


# ---------------------------------------------------------------------------
# one request sequence through both engines
# ---------------------------------------------------------------------------


def _sequence(engine, jax_out: bool):
    """Two support buckets (5 and 15 samples: buckets 8 and 16), two batch
    buckets (1 and 2), both strategies: adapt, then predict, then refine,
    then predict -> the probabilities of every step, in order."""
    out = []
    as_np = (lambda p: np.asarray(p)) if jax_out else (lambda p: p)
    for strategy in STRATEGIES:
        pairs = [_support(1, 10), _support(1, 11)]
        fws = engine.adapt_batch([(x, y) for x, y, _ in pairs], strategy=strategy)
        out += [as_np(p) for p in engine.predict_batch([(fw, q) for fw, (_, _, q) in zip(fws, pairs)],
                                                      strategy=strategy)]
        x, y, q = _support(3, 12)
        fw = engine.adapt(x, y, strategy=strategy)
        out.append(as_np(engine.predict(fw, q, strategy=strategy)))
        refined = engine.refine(fw, *_support(3, 13)[:2], strategy=strategy)
        out.append(as_np(engine.predict(refined, q, strategy=strategy)))
    return out


@pytest.fixture(scope="module")
def served():
    system, state, jsystem, jstate = _systems()
    engine, jengine = AdaptationEngine(system, state), JaxEngine(jsystem, jstate)
    return types.SimpleNamespace(engine=engine, jengine=jengine, probs=_sequence(engine, False),
                                 jprobs=_sequence(jengine, True))


@pytest.mark.parametrize("key", ["adapt_programs", "predict_programs", "refine_programs"])
def test_compile_counts_match_jax(served, key):
    """After the same requests the port has built the programs the JAX
    engine has compiled, under JAX's count keys."""
    counts, jcounts = served.engine.compile_counts(), served.jengine.compile_counts()
    assert counts[key] == jcounts[key] > 0
    assert not {"adapt_shapes", "predict_shapes"} & set(counts)


@pytest.mark.parametrize("base", ["adapt", "predict", "refine"])
def test_program_table_has_jax_keys(served, base):
    """One ``ServingCall`` per ``(strategy, bucket, b)``: the JAX engine's
    jit-cache keys, and no other."""
    table = getattr(served.engine, f"_{base}_programs")
    jtable = getattr(served.jengine, f"_{base}_jit")
    assert set(table) == set(jtable)
    assert all(isinstance(p, ServingCall) for p in table.values())
    assert len({id(p) for p in table.values()}) == len(table)


def test_static_buffer_path_gives_jax_probabilities(served):
    """Adapt, predict, refine, predict: every step's probabilities within
    ATOL of the JAX engine's."""
    assert len(served.probs) == len(served.jprobs) == 2 * len(STRATEGIES) + 2 * len(STRATEGIES)
    for got, want in zip(served.probs, served.jprobs):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_programs_share_the_master_and_inputs(served):
    """Every program reads the one static master; programs of one shape
    read the same input buffers."""
    engine = served.engine
    programs_ = [p for t in (engine._adapt_programs, engine._predict_programs, engine._refine_programs)
                 for p in t.values()]
    assert all(p.state is engine._static_master for p in programs_)
    adapt = engine._adapt_programs[("maml++", 8, 2)]
    assert adapt.inputs["xs"] is engine._adapt_programs[("anil", 8, 2)].inputs["xs"]
    refine = engine._refine_programs[("maml++", 16, 1)]
    assert refine.inputs["xs"] is engine._adapt_programs[("anil", 16, 1)].inputs["xs"]
    assert refine.inputs["fw"]["fc"]["w"] is engine._predict_programs[("anil", 16, 1)].inputs["fw"]["fc"]["w"]
    assert engine.program_memory()["static_bytes"] > 0 and engine.program_memory()["pool_bytes"] is None


# ---------------------------------------------------------------------------
# outputs and caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_second_flush_keeps_the_first_flush_trees(strategy):
    """A flush's trees own their memory: a second flush of the same
    program, which overwrites the static outputs, changes none of them,
    and no tree is a view of a static buffer."""
    system, state, _, _ = _systems()
    engine = AdaptationEngine(system, state)
    first = engine.adapt_batch([_support(1, 20)[:2], _support(1, 21)[:2]], strategy=strategy)
    kept = [_numpy(t) for t in first]
    second = engine.adapt_batch([_support(1, 22)[:2], _support(1, 23)[:2]], strategy=strategy)
    assert engine.compile_counts()["adapt_programs"] == 1
    for tree, want in zip(first, kept):
        for leaf, w in zip(_numpy(tree), want):
            np.testing.assert_array_equal(leaf, w)
    head = lambda t: t["fc"]["w"]  # noqa: E731
    assert not torch.equal(head(first[0]), head(second[0]))
    static = {b.untyped_storage().data_ptr() for b in engine._buffers._by_key.values()}
    assert not any(leaf.untyped_storage().data_ptr() in static for t in first + second for leaf in tree_leaves(t))


def test_predict_results_outlive_the_next_flush():
    system, state, _, _ = _systems()
    engine = AdaptationEngine(system, state)
    x, y, q = _support(1, 30)
    fw = engine.adapt(x, y)
    probs = engine.predict(fw, q)
    kept = probs.copy()
    engine.predict(engine.adapt(*_support(1, 31)[:2]), q)
    np.testing.assert_array_equal(probs, kept)


# ---------------------------------------------------------------------------
# tenants: one program for all
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tenants(tmp_path_factory):
    """A registry of TENANTS in each package over one master, and an engine
    of each in tenant mode; the port's pager holds one tenant at a time,
    so that alternating tenants evicts and re-pages them."""
    root = tmp_path_factory.mktemp("serve_programs_tenants")
    system, state, jsystem, jstate = _systems(serving={"refine_enabled": False})
    jreg = jax_synthetic_registry(TENANTS, jstate, str(root / "jax"), seed=0)
    reg = synthetic_registry(TENANTS, state, str(root / "port"), seed=0, feature_shape=system.model.feature_shape)
    engine = AdaptationEngine(system, state, registry=reg)
    engine.pager.budget_bytes = master_bytes(state)
    return types.SimpleNamespace(engine=engine, jengine=JaxEngine(jsystem, jstate, registry=jreg), system=system,
                                 state=state, reg=reg)


def test_two_tenants_alternate_through_one_program(tenants):
    """acme, bravo, acme, bravo, the engine's own master, acme: each
    answer is the JAX engine's for that tenant, and the port ran them all
    through one adapt and one predict program, evicting and re-paging."""
    engine, jengine = tenants.engine, tenants.jengine
    x, y, q = _support(2, 40)
    for tenant in TENANTS + TENANTS + [None, TENANTS[0]]:
        got = engine.predict(engine.adapt(x, y, tenant=tenant), q, tenant=tenant)
        want = np.asarray(jengine.predict(jengine.adapt(x, y, tenant=tenant), q, tenant=tenant))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    counts = engine.compile_counts()
    assert (counts["adapt_programs"], counts["predict_programs"]) == (1, 1)
    stats = engine.pager.stats()
    assert stats["page_ins"] >= 4 and stats["evictions"] >= 3


def test_tenant_answers_equal_an_engine_of_their_own(tenants):
    """Through the shared program each tenant gets exactly what an engine
    over its master alone gives, including after an eviction and a
    re-page, which gives the copy a new serial."""
    engine = tenants.engine
    x, y, q = _support(2, 41)
    alone = {}
    for tenant in TENANTS:
        host, _ = tenants.reg.host_state(tenant)
        own = AdaptationEngine(tenants.system, host._replace(opt_state=None))
        alone[tenant] = own.predict(own.adapt(x, y), q)
    for tenant in TENANTS:
        np.testing.assert_array_equal(engine.predict(engine.adapt(x, y, tenant=tenant), q, tenant=tenant),
                                      alone[tenant])
    _, serial = engine.pager.resident_entry(TENANTS[-1])
    assert engine._loaded == (TENANTS[-1], serial)
    engine.pager.evict(TENANTS[-1])
    again = engine.pager.resident_entry(TENANTS[-1])[1]
    assert again != serial
    np.testing.assert_array_equal(
        engine.predict(engine.adapt(x, y, tenant=TENANTS[-1]), q, tenant=TENANTS[-1]), alone[TENANTS[-1]])
    assert engine._loaded == (TENANTS[-1], again)


def test_same_tenant_skips_the_master_copy(tenants, monkeypatch):
    """The same tenant, resident and unchanged, is not copied into the
    static master again; another tenant is."""
    engine = tenants.engine
    x, y, _ = _support(2, 42)
    engine.adapt(x, y, tenant=TENANTS[0])
    copies = []
    real = programs._copy_into
    monkeypatch.setattr("howtotrainyourmamlpytorch_tpu_torch.serving.engine._copy_into",
                        lambda d, s: (copies.append(len(d)), real(d, s)))
    engine.adapt(x, y, tenant=TENANTS[0])
    assert copies == []
    engine.adapt(x, y, tenant=TENANTS[1])
    assert len(copies) == 1


# ---------------------------------------------------------------------------
# prewarm and strict mode
# ---------------------------------------------------------------------------


def test_prewarm_builds_the_plan_and_planned_keys_add_none():
    """The prewarm builds every planned program (one ledger entry each, in
    ``phase="prewarm"``, priced); then traffic at planned keys builds
    nothing and adds no ledger entry, and an unplanned key raises in
    strict mode before anything runs."""
    system, state, _, _ = _systems(strict_recompile_guard=True)
    engine = AdaptationEngine(system, state)
    planned = serving_planned_programs(engine.serving)
    summary = engine.prewarm(image_shape=IMG)
    assert summary["errors"] == 0 and summary["programs"] == len(planned)
    assert summary["pool_bytes"] is None and summary["static_bytes"] > 0
    entries = engine.compile_ledger.summary()
    assert entries["entries"] == len(planned) and all(p["flops"] > 0 for p in entries["by_program"].values())
    counts = engine.compile_counts()
    built = counts["adapt_programs"] + counts["predict_programs"] + counts["refine_programs"]
    assert built == len(planned)
    probs = _sequence(engine, False)
    assert all(np.isfinite(p).all() for p in probs)
    assert engine.compile_ledger.summary()["entries"] == len(planned)
    assert engine.compile_counts() == counts
    with pytest.raises(RecompileBudgetExceededError, match="OUTSIDE prewarm"):
        engine.adapt(*_support(4, 50)[:2])  # support 20 > the largest bucket, 16
    assert engine.compile_counts()["adapt_programs"] == counts["adapt_programs"]


def test_prewarm_entries_are_named_as_jax_and_phased():
    """One entry per planned program under JAX's program name, each in
    ``phase="prewarm"`` with the seconds of its build; the traffic after
    it records nothing."""
    system, state, _, _ = _systems(strict_recompile_guard=True)
    engine = AdaptationEngine(system, state)
    ledger, entries = CompileLedger(), []
    ledger.on_entry = entries.append
    engine.compile_ledger = ledger
    summary = engine.prewarm(image_shape=IMG)
    names = {f"serve_{k}/{b}/{n}" for k, b, n in serving_planned_programs(engine.serving)}
    assert set(summary["by_program"]) == names == {e["program"] for e in entries}
    assert all(e["phase"] == "prewarm" and e["graph"] is False and e["total_s"] >= 0 for e in entries)
    assert all(row["total_s"] is not None for row in summary["by_program"].values())
    n = len(entries)
    _sequence(engine, False)
    assert len(entries) == n


# ---------------------------------------------------------------------------
# the buffers, the program object, threads
# ---------------------------------------------------------------------------


def test_static_buffers_one_per_leaf_and_shared_by_shape():
    buffers = StaticBuffers("cpu")
    tree = {"a": torch.zeros(3), "b": torch.zeros(3), "c": {"d": torch.zeros(2, 2)}}
    one, two = buffers.like("fw", tree, lead=(4,)), buffers.like("fw", tree, lead=(4,))
    leaves = tree_leaves(one)
    assert [t.shape for t in leaves] == [(4, 3), (4, 3), (4, 2, 2)]
    assert len({t.data_ptr() for t in leaves}) == 3
    assert all(a is b for a, b in zip(leaves, tree_leaves(two)))
    assert buffers.like("fw", tree, lead=(2,))["a"] is not one["a"]
    assert buffers.nbytes() == 4 * (12 + 12 + 16 + 6 + 6 + 8)


def test_serving_call_runs_its_buffers_on_the_cpu():
    """The CPU build is the first run, priced; a run reads what the caller
    staged and writes the static outputs, which the next run overwrites."""
    buffers = StaticBuffers("cpu")
    state = {"w": torch.full((2, 2), 2.0)}
    inputs = {"x": buffers.get("x", (3, 2), torch.float32)}
    inputs["x"].copy_(torch.ones(3, 2))
    call = ServingCall(lambda st, inp: {"y": inp["x"] @ st["w"]}, state, inputs, buffers, "cpu").build()
    assert call.graph is None and call.cost["flops"] > 0 and call.lower_s >= 0
    first = call.outputs["y"]
    assert torch.equal(first, torch.full((3, 2), 4.0))
    inputs["x"].copy_(torch.full((3, 2), 3.0))
    assert call.run()["y"] is first and torch.equal(first, torch.full((3, 2), 12.0))


def test_concurrent_flushes_from_threads_match_serial_ones():
    """Adapt and predict flushes from several threads at once (the
    batcher workers) share the programs' buffers under the program lock:
    every answer equals the serial one."""
    system, state, _, _ = _systems()
    engine = AdaptationEngine(system, state)
    episodes = [_support(1 + (i % 3), 60 + i) for i in range(8)]
    want = [engine.predict(engine.adapt(x, y), q) for x, y, q in episodes]
    got = [None] * len(episodes)
    errors = []

    def client(i):
        try:
            x, y, q = episodes[i]
            got[i] = engine.predict(engine.adapt(x, y), q)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    switch = __import__("sys").getswitchinterval()
    __import__("sys").setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(episodes))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        __import__("sys").setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and errors == []
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_sync_gate_keeps_warmups_apart_from_host_syncs(monkeypatch):
    """A warmup under the process's ``"error"`` sync-debug mode waits for
    the host syncs in flight and holds new ones off until it ends."""
    mode = {"now": "default"}
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode["now"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda m: mode.update(now=m))
    gate = programs.SyncGate()
    seen = []
    syncing, release = threading.Event(), threading.Event()

    def sync():
        with gate.host_sync():
            syncing.set()
            release.wait(10)
            seen.append(("sync", mode["now"]))

    def warm():
        with gate.checked():
            seen.append(("warmup", mode["now"]))

    t1 = threading.Thread(target=sync)
    t1.start()
    assert syncing.wait(10)
    t2 = threading.Thread(target=warm)
    t2.start()
    t2.join(0.2)
    assert t2.is_alive() and seen == []  # the warmup waits for the sync
    release.set()
    t1.join(10)
    t2.join(10)
    assert not t1.is_alive() and not t2.is_alive()
    assert seen == [("sync", "default"), ("warmup", "error")] and mode["now"] == "default"


def test_pool_probe_orders_the_prewarm(capsys):
    """``scripts/serving_pool_probe.py`` on the CPU: each arm prewarms the
    whole grid, the JAX order from the smallest key, the engine's from the
    largest flush (no pool off a card)."""
    import json

    from howtotrainyourmamlpytorch_tpu_torch.scripts import serving_pool_probe

    rc = serving_pool_probe.main(["--device", "cpu", "--arms", "jax", "largest_first", "--override",
                                  "num_classes_per_set=3", "serving.support_buckets=[8, 16]",
                                  "serving.query_buckets=[8]", "serving.max_batch_size=2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and [row["arm"] for row in line["arms"]] == ["jax", "largest_first"]
    jax_arm, ours = line["arms"]
    assert jax_arm["programs"] == ours["programs"] == 6 and jax_arm["errors"] == ours["errors"] == 0
    assert (jax_arm["first"], ours["first"]) == ("serve_adapt/16/1", "serve_adapt/16/2")
    assert ours["pool_bytes"] is None and line["device"] == "cpu"
