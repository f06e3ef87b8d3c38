"""Multi-tenant serving of the port against the JAX package's, on the CPU.

Each of the JAX package's tests in ``tests/test_tenancy.py`` has a
counterpart here, run on both packages where both can run (the registry's
manifest, tenant validation, the pager's LRU and watermark arithmetic, the
quotas, the watermark provider) and on the port elsewhere:

- the registry: lazy, once-only host loads; a structurally foreign
  checkpoint refused;
- ``support_digest`` with a tenant byte-identical to JAX's;
- session spill files carrying the tenant, read by both packages;
- the platform drill (JAX: ``resilience/campaign.py``'s
  ``serve-tenant-thrash`` episode): 4 tenants behind one frontend over HTTP
  under a budget that fits 2 masters — page-ins and evictions equal to the
  LRU arithmetic, each tenant's answers equal to a single-tenant control,
  evictions in ``/metrics`` and in events.jsonl, every non-200 a 404 or a
  429 with an access-log line;
- quota 429s with ``Retry-After``, cross-tenant 404s, the engine without a
  registry refusing tenants, the budget flowing from the config;
- the serve CLI on a run directory holding a ``tenants.yaml``.

Parity at a small size (VGG with 2 stages and 8 filters on 14x14x1 images,
5-way 2-shot, K=2, buckets [10]/[15], ``max_batch_size`` 2): both packages'
``synthetic_registry`` over one master (carried across with
``utils/interop.py``) write the same tenant parameters, and each package
loads the other's checkpoints; the port's tenant-mode answers match the
JAX engine's within atol 1e-5 (float32 on both sides, sums in other
orders, as in ``test_torch_serving.py``) and equal a single-tenant port
engine on the tenant's checkpoint exactly.
"""

import importlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from collections import OrderedDict

import jax
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu import config as jcfg
from howtotrainyourmamlpytorch_tpu.core import MAMLSystem as JaxMAMLSystem
from howtotrainyourmamlpytorch_tpu.data.synthetic import synthetic_batch
from howtotrainyourmamlpytorch_tpu.experiment import checkpoint as jckpt
from howtotrainyourmamlpytorch_tpu.models import build_vgg as jax_build_vgg
from howtotrainyourmamlpytorch_tpu.serving.cache import support_digest as jax_support_digest
from howtotrainyourmamlpytorch_tpu.serving.engine import AdaptationEngine as JaxEngine
from howtotrainyourmamlpytorch_tpu.serving.registry import synthetic_registry as jax_synthetic_registry
from howtotrainyourmamlpytorch_tpu.serving.sessions import SessionStore as JaxSessionStore
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.core.train_state import TrainState
from howtotrainyourmamlpytorch_tpu_torch.experiment import checkpoint as ckpt
from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg
from howtotrainyourmamlpytorch_tpu_torch.observability.context import read_access_log
from howtotrainyourmamlpytorch_tpu_torch.observability.memory import device_memory_stats
from howtotrainyourmamlpytorch_tpu_torch.serving import AdaptationEngine, ServingFrontend, make_http_server
from howtotrainyourmamlpytorch_tpu_torch.serving.cache import support_digest, tree_bytes
from howtotrainyourmamlpytorch_tpu_torch.serving.errors import ServiceUnavailableError, UnknownAdaptationError
from howtotrainyourmamlpytorch_tpu_torch.serving.registry import synthetic_registry
from howtotrainyourmamlpytorch_tpu_torch.serving.sessions import SessionStore
from howtotrainyourmamlpytorch_tpu_torch.serving.tenancy import TenantQuotas, master_bytes
from howtotrainyourmamlpytorch_tpu_torch.utils.interop import params_to_jax, state_from_jax
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_flatten, tree_leaves

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_IMG = (14, 14, 1)
ATOL = 1e-5
TENANTS = ["acme", "bravo", "charlie", "delta"]

torch.set_num_threads(2)

PACKAGES = {"jax": "howtotrainyourmamlpytorch_tpu", "torch": "howtotrainyourmamlpytorch_tpu_torch"}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    name = PACKAGES[request.param]
    mod = lambda path: importlib.import_module(f"{name}.{path}")  # noqa: E731
    tenancy = mod("serving.tenancy")
    return types.SimpleNamespace(
        name=request.param,
        TenantRegistry=mod("serving.registry").TenantRegistry,
        WeightPager=tenancy.WeightPager,
        TenantQuotas=tenancy.TenantQuotas,
        QuotaExceededError=tenancy.QuotaExceededError,
        normalize_tenant=tenancy.normalize_tenant,
        validate_request_tenant=tenancy.validate_request_tenant,
        MemoryWatermarks=mod("observability.memory").MemoryWatermarks,
    )


def _config(module, **serving):
    return module.Config(
        num_classes_per_set=5,
        num_samples_per_class=2,
        num_target_samples=3,
        batch_size=2,
        number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=2,
        total_iter_per_epoch=4,
        use_pallas_inner_update=True,
        serving=module.ServingConfig(**{"support_buckets": [10], "query_buckets": [15], "max_batch_size": 2,
                                        **serving}),
    )


def _system(filters=4, **serving):
    return MAMLSystem(_config(tcfg, **serving), model=build_vgg(_IMG, 5, num_stages=2, cnn_num_filters=filters),
                      device="cpu")


def _episode(seed=0):
    b = synthetic_batch(1, 5, 2, 3, _IMG, seed=seed)
    return b["x_support"][0], b["y_support"][0], b["x_target"][0].reshape((-1,) + _IMG)


# ---------------------------------------------------------------------------
# registry: manifest round-trip + lazy host loads
# ---------------------------------------------------------------------------


def test_registry_yaml_round_trip_and_discovery_precedence(pkg, tmp_path):
    reg_path = tmp_path / "tenants.yaml"
    reg_path.write_text(
        "tenants:\n"
        "  acme: {run_dir: acme_runs, checkpoint: latest}\n"
        "  bravo: {run_dir: /abs/bravo}\n"
    )
    reg = pkg.TenantRegistry.from_yaml(str(reg_path))
    assert reg.tenants() == ("acme", "bravo")
    assert "acme" in reg and "nobody" not in reg
    # relative run_dirs resolve against the registry file's directory
    assert reg._resolve_run_dir("acme") == str(tmp_path / "acme_runs")
    assert reg._resolve_run_dir("bravo") == "/abs/bravo"
    assert reg._entries["bravo"]["checkpoint"] == "best"

    class _Cfg:
        tenant_registry = str(reg_path)

    # explicit path wins over <run_dir>/tenants.yaml; no source => None
    assert pkg.TenantRegistry.discover(_Cfg(), run_dir="/nonexistent") is not None
    _Cfg.tenant_registry = ""
    assert pkg.TenantRegistry.discover(_Cfg(), run_dir=str(tmp_path)) is not None
    assert pkg.TenantRegistry.discover(_Cfg(), run_dir="/nonexistent") is None
    with pytest.raises(ValueError):
        pkg.TenantRegistry({"acme": "not-a-mapping"})
    with pytest.raises(ValueError):
        pkg.TenantRegistry({})


def test_registry_loads_masters_lazily_and_once(tmp_path):
    system = _system()
    reg = synthetic_registry(["a", "b"], system.init_train_state(), str(tmp_path),
                             feature_shape=system.model.feature_shape)
    # naming tenants costs nothing until traffic arrives for one
    assert reg.stats() == {"tenants": 2, "hosted": 0, "loads": 0}
    assert reg.hosted_fingerprints() == {}
    st_a, fp_a = reg.host_state("a")
    assert reg.stats()["loads"] == 1 and reg.stats()["hosted"] == 1
    # host RAM only: CPU leaves in the port's layout (pinned only with a card)
    assert all(leaf.device.type == "cpu" and not leaf.is_pinned() for leaf in tree_leaves(st_a.params))
    assert st_a.opt_state is None
    st_a2, fp_a2 = reg.host_state("a")
    assert reg.stats()["loads"] == 1 and fp_a2 == fp_a and st_a2 is st_a
    assert reg.fingerprint("b") != fp_a  # distinct perturbed checkpoints
    assert reg.hosted_fingerprints() == {"a": fp_a, "b": reg.fingerprint("b")}
    with pytest.raises(KeyError):
        reg.host_state("nobody")


def test_registry_rejects_structurally_foreign_checkpoints(tmp_path):
    system = _system()
    reg = synthetic_registry(["a"], system.init_train_state(), str(tmp_path), feature_shape=system.model.feature_shape)
    # a wider model cannot share the fleet's engine
    reg.template = _system(filters=8).init_train_state()
    with pytest.raises(ValueError, match="structure differs"):
        reg.host_state("a")


# ---------------------------------------------------------------------------
# normalization + pager arithmetic (fake registry, fake byte budget)
# ---------------------------------------------------------------------------


def test_tenant_normalization_and_validation(pkg):
    assert pkg.normalize_tenant(None) is None
    assert pkg.normalize_tenant("") is None
    assert pkg.normalize_tenant("default") is None
    assert pkg.normalize_tenant(" acme ") == "acme"
    with pytest.raises(ValueError):
        pkg.normalize_tenant(7)
    assert pkg.validate_request_tenant("default", None) is None
    with pytest.raises(ValueError, match="no tenant registry"):
        pkg.validate_request_tenant("acme", None)

    class _Reg:
        def __contains__(self, t):
            return t == "acme"

        def tenants(self):
            return ("acme",)

    assert pkg.validate_request_tenant("acme", _Reg()) == "acme"
    with pytest.raises(ValueError, match="unknown tenant"):
        pkg.validate_request_tenant("bravo", _Reg())


class _FakeRegistry:
    """Registry double: each tenant's master is one float32 vector of
    ``leaf_n`` elements (4*leaf_n bytes once resident) — a dict of numpy
    for the JAX pager, a ``TrainState`` of tensors for the port's."""

    def __init__(self, package, tenants, leaf_n=256):
        self.package = package
        self._tenants = list(tenants)
        self.leaf_n = leaf_n

    def host_state(self, tenant):
        value = float(self._tenants.index(tenant))
        if self.package == "jax":
            return {"w": np.full((self.leaf_n,), value, np.float32)}, f"fp-{tenant}"
        state = TrainState({"w": torch.full((self.leaf_n,), value)}, {}, {}, None, torch.zeros((), dtype=torch.int64))
        return state, f"fp-{tenant}"


def _w(package, state):
    return np.asarray(state["w"] if package == "jax" else state.params["w"])


def test_pager_lru_eviction_arithmetic_under_byte_budget(pkg):
    per = 256 * 4
    template = {"w": np.zeros(1)} if pkg.name == "jax" else TrainState({"w": torch.zeros(1)}, {}, {}, None, 0)
    pager = pkg.WeightPager(_FakeRegistry(pkg.name, ["a", "b", "c"]), template=template, budget_bytes=2 * per)
    pager.resident("a")
    pager.resident("b")
    assert pager.stats()["resident_bytes"] == 2 * per
    assert pager.stats()["resident_tenants"] == ["a", "b"]
    # touching "a" refreshes its recency: paging "c" in evicts "b", not "a"
    pager.resident("a")
    pager.resident("c")
    st = pager.stats()
    assert st["resident_tenants"] == ["a", "c"]
    assert st["evictions"] == 1 and st["page_ins"] == 3
    assert st["resident_bytes"] == 2 * per
    assert st["page_in_p50_ms"] is not None
    # a re-request of the evicted tenant is a page-in, never an error
    np.testing.assert_array_equal(_w(pkg.name, pager.resident("b"))[:1], [1.0])
    events = pager.drain_events()
    assert [e["event"] for e in events].count("tenant_evicted") == 2
    assert all(e["bytes"] == per for e in events)
    assert pager.drain_events() == []
    # the default tenant is the engine's own state: no paging, no accounting
    assert pager.resident(None) is pager.template
    assert pager.stats()["page_ins"] == 4


def test_pager_watermark_pressure_evicts_lru(pkg):
    class _Watermarks:
        headroom = 1.0

        def snapshot(self):
            return {"headroom_frac_min": self.headroom}

    wm = _Watermarks()
    pager = pkg.WeightPager(_FakeRegistry(pkg.name, ["a", "b"]), template=None, min_headroom_frac=0.1, watermarks=wm)
    pager.resident("a")
    pager.resident("b")
    assert pager.check_watermark() is None  # plenty of headroom
    wm.headroom = 0.05
    assert pager.check_watermark() == "a"  # LRU goes first
    assert pager.stats()["resident_tenants"] == ["b"]
    assert pager.drain_events()[-1]["reason"] == "hbm_watermark"
    # no provider / knob off => free no-op
    assert pkg.WeightPager(_FakeRegistry(pkg.name, ["a"]), None).check_watermark() is None


def test_concurrent_page_ins_never_exceed_the_byte_budget(monkeypatch):
    """The port copies a master to the card outside the pager lock, so
    several misses copy at once. Twelve threads miss on six tenants
    (two per tenant) under a budget of two masters, each copy held open
    long enough to overlap: the resident bytes plus the copies in flight
    never pass the budget, no tenant is copied twice at once, and the
    end state and counters are a serial pager's."""
    import howtotrainyourmamlpytorch_tpu_torch.serving.tenancy as tenancy

    per = 256 * 4
    tenants = ["a", "b", "c", "d", "e", "f"]
    pager = tenancy.WeightPager(_FakeRegistry("torch", tenants), template=None, budget_bytes=2 * per)
    gauge = {"copying": set(), "worst": 0, "twice": 0}
    gauge_lock = threading.Lock()
    real_page_to = tenancy.page_to

    def slow_page_to(state, device):
        tenant = tenants[int(state.params["w"][0])]
        with gauge_lock:
            gauge["twice"] += tenant in gauge["copying"]
            gauge["copying"].add(tenant)
            live = pager._bytes + per * len(gauge["copying"])
            gauge["worst"] = max(gauge["worst"], live)
        time.sleep(0.02)
        with gauge_lock:
            gauge["copying"].discard(tenant)
        return real_page_to(state, device)

    monkeypatch.setattr(tenancy, "page_to", slow_page_to)
    start = threading.Barrier(2 * len(tenants))
    got = {}

    def miss(tenant, k):
        start.wait()
        got[(tenant, k)] = _w("torch", pager.resident(tenant))[0]

    threads = [threading.Thread(target=miss, args=(t, k)) for t in tenants for k in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert got == {(t, k): float(i) for i, t in enumerate(tenants) for k in range(2)}
    assert gauge["worst"] <= 2 * per and gauge["twice"] == 0
    st = pager.stats()
    assert st["resident_bytes"] == 2 * per and st["resident"] == 2
    assert st["page_ins"] - st["evictions"] == 2 and st["page_ins"] >= len(tenants)
    assert pager._reserved == 0 and pager._inflight == {}


def test_failed_page_in_releases_its_reservation(monkeypatch):
    """A copy that raises leaves no reserved bytes, no copy in flight and
    no resident entry behind it; the next miss pages the tenant in."""
    import howtotrainyourmamlpytorch_tpu_torch.serving.tenancy as tenancy

    pager = tenancy.WeightPager(_FakeRegistry("torch", ["a"]), template=None, budget_bytes=256 * 4)
    real_page_to = tenancy.page_to

    def broken(state, device):
        raise RuntimeError("transfer failed")

    monkeypatch.setattr(tenancy, "page_to", broken)
    with pytest.raises(RuntimeError, match="transfer failed"):
        pager.resident("a")
    assert (pager._reserved, pager._inflight, pager.stats()["page_ins"]) == (0, {}, 0)
    monkeypatch.setattr(tenancy, "page_to", real_page_to)
    assert _w("torch", pager.resident("a"))[0] == 0.0 and pager.stats()["page_ins"] == 1


# ---------------------------------------------------------------------------
# the watermark provider
# ---------------------------------------------------------------------------


def _rows(headroom_0, headroom_1):
    return [
        {"device": 0, "kind": "card", "available": True, "bytes_in_use": 10, "peak_bytes_in_use": 30,
         "bytes_limit": 100, "headroom_frac": headroom_0},
        {"device": 1, "kind": "card", "available": True, "bytes_in_use": 20, "peak_bytes_in_use": 50,
         "bytes_limit": 100, "headroom_frac": headroom_1},
        {"device": 2, "kind": "?", "available": False, "reason": "unreachable"},
    ]


def test_memory_watermarks_snapshot_and_latched_warning(pkg):
    rows = {"now": _rows(0.9, 0.8)}
    wm = pkg.MemoryWatermarks(0.05, stats_fn=lambda: rows["now"])
    snap = wm.snapshot()
    assert (snap["available_devices"], snap["peak_bytes_in_use_max"], snap["headroom_frac_min"]) == (2, 50, 0.8)
    assert snap["devices"] == rows["now"]
    assert wm.maybe_warn() == []
    rows["now"] = _rows(0.9, 0.01)
    log = []
    fired = wm.maybe_warn(log)
    assert [(e["event"], e["device"], e["headroom_frac"], e["threshold"]) for e in fired] == [
        ("hbm_headroom_low", 1, 0.01, 0.05)
    ]
    assert log == fired
    assert wm.maybe_warn(log) == [] and len(log) == 1  # latched per device
    # a failing source never raises into the process it watches
    assert pkg.MemoryWatermarks(stats_fn=lambda: 1 / 0).maybe_warn() == []


def test_device_memory_stats_without_a_card_is_an_explicit_row(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (row,) = device_memory_stats()
    assert row["available"] is False and "no CUDA device" in row["reason"]
    assert "bytes_in_use" not in row and "headroom_frac" not in row


# ---------------------------------------------------------------------------
# digest stability + quotas
# ---------------------------------------------------------------------------


def test_default_tenant_digest_stability_pin():
    x, y, _ = _episode(3)
    x, y = AdaptationEngine._flatten_support(x, y)
    base = support_digest(x, y, 2)
    # absent, None and explicitly-default tenants are all the pre-tenancy
    # digest — adaptation ids never churn on upgrade
    assert support_digest(x, y, 2, tenant=None) == base
    assert support_digest(x, y, 2, "maml++", None) == base
    assert support_digest(x, y, 2, tenant="acme") != base
    assert support_digest(x, y, 2, tenant="acme") != support_digest(x, y, 2, tenant="bravo")
    for tenant in (None, "acme", "bravo"):
        assert support_digest(x, y, 2, tenant=tenant) == jax_support_digest(x, y, 2, tenant=tenant)


def test_quotas_rate_inflight_and_resident_bytes(pkg):
    now = [0.0]
    q = pkg.TenantQuotas(max_inflight=2, rate_rps=1.0, max_resident_bytes=100, clock=lambda: now[0])
    assert q.enabled
    q.acquire("a")  # burst token
    with pytest.raises(pkg.QuotaExceededError) as exc:
        q.acquire("a")
    assert exc.value.reason == "rate"
    assert 0 < exc.value.retry_after_s <= 1.0  # honest token-refill time
    q.acquire("b")  # tenants do not share buckets
    now[0] += 2.0
    q.acquire("a")
    now[0] += 2.0
    with pytest.raises(pkg.QuotaExceededError) as exc:
        q.acquire("a")  # 2 inflight already held
    assert exc.value.reason == "inflight"
    q.release("a")
    now[0] += 2.0
    q.acquire("a")
    q.check_resident_bytes("a", 100)  # at the limit is fine
    with pytest.raises(pkg.QuotaExceededError):
        q.check_resident_bytes("a", 101)
    st = q.stats()
    assert st["inflight"]["a"] == 2
    assert st["rejections"] == {"a.rate": 1, "a.inflight": 1, "a.resident_bytes": 1}
    assert not pkg.TenantQuotas().enabled


# ---------------------------------------------------------------------------
# sessions: spill/rehydrate carries the tenant
# ---------------------------------------------------------------------------

_FEATURE = (4, 1, 1)


def test_session_spill_rehydrate_round_trips_tenant(tmp_path):
    store = SessionStore(str(tmp_path), _FEATURE)
    tree = {"w": torch.arange(4, dtype=torch.float32)}
    store.spill("d" * 64, tree, "fp-acme", 1.0, 600.0, tenant="acme")
    store.spill("e" * 64, tree, "fleet-fp", 1.0, 600.0)
    # without the tenant map, the tenant entry stays foreign (never served
    # under the wrong master); the default entry rehydrates
    entries, stats = store.load_all("fleet-fp", tree)
    assert stats == {"loaded": 1, "stale": 0, "corrupt": 0, "foreign": 1}
    assert [(e[0], e[4]) for e in entries] == [("e" * 64, None)]
    # with the map, the tenant entry rehydrates carrying its tenant
    entries, stats = store.load_all("fleet-fp", tree, tenant_fingerprints={"acme": "fp-acme"})
    assert stats["loaded"] == 1
    digest, loaded, _, strategy, tenant = entries[0]
    assert (digest, strategy, tenant) == ("d" * 64, "maml++", "acme")
    assert torch.equal(loaded["w"], tree["w"])


def test_tenant_session_files_cross_load_between_packages(tmp_path):
    tree = {"w": torch.arange(4, dtype=torch.float32)}
    jtree = {"w": np.arange(4, dtype=np.float32)}
    SessionStore(str(tmp_path / "port"), _FEATURE).spill("d" * 64, tree, "fp-acme", 1.0, 600.0, tenant="acme")
    JaxSessionStore(str(tmp_path / "jax")).spill("d" * 64, jtree, "fp-acme", 1.0, 600.0, tenant="acme")
    jentries, jstats = JaxSessionStore(str(tmp_path / "port")).load_all(
        "fleet-fp", jtree, tenant_fingerprints={"acme": "fp-acme"})
    entries, stats = SessionStore(str(tmp_path / "jax"), _FEATURE).load_all(
        "fleet-fp", tree, tenant_fingerprints={"acme": "fp-acme"})
    assert jstats == stats == {"loaded": 1, "stale": 0, "corrupt": 0, "foreign": 0}
    assert jentries[0][4] == entries[0][4] == "acme"
    np.testing.assert_array_equal(np.asarray(jentries[0][1]["w"]), entries[0][1]["w"].numpy())


def test_pre_tenancy_session_files_read_as_default_tenant(tmp_path):
    store = SessionStore(str(tmp_path), _FEATURE)
    tree = {"w": torch.ones(2)}
    store.spill("a" * 64, tree, "fleet-fp", 0.0, 600.0, tenant=None)
    entries, stats = store.load_all("fleet-fp", tree, tenant_fingerprints={"acme": "fp-acme"})
    assert stats["loaded"] == 1
    assert entries[0][4] is None
    # a tenant whose fingerprint moved (re-finetuned checkpoint) stays
    # foreign rather than serving stale weights
    store.spill("b" * 64, tree, "fp-old", 0.0, 600.0, tenant="acme")
    _, stats = store.load_all("fleet-fp", tree, tenant_fingerprints={"acme": "fp-new"})
    assert stats["foreign"] == 1


# ---------------------------------------------------------------------------
# parity with the JAX package: the tenants, the answers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """Both packages' systems over one master (the JAX init carried into
    the port), both packages' synthetic_registry of TENANTS over it, and an
    engine of each in tenant mode."""
    root = tmp_path_factory.mktemp("tenant_parity")
    jsystem = JaxMAMLSystem(_config(jcfg), model=jax_build_vgg(_IMG, 5, num_stages=2, cnn_num_filters=8))
    jstate = jsystem.init_train_state()
    system = _system(filters=8)
    params, bn_state, hparams = state_from_jax(
        jax.tree.map(np.asarray, jstate.params), jax.tree.map(np.asarray, jstate.bn_state),
        jax.tree.map(np.asarray, jstate.inner_hparams), system.model.feature_shape,
    )
    state = system.init_train_state()._replace(params=params, bn_state=bn_state, inner_hparams=hparams)
    jreg = jax_synthetic_registry(TENANTS, jstate, str(root / "jax"), seed=0)
    reg = synthetic_registry(TENANTS, state, str(root / "port"), seed=0, feature_shape=system.model.feature_shape)
    jengine = JaxEngine(jsystem, jstate, registry=jreg)
    engine = AdaptationEngine(system, state, registry=reg)
    return types.SimpleNamespace(root=root, system=system, state=state, jstate=jstate, jreg=jreg, reg=reg,
                                 jengine=jengine, engine=engine)


def _params_equal(a, b):
    la, pa = tree_flatten(a)
    lb, pb = tree_flatten(b)
    assert pa == pb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_synthetic_registry_tenants_match_jax(parity):
    """The same tenant parameters in both packages, bit for bit, and each
    package loads the other's checkpoints."""
    feature_shape = parity.system.model.feature_shape
    for tenant in TENANTS:
        port_dir = str(parity.root / "port" / tenant / "saved_models")
        jax_dir = str(parity.root / "jax" / tenant / "saved_models")
        written = ckpt.load_for_inference(port_dir, "latest")[0]
        jwritten = jckpt.load_for_inference(jax_dir, "latest")[0]
        _params_equal(written.params, jwritten.params)
        _params_equal(ckpt.load_for_inference(jax_dir, "latest")[0].params, jwritten.params)
        _params_equal(jckpt.load_for_inference(port_dir, "latest")[0].params, written.params)
        host, _ = parity.reg.host_state(tenant)
        jhost, _ = parity.jreg.host_state(tenant)
        _params_equal(params_to_jax(host.params, feature_shape), jax.tree.map(np.asarray, jhost.params))
    # the perturbation moved every tenant off the master
    master = params_to_jax(parity.state.params, feature_shape)
    assert not np.array_equal(tree_leaves(written.params)[0], tree_leaves(master)[0])


def test_tenant_answers_match_jax(parity):
    x, y, q = _episode(5)
    answers = {}
    for tenant in TENANTS + [None]:
        jfw = parity.jengine.adapt(x, y, tenant=tenant)
        want = np.asarray(parity.jengine.predict(jfw, q, tenant=tenant))
        got = parity.engine.predict(parity.engine.adapt(x, y, tenant=tenant), q, tenant=tenant)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        answers[tenant] = got
    # distinct masters answer distinctly
    assert min(float(abs(answers[a] - answers[b]).max()) for a in answers for b in answers if a != b) > 10 * ATOL
    assert parity.engine.compile_counts()["tenants"] == TENANTS


def test_tenant_mode_equals_single_tenant_engine(parity):
    """Adapt, refine and predict against a paged tenant master equal a
    single-tenant engine on that tenant's checkpoint exactly."""
    x, y, q = _episode(6)
    engine = parity.engine
    for tenant in TENANTS:
        ctrl = AdaptationEngine.from_run_dir(str(parity.root / "port" / tenant), "latest",
                                             cfg=parity.system.cfg, system=parity.system)
        assert ctrl.registry is None and ctrl.fingerprint == parity.reg.fingerprint(tenant)
        fw, cfw = engine.adapt(x, y, tenant=tenant), ctrl.adapt(x, y)
        np.testing.assert_array_equal(engine.predict(fw, q, tenant=tenant), ctrl.predict(cfw, q))
        rfw, crfw = engine.refine(fw, x, y, tenant=tenant), ctrl.refine(cfw, x, y)
        np.testing.assert_array_equal(engine.predict(rfw, q, tenant=tenant), ctrl.predict(crfw, q))


# ---------------------------------------------------------------------------
# over HTTP: the platform drill
# ---------------------------------------------------------------------------


def _post(base, path, body):
    """-> (status, decoded body, headers) of one POST."""
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read()), exc.headers


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as resp:
        return json.loads(resp.read())


def lru_paging(dispatches, capacity: int):
    """(page-ins, evictions, resident) of an LRU set of ``capacity`` masters
    over the tenants of a dispatch sequence (None: the default tenant,
    never paged)."""
    resident: "OrderedDict[str, None]" = OrderedDict()
    page_ins = evictions = 0
    for tenant in dispatches:
        if tenant is None:
            continue
        if tenant in resident:
            resident.move_to_end(tenant)
            continue
        resident[tenant] = None
        page_ins += 1
        while len(resident) > capacity:
            resident.popitem(last=False)
            evictions += 1
    return page_ins, evictions, list(resident)


def test_platform_drill_tenant_thrash_all_invariants(tmp_path):
    """4 tenants (distinct checkpoints) and the default behind one frontend
    over HTTP, under a budget that fits 2 masters, round-robin for 2 rounds
    of fresh supports: page-ins and evictions follow the LRU arithmetic,
    each answer equals its single-tenant control exactly, the evictions
    show in /metrics and events.jsonl, and every non-200 is a 404 or a 429
    that the access log resolves."""
    tenants = [f"t{i}" for i in range(4)]
    system = _system(support_buckets=[16], query_buckets=[16])
    state = system.init_train_state()
    registry = synthetic_registry(tenants, state, str(tmp_path / "tenants"), seed=7,
                                  feature_shape=system.model.feature_shape)
    engine = AdaptationEngine(system, state, registry=registry)
    episodes = [_episode(31 + r) for r in range(2)]
    controls = {}
    for tenant in tenants + [None]:
        ctrl = engine if tenant is None else AdaptationEngine.from_run_dir(
            str(tmp_path / "tenants" / tenant), "latest", cfg=system.cfg, system=system)
        for r, (x, y, q) in enumerate(episodes):
            controls[tenant, r] = ctrl.predict(ctrl.adapt(x, y), q)
    access_dir = str(tmp_path / "logs")
    frontend = ServingFrontend(engine, access_log_dir=access_dir)
    server = make_http_server(frontend, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    statuses, dispatches = [], []
    try:
        assert frontend.metrics()["tenants"]["pager"]["resident_bytes"] == 0
        engine.pager.budget_bytes = 2 * master_bytes(registry.host_state(tenants[0])[0])
        ids = {}
        for r, (x, y, q) in enumerate(episodes):
            payload = {"x_support": x.tolist(), "y_support": y.tolist()}
            for tenant in [None] + tenants:
                named = {} if tenant is None else {"tenant": tenant}
                status, out, _ = _post(base, "/adapt", {**payload, **named})
                statuses.append(status)
                assert status == 200 and not out["cached"] and out.get("tenant") == tenant
                ids[tenant] = out["adaptation_id"]
                status, probs, _ = _post(base, "/predict", {"adaptation_id": ids[tenant], "x_query": q.tolist(),
                                                            **named})
                statuses.append(status)
                dispatches += [tenant, tenant]
                np.testing.assert_array_equal(np.asarray(probs["probs"], np.float32), controls[tenant, r])
        page_ins, evictions, resident = lru_paging(dispatches, 2)
        pager = frontend.metrics()["tenants"]["pager"]
        assert (pager["page_ins"], pager["evictions"], pager["resident_tenants"]) == (page_ins, evictions,
                                                                                      sorted(resident))
        assert (page_ins, evictions) == (8, 6)  # every round-robin access misses
        assert pager["resident_bytes"] == pager["budget_bytes"]
        # isolation: tenant A's id as tenant B (or as the default) = 404
        non_200 = []
        for named in ({"tenant": tenants[1]}, {}):
            status, _, headers = _post(base, "/predict", {"adaptation_id": ids[tenants[0]],
                                                          "x_query": episodes[0][2].tolist(), **named})
            statuses.append(status)
            non_200.append((status, headers.get("X-Request-Id")))
        # a quota breach is the breaching tenant's alone: 429 + Retry-After
        now = [0.0]
        frontend.quotas = TenantQuotas(rate_rps=1.0, clock=lambda: now[0])
        x, y, _ = episodes[0]
        payload = {"x_support": x.tolist(), "y_support": y.tolist(), "tenant": tenants[2]}
        statuses.append(_post(base, "/adapt", payload)[0])
        status, body, headers = _post(base, "/adapt", payload)
        statuses.append(status)
        non_200.append((status, headers.get("X-Request-Id")))
        assert status == 429 and int(headers["Retry-After"]) >= 1 and 0 < body["retry_after_s"] <= 1.0
        assert _post(base, "/adapt", {**payload, "tenant": tenants[3]})[0] == 200
        # an unknown tenant is a client error
        assert _post(base, "/adapt", {**payload, "tenant": "nobody"})[0] == 400
        assert {s for s in statuses if s != 200} == {404, 429}
        metrics = _get(base, "/metrics")
        json.dumps(metrics)
        block = metrics["tenants"]
        assert set(block["by_tenant"]) == set(tenants) | {"default"}
        assert block["by_tenant"][tenants[1]]["predict.unknown_id"] == 1
        assert block["by_tenant"][tenants[2]]["adapt.shed"] == 1
        assert block["quotas"]["rejections"] == {f"{tenants[2]}.rate": 1}
        assert metrics["resilience"]["tenant_evictions"] == block["pager"]["evictions"]
        assert metrics["memory"]["available_devices"] == 0  # no card: explicit rows, no numbers
    finally:
        server.shutdown()
        server.server_close()
        frontend.close()
        thread.join(timeout=5)
    assert not thread.is_alive()
    with open(os.path.join(access_dir, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    evicted = [e for e in events if e["event"] == "tenant_evicted"]
    assert len(evicted) == block["pager"]["evictions"] and all(e["reason"] == "byte_budget" for e in evicted)
    assert len([e for e in events if e["event"] == "tenant_paged_in"]) == block["pager"]["page_ins"]
    assert all(e["tenant"] in tenants for e in evicted)  # the default tenant is never paged
    records, torn = read_access_log(os.path.join(access_dir, "access.jsonl"))
    assert torn == 0
    logged = {r["trace_id"]: r for r in records}
    for status, rid in non_200:
        assert rid in logged and logged[rid]["status"] == status
    assert {r["tenant"] for r in records if r.get("tenant")} == set(tenants)


# ---------------------------------------------------------------------------
# quota isolation and cross-tenant ids over the frontend
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tenant_fleet(tmp_path_factory):
    system = _system()
    state = system.init_train_state()
    registry = synthetic_registry(["acme", "bravo"], state, str(tmp_path_factory.mktemp("tenant_fleet")),
                                  feature_shape=system.model.feature_shape)
    frontend = ServingFrontend(AdaptationEngine(system, state, registry=registry))
    yield frontend
    frontend.close()


def test_quota_breach_sheds_429_without_degrading_others(tenant_fleet):
    x, y, _ = _episode(11)
    now = [0.0]
    saved = tenant_fleet.quotas
    tenant_fleet.quotas = TenantQuotas(rate_rps=1.0, clock=lambda: now[0])
    try:
        assert tenant_fleet.adapt(x, y, tenant="acme")["tenant"] == "acme"
        # burst=1 token at 1 rps: the immediate second request is an honest
        # 429 (quota admission runs BEFORE the cache check, so even this
        # would-be cache hit consumes admission)
        with pytest.raises(ServiceUnavailableError) as exc:
            tenant_fleet.adapt(x, y, tenant="acme")
        assert exc.value.status == 429
        assert 0 < exc.value.retry_after_s <= 1.0
        assert tenant_fleet.adapt(x, y, tenant="bravo")["tenant"] == "bravo"
        assert "tenant" not in tenant_fleet.adapt(x, y)
        m = tenant_fleet.metrics()
        assert m["tenants"]["quotas"]["rejections"] == {"acme.rate": 1}
        assert m["tenants"]["by_tenant"]["acme"]["adapt.shed"] == 1
        assert m["tenants"]["by_tenant"]["acme"]["adapt.ok"] == 1
        assert m["tenants"]["by_tenant"]["bravo"]["adapt.ok"] == 1
        assert m["tenants"]["by_tenant"]["default"]["adapt.ok"] == 1
        assert m["tenants"]["registry"]["hosted"] == 2
    finally:
        tenant_fleet.quotas = saved


def test_cross_tenant_adaptation_id_is_honest_404(tenant_fleet):
    x, y, xq = _episode(12)
    acme_id = tenant_fleet.adapt(x, y, tenant="acme")["adaptation_id"]
    assert tenant_fleet.predict(acme_id, xq, tenant="acme").shape[0] == xq.shape[0]
    with pytest.raises(UnknownAdaptationError):
        tenant_fleet.predict(acme_id, xq, tenant="bravo")
    with pytest.raises(UnknownAdaptationError):
        tenant_fleet.predict(acme_id, xq)  # nor the default tenant's


def test_engine_without_registry_rejects_tenant_traffic():
    system = _system()
    engine = AdaptationEngine(system, system.init_train_state())
    assert engine.registry is None and engine.pager is None
    x, y, _ = _episode(13)
    with pytest.raises(ValueError, match="no tenant registry"):
        engine.adapt(x, y, tenant="acme")
    frontend = ServingFrontend(engine)
    try:
        with pytest.raises(ValueError, match="no tenant registry"):
            frontend.adapt(x, y, tenant="acme")
        assert "tenants" not in frontend.metrics()
    finally:
        frontend.close()


def test_tenant_budget_bytes_flows_from_config(tmp_path):
    system = _system(tenant_budget_bytes=12345, tenant_min_headroom_frac=0.25)
    state = system.init_train_state()
    registry = synthetic_registry(["a"], state, str(tmp_path), feature_shape=system.model.feature_shape)
    engine = AdaptationEngine(system, state, registry=registry)
    assert engine.pager is not None
    assert (engine.pager.budget_bytes, engine.pager.min_headroom_frac) == (12345, 0.25)
    assert engine.pager.template is engine.state and registry.template is engine.state
    # the template's own bytes never count against the budget
    assert engine.pager.stats()["resident_bytes"] == 0
    assert tree_bytes(engine.state.params) > 0
    # the frontend hands the pagers its watermark provider
    frontend = ServingFrontend(engine)
    try:
        assert engine.pager.watermarks is frontend._memory is not None
    finally:
        frontend.close()


# ---------------------------------------------------------------------------
# the serve CLI on a run directory holding a tenants.yaml
# ---------------------------------------------------------------------------


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_cli_serves_tenants_from_run_dir(tmp_path):
    """``python -m howtotrainyourmamlpytorch_tpu_torch.serve RUN_DIR`` with
    ``RUN_DIR/tenants.yaml`` (relative run dirs) and a budget of one master
    over the config override: a tenant's adapt and predict, a second
    tenant's evicting the first, an unknown tenant's 400; SIGTERM spills
    the tenant sessions, the restart rehydrates them under their tenant."""
    cfg = tcfg.load_config(None, ["num_classes_per_set=3", "num_samples_per_class=2",
                                  "number_of_evaluation_steps_per_iter=2"])
    system = MAMLSystem(cfg, device="cpu")
    state = system.init_train_state(seed=0)
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    tcfg.save_config(cfg, os.path.join(run_dir, "config.yaml"))
    ckpt.save_checkpoint(os.path.join(run_dir, "saved_models"), state, {"epoch": 0}, epoch=0,
                         feature_shape=system.model.feature_shape)
    registry = synthetic_registry(["acme", "bravo"], state, os.path.join(run_dir, "tenants"),
                                  feature_shape=system.model.feature_shape)
    with open(os.path.join(run_dir, "tenants.yaml"), "w") as f:
        f.write("tenants:\n  acme: {run_dir: tenants/acme, checkpoint: latest}\n"
                "  bravo: {run_dir: tenants/bravo}\n")
    one_master = master_bytes(registry.host_state("acme")[0])
    batch = synthetic_batch(1, 3, 2, 1, cfg.image_shape, seed=0)
    support = {"x_support": batch["x_support"][0].tolist(), "y_support": batch["y_support"][0].tolist()}
    query = batch["x_target"][0].reshape((-1,) + cfg.image_shape).tolist()
    env = dict(os.environ, PYTHONPATH=_ROOT, OMP_NUM_THREADS="2")

    def start():
        port = _free_port()
        proc = subprocess.Popen(
            [sys.executable, "-m", "howtotrainyourmamlpytorch_tpu_torch.serve", run_dir, "--device", "cpu",
             "--port", str(port), "--checkpoint", "latest", f"serving.tenant_budget_bytes={one_master}"],
            cwd=_ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 120
        while True:
            try:
                _get(base, "/healthz")
                return proc, base
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline, proc.communicate()[0]
                time.sleep(0.2)

    proc, base = start()
    try:
        status, acme, _ = _post(base, "/adapt", {**support, "tenant": "acme"})
        assert status == 200 and acme["tenant"] == "acme"
        status, probs, _ = _post(base, "/predict", {"adaptation_id": acme["adaptation_id"], "x_query": query,
                                                   "tenant": "acme"})
        assert status == 200 and np.allclose(np.sum(probs["probs"], axis=-1), 1.0, atol=1e-5)
        assert _post(base, "/adapt", {**support, "tenant": "bravo"})[0] == 200
        assert _post(base, "/adapt", {**support, "tenant": "nobody"})[0] == 400
        metrics = _get(base, "/metrics")
        pager = metrics["tenants"]["pager"]
        assert (pager["page_ins"], pager["evictions"], pager["resident_tenants"]) == (2, 1, ["bravo"])
        assert pager["budget_bytes"] == one_master
        assert metrics["compiled"]["tenants"] == ["acme", "bravo"]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "2 session(s) spilled" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    proc, base = start()
    try:
        assert _get(base, "/metrics")["sessions"]["rehydrated"] == 2
        status, again, _ = _post(base, "/adapt", {**support, "tenant": "acme"})
        assert (status, again["adaptation_id"], again["cached"]) == (200, acme["adaptation_id"], True)
        # the rehydrated session answers as before the restart
        status, again_probs, _ = _post(base, "/predict", {"adaptation_id": acme["adaptation_id"], "x_query": query,
                                                         "tenant": "acme"})
        np.testing.assert_array_equal(np.asarray(again_probs["probs"]), np.asarray(probs["probs"]))
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=60)
