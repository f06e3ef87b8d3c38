"""Traffic driver ``open_loop_adapt_predict``: independent clients, each
sending one task (a fresh labelled support set and its queries) to the
in-process serving frontend (``ServingFrontend.adapt_predict``) and waiting
for the probabilities; arrivals on a fixed open-loop schedule.

The schedule (the arrival arithmetic of the port's
``observability/slo.py::generate_schedule``): inter-arrival gaps lognormal
with mean ``1 / rate_per_s`` and ``tail_sigma`` in log space. So that every
seed offers the same work, the set of gaps and the multiset of query sizes
are fixed by ``shape_seed`` and the cell's length, and ``--seed`` only
orders them and draws the images: ``round(rate_per_s * seconds)`` requests,
the gaps scaled to fill the window. A request's latency runs from its
scheduled send time to the return of ``adapt_predict``; a request that
fails counts as missing every latency.

The deployment runs as the port's serve CLI runs it on a card, under the
deterministic algorithms (the traffic's ``deterministic_algorithms``).
Set-up makes the master weights (learning rates drawn around the
configuration's inner lr) on the card from the seed, builds the engine
with the buckets of this traffic only (the support size and each query
size), captures its programs (``engine.prewarm``), starts the frontend and
sends a short burst of warm-up requests outside the window.

End to end: ``serve_tasks_per_s``, the requests answered over the window
(from its start to the last answer): the offered rate where the deployment
keeps up, what it sustains where the rate lies above its knee. The median
and 95th percentile of the requests' latencies are per-layer readings
(``latency_p50_ms.serve``, ``latency_p95_ms.serve``).

``correct``: after the window, a sample of the answered requests drawn
from the seed (half of it among the longest, the largest query size) is
recomputed by the reference, adapt then predict, one request at a time.
"""

import contextlib
import gc
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from harness import compare, program
from harness import trace as tracing
from harness.runtime import seconds_since_start
from reference import maml as ref

WARM_REQUESTS = 16
STREAM_WINDOW, STREAM_TRACE, STREAM_WARM = 0, 1, 2


def schedule(traffic: Dict, seed: int, seconds: float):
    """-> (send times from the window's start [s], query sizes), one per
    request; the same gaps and sizes for every seed, in the seed's order."""
    rate, sigma = float(traffic["rate_per_s"]), float(traffic["tail_sigma"])
    n = max(1, int(round(rate * seconds)))
    shape = np.random.default_rng(int(traffic["shape_seed"]))
    gaps = shape.lognormal(np.log(1.0 / rate) - sigma ** 2 / 2.0, sigma, n)
    gaps *= seconds / gaps.sum()
    weights = np.asarray(traffic["query_weights"], np.float64)
    counts = np.floor(weights / weights.sum() * n).astype(int)
    counts[np.argsort(-(weights / weights.sum() * n - counts))[: n - counts.sum()]] += 1
    sizes = np.repeat(np.asarray(traffic["query_sizes"], int), counts)
    order = np.random.default_rng([int(seed), 7])
    gaps, sizes = order.permutation(gaps), order.permutation(sizes)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]]), sizes


def request(cfgd: Dict, seed: int, stream: int, i: int, n_query: int, noise_share: float):
    """The images and labels of request ``i`` (host float32 arrays): a
    prototype image per class, each support image and query (of class
    ``q mod n_way``) the prototype mixed with ``noise_share`` of its own
    uniform noise (``harness/program.py::episodes``)."""
    rng = np.random.default_rng([int(seed), stream, i])
    n, k = int(cfgd["num_classes_per_set"]), int(cfgd["num_samples_per_class"])
    img = ref.image_shape(cfgd)
    proto = rng.random((n, 1) + img, dtype=np.float32) * np.float32(1.0 - noise_share)
    noise = np.float32(noise_share)
    x_s = rng.random((n, k) + img, dtype=np.float32) * noise + proto
    y_s = np.repeat(np.arange(n, dtype=np.int32)[:, None], k, axis=1)
    x_q = rng.random((n_query,) + img, dtype=np.float32) * noise + proto[np.arange(n_query) % n, 0]
    return x_s, y_s, x_q


class _Flushes:
    """Wraps the engine's adapt and predict flushes in harness spans (the
    batcher worker calls the engine's methods at flush time). While a
    traced window records, each adapt flush is bracketed by CUDA events on
    its stream: their elapsed times are the replayed adapt programs'
    device time (``adapt_seconds``)."""

    def __init__(self, engine, spans):
        self.spans, self.events = spans, []
        for name, span in (("adapt_batch", "bench.adapt_flush"), ("predict_batch", "bench.predict_flush")):
            inner = getattr(engine, name)

            def flush(*args, _inner=inner, _span=span, **kwargs):
                timed = _span == "bench.adapt_flush" and self.spans.annotate and torch.cuda.is_available()
                if timed:
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                with self.spans.span(_span):
                    out = _inner(*args, **kwargs)
                if timed:
                    end.record()
                    self.events.append((start, end))
                return out

            setattr(engine, name, flush)

    def adapt_seconds(self) -> List[float]:
        """The timed adapt flushes' device seconds (after the card is idle)."""
        return [start.elapsed_time(end) / 1e3 for start, end in self.events]


def _drive(run, frontend, cfgd, stream: int, times, sizes, keep=frozenset()):
    """One open-loop schedule against the frontend -> per-request rows
    ``(ok, latency s, done s from start, lateness s)`` and the answers of
    the requests in ``keep``."""
    rows: List = [None] * len(times)
    answers: Dict[int, np.ndarray] = {}
    lock = threading.Lock()

    def call(i, inputs, due):
        ok = True
        try:
            with run.spans.span("bench.request"):
                out = frontend.adapt_predict(*inputs)
        except Exception as exc:  # noqa: BLE001 — a failed request is counted, never raised
            ok = False
            print(f"benchmark: request {i} failed: {type(exc).__name__}: {exc}", file=sys.stderr, flush=True)
        done = time.perf_counter()
        with lock:
            rows[i] = [ok, done - due, done - t0, rows[i][3] if rows[i] else 0.0]
            if ok and i in keep:
                answers[i] = np.asarray(out["probs"], np.float32)

    pool = ThreadPoolExecutor(max_workers=int(run.traffic["clients"]), thread_name_prefix="bench-client")
    futures = []
    t0 = time.perf_counter() + 0.05
    for i, (t, q) in enumerate(zip(times, sizes)):
        inputs = request(cfgd, run.seed, stream, i, int(q), float(run.traffic["noise_share"]))
        due = t0 + float(t)
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late = time.perf_counter() - due
        with lock:
            rows[i] = [False, float("inf"), float("inf"), late]
        futures.append(pool.submit(call, i, inputs, due))
    deadline = time.perf_counter() + float(run.traffic["drain_s"])
    for fut in futures:
        fut.result(timeout=max(0.1, deadline - time.perf_counter()))
    pool.shutdown(wait=True)
    return rows, answers


def _percentile(values, q: float) -> float:
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(np.ceil(q * len(ordered))) - 1)]


def setup(run):
    from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine
    from howtotrainyourmamlpytorch_tpu_torch.serving.server import ServingFrontend

    cfgd, traffic, device = run.config["maml"], run.traffic, run.device
    support = int(cfgd["num_classes_per_set"]) * int(cfgd["num_samples_per_class"])
    extra = {"serving.support_buckets": [support], "serving.query_buckets": sorted(set(traffic["query_sizes"]))}
    extra.update(run.program_overrides)
    system = MAMLSystem(program.program_config(cfgd, extra), device=device)
    params = ref.init_params(cfgd, program.generator(run.seed, 0, device), device)
    lr = float(cfgd["inner_optim"]["lr"])
    draws = torch.rand(len(params), generator=program.generator(run.seed, 2, device), device=device)
    lrs = {k: lr * (0.5 + draws[i]) for i, k in enumerate(params)}
    engine = AdaptationEngine(system, program.train_state(system, params, lrs))
    flushes = _Flushes(engine, run.spans)
    run.faults.apply(engine)
    engine.prewarm()
    frontend = ServingFrontend(engine, replicas=1)
    warm_times = np.linspace(0.0, 0.2, WARM_REQUESTS)
    warm_sizes = np.resize(np.asarray(traffic["query_sizes"], int), WARM_REQUESTS)
    _drive(run, frontend, cfgd, STREAM_WARM, warm_times, warm_sizes)
    return {"engine": engine, "frontend": frontend, "flushes": flushes, "params": params, "lrs": lrs,
            "steps": engine.num_steps}


def check(run, built, answers: Dict[int, np.ndarray], sizes) -> Dict[str, Dict[str, float]]:
    cfgd, device = run.config["maml"], run.device
    params, lrs, steps = built["params"], built["lrs"], built["steps"]
    built.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref.strict_float32()
    dtype = getattr(torch, run.config.get("reference_dtype", "float32"))
    p = {k: v.to(dtype) for k, v in params.items()}
    a = {k: v.to(dtype) for k, v in lrs.items()}
    gaps, t0 = [], time.perf_counter()
    for i, probs in sorted(answers.items()):
        x_s, y_s, x_q = request(cfgd, run.seed, STREAM_WINDOW, i, int(sizes[i]), float(run.traffic["noise_share"]))
        expect = ref.adapt_predict(
            cfgd, p, a, torch.as_tensor(x_s, device=device, dtype=dtype).reshape((-1,) + x_s.shape[2:]),
            torch.as_tensor(y_s.reshape(-1), device=device, dtype=torch.int64),
            torch.as_tensor(x_q, device=device, dtype=dtype), steps)
        gaps.append(float((torch.as_tensor(probs, device=device, dtype=dtype) - expect).abs().max()))
    gaps.sort()
    readings = {"prob_gap": gaps[-1] if gaps else 0.0, "prob_gap_median_request": gaps[len(gaps) // 2] if gaps else 0.0}
    print(f"benchmark: reference {time.perf_counter() - t0:.1f} s over {len(answers)} requests; readings {readings}",
          file=sys.stderr, flush=True)
    run.readings = readings
    return compare.judge(readings, run.limits)


def sample(traffic: Dict, seed: int, sizes) -> List[int]:
    """The requests the reference checks: half among the largest queries,
    the rest among all, drawn from the seed."""
    rng = np.random.default_rng([int(seed), 11])
    n = min(int(traffic["check_requests"]), len(sizes))
    longest = np.flatnonzero(sizes == sizes.max())
    picked = set(rng.choice(longest, size=min(n // 2, len(longest)), replace=False).tolist())
    rest = [i for i in rng.permutation(len(sizes)).tolist() if i not in picked]
    return sorted(picked.union(rest[: n - len(picked)]))


def deployment(run):
    """The deterministic algorithms where the traffic says its deployment
    runs under them (the port's serve CLI does on a card), else nothing."""
    from howtotrainyourmamlpytorch_tpu_torch.utils.seeding import deterministic_algorithms

    on = bool(run.traffic.get("deterministic_algorithms")) and run.device.type == "cuda"
    return deterministic_algorithms() if on else contextlib.nullcontext()


def run(run):
    with deployment(run):
        return _run(run)


def _run(run):
    cfgd, traffic = run.config["maml"], run.traffic
    built = setup(run)
    frontend = built["frontend"]
    on_card = run.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    times, sizes = schedule(traffic, run.seed, run.seconds)
    keep = frozenset(sample(traffic, run.seed, sizes))
    before = frontend.pool.batcher_stats("adapt")
    setup_s = seconds_since_start()
    print(f"benchmark: set-up {setup_s:.1f} s", file=sys.stderr, flush=True)
    rows, answers = _drive(run, frontend, cfgd, STREAM_WINDOW, times, sizes, keep)
    after = frontend.pool.batcher_stats("adapt")
    ok = [r for r in rows if r[0]]
    latencies = [r[1] if r[0] else float("inf") for r in rows]
    flushes = after["flushes"] - before["flushes"]
    record = {"requests": len(rows), "lateness_s": [r[3] for r in rows],
              "adapt_requests": after["requests"] - before["requests"], "adapt_flushes": flushes,
              "precision": run.config["precision"], "answer_s": max((r[2] for r in ok), default=0.0),
              "flops_answered": sum(float(run.config.get("flops_per_task", {}).get(str(int(q)), 0.0))
                                    for r, q in zip(rows, sizes) if r[0])}
    record["p50_ms"], record["p95_ms"] = (1e3 * _percentile(latencies, q) for q in (0.50, 0.95))
    metrics = {"serve_tasks_per_s": len(ok) / record["answer_s"] if ok else 0.0, "setup_s": setup_s,
               "serve_p50_ms": record["p50_ms"], "serve_p95_ms": record["p95_ms"]}
    if on_card:
        torch.cuda.synchronize()
        record["memory_peak_bytes"] = max(setup_peak, torch.cuda.max_memory_allocated())
    failed = len(rows) - len(ok)
    late = sorted(record["lateness_s"])
    print(f"benchmark: {len(rows)} requests, {failed} failed; generator late p50 {1e3 * late[len(late) // 2]:.3f} ms, "
          f"max {1e3 * late[-1]:.3f} ms; adapt flushes {flushes}; latency p50 {record['p50_ms']!r} ms, "
          f"p95 {record['p95_ms']!r} ms; answered {metrics['serve_tasks_per_s']!r} /s", file=sys.stderr, flush=True)
    if run.trace:
        t_times, t_sizes = schedule(traffic, run.seed + 1, float(traffic["trace_seconds"]))
        (t_rows, _), record["trace"] = tracing.traced(
            lambda: _drive(run, frontend, cfgd, STREAM_TRACE, t_times, t_sizes), run.spans, run.device)
        failed += sum(1 for r in t_rows if not r[0])
        record["adapt_flush_s"] = built["flushes"].adapt_seconds()
    frontend.close()
    del frontend
    checks = check(run, built, answers, sizes)
    correct = compare.passed(checks) and failed == 0 and set(answers) == set(keep)
    return {"correct": correct, "attempted": len(rows), "failed": failed, "metrics": metrics, "checks": checks,
            "record": record}
