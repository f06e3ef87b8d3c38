"""Traffic-driven shape-bucket auto-tuning (a copy of the JAX package's module).

The serving engine pads every request up to a compiled (support-size /
query-count) bucket; the default edges are a guess, and the server's
padding-waste accounting (``access.jsonl`` true sizes, the
``/metrics.padding`` tallies) records what the guess costs: per-sample
FLOPs scale ~linearly in the flattened sample count, so
``padded - true`` samples are wasted device work. This module closes the
loop: consume recorded traffic, solve for the bucket edges minimizing
padded samples under a max-program-count budget, and emit the config
overrides (``serving.support_buckets=[...]`` /
``serving.query_buckets=[...]``) that the engine's bucket tables, the
strict-mode planned sets (``utils/strictmode.py::serving_planned_programs``),
and the AOT prewarm grid (``compile/aot.py::prewarm_serving``) all already
derive from — tuned edges flow everywhere by construction.

The solver is exact: for observed sizes ``s_1 < ... < s_n`` with counts
``c_i``, an optimal edge set is a subset of the observed sizes (lowering an
edge below its group's max strands requests; raising it above only adds
padding), so minimizing total padded samples over at most K edges is a
contiguous-partition DP — group ``i..j`` costs ``s_j * sum(c_i..c_j)`` —
in O(n^2 K). Optimality is test-pinned against brute force.

Deliberately stdlib-only (no jax, no package imports): ``scripts/
bucket_tune.py`` file-path-loads this module so tuning a recorded trace
never pays a jax import.
"""

import json
from typing import Any, Dict, Iterable, List, Optional, Tuple

#: observed size -> request count
SizeHistogram = Dict[int, int]


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------


def bucket_for(size: int, edges: List[int]) -> int:
    """Smallest edge >= size; an oversize request keeps its exact shape
    (compiles on demand) — the engine's ``_bucket_for`` rule, duplicated
    here in stdlib form and cross-checked by test against the engine."""
    for e in edges:
        if e >= size:
            return e
    return size


def padded_samples(hist: SizeHistogram, edges: List[int]) -> int:
    """Total device samples the traffic pays under ``edges`` (true samples
    plus padding). Proportional to padded FLOPs at fixed image shape."""
    edges = sorted(edges)
    return sum(count * bucket_for(size, edges) for size, count in hist.items())


def true_samples(hist: SizeHistogram) -> int:
    return sum(size * count for size, count in hist.items())


def waste_frac(hist: SizeHistogram, edges: List[int]) -> Optional[float]:
    """1 - true/padded over this traffic — the same definition as the
    serving ``padding_waste_frac`` gauge. None on empty traffic."""
    padded = padded_samples(hist, edges)
    if not padded:
        return None
    return round(1.0 - true_samples(hist) / padded, 4)


# ---------------------------------------------------------------------------
# the exact solver
# ---------------------------------------------------------------------------


def optimal_edges(hist: SizeHistogram, max_buckets: int) -> List[int]:
    """Bucket edges minimizing :func:`padded_samples` over ``hist`` using
    at most ``max_buckets`` edges. The top edge is always the largest
    observed size (everything must be covered). Exact DP, O(n^2 K) in the
    number of distinct sizes."""
    if max_buckets < 1:
        raise ValueError(f"max_buckets must be >= 1, got {max_buckets}")
    sizes = sorted(s for s in hist if hist[s] > 0)
    if not sizes:
        return []
    n = len(sizes)
    k_max = min(max_buckets, n)
    counts = [hist[s] for s in sizes]
    prefix = [0] * (n + 1)
    for i, c in enumerate(counts):
        prefix[i + 1] = prefix[i] + c
    inf = float("inf")
    # dp[k][j] = min padded samples covering sizes[:j] with exactly k edges
    dp = [[inf] * (n + 1) for _ in range(k_max + 1)]
    choice = [[0] * (n + 1) for _ in range(k_max + 1)]
    dp[0][0] = 0.0
    for k in range(1, k_max + 1):
        for j in range(1, n + 1):
            best, best_i = inf, 0
            for i in range(k - 1, j):
                if dp[k - 1][i] == inf:
                    continue
                cost = dp[k - 1][i] + sizes[j - 1] * (prefix[j] - prefix[i])
                if cost < best:
                    best, best_i = cost, i
            dp[k][j] = best
            choice[k][j] = best_i
    k_best = min(range(1, k_max + 1), key=lambda k: dp[k][n])
    edges: List[int] = []
    j = n
    for k in range(k_best, 0, -1):
        edges.append(sizes[j - 1])
        j = choice[k][j]
    return sorted(edges)


# ---------------------------------------------------------------------------
# traffic sources
# ---------------------------------------------------------------------------


def traffic_from_access_log(path: str) -> Dict[str, SizeHistogram]:
    """Per-verb true-size histograms off ``logs/access.jsonl`` (the precise
    source: every line carries the pre-padding sample count). Only ``ok``
    lines count — sheds and router rejections never dispatched, so their
    sizes are not padded FLOPs (the same rule the padding gauge applies).
    Torn lines are skipped, matching every other access-log reader."""
    out: Dict[str, SizeHistogram] = {"adapt": {}, "predict": {}}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            verb, size = rec.get("verb"), rec.get("true_size")
            if verb not in out or size is None or rec.get("outcome") != "ok":
                continue
            hist = out[verb]
            hist[int(size)] = hist.get(int(size), 0) + 1
    return out


def traffic_from_metrics(metrics: Dict[str, Any]) -> Dict[str, SizeHistogram]:
    """Approximate per-verb histograms off a ``/metrics`` snapshot's
    ``padding.by_bucket`` tallies (``{verb: {bucket: {count,
    true_samples}}}``): each bucket's traffic is placed at its mean true
    size, plus ONE sentinel request at the largest occupied bucket's edge —
    the upper bound of the recorded sizes. The sentinel pins the tuned top
    edge at (or above) that bound, so traffic the tallies DID see can never
    be stranded below it just because its bucket mean sat lower (sizes
    within a bucket are only known up to the edge). Bucket-granular — good
    enough to tune against, but the access log is the precise source."""
    padding = metrics.get("padding", metrics) or {}
    by_bucket = padding.get("by_bucket") or {}
    out: Dict[str, SizeHistogram] = {"adapt": {}, "predict": {}}
    for verb, buckets in by_bucket.items():
        if verb not in out:
            continue
        top_edge = 0
        for bucket_id, row in (buckets or {}).items():
            count = int(row.get("count") or 0)
            true = int(row.get("true_samples") or 0)
            if count <= 0 or true <= 0:
                continue
            try:
                top_edge = max(top_edge, int(bucket_id))
            except (TypeError, ValueError):
                pass
            mean = max(1, round(true / count))
            out[verb][mean] = out[verb].get(mean, 0) + count
        if out[verb] and top_edge > max(out[verb]):
            out[verb][top_edge] = out[verb].get(top_edge, 0) + 1
    return out


def merge_histograms(histograms: Iterable[SizeHistogram]) -> SizeHistogram:
    out: SizeHistogram = {}
    for hist in histograms:
        for size, count in hist.items():
            out[size] = out.get(size, 0) + count
    return out


# ---------------------------------------------------------------------------
# program-count budget
# ---------------------------------------------------------------------------


def batch_bucket_count(max_batch: int) -> int:
    """How many task-batch buckets the engine's power-of-two rounding
    produces for ``max_batch`` (``serving/engine.py::_batch_bucket``:
    powers of two below ``max_batch``, plus ``max_batch`` itself).
    Duplicated here in stdlib form; cross-checked by test against
    ``utils/strictmode.py::batch_buckets`` so the rules can't drift."""
    count, b = 0, 1
    while b < max_batch:
        count += 1
        b *= 2
    return count + 1


def shape_buckets_for_program_budget(max_programs: int, max_batch: int) -> int:
    """Per-verb shape-bucket budget from a TOTAL compiled-program budget:
    the planned serving grid is (adapt + predict) x shape bucket x
    task-batch bucket, so each shape bucket costs ``2 *
    batch_bucket_count`` programs."""
    per_bucket = 2 * batch_bucket_count(max_batch)
    return max(1, max_programs // per_bucket)


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------

_VERB_TO_KEY = {"adapt": "support_buckets", "predict": "query_buckets"}


def tune(
    traffic: Dict[str, SizeHistogram],
    current_support: List[int],
    current_query: List[int],
    max_buckets: Optional[int] = None,
    max_programs: Optional[int] = None,
    max_batch: int = 8,
    keep_max_edge: bool = False,
) -> Dict[str, Any]:
    """Solve both verbs and emit the override payload.

    ``max_buckets`` caps edges per verb (default: the current edge count,
    so tuning is waste-for-waste comparable); ``max_programs`` instead caps
    the TOTAL planned serving grid and derives the per-verb cap. With
    ``keep_max_edge`` the current top edge is appended when it exceeds the
    tuned top, preserving coverage for sizes the recorded traffic never
    showed (it costs one budget slot). A verb with no recorded traffic
    keeps its current edges and emits no override."""
    if max_programs is not None:
        max_buckets = shape_buckets_for_program_budget(max_programs, max_batch)
    current = {"adapt": sorted(current_support), "predict": sorted(current_query)}
    verbs: Dict[str, Any] = {}
    overrides: List[str] = []
    edges_out: Dict[str, List[int]] = {}
    for verb, key in _VERB_TO_KEY.items():
        hist = traffic.get(verb) or {}
        cur = current[verb]
        if not hist:
            verbs[verb] = {
                "requests": 0,
                "edges": cur,
                "tuned": False,
                "reason": "no recorded traffic",
            }
            edges_out[key] = cur
            continue
        budget = max_buckets if max_buckets is not None else max(1, len(cur))
        edges = optimal_edges(hist, budget)
        if keep_max_edge and cur and cur[-1] > edges[-1]:
            # the appended coverage edge costs one budget slot (the
            # documented contract): re-solve one edge short so the append
            # never silently exceeds — or silently skips — the budget. At
            # budget 1 coverage wins: the single edge is the current top.
            if len(edges) >= budget:
                edges = (
                    optimal_edges(hist, budget - 1) if budget > 1 else []
                )
            if not edges or cur[-1] > edges[-1]:
                edges.append(cur[-1])
        verbs[verb] = {
            "requests": sum(hist.values()),
            "true_samples": true_samples(hist),
            "edges": edges,
            "tuned": True,
            "padded_before": padded_samples(hist, cur),
            "padded_after": padded_samples(hist, edges),
            "waste_frac_before": waste_frac(hist, cur),
            "waste_frac_after": waste_frac(hist, edges),
        }
        edges_out[key] = edges
        overrides.append(f"serving.{key}={json.dumps(edges)}")
    tuned = [v for v in verbs.values() if v.get("tuned")]
    total_before = sum(v["padded_before"] for v in tuned)
    total_after = sum(v["padded_after"] for v in tuned)
    total_true = sum(v["true_samples"] for v in tuned)
    return {
        "verbs": verbs,
        "edges": edges_out,
        "overrides": overrides,
        "config": {"serving": dict(edges_out)},
        "padded_before": total_before,
        "padded_after": total_after,
        "padding_waste_frac_before": (
            round(1.0 - total_true / total_before, 4) if total_before else None
        ),
        "padding_waste_frac_after": (
            round(1.0 - total_true / total_after, 4) if total_after else None
        ),
    }
