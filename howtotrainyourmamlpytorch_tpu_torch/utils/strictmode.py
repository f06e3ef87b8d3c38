"""Strict mode: hold the dispatched program families to their declared plan
(JAX package ``utils/strictmode.py``).

The framework's performance story rests on small, closed program families:
the runner's train-step variants keyed by ``(second_order, msl_active)``
and the serving engine's ``(shape bucket, task-batch bucket)`` grid. In the
JAX package every key outside the family is an unplanned XLA compile. In
eager PyTorch nothing is compiled, but the first dispatch of a new shape
still pays once: cuDNN picks its convolution algorithms for the shape and
the caching allocator takes its first blocks for it. An unplanned key is
that cost on the hot path, invisible until someone reads ``/metrics``.
:class:`RecompileGuard` makes it loud: a first dispatch of an unplanned key
(or one past the count budget) raises :class:`RecompileBudgetExceededError`
immediately, with the offending key in the message.

Enabled via ``Config.strict_recompile_guard`` (wired into ``MAMLSystem``
and ``AdaptationEngine``, which note their program keys themselves), or
used directly as a context manager in tests::

    with RecompileGuard(budget=2, name="adapt") as guard:
        fn = guard.wrap(adapt)
        fn(small_batch); fn(small_batch)   # one first dispatch
        fn(big_batch)                      # second signature: at budget
        fn(odd_batch)                      # third: raises

``wrap`` counts first calls per abstract argument signature (shape and
dtype of every tensor argument, plus the value of every hashable
non-tensor argument): the eager counterpart of the JAX ``wrap``, which
counts lowerings of a jitted function. There is no program cache to
cross-check, so a wrapped function is judged by its signatures alone.
"""

import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Set, Tuple


class RecompileBudgetExceededError(RuntimeError):
    """A program family grew past its declared budget (or off its planned
    key set): an unplanned first dispatch."""


def abstract_signature(value: Any) -> Any:
    """Hashable (shape, dtype)-level abstraction of a call argument: two
    arguments with equal signatures dispatch the same shapes."""
    if hasattr(value, "shape") and hasattr(value, "dtype"):
        return ("arr", tuple(value.shape), str(value.dtype))
    if isinstance(value, dict):
        return (
            "dict",
            tuple(sorted((k, abstract_signature(v)) for k, v in value.items())),
        )
    if isinstance(value, (list, tuple)):
        kind = "list" if isinstance(value, list) else "tuple"
        return (kind, tuple(abstract_signature(v) for v in value))
    # NamedTuple-ish tree nodes (TrainState)
    if hasattr(value, "_fields"):
        return (
            type(value).__name__,
            tuple(abstract_signature(getattr(value, f)) for f in value._fields),
        )
    try:
        hash(value)
        return ("static", value)
    except TypeError:
        return ("opaque", type(value).__name__)


class RecompileGuard:
    """Count first dispatches against a declared program-family budget.

    ``planned`` (optional): the exact set of allowed program keys; any
    ``note()`` outside it raises immediately. ``budget`` (optional): a cap
    on the number of distinct programs. Either alone works; together the
    planned set is checked first. ``strict=False`` records violations in
    ``.violations`` instead of raising (observe-only mode).
    """

    def __init__(
        self,
        budget: Optional[int] = None,
        planned: Optional[Iterable[Any]] = None,
        name: str = "dispatch",
        strict: bool = True,
    ):
        if budget is None and planned is None:
            raise ValueError("RecompileGuard needs a budget, a planned set, or both")
        self.name = name
        self.strict = strict
        self.planned: Optional[Set[Any]] = set(planned) if planned is not None else None
        self.budget = int(budget) if budget is not None else len(self.planned)  # type: ignore[arg-type]
        self._lock = threading.Lock()
        # optional CompileLedger (observability/compile_ledger.py): wrap()
        # records the first-call seconds of every new signature there
        self.ledger = None
        self._seen: List[Any] = []
        # violating key -> message: a rejected key is NOT recorded as seen,
        # so a retried unplanned request re-raises instead of slipping past
        # the guard on the second attempt
        self._rejected: Dict[Any, str] = {}
        self.violations: List[str] = []
        # the serving prewarm (AdaptationEngine.prewarm) flips the contract
        # from "detect drift" to "enforce the prewarmed set": once
        # mark_prewarmed() has declared the family complete, ANY first-noted
        # key (planned or not, within budget or not) is a finding
        self._prewarmed = False

    # ------------------------------------------------------------------

    @property
    def lowerings(self) -> int:
        """Distinct keys accepted so far (the JAX name: its keys are
        lowerings; here each is a first dispatch)."""
        with self._lock:
            return len(self._seen)

    def note(self, key: Any) -> None:
        """Record that a program is about to be dispatched for ``key``.
        Idempotent per accepted key; an unplanned/over-budget key raises,
        and keeps raising on every retry of the same key (it is never
        accepted, so a client hammering an oversize request can't wear the
        guard down)."""
        with self._lock:
            try:
                if key in self._rejected:
                    msg: Optional[str] = self._rejected[key]
                elif key in self._seen:
                    return
                else:
                    msg = None
            except TypeError:  # unhashable key: fall back to the seen list
                if key in self._seen:
                    return
                msg = None
            if msg is None:
                problem = None
                if self._prewarmed:
                    problem = (
                        f"program {key!r} compiled OUTSIDE prewarm (the "
                        f"prewarmed set of {len(self._seen)} programs was "
                        f"declared complete)"
                    )
                elif self.planned is not None and key not in self.planned:
                    problem = (
                        f"unplanned program {key!r} (planned family: "
                        f"{sorted(map(repr, self.planned))})"
                    )
                elif len(self._seen) + 1 > self.budget:
                    problem = (
                        f"program {key!r} is lowering "
                        f"#{len(self._seen) + 1} against a budget of "
                        f"{self.budget}"
                    )
                if problem is None:
                    self._seen.append(key)
                    return
                msg = f"RecompileGuard[{self.name}]: {problem}"
                try:
                    self._rejected[key] = msg
                except TypeError:
                    pass
                self.violations.append(msg)
        if self.strict:
            raise RecompileBudgetExceededError(msg)

    def mark_prewarmed(self) -> None:
        """Declare the seen set complete (the prewarm just dispatched the
        whole planned family): from here on a first-noted key of ANY kind is
        a violation."""
        with self._lock:
            self._prewarmed = True

    @property
    def prewarmed(self) -> bool:
        with self._lock:
            return self._prewarmed

    def reset(self) -> None:
        """Forget seen programs (a deliberate re-plan, e.g. the rollback LR
        backoff rebuilding the outer schedule, re-plans the same family),
        which also un-seals a prewarmed guard."""
        with self._lock:
            self._seen.clear()
            self._rejected.clear()
            self._prewarmed = False

    def check(self) -> None:
        """Raise if any violation was recorded (useful with strict=False)."""
        with self._lock:
            violations = list(self.violations)
        if violations:
            raise RecompileBudgetExceededError("; ".join(violations))

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "name": self.name,
                "budget": self.budget,
                "lowerings": len(self._seen),
                "prewarmed": self._prewarmed,
                "violations": list(self.violations),
            }

    # ------------------------------------------------------------------

    def wrap(self, fn: Callable, key_fn: Optional[Callable] = None) -> Callable:
        """Wrap a callable: each call computes the abstract signature of its
        arguments (or ``key_fn(*args, **kwargs)``) and ``note()``s it, so
        the first call of every new signature counts against the plan."""

        fn_label = getattr(fn, "__name__", None) or type(fn).__name__

        def wrapped(*args, **kwargs):
            sig = key_fn(*args, **kwargs) if key_fn is not None else abstract_signature((args, kwargs))
            before = self.lowerings
            self.note(sig)
            ledger = self.ledger
            # a first call of a new signature: its seconds go to the ledger
            # (total only: an eager call has no build phases to split)
            time_it = ledger is not None and self.lowerings > before
            t0 = time.perf_counter() if time_it else 0.0
            out = fn(*args, **kwargs)
            if time_it:
                ledger.record(f"{self.name}/{fn_label}", total_s=time.perf_counter() - t0,
                              signature_index=self.lowerings)
            return out

        wrapped.guard = self  # type: ignore[attr-defined]
        return wrapped

    def __enter__(self) -> "RecompileGuard":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.check()
        return False


# ---------------------------------------------------------------------------
# declared program families for this framework
# ---------------------------------------------------------------------------


def batch_buckets(max_batch: int) -> Tuple[int, ...]:
    """The task-batch sizes the serving engine pads to, derived from the
    engine's own ``_batch_bucket`` so a change to its rounding policy can
    never drift the planned set out from under the guard."""
    from ..serving.engine import _batch_bucket  # local: avoid import cycle

    return tuple(sorted({_batch_bucket(n, max_batch) for n in range(1, max_batch + 1)}))


def serving_planned_programs(serving_cfg) -> Set[Tuple[str, int, int]]:
    """Every (kind, shape-bucket, batch-bucket) program the engine's bucket
    tables plan for, per configured strategy (``ServingConfig.strategies``),
    keyed through ``config.strategy_kind``: the default strategy keeps the
    bare kinds. The refine grid mirrors the adapt grid for every strategy
    with a fast-weight rollout, under ``serving.refine_enabled`` only
    (protonet refreshes run through its adapt program). A request larger
    than the largest bucket, or naming a valid but unconfigured strategy,
    dispatches its exact shape on demand: correct, but unplanned."""
    from ..config import strategy_kind  # local: keep module deps one-way

    batches = batch_buckets(serving_cfg.max_batch_size)
    strategies = tuple(getattr(serving_cfg, "strategies", None) or ("maml++",))
    refine = bool(getattr(serving_cfg, "refine_enabled", False))
    planned: Set[Tuple[str, int, int]] = set()
    for strategy in strategies:
        adapt_kind = strategy_kind("adapt", strategy)
        predict_kind = strategy_kind("predict", strategy)
        for bucket in serving_cfg.support_buckets:
            planned.update((adapt_kind, bucket, b) for b in batches)
            if refine and strategy != "protonet":
                refine_kind = strategy_kind("refine", strategy)
                planned.update((refine_kind, bucket, b) for b in batches)
        for bucket in serving_cfg.query_buckets:
            planned.update((predict_kind, bucket, b) for b in batches)
    return planned


def train_planned_programs(cfg) -> Set[Tuple[str, ...]]:
    """The runner-side program family: the train step (single and
    multi-dispatch) keyed by the (second_order, msl_active) switches the
    config can reach, plus the eval programs, under the configured
    ``Config.strategy``'s kind spelling. Over-planning is free (the set only
    rejects); a switch that is on plans both of its values, and fomaml pins
    second order off for the whole run."""
    from ..config import strategy_kind  # local: keep module deps one-way

    strategy = getattr(cfg, "strategy", "maml++")
    so_values = {False} if not cfg.second_order or strategy == "fomaml" else {True, False}
    msl_values = {False} if not cfg.use_multi_step_loss_optimization else {True, False}
    planned: Set[Tuple[str, ...]] = {
        (strategy_kind("eval", strategy),),
        (strategy_kind("eval_multi", strategy),),
    }
    for so in so_values:
        for msl in msl_values:
            planned.add((strategy_kind("train", strategy), so, msl))
            planned.add((strategy_kind("train_multi", strategy), so, msl))
    return planned
