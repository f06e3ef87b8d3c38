"""The MAML++ meta-step and adaptation in PyTorch: the train/eval and serving
subset of the JAX package's ``core/maml.py``.

The JAX package ``jax.vmap``s a per-task rollout and ``lax.scan``s its inner
steps. Here the inner steps are a Python loop, and the task axis is explicit:
a meta-batch ``[B, n_way, k, H, W, C]`` becomes ``[B, n_way * k, H, W, C]``
and every fast-weight leaf carries a leading task axis. Each inner step
takes the per-task support gradients with
``torch.func.vmap(torch.func.grad(...))`` and then applies the inner
optimizer OUTSIDE the vmap, to the task-stacked tree: with
``use_pallas_inner_update`` every task's leaves update in one fused-update
launch over the tree (``ops/fused_update.py``), and in ``train_step`` the
outer backward runs that update's backward kernel once per inner step.

``train_step`` differentiates the meta-objective with ``torch.autograd``:
second order keeps the graph of the inner gradients (``torch.func.grad``'s
results carry it), first order detaches them. Then the ImageNet +-10 clamp,
the outer Adam on the cosine schedule (``ops/outer_adam.py``), the lr
projection and ``step + 1``. ``eval_step``, ``adapt_fast_weights`` and
``predict_logits`` are first-order and run under ``torch.no_grad()``
(``torch.func.grad`` still takes the inner gradients).

The inner optimizer is sgd (fused or not), adam or rprop, its state carried
with the task axis from step 0; inner Adam warm-starts its moments from the
outer Adam's (``warm_start_inner_opt_from_outer``) in the meta-objective and
``adapt_fast_weights``, and from zero where no outer state is given (the
serving engine). ``lslr_per_step`` learns a ``[K]`` vector per hparam
tensor, step i reading element i as a 0-d view.

Remat (``Config.resolved_remat_policy``, ``core/remat.py``): each inner
step of ``_adapt_loop`` and of the MSL branch of ``_rollout`` is recomputed
in the outer backward instead of keeping its activations, where autograd
records it.

Strategies (``core/strategies.py``): ``Config.strategy`` selects what the
meta-objective trains: ``maml++``, ``fomaml`` (the same rollout, first
order at every epoch) or ``anil`` (the head-only inner loop).
``adapt_fast_weights`` and ``refine_fast_weights`` take a strategy per call
(serving is first order, so maml++ and fomaml coincide there);
``protonet_adapt`` and ``protonet_predict_logits`` serve ProtoNet.
``refine_fast_weights`` runs the adapt rollout from fast weights that
already carry the task axis, with the hparams and inner state of the
masters.

Data parallelism (``parallel/mesh.py``): ``train_step``, ``eval_step``,
``meta_gradients`` and ``meta_objective`` also take a batch from
``shard_batch`` with a state from ``replicate``. Each shard's tasks roll out
on its device (B1, and B2 in the backward, launched there), its objective is
the sum of its task losses over the global task count, and the shards'
gradients are summed in mesh order on the mesh's first device, then over
the hosts' processes: the gradient of the mean over every task. The outer
update runs once and its result is replicated. No statistic crosses a
shard: batch norm uses each task's own statistics and ``bn_state`` is left
as it is.

``scale_meta_lr`` rebuilds the outer schedule at scaled rates (the NaN
rollback's backoff, ``experiment/runner.py``) and drops the built programs.

Multi-step dispatch (JAX ``train_step_multi``/``eval_step_multi``):
``train_step_multi`` takes K outer steps over batches with a leading
``[K]`` axis, ``eval_step_multi`` every eval batch of an ``[N]`` stack. On
the card each replays a captured CUDA graph of one train or eval step
(``core/programs.py``), B1 and B2 inside it; on the CPU each runs the K (or
N) eager steps and stacks their outputs, the plain version the tests hold
against JAX's ``lax.scan`` programs. Programs are built once per key, as
JAX's program caches build them (``_build_program``): ``(train, so, msl)``
eagerly, ``(train_multi, so, msl)`` and ``(eval_multi,)`` as graphs on the
card. With a compile ledger attached (``attach_compile_ledger``,
``observability/compile_ledger.py``) every build is a ledger entry: a
capture with its warmup, capture seconds, FLOPs and pool bytes, or a first
eager dispatch, timed and priced by the flop counter. The graphs of a
system share one memory pool; a variant that the epoch can no longer reach
(second order switched on, the MSL window over) has its graphs released.
Not here (ROADMAP.md): donation (A10.7); the multi-step programs on a mesh
(A10.5 (mesh)).

Strict mode (``Config.strict_recompile_guard``, ``utils/strictmode.py``):
``recompile_guard`` holds every train variant ``(kind, second_order,
msl_active)`` and the eval kind, noted where they are dispatched, to
``train_planned_programs``. ``drop_compiled_programs`` re-plans the family.

``Config.matmul_precision`` is applied process-wide by the constructor, as
the JAX package applies it (``jax_default_matmul_precision``): it sets the
float32 precision of cuBLAS matmuls and of cuDNN convolutions together
(:data:`FP32_PRECISION`): ``"highest"`` and ``"default"`` are IEEE float32
(no TF32), ``"high"`` is TF32. The last-constructed system wins, and a
change of a value that something else had already set is warned.
``conv_via_patches`` and ``precision.fuse_conv_bn`` only change how XLA lays
out the same math, so they have no counterpart here.
"""

import contextlib
import functools
import math
import warnings
from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch.func import grad, vmap

from ..config import SERVING_STRATEGIES, TRAIN_STRATEGIES, Config, strategy_kind
from ..models.model import Model
from ..models.registry import build_model
from ..ops.inner_optim import build_inner_optimizer
from ..ops.losses import cross_entropy
from ..ops.msl import final_step_only, per_step_loss_importance
from ..ops.outer_adam import adam_init, adam_update
from ..ops.precision import as_f32, policy_from_config
from ..parallel.mesh import Replicated, ShardedBatch, all_reduce_sum, replicate, unreplicate
from ..utils import seeding
from ..utils.trees import tree_flatten, tree_map
from . import strategies
from .remat import apply_remat_policy
from .train_state import TrainState


class StepOutput(NamedTuple):
    loss: Any
    accuracy: Any
    per_task_losses: Any  # [B]
    per_task_accuracies: Any  # [B]: mean target accuracy per episode
    per_task_target_logits: Any  # [B, n_target, n_way]
    loss_importance_vector: Any  # [num_steps]
    learning_rate: Any


def cosine_epoch_schedule(meta_lr: float, min_lr: float, total_epochs: int, iters_per_epoch: int):
    """CosineAnnealingLR stepped once per *epoch* with the integer epoch
    index (reference ``few_shot_learning_system.py:339-340``), as a function
    of an integer step-count tensor, computed in float32."""

    def schedule(count):
        epoch = torch.div(torch.as_tensor(count), iters_per_epoch, rounding_mode="floor").to(torch.float32)
        cos = 0.5 * (1.0 + torch.cos(math.pi * epoch / total_epochs))
        return min_lr + (meta_lr - min_lr) * cos

    return schedule


def _zeros_if_none(grad, like):
    """An unused trainable gets a zero gradient, as ``jax.grad`` gives it."""
    return torch.zeros_like(like) if grad is None else grad


def _task_stack(tree, tasks: int):
    """Every tensor leaf repeated over a leading task axis ``[tasks, ...]``
    (the fast weights and the inner optimizer state at rollout entry, as
    ``jax.vmap`` broadcasts them per task); other leaves pass through."""
    return tree_map(
        lambda a: a.unsqueeze(0).expand(tasks, *a.shape).contiguous() if isinstance(a, torch.Tensor) else a,
        tree,
    )


def _flatten_task(x):
    """[B, n_way, k, ...] -> [B, n_way*k, ...] (reference view(-1, c, h, w),
    per task)."""
    return x.reshape((x.shape[0], -1) + tuple(x.shape[3:]))

def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raise where there is none, never fall back
    to the CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def check_rollout_strategy(strategy: str, known=SERVING_STRATEGIES) -> None:
    """``ValueError`` for a strategy outside ``known`` (the train strategies
    for a system, the serving ones for a call) and for ``protonet`` where a
    fast-weight rollout is asked for."""
    if strategy == "protonet":
        raise ValueError(
            "protonet adaptation is a prototype reduction, not a fast-weight rollout; "
            "use protonet_adapt/protonet_predict_logits (or recompute the prototypes to refine)"
        )
    if strategy not in known:
        raise ValueError(f"unknown strategy {strategy!r}; valid: {list(known)}")


#: ``Config.matmul_precision`` -> the float32 precision of cuBLAS matmuls
#: and cuDNN convolutions (``torch.backends.cuda.matmul.fp32_precision``,
#: ``torch.backends.cudnn.conv.fp32_precision``)
FP32_PRECISION = {"default": "ieee", "high": "tf32", "highest": "ieee"}


def fp32_precision_flags() -> Tuple[str, str]:
    """The process's (matmul, convolution) float32 precision."""
    return torch.backends.cuda.matmul.fp32_precision, torch.backends.cudnn.conv.fp32_precision


#: the flags as the process had them when the port was imported
_STARTUP_FP32_FLAGS = fp32_precision_flags()


def apply_matmul_precision(value: str) -> None:
    """Set the process's float32 precision for matmuls and convolutions
    from a ``Config.matmul_precision`` value (:data:`FP32_PRECISION`), with
    torch's ``fp32_precision`` flags only: mixing them with the legacy
    ``allow_tf32`` flags makes torch raise on a read. Warns where it
    changes flags that were set since the import to another value."""
    if value not in FP32_PRECISION:
        raise ValueError(f"matmul_precision must be one of {sorted(FP32_PRECISION)}, got {value!r}")
    target = FP32_PRECISION[value]
    prev = fp32_precision_flags()
    if prev != (target, target) and prev != _STARTUP_FP32_FLAGS:
        warnings.warn(
            f"matmul_precision={value!r} sets the process-wide float32 precision of matmuls and "
            f"convolutions to {target!r} (was {prev[0]!r} and {prev[1]!r}); operations from now on use it",
            stacklevel=2,
        )
    torch.backends.cuda.matmul.fp32_precision = target
    torch.backends.cudnn.conv.fp32_precision = target


class MAMLSystem:
    """The model, the inner optimizer and the precision policy, with the
    adapt/predict entry points the serving engine drives. Runs on
    ``device`` (default: the CUDA card)."""

    def __init__(self, cfg: Config, model: Optional[Model] = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.strategy = getattr(cfg, "strategy", "maml++")
        check_rollout_strategy(self.strategy, TRAIN_STRATEGIES)
        apply_matmul_precision(cfg.matmul_precision)
        self.model = model or build_model(
            cfg.net,
            cfg.image_shape,
            cfg.num_classes_per_set,
            reduce_window_pool=cfg.max_pool_reduce_window,
        )
        io = cfg.inner_optim
        kwargs = {"lr": io.lr}
        if io.kind == "adam":
            kwargs.update(beta1=io.beta1, beta2=io.beta2)
        if cfg.use_pallas_inner_update:
            if io.kind not in ("sgd", "gd"):
                raise ValueError(
                    "use_pallas_inner_update only supports the sgd/gd inner "
                    f"optimizer, got inner_optim.kind={io.kind!r}"
                )
            kwargs["fused"] = True
        self.inner_opt = build_inner_optimizer(io.kind, **kwargs)
        # strict mode: every train/eval variant is noted against the
        # declared family BEFORE it runs, so an unplanned variant raises
        # instead of silently paying its first dispatch mid-run
        self.recompile_guard = None
        if cfg.strict_recompile_guard:
            from ..utils.strictmode import RecompileGuard, train_planned_programs

            self.recompile_guard = RecompileGuard(planned=train_planned_programs(cfg), name="maml-system")
        # the program caches (JAX's _train_step_cache, _train_multi_cache,
        # _eval_step, _eval_multi) and the one graph pool they share
        self.compile_ledger = None
        self._train_programs: dict = {}
        self._train_multi: dict = {}
        self._eval_program = None
        self._eval_multi = None
        self._graph_pool = None
        self.meta_lr_scale = 1.0
        self.scale_meta_lr(1.0)
        self.precision = policy_from_config(cfg)
        self.remat_policy = cfg.resolved_remat_policy

    def scale_meta_lr(self, factor: float) -> None:
        """Scale the outer lr schedule by ``factor`` (the NaN rollback's
        backoff, ``experiment/runner.py::_note_bad_step``): the cosine
        schedule is rebuilt at ``meta_lr_scale * factor`` of the configured
        rates. The Adam state is unchanged, so a restored state keeps
        working across the swap."""
        self.meta_lr_scale *= float(factor)
        cfg = self.cfg
        self.schedule = cosine_epoch_schedule(
            cfg.meta_learning_rate * self.meta_lr_scale,
            cfg.min_learning_rate * self.meta_lr_scale,
            cfg.total_epochs,
            cfg.total_iter_per_epoch,
        )
        self.drop_compiled_programs()

    def drop_compiled_programs(self) -> None:
        """Re-plan the program family: the JAX system drops its compiled
        train/eval programs here (the rollback backoff, the mesh grow-back),
        and the rebuilds after a deliberate drop are not violations. The
        program caches are emptied (a graph bakes the outer schedule's rates
        in), the strict guard is reset, and the eval kind noted again, as
        the JAX system re-jits it."""
        for program in list(self._train_multi.values()) + [self._eval_multi]:
            if hasattr(program, "release"):
                program.release()
        self._train_programs, self._train_multi = {}, {}
        self._eval_program = self._eval_multi = None
        if self.recompile_guard is not None:
            self.recompile_guard.reset()
        self._note_program((self._kind("eval"),))

    def _build_program(self, key, build):
        """One program-cache insert: build the program and, with a compile
        ledger attached, hand it to the ledger, which prices its builds."""
        fn = build()
        if self.compile_ledger is not None:
            fn = self.compile_ledger.wrap_build(key, fn)
        return fn

    def attach_compile_ledger(self, ledger) -> None:
        """Route every program build through ``ledger``. Programs already
        built are dropped, so that each is rebuilt, and priced, through the
        ledger. (The JAX system also hands the ledger to its strict guard
        for ``RecompileGuard.wrap``; no program of this system is wrapped,
        the ledger prices each build itself, so the guard gets none.)"""
        self.compile_ledger = ledger
        self.drop_compiled_programs()

    @property
    def state_in_place(self) -> bool:
        """True where the multi-step programs update the state in place
        (CUDA graphs on the card): a caller that keeps a state across such a
        dispatch must keep a copy of it."""
        return self.device.type == "cuda"

    def _graph_pool_handle(self):
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return self._graph_pool

    def _kind(self, base: str) -> str:
        """Program-key kind for this system's strategy (the default keeps
        the bare spelling)."""
        return strategy_kind(base, self.strategy)

    def _note_program(self, key) -> None:
        if self.recompile_guard is not None:
            self.recompile_guard.note(key)

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    @property
    def _per_step_hparams(self) -> bool:
        return bool(self.cfg.lslr_per_step and self.cfg.learnable_inner_opt_params)

    def init_train_state(self, seed: Optional[int] = None) -> TrainState:
        """Seeded init on the CPU (``utils/seeding.py``), moved to the
        system's device, with a zero outer Adam state over
        ``{"params", "hparams"}``."""
        gen = seeding.model_init_generator(self.cfg.seed if seed is None else seed)
        params, bn_state = self.model.init(gen)
        to_dev = lambda a: a.to(self.device)  # noqa: E731
        params, bn_state = tree_map(to_dev, params), tree_map(to_dev, bn_state)
        if self.cfg.learnable_inner_opt_params:
            inner_hparams = self.inner_opt.init_hparams(params)
            if self._per_step_hparams:
                K = self.cfg.number_of_training_steps_per_iter
                inner_hparams = tree_map(lambda a: a.repeat(K), inner_hparams)
        else:
            inner_hparams = {}
        return TrainState(
            params=params,
            bn_state=bn_state,
            inner_hparams=inner_hparams,
            opt_state=adam_init({"params": params, "hparams": inner_hparams}),
            step=torch.zeros((), dtype=torch.int64, device=self.device),
        )

    def num_params(self, state: TrainState) -> int:
        return sum(
            t.numel() for t in tree_flatten({"params": state.params, "hparams": state.inner_hparams})[0]
        )

    # ------------------------------------------------------------------
    # inner rollout
    # ------------------------------------------------------------------

    def _inner_hparams_for_rollout(self, inner_hparams, params):
        if self.cfg.learnable_inner_opt_params:
            return inner_hparams
        # non-learnable: constant per-tensor scalars from config
        return self.inner_opt.init_hparams(params)

    def _initial_inner_state(self, params, hparams, opt_state):
        """The inner optimizer's state at step 0 (JAX package
        ``core/maml.py::_initial_inner_state``): per-step hparams are read
        at step 0 (rprop's step size starts at the lr). With
        ``warm_start_inner_opt_from_outer``, inner Adam takes its moments
        from the outer Adam's over the params and its step from the outer
        count (the intent of the reference's deepcopy,
        ``few_shot_learning_system.py:219-220``); ``opt_state=None`` (the
        serving engine) starts from zero moments."""
        init_hp = hparams
        if self._per_step_hparams:
            init_hp = tree_map(lambda a: a[0], hparams)
        inner_state = self.inner_opt.init_state(params, init_hp)
        if not (self.cfg.warm_start_inner_opt_from_outer and self.inner_opt.name == "adam" and opt_state is not None):
            return inner_state
        adam_state = next((part for part in opt_state if hasattr(part, "mu")), None)
        if adam_state is None:
            return inner_state
        count = adam_state.count.to(torch.float32)
        return {
            "step": tree_map(lambda p: count, params),
            "exp_avg": adam_state.mu["params"],
            "exp_avg_sq": adam_state.nu["params"],
        }

    def _apply_forward(self, params, bn_state, x, sample_weight=None):
        """One model forward in the policy's compute dtype, f32 logits out.
        ``sample_weight`` masks padded samples out of the BN statistics."""
        pol = self.precision
        params, x = pol.cast_forward_inputs(params, x)
        kwargs = {}
        if sample_weight is not None:
            kwargs["sample_weight"] = sample_weight
        if pol.stat_dtype is not None:
            kwargs["stat_dtype"] = pol.stat_dtype
        logits, _ = self.model.apply(params, bn_state, x, use_batch_stats=True, **kwargs)
        return pol.cast_logits(logits)

    def _make_inner_update(self, bn_state, x_support, y_support, second_order, support_weight=None):
        """``inner_update(p, opt_state, hp) -> (p', opt_state')``: one
        support-set gradient step for every task of the batch. ``p`` and the
        support tensors carry the leading task axis. The inner gradients of
        ``vmap(grad(...))`` keep their autograd graph, so a loss of ``p'``
        differentiates through them (second order); first order detaches
        them (JAX ``stop_gradient``)."""

        def support_loss(q, x, y, w):
            return cross_entropy(self._apply_forward(q, bn_state, x, w), y, sample_weight=w)

        task_grads = vmap(grad(support_loss), in_dims=(0, 0, 0, None if support_weight is None else 0))

        def inner_update(p, opt_s, hp):
            grads = task_grads(p, x_support, y_support, support_weight)
            if not second_order:
                grads = tree_map(torch.Tensor.detach, grads)
            return self.inner_opt.update(grads, opt_s, p, hp)

        return inner_update

    def _hparam_sequence(self, hparams, num_steps: int):
        """Per-step hparams. Default: the same hparams every step.
        ``lslr_per_step``: slice the leading step axis; horizons beyond the
        trained one reuse the last step's values."""
        if self._per_step_hparams:
            K = self.cfg.number_of_training_steps_per_iter
            return [tree_map(lambda a, i=i: a[min(i, K - 1)], hparams) for i in range(num_steps)]
        return [hparams] * num_steps

    def _rollout_start(self, params, inner_state, tasks: int, stacked: bool = False):
        """The fast weights and the inner state at rollout entry: cast once
        to the fast-weight dtype (bf16 under bf16_inner), then stacked over
        the tasks (the params not where they are ``stacked`` already: the
        fast weights a refinement starts from)."""
        cast = self.precision.cast_fast_weights
        p = cast(params) if stacked else _task_stack(cast(params), tasks)
        return p, _task_stack(cast(inner_state), tasks)

    def _adapt_loop(
        self, params, bn_state, hparams, inner_state, x_support, y_support,
        second_order: bool, num_steps: int, support_weight=None, stacked: bool = False,
    ):
        """``num_steps`` support-set updates of every task -> task-stacked
        fast weights, each step under the remat policy."""
        p, inner_state = self._rollout_start(params, inner_state, x_support.shape[0], stacked)
        step = apply_remat_policy(
            self._make_inner_update(bn_state, x_support, y_support, second_order, support_weight),
            self.remat_policy,
        )
        for hp in self._hparam_sequence(hparams, num_steps):
            p, inner_state = step(p, inner_state, hp)
        return p

    def _forward_tasks(self, p, bn_state, x):
        """Task-stacked fast weights and inputs ``[T, N, ...]`` -> f32 logits
        ``[T, N, n_way]``."""
        return vmap(lambda q, xq: self._apply_forward(q, bn_state, xq))(p, x)

    def _rollout(
        self, params, bn_state, hparams, inner_state, x_support, y_support,
        x_target, y_target, loss_weights, second_order: bool, num_steps: int,
        per_step_target: bool,
    ):
        """Adapt every task on its support set for ``num_steps``. With
        ``per_step_target`` (the MSL window) the target loss is taken after
        *every* inner step and weighted by ``loss_weights``; otherwise only
        the final fast weights see the target set (reference
        few_shot_learning_system.py:239-251). Returns (per-task losses
        ``[T]``, final target logits ``[T, Q, n_way]``). ``anil`` runs the
        head-only rollout (``core/strategies.py``)."""
        if self.strategy == "anil":
            return strategies.anil_rollout(
                self, params, bn_state, hparams, inner_state, x_support, y_support, x_target, y_target,
                loss_weights, second_order, num_steps, per_step_target,
            )
        task_ce = vmap(cross_entropy)
        if per_step_target:
            p, inner_state = self._rollout_start(params, inner_state, x_support.shape[0])
            inner_update = self._make_inner_update(bn_state, x_support, y_support, second_order)

            def msl_step(p, opt_s, hp, weight):
                p, opt_s = inner_update(p, opt_s, hp)
                logits = self._forward_tasks(p, bn_state, x_target)
                return p, opt_s, logits, weight * task_ce(logits, y_target)

            step = apply_remat_policy(msl_step, self.remat_policy)
            weighted = []
            for i, hp in enumerate(self._hparam_sequence(hparams, num_steps)):
                p, inner_state, logits, loss = step(p, inner_state, hp, loss_weights[i])
                weighted.append(loss)
            return torch.stack(weighted).sum(0), logits
        p_final = self._adapt_loop(
            params, bn_state, hparams, inner_state, x_support, y_support,
            second_order, num_steps,
        )
        logits = self._forward_tasks(p_final, bn_state, x_target)
        return task_ce(logits, y_target), logits

    # ------------------------------------------------------------------
    # meta objective over a task batch
    # ------------------------------------------------------------------

    def msl_active(self, epoch: int, training: bool = True) -> bool:
        """Per-step MSL weighting applies during training in the annealing
        window (reference few_shot_learning_system.py:239-240)."""
        return bool(
            training
            and self.cfg.use_multi_step_loss_optimization
            and epoch < self.cfg.multi_step_loss_num_epochs
        )

    def _loss_weights(self, epoch, num_steps, msl_active: bool, device):
        if msl_active:
            return per_step_loss_importance(epoch, num_steps, self.cfg.multi_step_loss_num_epochs, device=device)
        return final_step_only(num_steps, device=device)

    def _batch(self, batch, device=None):
        """A meta-batch dict (numpy or tensors) on ``device`` (default the
        system's), with the task axis made explicit: ``[B, n_way, k, ...]``
        -> ``[B, n_way * k, ...]``."""
        return {
            "x_support": _flatten_task(self._tensor(batch["x_support"], torch.float32, device)),
            "y_support": _flatten_task(self._tensor(batch["y_support"], torch.int64, device)),
            "x_target": _flatten_task(self._tensor(batch["x_target"], torch.float32, device)),
            "y_target": _flatten_task(self._tensor(batch["y_target"], torch.int64, device)),
        }

    def _meta_objective(self, trainables, bn_state, opt_state, batch, epoch, second_order, num_steps, msl_active):
        """Mean over tasks of each task's (MSL-weighted) target loss, and
        the aux outputs. ``batch`` is a :meth:`_batch` dict; ``opt_state``
        (the outer Adam's) warm-starts inner Adam."""
        params = trainables["params"]
        hparams = self._inner_hparams_for_rollout(trainables["hparams"], params)
        inner_state0 = self._initial_inner_state(params, hparams, opt_state)
        loss_weights = self._loss_weights(epoch, num_steps, msl_active, batch["x_support"].device)
        task_losses, target_logits = self._rollout(
            params, bn_state, hparams, inner_state0, batch["x_support"], batch["y_support"],
            batch["x_target"], batch["y_target"], loss_weights, second_order, num_steps,
            per_step_target=msl_active,
        )
        # mean over tasks (reference get_across_task_loss_metrics,
        # few_shot_learning_system.py:170-176)
        loss = task_losses.mean()
        per_task_acc = as_f32(target_logits.argmax(-1) == batch["y_target"]).mean(-1)
        aux = {
            "accuracy": per_task_acc.mean(),
            "per_task_losses": task_losses,
            "per_task_accuracies": per_task_acc,
            "target_logits": target_logits,
            "loss_weights": loss_weights,
        }
        return loss, aux

    # ------------------------------------------------------------------
    # train / eval steps (reference run_train_iter / run_validation_iter)
    # ------------------------------------------------------------------

    def use_second_order(self, epoch: int) -> bool:
        """Second order iff ``second_order`` and ``epoch >
        first_order_to_second_order_epoch`` (reference
        few_shot_learning_system.py:288-289); ``fomaml`` pins it False."""
        if self.strategy == "fomaml":
            return False
        return bool(self.cfg.second_order and epoch > self.cfg.first_order_to_second_order_epoch)

    def _step_epoch(self, state: TrainState):
        return torch.div(state.step, self.cfg.total_iter_per_epoch, rounding_mode="floor")

    def _train_objective(self, state: TrainState, trainables, batch, epoch: Optional[int], device=None):
        """The train step's objective at ``trainables``. ``epoch`` (host int)
        selects second/first order and the MSL branch; the MSL weights
        themselves follow ``state.step``. ``device``: where the batch goes
        (default the system's)."""
        cfg = self.cfg
        if epoch is None:
            epoch = int(state.step) // cfg.total_iter_per_epoch
        return self._meta_objective(
            trainables, state.bn_state, state.opt_state, self._batch(batch, device), self._step_epoch(state),
            self.use_second_order(epoch), cfg.number_of_training_steps_per_iter, self.msl_active(epoch),
        )

    @staticmethod
    def _grads_of(loss, trainables):
        """``d loss / d trainables`` over the trainables' own structure (an
        empty subtree stays in place; an unused leaf gets zeros)."""
        grads = iter(torch.autograd.grad(loss, tree_flatten(trainables)[0], allow_unused=True))
        return tree_map(lambda t: _zeros_if_none(next(grads), t), trainables)

    def meta_objective(self, state: TrainState, batch, epoch: Optional[int] = None):
        """The train step's objective and aux outputs at ``state``, without
        gradients -> ``(loss, aux)``. Takes a sharded batch too."""
        if isinstance(batch, ShardedBatch):
            return self._sharded_objective(state, batch, epoch, with_grads=False)[:2]
        with torch.no_grad():
            return self._train_objective(
                state, {"params": state.params, "hparams": state.inner_hparams}, batch, epoch
            )

    def meta_gradients(self, state: TrainState, batch, epoch: Optional[int] = None):
        """The train step's objective and its gradient over
        ``{"params", "hparams"}`` -> ``(loss, aux, grads)``. Given a
        :class:`~..parallel.mesh.ShardedBatch` (and a state from
        ``replicate``, or one to replicate), the gradient is the sum of the
        shards' gradients on the mesh's first device."""
        if isinstance(batch, ShardedBatch):
            return self._sharded_objective(state, batch, epoch, with_grads=True)
        trainables = tree_map(
            lambda t: t.detach().requires_grad_(True),
            {"params": state.params, "hparams": state.inner_hparams},
        )
        loss, aux = self._train_objective(state, trainables, batch, epoch)
        return loss.detach(), aux, self._grads_of(loss, trainables)

    def train_step(self, state: TrainState, batch, epoch: Optional[int] = None) -> Tuple[TrainState, StepOutput]:
        """One outer update: the meta-gradient, the ImageNet +-10 clamp of
        the classifier grads, outer Adam on the cosine schedule, the lr
        projection, ``step + 1``. ``epoch`` (host int) selects the variant;
        when omitted it is read from ``state.step``. Data-parallel: given
        ``replicate(state, mesh)`` and ``shard_batch(batch, mesh)`` the
        update runs once, on the mesh's first device, and the new state is
        replicated again. Under the strict guard or a compile ledger the
        step goes through its variant's program (noted, and its first
        dispatch priced)."""
        if self.recompile_guard is None and self.compile_ledger is None:
            return self._train_step_impl(state, batch, epoch)
        ep = epoch if epoch is not None else int(unreplicate(state).step) // self.cfg.total_iter_per_epoch
        return self._compiled_train_step(self.use_second_order(ep), self.msl_active(ep))(state, batch, epoch=ep)

    def _compiled_train_step(self, second_order: bool, msl_active: bool):
        key = (self._kind("train"), second_order, msl_active)
        fn = self._train_programs.get(key)
        if fn is None:
            self._note_program(key)
            fn = self._train_programs[key] = self._build_program(key, lambda: self._train_step_impl)
        return fn

    def _train_step_impl(self, state: TrainState, batch, epoch: Optional[int] = None):
        cfg = self.cfg
        sharded = isinstance(batch, ShardedBatch)
        if sharded:
            state = self._replicated(state, batch.mesh)
        loss, aux, grads = self.meta_gradients(state, batch, epoch)
        base = unreplicate(state)
        with torch.no_grad():
            if cfg.is_imagenet:
                # element-wise clamp of classifier grads only (reference
                # few_shot_learning_system.py:317-320)
                grads = {
                    "params": tree_map(lambda g: torch.clamp(g, -10.0, 10.0), grads["params"]),
                    "hparams": grads["hparams"],
                }
            trainables = {"params": base.params, "hparams": base.inner_hparams}
            new_trainables, new_opt_state = adam_update(grads, base.opt_state, trainables, self.schedule)
            new_hparams = new_trainables["hparams"]
            if cfg.learnable_inner_opt_params:
                new_hparams = self.inner_opt.project_hparams(new_hparams)
            new_state = TrainState(
                params=new_trainables["params"],
                bn_state=base.bn_state,
                inner_hparams=new_hparams,
                opt_state=new_opt_state,
                step=base.step + 1,
            )
            out = self._step_output(loss, aux, base)
        if sharded:
            new_state = replicate(new_state, batch.mesh)
        return new_state, out

    def _step_output(self, loss, aux, state: TrainState) -> StepOutput:
        return StepOutput(
            loss=loss.detach(),
            accuracy=aux["accuracy"].detach(),
            per_task_losses=aux["per_task_losses"].detach(),
            per_task_accuracies=aux["per_task_accuracies"].detach(),
            per_task_target_logits=aux["target_logits"].detach(),
            loss_importance_vector=aux["loss_weights"],
            learning_rate=self.schedule(state.step),
        )

    def eval_step(self, state: TrainState, batch) -> StepOutput:
        """First-order, ``number_of_evaluation_steps_per_iter`` inner steps,
        final-step target loss only (reference :239-251); no gradients.
        Takes a sharded batch too."""
        self._note_program((self._kind("eval"),))
        if self.compile_ledger is None:
            return self._eval_step_impl(state, batch)
        if self._eval_program is None:
            self._eval_program = self._build_program((self._kind("eval"),), lambda: self._eval_step_impl)
        return self._eval_program(state, batch)

    def _eval_step_impl(self, state: TrainState, batch) -> StepOutput:
        cfg = self.cfg
        if isinstance(batch, ShardedBatch):
            state = self._replicated(state, batch.mesh)
            with torch.no_grad():
                loss, aux = self._per_shard(state, batch, lambda replica, shard, device: self._meta_objective(
                    {"params": replica.params, "hparams": replica.inner_hparams}, replica.bn_state,
                    replica.opt_state, self._batch(shard, device), self._step_epoch(replica), False,
                    cfg.number_of_evaluation_steps_per_iter, False,
                ))[:2]
            return self._step_output(loss, aux, unreplicate(state))
        with torch.no_grad():
            loss, aux = self._meta_objective(
                {"params": state.params, "hparams": state.inner_hparams}, state.bn_state, state.opt_state,
                self._batch(batch), self._step_epoch(state), False,
                cfg.number_of_evaluation_steps_per_iter, False,
            )
            return self._step_output(loss, aux, state)

    # ------------------------------------------------------------------
    # multi-step dispatch (JAX core/maml.py:955-1031)
    # ------------------------------------------------------------------

    def _step_batches(self, batches) -> list:
        """A stack of batches (every key with a leading ``[K]`` axis) -> K
        batch dicts. On the card the stack goes to the device once, in the
        step's dtypes, and each batch is a view of it."""
        if isinstance(batches, ShardedBatch):
            raise NotImplementedError(
                "train_step_multi/eval_step_multi on a mesh is not ported to PyTorch yet "
                "(ROADMAP.md A10.5 (mesh)); dispatch one step per call on a mesh"
            )
        if self.device.type == "cuda":
            batches = {key: self._tensor(value, torch.int64 if key.startswith("y") else torch.float32)
                       for key, value in batches.items()}
        n = len(batches["x_support"])
        return [{key: value[i] for key, value in batches.items()} for i in range(n)]

    def _release_unreachable(self, second_order: bool, msl_active: bool) -> None:
        """Release the train graphs of variants no later epoch reaches: both
        switches move one way (second order on after its epoch, the MSL
        window closed after its epochs), as JAX drops programs."""
        for key in list(self._train_multi):
            _, so, msl = key
            if (second_order and not so) or (msl and not msl_active):
                program = self._train_multi.pop(key)
                if hasattr(program, "release"):
                    program.release()

    def _train_graph_step(self, epoch: int):
        """The step a train graph captures: the train step at ``epoch``'s
        variant, with the per-step outputs the loop consumes."""

        def step(state, batch):
            new_state, out = self._train_step_impl(state, batch, epoch)
            return new_state, (out.loss, out.accuracy, out.learning_rate)

        return step

    def _train_multi_eager(self, state, batches, epoch: int):
        outs = []
        for batch in batches:
            state, out = self._train_step_impl(state, batch, epoch)
            outs.append((out.loss, out.accuracy, out.learning_rate))
        return state, outs

    def _compiled_train_multi(self, second_order: bool, msl_active: bool):
        key = (self._kind("train_multi"), second_order, msl_active)
        fn = self._train_multi.get(key)
        if fn is None:
            self._release_unreachable(second_order, msl_active)
            self._note_program(key)
            if self.device.type == "cuda":
                from .programs import GraphProgram

                build = lambda: GraphProgram(self._train_graph_step, self.device, self._graph_pool_handle)  # noqa: E731
            else:
                build = lambda: self._train_multi_eager  # noqa: E731
            fn = self._train_multi[key] = self._build_program(key, build)
        return fn

    def train_step_multi(self, state: TrainState, batches, epoch: Optional[int] = None):
        """K outer updates in one dispatch over ``batches`` whose leaves
        carry a leading ``[K]`` axis (``loader.train_batch_chunks``): the
        same math as K ``train_step`` calls. On the card it replays a CUDA
        graph of the train step K times (the state updated in place; the
        returned state is a view of the graph's buffers); on the CPU it runs
        the K eager steps. Returns ``(new_state, (losses[K], accuracies[K],
        learning_rates[K]))``. The chunk must not span an epoch where the
        ``(second_order, msl_active)`` variant flips: with ``epoch`` given
        the caller dispatches within it (the runner does), without it the
        step count is read once and a flipping chunk raises ``ValueError``.
        A mesh's sharded batch raises ``NotImplementedError`` (ROADMAP.md
        A10.5 (mesh))."""
        steps = self._step_batches(batches)
        if epoch is None:
            first = int(unreplicate(state).step)
            epoch, last = (first // self.cfg.total_iter_per_epoch,
                           (first + len(steps) - 1) // self.cfg.total_iter_per_epoch)
            variant = lambda e: (self.use_second_order(e), self.msl_active(e))  # noqa: E731
            if variant(epoch) != variant(last):
                raise ValueError(
                    f"train_step_multi: the chunk of {len(steps)} steps from step {first} spans epochs "
                    f"{epoch}..{last}, where the program variant flips {variant(epoch)} -> {variant(last)}"
                )
        program = self._compiled_train_multi(self.use_second_order(epoch), self.msl_active(epoch))
        state, outs = program(state, steps, epoch=epoch)
        losses, accuracies, lrs = (torch.stack([o[i] for o in outs]) for i in range(3))
        return state, (losses, accuracies, lrs)

    def _eval_graph_step(self):
        def step(state, batch):
            out = self._eval_step_impl(state, batch)
            return None, (out.per_task_losses, out.per_task_accuracies)

        return step

    def _eval_multi_eager(self, state, batches):
        outs = []
        for batch in batches:
            out = self._eval_step_impl(state, batch)
            outs.append((out.per_task_losses, out.per_task_accuracies))
        return state, outs

    def _compiled_eval_multi(self):
        if self._eval_multi is None:
            key = (self._kind("eval_multi"),)
            self._note_program(key)
            if self.device.type == "cuda":
                from .programs import GraphProgram

                build = lambda: GraphProgram(self._eval_graph_step, self.device, self._graph_pool_handle)  # noqa: E731
            else:
                build = lambda: self._eval_multi_eager  # noqa: E731
            self._eval_multi = self._build_program(key, build)
        return self._eval_multi

    def eval_step_multi(self, state: TrainState, batches):
        """Every eval batch in one dispatch: ``batches`` with a leading
        ``[N]`` axis -> ``(per_task_losses [N, B], per_task_accuracies [N,
        B])``, the same per-batch math as N ``eval_step`` calls. On the card
        it replays a CUDA graph of the eval step N times; on the CPU it runs
        the N eager steps."""
        _, outs = self._compiled_eval_multi()(state, self._step_batches(batches))
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])

    # ------------------------------------------------------------------
    # data parallelism over a mesh (parallel/mesh.py)
    # ------------------------------------------------------------------

    @staticmethod
    def _replicated(state, mesh) -> Replicated:
        if isinstance(state, Replicated) and state.mesh is mesh:
            return state
        return replicate(state, mesh)

    def _sharded_objective(self, state, batch: ShardedBatch, epoch: Optional[int], with_grads: bool):
        """The train objective of every shard on its device -> ``(loss, aux,
        grads)``. A shard's objective is the sum of its tasks' losses over
        the global task count, so the shards' gradients, summed in mesh
        order on the first device (then over the processes), are the
        gradient of the global mean."""
        state = self._replicated(state, batch.mesh)
        total = batch.global_tasks

        def shard_objective(replica, shard, device):
            trainables = {"params": replica.params, "hparams": replica.inner_hparams}
            if not with_grads:
                with torch.no_grad():
                    return self._train_objective(replica, trainables, shard, epoch, device)
            trainables = tree_map(lambda t: t.detach().requires_grad_(True), trainables)
            loss, aux = self._train_objective(replica, trainables, shard, epoch, device)
            return loss, aux, self._grads_of(aux["per_task_losses"].sum() / total, trainables)

        loss, aux, shard_grads = self._per_shard(state, batch, shard_objective)
        if not with_grads:
            return loss, aux, None
        first = batch.mesh.devices[0]
        grads = tree_map(lambda *gs: functools.reduce(lambda acc, g: acc + g.to(first), gs[1:], gs[0]),
                         *shard_grads)
        if batch.mesh.processes > 1:
            all_reduce_sum(tree_flatten(grads)[0])
        return loss, aux, grads

    def _per_shard(self, state: Replicated, batch: ShardedBatch, fn):
        """``fn(replica, shard, device)`` for every shard, each under its
        card's device guard -> (global mean loss, merged aux, [the third
        outputs of ``fn``]). The per-task outputs are concatenated in task
        order on the mesh's first device; the loss and accuracy are means
        over every process's tasks."""
        mesh = batch.mesh
        first = mesh.devices[0]
        results = []
        for i, (device, shard) in enumerate(zip(mesh.devices, batch.shards)):
            with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
                results.append(fn(state.replicas[i], shard, device))
        auxes = [r[1] for r in results]
        cat = lambda key: torch.cat([a[key].detach().to(first) for a in auxes])  # noqa: E731
        per_task_losses, per_task_acc = cat("per_task_losses"), cat("per_task_accuracies")
        sums = torch.stack([per_task_losses.sum(), per_task_acc.sum()])
        if mesh.processes > 1:
            all_reduce_sum([sums])
        loss, accuracy = sums / batch.global_tasks
        aux = {
            "accuracy": accuracy,
            "per_task_losses": per_task_losses,
            "per_task_accuracies": per_task_acc,
            "target_logits": cat("target_logits"),
            "loss_weights": auxes[0]["loss_weights"].to(first),
        }
        return loss, aux, [r[2] for r in results] if len(results[0]) > 2 else None

    # ------------------------------------------------------------------
    # serving entry points
    # ------------------------------------------------------------------

    def _tensor(self, x, dtype=None, device=None):
        return torch.as_tensor(x, dtype=dtype, device=self.device if device is None else device)

    def _serving_rollout(self, state: TrainState, start, x_support, y_support, num_steps, support_weight,
                         strategy, stacked: bool):
        """The first-order rollout of a task batch from ``start`` (the
        masters, or ``stacked`` fast weights), with the hparams and the
        inner state of the masters."""
        strategy = self.strategy if strategy is None else strategy
        check_rollout_strategy(strategy)
        if num_steps is None:
            num_steps = self.cfg.number_of_evaluation_steps_per_iter
        x = self._tensor(x_support, torch.float32)
        y = self._tensor(y_support, torch.int64)
        w = None if support_weight is None else self._tensor(support_weight, torch.float32)
        with torch.no_grad():
            hparams = self._inner_hparams_for_rollout(state.inner_hparams, state.params)
            inner_state = self._initial_inner_state(state.params, hparams, state.opt_state)
            args = (start, state.bn_state, hparams, inner_state, x, y)
            kwargs = dict(second_order=False, num_steps=num_steps, support_weight=w, stacked=stacked)
            if strategy == "anil":
                return strategies.anil_adapt_loop(self, *args, **kwargs)
            return self._adapt_loop(*args, **kwargs)

    def adapt_fast_weights(
        self, state: TrainState, x_support, y_support, num_steps: Optional[int] = None,
        support_weight=None, strategy: Optional[str] = None,
    ):
        """Inner-loop adaptation of a task batch: support ``[T, S, H, W, C]``
        / ``[T, S]`` (and ``support_weight`` ``[T, S]``, 0 = padding) ->
        fast weights with a leading ``T`` on every leaf. First-order, no
        target forward. ``strategy`` (default: the system's) picks the
        rollout per call: ``maml++`` and ``fomaml`` the full one, ``anil``
        the head's (the body's leaves are views of the masters');
        ``protonet`` raises (:meth:`protonet_adapt`)."""
        return self._serving_rollout(state, state.params, x_support, y_support, num_steps, support_weight,
                                     strategy, stacked=False)

    def refine_fast_weights(
        self, state: TrainState, fast_weights, x_support, y_support, num_steps: Optional[int] = None,
        support_weight=None, strategy: Optional[str] = None,
    ):
        """Refinement: the rollout of :meth:`adapt_fast_weights` started from
        earlier fast weights (a leading ``T`` on every leaf) instead of the
        masters. The hparams and the inner optimizer's state still come from
        the masters: a refinement is a fresh K-step episode on new support
        data, under the lr schedule the checkpoint was trained with.
        ``protonet`` raises: its prototypes are recomputed by
        :meth:`protonet_adapt`."""
        return self._serving_rollout(state, fast_weights, x_support, y_support, num_steps, support_weight,
                                     strategy, stacked=True)

    def protonet_adapt(self, state: TrainState, x_support, y_support, support_weight=None):
        """ProtoNet ``adapt`` of a task batch: one embedding forward and a
        masked per-class mean -> ``{"prototypes": [T, n_way, D]}``."""
        x = self._tensor(x_support, torch.float32)
        y = self._tensor(y_support, torch.int64)
        w = None if support_weight is None else self._tensor(support_weight, torch.float32)
        with torch.no_grad():
            return strategies.protonet_prototypes(self, state.params, state.bn_state, x, y, w)

    def protonet_predict_logits(self, params, bn_state, prototypes, x_query, sample_weight=None):
        """ProtoNet ``predict``: queries ``[T, Q, H, W, C]`` embedded through
        the master ``params``, scored against each task's prototype table ->
        distance logits ``[T, Q, n_way]``."""
        x = self._tensor(x_query, torch.float32)
        w = None if sample_weight is None else self._tensor(sample_weight, torch.float32)
        with torch.no_grad():
            return strategies.protonet_logits(self, params, bn_state, prototypes, x, w)

    def predict_logits(self, fast_weights, bn_state, x, sample_weight=None):
        """Task-stacked fast weights and queries ``[T, Q, H, W, C]`` -> f32
        logits ``[T, Q, num_classes]``. Transductive BN over each task's
        query batch; ``sample_weight`` ``[T, Q]`` masks padded queries out of
        the statistics."""
        x = self._tensor(x, torch.float32)
        w = None if sample_weight is None else self._tensor(sample_weight, torch.float32)
        forward = vmap(
            lambda p, xq, wq: self._apply_forward(p, bn_state, xq, wq),
            in_dims=(0, 0, None if w is None else 0),
        )
        with torch.no_grad():
            return forward(fast_weights, x, w)
