"""GL1xx for PyTorch and CUDA graphs: the JAX rules' ids and meanings, on
the port's hazards.

GL101  host sync in capture-reachable code
GL102  Python control flow on a tensor in capture-reachable code
GL110  host sync on a designated hot path
GL121  unseeded global RNG in library code (numpy, ``random`` and torch's
       global generator)
GL130  a batch or state read after a donating call
GL140  literal float cast outside the precision policy

**Capture-reachable code** (GL101/GL102) is what a CUDA graph records. The
roots are the callables handed to ``core/programs.py``'s ``capture_graph``,
``CapturedStep`` and ``ServingCall``, and the step factories handed to
``GraphProgram`` (or made by a call, as ``ServingCall(self._program_fn(...),
...)``). From a root, reachability follows ``self.`` methods and module
functions of the same module, whatever their arguments, as the JAX rules'
fixpoint follows ``jax.jit``; tensors are tracked as the JAX rules track
tracers: the parameters of a root that a capture calls with tensors, of a
def nested in reachable code, and of a callee given a tensor, and what a
``torch.*`` call, a tensor's method or a callee that returns one gives back.
A graph bakes in the sync (a capture refuses it, or a replay skips it) and
the branch its capture took, so these are faults, not slow paths.

``.shape``/``.dtype``/``.device`` and their kin, ``len()``/``isinstance()``,
``x is None`` and the host scalar that ``float()``/``int()`` return are not
tensors. A ``.item()``/``.cpu()``/``.numpy()``/``.tolist()``/``.nonzero()``/
``.synchronize()`` call is flagged on any receiver: captured code holds
tensors, and a capture that was handed no argument (``capture_graph(fn)``)
tracks none.
"""

import ast
from collections import deque
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from tools.graftlint.engine import Finding, Module, Project, Rule, call_name, dotted_name
from tools.graftlint.rules_jax import (
    SANITIZER_CALLS,
    UnseededModuleRNG,
    _FuncIndex,
    _is_numpy_call,
)

#: capture entry points -> how their first argument is called: "direct"
#: (the callable is captured) or "factory" (it makes the step callable)
CAPTURE_ENTRIES = {"capture_graph": "direct", "CapturedStep": "direct", "ServingCall": "direct",
                   "GraphProgram": "factory"}
CAPTURE_KEYWORDS = ("fn", "step", "step_for")

#: tensor methods that wait for the card, flagged on any receiver
SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "nonzero", "synchronize"}
#: torch functions that wait for the card
TORCH_SYNC_CALLS = {"torch.cuda.synchronize", "torch.unique", "torch.masked_select", "torch.nonzero"}
#: built-ins that read a tensor's value on the host
CONCRETIZERS = {"float", "int", "bool", "complex"}
#: attributes and methods whose value is known on the host (a device's
#: ``.type``, and a sharded batch's or placed state's ``.mesh``,
#: ``parallel/mesh.py``'s host structure, too)
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "requires_grad", "layout", "is_leaf", "type", "mesh"}
STATIC_METHODS = {"size", "dim", "numel", "element_size", "data_ptr", "stride", "is_contiguous", "get_device",
                  "untyped_storage", "nelement", "is_floating_point", "storage_offset"}
#: torch calls that give back host values, not tensors
TORCH_HOST_PREFIXES = ("torch.cuda.", "torch.backends.", "torch.distributed.", "torch.autograd.")
TORCH_HOST_CALLS = {"is_tensor", "is_floating_point", "is_complex", "is_grad_enabled", "device", "Size",
                    "get_default_dtype", "no_grad", "enable_grad", "inference_mode", "is_inference_mode_enabled"}

#: GL110's hot paths, matched by path suffix; ``Class.method`` names one
#: class's method. The JAX linter's four (the runner's dispatch loop, the
#: engine's two flushes, the frontend's guarded dispatch, which in the port
#: is ``EngineReplica.dispatch``: JAX's ``_dispatch`` delegates there), and
#: the graphs' replays. Functions opt in with a ``# graftlint: hot-path``
#: marker on or above their ``def``.
HOT_PATHS: Dict[str, Set[str]] = {
    "experiment/runner.py": {"_train_epoch"},
    "serving/engine.py": {"adapt_batch", "predict_batch"},
    "serving/pool.py": {"EngineReplica.dispatch"},
    "core/programs.py": {"GraphProgram.__call__", "CapturedStep.replay", "CapturedStep.dispatch", "ServingCall.run"},
}


def _torch_name(module: Module, call: ast.Call) -> Optional[str]:
    """``torch.x.y`` for a call whose root resolves to torch, else None."""
    name = call_name(call)
    if not name:
        return None
    root, _, rest = name.partition(".")
    resolved = module.resolve_root(root)
    if resolved.split(".")[0] != "torch":
        return None
    return resolved + ("." + rest if rest else "")


def sync_reason(module: Module, call: ast.Call, tensor=None) -> Optional[str]:
    """Why ``call`` waits for the card, or None. ``tensor(node)`` says
    whether an argument is a tensor. Without it (GL110, which tracks no
    tensors) any argument that is not a literal counts, and of the
    built-ins only ``float()``/``int()``, as the JAX rule judges them:
    ``bool()`` there is a config's truth far more often than a tensor's,
    and the card run's sync record (``chip_smoke.py``, phase ``lint``)
    catches the tensor's."""

    def is_value(node):
        if tensor is not None:
            return tensor(node)
        return not isinstance(node, (ast.Constant, ast.List, ast.Tuple))

    concretizers = CONCRETIZERS if tensor is not None else {"float", "int"}

    func = call.func
    if isinstance(func, ast.Attribute) and func.attr in SYNC_METHODS:
        return f".{func.attr}() waits for the card"
    torch_name = _torch_name(module, call)
    if torch_name in TORCH_SYNC_CALLS:
        return f"{torch_name}() waits for the card"
    if isinstance(func, ast.Name) and func.id in concretizers and call.args and is_value(call.args[0]):
        return f"{func.id}() of a tensor copies it to the host"
    if _is_numpy_call(module, call, {"asarray", "array", "copy"}) and call.args and is_value(call.args[0]):
        return f"{call_name(call)}() of a tensor copies it to the host"
    return None


class _Shared:
    """What one module's analyses share: the function index and the
    memo of which callees return a tensor."""

    def __init__(self, module: Module):
        self.index = _FuncIndex(module)
        self.returns: Dict[Tuple[ast.AST, FrozenSet[str]], bool] = {}


class _CaptureAnalysis:
    """One pass over one function with its set of tensor parameters:
    GL101/GL102 findings, the module-local callees it reaches (with the
    parameters it hands them tensors for) and whether it returns a tensor."""

    def __init__(self, module: Module, shared: _Shared):
        self.module = module
        self.shared = shared
        self.index = shared.index
        self.findings: List[Finding] = []
        self.calls_out: List[Tuple[ast.AST, FrozenSet[str]]] = []
        self.returned = False
        self._depth = 0

    # -- is it a tensor --------------------------------------------------

    def t(self, node: ast.AST, env: Dict[str, bool]) -> bool:
        if isinstance(node, ast.Name):
            return env.get(node.id, False)
        if isinstance(node, ast.Attribute):
            return node.attr not in STATIC_ATTRS and self.t(node.value, env)
        if isinstance(node, ast.Subscript):
            return self.t(node.value, env)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in node.ops):
                return False
            return self.t(node.left, env) or any(self.t(c, env) for c in node.comparators)
        if isinstance(node, ast.BinOp):
            return self.t(node.left, env) or self.t(node.right, env)
        if isinstance(node, ast.BoolOp):
            return any(self.t(v, env) for v in node.values)
        if isinstance(node, ast.UnaryOp):
            return self.t(node.operand, env)
        if isinstance(node, ast.IfExp):
            return self.t(node.body, env) or self.t(node.orelse, env)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.t(e, env) for e in node.elts)
        if isinstance(node, ast.Dict):
            return any(self.t(v, env) for v in node.values if v is not None)
        if isinstance(node, ast.Starred):
            return self.t(node.value, env)
        if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.DictComp)):
            return any(self.t(g.iter, env) for g in node.generators)
        if isinstance(node, ast.Call):
            return self._call_is_tensor(node, env)
        return False

    def _call_is_tensor(self, call: ast.Call, env) -> bool:
        func = call.func
        name = call_name(call) or ""
        if name.split(".")[-1] in SANITIZER_CALLS:
            return False
        if isinstance(func, ast.Name) and func.id in CONCRETIZERS:
            return False  # a host scalar; the read itself is the finding
        if isinstance(func, ast.Attribute) and func.attr in STATIC_METHODS | SYNC_METHODS:
            return False
        torch_name = _torch_name(self.module, call)
        if torch_name is not None:
            return not (torch_name.startswith(TORCH_HOST_PREFIXES) or torch_name.split(".")[-1] in TORCH_HOST_CALLS)
        if isinstance(func, ast.Attribute) and self.t(func.value, env):
            return True  # a tensor's method
        callee = self._callee(call, env)
        if callee is not None:
            return self._returns_tensor(*callee)
        return any(self.t(a, env) for a in call.args) or any(self.t(kw.value, env) for kw in call.keywords)

    def _callee(self, call: ast.Call, env) -> Optional[Tuple[ast.AST, FrozenSet[str]]]:
        """The module-local def ``call`` runs and its tensor parameters."""
        func = call.func
        skip = 0
        target = None
        if isinstance(func, ast.Name):
            target = self.index.resolve_name(func.id, call)
        elif isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name) and func.value.id in ("self", "cls"):
            target = self.index.resolve_method(self.index.enclosing_class(call), func.attr)
            skip = 1
        if target is None:
            return None
        params = [a.arg for a in getattr(target.args, "posonlyargs", [])] + [a.arg for a in target.args.args]
        params = params[skip:] if params[:1] in (["self"], ["cls"]) else params
        tensors: Set[str] = set()
        for i, arg in enumerate(call.args):
            if not isinstance(arg, ast.Starred) and i < len(params) and self.t(arg, env):
                tensors.add(params[i])
        named = set(params) | {a.arg for a in target.args.kwonlyargs}
        for kw in call.keywords:
            if kw.arg in named and self.t(kw.value, env):
                tensors.add(kw.arg)
        return target, frozenset(tensors)

    def _returns_tensor(self, target: ast.AST, tensors: FrozenSet[str]) -> bool:
        key = (target, tensors)
        memo = self.shared.returns
        if key not in memo:
            memo[key] = False  # a recursive call returns no tensor
            probe = _CaptureAnalysis(self.module, self.shared)
            probe.run(target, set(tensors))
            memo[key] = probe.returned
        return memo[key]

    # -- the walk ----------------------------------------------------------

    def run(self, fn: ast.AST, tensors: Set[str]) -> None:
        env = {name: True for name in tensors}
        if isinstance(fn, ast.Lambda):
            self._expr(fn.body, env)
            self.returned = self.t(fn.body, env)
        else:
            self._block(fn.body, env)

    def _flag(self, rule: str, node: ast.AST, msg: str) -> None:
        self.findings.append(Finding(rule, self.module.rel, node.lineno, node.col_offset, msg))

    def _check_call(self, call: ast.Call, env) -> None:
        why = sync_reason(self.module, call, lambda node: self.t(node, env))
        if why:
            self._flag("GL101", call, f"{why} inside capture-reachable code: a CUDA graph cannot record it "
                                      "(the capture fails, or every replay skips it)")
        callee = self._callee(call, env)
        if callee is not None:
            self.calls_out.append(callee)

    def _expr(self, node: ast.AST, env, test_of: Optional[ast.AST] = None) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._check_call(sub, env)
            elif isinstance(sub, ast.BoolOp) and sub is not test_of:
                if any(self.t(v, env) for v in sub.values[:-1]):
                    op = "and" if isinstance(sub.op, ast.And) else "or"
                    self._flag("GL102", sub, f"`{op}` on a tensor inside capture-reachable code: the graph keeps "
                                             "the operand its capture chose (use torch.where or a host switch)")
            elif isinstance(sub, ast.IfExp) and self.t(sub.test, env):
                self._flag("GL102", sub, "a conditional expression on a tensor inside capture-reachable code: the "
                                         "graph keeps the branch its capture took (use torch.where)")

    def _bind(self, target: ast.AST, value: bool, env) -> None:
        if isinstance(target, ast.Name):
            env[target.id] = value
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, value, env)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, value, env)

    def _block(self, stmts: List[ast.stmt], env: Dict[str, bool]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a def nested in captured code is called with its tensors
                child = dict(env)
                for a in list(getattr(stmt.args, "posonlyargs", [])) + stmt.args.args + stmt.args.kwonlyargs:
                    child[a.arg] = True
                self._depth += 1
                self._block(stmt.body, child)
                self._depth -= 1
            elif isinstance(stmt, ast.Assign):
                self._expr(stmt.value, env)
                value = self.t(stmt.value, env)
                for target in stmt.targets:
                    self._bind(target, value, env)
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                self._expr(stmt.value, env)
                self._bind(stmt.target, self.t(stmt.value, env), env)
            elif isinstance(stmt, ast.AugAssign):
                self._expr(stmt.value, env)
                if isinstance(stmt.target, ast.Name):
                    env[stmt.target.id] = env.get(stmt.target.id, False) or self.t(stmt.value, env)
            elif isinstance(stmt, (ast.If, ast.While)):
                self._expr(stmt.test, env, test_of=stmt.test)
                if self.t(stmt.test, env):
                    kind = "if" if isinstance(stmt, ast.If) else "while"
                    self._flag("GL102", stmt, f"Python `{kind}` on a tensor inside capture-reachable code: the "
                                              "graph keeps the branch its capture took (use torch.where, or "
                                              "hoist the switch to the host)")
                self._block(stmt.body, env)
                self._block(stmt.orelse, env)
            elif isinstance(stmt, ast.For):
                self._expr(stmt.iter, env)
                self._bind(stmt.target, self.t(stmt.iter, env), env)
                self._block(stmt.body, env)
                self._block(stmt.orelse, env)
            elif isinstance(stmt, ast.With):
                for item in stmt.items:
                    self._expr(item.context_expr, env)
                self._block(stmt.body, env)
            elif isinstance(stmt, ast.Try):
                self._block(stmt.body, env)
                for handler in stmt.handlers:
                    self._block(handler.body, env)
                self._block(stmt.orelse, env)
                self._block(stmt.finalbody, env)
            elif isinstance(stmt, ast.Return) and stmt.value is not None:
                self._expr(stmt.value, env)
                if self._depth == 0 and self.t(stmt.value, env):
                    self.returned = True
            elif isinstance(stmt, (ast.Expr, ast.Assert, ast.Raise, ast.Delete)):
                self._expr(stmt, env)


def _capture_roots(module: Module, index: _FuncIndex) -> List[Tuple[ast.AST, FrozenSet[str]]]:
    """(def or lambda, tensor parameters) for every capture entry call."""
    roots = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        kind = CAPTURE_ENTRIES.get((call_name(node) or "").split(".")[-1])
        if kind is None:
            continue
        expr = node.args[0] if node.args else next(
            (kw.value for kw in node.keywords if kw.arg in CAPTURE_KEYWORDS), None)
        if expr is None:
            continue
        if isinstance(expr, ast.Call) and (call_name(expr) or "").split(".")[-1] != "partial":
            # a factory called in place: the def it runs makes the callable
            kind, expr = "factory", expr.func
        resolved = index.resolve_callable(expr, node, set())
        if resolved is None:
            continue
        target, bound = resolved
        if kind == "factory":
            roots.append((target, frozenset()))
            continue
        params = [a.arg for a in list(getattr(target.args, "posonlyargs", [])) + target.args.args]
        roots.append((target, frozenset(p for p in params if p not in ("self", "cls") and p not in bound)))
    return roots


def _capture_contexts(module: Module, shared: _Shared) -> Dict[ast.AST, Set[str]]:
    """Every def (or lambda) of ``module`` a capture reaches -> its tensor
    parameters: the fixpoint from the capture roots."""
    contexts: Dict[ast.AST, Set[str]] = {}
    work = deque(_capture_roots(module, shared.index))
    steps = 0
    while work and steps < 10_000:
        steps += 1
        fn, tensors = work.popleft()
        have = contexts.get(fn)
        if have is not None and set(tensors) <= have:
            continue
        contexts[fn] = (have or set()) | set(tensors)
        probe = _CaptureAnalysis(module, shared)
        probe.run(fn, contexts[fn])
        work.extend(probe.calls_out)
    return contexts


def capture_reachable(module: Module) -> List[ast.AST]:
    """The defs and lambdas of ``module`` that a CUDA graph captures."""
    return list(_capture_contexts(module, _Shared(module)))


def capture_findings(module: Module) -> List[Finding]:
    """GL101 and GL102 of one module, from one fixpoint over its capture
    roots (kept on the module, so selecting both rules runs it once)."""
    cached = getattr(module, "_port_capture_findings", None)
    if cached is not None:
        return cached
    findings: List[Finding] = []
    shared = _Shared(module)
    contexts = _capture_contexts(module, shared)
    seen = set()
    for fn, tensors in contexts.items():
        final = _CaptureAnalysis(module, shared)
        final.run(fn, tensors)
        for f in final.findings:
            key = (f.rule, f.line, f.col)
            if key not in seen:
                seen.add(key)
                findings.append(f)
    module._port_capture_findings = findings  # type: ignore[attr-defined]
    return findings


class HostSyncInCapture(Rule):
    id = "GL101"
    title = "host sync in capture-reachable code"

    def check_module(self, module: Module, project: Project) -> Iterable[Finding]:
        return [f for f in capture_findings(module) if f.rule == self.id]


class ControlFlowOnTensor(Rule):
    id = "GL102"
    title = "Python control flow on a tensor in capture-reachable code"

    def check_module(self, module: Module, project: Project) -> Iterable[Finding]:
        return [f for f in capture_findings(module) if f.rule == self.id]


def hot_functions(module: Module) -> List[ast.AST]:
    """The defs of ``module`` that GL110 holds to no host sync."""
    declared: Set[str] = set()
    for suffix, names in HOT_PATHS.items():
        if module.rel.endswith(suffix):
            declared |= names
    out = []
    for node in module.tree.body:
        members = [(None, node)] if not isinstance(node, ast.ClassDef) else [(node.name, sub) for sub in node.body]
        for cls, fn in members:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name in declared or f"{cls}.{fn.name}" in declared or module.has_marker("hot-path", fn.lineno):
                out.append(fn)
    return out


class HostSyncInHotPath(Rule):
    id = "GL110"
    title = "host sync on a hot path"

    def check_module(self, module: Module, project: Project) -> Iterable[Finding]:
        findings: List[Finding] = []
        for fn in hot_functions(module):
            for node in ast.walk(fn):
                why = sync_reason(module, node) if isinstance(node, ast.Call) else None
                if why:
                    findings.append(Finding(
                        self.id, module.rel, node.lineno, node.col_offset,
                        f"host sync inside hot path `{fn.name}`: {why} (move it off the dispatch path, or "
                        "suppress with a justification if the sync is the point)"))
        return findings


#: torch's draws from its global generator (``torch.manual_seed``'s)
TORCH_GLOBAL_RNG = {"rand", "randn", "randint", "randperm", "normal", "bernoulli", "multinomial", "rand_like",
                    "randn_like", "randint_like", "poisson"}


class UnseededGlobalRNG(UnseededModuleRNG):
    """The JAX rule's numpy and ``random`` draws, and torch's global
    generator: a ``torch.rand*`` draw with no ``generator=``."""

    title = "unseeded global RNG in library code"

    def check_module(self, module: Module, project: Project) -> Iterable[Finding]:
        findings = list(super().check_module(module, project))
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            torch_name = _torch_name(module, node)
            if (torch_name and torch_name.count(".") == 1 and torch_name.split(".")[1] in TORCH_GLOBAL_RNG
                    and not any(kw.arg == "generator" for kw in node.keywords)):
                findings.append(Finding(
                    self.id, module.rel, node.lineno, node.col_offset,
                    f"{torch_name}() draws from torch's global generator: every caller and thread shares it, "
                    "so a draw's value depends on what ran before; pass generator=torch.Generator(...)"
                    ".manual_seed(seed) plumbed from config"))
        return findings


# ---------------------------------------------------------------------------
# GL130: a batch or state read after a donating call
# ---------------------------------------------------------------------------

#: the port's donations (``core/maml.py``): ``donate_batch`` empties the
#: batch (``_drop_batch``), ``donate_train_state`` writes the new state
#: into the given one (``_write_into``); each donates its first argument
DONATING_FUNCS = {"_drop_batch", "donate_batch", "_write_into", "donate_train_state"}


def _donated_args(call: ast.Call) -> List[str]:
    """Names a call donates: the first argument of a donating function,
    the state and the batch (the first two arguments) of a call with
    ``donate=True``."""
    name = (call_name(call) or "").split(".")[-1]
    if name in DONATING_FUNCS:
        args = call.args[:1]
    elif any(kw.arg == "donate" and isinstance(kw.value, ast.Constant) and kw.value.value is True
             for kw in call.keywords):
        args = call.args[:2]
    else:
        return []
    return [a.id for a in args if isinstance(a, ast.Name)]


class DonationAfterUse(Rule):
    id = "GL130"
    title = "donated batch or state read after the donating call"

    def check_module(self, module: Module, project: Project) -> Iterable[Finding]:
        findings: List[Finding] = []
        if not any(isinstance(n, ast.Call) and _donated_args(n) for n in ast.walk(module.tree)):
            return findings
        scopes = [module.tree] + [n for n in ast.walk(module.tree)
                                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for scope in scopes:
            inner: Set[ast.AST] = set()
            for stmt in scope.body:
                for n in ast.walk(stmt):
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                        inner.update(ast.walk(n))
            # a rebind takes effect when its statement ends: `state = f(\n state, ...)` is clean
            store_at: Dict[ast.AST, int] = {}
            events = []
            for stmt in scope.body:
                # a donating call in a return statement ends the scope
                returned = {n for ret in ast.walk(stmt) if isinstance(ret, ast.Return) for n in ast.walk(ret)}
                for node in ast.walk(stmt):
                    if node in inner or node in returned:
                        continue
                    if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                        end = getattr(node, "end_lineno", None) or node.lineno
                        for target in node.targets if isinstance(node, ast.Assign) else [node.target]:
                            for sub in ast.walk(target):
                                if isinstance(sub, ast.Name):
                                    store_at[sub] = end
                    if isinstance(node, ast.Call):
                        end = getattr(node, "end_lineno", None) or node.lineno
                        events.extend(("donate", end, name) for name in _donated_args(node))
            for stmt in scope.body:
                for node in ast.walk(stmt):
                    if node in inner or not isinstance(node, ast.Name):
                        continue
                    if node in store_at:
                        events.append(("store", store_at[node], node.id))
                    else:
                        kind = "store" if isinstance(node.ctx, (ast.Store, ast.Del)) else "load"
                        events.append((kind, node.lineno, node.id))
            events.sort(key=lambda e: (e[1], {"load": 0, "donate": 1, "store": 2}[e[0]]))
            donated: Dict[str, int] = {}
            for kind, line, name in events:
                if kind == "donate":
                    donated[name] = line
                elif kind == "store":
                    donated.pop(name, None)
                elif name in donated and line > donated[name]:
                    findings.append(Finding(
                        self.id, module.rel, line, 0,
                        f"`{name}` was donated (line {donated[name]}) and read afterwards: a donated batch is "
                        "emptied and a donated state holds the new values; rebind the result or drop the "
                        "donation"))
                    donated.pop(name, None)
        return findings


# ---------------------------------------------------------------------------
# GL140: literal float cast outside the precision policy
# ---------------------------------------------------------------------------

PRECISION_SCOPED_FRAGMENTS = tuple(f"howtotrainyourmamlpytorch_tpu_torch/{d}/" for d in ("models", "core", "ops",
                                                                                         "serving"))
PRECISION_HOME_SUFFIX = "howtotrainyourmamlpytorch_tpu_torch/ops/precision.py"
FLOAT_DTYPE_NAMES = {"float32", "float64", "float16", "bfloat16", "half", "single", "double", "float"}
CAST_METHODS = {"float": "float32", "half": "float16", "bfloat16": "bfloat16", "double": "float64"}


def _float_literal(module: Module, node: ast.AST) -> Optional[str]:
    """The dtype a literal names (``torch.bfloat16``, ``np.float32``,
    ``"float16"``), None for a value-derived one (``p.dtype``)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value if node.value in FLOAT_DTYPE_NAMES else None
    name = dotted_name(node)
    if not name:
        return None
    root, _, rest = name.partition(".")
    resolved = module.resolve_root(root) + ("." + rest if rest else "")  # `from torch import bfloat16` too
    if "." in resolved and resolved.split(".")[0] in ("torch", "numpy") and resolved.rsplit(".", 1)[1] in \
            FLOAT_DTYPE_NAMES:
        return name
    return None


class FloatCastOutsidePolicy(Rule):
    id = "GL140"
    title = "float-dtype cast outside the precision policy"

    def check_module(self, module: Module, project: Project) -> Iterable[Finding]:
        rel = module.rel.replace("\\", "/")
        if rel.endswith(PRECISION_HOME_SUFFIX) or not any(frag in rel for frag in PRECISION_SCOPED_FRAGMENTS):
            return ()
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
                continue
            attr = node.func.attr
            literal = None
            if attr in CAST_METHODS and not node.args and not node.keywords:
                literal = f".{attr}() ({CAST_METHODS[attr]})"
            elif attr in ("to", "astype", "type"):
                for arg in list(node.args) + [kw.value for kw in node.keywords if kw.arg == "dtype"]:
                    name = _float_literal(module, arg)
                    if name:
                        literal = f".{attr}({name})"
                        break
            if literal:
                findings.append(Finding(
                    self.id, module.rel, node.lineno, node.col_offset,
                    f"{literal} in a hot-path module: float-dtype casts live in ops/precision.py (use the policy, "
                    "or a value-derived dtype like `p.dtype`); suppress with a justification if this cast really "
                    "is not on the hot path"))
        return findings
