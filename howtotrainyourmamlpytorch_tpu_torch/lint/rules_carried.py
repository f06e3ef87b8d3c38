"""The JAX linter's rules whose meaning carries over to the port.

As they are: GL120 (wall-clock-seeded RNG), GL122 (set iteration feeding
construction), GL201/GL202 (unguarded read-modify-write, untimed blocking
wait), GL210 (lock order against ``tools/graftsan/order.toml``), GL211
(guarded field stored bare), GL212 (blocking call under a lock).

Pointed at the port: GL213's heavy roots are torch, triton, jax, jaxlib
and both package roots; GL301/GL302/GL303 read the port's own registries
(``howtotrainyourmamlpytorch_tpu_torch/exit_codes.py`` against
``docs/OPERATIONS.md``'s exit-code table, ``resilience/faults.py::SEAMS``),
whichever other tree is linted beside it.
"""

from typing import Dict, Iterable, List, Optional, Set

from tools.graftlint.engine import Finding, Module, Project, Rule
from tools.graftlint.rules_concurrency import _module_is_import_light, _required_imports
from tools.graftlint.rules_contracts import BareExitCodeLiteral, OperationsRcTableDrift, UnknownFaultSeam

PORT_PACKAGE = "howtotrainyourmamlpytorch_tpu_torch"
#: the JAX package's root: the port's name without its suffix
JAX_PACKAGE = PORT_PACKAGE[: -len("_torch")]

#: what an import-light module of the port must not load at import time:
#: torch (or triton) on a gateway-only host, jax, and either package root,
#: whose ``__init__`` imports its backend
HEAVY_ROOTS = ("torch", "triton", "jax", "jaxlib", JAX_PACKAGE, PORT_PACKAGE)


class _PortRegistries:
    """A project whose registry lookups (``module_by_suffix``) find the
    port's module first, then any other (a snippet tree's)."""

    def __init__(self, project: Project):
        self._project = project

    def __getattr__(self, name):
        return getattr(self._project, name)

    def module_by_suffix(self, suffix: str) -> Optional[Module]:
        return (self._project.module_by_suffix(f"{PORT_PACKAGE}/{suffix}")
                or self._project.module_by_suffix(suffix))


class PortExitCodeLiteral(BareExitCodeLiteral):
    def check_module(self, module: Module, project: Project) -> Iterable[Finding]:
        return super().check_module(module, _PortRegistries(project))


class PortOperationsRcTable(OperationsRcTableDrift):
    def check_project(self, project: Project) -> Iterable[Finding]:
        return super().check_project(_PortRegistries(project))


class PortFaultSeams(UnknownFaultSeam):
    def check_project(self, project: Project) -> Iterable[Finding]:
        return super().check_project(_PortRegistries(project))


class ImportLightClosure(Rule):
    """GL213: a module marked ``# graftlint: import-light`` whose import
    (module scope, class bodies, plain blocks; not a ``try`` that catches
    ImportError, not a function body) reaches a heavy root, directly or
    through the modules it imports."""

    id = "GL213"
    title = "import-light module reaches a heavy root"

    def check_project(self, project: Project) -> Iterable[Finding]:
        by_rel = {m.rel: m for m in project.modules}
        chains: Dict[str, Optional[List[str]]] = {}

        def resolve(dotted: str) -> Optional[Module]:
            path = dotted.replace(".", "/")
            for cand in (path + ".py", path + "/__init__.py"):
                if cand in by_rel:
                    return by_rel[cand]
            return resolve(dotted.rsplit(".", 1)[0]) if "." in dotted else None

        def heavy(dotted: str) -> bool:
            return dotted.split(".")[0] in HEAVY_ROOTS

        def chase(mod: Module, stack: Set[str]) -> Optional[List[str]]:
            if mod.rel in chains:
                return chains[mod.rel]
            if mod.rel in stack:
                return None
            result = None
            for dotted, _, _ in _required_imports(mod):
                if heavy(dotted):
                    result = [dotted]
                    break
                target = resolve(dotted)
                if target is not None and target.rel != mod.rel:
                    sub = chase(target, stack | {mod.rel})
                    if sub is not None:
                        result = [dotted] + sub
                        break
            chains[mod.rel] = result
            return result

        findings: List[Finding] = []
        for mod in project.modules:
            if not _module_is_import_light(mod):
                continue
            for dotted, line, col in _required_imports(mod):
                chain = [dotted] if heavy(dotted) else None
                if chain is None:
                    target = resolve(dotted)
                    sub = chase(target, {mod.rel}) if target is not None and target.rel != mod.rel else None
                    chain = [dotted] + sub if sub is not None else None
                if chain is not None:
                    findings.append(Finding(
                        self.id, mod.rel, line, col,
                        f"import-light module imports `{dotted}`, which reaches `{chain[-1]}` at import time "
                        f"(chain: {' -> '.join(chain)}): it must load on a host with no torch and without "
                        "running a package __init__; import it inside the function that needs it, or guard it "
                        "with try/except ImportError"))
        return findings

