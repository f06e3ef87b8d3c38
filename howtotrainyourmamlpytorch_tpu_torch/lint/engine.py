"""The port's rule registry and runner, on ``tools/graftlint``'s engine.

The file walk, the parsed :class:`Module` (its suppressions and markers),
:class:`Finding` and the human report are ``tools.graftlint.engine``'s, so a
``# graftlint: disable=GLxxx`` line means the same to both linters. The
registry is this module's own: :func:`register` never touches
``tools.graftlint.engine.RULES``, which the JAX package's self-gate and its
per-rule timing test read in whatever process imports this one.
"""

import json
import time
from typing import Dict, List, Optional, Tuple

from tools.graftlint.engine import Finding, load_project, report_human  # noqa: F401 (report_human: the API)

#: the port's rules, id -> instance
RULES: Dict[str, object] = {}

#: per-rule wall time of the most recent :func:`run_lint`, rule id -> ms
#: (``rule_times_ms`` in the JSON payload, as the root CLI reports it)
LAST_RULE_TIMES_MS: Dict[str, float] = {}


def register(cls):
    """Add one instance of ``cls`` to :data:`RULES` -> ``cls``. Takes the
    JAX linter's rule classes as they are, and the port's own."""
    inst = cls()
    if not inst.id or inst.id in RULES:
        raise ValueError(f"rule id missing or duplicate: {inst.id!r}")
    RULES[inst.id] = inst
    return cls


def run_lint(paths: List[str], rule_ids: Optional[List[str]] = None) -> Tuple[List[Finding], List[Finding]]:
    """Lint ``paths`` with the port's rules -> ``(active, suppressed)``,
    each sorted by path, line, rule and column. ``rule_ids`` restricts the
    run (the CLI's ``--rule``); a shared analysis's sibling findings are
    dropped at the end, as the JAX runner drops them."""
    project = load_project(paths)
    selected = [RULES[r.upper()] for r in rule_ids] if rule_ids else list(RULES.values())
    findings: List[Finding] = list(project.parse_errors)
    LAST_RULE_TIMES_MS.clear()
    for rule in selected:
        started = time.perf_counter()
        for mod in project.modules:
            findings.extend(rule.check_module(mod, project))
        findings.extend(rule.check_project(project))
        LAST_RULE_TIMES_MS[rule.id] = round((time.perf_counter() - started) * 1000.0, 3)
    if rule_ids:
        wanted = {r.upper() for r in rule_ids}
        findings = [f for f in findings if f.rule in wanted or f.rule == "GL001"]
    active: List[Finding] = []
    suppressed: List[Finding] = []
    by_path = {m.rel: m for m in project.modules}
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule, f.col)):
        mod = by_path.get(f.path)
        if mod is not None and mod.is_suppressed(f.rule, f.line):
            f.suppressed = True
            suppressed.append(f)
        else:
            active.append(f)
    return active, suppressed


def report_json(active: List[Finding], suppressed: List[Finding]) -> str:
    """The root CLI's payload: the same keys, this registry's times."""
    counts: Dict[str, int] = {}
    for f in active:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return json.dumps(
        {
            "tool": "graftlint",
            "version": 1,
            "findings": [f.to_dict() for f in active],
            "counts": counts,
            "suppressed": [f.to_dict() for f in suppressed],
            "rule_times_ms": dict(LAST_RULE_TIMES_MS),
        },
        indent=2,
    )
