"""Static concurrency analyzer for the serving runtime.

PLUSS reasons statically about interleavings of simulated threads;
this package applies the same spirit to the project's own
`threading` code. It is jax-free and AST-based — PR 11's IR analyzer
covers loop-nest programs, this one covers the Python that serves
them — and emits machine-readable C_* diagnostics in the shared
`analysis.lint_common` shape:

- C_LOCK_CYCLE        lock-order inversion (potential deadlock)
- C_RELOCK            non-reentrant lock reacquired on one path
- C_BLOCKING_UNDER_LOCK  blocking call while holding a lock
- C_SINK_UNDER_LOCK   telemetry sink call while holding a lock
- C_UNGUARDED_STATE   field written both with and without a lock
- C_SIGNAL_UNSAFE     signal handler beyond flag-set + raise

The static lock-order graph uses the same lock names
("Class._attr" / "modstem._name") as the runtime witness in
`runtime/lockwitness.py`, so `tools/check_concurrency.py` can prove
the static graph is a superset of every order actually observed
under the chaos gate.

Entry points: `analyze_files` (the repo gate), `analyze_source`
(fixtures/tests), `default_targets` (the scanned module set).
"""

from __future__ import annotations

import dataclasses
import os

from ..lint_common import Violation
from . import graph as _graph
from . import lints as _lints
from ._scan import scan_module
from .fixtures import FIXTURES

__all__ = [
    "AnalysisResult",
    "FIXTURES",
    "Violation",
    "analyze_files",
    "analyze_source",
    "default_targets",
    "repo_root",
]

#: modules under analysis: everything that owns threads, locks, or
#: signal handlers. Pure-math modules (sampler/, ir/, frontend/) are
#: single-threaded by design and stay out to keep the graph honest.
_TARGET_DIRS = (
    "pluss_sampler_optimization_torch/service",
    "pluss_sampler_optimization_torch/runtime/obs",
)
#: runtime/lockwitness.py is deliberately absent: it is the
#: measuring instrument, not the measured system — its wrapper
#: classes hold the wrapped primitive plus one leaf bookkeeping lock,
#: and scanning it would inject those internals as junk nodes into
#: the very graph it exists to validate.
_TARGET_FILES = (
    "pluss_sampler_optimization_torch/runtime/telemetry.py",
    "pluss_sampler_optimization_torch/runtime/faults.py",
    "pluss_sampler_optimization_torch/cli.py",
)


@dataclasses.dataclass
class AnalysisResult:
    violations: list
    edges: dict        # (src, dst) -> [(path, qualname, line), ...]
    inventory: dict
    n_files: int
    n_functions: int

    def edge_pairs(self) -> list:
        """Sorted (src, dst) lock-order pairs — the static graph the
        runtime witness is checked against."""
        return sorted(self.edges)

    def to_dict(self) -> dict:
        return {
            "edges": [
                {
                    "src": a, "dst": b,
                    "sites": [
                        {"path": p, "qualname": q, "line": ln}
                        for p, q, ln in sites
                    ],
                }
                for (a, b), sites in sorted(self.edges.items())
            ],
            "inventory": self.inventory,
            "n_files": self.n_files,
            "n_functions": self.n_functions,
        }


def repo_root() -> str:
    """The checkout root (two levels above the package dir)."""
    pkg = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.dirname(pkg)


def default_targets(root: str | None = None) -> list[str]:
    """Repo-relative paths of every module under analysis."""
    root = root or repo_root()
    out = []
    for d in _TARGET_DIRS:
        full = os.path.join(root, d)
        if not os.path.isdir(full):
            continue
        for name in sorted(os.listdir(full)):
            if name.endswith(".py"):
                out.append(f"{d}/{name}")
    for f in _TARGET_FILES:
        if os.path.exists(os.path.join(root, f)):
            out.append(f)
    return out


def _inventory(scans: list) -> dict:
    locks = []
    for s in scans:
        for name, (kind, line) in sorted(s.module_locks.items()):
            locks.append({
                "id": f"{s.stem}.{name}", "kind": kind,
                "path": s.path, "line": line, "scope": "module",
            })
        for cls, attrs in sorted(s.class_locks.items()):
            for attr, (kind, line) in sorted(attrs.items()):
                locks.append({
                    "id": f"{cls}.{attr}", "kind": kind,
                    "path": s.path, "line": line, "scope": "class",
                })
    threads = [
        {"target": tgt, "qualname": q, "path": s.path, "line": ln}
        for s in scans for tgt, q, ln in s.threads
    ]
    executors = [
        {"qualname": q, "path": s.path, "line": ln}
        for s in scans for q, ln in s.executors
    ]
    handlers = [
        {"signal": sig, "qualname": q, "path": s.path, "line": ln}
        for s in scans for sig, _node, q, ln in s.signal_handlers
    ]
    sinks = [
        {"install": fn, "qualname": q, "path": s.path, "line": ln}
        for s in scans for fn, q, ln in s.sink_installs
    ]
    cross = sorted({
        f"{s.stem}.{cls}"
        for s in scans
        for cls in (set(s.class_locks) | set(s.thread_targets))
    })
    return {
        "locks": locks, "threads": threads, "executors": executors,
        "signal_handlers": handlers, "sink_installs": sinks,
        "cross_thread_classes": cross,
    }


def _analyze_scans(scans: list) -> AnalysisResult:
    program = _graph.Program(scans)
    violations, edges = _graph.analyze(program)
    violations = violations + _lints.shared_state_lint(scans)
    violations = violations + _lints.signal_audit(scans)
    violations.sort(key=lambda v: (v.path, v.line, v.rule, v.detail))
    return AnalysisResult(
        violations=violations,
        edges=edges,
        inventory=_inventory(scans),
        n_files=len(scans),
        n_functions=sum(len(s.functions) for s in scans),
    )


def analyze_files(paths: list[str] | None = None,
                  root: str | None = None) -> AnalysisResult:
    """Analyze repo files (repo-relative paths) as one program."""
    root = root or repo_root()
    paths = paths if paths is not None else default_targets(root)
    scans = []
    for rel in paths:
        with open(os.path.join(root, rel)) as fh:
            scans.append(scan_module(fh.read(), rel))
    return _analyze_scans(scans)


def analyze_source(source: str, path: str = "<source>"
                   ) -> AnalysisResult:
    """Analyze one synthetic module (fixtures, tests)."""
    return _analyze_scans([scan_module(source, path)])


def lint_source(source: str, path: str = "<source>") -> list:
    """`lint_common.check_fixtures`-compatible entry point."""
    return analyze_source(source, path).violations
