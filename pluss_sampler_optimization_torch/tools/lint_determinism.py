"""AST lint for the bit-identity hot spots.

The port's twin of the JAX package's tools/lint_determinism.py: the same
command line and output, on the port's modules.

The repo's serving story rests on a handful of functions whose output
must be a pure value function of their inputs: the request
fingerprint (service/fingerprint.py — cache addresses), the CRI
distribution and histogram folds (runtime/cri.py, runtime/hist.py —
the MRC bytes themselves), the ledger's MRC digest
(runtime/obs/ledger.py::mrc_digest — the cross-run attribution key),
and the chaos layer's counter hash and seeded backoff jitter
(runtime/faults.py::_mix/counter_u01/backoff_delay — fault replay
and retry schedules must be pure functions of (seed, path)).
A wall-clock read, an RNG draw, a PYTHONHASHSEED-dependent `hash()`,
or iteration over an unordered set silently breaks the bit-identity
contract tier-1 pins everywhere else.

This lint walks the AST of those targets and reports:

  wallclock   time.time / time.time_ns / perf_counter / monotonic /
              datetime.now / utcnow
  entropy     random.* / np.random.* / numpy.random.* / os.urandom /
              uuid.uuid4 / secrets.*
  hashseed    the builtin hash() (PYTHONHASHSEED-dependent)
  set-order   a for-loop or comprehension iterating a set literal,
              set/frozenset() call, or set comprehension without a
              sorted(...) wrapper (iteration order is salted)

Violation ids are `relpath::qualname::rule`; lines in
pluss_sampler_optimization_torch/tools/lint_determinism_allow.txt
(one id per line, '#' comments)
suppress a finding after human review. tests/test_analysis.py runs
the lint from tier-1 (clean run required) and checks it still
catches synthetic violations. Driver plumbing (Violation, allowlist,
JSON report shape, the `--fixtures` self-test convention) is shared
with tools/check_concurrency.py via analysis/lint_common.py.

    python -m pluss_sampler_optimization_torch.tools.lint_determinism
        [--list-targets] [--json] [--fixtures]
"""

from __future__ import annotations

import argparse
import ast
import os
import sys
import textwrap

from pluss_sampler_optimization_torch.analysis import (
    lint_common,
)
from pluss_sampler_optimization_torch.analysis.lint_common import (
    Violation,
)

PKG = "pluss_sampler_optimization_torch"

# (relative path, qualname prefix or None for the whole file)
TARGETS = (
    (f"{PKG}/service/fingerprint.py", None),
    (f"{PKG}/runtime/cri.py", None),
    (f"{PKG}/runtime/hist.py", None),
    (f"{PKG}/runtime/obs/ledger.py", "mrc_digest"),
    # chaos layer: fault decisions and backoff jitter replay from
    # (seed, path) — any clock or RNG here breaks chaos-run replay
    (f"{PKG}/runtime/faults.py", "_mix"),
    (f"{PKG}/runtime/faults.py", "counter_u01"),
    (f"{PKG}/runtime/faults.py", "backoff_delay"),
    # kernel-backend selection must depend only on (config, backend
    # platform, library availability) — a clock or RNG here would
    # make bit-identity across kernel_backend values unreproducible
    (f"{PKG}/sampler/sampled.py", "_sampled_backend"),
    # progressive precision: bootstrap resamples, round schedules, and
    # band folds must replay exactly from the request (seed, knobs) —
    # any clock/RNG here breaks partial_final replay and the
    # tolerance-stop round count (tools/check_precision.py pins both)
    (f"{PKG}/sampler/confidence.py", None),
)

ALLOWLIST_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "lint_determinism_allow.txt",
)

# dotted-name bans: exact names, or prefixes ending in "."
_WALLCLOCK = {"time.time", "time.time_ns", "time.perf_counter",
              "time.monotonic", "datetime.now",
              "datetime.utcnow", "datetime.datetime.now",
              "datetime.datetime.utcnow"}
_ENTROPY_EXACT = {"os.urandom", "uuid.uuid4"}
_ENTROPY_PREFIX = ("random.", "np.random.", "numpy.random.",
                   "secrets.")


def _dotted(node: ast.AST) -> str | None:
    """`a.b.c` -> "a.b.c" when the chain roots in a bare Name."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("set", "frozenset")
    return False


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.stack: list[str] = []
        self.violations: list[Violation] = []

    @property
    def qualname(self) -> str:
        return ".".join(self.stack) or "<module>"

    def _flag(self, rule: str, node: ast.AST, detail: str) -> None:
        self.violations.append(Violation(
            path=self.path, qualname=self.qualname, rule=rule,
            line=getattr(node, "lineno", 0), detail=detail))

    # -- scoping ------------------------------------------------------

    def _scoped(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = _scoped
    visit_AsyncFunctionDef = _scoped
    visit_ClassDef = _scoped

    # -- rules --------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        if name is not None:
            if name in _WALLCLOCK:
                self._flag("wallclock", node, f"call to {name}()")
            elif name in _ENTROPY_EXACT or name.startswith(
                _ENTROPY_PREFIX
            ):
                self._flag("entropy", node, f"call to {name}()")
        if isinstance(node.func, ast.Name) and node.func.id == "hash":
            self._flag(
                "hashseed", node,
                "builtin hash() is PYTHONHASHSEED-dependent; use "
                "hashlib over a canonical encoding",
            )
        self.generic_visit(node)

    def _check_iter(self, node: ast.AST, it: ast.AST) -> None:
        if _is_set_expr(it):
            self._flag(
                "set-order", node,
                "iterating an unordered set; wrap in sorted(...)",
            )

    def visit_For(self, node: ast.For) -> None:
        self._check_iter(node, node.iter)
        self.generic_visit(node)

    def _comp(self, node) -> None:
        for gen in node.generators:
            self._check_iter(node, gen.iter)
        self.generic_visit(node)

    visit_ListComp = _comp
    visit_SetComp = _comp
    visit_DictComp = _comp
    visit_GeneratorExp = _comp


def lint_source(source: str, path: str,
                qualname: str | None = None) -> list[Violation]:
    """Lint one file's source; restrict to `qualname` (a top-level
    def/class name) when given."""
    tree = ast.parse(source, filename=path)
    if qualname is not None:
        body = [n for n in tree.body
                if getattr(n, "name", None) == qualname]
        if not body:
            return [Violation(path=path, qualname=qualname,
                              rule="missing", line=0,
                              detail=f"target {qualname!r} not found")]
        tree = ast.Module(body=body, type_ignores=[])
    linter = _Linter(path)
    linter.visit(tree)
    return linter.violations


def read_allowlist(path: str = ALLOWLIST_PATH) -> set[str]:
    return lint_common.read_allowlist(path)


#: seeded bad-pattern fixtures, one per rule, in the shared
#: lint_common.check_fixtures convention (--fixtures / tier-1)
FIXTURES = {
    "wallclock": (textwrap.dedent("""
        import time

        def fingerprint(payload):
            return (payload, time.time())
    """), "wallclock"),
    "entropy": (textwrap.dedent("""
        import random

        def salt():
            return random.random()
    """), "entropy"),
    "hashseed": (textwrap.dedent("""
        def key(payload):
            return hash(payload)
    """), "hashseed"),
    "set_order": (textwrap.dedent("""
        def fold(refs):
            return [r for r in set(refs)]
    """), "set-order"),
}


def run_lint(repo_root: str | None = None,
             targets=TARGETS,
             allowlist: set[str] | None = None) -> list[Violation]:
    """Lint every target file; returns unallowed violations."""
    root = repo_root or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))
    ))
    allow = read_allowlist() if allowlist is None else allowlist
    out: list[Violation] = []
    for rel, qual in targets:
        with open(os.path.join(root, rel)) as f:
            source = f.read()
        out.extend(
            v for v in lint_source(source, rel, qual)
            if v.id not in allow
        )
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="determinism lint over the bit-identity hot spots"
    )
    ap.add_argument("--list-targets", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report (shared shape with "
                         "tools/check_concurrency.py)")
    ap.add_argument("--fixtures", action="store_true",
                    help="self-test: every seeded bad pattern must "
                         "trip its expected rule")
    args = ap.parse_args(argv)
    if args.list_targets:
        for rel, qual in TARGETS:
            print(f"{rel}" + (f"::{qual}" if qual else ""))
        return 0
    if args.fixtures:
        problems = lint_common.check_fixtures(
            FIXTURES, lambda s, p: lint_source(s, p)
        )
        for p in problems:
            print(f"FIXTURE FAIL: {p}", file=sys.stderr)
        print(f"lint_determinism --fixtures: {len(FIXTURES)} "
              f"fixture(s), {len(problems)} problem(s)")
        return 1 if problems else 0
    allow = read_allowlist()
    all_violations = run_lint(allowlist=set())
    violations, suppressed = lint_common.split_allowed(
        all_violations, allow
    )
    doc = lint_common.report_doc(
        "lint_determinism", len(TARGETS), violations, suppressed
    )
    lint_common.print_report(doc, args.json)
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
