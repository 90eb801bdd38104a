"""Concurrency gate: static lock-order / blocking / shared-state

The port's twin of the JAX package's tools/check_concurrency.py: the same
command line and output, on the port's modules.
analysis over the serving runtime's own source.

Runs pluss_sampler_optimization_torch/analysis/concurrency/ over every
threaded module (service/, runtime/obs/, telemetry, faults,
lockwitness, cli) and fails on any unallowlisted C_* diagnostic:

    python -m pluss_sampler_optimization_torch.tools.check_concurrency [--json] [--graph]
        [--fixtures] [--fixture NAME] [--allowlist FILE]

Exit code: nonzero when any violation survives the allowlist.
`--graph` prints the static lock-order graph (the edge set the
runtime witness in runtime/lockwitness.py is checked against — same
lock names, so `observed ⊆ static` is a set comparison; the chaos
gate tools/check_chaos.py enforces it end-to-end). `--fixtures` runs
the ≥10 seeded bad-pattern fixtures and fails unless every one still
trips its expected code; `--fixture NAME` runs the gate over that
single fixture as if it were repo source (exits nonzero — the
per-fixture catch tier-1 asserts). No jax import; the gate is
instant.

Allowlist (pluss_sampler_optimization_torch/tools/check_concurrency_allow.txt): one violation id
(`path::qualname::rule`) per line, '#' comments, added only after
review — the same workflow as tools/lint_determinism_allow.txt.
"""

from __future__ import annotations

import argparse
import os
import sys

from pluss_sampler_optimization_torch.analysis import (
    concurrency,
    lint_common,
)

ALLOWLIST_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "check_concurrency_allow.txt",
)


def run_gate(allowlist_path: str | None = ALLOWLIST_PATH):
    """(kept_violations, suppressed, result) for the repo run."""
    res = concurrency.analyze_files()
    allow = (
        lint_common.read_allowlist(allowlist_path)
        if allowlist_path else set()
    )
    kept, suppressed = lint_common.split_allowed(res.violations,
                                                allow)
    return kept, suppressed, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="static concurrency analysis gate"
    )
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report")
    ap.add_argument("--graph", action="store_true",
                    help="print the static lock-order graph")
    ap.add_argument("--fixtures", action="store_true",
                    help="self-test: every seeded bad pattern must "
                         "trip its expected C_* code")
    ap.add_argument("--fixture", default=None,
                    help="run the gate over one named fixture "
                         "(exits nonzero: the fixture is a seeded "
                         "bug)")
    ap.add_argument("--allowlist", default=ALLOWLIST_PATH,
                    help="violation-id allowlist file")
    args = ap.parse_args(argv)

    if args.fixtures:
        problems = lint_common.check_fixtures(
            concurrency.FIXTURES, concurrency.lint_source
        )
        for p in problems:
            print(f"FIXTURE FAIL: {p}", file=sys.stderr)
        print(
            f"check_concurrency --fixtures: "
            f"{len(concurrency.FIXTURES)} fixture(s), "
            f"{len(problems)} problem(s)"
        )
        return 1 if problems else 0

    if args.fixture is not None:
        if args.fixture not in concurrency.FIXTURES:
            print(
                f"unknown fixture {args.fixture!r}; have: "
                f"{', '.join(sorted(concurrency.FIXTURES))}",
                file=sys.stderr,
            )
            return 2
        source, _want = concurrency.FIXTURES[args.fixture]
        violations = concurrency.lint_source(
            source, f"<fixture:{args.fixture}>"
        )
        doc = lint_common.report_doc(
            "check_concurrency", 1, violations
        )
        lint_common.print_report(doc, args.json)
        return 1 if violations else 0

    kept, suppressed, res = run_gate(args.allowlist)
    extra = {
        "n_files": res.n_files,
        "n_functions": res.n_functions,
        "n_edges": len(res.edges),
    }
    if args.graph or args.json:
        extra["graph"] = [
            {"src": a, "dst": b, "sites": len(sites)}
            for (a, b), sites in sorted(res.edges.items())
        ]
        extra["inventory"] = res.inventory
    doc = lint_common.report_doc(
        "check_concurrency", res.n_files, kept, suppressed, extra
    )
    if args.graph and not args.json:
        for (a, b), sites in sorted(res.edges.items()):
            p, q, ln = sites[0]
            print(f"{a} -> {b}  ({len(sites)} site(s), e.g. "
                  f"{p}:{ln} in {q})")
    lint_common.print_report(doc, args.json)
    return 1 if kept else 0


if __name__ == "__main__":
    raise SystemExit(main())
