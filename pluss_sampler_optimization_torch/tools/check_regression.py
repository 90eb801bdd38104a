"""Gate the repo's performance trajectory against regressions.

The port's twin of the JAX package's tools/check_regression.py: the same
command line and output, on the port's modules.

The run ledger records per-request latency / stage timings / compile
deltas, and the BENCH_r*.json evidence sidecars record each round's
headline metric — a passive history until now. This tool is the CI
face of pluss_sampler_optimization_torch/runtime/obs/regress.py (the
serve-mode SLO sentinel evaluates the same checks live): it splits
the ledger into baseline-vs-recent halves per engine (p50 total
latency, p50 execute-stage latency, mean backend compiles per
request) and compares the newest bench headline against the median of
the prior rounds, flagging anything worse than the noise band.

Exit 0 when no check regressed (including "not enough history for any
check" — a fresh repo has no trajectory to regress against); exit 1
on any regression or unreadable ledger.

    python -m pluss_sampler_optimization_torch.tools.check_regression [--ledger LEDGER.jsonl]
        [--bench BENCH_r01.json BENCH_r02.json ...]
        [--noise-band 0.25] [--min-samples 5]

Typical CI invocation over the repo's evidence trail:

    python -m pluss_sampler_optimization_torch.tools.check_regression --bench BENCH_r*.json
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    from pluss_sampler_optimization_torch.runtime.obs import (
        ledger, regress,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("--ledger", default=None,
                    help="run ledger JSONL file (per-engine latency / "
                    "stage / compile-count history)")
    ap.add_argument("--bench", nargs="*", default=None,
                    metavar="FILE",
                    help="BENCH_r*.json evidence files, oldest first "
                    "(shell globs expand in order for the r01..rNN "
                    "naming)")
    ap.add_argument("--noise-band", type=float,
                    default=regress.DEFAULT_NOISE_BAND,
                    help="allowed fractional slack before a worse "
                    "recent value counts as a regression "
                    "(default %(default)s)")
    ap.add_argument("--min-samples", type=int,
                    default=regress.DEFAULT_MIN_SAMPLES,
                    help="minimum ledger rows per baseline/recent "
                    "half for an engine's checks to run "
                    "(default %(default)s)")
    args = ap.parse_args(argv)

    if not args.ledger and not args.bench:
        ap.error("nothing to check: pass --ledger and/or --bench")

    rows = None
    if args.ledger:
        if not os.path.isfile(args.ledger):
            print(f"{args.ledger}: not a file", file=sys.stderr)
            return 1
        rows = ledger.read_rows(args.ledger)

    report = regress.evaluate(
        rows=rows, bench_paths=args.bench,
        noise_band=args.noise_band, min_samples=args.min_samples,
    )
    for line in regress.format_report(report):
        print(line)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
