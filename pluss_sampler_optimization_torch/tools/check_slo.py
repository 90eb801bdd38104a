"""Offline SLO gate over a run ledger.

The port's twin of the JAX package's tools/check_slo.py: the same
command line and output, on the port's modules.

The serve-mode SLO sentinel (runtime/obs/slo.py) watches the live
metrics registry; this tool is its CI-side twin, the check_drift.py /
check_ledger.py pattern applied to service-level objectives: point it
at a ledger and it recomputes the multi-window burn rates from the
rows themselves (windows anchored at the NEWEST request row, so an
archived ledger audits its own era rather than always passing because
it is old).

Checks (all burn-rate checks breach only when the burn exceeds
--burn-threshold in BOTH windows — the SRE multi-window rule):

- latency: fraction of requests slower than --latency-p95-s against a
  --latency-budget slow allowance (omit the flag to skip);
- errors: fraction of requests that failed or completed degraded
  against --error-budget;
- drift: any (model, n) whose LATEST drift row breaches inside the
  long window;
- batch occupancy: ledger occupancy p50 below --min-occupancy (omit
  to skip; only evaluated when batched rows exist).

Exit code 0 = inside budget, 1 = breach (or unreadable ledger), so CI
gates on it exactly like the other tools:

    python -m pluss_sampler_optimization_torch.tools.check_slo LEDGER.jsonl --latency-p95-s 30 \
        --error-budget 0.1 [--windows 30s,5m] [--burn-threshold 1.0]
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("ledger", help="run ledger JSONL file")
    ap.add_argument("--latency-p95-s", type=float, default=None,
                    help="latency objective: at most --latency-budget "
                    "of requests may exceed this many seconds "
                    "(omit = skip the latency check)")
    ap.add_argument("--latency-budget", type=float, default=0.05,
                    help="allowed slow fraction for the latency "
                    "objective (default 0.05 = a p95 bound)")
    ap.add_argument("--error-budget", type=float, default=0.01,
                    help="allowed fraction of failed-or-degraded "
                    "requests (default 0.01)")
    ap.add_argument("--burn-threshold", type=float, default=1.0,
                    help="burn-rate trip point; breach needs BOTH "
                    "windows above it (default 1.0)")
    ap.add_argument("--windows", default="30s,5m",
                    help="short,long rolling windows (default "
                    "'30s,5m'; suffixes s/m/h)")
    ap.add_argument("--min-occupancy", type=float, default=None,
                    help="breach when batch occupancy p50 falls "
                    "below this (omit = skip)")
    args = ap.parse_args(argv)

    if not os.path.isfile(args.ledger):
        print(f"{args.ledger}: not a file", file=sys.stderr)
        return 1

    from pluss_sampler_optimization_torch.config import SLOConfig
    from pluss_sampler_optimization_torch.runtime.obs import (
        ledger,
        slo,
    )

    windows = tuple(w.strip() for w in args.windows.split(","))
    if len(windows) != 2:
        print("--windows needs exactly 'short,long'", file=sys.stderr)
        return 1
    try:
        for w in windows:
            slo.window_span_s(w)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1

    config = SLOConfig(
        latency_p95_s=args.latency_p95_s,
        latency_budget=args.latency_budget,
        error_budget=args.error_budget,
        burn_rate_threshold=args.burn_threshold,
        min_batch_occupancy=args.min_occupancy,
        windows=windows,
    )
    rows = ledger.read_rows(args.ledger)
    if not any(r.get("kind") == "request" for r in rows):
        print(f"{args.ledger}: no request rows to evaluate")
        return 0
    report = slo.evaluate(config, rows=rows)
    for line in slo.format_report(report):
        print(line)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
