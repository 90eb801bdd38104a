"""Accuracy-drift gate: sampled-vs-exact MRC audits with an exit code.

The port's twin of the JAX package's tools/check_drift.py: the same
command line and output, on the port's modules.

Runs the drift monitor (pluss_sampler_optimization_torch/runtime/obs/
drift.py) over a small model matrix — by default gemm (the reference
anchor) and mvt (a non-gemm family) — and exits nonzero when any
audit breaches its thresholds or fails to run.
Each audit appends a "drift" row to the run ledger when --ledger is
given, so the BENCH_r*.json trajectory gains a longitudinal
model-quality signal next to the speed numbers. Exercised from tier-1
(tests/test_torch_obs.py), the tools/check_telemetry_schema.py pattern.

    python -m pluss_sampler_optimization_torch.tools.check_drift
        [--models gemm,mvt] [--n 48] [--ratio 0.3] [--seed 0]
        [--ledger LEDGER.jsonl] [--max-abs X] [--mean-abs Y]
        [--device cuda|cpu]

Both engines of every audit run on --device (default cuda).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from pluss_sampler_optimization_torch.runtime.obs import drift

    ap = argparse.ArgumentParser()
    ap.add_argument("--models",
                    default=",".join(drift.DEFAULT_AUDIT_MODELS),
                    help="comma-separated audit models (default "
                    "covers gemm + one non-gemm family)")
    ap.add_argument("--n", type=int, default=drift.DEFAULT_AUDIT_N)
    ap.add_argument("--ratio", type=float,
                    default=drift.DEFAULT_AUDIT_RATIO)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ledger", default=None, metavar="PATH",
                    help="append each audit's drift row to this run "
                    "ledger")
    ap.add_argument("--max-abs", type=float,
                    default=drift.DRIFT_THRESHOLDS["max_abs_delta"],
                    help="max allowed worst-case |miss-ratio delta|")
    ap.add_argument("--mean-abs", type=float,
                    default=drift.DRIFT_THRESHOLDS["mean_abs_delta"],
                    help="max allowed mean |miss-ratio delta|")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    thresholds = {
        "max_abs_delta": args.max_abs,
        "mean_abs_delta": args.mean_abs,
    }
    rc = 0
    for model in filter(None, args.models.split(",")):
        try:
            row = drift.drift_audit(
                model.strip(), n=args.n, ratio=args.ratio,
                seed=args.seed, thresholds=thresholds,
                ledger_path=args.ledger, source="check_drift",
                device=args.device,
            )
        except Exception as e:
            print(f"{model}: audit FAILED ({e!r})", file=sys.stderr)
            rc = 1
            continue
        status = "BREACH" if row["breach"] else "ok"
        line = (
            f"{row['model']} n={row['n']} ratio={row['ratio']:g} "
            f"(exact={row['engine_exact']}): "
            f"max_abs={row['max_abs_delta']:.4f} "
            f"mean_abs={row['mean_abs_delta']:.5f} "
            f"support={row['support']} {status}"
        )
        if row["breach"]:
            rc = 1
            print(line, file=sys.stderr)
        else:
            print(line)
    return rc


if __name__ == "__main__":
    sys.exit(main())
