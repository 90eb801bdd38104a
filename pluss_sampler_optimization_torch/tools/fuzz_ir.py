"""Standing generative-fuzz gate for the program frontend.

The port's twin of the JAX package's tools/fuzz_ir.py. Sweeps seeded
random loop-nest documents through the full frontend contract
(frontend/fuzz.py, the same generators and mutators): schema
round-trip, exact-engine bit-identity vs the numpy oracle,
sampled-engine MRC drift bound, and rejection-with-diagnostic for every
invalid mutant. The engines run on the card unless `--device cpu`.

    python -m pluss_sampler_optimization_torch.tools.fuzz_ir
        [--seeds N] [--start-seed S] [--ratio R] [--drift-max D]
        [--mutants M] [--sharded] [--kernel-backend B ...]
        [--device D] [--json] [-v]

`--sharded` also runs each seed through
parallel/sharded.py::run_sampled_sharded on a two-shard mesh of the
port (two cards where there are two, else two shards of the device)
and requires bit-identity to the solo run. `--kernel-backend`
(repeatable: cuda, torch, native) re-runs each seed's solo config per
named backend (SamplerConfig.kernel_backend) and requires bit-identity
to the solo run, which is itself drift-bounded against the numpy
oracle. `--batched` also runs each seed through run_sampled_multi in a
3-job union bucket and requires bit-identity to the solo run.

Exit code: nonzero on any oracle mismatch, drift violation, accepted
mutant, batched, sharded or backend divergence, or parser crash. Failures print
the seed and the contract clause violated; re-run a single seed with
`--seeds 1 --start-seed S` (the generator is deterministic per seed).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    from pluss_sampler_optimization_torch.config import KERNEL_BACKENDS
    from pluss_sampler_optimization_torch.frontend import fuzz

    ap = argparse.ArgumentParser(
        description="generative IR fuzz gate (engines vs numpy oracle)"
    )
    ap.add_argument("--seeds", type=int, default=100,
                    help="number of seeds to sweep (default 100)")
    ap.add_argument("--start-seed", type=int, default=0)
    ap.add_argument("--ratio", type=float, default=fuzz.RATIO,
                    help="sampled-engine sampling ratio")
    ap.add_argument("--drift-max", type=float, default=fuzz.DRIFT_MAX,
                    help="max |MRC_sampled - MRC_oracle| allowed")
    ap.add_argument("--mutants", type=int, default=4,
                    help="invalid mutants per seed")
    ap.add_argument("--batched", action="store_true",
                    help="also check run_sampled_multi bit-identity vs "
                         "solo per seed (3-job union bucket)")
    ap.add_argument("--sharded", action="store_true",
                    help="also check run_sampled_sharded bit-identity "
                         "vs solo per seed (2-shard mesh)")
    ap.add_argument("--kernel-backend", action="append", default=[],
                    choices=[b for b in KERNEL_BACKENDS if b != "auto"],
                    metavar="B", dest="kernel_backends",
                    help="also re-run each seed with this "
                         "SamplerConfig.kernel_backend and check "
                         "bit-identity vs solo (repeatable)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as one JSON object")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="one line per seed")
    args = ap.parse_args(argv)

    def progress(r):
        if args.verbose:
            print(f"seed {r['seed']:>4}: "
                  f"{'ok' if r['ok'] else 'FAIL'} "
                  f"depth {r['depth']} refs {r['refs']} "
                  f"drift {r['sampled_drift']:.3f} "
                  f"mutants {r['mutants_rejected']}",
                  file=sys.stderr)

    t0 = time.time()
    summary = fuzz.run_seeds(
        args.seeds, start=args.start_seed, ratio=args.ratio,
        drift_max=args.drift_max, n_mutants=args.mutants,
        batched=args.batched, sharded=args.sharded,
        kernel_backends=tuple(args.kernel_backends),
        progress=progress, device=args.device,
    )
    summary["wall_s"] = round(time.time() - t0, 1)
    if args.json:
        print(json.dumps(summary, sort_keys=True))
    else:
        for f in summary["failures"]:
            for err in f["errors"]:
                print(f"SEED {f['seed']} FAIL: {err}",
                      file=sys.stderr)
        print(f"fuzz: {summary['passed']}/{summary['seeds']} seeds "
              f"passed (worst sampled drift "
              f"{summary['worst_drift']:.3f} at seed "
              f"{summary['worst_drift_seed']}, ratio "
              f"{summary['ratio']}, {summary['wall_s']}s)")
    return 1 if summary["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
