"""Micro-profile the sampled engine's per-ref stages on the device.

The port's counterpart of the JAX package's tools/profile_tpu_stages.py
(named for what it does on any device): a thin CLI wrapper around
runtime/obs/stage_profile.py::profile_stages — decode, geometry,
best_sink, classify, the pair reduction, the device draw (kernel B3)
and the whole ref's dispatch through kernel B1, each a device-synced
telemetry span. `--profile-hz` also runs the sampling profiler over
the same stage reps.

    python -m pluss_sampler_optimization_torch.tools.profile_stages \\
        [--n 512] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--model", default="gemm")
    ap.add_argument("--ref", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--telemetry-out", default=None, metavar="PATH",
                    help="also write the run's full telemetry JSON")
    ap.add_argument("--profile-hz", type=float, default=None,
                    metavar="HZ",
                    help="also run the sampling wall-clock profiler "
                    "over the stage reps and print its span-seconds "
                    "summary (runtime/obs/profiler.py)")
    args = ap.parse_args(argv)

    from pluss_sampler_optimization_torch.runtime.obs.stage_profile import (
        profile_stages,
    )

    result = profile_stages(
        n=args.n, model=args.model, ref=args.ref, reps=args.reps,
        telemetry_out=args.telemetry_out,
        profile_hz=args.profile_hz, device=args.device,
    )
    snap = result.get("profile")
    if snap is not None:
        print(f"profiler: {snap['samples']} samples @ {snap['hz']} Hz")
        for path, secs in sorted(
            snap["span_seconds"].items(), key=lambda kv: -kv[1]
        )[:10]:
            print(f"  {path:<40s} {secs:8.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
