"""Record a native serial-oracle baseline.

The port's twin of the JAX package's tools/make_baseline.py, on the
port's copy of native/ (built with make at first use). Runs the native
C++ serial full-traversal walk (the reference's accuracy/speed oracle
re-implemented over the IR) on one model/size and stores its
histograms plus measured wall time under `baselines/` (see
runtime/baseline.py), in the JAX package's format. One-time cost per
config; the north-star GEMM N=4096 takes about an hour of one core.

    python -m pluss_sampler_optimization_torch.tools.make_baseline \
        --model gemm --n 4096
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="gemm")
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--reps", type=int, default=1,
                    help="timed repetitions; the stored wall time is "
                    "the median (the reference's speed mode runs 10; "
                    "1 is the pragmatic default for hour-long configs)")
    ap.add_argument("--share-cap", type=int, default=1 << 20,
                    help="native share-pair buffer size; an undersized "
                    "buffer regrows and RE-WALKS, which would silently "
                    "double every timed rep (triangular nests at large "
                    "N need ~1e5-1e6 pairs)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the baseline here instead of "
                    "baselines/<model><n>.json.gz")
    args = ap.parse_args(argv)

    from pluss_sampler_optimization_torch import MachineConfig
    from pluss_sampler_optimization_torch.models import REGISTRY
    from pluss_sampler_optimization_torch.native import run_serial_native
    from pluss_sampler_optimization_torch.runtime.baseline import save_baseline
    from pluss_sampler_optimization_torch.runtime.timing import flush_cache

    machine = MachineConfig()
    prog = REGISTRY[args.model](args.n)
    times = []
    for _ in range(max(1, args.reps)):
        flush_cache()  # reference flushes before timing (pluss.cpp:71-94)
        t0 = time.perf_counter()
        res = run_serial_native(prog, machine, share_cap=args.share_cap)
        times.append(time.perf_counter() - t0)
    secs = sorted(times)[len(times) // 2]
    conditions = {
        "reps": len(times),
        "times_s": [round(t, 4) for t in times],
        "cpus": os.cpu_count(),
        "loadavg_1m": round(os.getloadavg()[0], 2),
    }
    path = save_baseline(
        args.model, args.n, machine, secs, res.total_accesses, res.state,
        path=args.out, conditions=conditions,
    )
    print(f"{path}: {secs:.1f}s median of {times}, "
          f"{res.total_accesses} accesses, {conditions}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
