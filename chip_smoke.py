#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # GEMM N=2048, ratio 0.1, seed 0
    python3 chip_smoke.py --n 256    # a quicker check (no MRC baseline)

Phases, each printing its own lines; any failure exits non-zero:

1. card: the name and power limit nvidia-smi reports;
2. build: csrc/sampled_hist.cu for sm_90a with nvcc, its build seconds
   and ptxas' register/spill lines;
3. kernel vs plain: every dispatch of the main path (the engine's own
   plan_dispatches, so the same host-drawn keys and shapes) through the
   CUDA kernel and through its plain torch version on the card; residual,
   hist, cold and the sorted pair outputs must be equal; both are timed
   with CUDA events;
4. main path: run_sampled -> cri_distribute -> aet_mrc on the card, four
   runs in the order kernel, plain, plain, kernel (kernel_backend "cuda"
   then "torch"), each with its host seconds per stage. Every kernel run
   must launch the kernel once per dispatch of phase 3, every plain run
   never; all four folded PRIStates and MRC bytes must be equal, and the
   MRC's L1 error against baselines/gemm<N>.json.gz must be at most 0.01.

Then one JSON line of kernel numbers, the nvidia-smi line, and last the
result line {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

MRC_L1_LIMIT = 0.01
KERNEL_REPS, PLAIN_REPS = 10, 2  # timed calls per dispatch, after a warm-up
MAIN_PATH_ORDER = ("cuda", "torch", "torch", "cuda")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# Non-tensor-core integer rate of an H100 SXM: 64 INT32 lanes per SM
# (half its 128 FP32 lanes) x 132 SMs x 1.98 GHz = 16.7e12 int32
# operations/s (the FP32 67 TFLOP/s figure counts an FMA as two). An
# int64 add, compare or select takes two int32 instructions.
INT64_OPS_PER_S = 16.7e12 / 2
# Bytes one sample costs the kernel on the main path: its 8 B key read
# and its 8 B residual written (the engine passes no mask).
BYTES_PER_SAMPLE = 8 + 8
REPLACES = "pluss_sampler_optimization_tpu/ops/pallas_sampled.py:126"
SOURCE = "pluss_sampler_optimization_torch/csrc/sampled_hist.cu"
SPANS = ("draw", "stage", "dispatch", "decode", "fold")


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def _time_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls, after one
    warm-up call, from CUDA events around the whole run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _spans_text(spans: dict) -> str:
    return ", ".join(f"{k} {spans.get(k, 0.0):.3f} s" for k in SPANS)


def phase_build() -> None:
    from pluss_sampler_optimization_torch.ops import _build

    t0 = time.perf_counter()
    path, log = _build.build("sampled_hist", force=True)
    print(f"build: {os.path.relpath(path)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: {line.strip()}")


def phase_kernels(n: int, cfg, dev) -> dict:
    """Kernel vs plain on every dispatch of the main path; returns the
    kernel's JSON entry (without launches), its bound's two parts and
    the number of dispatches."""
    import torch

    from pluss_sampler_optimization_torch.config import MachineConfig
    from pluss_sampler_optimization_torch.models import gemm
    from pluss_sampler_optimization_torch.ops.histogram import (
        SENTINEL,
        sorted_k_unique,
    )
    from pluss_sampler_optimization_torch.ops.sampled_hist import (
        ops_per_sample,
        sampled_hist_cuda,
        sampled_hist_plain,
    )
    from pluss_sampler_optimization_torch.sampler import sampled as S

    trace, rows = S._program_rows(gemm(n), MachineConfig())
    spans: dict = {}
    tot = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0}
    max_err = n_dispatches = 0
    for d in S.plan_dispatches(trace, rows, cfg, dev, S.default_batch(dev),
                               "cuda", spans):
        label = "{" + ",".join(d.nt.tables.ref_names[ri]
                               for _, ri in d.members) + "}"
        keys = d.keys_RB

        def kern():
            return sampled_hist_cuda(d.nt, d.ref_idx, keys, None, d.highs,
                                     d.rx_R, d.desc)

        def plain():
            return sampled_hist_plain(d.nt, d.ref_idx, keys, None, d.highs,
                                      d.rx_R)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        for name, a, b in zip(("residual", "hist", "cold"), got, want):
            err = int((a - b).abs().max()) if a.numel() else 0
            max_err = max(max_err, err)
            if not torch.equal(a, b):
                raise AssertionError(
                    f"kernel vs plain: {label} {name} differs "
                    f"(max abs err {err})"
                )
        for j in range(keys.shape[0]):
            pk = [sorted_k_unique(r[j], r[j] != SENTINEL, 64)
                  for r in (got[0], want[0])]
            for a, b in zip(*pk):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"kernel vs plain: {label} sorted_k_unique differs"
                    )
        ms = _time_ms(kern, KERNEL_REPS)
        plain_ms = _time_ms(plain, PLAIN_REPS)
        ops = ops_per_sample(d.desc.cpu().numpy()) * keys.numel()
        nbytes = BYTES_PER_SAMPLE * keys.numel() + 8 * got[1].numel() \
            + 8 * got[2].numel()
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["bytes"] += nbytes
        tot["ops"] += ops
        n_dispatches += 1
        print(f"kernels: dispatch {n_dispatches} {label} R={keys.shape[0]} "
              f"B={keys.shape[1]} equal; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, {ops // keys.numel()} int64 ops/sample")
    print(f"kernels: {n_dispatches} dispatches; host {_spans_text(spans)}")
    bytes_ms = tot["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = tot["ops"] / INT64_OPS_PER_S * 1e3
    return {
        "entry": {
            "name": "sampled_hist", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": None,
            "max_abs_err": max_err, "ms": tot["ms"],
            "plain_ms": tot["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        },
        "bytes_ms": bytes_ms,
        "ops_ms": ops_ms,
        "dispatches": n_dispatches,
    }


def phase_main_path(n: int, cfg, dispatches: int) -> int:
    """Main-path runs on the card in MAIN_PATH_ORDER; returns the
    kernel's launches in one "cuda" run."""
    import torch

    from pluss_sampler_optimization_torch.config import MachineConfig
    from pluss_sampler_optimization_torch.models import gemm
    import pluss_sampler_optimization_torch.ops.sampled_hist as sh
    from pluss_sampler_optimization_torch.runtime.aet import (
        aet_mrc,
        mrc_l1_error,
    )
    from pluss_sampler_optimization_torch.runtime.baseline import (
        load_baseline,
        state_to_json,
    )
    from pluss_sampler_optimization_torch.runtime.cri import cri_distribute
    from pluss_sampler_optimization_torch.sampler.sampled import run_sampled

    machine = MachineConfig()
    T = machine.thread_num
    first = kernel_launches = None
    for i, backend in enumerate(MAIN_PATH_ORDER, 1):
        c = dataclasses.replace(cfg, kernel_backend=backend)
        spans: dict = {}
        sh.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, results = run_sampled(gemm(n), machine, c, device="cuda",
                                     spans=spans)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = sh.LAUNCHES
        mrc = aet_mrc(cri_distribute(state, T, T), machine)
        samples = sum(r.n_samples for r in results)
        print(f"main path: run {i} kernel_backend={backend} gemm({n}) "
              f"{wall:.3f} s ({_spans_text(spans)}, rest "
              f"{wall - sum(spans.values()):.3f} s), {samples} samples, "
              f"{launches} kernel launches, MRC of {len(mrc)} points")
        want = dispatches if backend == "cuda" else 0
        if launches != want:
            raise AssertionError(
                f"main path: {launches} kernel launches under "
                f"kernel_backend={backend} (expected {want})"
            )
        if backend == "cuda":
            kernel_launches = launches
        if first is None:
            first = (state_to_json(state), mrc)
        elif state_to_json(state) != first[0]:
            raise AssertionError(f"main path: run {i}'s PRIState differs")
        elif mrc.tobytes() != first[1].tobytes():
            raise AssertionError(f"main path: run {i}'s MRC bytes differ")
    print("main path: all runs give equal PRIStates and MRC bytes")
    mrc = first[1]
    if not (np.isfinite(mrc).all() and mrc[0] == 1.0
            and (np.diff(mrc) <= 0).all()):
        raise AssertionError("main path: MRC not finite, 1 at 0 and "
                             "non-increasing")
    base = load_baseline("gemm", n, machine)
    if base is None:
        if n in (2048, 4096):
            raise AssertionError(f"main path: baselines/gemm{n}.json.gz "
                                 "is missing")
        print(f"main path: no baseline for gemm{n}; MRC error not checked")
        return kernel_launches
    mrc_b = aet_mrc(cri_distribute(base["state"], T, T), machine)
    err = mrc_l1_error(mrc, mrc_b)
    print(f"main path: MRC L1 error vs baselines/gemm{n}.json.gz: {err!r}")
    if not err <= MRC_L1_LIMIT:
        raise AssertionError(
            f"main path: MRC L1 error {err} above {MRC_L1_LIMIT}"
        )
    return kernel_launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2048)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from pluss_sampler_optimization_torch.config import SamplerConfig

    card = _card_line()
    print(f"card: {card}")
    phase_build()
    cfg = SamplerConfig(ratio=0.1, seed=0)
    k = phase_kernels(args.n, cfg, torch.device("cuda"))
    print(f"kernels: all {k['dispatches']} dispatches: kernel "
          f"{k['entry']['ms']:.3f} ms, plain {k['entry']['plain_ms']:.3f} ms, "
          f"bound {k['entry']['bound_ms']:.3f} ms by "
          f"{k['entry']['bound_by']} (bytes {k['bytes_ms']:.4f} ms, "
          f"int64 operations {k['ops_ms']:.3f} ms)")
    k["entry"]["launches"] = phase_main_path(args.n, cfg, k["dispatches"])
    print(json.dumps({"kernels": [k["entry"]]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
