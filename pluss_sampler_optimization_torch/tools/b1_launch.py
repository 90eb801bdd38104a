"""What one launch of kernel B1 (or B2) costs beside its work, on one CUDA card.

    python3 -m pluss_sampler_optimization_torch.tools.b1_launch        # B1
    python3 -m pluss_sampler_optimization_torch.tools.b1_launch --b2   # B2

B1 (csrc/sampled_hist.cu) takes its descriptor by value: a kernel
parameter block of 8 * (9 + MAX_DESC) bytes, 16,456 B at the package's
MAX_DESC of 2048 words, whatever the descriptor's own length. To see
whether that block costs time per launch, the source is built twice
with nvcc, started together: as the package builds it, and with
-DMAX_DESC=384 (a 3,144 B block; GEMM's descriptors have 173 words),
beside the buffer form's library (csrc/sampled_hist_buf.cu).
On GEMM N=2048's descriptors and radices (ratio 0.1) and numpy-seeded
keys in range, at the sizes of the main path's small dispatches (R x B:
the {C0,C1} bucket's 2 x 41,944, a last chunk's 1 x 201,327 of {A0},
and one block's 1 x 256), it times

- back-to-back raw launches of each build through ctypes (outputs
  allocated once, no zero fill), and of the buffer form
  (sampled_hist_launch_buf: the descriptor in a device buffer, staged in
  each block's shared memory, a 72 B parameter block), in turns 16 KB,
  3 KB, buffer, buffer, 3 KB, 16 KB, each turn the mean of LAUNCHES
  launches between two CUDA events; and the host's seconds per call over
  the same launches;
- the package's wrapper sampled_hist_cuda (which allocates and zeroes
  its outputs and packs the radix records) on the same inputs, in the
  parameter form and in the buffer form.

Every raw launch's outputs must equal the wrapper's. Prints the card line,
one line per size, then one JSON object.

With --b2 it times kernel B2 (csrc/pow2_hist.cu) at the sharded
engine's two launch sizes (B2_SIZES: 2^20 and 41,944 elements,
numpy-seeded values over two bins and bool weights): back-to-back raw
launches through ctypes (two outputs allocated once, taken in turns,
each launch zeroing the other) against the wrapper pow2_hist (its
checks, the stream's chained outputs, one allocation), in turns raw, wrapper, wrapper, raw, each turn the mean of
LAUNCHES calls; device ms per call between CUDA events and host us per
call. The raw launch's output must equal the wrapper's.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SHORT_MAX_DESC = 384
LAUNCHES = 200  # timed launches per turn, after a warm-up
SIZES = (("C0,C1", 2, 41944), ("A0", 1, 201327), ("C0,C1", 1, 256))
B2_SIZES = (1 << 20, 41944)


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def _gemm_buckets(n: int) -> dict:
    """{members label: (nest trace, source ref, padded highs, rx)} of
    GEMM N=n's kernel-signature buckets (no draw)."""
    from ..config import MachineConfig, SamplerConfig
    from ..models import gemm
    from ..sampler import sampled as S

    cfg = SamplerConfig(ratio=0.1, seed=0)
    trace, rows = S._program_rows(gemm(n), MachineConfig())
    out = {}
    for (k, _), members in S._bucket_rows(trace, rows).items():
        nt, ri0 = trace.nests[k], members[0][1]
        highs, _ = S._sample_highs(nt, ri0, cfg)
        label = ",".join(nt.tables.ref_names[ri] for _, ri in members)
        out[label] = (nt, ri0, S._pad_highs(highs), [ri for _, ri in members])
    return out


def _time(fn, reps: int) -> tuple[float, float]:
    """(device ms per call between CUDA events, host us per call) of reps
    calls of fn after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host / reps * 1e6


def b2_main() -> int:
    import torch

    from ..ops import _build
    from ..ops import pow2_hist as p2

    fn = ctypes.CDLL(_build.build("pow2_hist", True)[0]).pow2_hist_launch
    fn.argtypes = p2._ARGTYPES
    fn.restype = ctypes.c_int
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    rows = []
    for n in B2_SIZES:
        v = torch.from_numpy(rng.integers(1 << 12, 1 << 14, size=n)).to(dev)
        w = torch.from_numpy(rng.random(n) < 0.5).to(dev)
        want = p2.pow2_hist(v, w)
        # two outputs that the raw launches take in turns, each launch
        # zeroing the other for the next
        bufs = [torch.zeros(64, dtype=torch.int64, device=dev),
                torch.empty(64, dtype=torch.int64, device=dev)]
        stream = torch.cuda.current_stream(dev).cuda_stream
        calls = [(v.data_ptr(), w.data_ptr(), 1, n, a.data_ptr(),
                  b.data_ptr(), dev.index, stream)
                 for a, b in (bufs, bufs[::-1])]
        if fn(*calls[0]) != 0:
            raise RuntimeError("raw pow2_hist launch failed")
        torch.cuda.synchronize()
        if not torch.equal(bufs[0], want):
            raise AssertionError(f"raw pow2_hist launch differs at {n}")
        turn = [1]

        def raw():
            fn(*calls[turn[0]])
            turn[0] ^= 1

        def wrapper(v=v, w=w):
            p2.pow2_hist(v, w)

        turns = {"raw": [], "wrapper": []}
        for name in ("raw", "wrapper", "wrapper", "raw"):
            turns[name].append(_time(raw if name == "raw" else wrapper,
                                     LAUNCHES))
        row = {"n": n}
        for name, t in turns.items():
            row[f"{name}_ms"] = sum(x[0] for x in t) / len(t)
            row[f"{name}_host_us"] = sum(x[1] for x in t) / len(t)
        rows.append(row)
        print(f"b1_launch: B2 {n} elements: raw launch {row['raw_ms']:.4f} "
              f"ms ({row['raw_host_us']:.1f} us host); wrapper "
              f"{row['wrapper_ms']:.4f} ms ({row['wrapper_host_us']:.1f} us "
              "host)")
    print(json.dumps({"b2_launch": rows}))
    return 0


def main(argv=None) -> int:
    import torch

    from ..ops import _build
    from ..ops import sampled_hist as sh

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--b2", action="store_true",
                    help="time kernel B2 (pow2_hist) instead of B1")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("b1_launch: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {_card_line()}")
    if opts.b2:
        return b2_main()
    variants = {"16KB": ("sampled_hist", ()),
                "3KB": ("sampled_hist", (f"MAX_DESC={SHORT_MAX_DESC}",)),
                "buffer": ("sampled_hist_buf", ())}
    with ThreadPoolExecutor(len(variants)) as ex:
        paths = dict(zip(variants, ex.map(
            lambda v: _build.build(v[0], True, v[1])[0],
            variants.values())))
    fns = {}
    for name in ("16KB", "3KB"):
        fn = ctypes.CDLL(paths[name]).sampled_hist_launch
        fn.argtypes = sh._ARGTYPES
        fn.restype = ctypes.c_int
        fns[name] = fn
    buf_fn = ctypes.CDLL(paths["buffer"]).sampled_hist_launch_buf
    buf_fn.argtypes = sh._ARGTYPES_BUF
    buf_fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    buckets = _gemm_buckets(2048)
    rng = np.random.default_rng(0)
    rows = []
    for label, R, B in SIZES:
        nt, ri0, highs, refs = buckets[label]
        desc = sh.build_descriptor(nt, ri0)
        desc_dev = torch.as_tensor(desc, device=dev)
        hrec = sh.radix_records(highs)
        space = int(np.prod(highs))
        keys = torch.from_numpy(
            rng.integers(0, space, size=(R, B), dtype=np.int64)).to(dev)
        rx = torch.tensor(refs[:R], dtype=torch.int64, device=dev)
        want = sh.sampled_hist_cuda(nt, ri0, keys, None, highs, rx, desc)
        stream = torch.cuda.current_stream(dev).cuda_stream
        raw = {}
        for name, fn in (*fns.items(), ("buffer", buf_fn)):
            out = (torch.empty_like(keys),
                   torch.zeros((R, sh.N_BINS), dtype=torch.int64,
                               device=dev),
                   torch.zeros(R, dtype=torch.int64, device=dev))
            extra = (desc_dev.data_ptr(),) if name == "buffer" else ()
            args = (keys.data_ptr(), None, R, B, B, desc.ctypes.data,
                    desc.shape[0], *extra, hrec.ctypes.data, rx.data_ptr(),
                    None, 0, *(t.data_ptr() for t in out), stream)
            if fn(*args) != 0:
                raise RuntimeError(f"{name} launch failed")
            torch.cuda.synchronize()
            for a, b in zip(out, want):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} build differs at {label}")

            def launch(fn=fn, args=args):
                fn(*args)

            raw[name] = launch
        turns = {name: [] for name in raw}
        for name in ("16KB", "3KB", "buffer", "buffer", "3KB", "16KB"):
            turns[name].append(_time(raw[name], LAUNCHES))

        def wrapper(form=None):
            sh.sampled_hist_cuda(nt, ri0, keys, None, highs, rx, desc,
                                 desc_dev=desc_dev, form=form)

        w_ms, w_us = _time(wrapper, LAUNCHES)
        wb_ms, wb_us = _time(lambda: wrapper("buffer"), LAUNCHES)
        row = {"bucket": label, "R": R, "B": B, "wrapper_ms": w_ms,
               "wrapper_host_us": w_us, "wrapper_buffer_ms": wb_ms,
               "wrapper_buffer_host_us": wb_us}
        for name, t in turns.items():
            row[f"raw_{name}_ms"] = sum(x[0] for x in t) / len(t)
            row[f"raw_{name}_host_us"] = sum(x[1] for x in t) / len(t)
        rows.append(row)
        print(f"b1_launch: {label} {R}x{B}: raw launch, 16 KB block "
              f"{row['raw_16KB_ms']:.4f} ms ({row['raw_16KB_host_us']:.1f} "
              f"us host), 3 KB block {row['raw_3KB_ms']:.4f} ms "
              f"({row['raw_3KB_host_us']:.1f} us host), buffer form "
              f"{row['raw_buffer_ms']:.4f} ms "
              f"({row['raw_buffer_host_us']:.1f} us host); wrapper "
              f"{w_ms:.4f} ms ({w_us:.1f} us host), buffer form "
              f"{wb_ms:.4f} ms ({wb_us:.1f} us host)")
    print(json.dumps({"b1_launch": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
