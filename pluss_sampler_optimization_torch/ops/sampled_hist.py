"""Fused decode + classify + pow2 histogram of the sampled engine.

The counterpart of the JAX package's Pallas kernel
(ops/pallas_sampled.py::_one_ref). For one kernel-signature bucket —
R member refs of one nest, each with its own value index rx and its own
buffer of B mixed-radix sample keys — it returns

    residual[R, B]  packed key ri*16+slot of every share sample and
                    every noshare sample with ri < 1, 2^62 elsewhere;
    hist[R, 64]     pow2 histogram of noshare samples with ri >= 1
                    (bin floor(log2 ri); bin 63 is always empty);
    cold[R]         masked-in samples whose line is never touched again.

`mask_RB` (bool [R, B]) switches lanes off; None means every lane is
live, which is what the engine's dispatches pass (they are never
padded), so the kernel then reads no mask at all.

`sampled_hist` picks the implementation: the hand-written CUDA kernel
(csrc/sampled_hist.cu) for CUDA tensors, the plain torch version for
tensors on the CPU or under an explicit backend="torch". There is no
fallback: a CUDA tensor under "auto"/"cuda" launches the kernel or
raises, and "cuda" on CPU tensors raises.

The kernel takes the classify's structure as a packed int64 descriptor
(`build_descriptor`), so one build serves every rectangular signature.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ir import MAX_DEPTH
from .histogram import SENTINEL

N_BINS = 64
# Kernel launches of sampled_hist_cuda; read by callers that must show
# a run went through the kernel.
LAUNCHES = 0

# Descriptor layout; csrc/sampled_hist.cu #defines the same offsets.
D_LV, D_DEPTH, D_NREFS, D_THREADS, D_CHUNK = 0, 1, 2, 3, 4
D_S_START, D_S_STEP, D_DS, D_CLS, D_W = 5, 6, 7, 8, 9
D_NPRE0, D_NPRE1, D_NGROUPS = 10, 11, 12
D_ACC, D_TRIPS, D_STARTB, D_SC, D_LSTART, D_LSTEP = 13, 16, 19, 22, 25, 28
D_OFF_LC, D_OFF_REFS, D_OFF_GROUPS, D_HEADER = 31, 32, 33, 34
R_SIZE = 8  # off, coeff[3], const, thr, ratio, level
G_FIXED = 7 + MAX_DEPTH * 5  # nmem, level, nheads, term, tlevel, tw, const, heads
TERM_CHECK, TERM_INTERVAL, TERM_WINDOW = 0, 1, 2
MAX_DESC = 2048
MAX_MEMBERS = 8


def build_descriptor(nt, ref_idx: int) -> np.ndarray:
    """The classify of source ref `ref_idx` as the kernel's int64
    descriptor: schedule and machine fields, loop tables, the per-ref
    value tables (indexed by rx and by sink), and every sink group's
    band plan (sampler/nextuse.py::band_plan) with its per-head
    coefficient and residual span precomputed from the value overlay."""
    from ..sampler.nextuse import _ref_vars_static, band_plan
    from ..sampler.sampled import _sink_groups, check_packed_ratios

    if nt.tri:
        raise NotImplementedError(
            "the CUDA classify covers rectangular nests; triangular nests "
            "land with ROADMAP A1"
        )
    check_packed_ratios(nt)
    t, mach, sched, v = nt.tables, nt.machine, nt.schedule, nt.vals
    depth = nt.nest.depth
    W = mach.lines_per_element_block
    d = [0] * D_HEADER
    d[D_LV] = int(t.ref_levels[ref_idx])
    d[D_DEPTH] = depth
    d[D_NREFS] = t.n_refs
    d[D_THREADS], d[D_CHUNK] = sched.threads, sched.chunk
    d[D_S_START], d[D_S_STEP] = sched.start, sched.step
    d[D_DS], d[D_CLS], d[D_W] = mach.ds, mach.cls, W
    d[D_NPRE0] = nt.npre[0]
    d[D_NPRE1] = nt.npre[1] if depth > 1 else 0
    for l in range(MAX_DEPTH):
        d[D_ACC + l] = int(v["acc"][l])
        d[D_TRIPS + l] = int(v["trips"][l])
        d[D_STARTB + l] = int(v["startb"][l])
        d[D_SC + l] = int(t.start_coeffs[l])
        d[D_LSTART + l] = nt.nest.loops[l].start if l < depth else 0
        d[D_LSTEP + l] = nt.nest.loops[l].step if l < depth else 1
    d[D_OFF_LC] = len(d)
    d += [int(x) for x in v["lc"]]
    d[D_OFF_REFS] = len(d)
    for j in range(t.n_refs):
        d += [int(v["off"][j]), *(int(c) for c in v["coeff"][j]),
              int(v["const"][j]), int(v["thr"][j]),
              int(t.ref_share_ratios[j]), int(t.ref_levels[j])]
    d[D_OFF_GROUPS] = len(d)
    groups = _sink_groups(nt, ref_idx)
    d[D_NGROUPS] = len(groups)
    for sinks in groups:
        if len(sinks) > MAX_MEMBERS:
            raise NotImplementedError(
                f"sink group of {len(sinks)} refs exceeds the kernel's "
                f"{MAX_MEMBERS}"
            )
        s0 = sinks[0]
        nz = _ref_vars_static(nt, s0)
        coeff = [int(c) for c in v["coeff"][s0]]
        node = band_plan(nt, s0, W)
        heads = []
        while node[0] == "head":
            _, l, n_u, child = node
            rest = nz[len(heads) + 1:]
            heads.append([
                l, n_u, coeff[l],
                sum(coeff[lr] * int(v["vlo"][lr]) for lr, _ in rest),
                sum(coeff[lr] * int(v["vhi"][lr]) for lr, _ in rest),
            ])
            node = child
        if node[0] == "check":
            term, tlevel, tw = TERM_CHECK, 0, 0
        elif node[0] == "interval":
            term, tlevel, tw = TERM_INTERVAL, node[1], 0
        else:
            term, tlevel, tw = TERM_WINDOW, node[1], node[2]
        rec = [len(sinks), int(t.ref_levels[s0]), len(heads), term, tlevel,
               tw, int(v["const"][s0])]
        for k in range(MAX_DEPTH):
            rec += heads[k] if k < len(heads) else [0, 0, 1, 0, 0]
        d += rec + list(sinks)
    if len(d) > MAX_DESC:
        raise NotImplementedError(
            f"descriptor of {len(d)} words exceeds the kernel's {MAX_DESC}"
        )
    return np.asarray(d, dtype=np.int64)


# int64 operations the kernel spends per call site, counted from
# csrc/sampled_hist.cu; a floored division or modulo is one hardware
# divide plus its sign fix-up
_FDIV, _FMOD = 6, 5
_SCHED = 2 * _FDIV + 2 * _FMOD + 4  # owner_tid + local_index


def ops_per_sample(desc: np.ndarray) -> int:
    """int64 operations the kernel's code path spends on one masked-in
    sample of this descriptor: decode, geometry, every band candidate's
    level box and every member sink's position reduction, and the share
    test. A count of operations, not of instructions: each int64 add,
    multiply, compare or select counts once."""
    d = desc
    lv = int(d[D_LV])
    ops = 3 * _FMOD + 2 * _FDIV  # decode
    ops += _SCHED + 2 + 4 * (lv + 1) + 5 * (lv + 1) + 1 + _FDIV  # geometry
    mpa = {0: _FDIV + 2 + 2 * 4 + 2 * 5 + 3,
           1: 2 * _FDIV + 8 + 5 * 4 + 3 * 7 + 5,
           2: 2 * _FDIV + 9 + 7 * 4 + 3 * 9 + 6}
    g = int(d[D_OFF_GROUPS])
    for _ in range(int(d[D_NGROUPS])):
        nm, level, nh, term = (int(x) for x in d[g:g + 4])
        tw = int(d[g + 5])
        n_emit = 1
        walk = 2
        for k in range(nh):
            walk += n_emit * (_FDIV + _FDIV + 6)  # head bounds
            n_emit *= int(d[g + 7 + 5 * k + 1])
            walk += n_emit * 4
        if term == TERM_WINDOW:
            n_emit *= tw
        box = 0
        for l in range(level + 1):
            box += 2 * _FDIV + 6 + (_SCHED if l == 0 else 0)
        ops += walk + n_emit * (box + nm * (mpa[level] + 1)) + 2 * nm
        g += G_FIXED + nm
    return ops + 12  # share test and packing


def torch_vals(vals: dict, device) -> dict:
    """The value overlay of a NestTrace as int64 tensors on `device`."""
    return {
        k: torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)
        for k, x in vals.items()
    }


def exp2_floor(x):
    """floor(log2 x) of int64 x >= 1, exact (a 6-step binary search on
    shifts; a float log2 is inexact above 2^53)."""
    e = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        y = x >> s
        big = y > 0
        e += big.to(torch.int64) * s
        x = torch.where(big, y, x)
    return e


def sampled_hist_plain(nt, ref_idx: int, keys_RB, mask_RB, highs, rx_R):
    """Plain torch version: the tensor classify
    (sampler/sampled.py::classify_samples), then the same
    residual/histogram/cold split as the kernel."""
    from ..sampler.sampled import classify_samples, decode_sample_keys

    dev = keys_RB.device
    tnt = nt.with_vals(torch_vals(nt.vals, dev))
    R = keys_RB.shape[0]
    residual = torch.empty_like(keys_RB)
    hist = torch.zeros((R, N_BINS), dtype=torch.int64, device=dev)
    cold = torch.zeros(R, dtype=torch.int64, device=dev)
    for r in range(R):
        samples = decode_sample_keys(keys_RB[r], highs)
        packed, ri, is_share, found = classify_samples(
            tnt, ref_idx, samples, rx_R[r]
        )
        live, dead = found, ~found
        if mask_RB is not None:
            live, dead = live & mask_RB[r], dead & mask_RB[r]
        nosh = live & ~is_share & (ri >= 1)
        residual[r] = torch.where(live & ~nosh, packed, SENTINEL)
        hist[r] = torch.bincount(exp2_floor(ri[nosh]), minlength=N_BINS)
        cold[r] = dead.sum()
    return residual, hist, cold


_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_longlong] * 3
    + [ctypes.c_void_p] * 5
)


def _check(name, x, dtype, shape, dev):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)}, got {x.dtype} "
            f"{tuple(x.shape)}"
        )
    if x.device != dev or not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous on {dev}")


def sampled_hist_cuda(nt, ref_idx: int, keys_RB, mask_RB, highs, rx_R,
                      desc=None):
    """Launch csrc/sampled_hist.cu on the current stream; raises on any
    argument the kernel does not take or a launch error. `desc` is
    build_descriptor's output as an int64 tensor on the keys' device
    (built here when None)."""
    global LAUNCHES
    from . import _build

    dev = keys_RB.device
    if dev.type != "cuda":
        raise ValueError(f"sampled_hist_cuda needs CUDA tensors, got {dev}")
    R, B = keys_RB.shape
    _check("keys", keys_RB, torch.int64, (R, B), dev)
    if mask_RB is not None:
        _check("mask", mask_RB, torch.bool, (R, B), dev)
    _check("rx", rx_R, torch.int64, (R,), dev)
    h = [int(x) for x in highs]
    if len(h) != MAX_DEPTH or min(h) < 1:
        raise ValueError(f"highs must be {MAX_DEPTH} positive ints: {h}")
    if desc is None:
        desc = descriptor_tensor(nt, ref_idx, dev)
    _check("desc", desc, torch.int64, (desc.shape[0],), dev)
    fn = _build.load("sampled_hist").sampled_hist_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        residual = torch.empty_like(keys_RB)
        hist = torch.zeros((R, N_BINS), dtype=torch.int64, device=dev)
        cold = torch.zeros(R, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        mask_ptr = None if mask_RB is None else mask_RB.data_ptr()
        rc = fn(keys_RB.data_ptr(), mask_ptr, R, B,
                desc.data_ptr(), desc.shape[0], *h, rx_R.data_ptr(),
                residual.data_ptr(), hist.data_ptr(), cold.data_ptr(),
                stream)
        if rc != 0:
            raise RuntimeError(f"sampled_hist_launch failed: CUDA error {rc}")
        LAUNCHES += 1
    return residual, hist, cold


def descriptor_tensor(nt, ref_idx: int, device) -> torch.Tensor:
    """build_descriptor as an int64 tensor on `device`."""
    return torch.from_numpy(build_descriptor(nt, ref_idx)).to(device)


def sampled_hist(nt, ref_idx: int, keys_RB, mask_RB, highs, rx_R,
                 backend: str = "auto", desc=None):
    """(residual[R,B], hist[R,64], cold[R]) for one bucket dispatch.

    backend "torch" takes the plain version; "auto" takes it for tensors
    on the CPU and launches the kernel for CUDA tensors; "cuda" always
    launches the kernel (and so raises on CPU tensors)."""
    if backend == "torch" or (
        backend == "auto" and keys_RB.device.type == "cpu"
    ):
        return sampled_hist_plain(nt, ref_idx, keys_RB, mask_RB, highs, rx_R)
    if backend not in ("auto", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    return sampled_hist_cuda(nt, ref_idx, keys_RB, mask_RB, highs, rx_R,
                             desc)
