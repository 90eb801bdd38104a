"""Weighted pow2 histogram: kernel B2, its plain version and the dispatch.

The counterpart of the JAX package's ops/pallas_hist.py. `pow2_hist`
returns the (64,) int64 histogram of floor(log2 x) weighted by
`weights` as the Pallas comparison ladder defines it: entry x adds its
weight to bin 63 - clz(x) (x read as unsigned 64-bit, so x < 0 lands
in bin 63) and x == 0 is dropped. On x >= 1 — the sharded engine's
domain, which passes max(ri, 1) — that is `exp_hist`'s answer.

- `pow2_hist` launches the hand-written CUDA kernel csrc/pow2_hist.cu
  for CUDA tensors and takes `pow2_hist_plain` for tensors on the CPU.
  It accumulates in int64, so it has no `widen` argument: every weight
  total that fits int64 is exact, and the int32 wrap that the TPU
  kernel's `widen=False` documents never happens.
- `pow2_hist_plain` is the same function in torch (exact integer
  binning and an int64 index_add_); the tests and the card's comparison
  use it, the engine never does.
- `pow2_hist_auto` is the engine's dispatch, as in the JAX package:
  the kernel for CUDA tensors under backend "auto"/"cuda", `exp_hist`
  on the CPU or under "torch". "cuda" on CPU tensors raises; there is
  no fallback from the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .histogram import N_EXP_BINS, exp_bin, exp_hist

# Kernel launches of pow2_hist; read by callers that must show a run
# went through the kernel.
LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]


def _flat(values, weights):
    """Both inputs as flat contiguous tensors: values int64, weights
    bool or int64. Raises on anything else."""
    values, weights = values.reshape(-1), weights.reshape(-1)
    if values.shape != weights.shape:
        raise ValueError(
            f"values {tuple(values.shape)} and weights "
            f"{tuple(weights.shape)} differ in size"
        )
    if values.device != weights.device:
        raise ValueError(
            f"values on {values.device}, weights on {weights.device}"
        )
    if values.dtype.is_floating_point or values.dtype == torch.bool:
        raise ValueError(f"values must be integers, got {values.dtype}")
    if weights.dtype.is_floating_point or weights.dtype.is_complex:
        raise ValueError(f"weights must be bool or integers, got "
                         f"{weights.dtype}")
    if weights.dtype != torch.bool:
        weights = weights.to(torch.int64)
    return values.to(torch.int64).contiguous(), weights.contiguous()


def pow2_hist_plain(values, weights):
    """Plain torch version of the kernel: (64,) int64 ladder histogram."""
    values, weights = _flat(values, weights)
    keep = values != 0
    return torch.zeros(N_EXP_BINS, dtype=torch.int64,
                       device=values.device).index_add_(
        0, exp_bin(values[keep]), weights[keep].to(torch.int64))


def pow2_hist(values, weights):
    """(64,) int64 ladder histogram of `values` weighted by `weights`
    (bool, or integers summed as int64): csrc/pow2_hist.cu on CUDA
    tensors, launched on the current stream of their device; the plain
    version on CPU tensors. An empty input returns zeros without a
    launch. Raises on arguments the kernel does not take and on a
    launch error."""
    global LAUNCHES
    values, weights = _flat(values, weights)
    dev = values.device
    if dev.type == "cpu":
        return pow2_hist_plain(values, weights)
    if dev.type != "cuda":
        raise ValueError(f"pow2_hist runs on CUDA or CPU tensors, got {dev}")
    from . import _build

    fn = _build.load("pow2_hist").pow2_hist_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        out = torch.zeros(N_EXP_BINS, dtype=torch.int64, device=dev)
        n = values.numel()
        if n == 0:
            return out
        rc = fn(values.data_ptr(), weights.data_ptr(),
                int(weights.dtype == torch.bool), n, out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"pow2_hist_launch failed: CUDA error {rc}")
        LAUNCHES += 1
    return out


def pow2_hist_auto(values, weights, backend: str = "auto"):
    """The sharded engine's histogram: the kernel for CUDA tensors under
    "auto"/"cuda", exp_hist for CPU tensors or under "torch"."""
    if backend == "torch" or (
        backend == "auto" and values.device.type == "cpu"
    ):
        return exp_hist(values, weights)
    if backend not in ("auto", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    if values.device.type != "cuda":
        raise ValueError(
            f"the pow2_hist kernel needs CUDA tensors, got {values.device}"
        )
    return pow2_hist(values, weights)
