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
  kernel's `widen=False` documents never happens. A call is one device
  operation: its blocks add into an output that the previous launch on
  the same stream zeroed, and it zeroes the next call's (see the
  source's header); only a stream's first call zeroes its output
  itself.
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
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p]
_LAUNCH = None  # pow2_hist_launch, its argtypes set, at first use
# (device index, raw stream) -> the next call's output, which the last
# launch on that stream zeroed
_NEXT: dict = {}


def _flat(values, weights):
    """Both inputs as flat contiguous tensors: values int64, weights
    bool or int64. Raises on anything else. Inputs that already are
    (the engine's) pass through a few attribute reads."""
    if values.dim() != 1:
        values = values.reshape(-1)
    if weights.dim() != 1:
        weights = weights.reshape(-1)
    if values.shape != weights.shape:
        raise ValueError(
            f"values {tuple(values.shape)} and weights "
            f"{tuple(weights.shape)} differ in size"
        )
    if values.device != weights.device:
        raise ValueError(
            f"values on {values.device}, weights on {weights.device}"
        )
    if values.dtype is not torch.int64:
        if values.dtype.is_floating_point or values.dtype == torch.bool:
            raise ValueError(f"values must be integers, got {values.dtype}")
        values = values.to(torch.int64)
    if weights.dtype is not torch.bool and weights.dtype is not torch.int64:
        if weights.dtype.is_floating_point or weights.dtype.is_complex:
            raise ValueError(f"weights must be bool or integers, got "
                             f"{weights.dtype}")
        weights = weights.to(torch.int64)
    if not values.is_contiguous():
        values = values.contiguous()
    if not weights.is_contiguous():
        weights = weights.contiguous()
    return values, weights


def pow2_hist_plain(values, weights):
    """Plain torch version of the kernel: (64,) int64 ladder histogram."""
    values, weights = _flat(values, weights)
    keep = values != 0
    return torch.zeros(N_EXP_BINS, dtype=torch.int64,
                       device=values.device).index_add_(
        0, exp_bin(values[keep]), weights[keep].to(torch.int64))


def _launcher():
    """csrc/pow2_hist.cu's pow2_hist_launch, built and typed once."""
    global _LAUNCH
    if _LAUNCH is None:
        from . import _build

        fn = _build.load("pow2_hist").pow2_hist_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def pow2_hist(values, weights):
    """(64,) int64 ladder histogram of `values` weighted by `weights`
    (bool, or integers summed as int64): csrc/pow2_hist.cu on CUDA
    tensors, one launch on the current stream of their device and no
    other device operation (after a stream's first call, which zeroes
    its output); the plain version on CPU tensors. An empty input
    returns zeros without a launch. Raises on arguments the kernel does
    not take and on a launch error."""
    global LAUNCHES
    values, weights = _flat(values, weights)
    dev = values.device
    if dev.type == "cpu":
        return pow2_hist_plain(values, weights)
    if dev.type != "cuda":
        raise ValueError(f"pow2_hist runs on CUDA or CPU tensors, got {dev}")
    n = values.numel()
    if n == 0:
        return torch.zeros(N_EXP_BINS, dtype=torch.int64, device=dev)
    fn = _launcher()
    # the current stream's handle, without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    key = (dev.index, stream)
    out = _NEXT.pop(key, None)
    if out is None:  # the stream's first call
        out = torch.zeros(N_EXP_BINS, dtype=torch.int64, device=dev)
    nxt = torch.empty(N_EXP_BINS, dtype=torch.int64, device=dev)
    rc = fn(values.data_ptr(), weights.data_ptr(),
            weights.dtype is torch.bool, n, out.data_ptr(), nxt.data_ptr(),
            dev.index, stream)
    if rc != 0:  # a refused launch zeroed nothing: the next call starts anew
        raise RuntimeError(f"pow2_hist_launch failed: CUDA error {rc}")
    _NEXT[key] = nxt
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
