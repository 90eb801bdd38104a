"""The device draw's threefry streams: kernel B3, its plain version and the dispatch.

The JAX package draws device sample sets with jax.random (XLA code, no
Pallas original): `randint` candidate keys over [0, span) and uint64
`bits` priorities (sampler/draw.py). Each entry here covers R rows, one
key per row, B elements per row:

- `threefry_randint(keys, B, span, device)`: row r is
  jr.randint(keys[r], (B,), 0, span, int64), as int64 [R, B];
- `threefry_bits(keys, B, device, valid)`: row r is
  jr.bits(keys[r], (B,), uint64), UINT64_MAX where `valid` (bool or
  uint8 [R, B]) is False, as the order-preserving int64 image x ^ 2^63
  (a signed sort of the images is the unsigned sort of the bits).

A key is a pair of uint32 words as Python ints (sampler/threefry.py
derives them on the host). Each entry launches the hand-written CUDA
kernel csrc/threefry_draw.cu on a CUDA device, one launch per
`MAX_ROWS` rows, and takes its plain torch version
(`threefry_randint_plain`, `threefry_bits_plain`: sampler/threefry.py's
`randint` and `bits64` row by row) on the CPU or under backend "torch".
There is no fallback: "auto"/"cuda" on a CUDA device launches the
kernel or raises, and "cuda" on the CPU raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..sampler import threefry

# Kernel launches of the two entries; read by callers that must show a
# run went through the kernel.
LAUNCHES = 0
MAX_ROWS = 128  # csrc/threefry_draw.cu's rows per launch

_RANDINT_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                     ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_void_p]
_BITS_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_FNS: dict = {}  # entry name -> the typed ctypes function, at first use


def _check_args(keys, B: int, span: int | None = None) -> list:
    """The keys as a list of word pairs; raises ValueError unless each is
    two uint32 words, B >= 1 and the span (where given) in [1, 2^46]."""
    keys = [tuple(k) for k in keys]
    if not keys:
        raise ValueError("threefry: needs at least one key")
    for k in keys:
        if len(k) != 2 or not all(
                isinstance(w, (int, np.integer)) and 0 <= w <= threefry.M32
                for w in k):
            raise ValueError(f"threefry: a key is two uint32 words, got {k}")
    if int(B) < 1:
        raise ValueError(f"threefry: B must be >= 1, got {B}")
    if span is not None and not 1 <= span <= threefry.MAX_SPAN:
        raise ValueError(f"threefry: span must be in [1, 2^46], got {span}")
    return keys


def _device(device) -> torch.device:
    """torch.device(device), with a CUDA device's index made explicit."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _check_valid(valid, R: int, B: int, device):
    """valid as a contiguous bool [R, B] tensor on device, or None."""
    if valid is None:
        return None
    device = _device(device)
    if valid.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"valid: expected bool or uint8, got {valid.dtype}")
    if tuple(valid.shape) != (R, B):
        raise ValueError(f"valid: expected shape {(R, B)}, got "
                         f"{tuple(valid.shape)}")
    if valid.device != device:
        raise ValueError(f"valid: must be on {device}, got {valid.device}")
    if not valid.is_contiguous():
        raise ValueError("valid: must be contiguous")
    return valid.to(torch.bool)


def threefry_randint_plain(keys, B: int, span: int, device="cpu"):
    """Plain torch version: int64 [R, B] randint rows."""
    keys = _check_args(keys, B, span)
    return torch.stack([threefry.randint(k, B, span, device) for k in keys])


def threefry_bits_plain(keys, B: int, device="cpu", valid=None):
    """Plain torch version: int64 [R, B] images of the bits rows."""
    keys = _check_args(keys, B)
    device = torch.device(device)
    valid = _check_valid(valid, len(keys), B, device)
    rows = []
    for r, k in enumerate(keys):
        x = threefry.bits64(k, B, device)
        if valid is not None:
            x = torch.where(valid[r], x, -1)  # -1: UINT64_MAX's pattern
        rows.append(x ^ threefry.SIGN)
    return torch.stack(rows)


def _fn(name: str, argtypes):
    fn = _FNS.get(name)
    if fn is None:
        from . import _build

        fn = getattr(_build.load("threefry_draw"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _launch_rows(name, argtypes, words, out, per_launch):
    """Launch `name` over out's rows, MAX_ROWS at a time, on the current
    stream of out's device; per_launch(words block, out block, stream)
    gives the arguments. Raises on a launch error."""
    global LAUNCHES
    fn = _fn(name, argtypes)
    dev = out.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for r0 in range(0, out.shape[0], MAX_ROWS):
            w = np.ascontiguousarray(words[r0:r0 + MAX_ROWS])
            rc = fn(*per_launch(w, r0, stream))
            if rc != 0:
                raise RuntimeError(f"{name} failed: CUDA error {rc}")
            LAUNCHES += 1
    return out


def threefry_randint_cuda(keys, B: int, span: int, device):
    """csrc/threefry_draw.cu's randint entry: int64 [R, B] on `device`."""
    keys = _check_args(keys, B, span)
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"threefry_randint_cuda needs a CUDA device, got "
                         f"{device}")
    words = np.array([[*a, *b] for a, b in map(threefry.split, keys)],
                     dtype=np.uint32)
    out = torch.empty((len(keys), B), dtype=torch.int64, device=device)
    return _launch_rows(
        "threefry_randint_launch", _RANDINT_ARGTYPES, words, out,
        lambda w, r0, st: (w.ctypes.data, len(w), B, span,
                           out[r0].data_ptr(), st))


def threefry_bits_cuda(keys, B: int, device, valid=None):
    """csrc/threefry_draw.cu's bits entry: int64 [R, B] images on
    `device`, UINT64_MAX's image where valid is False."""
    keys = _check_args(keys, B)
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"threefry_bits_cuda needs a CUDA device, got "
                         f"{device}")
    valid = _check_valid(valid, len(keys), B, device)
    words = np.array(keys, dtype=np.uint32)
    out = torch.empty((len(keys), B), dtype=torch.int64, device=device)
    return _launch_rows(
        "threefry_bits_launch", _BITS_ARGTYPES, words, out,
        lambda w, r0, st: (w.ctypes.data, len(w), B,
                           None if valid is None else valid[r0].data_ptr(),
                           out[r0].data_ptr(), st))


def _use_plain(device, backend: str) -> bool:
    if backend == "torch":
        return True
    if backend not in ("auto", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend == "auto" and torch.device(device).type == "cpu"


def threefry_randint(keys, B: int, span: int, device, backend="auto"):
    """randint rows on `device`: the kernel on CUDA under "auto"/"cuda",
    the plain version on the CPU or under "torch"."""
    if _use_plain(device, backend):
        return threefry_randint_plain(keys, B, span, device)
    return threefry_randint_cuda(keys, B, span, device)


def threefry_bits(keys, B: int, device, valid=None, backend="auto"):
    """bits rows (images, masked by valid) on `device`: the kernel on CUDA
    under "auto"/"cuda", the plain version on the CPU or under "torch"."""
    if _use_plain(device, backend):
        return threefry_bits_plain(keys, B, device, valid)
    return threefry_bits_cuda(keys, B, device, valid)
