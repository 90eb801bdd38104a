"""The device draw's threefry streams: kernel B3, its plain version and the dispatch.

The JAX package draws device sample sets with jax.random (XLA code, no
Pallas original): `randint` candidate keys over [0, span) and uint64
`bits` priorities (sampler/draw.py). Each entry here covers R rows, one
key per row, B elements per row:

- `threefry_randint(keys, B, span, device)`: row r is
  jr.randint(keys[r], (B,), 0, span, int64), as int64 [R, B]; `span` is
  one int for every row or a sequence of one per row (the cross-request
  draw's rows come from different programs);
- `threefry_bits(keys, B, device, valid)`: row r is
  jr.bits(keys[r], (B,), uint64), UINT64_MAX where `valid` (bool or
  uint8 [R, B]) is False, as the order-preserving int64 image x ^ 2^63
  (a signed sort of the images is the unsigned sort of the bits).

A key is a pair of uint32 words as Python ints (sampler/threefry.py
derives them on the host). Each entry launches the hand-written CUDA
kernel csrc/threefry_draw.cu on a CUDA device, one launch per
`MAX_ROWS` rows and `SEGMENT` columns, with the span's remainder record
(`remainder_record`, computed here in exact integers; with a span per
row, the rows' records travel in the launch beside their keys and the
rows of each remainder kind take one launch, `launch_randint_rows`),
and takes its
plain torch version (`threefry_randint_plain`, `threefry_bits_plain`:
sampler/threefry.py's `randint` and `bits64` row by row) on the CPU or
under backend "torch". There is no fallback: "auto"/"cuda" on a CUDA
device launches the kernel or raises, and "cuda" on the CPU raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..sampler import threefry

# Kernel launches of the two entries; read by callers that must show a
# run went through the kernel. ROWS_LAUNCHES counts the launches of
# randint with a span per row (a part of LAUNCHES).
LAUNCHES = 0
ROWS_LAUNCHES = 0
MAX_ROWS = 128  # csrc/threefry_draw.cu's rows per launch
# csrc/threefry_draw.cu's counters per thread and threads per block: a
# launch covers each row in blocks of CPT * THREADS columns
CPT, THREADS = 4, 128
# Columns per launch: a launch's counters (col >> 32, col & 0xffffffff)
# then share their high word, and the kernel indexes in 32 bits.
SEGMENT = 1 << 31

# csrc/threefry_draw.cu's remainder kinds
REM_POW2, REM_BIG, REM_SMALL = 0, 1, 2

_C = ctypes
_RANDINT_ARGTYPES = [_C.c_void_p, _C.c_longlong, _C.c_longlong,
                     _C.c_longlong, _C.c_uint, _C.c_uint, _C.c_ulonglong,
                     _C.c_ulonglong, _C.c_ulonglong, _C.c_int, _C.c_void_p,
                     _C.c_void_p]
_ROWS_ARGTYPES = [_C.c_void_p, _C.c_longlong, _C.c_longlong, _C.c_longlong,
                  _C.c_uint, _C.c_uint, _C.c_void_p, _C.c_void_p,
                  _C.c_void_p, _C.c_int, _C.c_void_p, _C.c_longlong,
                  _C.c_void_p, _C.c_void_p]
_BITS_ARGTYPES = [_C.c_void_p, _C.c_longlong, _C.c_longlong, _C.c_longlong,
                  _C.c_uint, _C.c_uint, _C.c_void_p, _C.c_void_p,
                  _C.c_void_p]
_FNS: dict = {}  # entry name -> the typed ctypes function, at first use


class Record(NamedTuple):
    """How the kernel takes n % span for a uint64 n (csrc/threefry_draw.cu
    ::urem proves it for every n and every span in [1, 2^63])."""

    kind: int  # REM_POW2: n & (span - 1); REM_BIG, REM_SMALL: by recip
    recip: int  # floor((2^64 - 1) / span); 0 for REM_POW2
    mult: int  # jax's randint multiplier (2^32 % span)^2 % span in uint64


def remainder_record(span: int) -> Record:
    """The launch's record for 1 <= span <= 2^46. REM_BIG (span > 2^32,
    not a power of two) has recip < 2^32; REM_SMALL (span < 2^32, not a
    power of two) is the one kind whose randint multiplier is not 0."""
    if not 1 <= span <= threefry.MAX_SPAN:
        raise ValueError(f"threefry: span must be in [1, 2^46], got {span}")
    mult = threefry.randint_multiplier(span)
    if span & (span - 1) == 0:
        rec = Record(REM_POW2, 0, mult)
    else:
        rec = Record(REM_BIG if span > 1 << 32 else REM_SMALL,
                     threefry.M64 // span, mult)
    if (rec.mult != 0) != (rec.kind == REM_SMALL):
        raise AssertionError(f"threefry: span {span}: multiplier {mult} "
                             f"does not fit kind {rec.kind}")
    return rec


def record_urem(n: int, span: int, rec: Record) -> int:
    """n % span for 0 <= n < 2^64 as the kernel takes it from `rec`: a
    mask, or q = (n * recip) >> 64, n - q * span in uint64 and at most
    one subtraction of span."""
    if rec.kind == REM_POW2:
        return n & (span - 1)
    r = (n - ((n * rec.recip) >> 64) * span) & threefry.M64
    return r - span if r >= span else r


def _check_args(keys, B: int, span=None) -> list:
    """The keys as a list of word pairs; raises ValueError unless each is
    two uint32 words, B >= 1 and the span (where given: one int, or one
    per key) in [1, 2^46]."""
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
    spans = [] if span is None else (
        [span] if isinstance(span, (int, np.integer)) else list(span))
    if span is not None and not isinstance(span, (int, np.integer)) and (
            len(spans) != len(keys)):
        raise ValueError(f"threefry: {len(spans)} spans for {len(keys)} "
                         "rows")
    for sp in spans:
        if not 1 <= sp <= threefry.MAX_SPAN:
            raise ValueError(f"threefry: span must be in [1, 2^46], got "
                             f"{sp}")
    return keys


def _row_spans(span, R: int) -> list[int]:
    """One span per row: `span` repeated, or its per-row sequence."""
    if isinstance(span, (int, np.integer)):
        return [int(span)] * R
    return [int(sp) for sp in span]


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


def threefry_randint_plain(keys, B: int, span, device="cpu"):
    """Plain torch version: int64 [R, B] randint rows (`span` one int,
    or one per row)."""
    keys = _check_args(keys, B, span)
    return torch.stack([threefry.randint(k, B, sp, device)
                        for k, sp in zip(keys, _row_spans(span, len(keys)))])


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


def randint_words(keys) -> np.ndarray:
    """uint32 [R, 4]: each key's two randint sub-keys (split on the
    host), the rows of the kernel's key bank."""
    return np.array([[*a, *b] for a, b in map(threefry.split, keys)],
                    dtype=np.uint32)


def launch_blocks(R: int, B: int):
    """(r0, rows, col0, cols) of each launch over [R, B]: MAX_ROWS rows
    and SEGMENT columns at a time."""
    for r0 in range(0, R, MAX_ROWS):
        for c in range(0, B, SEGMENT):
            yield r0, min(MAX_ROWS, R - r0), c, min(SEGMENT, B - c)


def launch_randint(fn, words, B: int, span: int, out, stream) -> int:
    """Launch `fn` (csrc/threefry_draw.cu's randint entry) over out's
    rows, the randint sub-key words `words`; returns the launches.
    Raises on a failed launch."""
    rec = remainder_record(span)
    n = 0
    for r0, rows, c, cols in launch_blocks(out.shape[0], B):
        w = np.ascontiguousarray(words[r0:r0 + rows])
        rc = fn(w.ctypes.data, rows, B, cols, c >> 32, c & threefry.M32,
                span, rec.recip, rec.mult, rec.kind,
                out.data_ptr() + 8 * (r0 * B + c), stream)
        if rc != 0:
            raise RuntimeError(f"threefry randint launch failed: CUDA "
                               f"error {rc}")
        n += 1
    return n


def launch_randint_rows(fn, words, B: int, spans, out, stream) -> int:
    """Launch `fn` (csrc/threefry_draw.cu's per-row randint entry, or its
    host twin with the same arguments) over out's rows, row r with its
    own span spans[r]: the rows of each remainder kind, MAX_ROWS at a
    time, in one launch per SEGMENT columns, each row writing its own
    output row. Returns the launches; raises on a failed launch."""
    recs = [remainder_record(sp) for sp in spans]
    R = out.shape[0]
    n = 0
    for kind in (REM_POW2, REM_BIG, REM_SMALL):
        rows = [r for r in range(R) if recs[r].kind == kind]
        for i in range(0, len(rows), MAX_ROWS):
            sel = rows[i:i + MAX_ROWS]
            w = np.ascontiguousarray(words[sel])
            d = np.array([spans[r] for r in sel], dtype=np.uint64)
            m = np.array([recs[r].recip for r in sel], dtype=np.uint64)
            mult = np.array([recs[r].mult for r in sel], dtype=np.uint64)
            orow = np.array(sel, dtype=np.uint32)
            for c in range(0, B, SEGMENT):
                cols = min(SEGMENT, B - c)
                rc = fn(w.ctypes.data, len(sel), B, cols, c >> 32,
                        c & threefry.M32, d.ctypes.data, m.ctypes.data,
                        mult.ctypes.data, kind, orow.ctypes.data, R,
                        out.data_ptr() + 8 * c, stream)
                if rc != 0:
                    raise RuntimeError(f"threefry randint (span per row) "
                                       f"launch failed: CUDA error {rc}")
                n += 1
    return n


def launch_bits(fn, words, B: int, valid, out, stream) -> int:
    """As launch_randint for the bits entry; valid a bool [R, B] tensor
    on out's device, or None."""
    n = 0
    for r0, rows, c, cols in launch_blocks(out.shape[0], B):
        w = np.ascontiguousarray(words[r0:r0 + rows])
        v = None if valid is None else valid.data_ptr() + r0 * B + c
        rc = fn(w.ctypes.data, rows, B, cols, c >> 32, c & threefry.M32, v,
                out.data_ptr() + 8 * (r0 * B + c), stream)
        if rc != 0:
            raise RuntimeError(f"threefry bits launch failed: CUDA error "
                               f"{rc}")
        n += 1
    return n


def _cuda_device(device, name: str) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA device, got {device}")
    return device


def threefry_randint_cuda(keys, B: int, span, device):
    """csrc/threefry_draw.cu's randint entry: int64 [R, B] on `device`.
    With one span per row (a sequence), the per-row entry: one launch
    per remainder kind present (launch_randint_rows)."""
    global LAUNCHES, ROWS_LAUNCHES
    keys = _check_args(keys, B, span)
    device = _cuda_device(device, "threefry_randint_cuda")
    out = torch.empty((len(keys), B), dtype=torch.int64, device=device)
    per_row = not isinstance(span, (int, np.integer))
    fn = (_fn("threefry_randint_rows_launch", _ROWS_ARGTYPES) if per_row
          else _fn("threefry_randint_launch", _RANDINT_ARGTYPES))
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        if per_row:
            n = launch_randint_rows(fn, randint_words(keys), B,
                                    _row_spans(span, len(keys)), out, stream)
            ROWS_LAUNCHES += n
        else:
            n = launch_randint(fn, randint_words(keys), B, span, out, stream)
        LAUNCHES += n
    return out


def threefry_bits_cuda(keys, B: int, device, valid=None):
    """csrc/threefry_draw.cu's bits entry: int64 [R, B] images on
    `device`, UINT64_MAX's image where valid is False."""
    global LAUNCHES
    keys = _check_args(keys, B)
    device = _cuda_device(device, "threefry_bits_cuda")
    valid = _check_valid(valid, len(keys), B, device)
    out = torch.empty((len(keys), B), dtype=torch.int64, device=device)
    fn = _fn("threefry_bits_launch", _BITS_ARGTYPES)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        LAUNCHES += launch_bits(fn, np.array(keys, dtype=np.uint32), B,
                                valid, out, stream)
    return out


def _use_plain(device, backend: str) -> bool:
    if backend == "torch":
        return True
    if backend not in ("auto", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend == "auto" and torch.device(device).type == "cpu"


def threefry_randint(keys, B: int, span, device, backend="auto"):
    """randint rows on `device` (`span` one int, or one per row): the
    kernel on CUDA under "auto"/"cuda", the plain version on the CPU or
    under "torch"."""
    if _use_plain(device, backend):
        return threefry_randint_plain(keys, B, span, device)
    return threefry_randint_cuda(keys, B, span, device)


def threefry_bits(keys, B: int, device, valid=None, backend="auto"):
    """bits rows (images, masked by valid) on `device`: the kernel on CUDA
    under "auto"/"cuda", the plain version on the CPU or under "torch"."""
    if _use_plain(device, backend):
        return threefry_bits_plain(keys, B, device, valid)
    return threefry_bits_cuda(keys, B, device, valid)
