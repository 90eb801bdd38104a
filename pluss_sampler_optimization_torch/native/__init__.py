"""ctypes bindings for the native serial sampler runtime.

The C++ library (pluss_native.cpp) is the framework's native runtime
component — the TPU-native equivalent of the reference's C++ runtime +
generated serial sampler (c_lib/test/runtime/pluss_utils.h,
c_lib/test/sampler/...-ri-omp-seq.cpp), driven by the loop-nest IR
instead of per-benchmark codegen. It serves as the fast large-N oracle
and as bench.py's single-core speed baseline.

Built lazily with g++ on first use; `available()` reports whether a
toolchain/binary exists so callers can fall back to the Python oracle.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from ..config import MachineConfig
from ..ir import MAX_DEPTH, Program, nest_tables
from ..oracle.serial import OracleResult
from ..runtime.hist import PRIState

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libplussnative.so")
_SRC = os.path.join(_DIR, "pluss_native.cpp")

N_NOSHARE_BINS = 64
_NOSHARE_SLOTS = N_NOSHARE_BINS + 1  # + the -1 cold bin

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def ensure_built(force: bool = False) -> str:
    """Compile the shared library if missing/stale; returns its path."""
    stale = (
        not os.path.exists(_SO)
        or os.path.getmtime(_SO) < os.path.getmtime(_SRC)
    )
    if force or stale:
        subprocess.run(
            ["make", "-C", _DIR, "libplussnative.so"],
            check=True,
            capture_output=True,
        )
    return _SO


def _load() -> ctypes.CDLL:
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if _build_error is not None:
        raise RuntimeError(_build_error)
    try:
        lib = ctypes.CDLL(ensure_built())
    except (OSError, subprocess.CalledProcessError) as e:
        _build_error = f"native runtime unavailable: {e}"
        raise RuntimeError(_build_error) from e
    lib.pluss_run.restype = ctypes.c_int64
    lib.pluss_classify_reduce.restype = ctypes.c_int64
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int64))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def classify_reduce(
    packed, found, noshare_bins: np.ndarray, mask=None,
    share_cap: int = 64,
):
    """SIMD batched classify+histogram reduction for the sampled
    engine's CPU fast path (pluss_classify_reduce).

    `packed`/`found` are one classified chunk (the "raw" kernel form's
    outputs, already on the host); `noshare_bins` is the caller's
    per-ref (65,) int64 accumulator (64 pow2 bins + cold at [64]) that
    the C pass ADDS into; `mask` (optional bool array) marks valid
    elements. Share samples and sub-1 noshare samples come back as
    exact sorted (packed key, count) pairs for decode_pairs. Regrows
    the pair buffers internally on capacity overflow (the C side
    writes nothing on overflow, so a re-call cannot double-count).

    Returns (keys, counts, share_cap, regrows): the trimmed pair
    arrays, the (possibly grown) capacity to reuse for the next chunk,
    and how many regrow re-calls happened (for capacity_regrows).
    """
    lib = _load()
    packed = _i64(packed)
    found_u8 = np.ascontiguousarray(np.asarray(found, dtype=np.uint8))
    n = packed.shape[0]
    if found_u8.shape[0] != n:
        raise ValueError("packed/found length mismatch")
    assert noshare_bins.dtype == np.int64 and (
        noshare_bins.shape == (_NOSHARE_SLOTS,)
    )
    u8p = ctypes.POINTER(ctypes.c_uint8)
    mask_ptr = None
    if mask is not None:
        mask_u8 = np.ascontiguousarray(np.asarray(mask, dtype=np.uint8))
        if mask_u8.shape[0] != n:
            raise ValueError("packed/mask length mismatch")
        mask_ptr = mask_u8.ctypes.data_as(u8p)
    regrows = 0
    while True:
        keys = np.empty(share_cap, dtype=np.int64)
        counts = np.empty(share_cap, dtype=np.int64)
        sz = lib.pluss_classify_reduce(
            _ptr(packed), found_u8.ctypes.data_as(u8p), mask_ptr,
            ctypes.c_int64(n), _ptr(noshare_bins), _ptr(keys),
            _ptr(counts), ctypes.c_int64(share_cap),
        )
        if sz <= share_cap:
            return keys[:sz], counts[:sz], share_cap, regrows
        regrows += 1
        share_cap = max(share_cap * 4, int(sz))


def run_serial_native(
    program: Program, machine: MachineConfig, share_cap: int = 1 << 16
) -> OracleResult:
    """Native serial walk -> OracleResult, bit-exact vs oracle.run_serial."""
    return _run_native(program, machine, share_cap, parallel=False)


def run_parallel_native(
    program: Program, machine: MachineConfig, share_cap: int = 1 << 16
) -> OracleResult:
    """Native parallel walk: one OS thread per simulated thread (the
    reference `ri` variant's omp-over-tids execution model,
    ...ri.cpp:67), thread-local histograms merged at join. Bit-identical
    output to run_serial_native."""
    return _run_native(program, machine, share_cap, parallel=True)


def _run_native(
    program: Program, machine: MachineConfig, share_cap: int, parallel: bool
) -> OracleResult:
    lib = _load()
    n_nests = len(program.nests)
    tables = [
        nest_tables(program, k, machine.thread_num - 1)
        for k in range(n_nests)
    ]
    depths = _i64([t.depth for t in tables])
    trips = _i64(np.stack([t.trips for t in tables]))
    starts = _i64(np.stack([t.starts for t in tables]))
    steps = _i64(np.stack([t.steps for t in tables]))
    trip_cf = _i64(np.stack([t.trip_coeffs for t in tables]))
    start_cf = _i64(np.stack([t.start_coeffs for t in tables]))
    ref_off = _i64(np.cumsum([0] + [t.n_refs for t in tables]))
    levels = _i64(np.concatenate([t.ref_levels for t in tables]))
    coeffs = _i64(np.concatenate([t.ref_coeffs for t in tables]))
    consts = _i64(np.concatenate([t.ref_consts for t in tables]))
    arrays = _i64(np.concatenate([t.ref_arrays for t in tables]))
    slots = _i64(
        [
            0 if r.slot == "pre" else 1
            for nest in program.nests
            for r in nest.refs
        ]
    )
    thrs = _i64(np.concatenate([t.ref_share_thresholds for t in tables]))
    ratios = _i64(np.concatenate([t.ref_share_ratios for t in tables]))

    P = machine.thread_num
    while True:
        noshare_bins = np.zeros(P * _NOSHARE_SLOTS, dtype=np.int64)
        share_out = np.zeros(share_cap * 4, dtype=np.int64)
        share_count = np.zeros(1, dtype=np.int64)
        per_tid = np.zeros(P, dtype=np.int64)

        rc = lib.pluss_run(
            ctypes.c_int64(1 if parallel else 0),
            ctypes.c_int64(P),
            ctypes.c_int64(machine.chunk_size),
            ctypes.c_int64(machine.ds),
            ctypes.c_int64(machine.cls),
            ctypes.c_int64(n_nests),
            _ptr(depths), _ptr(trips), _ptr(starts), _ptr(steps),
            _ptr(trip_cf), _ptr(start_cf),
            _ptr(ref_off), _ptr(levels), _ptr(coeffs), _ptr(consts),
            _ptr(arrays), _ptr(slots), _ptr(thrs), _ptr(ratios),
            ctypes.c_int64(len(program.arrays)),
            _ptr(noshare_bins), _ptr(share_out), _ptr(share_count),
            ctypes.c_int64(share_cap), _ptr(per_tid),
        )
        if rc == 2:
            raise RuntimeError(
                "native parallel execution failed (thread spawn or "
                "worker exception)"
            )
        if rc == 0:
            break
        # capacity overflow: the ABI reports the exact required pair
        # count in share_count without corrupting anything, so regrow
        # once and re-walk (triangular nests at large N produce ~1e5+
        # distinct share (tid, ratio, value) triples — syrk-tri N=2048
        # needs ~4.6e5 — far past any useful fixed default)
        need = int(share_count[0])
        if need <= share_cap:  # defensive: rc!=0 must imply growth
            raise RuntimeError(
                f"native share capacity exceeded: need {need}, "
                f"have {share_cap}"
            )
        share_cap = need

    state = PRIState(P)
    bins = noshare_bins.reshape(P, _NOSHARE_SLOTS)
    for tid in range(P):
        h = state.noshare[tid]
        for e in np.nonzero(bins[tid, :N_NOSHARE_BINS])[0]:
            h[1 << int(e)] = float(bins[tid, e])
        if bins[tid, N_NOSHARE_BINS]:
            h[-1] = float(bins[tid, N_NOSHARE_BINS])
    for i in range(int(share_count[0])):
        tid, ratio, value, cnt = share_out[i * 4 : i * 4 + 4]
        state.update_share(int(tid), int(ratio), int(value), float(cnt))
    return OracleResult(
        state=state,
        total_accesses=int(per_tid.sum()),
        per_tid_accesses=[int(x) for x in per_tid],
    )
