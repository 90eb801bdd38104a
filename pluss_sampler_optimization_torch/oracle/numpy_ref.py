"""Vectorized exact full-traversal sampler (host, numpy).

Computes the same per-thread reuse intervals as the serial oracle via
sorting instead of a hash-map walk: the last-access-time lookup
(LAT_X[tid][addr], ...ri-omp-seq.cpp:107-119) is equivalent to, per
(thread, array, line), taking consecutive differences of that line's
access positions — obtained by lexsorting the thread's access stream by
(array, line, position). Reuse never crosses a parallel nest: the
reference flushes surviving lines as -1 and clears the LAT tables after
every parallel loop (:303-319), so each (thread, nest) is an independent
sort problem (positions still carry the cross-nest clock offset, which
cancels in the differences). This is the CPU twin of the TPU dense
sampler (sampler/dense.py) and the oracle used at sizes where the dict
walk is too slow.
"""

from __future__ import annotations

import numpy as np

from ..config import MachineConfig
from ..core.trace import ProgramTrace
from ..ir import Program
from ..runtime.hist import PRIState
from .serial import OracleResult


def _pow2_floor_arr(x: np.ndarray) -> np.ndarray:
    """Elementwise highest power of two <= x (x > 0, x < 2^53)."""
    _, e = np.frexp(x.astype(np.float64))
    return (np.int64(1) << (e.astype(np.int64) - 1)).astype(np.int64)


def fold_nest_numpy(nt, tid: int, state: PRIState) -> int:
    """Exact fold of one (nest, thread) into `state` via the host
    lexsort; returns the thread's access count in this nest.

    The body of run_numpy, exposed standalone because it is also the
    fastest exact evaluator for SMALL nests: below a few million
    accesses the whole per-thread sort costs milliseconds, where any
    device-kernel route pays per-ref-structure dispatch/compile costs
    first (sampler/analytic.py routes its small-nest case here)."""
    t = nt.tables
    parts = [nt.enumerate_ref(tid, ri) for ri in range(t.n_refs)]
    pos = np.concatenate([p for p, _ in parts])
    if len(pos) == 0:
        return 0
    addr = np.concatenate([a for _, a in parts])
    arr = np.concatenate(
        [
            np.full(len(parts[ri][0]), t.ref_arrays[ri], dtype=np.int64)
            for ri in range(t.n_refs)
        ]
    )
    ref = np.concatenate(
        [
            np.full(len(parts[ri][0]), ri, dtype=np.int64)
            for ri in range(t.n_refs)
        ]
    )
    order = np.lexsort((pos, addr, arr))
    pos_s, addr_s, arr_s, ref_s = (
        pos[order], addr[order], arr[order], ref[order],
    )
    same = np.zeros(len(pos), dtype=bool)
    same[1:] = (arr_s[1:] == arr_s[:-1]) & (addr_s[1:] == addr_s[:-1])
    reuse = np.where(same, pos_s - np.concatenate(([0], pos_s[:-1])), 0)

    r = reuse[same]
    snk = ref_s[same]
    s_thr = t.ref_share_thresholds[snk]
    s_ratio = t.ref_share_ratios[snk]
    is_share = (s_thr > 0) & (np.abs(r) > np.abs(r - s_thr))

    # noshare: pow2-binned accumulate (pluss_utils.h:924-927)
    ns = r[~is_share]
    if len(ns):
        binned = _pow2_floor_arr(ns)
        keys, cnts = np.unique(binned, return_counts=True)
        h = state.noshare[tid]
        for key, c in zip(keys.tolist(), cnts.tolist()):
            h[key] = h.get(key, 0.0) + float(c)

    # share: raw keys per ratio (pluss_utils.h:928-937)
    sh = r[is_share]
    sh_ratio = s_ratio[is_share]
    if len(sh):
        for rat in np.unique(sh_ratio).tolist():
            vals = sh[sh_ratio == rat]
            keys, cnts = np.unique(vals, return_counts=True)
            h = state.share[tid].setdefault(int(rat), {})
            for key, c in zip(keys.tolist(), cnts.tolist()):
                h[int(key)] = h.get(int(key), 0.0) + float(c)

    # per-nest -1 flush: one per distinct (array, line)
    # (...ri-omp-seq.cpp:303-319)
    n_cold = int((~same).sum())
    if n_cold:
        h = state.noshare[tid]
        h[-1] = h.get(-1, 0.0) + float(n_cold)
    return len(pos)


def run_numpy(program: Program, machine: MachineConfig) -> OracleResult:
    trace = ProgramTrace(program, machine)
    P = machine.thread_num
    state = PRIState(P)
    per_tid = [0] * P

    for k, nt in enumerate(trace.nests):
        for tid in range(P):
            per_tid[tid] += fold_nest_numpy(nt, tid, state)

    return OracleResult(
        state=state, total_accesses=sum(per_tid), per_tid_accesses=per_tid
    )
