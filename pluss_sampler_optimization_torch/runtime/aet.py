"""AET: reuse-interval histogram -> LRU miss-ratio curve.

Port of `pluss_AET` (pluss_utils.h:758-804):

1. P(t) = fraction of reuses with interval > t (built by descending
   accumulation seeded with the cold-miss count at key -1, :772-780),
   P(0) := 1 (:781).
2. A fill-time sweep: a cursor t advances while the accumulated P mass
   (`sum_P`, repeated float addition) is below the cache size c; the
   miss ratio at c is P(prev_t) where prev_t is the last histogram key
   passed (:782-802). c ranges over [0, min(max_RT, cache lines)]
   with cache lines = 2560KB/8B = 327680 (:785-786).

Two evaluation paths produce bit-identical curves:
- `_mrc_literal`: the verbatim loop, O(max_RT) scalar adds.
- `_mrc_runs`: observes that between histogram keys the addend is
  constant, so the repeated-addition sequence is exactly a numpy cumsum
  per run (cumsum performs the same left-to-right float additions);
  crossings are then binary searches. Used when max_RT is large (the
  GEMM N=4096 histogram reaches max_RT ~ 2.7e8, where the literal loop
  is impractical).
"""

from __future__ import annotations

import numpy as np

from ..config import MachineConfig
from .hist import Hist

_RUN_CHUNK = 1 << 22


def _build_p(histogram: Hist):
    total = float(sum(histogram.values()))
    keys_desc = sorted((k for k in histogram), reverse=True)
    accumulate = histogram.get(-1, 0.0)
    P: dict[int, float] = {}
    for k in keys_desc:
        if k == -1:
            break
        P[k] = accumulate / total
        accumulate += histogram[k]
    P[0] = 1.0
    return P


def _mrc_literal(P: dict[int, float], max_rt: int, cs: int) -> np.ndarray:
    C = min(max_rt, cs)
    out = np.empty(C + 1, dtype=np.float64)
    sum_p = 0.0
    t = 0
    prev_t = 0
    for c in range(C + 1):
        while sum_p < c and t <= max_rt:
            if t in P:
                sum_p += P[t]
                prev_t = t
            else:
                sum_p += P[prev_t]
            t += 1
        out[c] = P[prev_t]
    return out


def _mrc_runs(P: dict[int, float], max_rt: int, cs: int) -> np.ndarray:
    C = min(max_rt, cs)
    out = np.empty(C + 1, dtype=np.float64)
    keys = sorted(P)
    # run j covers t in [keys[j], next_key) with addend P[keys[j]]
    run_starts = keys
    run_ends = keys[1:] + [max_rt + 1]  # exclusive
    c = 0
    sum_p = 0.0
    # t == 0 is always the first run start (P[0] exists)
    for k, t_end_full in zip(run_starts, run_ends):
        if k > max_rt:
            break
        t_end = min(t_end_full, max_rt + 1)
        q = P[k]
        t = k
        while t < t_end:
            blk = min(t_end - t, _RUN_CHUNK)
            arr = np.full(blk, q, dtype=np.float64)
            arr[0] += sum_p
            S = np.cumsum(arr)
            sum_p = float(S[-1])
            # every c <= floor(sum_p) has its stop condition (sum_p >= c
            # after an addition) satisfied inside this block, with
            # prev_t equal to this run's key -> miss ratio q.
            hi = min(int(np.floor(sum_p)), C)
            if hi >= c:
                out[c : hi + 1] = q
                c = hi + 1
            t += blk
            if c > C:
                break
        if c > C:
            break
    # cursor exhausted (t > max_rt) while sum_p still < c: the loop body
    # no longer advances and every remaining c reads P[prev_t] of the
    # last key <= max_rt.
    if c <= C:
        last_key = max((k for k in keys if k <= max_rt), default=0)
        out[c:] = P[last_key]
    return out


def aet_mrc(
    histogram: Hist, machine: MachineConfig, force: str | None = None
) -> np.ndarray:
    """Miss-ratio curve MRC[c] for c in [0, min(max_RT, cache lines)].

    Returns a dense float64 array; index = cache size in lines
    (pluss_utils.h:785-786).
    """
    if not histogram or sum(histogram.values()) == 0:
        return np.ones(1, dtype=np.float64)
    max_rt = max(histogram)
    if max_rt < 0:
        return np.ones(1, dtype=np.float64)
    cs = machine.cache_lines
    P = _build_p(histogram)
    use = force or ("literal" if max_rt <= 1 << 21 else "runs")
    if use == "literal":
        return _mrc_literal(P, max_rt, cs)
    return _mrc_runs(P, max_rt, cs)


def mrc_l1_error(a: np.ndarray, b: np.ndarray) -> float:
    """Mean absolute difference over the common support — the accuracy
    metric of BASELINE.json (MRC L1 error vs the serial oracle)."""
    n = min(len(a), len(b))
    if n == 0:
        return 0.0
    return float(np.mean(np.abs(a[:n] - b[:n])))
