"""MRC confidence bands for the progressive sampled engine.

run_sampled_progressive (sampler/sampled.py) executes the sampled
engine in rounds of increasing sample-stream prefixes and, between
rounds, asks this module how uncertain the interim MRC still is. The
estimate is a seeded bootstrap over per-ref SUB-histograms: each round
splits every ref's newly-classified slice into SUB_BLOCKS_PER_ROUND
independent blocks, and a bootstrap replicate refolds each ref from a
with-replacement resample of its blocks. The band at a cache size is
the max-minus-min across replicate curves; the reported width is the
max over cache sizes — the classic percentile-bootstrap spread, coarse
but cheap (the blocks are already-decoded sparse histograms, so a
replicate costs one fold + distribute, never a re-classification).

Determinism contract (tools/lint_determinism.py lints this whole
file): resample indices come from runtime/faults.py::counter_u01 — a
keyed counter hash of (request seed, "mrc_bootstrap", round, ref,
replicate, draw) — never from `random`/np.random or any clock, so the
band sequence (and with it the round count a tolerance stops at, and
the partial_final a deadline produces) replays exactly from the
request (seed, knobs). All fold loops iterate in sorted-key order so
float accumulation is a pure function of histogram content, the same
canonicalization cri_distribute applies.
"""

from __future__ import annotations

import numpy as np

from ..runtime.aet import aet_mrc
from ..runtime.cri import cri_distribute
from ..runtime.faults import counter_u01
from ..runtime.hist import PRIState, hist_update

# Schedule length when neither round_schedule nor max_rounds is set:
# geometric doubling 1/8 -> 1/4 -> 1/2 -> 1 of the final sample count.
DEFAULT_MAX_ROUNDS = 4

# Bootstrap replicates per band estimate. 8 keeps the between-round
# cost at a handful of fold+distribute passes; the band only gates
# EARLY stopping (a full schedule is bit-identical to one-shot
# regardless), so a coarse spread estimate is the right trade.
DEFAULT_REPLICATES = 8

# Independent sub-histogram blocks each round contributes per ref —
# so even round 1 resamples over a non-degenerate block set (a
# one-block bootstrap has zero spread by construction).
SUB_BLOCKS_PER_ROUND = 4


def resolve_schedule(cfg) -> tuple:
    """The round schedule as an increasing tuple of fractions of the
    final per-ref sample count, always ending at 1.0.

    cfg.round_schedule wins verbatim (validated); otherwise geometric
    doubling over cfg.max_rounds (default DEFAULT_MAX_ROUNDS) rounds:
    (1/2^(R-1), ..., 1/4, 1/2, 1)."""
    sched = getattr(cfg, "round_schedule", None)
    if sched is not None:
        fracs = tuple(float(f) for f in sched)
        if not fracs:
            raise ValueError("round_schedule must be non-empty")
        for a, b in zip(fracs, fracs[1:]):
            if b <= a:
                raise ValueError(
                    f"round_schedule must be strictly increasing, "
                    f"got {fracs}"
                )
        if fracs[0] <= 0.0:
            raise ValueError("round_schedule fractions must be > 0")
        if fracs[-1] != 1.0:
            raise ValueError(
                f"round_schedule must end at 1.0, got {fracs[-1]}"
            )
        return fracs
    rounds = getattr(cfg, "max_rounds", None) or DEFAULT_MAX_ROUNDS
    rounds = max(1, int(rounds))
    return tuple(1.0 / (1 << (rounds - 1 - r)) for r in range(rounds))


def round_counts(total: int, schedule: tuple) -> list:
    """Cumulative per-round sample counts for one ref: ceil(frac *
    total) per schedule entry, final round pinned to exactly `total`
    (the full stream — the bit-identity invariant)."""
    counts = []
    for frac in schedule:
        counts.append(min(total, int(-(-total * frac // 1))))
    if counts:
        counts[-1] = total
    return counts


def block_bounds(lo: int, hi: int, blocks: int = SUB_BLOCKS_PER_ROUND):
    """Split the half-open sample range [lo, hi) into up to `blocks`
    contiguous non-empty sub-ranges (fewer when the range is small).
    Returned as a list of (start, end) pairs; empty when lo == hi."""
    n = hi - lo
    if n <= 0:
        return []
    k = min(blocks, n)
    out = []
    for i in range(k):
        a = lo + (n * i) // k
        b = lo + (n * (i + 1)) // k
        out.append((a, b))
    return out


def fold_blocks(ref_blocks, thread_num: int, v2: bool,
                weights=None) -> PRIState:
    """Fold per-ref block histograms into one PRIState, mirroring
    sampled.py::fold_results (all counts on simulated thread 0).

    `ref_blocks` is [per ref] -> [per block] -> (noshare dict, share
    dict, cold count); `weights` (same shape, integer multiplicities)
    is the bootstrap resample — None folds every block once, which
    reproduces the cumulative state exactly (integer-count float
    addition is exact, and sorted-key iteration canonicalizes the
    order)."""
    state = PRIState(thread_num, bin_noshare=not v2)
    for ref_idx, blocks in enumerate(ref_blocks):
        for blk_idx, (noshare, share, cold) in enumerate(blocks):
            w = 1 if weights is None else weights[ref_idx][blk_idx]
            if not w:
                continue
            for ri_val in sorted(noshare):
                state.update_noshare(0, ri_val, noshare[ri_val] * w)
            if cold:
                hist_update(state.noshare[0], -1, cold * w,
                            in_log_format=False)
            for ratio in sorted(share):
                h = share[ratio]
                for ri_val in sorted(h):
                    state.update_share(
                        0, int(ratio), ri_val, h[ri_val] * w
                    )
    return state


def _resample_weights(ref_blocks, seed: int, round_idx: int,
                      replicate: int) -> list:
    """Integer multiplicities of one with-replacement resample: per
    ref, R draws over its R blocks, indices from the counter-hash
    stream keyed (seed, "mrc_bootstrap", round, ref, replicate,
    draw)."""
    weights = []
    for ref_idx, blocks in enumerate(ref_blocks):
        n = len(blocks)
        m = [0] * n
        for k in range(n):
            u = counter_u01(
                seed, "mrc_bootstrap", round_idx, ref_idx,
                replicate, k,
            )
            m[min(n - 1, int(u * n))] += 1
        weights.append(m)
    return weights


def mrc_from_state(state, machine) -> np.ndarray:
    """state -> MRC, exactly the service record pipeline
    (executor.py::build_record): cri_distribute then aet_mrc."""
    rih = cri_distribute(state, machine.thread_num, machine.thread_num)
    return aet_mrc(rih, machine)


def bootstrap_band(ref_blocks, machine, *, seed: int, round_idx: int,
                   v2: bool = False,
                   replicates: int = DEFAULT_REPLICATES) -> float:
    """Max-over-cache-sizes width of the bootstrap MRC band after
    `round_idx` (0-based) rounds. Pure function of (blocks, machine,
    seed, round_idx, v2, replicates) — no entropy, no clock."""
    if not ref_blocks or all(not b for b in ref_blocks):
        return float("inf")
    curves = []
    for b in range(replicates):
        weights = _resample_weights(ref_blocks, seed, round_idx, b)
        state = fold_blocks(
            ref_blocks, machine.thread_num, v2, weights
        )
        curves.append(mrc_from_state(state, machine))
    length = max(len(c) for c in curves)
    mat = np.stack([
        np.concatenate([c, np.full(length - len(c), c[-1])])
        if len(c) < length else c
        for c in curves
    ])
    return float(np.max(mat.max(axis=0) - mat.min(axis=0)))
