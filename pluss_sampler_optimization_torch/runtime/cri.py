"""Concurrent-reuse-interval (CRI) model — host-side post-processing.

Exact port of the reference's probabilistic model that converts
per-simulated-thread private reuse intervals into concurrent reuse
intervals for the interleaved machine:

- `nbd_spread` == `_pluss_cri_nbd` (pluss_utils.h:987-1009): a private
  interval of length n becomes n + K where K ~ NegativeBinomial(n, p),
  p = 1/thread_cnt — the other threads' interleaved accesses. GSL's
  `gsl_ran_negative_binomial_pdf(k, p, n)` is replaced by an exact
  log-gamma evaluation of the same pmf.
- `noshare_distribute` == `_pluss_cri_noshare_distribute`
  (pluss_utils.h:1010-1039).
- `racetrack` == `_pluss_cri_racetrack` (pluss_utils.h:1040-1131): for
  line-shared references, n = share_ratio racing threads split the
  spread interval across pow2 bins with
  P(2^{i-1} <= ri < 2^i) = (1 - 2^{i-1}/ri')^n - (1 - 2^i/ri')^n
  (:1080), remainder folded into the last bin (:1088-1093, including the
  reference's overwrite of the last computed bin).
- `cri_distribute` == `pluss_cri_distribute` (pluss_utils.h:1204-1208).

The r10 generated sampler carries slightly different local copies
(...rs-ri-opt-r10.cpp:42-131); `R10Quirks` reproduces them:
stop threshold 0.999 instead of 0.9999 (:60), point mass placed at
THREAD_NUM * pow2_floor(n) instead of THREAD_NUM * n (:49-51), racetrack
exponent n-1 instead of n (:105), and the share-path NBD call degenerating
to the point mass because `simulate_negative_binomial(1.0/THREAD_NUM,...)`
truncates its int parameter to thread_cnt=0 (:94), making
n >= (4000*(thread_cnt-1))/thread_cnt == -inf always true.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from .hist import Hist, hist_update, pow2_floor
from .pristate_typing import PRIStateLike  # small protocol, avoids cycle


@dataclasses.dataclass(frozen=True)
class R10Quirks:
    """Behavior switches of the r10 local distribute copies."""

    stop_threshold: float = 0.999
    point_mass_pow2: bool = True
    share_exponent_minus_one: bool = True
    share_nbd_degenerate: bool = True


def negative_binomial_pmf(k: int, p: float, n: float) -> float:
    """pmf of GSL's negative binomial: C(n+k-1, k) p^n (1-p)^k.

    gsl_ran_negative_binomial_pdf(k, p, n) == Gamma(n+k)/(Gamma(k+1)Gamma(n))
    * p^n * (1-p)^k, evaluated in log space for stability.
    """
    if k < 0:
        return 0.0
    if 1.0 - p <= 0.0:
        return 1.0 if k == 0 else 0.0
    lg = (
        math.lgamma(n + k)
        - math.lgamma(k + 1.0)
        - math.lgamma(n)
        + n * math.log(p)
        + k * math.log1p(-p)
    )
    return math.exp(lg)


def nbd_spread(
    thread_cnt: int,
    n: int,
    thread_num: int,
    stop_threshold: float = 0.9999,
    point_mass_pow2: bool = False,
) -> Hist:
    """`_pluss_cri_nbd` (pluss_utils.h:987-1009).

    Note the point-mass key multiplies the *machine* THREAD_NUM macro,
    not the thread_cnt argument (pluss_utils.h:996) — kept verbatim.
    """
    dist: Hist = {}
    p = 1.0 / thread_cnt
    if n >= (4000.0 * (thread_cnt - 1)) / thread_cnt:
        base = pow2_floor(n) if point_mass_pow2 else n
        dist[thread_num * base] = 1.0
        return dist
    k = 0
    prob_sum = 0.0
    while True:
        prob = negative_binomial_pmf(k, p, float(n))
        prob_sum += prob
        dist[k + n] = dist.get(k + n, 0.0) + prob
        if prob_sum > stop_threshold:
            break
        k += 1
    return dist


def _racetrack_split(ri: int, exponent: float, cnt: float, rih: Hist,
                     in_log_format: bool = True) -> None:
    """The pow2 split loop (pluss_utils.h:1076-1097), ported verbatim —
    including float equality on prob_sum and the last-bin overwrite."""
    prob: dict[int, float] = {}
    prob_sum = 0.0
    i = 1
    while True:
        if 2.0**i > ri:
            break
        prob[i] = (1 - (2.0 ** (i - 1)) / ri) ** exponent - (
            1 - (2.0**i) / ri
        ) ** exponent
        prob_sum += prob[i]
        i += 1
        if prob_sum == 1.0:
            break
    if prob_sum != 1.0:
        prob[i - 1] = 1 - prob_sum
    for b, pb in prob.items():
        new_ri = int(2.0 ** (b - 1))  # (long)pow(2, b-1); b==0 -> 0 (:1095)
        hist_update(rih, new_ri, pb * cnt, in_log_format)


def noshare_distribute(
    merged: Hist,
    rih: Hist,
    thread_cnt: int,
    thread_num: int,
    quirks: Optional[R10Quirks] = None,
    in_log_format: bool = True,
) -> None:
    """`_pluss_cri_noshare_distribute` (pluss_utils.h:1010-1039) over an
    already-merged thread histogram; r10's local copy
    (no_share_distribute, ...rs-ri-opt-r10.cpp:65-84) via quirks +
    in_log_format=False."""
    stop = quirks.stop_threshold if quirks else 0.9999
    pm_pow2 = quirks.point_mass_pow2 if quirks else False
    for ri, cnt in merged.items():
        if ri < 0:
            hist_update(rih, ri, cnt, in_log_format)
            continue
        if thread_cnt > 1:
            dist = nbd_spread(thread_cnt, ri, thread_num, stop, pm_pow2)
            for ri2, p in dist.items():
                hist_update(rih, ri2, cnt * p, in_log_format)
        else:
            hist_update(rih, ri, cnt, in_log_format)


def racetrack(
    merged_share,
    rih: Hist,
    thread_cnt: int,
    thread_num: int,
    quirks: Optional[R10Quirks] = None,
    in_log_format: bool = True,
) -> None:
    """`_pluss_cri_racetrack` (pluss_utils.h:1040-1131); r10's local copy
    (share_distribute, ...rs-ri-opt-r10.cpp:85-131) via quirks."""
    stop = quirks.stop_threshold if quirks else 0.9999
    pm_pow2 = quirks.point_mass_pow2 if quirks else False
    for ratio, h in merged_share.items():
        n = float(ratio)
        exponent = n - 1 if (quirks and quirks.share_exponent_minus_one) else n
        for ri, cnt in h.items():
            if thread_cnt <= 1:
                hist_update(rih, ri, cnt, in_log_format)
                continue
            if quirks and quirks.share_nbd_degenerate:
                # r10 passes 1.0/THREAD_NUM as the int thread_cnt (:94),
                # so the n >= -inf guard always fires: point mass at
                # THREAD_NUM * pow2_floor(ri) (:48-52).
                dist = {thread_num * pow2_floor(ri): 1.0}
            else:
                dist = nbd_spread(thread_cnt, ri, thread_num, stop, pm_pow2)
            for ri2, p in dist.items():
                _racetrack_split(int(ri2), exponent, cnt * p, rih, in_log_format)


def cri_distribute(
    state: PRIStateLike,
    thread_cnt: int,
    thread_num: int,
    rih: Optional[Hist] = None,
) -> Hist:
    """`pluss_cri_distribute` (pluss_utils.h:1204-1208): noshare NBD
    spread + share racetrack, both into the global RI histogram.

    The merged histograms are iterated in sorted-key order. The
    reference iterates an unordered_map (no meaningful order), but
    float accumulation into the shared rih bins is not associative, so
    insertion-order iteration would make the MRC depend on which
    dispatch path built the state (serial per-ref, fused, sharded, or
    the cross-request batched runner — each decodes pairs in a
    different order). Canonical order makes the output a pure function
    of histogram CONTENT, which is what the batched-vs-solo
    bit-identity contract (tests/test_batching.py) pins.
    """
    if rih is None:
        rih = {}
    merged = dict(sorted(state.merged_noshare().items()))
    share = {
        ratio: dict(sorted(h.items()))
        for ratio, h in sorted(state.merged_share().items())
    }
    noshare_distribute(merged, rih, thread_cnt, thread_num)
    racetrack(share, rih, thread_cnt, thread_num)
    return rih


def r10_distribute(
    results, thread_num: int, quirks: Optional[R10Quirks] = None
) -> tuple[Hist, dict]:
    """The r10 main flow: per-reference local distributes with the r10
    quirk copies, raw-keyed (no_share_distribute + share_distribute into
    each per-ref histogram, ...rs-ri-opt-r10.cpp:666-693, 42-131), then
    a pow2-binned merge of the per-ref histograms into the global RI
    histogram (pluss_histogram_update default in_log_format,
    :3258-3276). Returns (merged RIHist, {ref name: per-ref Hist}).

    `results` are SampledRefResult (sampler/sampled.py): raw noshare
    and share values with the cold (-1) multiplicity, exactly what the
    per-ref samplers hold at their END_SAMPLE block (:666-693).
    """
    quirks = quirks if quirks is not None else R10Quirks()
    per_ref: dict = {}
    merged: Hist = {}
    for r in results:
        rih: Hist = {}
        nosh = dict(r.noshare)
        if r.cold:
            nosh[-1] = nosh.get(-1, 0.0) + r.cold
        noshare_distribute(
            nosh, rih, thread_num, thread_num, quirks, in_log_format=False
        )
        racetrack(
            r.share, rih, thread_num, thread_num, quirks, in_log_format=False
        )
        per_ref[r.name] = rih
        for k, v in rih.items():
            hist_update(merged, int(k), v, in_log_format=True)
    return merged, per_ref
