"""Host-side sparse histograms: the reference's L1 runtime as plain dicts.

Mirrors `Histogram = unordered_map<long,double>` (pluss_utils.h:25) and
the global state `_NoSharePRI[THREAD_NUM]` / `_SharePRI[THREAD_NUM]`
(pluss_utils.cpp:4-14) as a value object instead of globals. Device-side
dense histograms (ops/histogram.py) are converted to this form before
the CRI/AET stages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

Hist = Dict[int, float]


def pow2_floor(x: int) -> int:
    """Highest power of two <= x, for x > 0.

    `_polybench_to_highest_power_of_two` (pluss_utils.h:665-679). The
    Rust port disagrees between its two runtimes (utils.rs:121-134
    rounds down, unsafe_utils.rs:227-230 rounds *up*); we follow the C++
    serial oracle (round down), per SURVEY.md section 7.
    """
    if x <= 0:
        raise ValueError("pow2_floor needs x > 0")
    return 1 << (x.bit_length() - 1)


def hist_update(h: Hist, key: int, cnt: float, in_log_format: bool = True) -> None:
    """`_pluss_histogram_update` (pluss_utils.h:680-689): pow2-bin keys > 0
    when in_log_format, accumulate."""
    if key > 0 and in_log_format:
        key = pow2_floor(key)
    h[key] = h.get(key, 0.0) + cnt


def merge_hists(hists, in_log_format: bool = False) -> Hist:
    out: Hist = {}
    for h in hists:
        for k, v in h.items():
            hist_update(out, k, v, in_log_format)
    return out


@dataclasses.dataclass
class PRIState:
    """Per-simulated-thread private-reuse histograms.

    noshare[tid]: Hist with pow2-binned keys (plus -1 for cold lines);
    share[tid]: {share_ratio: Hist with *raw* reuse keys} — the share
    update deliberately skips binning (pluss_utils.h:928-937) because the
    racetrack model needs raw interval lengths (pluss_utils.h:1060-1097).

    bin_noshare=False selects the runtime-v2 semantics: v2's noshare
    update drops the pow2 binning on insertion (`false` argument,
    pluss_utils_v2.h:915-918 vs v1 pluss_utils.h:924-927), keeping raw
    reuse keys everywhere.
    """

    thread_num: int
    noshare: list = dataclasses.field(default_factory=list)
    share: list = dataclasses.field(default_factory=list)
    bin_noshare: bool = True

    def __post_init__(self) -> None:
        if not self.noshare:
            self.noshare = [dict() for _ in range(self.thread_num)]
        if not self.share:
            self.share = [dict() for _ in range(self.thread_num)]

    def update_noshare(self, tid: int, reuse: int, cnt: float) -> None:
        """pluss_cri_noshare_histogram_update (pluss_utils.h:924-927;
        v2: pluss_utils_v2.h:915-918 via bin_noshare=False)."""
        hist_update(
            self.noshare[tid], reuse, cnt, in_log_format=self.bin_noshare
        )

    def update_share(self, tid: int, ratio: int, reuse: int, cnt: float) -> None:
        """pluss_cri_share_histogram_update (pluss_utils.h:928-937)."""
        h = self.share[tid].setdefault(ratio, {})
        hist_update(h, reuse, cnt, in_log_format=False)

    # -- merges used by the distribute/print stages -------------------------

    def merged_noshare(self) -> Hist:
        """Raw-key accumulate across threads (pluss_utils.h:1013-1022)."""
        return merge_hists(self.noshare, in_log_format=False)

    def merged_share(self):
        """{ratio: Hist} accumulated across threads (pluss_utils.h:1042-1058)."""
        out: Dict[int, Hist] = {}
        for per_tid in self.share:
            for ratio, h in per_tid.items():
                tgt = out.setdefault(ratio, {})
                for k, v in h.items():
                    tgt[k] = tgt.get(k, 0.0) + v
        return out

    def total_counts(self) -> float:
        s = 0.0
        for h in self.noshare:
            s += sum(h.values())
        for per_tid in self.share:
            for h in per_tid.values():
                s += sum(h.values())
        return s


def share_classify(reuse: int, threshold: int) -> bool:
    """True if the access is a cross-thread ("share") reuse.

    `distance_to(reuse,0) > distance_to(reuse,THRESH)`
    (...ri-omp-seq.cpp:203, distance_to at pluss_utils.h:703-708).
    """
    d0 = abs(reuse)
    dt = abs(reuse - threshold)
    return d0 > dt
