"""Output formats matching the reference's stdout dumps.

The reference's observability surface is CSV-ish stdout dumps
(`_pluss_histogram_print`, pluss_utils.h:690-702; MRC print with
run-length compression of flat segments, pluss_utils.h:851-883; file
writer, :885-913). The accuracy harness diffs these dumps across
implementations (Makefile:39-41, README.md:10-12), so the formats are
kept byte-compatible where the reference's are deterministic (sorted
keys; unordered_map iteration order itself is not deterministic, which
is why the reference sorts into a std::map before printing, :692-698).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from .hist import Hist, merge_hists


def _fmt(v: float) -> str:
    # std::cout default formatting for double: 6 significant digits.
    return f"{v:.6g}"


def histogram_lines(title: str, hist: Hist) -> list[str]:
    """`_pluss_histogram_print` (pluss_utils.h:690-702)."""
    out = [title]
    total = sum(hist.values())
    for k in sorted(hist):
        frac = hist[k] / total if total else float("nan")
        out.append(f"{k},{_fmt(hist[k])},{_fmt(frac)}")
    return out


def noshare_dump(state) -> list[str]:
    """pluss_cri_noshare_print_histogram (pluss_utils.h:938-948)."""
    merged = merge_hists(state.noshare, in_log_format=False)
    return histogram_lines("Start to dump noshare private reuse time", merged)


def share_dump(state) -> list[str]:
    """pluss_cri_share_print_histogram (pluss_utils.h:949-960)."""
    merged: Hist = {}
    for per_tid in state.share:
        for h in per_tid.values():
            for k, v in h.items():
                merged[k] = merged.get(k, 0.0) + v
    return histogram_lines("Start to dump share private reuse time", merged)


def rih_dump(rih: Hist) -> list[str]:
    """pluss_print_histogram (pluss_utils.h:748-751)."""
    return histogram_lines("Start to dump reuse time", rih)


def mrc_lines(mrc: np.ndarray, header: bool = True) -> list[str]:
    """pluss_print_mrc run-length compression (pluss_utils.h:851-883).

    Prints the first index of each flat segment and, when the segment is
    longer than one entry, its last index; flatness is
    value[start] - value[next] < 0.00001 (:863).
    """
    out = ["miss ratio"] if header else []
    n = len(mrc)
    i1 = 0
    while i1 < n:
        i2 = i1
        while i2 + 1 < n and mrc[i1] - mrc[i2 + 1] < 0.00001:
            i2 += 1
        out.append(f"{i1}, {_fmt(mrc[i1])}")
        if i2 != i1:
            out.append(f"{i2}, {_fmt(mrc[i2])}")
        i1 = i2 + 1
    return out


def write_mrc_to_file(mrc: np.ndarray, path: str) -> None:
    """pluss_write_mrc_to_file (pluss_utils.h:885-913); written
    atomically (runtime/io.py) so a killed process never leaves a
    truncated curve behind."""
    from .io import atomic_write_text

    atomic_write_text(
        path, "".join(line + "\n" for line in mrc_lines(mrc))
    )


def emit(lines: Iterable[str]) -> None:
    print("\n".join(lines))
