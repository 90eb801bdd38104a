"""Debug tracing — the reference's -DDEBUG surfaces as first-class API.

The reference compiles per-access logging only in DEBUG builds
(Makefile:15 commented flag): chunk assignment and access traces
(...ri.cpp:94-121), reuse source->sink pairs above a threshold
(...ri.cpp prints pairs >= 512; ...rs-ri-opt-r10.cpp:538-543,566-568),
and a full-Iteration LAT map (...ri.cpp:50-52). Here the same
information is always available, computed from the closed-form trace:

- `access_trace`: one simulated thread's access stream in execution
  order (position, array, cache line, ref) — the DEBUG access log;
- `reuse_pairs`: (source position, sink position, interval) pairs with
  interval >= min_reuse — the DEBUG reuse log;
- the sampled engine's per-sample surface is sampler/sampled.py::
  per_sample_ri (the r10 DEBUG print equivalent).

Both functions stream the trace in windows of parallel-loop iterations
(the reference's DEBUG build likewise logs incrementally as the walk
advances), so memory stays bounded at any problem size: `reuse_pairs`
carries a vectorized last-access table (key -> last position) across
windows exactly like the reference's LAT hash maps persist across
iterations, and both stop enumerating once `limit` rows exist.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import MachineConfig
from ..core.trace import ProgramTrace
from ..ir import Program

_WINDOW_ACCESSES = 1 << 22  # ~128 MB of int64 columns per window
_ARR_SHIFT = 48  # composite key = array_id << 48 | cache line


@dataclasses.dataclass
class ReusePair:
    source_pos: int
    sink_pos: int
    reuse: int
    array: int
    line: int
    source_ref: str
    sink_ref: str


def _windows(trace: ProgramTrace, tid: int, max_accesses: int | None = None):
    """Yield (nest_index, m_lo, m_hi) covering the thread's stream in
    position order, each window bounded to ~_WINDOW_ACCESSES (or to
    `max_accesses` when the caller only consumes that many rows)."""
    cap = _WINDOW_ACCESSES if max_accesses is None else max_accesses
    for k, nt in enumerate(trace.nests):
        total_m = nt.schedule.local_count(tid)
        if total_m == 0:
            continue
        acc0 = max(1, int(nt.acc[0]))
        step = max(1, min(_WINDOW_ACCESSES, cap + acc0 - 1) // acc0)
        for m_lo in range(0, total_m, step):
            yield k, m_lo, min(total_m, m_lo + step)


def access_trace(
    program: Program, machine: MachineConfig, tid: int, limit: int = 100,
    trace: ProgramTrace | None = None,
):
    """First `limit` accesses of one simulated thread, execution order.

    Returns rows of (position, array name, cache line, ref name) — the
    DEBUG access log (...ri.cpp:94-121). Streams the trace window by
    window and stops as soon as `limit` rows are collected.
    """
    trace = trace or ProgramTrace(program, machine)
    _, _, names = trace.ref_global_tables()
    arrays = program.arrays
    rows: list[tuple[int, str, int, str]] = []
    for k, m_lo, m_hi in _windows(trace, tid, max_accesses=limit):
        pos, addr, arr, ref = trace.enumerate_tid_window(tid, k, m_lo, m_hi)
        order = np.argsort(pos, kind="stable")[: limit - len(rows)]
        rows.extend(
            (int(pos[i]), arrays[int(arr[i])], int(addr[i]), names[int(ref[i])])
            for i in order
        )
        if len(rows) >= limit:
            break
    return rows


def reuse_pairs(
    program: Program,
    machine: MachineConfig,
    tid: int,
    min_reuse: int = 512,
    limit: int = 1000,
    trace: ProgramTrace | None = None,
):
    """Same-line reuse pairs of one thread with interval >= min_reuse
    (the DEBUG 'src -> sink' log, ...ri.cpp reuse prints), in sink
    position order within each streamed window, first `limit` pairs."""
    trace = trace or ProgramTrace(program, machine)
    _, _, names = trace.ref_global_tables()
    pairs: list[ReusePair] = []
    # carried last-access table, sorted by key (the LAT_<array> maps)
    c_keys = np.zeros(0, dtype=np.int64)
    c_pos = np.zeros(0, dtype=np.int64)
    c_ref = np.zeros(0, dtype=np.int64)

    def emit(src_pos, src_ref, snk_pos, snk_ref, key):
        reuse = snk_pos - src_pos
        take = np.flatnonzero(reuse >= min_reuse)
        take = take[np.argsort(snk_pos[take], kind="stable")]
        for i in take[: limit - len(pairs)]:
            pairs.append(
                ReusePair(
                    source_pos=int(src_pos[i]),
                    sink_pos=int(snk_pos[i]),
                    reuse=int(reuse[i]),
                    array=int(key[i] >> _ARR_SHIFT),
                    line=int(key[i] & ((1 << _ARR_SHIFT) - 1)),
                    source_ref=names[int(src_ref[i])],
                    sink_ref=names[int(snk_ref[i])],
                )
            )

    cur_nest = -1
    for k, m_lo, m_hi in _windows(trace, tid):
        if k != cur_nest:
            # the reference clears every LAT after each parallel loop —
            # reuse never crosses a nest boundary (ir.py, Program docs)
            c_keys = np.zeros(0, dtype=np.int64)
            c_pos = np.zeros(0, dtype=np.int64)
            c_ref = np.zeros(0, dtype=np.int64)
            cur_nest = k
        pos, addr, arr, ref = trace.enumerate_tid_window(tid, k, m_lo, m_hi)
        if len(pos) == 0:
            continue
        if np.any(addr < 0):
            raise ValueError("negative cache-line address")
        key = (arr << _ARR_SHIFT) | addr
        order = np.lexsort((pos, key))
        k_s, p_s, r_s = key[order], pos[order], ref[order]
        same = np.empty(len(k_s), dtype=bool)
        same[0] = False
        same[1:] = k_s[1:] == k_s[:-1]
        # pairs inside this window + window-first occurrences that hit
        # the carried table, emitted together in sink-position order
        within = np.flatnonzero(same)
        srcs = [p_s[within - 1]]
        srcr = [r_s[within - 1]]
        snks = [p_s[within]]
        snkr = [r_s[within]]
        keys = [k_s[within]]
        first = np.flatnonzero(~same)
        if len(c_keys):
            slot = np.searchsorted(c_keys, k_s[first])
            hit = (slot < len(c_keys)) & (
                c_keys[np.minimum(slot, len(c_keys) - 1)] == k_s[first]
            )
            f, s = first[hit], slot[hit]
            srcs.append(c_pos[s])
            srcr.append(c_ref[s])
            snks.append(p_s[f])
            snkr.append(r_s[f])
            keys.append(k_s[f])
        emit(*map(np.concatenate, (srcs, srcr, snks, snkr, keys)))
        # merge window-last occurrences into the carried table
        last = np.flatnonzero(np.append(~same[1:], True))
        merged_keys = np.concatenate([k_s[last], c_keys])
        merged_pos = np.concatenate([p_s[last], c_pos])
        merged_ref = np.concatenate([r_s[last], c_ref])
        uniq, idx = np.unique(merged_keys, return_index=True)
        c_keys, c_pos, c_ref = uniq, merged_pos[idx], merged_ref[idx]
        if len(pairs) >= limit:
            break
    return pairs


def format_reuse_pairs(pairs) -> list[str]:
    """'[reuse] source -> sink' lines (r10 DEBUG format, :566-568)."""
    return [
        f"[{p.reuse}] {p.source_ref}@{p.source_pos} -> "
        f"{p.sink_ref}@{p.sink_pos} (array {p.array}, line {p.line})"
        for p in pairs
    ]
