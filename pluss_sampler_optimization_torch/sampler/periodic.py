"""Periodic exact engine: full-traversal histograms from O(1) windows.

Port of the JAX package's sampler/periodic.py. The dense/stream engines
(sampler/dense.py, sampler/stream.py) measure every reuse exactly by
sorting the whole packed access stream — 6N^3 keys for GEMM. This
engine computes the *same bit-exact histograms* from a handful of
two-period windows:

Per simulated thread, the trace of a rectangular nest is PERIODIC in
the parallel loop: every thread-local parallel iteration m ("period")
executes an identical body, so positions are m * acc_per_level[0] +
(fixed inner offsets) (core/trace.py). Two facts make the histogram a
weighted sum over tiny windows:

1. **Reuse values are translation-invariant.** A reuse from a source
   in period q to a sink in period q or q+1 is a position difference,
   so it depends only on (v0(q+1) - v0(q), v0(q) mod cls/ds) — never
   on q itself.
2. **Reuses never skip a period (checked, not assumed).** If a line is
   touched in periods q and q' > q+1 of the same thread, it is also
   touched in q+1, so the *next* touch of any source lies in its own
   or the following period (or nowhere). `validate_periodic` verifies
   this per (nest, array) in tiers (host numpy, the JAX package's code
   verbatim); violations raise NotImplementedError and callers fall
   back to the analytic or streaming engine.

The engine therefore sorts one two-period window per distinct
signature (delta to next period, v0 phase) — typically 2-3 windows per
nest, each 2 * acc_per_level[0] keys, on the device with `torch.sort`
— multiplies each window's histogram by how many of the thread's
periods carry that signature, and sums on the host. Sources are the
window's first period only; a first-period access with no same-line
successor in the window is a cold (-1) line by fact 2.

`run_exact` is the exact router (periodic, then analytic, then dense).
The mesh-sharded form (parallel/sharded.py::run_periodic_sharded)
splits the merged windows over the shards through `window_eval`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import MachineConfig
from ..core.trace import NestTrace, ProgramTrace
from ..ir import Program
from ..ops.histogram import sorted_k_unique
from ..oracle.serial import OracleResult
from ..runtime.hist import PRIState
from .dense import (
    _ceil_log2,
    nest_geometry,
    packed_ref_keys,
    per_array_count,
    pow2_counts,
    ref_bits,
    same_as_prev,
    share_tables,
    shifted,
    sorted_fields,
)
from .sampled import _span, resolve_device


_TIER_B_MAX_REACH = 8  # periods a tier-B numeric window must cover


@functools.lru_cache(maxsize=64)
def _validate_nest(program: Program, nest_index: int, machine: MachineConfig):
    """Check the skip-free-reuse precondition for one nest (see module
    docstring fact 2). Raises NotImplementedError when the periodic
    decomposition would be unsound.

    Tiered per (nest, array) — each tier is a sufficient condition for
    "a line touched in two in-tid periods q < q' with q' > q+1 is also
    touched in q+1" (an interval of v0 values intersected with the
    thread's ordered period subsequence is always a consecutive run of
    it, so v0-global contiguity of each line's touch set suffices):

    - c0 == 0 for every ref: the touched-line set is identical every
      period, so any line's next touch is at most one period away.
    - single ref with a per-period contiguous line set: the set of v0
      touching a fixed line is a sliding-window intersection — it
      grows then shrinks monotonically, hence an interval.
    - equal c0 > 0 (stencils): numeric check over a (2R+1)-period
      window per phase that every line's touch set is v0-contiguous;
      equal c0 makes the pattern v0-translation-invariant (mod phase),
      so the window generalizes. R is the closed-form maximum touch
      reach; R > _TIER_B_MAX_REACH falls through to the hull tier.
    - equal c0 > 0, wide reach (hull tier): per-ref contiguous line
      sets + the refs' line intervals chain-overlapping at EVERY v0
      (checked vectorized): interval ends are monotone in v0, so a
      line in U(q) and U(q+D) lies in U(q+1)'s hull = U(q+1).

    Arrays mixing parallel-loop coefficients are rejected outright —
    not for fact 2 but for fact 1 (see _check_array).
    """
    trace = ProgramTrace(program, machine)
    nt = trace.nests[nest_index]
    t = nt.tables
    if nt.tri:
        raise NotImplementedError(
            f"{program.name} nest {nest_index}: triangular nests have "
            "per-period trip counts; the periodic engine needs a "
            "uniform period (use dense/stream)"
        )
    by_array: dict[int, list[int]] = {}
    for ri in range(t.n_refs):
        by_array.setdefault(int(t.ref_arrays[ri]), []).append(ri)
    for arr, refs in by_array.items():
        why = _check_array(nt, arr, refs)
        if why is not None:
            raise NotImplementedError(
                f"{program.name} nest {nest_index}: array {arr} "
                f"(refs {[t.ref_names[ri] for ri in refs]}): {why}; a "
                "reuse could skip a period (use dense/stream)"
            )
    return trace


def _check_array(nt: NestTrace, arr: int, refs: list) -> str | None:
    """None when some tier accepts the array, else the reason string.

    Every tier additionally requires ONE parallel-loop coefficient per
    array — that is what makes fact 1 (window translation invariance)
    hold per array: group structure never crosses arrays (groups are
    (array, line) pairs), and an array whose refs all shift lines at
    the same rate produces the same within-window grouping pattern at
    every period of a phase class. Mixed coefficients (syrk's A[i][k]
    vs A[j][k]) break it — the fixed ref re-touches the translating
    ref's line at a position that depends on the absolute v0 — so the
    representative-window decomposition itself is unsound there even
    when fact 2 holds, and the array is rejected outright."""
    t = nt.tables
    lp0 = nt.nest.loops[0]
    c0s = sorted({int(t.ref_coeffs[ri][0]) for ri in refs})
    if any(c < 0 for c in c0s):
        return f"negative parallel-loop coefficient {c0s[0]}"
    if len(c0s) > 1:
        return (
            f"refs mix parallel-loop coefficients {c0s}; the window "
            "histogram would depend on the absolute parallel value, "
            "not just its phase (no translation invariance)"
        )
    if c0s == [0]:
        return None  # same line set every period
    phases = _phase_count(nt)
    phase_v0s = [
        lp0.start + ph * lp0.step
        for ph in range(min(phases, lp0.trip))
    ]

    def ref_contiguous(ri: int) -> bool:
        for v0 in phase_v0s:
            u = np.unique(_ref_period_lines(nt, ri, v0))
            if len(u) != int(u[-1] - u[0] + 1):
                return False
        return True

    if len(refs) == 1:
        if ref_contiguous(refs[0]):
            return None
        return _check_exhaustive(
            nt, refs,
            "single ref with a non-contiguous per-period line set",
        )

    if len(c0s) == 1:
        # equal c0 > 0: numeric per-line window check
        c0 = c0s[0]
        flats_lo = min(
            int(t.ref_consts[ri]) + _inner_min(nt, ri) for ri in refs
        )
        flats_hi = max(
            int(t.ref_consts[ri]) + _inner_max(nt, ri) for ri in refs
        )
        g = max(1, nt.machine.cls // nt.machine.ds)
        reach = (flats_hi - flats_lo + g) // max(1, c0 * lp0.step) + 1
        if reach <= _TIER_B_MAX_REACH:
            for v0c in phase_v0s:
                pairs = []
                for d in range(-reach, reach + 1):
                    v0 = v0c + d * lp0.step
                    if not (lp0.start <= v0 < lp0.start + lp0.trip * lp0.step):
                        continue
                    ln = np.unique(np.concatenate(
                        [_ref_period_lines(nt, ri, v0) for ri in refs]
                    ))
                    pairs.append(
                        np.stack([ln, np.full_like(ln, d)], axis=1)
                    )
                allp = np.concatenate(pairs)
                order = np.lexsort((allp[:, 1], allp[:, 0]))
                allp = allp[order]
                line, dd = allp[:, 0], allp[:, 1]
                new = np.concatenate([[True], line[1:] != line[:-1]])
                # per line: contiguous iff count == max-min+1
                idx = np.cumsum(new) - 1
                n_lines = int(idx[-1]) + 1
                cnt = np.bincount(idx, minlength=n_lines)
                dmin = np.full(n_lines, 1 << 30)
                dmax = np.full(n_lines, -(1 << 30))
                np.minimum.at(dmin, idx, dd)
                np.maximum.at(dmax, idx, dd)
                if not (cnt == dmax - dmin + 1).all():
                    return (
                        "a line's touch-period set is non-contiguous "
                        f"within the +-{reach}-period window at v0={v0c}"
                    )
            return None
        # reach too wide for the window check: fall through to hull
    # wide-reach equal c0: per-ref contiguity + per-v0 interval chain
    # overlap, vectorized over every v0
    for ri in refs:
        if not ref_contiguous(ri):
            return _check_exhaustive(
                nt, refs,
                f"ref {t.ref_names[ri]} has a non-contiguous "
                "per-period line set (hull tier needs intervals)",
            )
    v0_all = lp0.start + np.arange(lp0.trip, dtype=np.int64) * lp0.step
    los, his = [], []
    for ri in refs:
        base = int(t.ref_consts[ri]) + int(t.ref_coeffs[ri][0]) * v0_all
        los.append((base + _inner_min(nt, ri)) * nt.machine.ds
                   // nt.machine.cls)
        his.append((base + _inner_max(nt, ri)) * nt.machine.ds
                   // nt.machine.cls)
    lo = np.stack(los, axis=1)  # (trip, refs)
    hi = np.stack(his, axis=1)
    order = np.argsort(lo, axis=1)
    lo_s = np.take_along_axis(lo, order, axis=1)
    hi_s = np.take_along_axis(hi, order, axis=1)
    run_hi = np.maximum.accumulate(hi_s, axis=1)
    if (lo_s[:, 1:] > run_hi[:, :-1] + 1).any():
        return _check_exhaustive(
            nt, refs, "per-period line intervals leave a gap at some v0"
        )
    return None


_EXHAUSTIVE_CAP = int(2e8)


def _check_exhaustive(nt: NestTrace, refs: list, why: str) -> str | None:
    """Last-resort sound tier: enumerate (line, v0) touch pairs over
    the WHOLE parallel loop and verify every line's touch set is a
    v0-interval — the property all the analytic tiers imply. Directly
    sound for any c0 structure (an interval of v0 intersected with a
    thread's ordered period subsequence is a consecutive run of it).
    Affordable exactly when the cheaper tiers fail in practice:
    transposed single refs (A[j][i]) touch only ~N/linesize lines per
    period, so trip x per-period-lines stays small. Returns None on
    success; the caller's `why` when the property fails or the
    enumeration would exceed _EXHAUSTIVE_CAP pairs."""
    lp0 = nt.nest.loops[0]
    per_period = sum(
        int(np.prod([nt.nest.loops[l].trip
                     for l in range(1, int(nt.tables.ref_levels[ri]) + 1)],
                    dtype=np.int64))
        for ri in refs
    )
    if lp0.trip * per_period > _EXHAUSTIVE_CAP:
        return why + " (and the nest is too large to verify exhaustively)"
    chunks = []
    for qi in range(lp0.trip):
        v0 = lp0.start + qi * lp0.step
        ln = np.unique(np.concatenate(
            [_ref_period_lines(nt, ri, v0) for ri in refs]
        ))
        chunks.append(np.stack([ln, np.full_like(ln, qi)], axis=1))
    allp = np.concatenate(chunks)
    order = np.lexsort((allp[:, 1], allp[:, 0]))
    allp = allp[order]
    line, qq = allp[:, 0], allp[:, 1]
    new = np.concatenate([[True], line[1:] != line[:-1]])
    idx = np.cumsum(new) - 1
    n_lines = int(idx[-1]) + 1
    cnt = np.bincount(idx, minlength=n_lines)
    qmin = np.full(n_lines, 1 << 62)
    qmax = np.full(n_lines, -(1 << 62))
    np.minimum.at(qmin, idx, qq)
    np.maximum.at(qmax, idx, qq)
    if (cnt == qmax - qmin + 1).all():
        return None
    return why


def _inner_min(nt: NestTrace, ri: int) -> int:
    t = nt.tables
    out = 0
    for l in range(1, int(t.ref_levels[ri]) + 1):
        lp = nt.nest.loops[l]
        c = int(t.ref_coeffs[ri][l])
        vals = (lp.start, lp.start + (lp.trip - 1) * lp.step)
        out += min(c * vals[0], c * vals[1])
    return out


def _inner_max(nt: NestTrace, ri: int) -> int:
    t = nt.tables
    out = 0
    for l in range(1, int(t.ref_levels[ri]) + 1):
        lp = nt.nest.loops[l]
        c = int(t.ref_coeffs[ri][l])
        vals = (lp.start, lp.start + (lp.trip - 1) * lp.step)
        out += max(c * vals[0], c * vals[1])
    return out


def _phase_count(nt: NestTrace) -> int:
    """Distinct per-period structures induced by line-granule rounding.

    The grouping pattern of a period at parallel value v0 depends on
    (c0 * v0) mod (cls/ds) per ref: successive periods differ by
    c0 * step there, so the pattern is identical for EVERY period —
    one phase — exactly when (c0 * step) % granule == 0 for every ref
    (the constant c0 * start offset is shared by all periods and
    cancels). Otherwise v0 mod granule covers every possible class."""
    t = nt.tables
    g = max(1, nt.machine.cls // nt.machine.ds)
    step = nt.nest.loops[0].step
    if all(
        (int(t.ref_coeffs[ri][0]) * step) % g == 0
        for ri in range(t.n_refs)
    ):
        return 1
    return g


def _ref_period_lines(nt: NestTrace, ri: int, v0: int) -> np.ndarray:
    """All cache lines one ref touches during one period (host numpy)."""
    t = nt.tables
    level = int(t.ref_levels[ri])
    flat = np.asarray([int(t.ref_consts[ri]) + int(t.ref_coeffs[ri][0]) * v0])
    for l in range(1, level + 1):
        lp = nt.nest.loops[l]
        vals = lp.start + np.arange(lp.trip, dtype=np.int64) * lp.step
        flat = (flat[:, None] + int(t.ref_coeffs[ri][l]) * vals[None, :]).ravel()
    return flat * nt.machine.ds // nt.machine.cls


def _signatures(nt: NestTrace, tid: int):
    """The thread's period sequence as {(delta, phase): multiplicity}.

    delta = v0 of the next thread-local period minus this one's
    (None for the final period), phase = v0 mod the granule when phases
    matter. Multiplicities are exact; the engine evaluates one window
    per distinct key and scales.
    """
    sched = nt.schedule
    cnt = sched.local_count(tid)
    if cnt == 0:
        return {}
    m = np.arange(cnt, dtype=np.int64)
    K = nt.machine.chunk_size
    v0 = sched.start + (
        ((m // K) * sched.threads + tid) * K + (m % K)
    ) * sched.step
    phases = _phase_count(nt)
    ph = v0 % phases if phases > 1 else np.zeros_like(v0)
    out: dict = {}
    for i in range(cnt):
        delta = int(v0[i + 1] - v0[i]) if i + 1 < cnt else None
        # signature keys carry a representative v0 (the first with that
        # signature) — windows only need *a* v0 realizing the phase
        key = (delta, int(ph[i]))
        if key in out:
            out[key][1] += 1
        else:
            out[key] = [int(v0[i]), 1]
    return {k: (v[0], v[1]) for k, v in out.items()}


def _window_kernel_body(nt: NestTrace, max_share: int, pair: bool):
    """(v0a, v0b, device) -> histogram contributions of one window:
    (noshare_hist[64], sk[cap], sc[cap], n_unique, cold[n_arrays]),
    int64 tensors on the device.

    Window-relative positions (mrel 0/1) keep the packed keys narrow:
    grp_bits + ceil_log2(2 * period) + ref bits, independent of N's
    full trace length — which is what lets the periodic engine run at
    sizes whose full packed keys would not fit 63 bits. The single-
    device engine and the sharded form call the same body per window,
    so their outputs are the same integers.
    """
    from ..ops.sampled_hist import torch_vals

    t = nt.tables
    a0 = int(t.acc_per_level[0])
    n_arrays, max_addr, n_groups = nest_geometry(nt)
    pos_bits = _ceil_log2(2 * a0 + 1)
    grp_bits = _ceil_log2(n_groups + 1)
    rbits = ref_bits(nt)
    assert grp_bits + pos_bits + rbits <= 63, "window key overflow"
    n_m = 2 if pair else 1
    per_dev: dict = {}

    def kernel(v0a: int, v0b: int, dev):
        dev = torch.device(dev)
        if dev not in per_dev:
            per_dev[dev] = (nt.with_vals(torch_vals(nt.vals, dev)),
                            *share_tables(nt, dev))
        dnt, thr_t, ratio_t = per_dev[dev]
        v0 = torch.tensor([int(v0a), int(v0b)][:n_m], dtype=torch.int64,
                          device=dev)
        mrel = torch.arange(n_m, dtype=torch.int64, device=dev)
        valid_m = torch.ones(n_m, dtype=torch.bool, device=dev)
        key = torch.sort(torch.cat([
            packed_ref_keys(
                dnt, ri, v0, mrel, valid_m, pos_bits, max_addr, n_groups,
                rbits=rbits,
            )
            for ri in range(t.n_refs)
        ])).values
        ref_s, pos_s, grp_s, is_valid = sorted_fields(
            key, pos_bits, n_groups, rbits)
        del key
        same = same_as_prev(grp_s, is_valid)
        prev_pos = shifted(pos_s)
        reuse = torch.where(same, pos_s - prev_pos, 0)
        # sources live in the window's first period
        src_first = same & (prev_pos < a0)
        del prev_pos
        thr = thr_t[ref_s]
        is_share = src_first & (thr > 0) & (
            reuse.abs() > (reuse - thr).abs()
        )
        del thr
        noshare_hist = pow2_counts(reuse, src_first & ~is_share)
        sk, sc, n_unique = sorted_k_unique(
            reuse * 8 + ratio_t[ref_s], is_share, max_share)
        del reuse, is_share, ref_s, src_first
        # cold: first-period accesses with no same-line successor in
        # the window — by the skip-free property their line is never
        # touched again
        succ_same = torch.zeros_like(same)
        succ_same[:-1] = same[1:]
        arr_of = torch.where(is_valid, grp_s // max_addr, n_arrays)
        cold = per_array_count(is_valid & (pos_s < a0) & ~succ_same,
                               arr_of, n_arrays)
        return noshare_hist, sk, sc, n_unique, cold

    return kernel


@functools.lru_cache(maxsize=32)
def _compiled_nest(program: Program, nest_index: int,
                   machine: MachineConfig, max_share: int):
    trace = _validate_nest(program, nest_index, machine)
    nt = trace.nests[nest_index]
    return nt, {
        True: _window_kernel_body(nt, max_share, pair=True),
        False: _window_kernel_body(nt, max_share, pair=False),
    }


def validate_periodic(program: Program, machine: MachineConfig) -> None:
    """Raise NotImplementedError if any nest fails the preconditions."""
    for k in range(len(program.nests)):
        _validate_nest(program, k, machine)


def run_exact(program: Program, machine: MachineConfig,
              max_share: int = 64, mesh=None, device=None,
              spans: dict | None = None) -> OracleResult:
    """Fastest applicable exact engine: periodic when its
    preconditions hold, then the analytic closed-form engine
    (sampler/analytic.py — covers the periodic rejections: triangular
    nests and mixed parallel coefficients), then dense — whose own
    auto-route covers the memory ceiling by falling to stream. All of
    them produce bit-identical PRIStates, so callers wanting "the
    exact histogram, fast" need no engine knowledge. The CLI's
    `--engine exact` is this function; `res.engine` names the route.

    `mesh` (parallel/mesh.py::Mesh) runs whichever engine the router
    picks in its mesh-sharded form — bit-identical to the single-device
    run; `--shard` on the CLI is this parameter. The dense fallback
    shards only when the mesh size divides thread_num (its mesh axis is
    the simulated-thread axis). Runs on CUDA unless `device="cpu"` (or
    a mesh of CPU devices)."""
    try:
        validate_periodic(program, machine)
    except NotImplementedError:
        from .analytic import (
            run_analytic,
            validate_analytic,
            warn_if_unaudited,
        )

        try:
            validate_analytic(program, machine)
        except NotImplementedError:
            from .dense import run_dense

            if mesh is not None and machine.thread_num % mesh.size == 0:
                from ..parallel.sharded import run_dense_sharded

                res = run_dense_sharded(program, machine, mesh=mesh,
                                        max_share=max_share, spans=spans)
            else:
                dev = mesh.devices[0] if mesh is not None else device
                res = run_dense(program, machine, max_share, device=dev,
                                spans=spans)
            # run_dense itself may have auto-routed past its memory
            # ceiling; it reports nothing, so the label stays coarse
            res.engine = "dense"
            return res
        # the analytic engine's exactness is PROVEN only for the
        # audited model families; routing anything else says so
        warn_if_unaudited(program)
        res = run_analytic(program, machine, mesh=mesh, device=device,
                           spans=spans)
        res.engine = "analytic"
        return res
    if mesh is not None:
        from ..parallel.sharded import run_periodic_sharded

        res = run_periodic_sharded(program, machine, mesh, max_share,
                                   spans=spans)
    else:
        res = run_periodic(program, machine, max_share, device=device,
                           spans=spans)
    res.engine = "periodic"
    return res


def run_periodic(program: Program, machine: MachineConfig,
                 max_share: int = 64, window_eval=None, device=None,
                 spans: dict | None = None) -> OracleResult:
    """Periodic exact engine -> host PRIState (== run_dense exactly).
    Runs on CUDA unless `device="cpu"`.

    `window_eval(program, nest_index, nt, merged) -> {key: outputs}` is
    the evaluation hook the mesh-sharded path plugs in
    (parallel/sharded.py::run_periodic_sharded splits the merged
    windows over the shards); the default evaluates each merged window
    as one call on the device. Either way the per-window outputs — and
    hence the folded state — are the same integer results. `spans`
    gathers host seconds ("window_build", "kernel": the windows and
    their read backs, "fold"); spans["windows"] counts the windows.
    """
    dev = resolve_device(device) if window_eval is None else None
    P = machine.thread_num
    state = PRIState(P)
    per_tid = [0] * P
    for k in range(len(program.nests)):
        nt, kernels = _compiled_nest(program, k, machine, max_share)
        # windows are tid-independent: merge every tid's signature set,
        # evaluate each window once, then scale into each tid's state
        with _span(spans, "window_build"):
            merged: dict = {}
            per_tid_sigs = []
            for tid in range(P):
                sigs = _signatures(nt, tid)
                per_tid_sigs.append(sigs)
                for key, (v0_rep, _) in sigs.items():
                    merged.setdefault(key, v0_rep)
        if spans is not None:
            spans["windows"] = spans.get("windows", 0) + len(merged)
        with _span(spans, "kernel"):
            if window_eval is not None:
                outs = window_eval(program, k, nt, merged)
            else:
                outs = {}
                for (delta, ph), v0_rep in merged.items():
                    pair = delta is not None
                    v0b = v0_rep + (delta if pair else 0)
                    outs[(delta, ph)] = tuple(
                        o.cpu().numpy()
                        for o in kernels[pair](v0_rep, v0b, dev))
        with _span(spans, "fold"):
            for tid in range(P):
                h = state.noshare[tid]
                hs_all = state.share[tid]
                for key, (_v0, mult) in per_tid_sigs[tid].items():
                    noshare_hist, sk, sc, n_unique, cold = outs[key]
                    if int(n_unique) > sk.shape[0]:
                        raise RuntimeError(
                            "share-value capacity exceeded; raise "
                            f"max_share (needed {int(n_unique)}, have "
                            f"{sk.shape[0]})"
                        )
                    for e_idx in np.nonzero(noshare_hist)[0]:
                        kk = 1 << int(e_idx)
                        h[kk] = h.get(kk, 0.0) + float(
                            noshare_hist[e_idx]
                        ) * mult
                    c = int(cold.sum())
                    if c:
                        h[-1] = h.get(-1, 0.0) + float(c) * mult
                    for kv, cnt in zip(sk, sc):
                        if cnt > 0:
                            reuse, ratio = divmod(int(kv), 8)
                            hs = hs_all.setdefault(ratio, {})
                            hs[reuse] = hs.get(reuse, 0.0) + float(
                                cnt) * mult
                per_tid[tid] += nt.tid_length(tid)
    return OracleResult(
        state=state, total_accesses=sum(per_tid), per_tid_accesses=per_tid
    )
