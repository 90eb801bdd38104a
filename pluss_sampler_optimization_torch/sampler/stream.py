"""Streaming dense engine: exact full traversal at large N, on PyTorch.

Port of the JAX package's sampler/stream.py. sampler/dense.py
materializes each simulated thread's whole access stream for one sort —
at GEMM N=4096 that is ~7e10 accesses per thread, far beyond device
memory. This engine streams the same computation over chunks of the
parallel loop (the JAX package's `lax.scan` becomes a Python loop over
chunks, each step queued on the device):

- the carry holds, per (array, cache line), the line's last global
  access position — a dense int64 vector on the device replacing the
  reference's LAT hash maps (LAT_A/B/C, ...ri-omp-seq.cpp:47-49) — plus
  the running noshare histogram and access count, also on the device;
- each step enumerates one m-chunk, sorts it (chunk-local positions so
  the packed keys stay within 63 bits), measures within-chunk reuses as
  adjacent diffs, and joins chunk-boundary reuses against the carry:
  first-of-group accesses look up the carried last position, exactly
  `count[tid] - LAT[addr]` across the boundary (:110);
- share-classified intervals exit per step through the fixed-capacity
  unique reduction; each step's pairs stay on the device and are read
  back once per (nest, tid), as the JAX package's stacked scan outputs;
- after the last chunk, surviving carry entries flush as the per-array
  -1 cold counts (:305-319).

The result is bit-identical to sampler/dense.py at every chunk size,
while memory scales with the chunk, not the trace length.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import MachineConfig
from ..core.trace import NestTrace, ProgramTrace
from ..ir import Program
from ..ops.histogram import N_EXP_BINS, sorted_k_unique
from ..ops.sampled_hist import torch_vals
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
from ..runtime import telemetry
from .sampled import _span, resolve_device

# Per-chunk element budget: chunk_m = max(1, _ELEM_BUDGET // acc[0]).
_ELEM_BUDGET = 1 << 22


def _stream_nest_kernel(nt: NestTrace, chunk_m: int, max_share: int,
                        dev: torch.device):
    """One nest's per-tid scan over m-chunks on `dev`: returns
    (run_tid, fresh_carry, n_steps); run_tid(tid, last_pos) ->
    (nosh[64], (sk[S,cap], sc[S,cap], nu[S]), cold[n_arrays], n_acc),
    all on the device."""
    t = nt.tables
    sched = nt.schedule
    machine = nt.machine
    lmax = sched.max_local_count()
    n_arrays, max_addr, n_groups = nest_geometry(nt)
    n_steps = -(-lmax // chunk_m)
    # chunk-local positions for key packing (the full-trace position
    # would overflow 63 bits at large N); positions leave the packed
    # domain as plain int64 before reuse arithmetic
    if nt.tri:
        # max accesses any chunk_m-window of any thread performs
        b = nt.tri_base
        span = max(
            int((b[:, min(m0 + chunk_m, b.shape[1] - 1)] - b[:, m0]).max())
            for m0 in range(0, lmax, chunk_m)
        ) if lmax else 1
        pos_bits = _ceil_log2(span + 1)
        base_tab = torch.as_tensor(nt.tri_base, device=dev)
    else:
        a0 = int(t.acc_per_level[0])
        pos_bits = _ceil_log2(chunk_m * a0 + 1)
        base_tab = None
    grp_bits = _ceil_log2(n_groups + 1)
    rbits = ref_bits(nt)
    assert grp_bits + pos_bits + rbits <= 63, "key packing overflow"

    local_counts = [sched.local_count(tt) for tt in range(sched.threads)]
    thr_table, ratio_table = share_tables(nt, dev)
    dnt = nt.with_vals(torch_vals(nt.vals, dev))
    K = machine.chunk_size
    P = sched.threads
    step0, start0 = sched.step, sched.start
    # the invalid group's array index, for the final flush
    arr_of_grp = torch.arange(n_groups - 1, dtype=torch.int64,
                              device=dev) // max_addr

    def enumerate_chunk(tid, m0):
        """Sorted packed keys of the m-range [m0, m0+chunk_m)."""
        mrel = torch.arange(chunk_m, dtype=torch.int64, device=dev)
        m = m0 + mrel
        valid_m = m < local_counts[tid]
        v0 = start0 + (((m // K) * P + tid) * K + (m % K)) * step0
        base = (
            base_tab[tid, torch.clamp(m, max=lmax)] - base_tab[tid, m0]
            if nt.tri else None
        )
        return torch.sort(torch.cat([
            packed_ref_keys(
                dnt, ri, v0, mrel, valid_m, pos_bits, max_addr, n_groups,
                base=base, rbits=rbits,
            )
            for ri in range(t.n_refs)
        ])).values

    def step_fn(tid, carry, m0):
        last_pos, nosh, n_acc = carry
        key = enumerate_chunk(tid, m0)
        ref_s, pos_rel, grp_s, is_valid = sorted_fields(
            key, pos_bits, n_groups, rbits)
        del key
        # position in the thread's nest-local clock (reuse intervals are
        # position differences, so any constant offset cancels)
        chunk_base = base_tab[tid, m0] if nt.tri else m0 * a0
        pos_g = pos_rel + chunk_base
        same = same_as_prev(grp_s, is_valid)
        # chunk-boundary join: first-of-group looks up the carry
        carried = last_pos[grp_s]
        is_first = is_valid & ~same
        has_prev = same | (is_first & (carried >= 0))
        prev = torch.where(same, shifted(pos_g), carried)
        reuse = torch.where(has_prev, pos_g - prev, 0)
        thr = thr_table[ref_s]
        is_share = has_prev & (thr > 0) & (
            reuse.abs() > (reuse - thr).abs()
        )
        nosh = nosh + pow2_counts(reuse, has_prev & ~is_share)
        sk, sc, nu = sorted_k_unique(
            reuse * 8 + ratio_table[ref_s], is_share, max_share)
        # carry update: last touch per group (positions ascend in-group;
        # invalid entries scatter -1 into the invalid group, a no-op)
        last_pos = last_pos.scatter_reduce(
            0, grp_s, torch.where(is_valid, pos_g, -1), "amax")
        n_acc = n_acc + is_valid.sum()
        return (last_pos, nosh, n_acc), (sk, sc, nu)

    def run_tid(tid, last_pos):
        """Scan all chunks of one (tid, nest); returns the final carry's
        histogram, the stacked per-step pairs, the cold flush and the
        access count."""
        carry = (last_pos,
                 torch.zeros(N_EXP_BINS, dtype=torch.int64, device=dev),
                 torch.zeros((), dtype=torch.int64, device=dev))
        ys = []
        for step in range(n_steps):
            carry, y = step_fn(tid, carry, step * chunk_m)
            ys.append(y)
        last_pos, nosh, n_acc = carry
        # -1 flush: surviving lines per array (...ri-omp-seq.cpp:305-319)
        cold = per_array_count(last_pos[:-1] >= 0, arr_of_grp, n_arrays)
        ys = tuple(torch.stack([y[i] for y in ys]) for i in range(3))
        return nosh, ys, cold, n_acc

    def fresh_carry():
        return torch.full((n_groups,), -1, dtype=torch.int64, device=dev)

    return run_tid, fresh_carry, n_steps


def _stream_kernels(program: Program, machine: MachineConfig,
                    chunk_m: int | None, max_share: int, dev):
    trace = ProgramTrace(program, machine)
    kernels = []
    for nt in trace.nests:
        cm = chunk_m or max(1, _ELEM_BUDGET // max(1, nt.max_body0))
        cm = min(cm, max(1, nt.schedule.max_local_count()))
        kernels.append(_stream_nest_kernel(nt, cm, max_share, dev))
    return trace, kernels


def run_stream(
    program: Program,
    machine: MachineConfig,
    chunk_m: int | None = None,
    max_share: int = 64,
    device=None,
    spans: dict | None = None,
) -> OracleResult:
    """Streaming dense engine -> OracleResult (== run_dense exactly).
    Runs on CUDA unless `device="cpu"`; `spans` gathers host seconds
    ("dispatch": the queued steps, "fetch": the read backs, "fold")."""
    dev = resolve_device(device)
    trace, kernels = _stream_kernels(program, machine, chunk_m, max_share,
                                     dev)
    P = machine.thread_num
    state = PRIState(P)
    per_tid = [0] * P
    engine_span = telemetry.span("engine", engine="stream")
    engine_span.__enter__()
    for nest_k, (run_tid, fresh_carry, _) in enumerate(kernels):
        for tid in range(P):
            with telemetry.span("scan", nest=nest_k, tid=tid):
                telemetry.count("dispatches")
                with _span(spans, "dispatch", tele=None):
                    out = run_tid(tid, fresh_carry())
                with _span(spans, "fetch"):
                    nosh, ys, cold, n_acc = telemetry.record_fetch((
                        out[0].cpu().numpy(),
                        tuple(y.cpu().numpy() for y in out[1]),
                        out[2].cpu().numpy(), out[3].cpu().numpy(),
                    ))
                    n_acc = int(n_acc)
            with _span(spans, "fold", tele=None):
                sk, sc, nu = ys
                if int(nu.max(initial=0)) > sk.shape[1]:
                    raise RuntimeError(
                        "share-value capacity exceeded; raise max_share "
                        f"(needed {int(nu.max())}, have {sk.shape[1]})"
                    )
                h = state.noshare[tid]
                for e_idx in np.nonzero(nosh)[0]:
                    key = 1 << int(e_idx)
                    h[key] = h.get(key, 0.0) + float(nosh[e_idx])
                c = int(cold.sum())
                if c:
                    h[-1] = h.get(-1, 0.0) + float(c)
                for s in range(sk.shape[0]):
                    for key, cnt in zip(sk[s], sc[s]):
                        if cnt > 0:
                            reuse, ratio = divmod(int(key), 8)
                            hs = state.share[tid].setdefault(ratio, {})
                            hs[reuse] = hs.get(reuse, 0.0) + float(cnt)
                per_tid[tid] += int(n_acc)
    engine_span.__exit__(None, None, None)
    return OracleResult(
        state=state, total_accesses=sum(per_tid), per_tid_accesses=per_tid
    )
