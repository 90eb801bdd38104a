"""Dense (full-traversal) exact engine on PyTorch.

Port of the JAX package's sampler/dense.py, the twin of the reference's
full-traversal samplers (`ri`/`ri-omp`/`ri-omp-seq`/`ri-opt`,
c_lib/test/sampler/): every access of every simulated thread is
enumerated and its reuse interval measured exactly. The hash-map walk
becomes one sort per (thread, nest):

  1. enumerate each reference's iteration grid -> (position, line) pairs
     (closed forms, core/trace.py);
  2. pack (group=(array,line), position, ref) into one int64 key; a
     single ascending sort then places consecutive accesses to the same
     line next to each other in trace order;
  3. reuse intervals are adjacent position differences within groups —
     exactly `count[tid] - LAT_X[tid][addr]` (...ri-omp-seq.cpp:110);
  4. scatter-add into dense pow2 histograms; share-classified intervals
     go through a fixed-capacity exact unique reduction; group starts
     (cold lines) count into the per-array -1 totals (:305-319).

Each simulated thread is one independent sort on its device (the JAX
package vmaps them; the `ri` variant's `#pragma omp parallel for` over
tids, ...ri.cpp:67-68); the mesh-sharded form (parallel/sharded.py::
run_dense_sharded) puts each shard's tids on its own device. Thread
ragged-ness (short/missing last chunks) is handled by masking padded
entries into a dedicated invalid group. Every step is plain torch
(`torch.sort`, `index_add_`): each has an exact equivalent of the JAX
package's XLA op, so the outputs are the same integers.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import MachineConfig
from ..core.trace import NestTrace, ProgramTrace
from ..ir import Program
from ..ops.histogram import N_EXP_BINS, exp_bin, sorted_k_unique
from ..ops.sampled_hist import torch_vals
from ..oracle.serial import OracleResult
from ..runtime.hist import PRIState
from .sampled import _span, resolve_device

_REF_BITS = 5  # up to 32 refs per nest


def _ceil_log2(x: int) -> int:
    return max(1, int(x - 1).bit_length())


def ref_bits(nt: NestTrace) -> int:
    """Bits of a packed key's ref field: the JAX package's _REF_BITS (32
    refs), more for a nest of more refs. The JAX package packs every
    nest with 5 bits, so past 32 refs (the frontend accepts 64) its ref
    indices run into the position field and its dense, stream and
    periodic engines fold wrong states; here the field grows instead."""
    return max(_REF_BITS, _ceil_log2(nt.tables.n_refs))


def nest_geometry(nt: NestTrace):
    """(n_arrays, max_addr, n_groups) for the packed-key group space.

    Validates the packing preconditions: negative flats would corrupt
    the packed sort keys, and share ratios must fit the radix-8 share
    key. Shared by the one-shot (this module) and streaming
    (sampler/stream.py) dense engines.
    """
    t = nt.tables
    machine = nt.machine
    n_arrays = int(t.ref_arrays.max()) + 1 if t.n_refs else 1
    max_addr = 1
    for ri in range(t.n_refs):
        level = int(t.ref_levels[ri])
        hi = int(t.ref_consts[ri])
        lo = int(t.ref_consts[ri])
        for l in range(level + 1):
            c = int(t.ref_coeffs[ri][l])
            lo_v, hi_v = nt.level_value_range(l)
            hi += max(c * lo_v, c * hi_v)
            lo += min(c * lo_v, c * hi_v)
        if lo < 0:
            raise NotImplementedError(
                f"ref {t.ref_names[ri]}: affine map can reach negative "
                f"element index {lo}; negative addresses are unsupported"
            )
        if int(t.ref_share_ratios[ri]) >= 8:
            raise NotImplementedError(
                f"ref {t.ref_names[ri]}: share ratio "
                f"{int(t.ref_share_ratios[ri])} >= 8 does not fit the "
                "packed share key (radix 8)"
            )
        max_addr = max(max_addr, hi * machine.ds // machine.cls + 1)
    return n_arrays, max_addr, n_arrays * max_addr + 1  # +1 invalid group


def packed_ref_keys(
    nt: NestTrace, ri: int, v0, mrel, valid_m, pos_bits: int,
    max_addr: int, n_groups: int, base=None, rbits: int = _REF_BITS,
):
    """Packed (group, position, ref) sort keys of one ref's accesses
    over an m-grid, as a flat int64 tensor on v0's device.

    `v0` are the parallel-loop values, `mrel` the position-relative
    parallel indices (equal to the thread-local m for the one-shot
    engine, chunk-relative for the streaming engine), `valid_m` the
    raggedness mask. Invalid entries land in group n_groups-1.

    Triangular nests pass `base` — the position-relative access base of
    each m (a tri_base gather) replacing mrel * acc[0]; inner grids pad
    to the nest-wide max trip and mask the dead tail, and positions go
    through tri_position. `nt.vals` must be an overlay of tensors on
    v0's device (ops/sampled_hist.py::torch_vals).
    """
    t = nt.tables
    machine = nt.machine
    dev = v0.device
    level = int(t.ref_levels[ri])
    c = t.ref_coeffs[ri]

    def arange(n):
        return torch.arange(int(n), dtype=torch.int64, device=dev)

    if nt.tri:
        assert base is not None, "triangular packed keys need a base"
        if level == 0:
            pos = nt.tri_position(ri, v0, base)
            flat = v0 * int(c[0]) + int(t.ref_consts[ri])
            valid = valid_m
        else:
            lp1 = nt.nest.loops[1]
            t1v = nt.trip_at(1, v0)
            n1 = arange(nt.max_trips[1])
            v1 = lp1.start_at(v0)[:, None] + n1[None, :] * lp1.step
            valid = valid_m[:, None] & (n1[None, :] < t1v[:, None])
            if level == 1:
                pos = nt.tri_position(ri, v0[:, None], base[:, None],
                                      n1[None, :])
                flat = (
                    v0[:, None] * int(c[0])
                    + v1 * int(c[1])
                    + int(t.ref_consts[ri])
                )
            else:
                lp2 = nt.nest.loops[2]
                t2v = nt.trip_at(2, v0)
                n2 = arange(nt.max_trips[2])
                v2 = (lp2.start_at(v0)[:, None, None]
                      + n2[None, None, :] * lp2.step)
                valid = valid[:, :, None] & (
                    n2[None, None, :] < t2v[:, None, None]
                )
                pos = nt.tri_position(
                    ri, v0[:, None, None], base[:, None, None],
                    n1[None, :, None], n2[None, None, :],
                )
                flat = (
                    v0[:, None, None] * int(c[0])
                    + v1[:, :, None] * int(c[1])
                    + v2 * int(c[2])
                    + int(t.ref_consts[ri])
                )
        pos = torch.broadcast_to(pos, valid.shape)
        flat = torch.broadcast_to(flat, valid.shape)
        # masked entries carry pos 0 so the packed key stays in range
        pos = torch.where(valid, pos, 0)
    elif level == 0:
        a0 = int(t.acc_per_level[0])
        off = int(t.ref_offsets[ri])
        pos = mrel * a0 + off
        flat = v0 * int(c[0]) + int(t.ref_consts[ri])
        valid = valid_m
    elif level == 1:
        a0 = int(t.acc_per_level[0])
        off = int(t.ref_offsets[ri])
        t1 = nt.nest.loops[1]
        n1 = arange(t1.trip)
        v1 = t1.start + n1 * t1.step
        pos = (
            mrel[:, None] * a0
            + int(nt.npre[0])
            + n1[None, :] * int(t.acc_per_level[1])
            + off
        )
        flat = (
            v0[:, None] * int(c[0])
            + v1[None, :] * int(c[1])
            + int(t.ref_consts[ri])
        )
        valid = torch.broadcast_to(valid_m[:, None], pos.shape)
    else:
        a0 = int(t.acc_per_level[0])
        off = int(t.ref_offsets[ri])
        t1, t2 = nt.nest.loops[1], nt.nest.loops[2]
        n1 = arange(t1.trip)
        n2 = arange(t2.trip)
        v1 = t1.start + n1 * t1.step
        v2 = t2.start + n2 * t2.step
        pos = (
            mrel[:, None, None] * a0
            + int(nt.npre[0])
            + n1[None, :, None] * int(t.acc_per_level[1])
            + int(nt.npre[1])
            + n2[None, None, :] * int(t.acc_per_level[2])
            + off
        )
        flat = (
            v0[:, None, None] * int(c[0])
            + v1[None, :, None] * int(c[1])
            + v2[None, None, :] * int(c[2])
            + int(t.ref_consts[ri])
        )
        valid = torch.broadcast_to(valid_m[:, None, None], pos.shape)
    addr = flat * machine.ds // machine.cls
    grp = torch.where(
        valid, int(t.ref_arrays[ri]) * max_addr + addr, n_groups - 1
    )
    key = (((grp << pos_bits) | pos.to(torch.int64)) << rbits) | ri
    return key.reshape(-1)


def sorted_fields(key, pos_bits: int, n_groups: int,
                  rbits: int = _REF_BITS):
    """(ref, position, group, valid) columns of sorted packed keys (a
    ref field of `rbits`, ref_bits of the nest)."""
    ref_s = key & ((1 << rbits) - 1)
    pos_s = (key >> rbits) & ((1 << pos_bits) - 1)
    grp_s = key >> (rbits + pos_bits)
    return ref_s, pos_s, grp_s, grp_s != (n_groups - 1)


def same_as_prev(grp_s, is_valid):
    """Entry i continues entry i-1's group (False for the first)."""
    same = torch.zeros_like(is_valid)
    same[1:] = (grp_s[1:] == grp_s[:-1]) & is_valid[1:]
    return same


def shifted(x):
    """x moved one place later, 0 first: each entry's predecessor."""
    out = torch.zeros_like(x)
    out[1:] = x[:-1]
    return out


def pow2_counts(reuse, weight):
    """Dense 64-bin pow2 histogram of max(reuse, 1) counting `weight`
    (a bool mask), int64."""
    e = exp_bin(torch.clamp(reuse, min=1))
    return torch.zeros(N_EXP_BINS, dtype=torch.int64,
                       device=reuse.device).index_add_(
        0, e, weight.to(torch.int64))


def per_array_count(mask, arr_of, n_arrays: int):
    """How many entries of `mask` fall in each array (int64 [n_arrays])."""
    idx = torch.where(mask, arr_of, n_arrays)
    return torch.zeros(n_arrays + 1, dtype=torch.int64,
                       device=mask.device).index_add_(
        0, idx, torch.ones_like(idx))[:n_arrays]


def share_tables(nt: NestTrace, device):
    """(thresholds, ratios) per ref as int64 tensors on `device`."""
    t = nt.tables
    return (
        torch.as_tensor(np.asarray(t.ref_share_thresholds, np.int64),
                        device=device),
        torch.as_tensor(np.asarray(t.ref_share_ratios, np.int64),
                        device=device),
    )


class _DenseNest:
    """One nest's per-tid sort body (the JAX package's vmapped per_tid):
    tid -> (noshare_hist[64], share keys[cap], share counts[cap],
    n_unique, cold[n_arrays], n_acc), int64 tensors on the tid's device.
    """

    def __init__(self, nt: NestTrace, max_share: int):
        t = nt.tables
        sched = nt.schedule
        self.nt = nt
        self.max_share = max_share
        self.lmax = sched.max_local_count()
        self.local_counts = [sched.local_count(tt)
                             for tt in range(sched.threads)]
        self.n_arrays, self.max_addr, self.n_groups = nest_geometry(nt)
        pos_bound = max(
            (nt.tid_length(tt) for tt in range(sched.threads)), default=1
        )
        self.pos_bits = _ceil_log2(pos_bound + 1)
        grp_bits = _ceil_log2(self.n_groups + 1)
        self.rbits = ref_bits(nt)
        assert grp_bits + self.pos_bits + self.rbits <= 63, (
            "key packing overflow")
        self.n_refs = t.n_refs
        self._dev: dict = {}

    def _on(self, dev):
        """The value overlay, share tables and base table on `dev`."""
        if dev not in self._dev:
            nt = self.nt
            self._dev[dev] = (
                nt.with_vals(torch_vals(nt.vals, dev)),
                *share_tables(nt, dev),
                torch.as_tensor(nt.tri_base, device=dev) if nt.tri
                else None,
            )
        return self._dev[dev]

    def __call__(self, tid: int, dev):
        nt = self.nt
        sched = nt.schedule
        dnt, thr_t, ratio_t, base_tab = self._on(dev)
        K, P = nt.machine.chunk_size, sched.threads
        m = torch.arange(self.lmax, dtype=torch.int64, device=dev)
        valid_m = m < self.local_counts[tid]
        v0 = sched.start + (((m // K) * P + tid) * K + (m % K)) * sched.step
        base = base_tab[tid, :self.lmax] if nt.tri else None
        key = torch.sort(torch.cat([
            packed_ref_keys(dnt, ri, v0, m, valid_m, self.pos_bits,
                            self.max_addr, self.n_groups, base=base,
                            rbits=self.rbits)
            for ri in range(self.n_refs)
        ])).values
        ref_s, pos_s, grp_s, is_valid = sorted_fields(
            key, self.pos_bits, self.n_groups, self.rbits)
        del key
        same = same_as_prev(grp_s, is_valid)
        reuse = torch.where(same, pos_s - shifted(pos_s), 0)
        thr = thr_t[ref_s]
        is_share = same & (thr > 0) & (reuse.abs() > (reuse - thr).abs())
        noshare_hist = pow2_counts(reuse, same & ~is_share)
        # share: pack (reuse, ratio) so one unique pass keeps both
        sk, sc, n_unique = sorted_k_unique(
            reuse * 8 + ratio_t[ref_s], is_share, self.max_share)
        # cold lines: first element of each valid group, per array
        arr_of = torch.where(is_valid, grp_s // self.max_addr,
                             self.n_arrays)
        cold = per_array_count(is_valid & ~same, arr_of, self.n_arrays)
        n_acc = is_valid.sum()
        return noshare_hist, sk, sc, n_unique, cold, n_acc


def dense_nest_outputs(program: Program, machine: MachineConfig,
                       max_share: int = 64, tid_devices=None,
                       device=None) -> list:
    """Per-nest, per-tid outputs as host numpy arrays, each nest's
    stacked over tids: [(noshare[P,64], sk[P,cap], sc[P,cap],
    n_unique[P], cold[P,n_arrays], n_acc[P]), ...]. `tid_devices[tid]`
    is the device that sorts thread tid (default: every tid on
    `device`); a nest's tids are all launched before its outputs are
    read back."""
    trace = ProgramTrace(program, machine)
    P = machine.thread_num
    if tid_devices is None:
        tid_devices = [resolve_device(device)] * P
    outs = []
    for nt in trace.nests:
        body = _DenseNest(nt, max_share)
        per_tid = [body(tid, tid_devices[tid]) for tid in range(P)]
        host = [
            tuple(x.cpu() for x in o) for o in per_tid
        ]
        outs.append(tuple(
            torch.stack([h[i] for h in host]).numpy() for i in range(6)
        ))
    return outs


def dense_bytes_estimate(program: Program, machine: MachineConfig) -> int:
    """Predicted peak bytes of the one-shot dense sort, from the trace
    geometry alone: per nest, the vmapped kernel materializes every
    tid's padded per-ref grids as int64 keys (lmax x inner sizes,
    packed_ref_keys), concatenates, and sorts — XLA holds roughly the
    keys plus the sorted copy plus the derived pos/grp/ref columns, so
    4x the key bytes is the working-set estimate the router uses."""
    trace = ProgramTrace(program, machine)
    total = 0
    for nt in trace.nests:
        sched = nt.schedule
        lmax = sched.max_local_count()
        per_m = 0
        for ri in range(nt.tables.n_refs):
            sz = 1
            for l in range(1, int(nt.tables.ref_levels[ri]) + 1):
                sz *= (nt.max_trips[l] if nt.tri
                       else nt.nest.loops[l].trip)
            per_m += sz
        total += machine.thread_num * lmax * per_m
    return total * 8 * 4


def _available_bytes(device=None) -> int:
    """Free memory where the sort runs: the card's free bytes on CUDA,
    the host's MemAvailable on the CPU."""
    if device is not None and torch.device(device).type == "cuda":
        return int(torch.cuda.mem_get_info(torch.device(device))[0])
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 1 << 62  # unknown: never route


def run_dense(program: Program, machine: MachineConfig,
              max_share: int = 64, tid_devices=None,
              auto_route: bool = True, device=None,
              spans: dict | None = None) -> OracleResult:
    """Dense exact engine -> host PRIState (same shape as the oracles).
    Runs on CUDA unless `device="cpu"`.

    With `auto_route` (default), a run whose predicted sort working
    set exceeds the free memory where it sorts (the card's on CUDA,
    the host's on the CPU) is routed to an equivalent exact engine
    instead: the periodic engine when its preconditions hold, else the
    streaming engine. Both produce bit-identical PRIStates.
    `tid_devices` (the sharded form's per-tid devices) disables the
    route, as the JAX package's tid sharding does.
    """
    dev = resolve_device(device if tid_devices is None
                         else tid_devices[0])
    if auto_route and tid_devices is None:
        est = dense_bytes_estimate(program, machine)
        avail = _available_bytes(dev)
        if est > 0.6 * avail:
            from .periodic import run_periodic, validate_periodic

            try:
                validate_periodic(program, machine)
                routed = "periodic"
            except NotImplementedError:
                routed = "stream"
            print(
                f"dense: predicted sort working set "
                f"{est / 1e9:.0f} GB exceeds available "
                f"{avail / 1e9:.0f} GB; routing to the {routed} "
                "engine (bit-identical output)",
                file=sys.stderr,
            )
            if routed == "periodic":
                return run_periodic(program, machine, max_share,
                                    device=dev, spans=spans)
            from .stream import run_stream

            return run_stream(program, machine, max_share=max_share,
                              device=dev, spans=spans)
    with _span(spans, "dispatch"):
        outs = dense_nest_outputs(program, machine, max_share,
                                  tid_devices, dev)
    with _span(spans, "fold"):
        return _fold_dense_outputs(machine, outs)


def _fold_dense_outputs(machine: MachineConfig, outs) -> OracleResult:
    P = machine.thread_num
    state = PRIState(P)
    per_tid = [0] * P
    for (noshare, sk, sc, n_unique, cold, n_acc) in outs:
        if int(n_unique.max(initial=0)) > sk.shape[1]:
            raise RuntimeError(
                "share-value capacity exceeded; raise max_share "
                f"(needed {int(n_unique.max())}, have {sk.shape[1]})"
            )
        for tid in range(P):
            h = state.noshare[tid]
            for e_idx in np.nonzero(noshare[tid])[0]:
                key = 1 << int(e_idx)
                h[key] = h.get(key, 0.0) + float(noshare[tid][e_idx])
            c = int(cold[tid].sum())
            if c:
                h[-1] = h.get(-1, 0.0) + float(c)
            for key, cnt in zip(sk[tid], sc[tid]):
                if cnt > 0:
                    reuse, ratio = divmod(int(key), 8)
                    hs = state.share[tid].setdefault(ratio, {})
                    hs[reuse] = hs.get(reuse, 0.0) + float(cnt)
            per_tid[tid] += int(n_acc[tid])
    return OracleResult(
        state=state, total_accesses=sum(per_tid), per_tid_accesses=per_tid
    )
