"""Per-simulated-thread trace codec: the state machine as index math.

The reference walks the interleaved iteration space with a per-thread
state machine (`Progress` cursor + while(true) dispatch,
...ri-omp-seq.cpp:68-301) and counts accesses in `count[tid]`
(:45, incremented once per access). Two facts make that walk a
closed-form indexed sequence:

1. `count[tid]` IS the thread-local trace position: every access of
   simulated thread t increments only count[t], so the "time" recorded
   in the last-access tables (LAT_X[tid][addr] = count[tid], :119) is
   the position of that access in t's own stream, and a reuse interval
   (:110) is a difference of positions in that stream.
2. The stream itself is a mixed-radix enumeration of the loop nest:
   thread t executes its chunks in dispatch order
   (getNextStaticChunk, pluss_utils.h:410-425), and each parallel-loop
   iteration performs the same statically-known body access sequence
   (the ri-opt variant already straight-lines it,
   ...ri-opt.cpp:101-263).

So position(t, m, n1, n2, ref) =
    m * acc[0] + npre[0] + n1 * acc[1] + npre[1] + n2 * acc[2] + off(ref)
(terms beyond the ref's level dropped), where m is the thread-local
index of the parallel iteration, n_l the normalized inner indices,
acc[l] the per-level body access counts and off the ref's offset within
its level's body. Interleaving across simulated threads never enters RI
values — it only exists in the CRI probability model, exactly as in the
reference.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..config import MachineConfig
from ..ir import NestTables, Program, nest_tables
from .schedule import StaticSchedule


class NestTrace:
    """Static trace geometry of one parallel nest."""

    def __init__(self, program: Program, nest_index: int, machine: MachineConfig):
        self.machine = machine
        self.nest = program.nests[nest_index]
        self.tables: NestTables = nest_tables(
            program, nest_index, machine.thread_num - 1
        )
        lp0 = self.nest.loops[0]
        self.schedule = StaticSchedule(
            trip=lp0.trip,
            chunk=machine.chunk_size,
            threads=machine.thread_num,
            start=lp0.start,
            step=lp0.step,
        )
        self.npre = tuple(
            len(self.nest.refs_at(l, "pre")) for l in range(self.nest.depth)
        )
        self.npost = tuple(
            len(self.nest.refs_at(l, "post")) for l in range(self.nest.depth)
        )
        # The value overlay: every N-dependent number the TRACED engine
        # code reads, as arrays. Host engines read the same concrete
        # numpy defaults (identical numerics); the sampled kernels swap
        # in traced jnp arrays via with_vals() so one compiled kernel
        # serves every N with the same structure (sampler/sampled.py::
        # _kernel_sig). Structure (levels, steps, slots, npre, ...)
        # always comes from the concrete fields. Built before the
        # triangular tables: body_at/trip_at read it.
        t = self.tables
        self.vals = {
            "acc": t.acc_per_level,
            "off": t.ref_offsets,
            "coeff": t.ref_coeffs,
            "const": t.ref_consts,
            "thr": t.ref_share_thresholds,
            "trips": t.trips,
            "startb": t.starts,
            "lc": np.array(
                [self.schedule.local_count(tt) for tt in range(
                    self.schedule.threads)],
                dtype=np.int64,
            ),
            "vlo": np.array(
                [self.level_value_range(l)[0] for l in range(self.nest.depth)]
                + [0] * (len(t.trips) - self.nest.depth),
                dtype=np.int64,
            ),
            "vhi": np.array(
                [self.level_value_range(l)[1] for l in range(self.nest.depth)]
                + [0] * (len(t.trips) - self.nest.depth),
                dtype=np.int64,
            ),
        }
        # Triangular nests (inner bounds affine in the parallel value):
        # body sizes vary per parallel iteration, so the per-thread
        # position bases are prefix sums over the thread's dispatch
        # order instead of m * acc[0]. The table is small (threads x
        # local parallel iterations) and shared by every engine.
        self.tri = self.nest.is_triangular
        if self.tri:
            P = self.schedule.threads
            lmax = self.schedule.max_local_count()
            base = np.zeros((P, lmax + 1), dtype=np.int64)
            for tid in range(P):
                lc = self.schedule.local_count(tid)
                if lc:
                    m = np.arange(lc, dtype=np.int64)
                    v0 = self.schedule.local_to_value(tid, m)
                    base[tid, 1 : lc + 1] = np.cumsum(self.body_at(0, v0))
                base[tid, lc + 1 :] = base[tid, lc]
            self.tri_base = base
            v0_all = lp0.start + np.arange(lp0.trip, dtype=np.int64) * lp0.step
            self.max_trips = tuple(
                int(np.max(self.trip_at(l, v0_all)))
                for l in range(self.nest.depth)
            )
            self.max_body0 = int(np.max(self.body_at(0, v0_all)))
        else:
            self.max_trips = tuple(lp.trip for lp in self.nest.loops)
            self.max_body0 = int(self.acc[0])
        if self.tri:
            self.vals["tri_base"] = self.tri_base

    def with_vals(self, vals: dict) -> "NestTrace":
        """Shallow copy with the value overlay swapped (traced arrays
        inside a jit; concrete arrays otherwise). Structural fields are
        shared with self and MUST agree with the overlay's provenance —
        the kernel signature (sampler/sampled.py::_kernel_sig) is the
        contract that makes a structure-equal trace's values safe here."""
        import copy

        c = copy.copy(self)
        c.vals = vals
        return c

    @property
    def acc(self) -> np.ndarray:
        return self.tables.acc_per_level

    def trip_at(self, level: int, v0):
        """Level trip count at parallel value v0 (elementwise).

        Reads the trip base from the value overlay so traced kernels
        stay N-generic; the affine coefficient is structural."""
        tc = int(self.tables.trip_coeffs[level])
        base = self.vals["trips"][level]
        if tc == 0:
            return v0 * 0 + base
        return (base + tc * v0).clip(0)

    def start_at(self, level: int, v0):
        """First iteration value of a level at parallel value v0
        (elementwise; overlay-aware twin of Loop.start_at)."""
        sc = int(self.tables.start_coeffs[level])
        return self.vals["startb"][level] + sc * v0

    def body_at(self, level: int, v0):
        """Accesses of ONE full level-`level` iteration at parallel
        value v0 (elementwise over arrays; constant when rectangular)."""
        n = self.npre[level] + self.npost[level]
        if level + 1 < self.nest.depth:
            n = n + self.trip_at(level + 1, v0) * self.body_at(level + 1, v0)
        return n

    def ref_offset_at(self, ref_idx: int, v0):
        """Body offset of a ref within its level's iteration at v0."""
        r = self.nest.refs[ref_idx]
        pre = self.nest.refs_at(r.level, "pre")
        if r.slot == "pre":
            return pre.index(r)
        inner = (
            self.trip_at(r.level + 1, v0) * self.body_at(r.level + 1, v0)
            if r.level + 1 < self.nest.depth
            else 0
        )
        return len(pre) + inner + self.nest.refs_at(r.level, "post").index(r)

    def tri_position(self, ref_idx: int, v0, base, n1=0, n2=0):
        """Thread-local position in a triangular nest.

        `base` = accesses the thread performed before this parallel
        iteration (tri_base[tid, m] or a traced gather of it), `v0` the
        parallel value; elementwise over arrays.
        """
        lv = int(self.tables.ref_levels[ref_idx])
        p = base + self.ref_offset_at(ref_idx, v0)
        if lv >= 1:
            p = p + self.npre[0] + n1 * self.body_at(1, v0)
        if lv >= 2:
            p = p + self.npre[1] + n2 * self.body_at(2, v0)
        return p

    def level_value_range(self, level: int) -> tuple[int, int]:
        """[min, max] iteration value a level can take across the nest
        (exact for triangular levels: evaluated over the parallel
        values that give the level at least one iteration)."""
        lp = self.nest.loops[level]
        if level == 0 or not lp.is_triangular:
            return min(lp.start, lp.last), max(lp.start, lp.last)
        lp0 = self.nest.loops[0]
        v0 = lp0.start + np.arange(lp0.trip, dtype=np.int64) * lp0.step
        trips = lp.trip_at(v0)
        live = trips > 0
        if not live.any():
            return lp.start, lp.start
        first = lp.start_at(v0[live])
        last = first + (trips[live] - 1) * lp.step
        return int(min(first.min(), last.min())), int(
            max(first.max(), last.max())
        )

    def tid_length(self, tid: int) -> int:
        """Total accesses simulated thread `tid` performs in this nest."""
        if self.tri:
            return int(self.tri_base[tid, self.schedule.local_count(tid)])
        return self.schedule.local_count(tid) * int(self.acc[0])

    def access_position(self, ref_idx: int, m, n1=0, n2=0, rx=None):
        """Thread-local position of one access; elementwise over arrays.

        `m` is the thread-local parallel-iteration index; n1/n2 are
        normalized inner-loop indices (ignored beyond the ref's level).
        Rectangular nests only — triangular positions need the
        per-thread base table (tri_position). `rx` (default ref_idx)
        is the index used for VALUE lookups — a traced scalar in the
        shared sampled kernels, letting structurally identical refs
        (same level/array) reuse one compile while their offsets ride
        in as operands; ref_idx always supplies the static structure.
        """
        if self.tri:
            raise NotImplementedError(
                "access_position is undefined for triangular nests; "
                "use tri_position with tri_base"
            )
        rx = ref_idx if rx is None else rx
        level = int(self.tables.ref_levels[ref_idx])
        acc = self.vals["acc"]
        p = m * acc[0] + self.vals["off"][rx]
        if level >= 1:
            p = p + self.npre[0] + n1 * acc[1]
        if level >= 2:
            p = p + self.npre[1] + n2 * acc[2]
        return p

    def ref_flat(self, ref_idx: int, v0, v1=0, v2=0):
        """Affine flat element index from loop *values* (not normalized)."""
        c = self.vals["coeff"][ref_idx]
        return v0 * c[0] + v1 * c[1] + v2 * c[2] + self.vals["const"][ref_idx]

    def ref_addr(self, ref_idx: int, v0, v1=0, v2=0):
        """Cache-line address: flat*DS//CLS (GetAddress_*, ...ri-omp-seq.cpp:12-35)."""
        m = self.machine
        return self.ref_flat(ref_idx, v0, v1, v2) * m.ds // m.cls

    def iter_values(self, level: int, n):
        lp = self.nest.loops[level]
        return lp.start + n * lp.step

    def ref_space(self, ref_idx: int) -> tuple[int, ...]:
        """Iteration-space shape of one ref (trips of its enclosing loops)."""
        level = int(self.tables.ref_levels[ref_idx])
        return tuple(lp.trip for lp in self.nest.loops[: level + 1])

    def enumerate_ref(
        self, tid: int, ref_idx: int, schedule=None,
        m_lo: int = 0, m_hi: int | None = None,
    ):
        """All accesses of (tid, ref): returns (positions, addrs) int64.

        Vectorized numpy enumeration; the concatenation over refs is the
        thread's complete access stream (in arbitrary order — the
        position array carries the ordering). `schedule` overrides the
        nest's round-robin static schedule (any object with
        local_count/local_to_value; the executing profiler passes its
        contiguous row-block split, oracle/profiler.py). `m_lo`/`m_hi`
        restrict to a window of thread-local parallel iterations so
        long traces can stream in bounded memory (runtime/debug.py).
        """
        sched = schedule if schedule is not None else self.schedule
        level = int(self.tables.ref_levels[ref_idx])
        L = sched.local_count(tid)
        L = L if m_hi is None else min(L, m_hi)
        if L <= m_lo:
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy()
        m = np.arange(m_lo, L, dtype=np.int64)
        v0 = sched.local_to_value(tid, m)
        if self.tri:
            return self._enumerate_ref_tri(tid, ref_idx, m, v0, sched)
        if level == 0:
            pos = self.access_position(ref_idx, m)
            addr = self.ref_addr(ref_idx, v0)
            return pos.astype(np.int64), addr.astype(np.int64)
        t1 = self.nest.loops[1].trip
        n1 = np.arange(t1, dtype=np.int64)
        if level == 1:
            pos = self.access_position(ref_idx, m[:, None], n1[None, :])
            addr = self.ref_addr(
                ref_idx, v0[:, None], self.iter_values(1, n1)[None, :]
            )
            addr = np.broadcast_to(addr, pos.shape)
            return pos.ravel().astype(np.int64), addr.ravel().astype(np.int64)
        t2 = self.nest.loops[2].trip
        n2 = np.arange(t2, dtype=np.int64)
        pos = self.access_position(
            ref_idx, m[:, None, None], n1[None, :, None], n2[None, None, :]
        )
        addr = self.ref_addr(
            ref_idx,
            v0[:, None, None],
            self.iter_values(1, n1)[None, :, None],
            self.iter_values(2, n2)[None, None, :],
        )
        addr = np.broadcast_to(addr, pos.shape)
        return pos.ravel().astype(np.int64), addr.ravel().astype(np.int64)

    def _enumerate_ref_tri(self, tid, ref_idx, m, v0, sched):
        """Triangular-nest enumeration: ragged inner grids via masks.

        Requires the nest's own static schedule (tri_base is built for
        it); alternative schedules would need their own base tables.
        """
        assert sched is self.schedule, (
            "triangular enumeration supports the nest schedule only"
        )
        level = int(self.tables.ref_levels[ref_idx])
        base = self.tri_base[tid, m]
        if level == 0:
            pos = self.tri_position(ref_idx, v0, base)
            addr = np.broadcast_to(self.ref_addr(ref_idx, v0), pos.shape)
            return pos.astype(np.int64), addr.astype(np.int64).copy()
        lp1 = self.nest.loops[1]
        t1 = lp1.trip_at(v0)
        n1 = np.arange(int(t1.max(initial=0)), dtype=np.int64)
        mask = n1[None, :] < t1[:, None]
        v1 = lp1.start_at(v0)[:, None] + n1[None, :] * lp1.step
        if level == 1:
            pos = self.tri_position(
                ref_idx, v0[:, None], base[:, None], n1[None, :]
            )
            addr = np.broadcast_to(
                self.ref_addr(ref_idx, v0[:, None], v1), pos.shape
            )
            return pos[mask].astype(np.int64), addr[mask].astype(np.int64)
        lp2 = self.nest.loops[2]
        t2 = lp2.trip_at(v0)
        n2 = np.arange(int(t2.max(initial=0)), dtype=np.int64)
        mask = mask[:, :, None] & (n2[None, None, :] < t2[:, None, None])
        v2 = lp2.start_at(v0)[:, None, None] + n2[None, None, :] * lp2.step
        pos = self.tri_position(
            ref_idx, v0[:, None, None], base[:, None, None],
            n1[None, :, None], n2[None, None, :],
        )
        addr = np.broadcast_to(
            self.ref_addr(ref_idx, v0[:, None, None], v1[:, :, None], v2),
            pos.shape,
        )
        return pos[mask].astype(np.int64), addr[mask].astype(np.int64)


class ProgramTrace:
    """Trace geometry of a whole program (nests concatenated per thread).

    The per-thread access clock persists across parallel nests (the
    reference keeps one `count` array across generated parallel loops),
    so nest k's positions are offset by the thread's total length of
    nests 0..k-1.
    """

    def __init__(self, program: Program, machine: MachineConfig):
        self.program = program
        self.machine = machine
        self.nests = [
            NestTrace(program, i, machine) for i in range(len(program.nests))
        ]
        P = machine.thread_num
        lengths = np.array(
            [[nt.tid_length(t) for t in range(P)] for nt in self.nests],
            dtype=np.int64,
        )  # (n_nests, P)
        self.nest_offsets = np.concatenate(
            [np.zeros((1, P), dtype=np.int64), np.cumsum(lengths, axis=0)]
        )  # (n_nests+1, P)

    def tid_total_length(self, tid: int) -> int:
        return int(self.nest_offsets[-1, tid])

    def nest_offset(self, nest_index: int, tid: int) -> int:
        return int(self.nest_offsets[nest_index, tid])

    def enumerate_tid(self, tid: int):
        """Full access stream of one simulated thread across all nests.

        Returns int64 arrays (positions, addrs, array_ids, ref_gids)
        where ref_gids index `self.program.refs`.
        """
        parts = [
            self.enumerate_tid_window(
                tid, k, 0, nt.schedule.local_count(tid)
            )
            for k, nt in enumerate(self.nests)
        ]
        return tuple(
            np.concatenate([p[c] for p in parts]) for c in range(4)
        )

    def enumerate_tid_window(
        self, tid: int, nest_index: int, m_lo: int, m_hi: int
    ):
        """One nest's accesses for thread-local parallel iterations
        [m_lo, m_hi) — same arrays as enumerate_tid, bounded memory."""
        nt = self.nests[nest_index]
        off = self.nest_offset(nest_index, tid)
        gid0 = sum(
            self.nests[k].tables.n_refs for k in range(nest_index)
        )
        pos_all, addr_all, arr_all, ref_all = [], [], [], []
        for ri in range(nt.tables.n_refs):
            pos, addr = nt.enumerate_ref(tid, ri, m_lo=m_lo, m_hi=m_hi)
            pos_all.append(pos + off)
            addr_all.append(addr)
            arr_all.append(
                np.full(pos.shape, nt.tables.ref_arrays[ri], dtype=np.int64)
            )
            ref_all.append(np.full(pos.shape, gid0 + ri, dtype=np.int64))
        return (
            np.concatenate(pos_all),
            np.concatenate(addr_all),
            np.concatenate(arr_all),
            np.concatenate(ref_all),
        )

    def ref_global_tables(self):
        """Program-wide ref tables: share thresholds/ratios per ref gid."""
        thr: list[int] = []
        ratio: list[int] = []
        names: list[str] = []
        for nt in self.nests:
            thr.extend(int(x) for x in nt.tables.ref_share_thresholds)
            ratio.extend(int(x) for x in nt.tables.ref_share_ratios)
            names.extend(nt.tables.ref_names)
        return (
            np.array(thr, dtype=np.int64),
            np.array(ratio, dtype=np.int64),
            tuple(names),
        )
