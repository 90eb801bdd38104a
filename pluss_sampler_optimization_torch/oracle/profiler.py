"""Ground-truth profiler: execute the real kernel, record exact RIs.

Port of the reference's executing profiler (src/gemm_profiler.rs) — the
oracle that the *model* (sampler + CRI) is validated against:

- real data: PolyBench init formulas (gemm_profiler.rs:101-122,
  mirroring gemm.ppcg_omp.c:37-45) and the actual GEMM float kernel
  C = beta*C + alpha*A@B (gemm_profiler.rs:147-168);
- parallel decomposition: each thread owns one *contiguous* block of C
  rows (`par_chunks_mut(rows/threads)`, gemm_profiler.rs:185) — note
  this differs from the samplers' round-robin CHUNK_SIZE schedule;
- exact reuse intervals: every access is clocked on its thread's
  private counter (gemm_profiler.rs:146,186-205); RI = clock delta to
  the previous touch of the same (array, cache line) on that thread
  (:62-77); first touches record RI = -1 (:70);
- output: one raw-keyed histogram per thread (pri_array, :30-36).

Two deviations from the reference, both documented here on purpose:
the reference indexes C and A with *chunk-local* row numbers in the
parallel kernel (c0 in 0..chunk_len, gemm_profiler.rs:188-197), making
different threads' addresses alias the same small row range; we use
global row indices (the addresses the real kernel touches). And the
reference tags samples with rayon's *execution* thread index (:191),
which depends on pool scheduling; we use the chunk owner, which is what
its per-thread chunk decomposition means.

The RI accounting is vectorized numpy (lexsort + segmented diff — the
same reduction the dense TPU engine uses), so the profiler scales to
N=1024+ where the reference's per-access hash walk is minutes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import MachineConfig
from ..ir import Program
from ..runtime.hist import Hist


@dataclasses.dataclass(frozen=True)
class ContiguousSchedule:
    """Contiguous row-block decomposition (par_chunks_mut semantics).

    Thread t owns normalized iterations [offset(t), offset(t)+count(t));
    when trip % threads != 0 the first `trip % threads` threads own one
    extra iteration (the reference instead asserts divisibility,
    gemm_profiler.rs:183).
    """

    trip: int
    threads: int
    start: int = 0
    step: int = 1

    def local_count(self, tid: int) -> int:
        base, rem = divmod(self.trip, self.threads)
        return base + (1 if tid < rem else 0)

    def offset(self, tid: int) -> int:
        base, rem = divmod(self.trip, self.threads)
        return tid * base + min(tid, rem)

    def local_to_value(self, tid: int, m):
        return self.start + (self.offset(tid) + m) * self.step


@dataclasses.dataclass
class ProfilerResult:
    """Exact per-thread reuse histograms from a real execution."""

    hists: list  # per-tid Hist, raw reuse keys, -1 = first touch
    per_tid_accesses: list
    output: np.ndarray | None = None  # the executed kernel's result

    def merged(self) -> Hist:
        from ..runtime.hist import merge_hists

        return merge_hists(self.hists, in_log_format=False)


# ---------------------------------------------------------------------------
# Real kernel execution (GEMM)
# ---------------------------------------------------------------------------


def gemm_init(ni: int, nj: int, nk: int):
    """PolyBench GEMM init (gemm_profiler.rs:101-122): returns C, A, B."""
    r_c, c_c = np.meshgrid(np.arange(ni), np.arange(nj), indexing="ij")
    C = ((r_c * c_c + 1) % ni) / ni
    r_a, c_a = np.meshgrid(np.arange(ni), np.arange(nk), indexing="ij")
    A = (r_a * (c_a + 1) % nk) / nk
    r_b, c_b = np.meshgrid(np.arange(nk), np.arange(nj), indexing="ij")
    B = (r_b * (c_b + 2) % nj) / nj
    return C, A, B


def execute_gemm(
    ni: int, nj: int, nk: int, thread_num: int,
    alpha: float = 1.5, beta: float = 1.2,
) -> np.ndarray:
    """Run the real kernel per thread block (gemm_profiler.rs:170-209).

    The per-block computation is the same math the instrumented loops
    perform; float results are bit-identical to the serial kernel
    because each C element is owned by exactly one thread.
    """
    C, A, B = gemm_init(ni, nj, nk)
    sched = ContiguousSchedule(trip=ni, threads=thread_num)
    out = np.empty_like(C)
    for tid in range(thread_num):
        lo = sched.offset(tid)
        hi = lo + sched.local_count(tid)
        out[lo:hi] = beta * C[lo:hi] + alpha * (A[lo:hi] @ B)
    return out


# ---------------------------------------------------------------------------
# Exact RI accounting (generic over the IR)
# ---------------------------------------------------------------------------


def profile_program(
    program: Program, machine: MachineConfig, thread_num: int | None = None
) -> ProfilerResult:
    """Exact per-thread RI histograms under the contiguous schedule.

    Enumerates each thread's access stream in execution order (the
    recursive loop body order of oracle/serial.py) and computes exact
    reuse intervals per (array, cache line) with one lexsort per
    thread — numerically identical to the reference's per-access hash
    walk (gemm_profiler.rs:52-91), minus its chunk-local addressing
    (see module docstring).
    """
    from ..core.trace import NestTrace

    T = thread_num if thread_num is not None else machine.thread_num
    hists: list[Hist] = [dict() for _ in range(T)]
    per_tid = [0] * T
    # Per-tid running clock across nests (the reference's profiler keeps
    # one counter per thread for the whole kernel, gemm_profiler.rs:186).
    clocks = [0] * T

    for k in range(len(program.nests)):
        nt = NestTrace(program, k, machine)
        t = nt.tables
        nest = nt.nest
        sched = ContiguousSchedule(
            trip=nest.loops[0].trip, threads=T,
            start=nest.loops[0].start, step=nest.loops[0].step,
        )
        for tid in range(T):
            L = sched.local_count(tid)
            if L == 0:
                continue
            pos_all, addr_all, arr_all = [], [], []
            for ri in range(t.n_refs):
                pos, addr = nt.enumerate_ref(tid, ri, schedule=sched)
                pos_all.append(pos)
                addr_all.append(addr)
                arr_all.append(
                    np.full(pos.size, int(t.ref_arrays[ri]), dtype=np.int64)
                )
            pos_v = np.concatenate(pos_all) + clocks[tid]
            addr_v = np.concatenate(addr_all)
            arr_v = np.concatenate(arr_all)
            order = np.lexsort((pos_v, addr_v, arr_v))
            pos_s, addr_s, arr_s = pos_v[order], addr_v[order], arr_v[order]
            same = np.empty(len(pos_s), dtype=bool)
            same[0] = False
            same[1:] = (addr_s[1:] == addr_s[:-1]) & (arr_s[1:] == arr_s[:-1])
            reuse = np.where(same, pos_s - np.roll(pos_s, 1), -1)
            keys, counts = np.unique(reuse, return_counts=True)
            h = hists[tid]
            for key, cnt in zip(keys.tolist(), counts.tolist()):
                h[int(key)] = h.get(int(key), 0.0) + float(cnt)
            per_tid[tid] += len(pos_v)
            clocks[tid] += L * int(t.acc_per_level[0])
    return ProfilerResult(hists=hists, per_tid_accesses=per_tid)


def profile_gemm(
    n: int, machine: MachineConfig | None = None,
    thread_num: int | None = None, execute: bool = True,
) -> ProfilerResult:
    """gemm_profiler::acc equivalent (gemm_profiler.rs:279-295)."""
    from ..models.gemm import gemm

    machine = machine or MachineConfig()
    res = profile_program(gemm(n), machine, thread_num)
    if execute:
        T = thread_num if thread_num is not None else machine.thread_num
        res.output = execute_gemm(n, n, n, T)
    return res
