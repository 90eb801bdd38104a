"""Closed-form OpenMP static-chunk scheduling arithmetic.

Replaces the reference's stateful `ChunkDispatcher`
(c_lib/test/runtime/pluss_utils.h:287-618, src/chunk_dispatcher.rs) with
index math. The dispatcher hands chunk `c` (CHUNK_SIZE consecutive
parallel-loop iterations) to simulated thread c % THREAD_NUM
(getNextStaticChunk, pluss_utils.h:410-425; per-thread start points
advance by chunk_size*THREAD_NUM*step, :420). The derived per-iteration
quantities below are the closed forms the reference itself documents:

  tid(i) = ((i-start)/step)/chunk_size mod THREAD_NUM
                                   (getStaticTid, pluss_utils.h:429-431)
  cid(i) = floor(((i-start)/step) / (chunk_size*THREAD_NUM))
                                   (getStaticChunkID, :433-435)
  pos(i) = ((i-start)/step) mod chunk_size
                                   (getStaticThreadLocalPos, :437-439)

plus the inverse map (thread-local index -> iteration value) that the
array engines need and the reference never materializes. Every function
is plain integer arithmetic and works elementwise on Python ints, numpy
arrays and traced jax arrays alike.

Only the static schedule is implemented. The C++ dispatcher carries a
FIFO dynamic-chunk arm (getNextChunk/hasNextChunk(false),
pluss_utils.h:391-411) but no live sampler ever drives it (every
generated walk calls getNextStaticChunk; the Rust port leaves the
dynamic trait `unimplemented!`, src/chunk_dispatcher.rs:34-69) — and
under the model's uniform interleaving, threads request chunks in tid
order, so FIFO assignment would reproduce the round-robin static map
anyway. It stays out by design.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class StaticSchedule:
    """Static chunk schedule of one parallel loop.

    `trip`, `start`, `step` describe the parallel loop (level 0);
    `chunk` is CHUNK_SIZE and `threads` is THREAD_NUM.
    Normalized index n = (i - start) // step ranges over [0, trip).
    """

    trip: int
    chunk: int
    threads: int
    start: int = 0
    step: int = 1

    # -- global-iteration queries (forward maps) ---------------------------

    def normalize(self, value):
        """Iteration value -> normalized index n."""
        return (value - self.start) // self.step

    def value(self, n):
        """Normalized index -> iteration value."""
        return self.start + n * self.step

    def owner_tid(self, n):
        """Simulated thread that executes normalized iteration n."""
        return (n // self.chunk) % self.threads

    def local_chunk_id(self, n):
        """Thread-local chunk id (cid) of normalized iteration n."""
        return n // (self.chunk * self.threads)

    def chunk_pos(self, n):
        """Position within its chunk (pos) of normalized iteration n."""
        return n % self.chunk

    def local_index(self, n):
        """Index of n within its owner thread's own iteration sequence.

        Only the globally-last chunk can be short, so every preceding
        chunk of the owner contributes exactly `chunk` iterations.
        """
        return self.local_chunk_id(n) * self.chunk + self.chunk_pos(n)

    # -- per-thread queries (inverse maps) ----------------------------------

    @property
    def n_chunks(self) -> int:
        return -(-self.trip // self.chunk)

    @property
    def last_chunk_len(self) -> int:
        rem = self.trip % self.chunk
        return rem if rem else self.chunk

    def local_count(self, tid: int) -> int:
        """Number of parallel-loop iterations simulated thread `tid` runs."""
        nch = self.n_chunks
        if tid >= nch:
            return 0
        mine = (nch - 1 - tid) // self.threads + 1
        total = mine * self.chunk
        if (nch - 1) % self.threads == tid:
            total += self.last_chunk_len - self.chunk
        return total

    def max_local_count(self) -> int:
        return max(self.local_count(t) for t in range(self.threads))

    def local_to_normalized(self, tid, m):
        """Thread-local index m of thread tid -> normalized iteration n."""
        cid = m // self.chunk
        pos = m % self.chunk
        return (cid * self.threads + tid) * self.chunk + pos

    def local_to_value(self, tid, m):
        return self.value(self.local_to_normalized(tid, m))

    def count_below(self, tid, n):
        """How many of thread `tid`'s iterations have normalized index
        < n — equivalently, the smallest thread-local index m whose
        global index is >= n. Elementwise over arrays; the caller
        clamps n to [0, trip]."""
        kp = self.chunk * self.threads
        q = n // kp
        r = n - q * kp - tid * self.chunk
        r = r.clip(0, self.chunk) if hasattr(r, "clip") else max(
            0, min(self.chunk, r)
        )
        return q * self.chunk + r


def interleaved_order_key(nest_trace, ref_idx: int, samples):
    """Interleaved-execution order of same-reference samples, as one
    int64 sort key.

    The reference's sampled variant processes each reference's random
    samples through a priority queue ordered by `IterationComp`
    (Iteration::compare, src/iteration.rs:63-134; same logic in
    pluss_utils.h:95-164): chunk round (cid) first, then position
    within the chunk, then the inner loop variables — the simulated
    thread id is deliberately never compared, because the uniform
    interleaving advances all threads' equal-cid/pos iterations
    together. Per-reference queues never compare across references, so
    the trailing priority tiebreak (ref program order) never fires
    there; sorting by this key reproduces the queue's pop order for
    the samples of one reference.

    `samples` is an (S, depth) array of normalized indices (as produced
    by sampler/sampled.py::draw_samples); returns (S,) int64 keys whose
    ascending order is the interleaved execution order.
    """
    import numpy as np

    t = nest_trace.tables
    sched = nest_trace.schedule
    lv = int(t.ref_levels[ref_idx])
    # widen the int32 wire format before radix math; .astype keeps
    # numpy arrays numpy and traced jax arrays traced
    samples = samples.astype(np.int64)
    n0 = samples[:, 0]
    key = sched.local_index(n0)  # (cid, pos) collapsed, tid excluded
    for l in range(1, lv + 1):
        # max_trips == trips for rectangular nests; triangular indices
        # range up to the nest-wide max trip
        key = key * int(nest_trace.max_trips[l]) + samples[:, l]
    return key


def dynamic_chunk_assignment(n_chunks: int, threads: int, chunk_costs):
    """FIFO chunk handout of the reference's dynamic dispatcher arm.

    `ChunkDispatcher.hasNextChunk(false)` / `getNextChunk`
    (pluss_utils.h:367-409; Rust stub surface chunk_dispatcher.rs:34-69)
    hand chunks to requesting threads in arrival order instead of the
    static round-robin. No live reference sampler calls this arm (every
    generated sampler passes isStatic=true or uses the static API), so
    there is no generated-code behavior to byte-match; the model here
    follows the uniform-interleaving machine the rest of the framework
    simulates: every simulated thread advances one access per turn, a
    thread requests its next chunk on the turn its current chunk
    completes, and simultaneous requests are served in tid order (the
    worker-list iteration order of the generated walks).

    With equal chunk costs — every rectangular nest, where each parallel
    iteration performs the same accesses — each request round resolves
    in tid order and the assignment IS the static round-robin; that
    closed-form equivalence is why the static arm alone reproduces the
    reference's live behavior (tests/test_schedule.py pins it). Costs
    only diverge for triangular nests.

    `chunk_costs[i]` = accesses in chunk i; returns per-tid lists of
    chunk indices in execution order.
    """
    import heapq

    ready = [(0, t) for t in range(threads)]
    heapq.heapify(ready)
    out: list = [[] for _ in range(threads)]
    for ci in range(n_chunks):
        turn, tid = heapq.heappop(ready)
        out[tid].append(ci)
        heapq.heappush(ready, (turn + int(chunk_costs[ci]), tid))
    return out
