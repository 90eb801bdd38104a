"""Serial oracle: a literal interpreter of the reference's sampler walk.

This is the in-repo correctness anchor (SURVEY.md section 7 step 3): a
direct, dict-based re-enactment of the serial C++ sampler
(c_lib/test/sampler/gemm-t4-pluss-pro-model-ri-omp-seq.cpp) generalized
over the loop-nest IR instead of generated per benchmark:

- each simulated thread walks its statically-scheduled chunks in
  dispatch order (:70-71), executing the body reference sequence
  (:102-288) with a per-(thread, array) last-access-time dict
  (LAT_C/LAT_A/LAT_B, :47-49) and a per-thread access clock (:45);
- private reuses go to the per-thread noshare histogram, pow2-binned
  (:117); share-classified references compare against their carried
  threshold (:203-207) and record raw intervals at ratio THREAD_NUM-1;
- lines never reused flush as -1 with multiplicity = surviving LAT
  entries per (thread, array), and the LAT tables are cleared, after
  EVERY parallel nest (:303-319: "reset both lists so they can be
  reused for later parallel loop"; LAT_X[i].clear() per loop) — so a
  line carried from one parallel loop to the next is a cold miss, while
  the per-thread access clock runs on across nests;
- `total_accesses` reproduces `max_iteration_count` =
  sum(count) (:332).

Thread-major order (each simulated thread runs to completion before the
next) is equivalent to any interleaving because all sampler state is
per-thread — the property the `ri` variant's `#pragma omp parallel for`
over tids (...ri.cpp:67) relies on.
"""

from __future__ import annotations

import dataclasses

from ..config import MachineConfig
from ..ir import Program
from ..runtime.hist import PRIState, share_classify


@dataclasses.dataclass
class OracleResult:
    state: PRIState
    total_accesses: int
    per_tid_accesses: list
    # which engine produced the result, when a router (e.g.
    # periodic.run_exact) chose one; None when the caller invoked an
    # engine directly
    engine: str | None = None


def run_serial(
    program: Program, machine: MachineConfig, v2: bool = False,
    schedule: str = "static",
) -> OracleResult:
    """v2=True selects the runtime-v2 histogram semantics (raw noshare
    keys, pluss_utils_v2.h:915-918). schedule="dynamic" replaces the
    static round-robin chunk ownership with the reference's FIFO
    dynamic-dispatcher arm (core/schedule.py::dynamic_chunk_assignment
    — dead code in the reference, modeled under uniform interleaving;
    identical to static for every rectangular nest)."""
    from ..core.schedule import StaticSchedule, dynamic_chunk_assignment

    P = machine.thread_num
    state = PRIState(P, bin_noshare=not v2)
    lat: dict[tuple[int, str], dict[int, int]] = {
        (t, a): {} for t in range(P) for a in program.arrays
    }
    count = [0] * P

    for nest in program.nests:
        lp0 = nest.loops[0]
        sched = StaticSchedule(
            trip=lp0.trip, chunk=machine.chunk_size, threads=P,
            start=lp0.start, step=lp0.step,
        )
        depth = nest.depth
        pre = [nest.refs_at(l, "pre") for l in range(depth)]
        post = [nest.refs_at(l, "post") for l in range(depth)]

        def access(tid: int, ref, ivs) -> None:
            flat = ref.flat_index(ivs)
            addr = flat * machine.ds // machine.cls
            table = lat[(tid, ref.array)]
            if addr in table:
                reuse = count[tid] - table[addr]
                if ref.share_threshold is not None and share_classify(
                    reuse, ref.share_threshold
                ):
                    ratio = (
                        ref.share_ratio
                        if ref.share_ratio is not None
                        else machine.thread_num - 1
                    )
                    state.update_share(tid, ratio, reuse, 1.0)
                else:
                    state.update_noshare(tid, reuse, 1.0)
            table[addr] = count[tid]
            count[tid] += 1

        def body(tid: int, level: int, ivs: list) -> None:
            for ref in pre[level]:
                access(tid, ref, ivs)
            if level + 1 < depth:
                lp = nest.loops[level + 1]
                # triangular levels: bounds affine in the parallel value
                for n in range(lp.trip_at(ivs[0])):
                    ivs.append(lp.start_at(ivs[0]) + n * lp.step)
                    body(tid, level + 1, ivs)
                    ivs.pop()
            for ref in post[level]:
                access(tid, ref, ivs)

        if schedule == "dynamic":
            n_chunks = -(-lp0.trip // machine.chunk_size)

            def period_cost(n: int) -> int:
                v0 = lp0.start + n * lp0.step
                total = 0
                for l in range(depth):
                    width = 1
                    for j in range(1, l + 1):
                        width *= nest.loops[j].trip_at(v0)
                    total += (len(pre[l]) + len(post[l])) * width
                return total

            costs = [
                sum(
                    period_cost(n)
                    for n in range(
                        ci * machine.chunk_size,
                        min((ci + 1) * machine.chunk_size, lp0.trip),
                    )
                )
                for ci in range(n_chunks)
            ]
            for tid, chunks in enumerate(
                dynamic_chunk_assignment(n_chunks, P, costs)
            ):
                for ci in chunks:
                    for n in range(
                        ci * machine.chunk_size,
                        min((ci + 1) * machine.chunk_size, lp0.trip),
                    ):
                        body(tid, 0, [lp0.start + n * lp0.step])
        else:
            for tid in range(P):
                for m in range(sched.local_count(tid)):
                    body(tid, 0, [sched.local_to_value(tid, m)])

        # per-nest -1 flush + LAT clear (...ri-omp-seq.cpp:303-319)
        for tid in range(P):
            for a in program.arrays:
                table = lat[(tid, a)]
                if table:
                    state.update_noshare(tid, -1, float(len(table)))
                    table.clear()

    return OracleResult(
        state=state, total_accesses=sum(count), per_tid_accesses=list(count)
    )
