"""Loop-nest IR: the reference's per-benchmark generated samplers as data.

The reference ships one generated C++/Rust state machine per benchmark
(c_lib/test/sampler/gemm-t4-pluss-pro-model-*.cpp, src/gemm_sampler*.rs);
the loop structure, reference order (C0 -> C1 -> A0 -> B0 -> C2 -> C3),
address affine maps (GetAddress_*, e.g.
c_lib/test/sampler/gemm-t4-pluss-pro-model-ri-omp-seq.cpp:12-35) and
carried-dependence share thresholds (:203) are all baked into code.

Here the same information is a small IR interpreted by one generic engine:

- `Loop`: one loop level with static bounds (trip, start, step).
- `Ref`: a static array reference with an affine flat-index map
  flat(iv) = sum(coeffs[l] * iv[l]) + const, cache-line address
  flat * DS // CLS (GetAddress_* formula, ...ri-omp-seq.cpp:12-35).
- `ParallelNest`: an OpenMP-style `#pragma pluss parallel` loop nest
  (gemm.ppcg_omp.c:90): level 0 is the statically-chunk-scheduled
  parallel loop; refs appear in program order at each level, before
  ("pre") or after ("post") that level's subloop.
- `Program`: an ordered list of parallel nests sharing arrays. The
  simulated per-thread access clock runs on across nests, but the
  last-access tables do NOT: the generated sampler flushes surviving
  lines as -1 and clears every LAT after each parallel loop
  (...ri-omp-seq.cpp:303-319), so reuse never crosses a nest boundary.

Share rule: a reference whose reuse is carried across simulated threads
(its address map does not involve the parallel induction variable) is
classified per access: share iff |reuse - threshold| < |reuse - 0|
(`distance_to(reuse,0) > distance_to(reuse,THRESH)`,
...ri-omp-seq.cpp:203-207), recorded with share ratio THREAD_NUM-1.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

MAX_DEPTH = 3


@dataclasses.dataclass(frozen=True)
class Loop:
    """One loop level: iterates start, start+step, ... (trip values).

    Inner levels may be *triangular*: bounds affine in the PARALLEL
    loop's value v0 (the class PolyBench's symmetric/triangular kernels
    need — syrk/trmm's `j <= i`, trisolv's `j < i`, covariance's
    `j >= i`). At parallel value v0 the level iterates
        start + start_coeff*v0 + k*step   for k in [0, trip_at(v0)),
        trip_at(v0) = max(0, trip + trip_coeff*v0).
    The parallel level itself must be rectangular
    (trip_coeff == start_coeff == 0); bounds depending on non-parallel
    outer variables (doubly-triangular nests) are out of scope.
    """

    trip: int
    start: int = 0
    step: int = 1
    trip_coeff: int = 0
    start_coeff: int = 0

    def __post_init__(self) -> None:
        if self.trip_coeff == 0 and self.trip < 1:
            raise ValueError("trip must be >= 1")
        if self.step == 0:
            raise ValueError("step must be nonzero")

    @property
    def is_triangular(self) -> bool:
        return self.trip_coeff != 0 or self.start_coeff != 0

    def trip_at(self, v0):
        """Trip count at parallel value v0 (elementwise over arrays)."""
        if not self.is_triangular:
            return self.trip if not hasattr(v0, "shape") else (
                v0 * 0 + self.trip
            )
        t = self.trip + self.trip_coeff * v0
        if hasattr(t, "shape"):
            return t.clip(min=0) if isinstance(t, np.ndarray) else t.clip(0)
        return max(0, t)

    def start_at(self, v0):
        """First iteration value at parallel value v0."""
        return self.start + self.start_coeff * v0

    @property
    def last(self) -> int:
        """The last iteration value (pluss_utils.h:331); rectangular
        loops only — triangular levels use the nest-level value range
        helpers."""
        if self.is_triangular:
            raise ValueError("last is undefined for a triangular loop")
        return self.start + (self.trip - 1) * self.step


@dataclasses.dataclass(frozen=True)
class Ref:
    """A static array reference.

    Attributes:
      name: reference name as in the generated sampler ("C0", "A0", ...;
        mapping documented at gemm.ppcg_omp.c:93-95).
      array: array name ("A", "B", "C"); last-access tables are per
        (simulated thread, array) (LAT_A/LAT_B/LAT_C,
        ...ri-omp-seq.cpp:47-49).
      level: loop level the reference sits at (0-based; its depth is
        level+1 enclosing loops).
      coeffs: affine coefficients over loop levels, length == level+1.
      const: affine constant term.
      slot: "pre" if the access happens before this level's subloop in
        program order, "post" if after. Levels without a subloop use "pre".
      share_threshold: None for thread-private references; otherwise the
        carried-reuse threshold of the share classifier
        (...ri-omp-seq.cpp:203: (1*T+1)*T+1 for GEMM's B0).
      share_ratio: number of *other* simulated threads racing on the line
        (THREAD_NUM-1 at the update site, ...ri-omp-seq.cpp:204); None
        defaults to machine.thread_num - 1 at runtime.
      write: whether this reference is a store. The engines never read
        it (locality is direction-blind), but the static race detector
        (analysis/deps.py) needs it. None means "derive": under the
        generated-sampler convention every store is a read-modify-write
        *pair* of refs sharing one affine map, so a duplicated map marks
        a write — set False on repeated reads of one element (heat-3d's
        stencil center, gesummv's x) where that convention misreads.
    """

    name: str
    array: str
    level: int
    coeffs: tuple[int, ...]
    const: int = 0
    slot: str = "pre"
    share_threshold: Optional[int] = None
    share_ratio: Optional[int] = None
    write: Optional[bool] = None

    def __post_init__(self) -> None:
        if self.level < 0 or self.level >= MAX_DEPTH:
            raise ValueError(f"level must be in [0,{MAX_DEPTH})")
        if len(self.coeffs) != self.level + 1:
            raise ValueError("coeffs length must equal level+1")
        if self.slot not in ("pre", "post"):
            raise ValueError("slot must be 'pre' or 'post'")

    @property
    def depth(self) -> int:
        return self.level + 1

    def flat_index(self, iv) -> int:
        """Affine flat element index for an iteration vector."""
        acc = self.const
        for c, v in zip(self.coeffs, iv):
            acc += c * v
        return acc


@dataclasses.dataclass(frozen=True)
class ParallelNest:
    """One `#pragma pluss parallel` loop nest (level 0 is parallel)."""

    loops: tuple[Loop, ...]
    refs: tuple[Ref, ...]

    def __post_init__(self) -> None:
        if not 1 <= len(self.loops) <= MAX_DEPTH:
            raise ValueError(f"supported nest depth is 1..{MAX_DEPTH}")
        if self.loops[0].is_triangular:
            raise ValueError("the parallel loop must be rectangular")
        for r in self.refs:
            if r.level >= len(self.loops):
                raise ValueError(f"ref {r.name} deeper than nest")
            if r.level == len(self.loops) - 1 and r.slot == "post":
                raise ValueError(
                    f"ref {r.name}: deepest level has no subloop; use slot='pre'"
                )

    @property
    def depth(self) -> int:
        return len(self.loops)

    @property
    def is_triangular(self) -> bool:
        """Any inner level's bounds depend on the parallel value."""
        return any(lp.is_triangular for lp in self.loops[1:])

    def refs_at(self, level: int, slot: str) -> tuple[Ref, ...]:
        return tuple(r for r in self.refs if r.level == level and r.slot == slot)

    def accesses_per_level_iter(self) -> tuple[int, ...]:
        """acc[l] = accesses performed by one full iteration at level l.

        GEMM: acc[2]=4 (A0,B0,C2,C3), acc[1]=2+128*4=514 (C0,C1 + inner),
        acc[0]=128*514 (= the r10 B0 share threshold body,
        ...rs-ri-opt-r10.cpp:2482). Rectangular nests only — triangular
        body sizes depend on the parallel value (NestTrace.body_at).
        """
        if self.is_triangular:
            raise ValueError(
                "accesses_per_level_iter is undefined for triangular nests"
            )
        acc = [0] * self.depth
        for l in range(self.depth - 1, -1, -1):
            n = len(self.refs_at(l, "pre")) + len(self.refs_at(l, "post"))
            if l < self.depth - 1:
                n += self.loops[l + 1].trip * acc[l + 1]
            acc[l] = n
        return tuple(acc)

    def ref_body_offset(self, ref: Ref) -> int:
        """Offset of `ref` within one iteration of its level's body
        (rectangular nests; triangular use NestTrace.ref_offset_at)."""
        pre = self.refs_at(ref.level, "pre")
        if ref.slot == "pre":
            return pre.index(ref)
        acc = self.accesses_per_level_iter()
        inner = (
            self.loops[ref.level + 1].trip * acc[ref.level + 1]
            if ref.level < self.depth - 1
            else 0
        )
        return len(pre) + inner + self.refs_at(ref.level, "post").index(ref)


@dataclasses.dataclass(frozen=True)
class Program:
    """A benchmark: ordered parallel nests over shared arrays."""

    name: str
    nests: tuple[ParallelNest, ...]

    def __post_init__(self) -> None:
        if not self.nests:
            raise ValueError("program needs at least one nest")

    @property
    def arrays(self) -> tuple[str, ...]:
        seen: dict[str, None] = {}
        for nest in self.nests:
            for r in nest.refs:
                seen.setdefault(r.array, None)
        return tuple(seen)

    @property
    def refs(self) -> tuple[tuple[int, Ref], ...]:
        """All (nest_index, ref) pairs in program order."""
        return tuple((i, r) for i, nest in enumerate(self.nests) for r in nest.refs)

    def array_id(self, array: str) -> int:
        return self.arrays.index(array)


# ---------------------------------------------------------------------------
# Flattened numeric tables for the array-program engines.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NestTables:
    """Static numpy views of one nest, consumed by trace/dense/sampled.

    All arrays are indexed by the nest-local ref index (program order).
    Coefficients are padded to MAX_DEPTH columns.
    """

    depth: int
    trips: np.ndarray  # (MAX_DEPTH,) int64, unused levels = 1
    starts: np.ndarray  # (MAX_DEPTH,) int64
    steps: np.ndarray  # (MAX_DEPTH,) int64
    trip_coeffs: np.ndarray  # (MAX_DEPTH,) int64, 0 for rectangular
    start_coeffs: np.ndarray  # (MAX_DEPTH,) int64, 0 for rectangular
    acc_per_level: np.ndarray  # (MAX_DEPTH,) int64 (-1 when triangular)
    n_refs: int
    ref_levels: np.ndarray  # (n_refs,) int64
    ref_coeffs: np.ndarray  # (n_refs, MAX_DEPTH) int64
    ref_consts: np.ndarray  # (n_refs,) int64
    ref_arrays: np.ndarray  # (n_refs,) int64 array ids (program-wide)
    ref_offsets: np.ndarray  # (n_refs,) int64 body offset within level iter
    ref_share_thresholds: np.ndarray  # (n_refs,) int64, -1 = thread-private
    ref_share_ratios: np.ndarray  # (n_refs,) int64
    ref_names: tuple[str, ...]


def nest_tables(
    program: Program, nest_index: int, default_share_ratio: int
) -> NestTables:
    nest = program.nests[nest_index]
    d = nest.depth
    trips = np.ones(MAX_DEPTH, dtype=np.int64)
    starts = np.zeros(MAX_DEPTH, dtype=np.int64)
    steps = np.ones(MAX_DEPTH, dtype=np.int64)
    trip_cf = np.zeros(MAX_DEPTH, dtype=np.int64)
    start_cf = np.zeros(MAX_DEPTH, dtype=np.int64)
    for l, lp in enumerate(nest.loops):
        trips[l], starts[l], steps[l] = lp.trip, lp.start, lp.step
        trip_cf[l], start_cf[l] = lp.trip_coeff, lp.start_coeff
    acc = np.zeros(MAX_DEPTH, dtype=np.int64)
    if nest.is_triangular:
        acc[:] = -1  # body sizes depend on v0: use NestTrace.body_at
        offsets = np.full(len(nest.refs), -1, dtype=np.int64)
    else:
        acc[:d] = nest.accesses_per_level_iter()
        offsets = np.array(
            [nest.ref_body_offset(r) for r in nest.refs], dtype=np.int64
        )
    refs = nest.refs
    coeffs = np.zeros((len(refs), MAX_DEPTH), dtype=np.int64)
    for i, r in enumerate(refs):
        coeffs[i, : r.level + 1] = r.coeffs
    return NestTables(
        depth=d,
        trips=trips,
        starts=starts,
        steps=steps,
        trip_coeffs=trip_cf,
        start_coeffs=start_cf,
        acc_per_level=acc,
        n_refs=len(refs),
        ref_levels=np.array([r.level for r in refs], dtype=np.int64),
        ref_coeffs=coeffs,
        ref_consts=np.array([r.const for r in refs], dtype=np.int64),
        ref_arrays=np.array([program.array_id(r.array) for r in refs], dtype=np.int64),
        ref_offsets=offsets,
        ref_share_thresholds=np.array(
            [r.share_threshold if r.share_threshold is not None else -1 for r in refs],
            dtype=np.int64,
        ),
        ref_share_ratios=np.array(
            [
                r.share_ratio if r.share_ratio is not None else default_share_ratio
                for r in refs
            ],
            dtype=np.int64,
        ),
        ref_names=tuple(r.name for r in refs),
    )
