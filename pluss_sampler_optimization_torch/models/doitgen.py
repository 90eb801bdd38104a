"""PolyBench doitgen as a PLUSS program.

Generated-sampler conventions as in models/gemm.py applied to
PolyBench/C doitgen (3.2 form, sum indexed sum[r][q][p]):

    for (r < NR) for (q < NQ) {
      for (p < NP) {
        sum[r][q][p] = 0;                           // S0
        for (s < NP)
          sum[r][q][p] += A[r][q][s] * C4[s][p];    // S1, A0, C40, S2
      }
      for (p < NP) A[r][q][p] = sum[r][q][p];       // S3, A1
    }

The two sibling p-loops inside one (r,q) iteration do not fit a single
chain-shaped nest, so the parallel schedule distributes them into two
`#pragma pluss parallel` regions with the (r,q) pair collapsed into one
parallel loop of NR*NQ iterations — the standard ppcg
distribute+collapse schedule for this kernel, and the reference codegen
emits one dispatcher per parallel region anyway
(...ri-omp-seq.cpp:59-60 allocates the dispatcher per loop). The
simulated thread clock runs across both regions; the write-back nest's
A/sum reuses start cold at the region boundary per the LAT flush
(...ri-omp-seq.cpp:303-319).

C4[s][p] omits the parallel variable -> share reference with the
depth-3 carried threshold (1*NP+1)*NP+1 (the gemm B0 family,
...ri-omp-seq.cpp:203).
"""

from __future__ import annotations

from ..ir import Loop, ParallelNest, Program, Ref


def doitgen(nr: int, nq: int | None = None, np_: int | None = None) -> Program:
    nq = nr if nq is None else nq
    np_ = nr if np_ is None else np_
    nest1 = ParallelNest(
        loops=(Loop(nr * nq), Loop(np_), Loop(np_)),
        refs=(
            Ref("S0", "sum", level=1, coeffs=(np_, 1)),
            Ref("S1", "sum", level=2, coeffs=(np_, 1, 0)),
            Ref("A0", "A", level=2, coeffs=(np_, 0, 1)),
            Ref("C40", "C4", level=2, coeffs=(0, 1, np_),
                share_threshold=(1 * np_ + 1) * np_ + 1),
            Ref("S2", "sum", level=2, coeffs=(np_, 1, 0)),
        ),
    )
    nest2 = ParallelNest(
        loops=(Loop(nr * nq), Loop(np_)),
        refs=(
            Ref("S3", "sum", level=1, coeffs=(np_, 1)),
            Ref("A1", "A", level=1, coeffs=(np_, 1)),
        ),
    )
    return Program(name=f"doitgen-{nr}x{nq}x{np_}", nests=(nest1, nest2))
