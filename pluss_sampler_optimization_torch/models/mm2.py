"""PolyBench 2mm as a PLUSS program (BASELINE.json config 4).

The reference ships generated samplers only for GEMM; 2mm follows the
same codegen conventions (statement-order references, read-before-write
per compound assignment, share classification for references not
involving the parallel induction variable) applied to PolyBench/C 2mm:

    // nest 1: tmp = alpha * A x B
    for (i < NI) for (j < NJ) { tmp[i][j] = 0;            // T0 (write)
      for (k < NK) tmp[i][j] += alpha*A[i][k]*B[k][j]; }  // A0,B0,T1,T2
    // nest 2: D = tmp x C + beta * D
    for (i < NI) for (j < NL) { D[i][j] *= beta;          // D0,D1
      for (k < NJ) D[i][j] += tmp[i][k]*C[k][j]; }        // T3,C0,D2,D3

B0 (nest 1) and C0 (nest 2) omit the parallel variable i -> share
references, thresholds per the full-traversal formula (1*Tmid+1)*Tinner+1
(...ri-omp-seq.cpp:203). Cross-nest reuse (tmp written in nest 1, read in
nest 2) exercises the multi-nest clock/LAT persistence.
"""

from __future__ import annotations

from ..ir import Loop, ParallelNest, Program, Ref


def mm2(n: int, ni: int | None = None, nj: int | None = None,
        nk: int | None = None, nl: int | None = None) -> Program:
    ni = n if ni is None else ni
    nj = n if nj is None else nj
    nk = n if nk is None else nk
    nl = n if nl is None else nl

    nest1 = ParallelNest(
        loops=(Loop(ni), Loop(nj), Loop(nk)),
        refs=(
            Ref("T0", "tmp", level=1, coeffs=(nj, 1)),
            Ref("A0", "A", level=2, coeffs=(nk, 0, 1)),
            Ref("B0", "B", level=2, coeffs=(0, 1, nj),
                share_threshold=(1 * nj + 1) * nk + 1),
            Ref("T1", "tmp", level=2, coeffs=(nj, 1, 0)),
            Ref("T2", "tmp", level=2, coeffs=(nj, 1, 0)),
        ),
    )
    nest2 = ParallelNest(
        loops=(Loop(ni), Loop(nl), Loop(nj)),
        refs=(
            Ref("D0", "D", level=1, coeffs=(nl, 1)),
            Ref("D1", "D", level=1, coeffs=(nl, 1)),
            Ref("T3", "tmp", level=2, coeffs=(nj, 0, 1)),
            Ref("C0", "C", level=2, coeffs=(0, 1, nl),
                share_threshold=(1 * nl + 1) * nj + 1),
            Ref("D2", "D", level=2, coeffs=(nl, 1, 0)),
            Ref("D3", "D", level=2, coeffs=(nl, 1, 0)),
        ),
    )
    return Program(name=f"2mm-{ni}", nests=(nest1, nest2))
