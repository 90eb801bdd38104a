"""PolyBench atax as a PLUSS program.

Generated-sampler conventions as in models/gemm.py (statement order,
RHS operands in source order before the write, the classifier rule of
...ri-omp-seq.cpp:203-207) applied to PolyBench/C atax:

    for (i < NY) y[i] = 0;                    // nest 1: Y_init
    for (i < NX) {
      tmp[i] = 0;                             // T0
      for (j < NY) tmp[i] += A[i][j] * x[j];  // T1, A0, X0, T2
    }
    for (j < NY)                              // y-update, interchanged
      for (i < NX) y[j] += A[i][j] * tmp[i];  // Y1, A1, T3, Y2

The y-update loop carries a reduction over its source-order outer i, so
the parallel codegen (`#pragma pluss parallel`, the ppcg schedule the
reference's samplers were generated from, gemm.ppcg_omp.c:90) legalizes
it by interchange: the parallel variable is j and i becomes the inner
loop. That makes A1 a *transposed* walk (flat = i*NY + j, inner
coefficient NY > outer coefficient 1, the mvt A[j][i] pattern) and
tmp[i] a share reference (omits the parallel j).

Depth-2 carried-dependence thresholds 1*inner_trip+1 as in models/mvt.py.
"""

from __future__ import annotations

from ..ir import Loop, ParallelNest, Program, Ref


def atax(nx: int, ny: int | None = None) -> Program:
    ny = nx if ny is None else ny
    nest1 = ParallelNest(
        loops=(Loop(ny),),
        refs=(Ref("Y0", "y", level=0, coeffs=(1,)),),
    )
    nest2 = ParallelNest(
        loops=(Loop(nx), Loop(ny)),
        refs=(
            Ref("T0", "tmp", level=0, coeffs=(1,)),
            Ref("T1", "tmp", level=1, coeffs=(1, 0)),
            Ref("A0", "A", level=1, coeffs=(ny, 1)),
            Ref("X0", "x", level=1, coeffs=(0, 1), share_threshold=1 * ny + 1),
            Ref("T2", "tmp", level=1, coeffs=(1, 0)),
        ),
    )
    nest3 = ParallelNest(
        loops=(Loop(ny), Loop(nx)),
        refs=(
            Ref("Y1", "y", level=1, coeffs=(1, 0)),
            Ref("A1", "A", level=1, coeffs=(1, ny)),  # A[i][j], i inner
            Ref("T3", "tmp", level=1, coeffs=(0, 1),
                share_threshold=1 * nx + 1),
            Ref("Y2", "y", level=1, coeffs=(1, 0)),
        ),
    )
    return Program(name=f"atax-{nx}x{ny}", nests=(nest1, nest2, nest3))
