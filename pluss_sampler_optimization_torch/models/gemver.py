"""PolyBench gemver as a PLUSS program.

Generated-sampler conventions as in models/gemm.py applied to
PolyBench/C gemver (scalars alpha/beta are unmodeled, exactly as the
reference's GEMM sampler models no scalar operands):

    for (i < N) for (j < N)
      A[i][j] = A[i][j] + u1[i]*v1[j] + u2[i]*v2[j];
                                     // A0, U10, V10, U20, V20, A1
    for (i < N) for (j < N)
      x[i] = x[i] + beta * A[j][i] * y[j];   // X0, A2, Y0, X1
    for (i < N) x[i] = x[i] + z[i];          // X2, Z0, X3
    for (i < N) for (j < N)
      w[i] = w[i] + alpha * A[i][j] * x[j];  // W0, A3, X4, W1

Coverage this model adds: four nests of mixed depth over one shared
array A that is written in nest 1, read transposed (A[j][i]) in nest 2
and read row-major in nest 4 — the per-nest LAT flush
(...ri-omp-seq.cpp:303-319) makes each nest's A reuse start cold; and
x crosses nests as well (written in 2/3, share-read in 4).

Depth-2 carried thresholds 1*N+1 as in models/mvt.py.
"""

from __future__ import annotations

from ..ir import Loop, ParallelNest, Program, Ref


def gemver(n: int) -> Program:
    thr = 1 * n + 1
    nest1 = ParallelNest(
        loops=(Loop(n), Loop(n)),
        refs=(
            Ref("A0", "A", level=1, coeffs=(n, 1)),
            Ref("U10", "u1", level=1, coeffs=(1, 0)),
            Ref("V10", "v1", level=1, coeffs=(0, 1), share_threshold=thr),
            Ref("U20", "u2", level=1, coeffs=(1, 0)),
            Ref("V20", "v2", level=1, coeffs=(0, 1), share_threshold=thr),
            Ref("A1", "A", level=1, coeffs=(n, 1)),
        ),
    )
    nest2 = ParallelNest(
        loops=(Loop(n), Loop(n)),
        refs=(
            Ref("X0", "x", level=1, coeffs=(1, 0)),
            Ref("A2", "A", level=1, coeffs=(1, n)),  # A[j][i]
            Ref("Y0", "y", level=1, coeffs=(0, 1), share_threshold=thr),
            Ref("X1", "x", level=1, coeffs=(1, 0)),
        ),
    )
    nest3 = ParallelNest(
        loops=(Loop(n),),
        refs=(
            Ref("X2", "x", level=0, coeffs=(1,)),
            Ref("Z0", "z", level=0, coeffs=(1,)),
            Ref("X3", "x", level=0, coeffs=(1,)),
        ),
    )
    nest4 = ParallelNest(
        loops=(Loop(n), Loop(n)),
        refs=(
            Ref("W0", "w", level=1, coeffs=(1, 0)),
            Ref("A3", "A", level=1, coeffs=(n, 1)),
            Ref("X4", "x", level=1, coeffs=(0, 1), share_threshold=thr),
            Ref("W1", "w", level=1, coeffs=(1, 0)),
        ),
    )
    return Program(name=f"gemver-{n}", nests=(nest1, nest2, nest3, nest4))
