"""PolyBench syrk, triangular (4.2) form, as a PLUSS program.

models/syrk.py covers the rectangular 3.2 variant; this is the 4.2
kernel whose inner j-loop runs only over the lower triangle:

    for (i < N) {
      for (j <= i) C[i][j] *= beta;                     // C0, C1
      for (k < M)
        for (j <= i) C[i][j] += alpha*A[i][k]*A[j][k];  // A0, A1, C2, C3
    }

The two sibling loops inside one i-iteration are distributed into two
parallel regions (the doitgen pattern, models/doitgen.py); the j levels
are triangular with trip i+1 (`Loop(trip=1, trip_coeff=1)`).

A1 = A[j][k] omits the parallel variable -> share reference. The
carried-threshold family of the generated code ((1*t_mid+1)*t_inner+1,
...ri-omp-seq.cpp:203) is evaluated at the triangular level's maximum
trip, the threshold a codegen run at the full rectangular bounding box
would emit.
"""

from __future__ import annotations

from ..ir import Loop, ParallelNest, Program, Ref


def syrk_tri(n: int, m: int | None = None) -> Program:
    m = n if m is None else m
    tri = Loop(trip=1, trip_coeff=1)  # j in [0, i]
    nest1 = ParallelNest(
        loops=(Loop(n), tri),
        refs=(
            Ref("C0", "C", level=1, coeffs=(n, 1)),
            Ref("C1", "C", level=1, coeffs=(n, 1)),
        ),
    )
    nest2 = ParallelNest(
        loops=(Loop(n), Loop(m), tri),
        refs=(
            Ref("A0", "A", level=2, coeffs=(m, 1, 0)),
            Ref("A1", "A", level=2, coeffs=(0, 1, m),
                share_threshold=(1 * m + 1) * n + 1),
            Ref("C2", "C", level=2, coeffs=(n, 0, 1)),
            Ref("C3", "C", level=2, coeffs=(n, 0, 1)),
        ),
    )
    return Program(name=f"syrk-tri-{n}x{m}", nests=(nest1, nest2))
