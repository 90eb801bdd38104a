"""PolyBench syrk (rectangular 3.2 variant) as a PLUSS program.

BASELINE.json config 4 names syrk. PolyBench/C 3.2's syrk is the
rectangular form; the 4.2 triangular form is models/syrk_tri.py:

    for (i < N) for (j < N) C[i][j] *= beta;              // C0,C1
    for (i < N) for (j < N)
      for (k < M) C[i][j] += alpha*A[i][k]*A[j][k];       // A0,A1,C2,C3

A1 = A[j][k] omits the parallel variable i -> share reference; note both
A0 and A1 hit the *same* array, the case where one array has both a
private-reuse and a shared-reuse reference.
"""

from __future__ import annotations

from ..ir import Loop, ParallelNest, Program, Ref


def syrk_rect(n: int, m: int | None = None) -> Program:
    m = n if m is None else m
    nest1 = ParallelNest(
        loops=(Loop(n), Loop(n)),
        refs=(
            Ref("C0", "C", level=1, coeffs=(n, 1)),
            Ref("C1", "C", level=1, coeffs=(n, 1)),
        ),
    )
    nest2 = ParallelNest(
        loops=(Loop(n), Loop(n), Loop(m)),
        refs=(
            Ref("A0", "A", level=2, coeffs=(m, 0, 1)),
            Ref("A1", "A", level=2, coeffs=(0, m, 1),
                share_threshold=(1 * n + 1) * m + 1),
            Ref("C2", "C", level=2, coeffs=(n, 1, 0)),
            Ref("C3", "C", level=2, coeffs=(n, 1, 0)),
        ),
    )
    return Program(name=f"syrk-{n}", nests=(nest1, nest2))
