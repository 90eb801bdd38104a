"""PolyBench jacobi-2d as a PLUSS program (BASELINE.json config 5).

The stencil/long-trace configuration: each time step contributes two
2-deep parallel nests (PolyBench/C jacobi-2d-imper):

    for (t < TSTEPS) {
      for (i in 1..N-1) for (j in 1..N-1)
        B[i][j] = 0.2*(A[i][j]+A[i][j-1]+A[i][1+j]+A[1+i][j]+A[i-1][j]);
      for (i in 1..N-1) for (j in 1..N-1)
        A[i][j] = B[i][j];
    }

The sequential t loop is unrolled into the program's nest list (the
reference codegen emits one dispatcher per parallel loop and keeps one
runtime across them, ...ri-omp-seq.cpp:59-60). Loop starts are 1, which
exercises non-zero `start` in the chunk arithmetic (pluss_utils.h:312).
All references involve the parallel variable i -> no share references;
cross-thread boundary-row sharing (A[i-1], A[1+i]) is below the share
classifier's radar exactly as it would be in the reference's codegen.
"""

from __future__ import annotations

from ..ir import Loop, ParallelNest, Program, Ref


def jacobi2d(n: int, tsteps: int = 1) -> Program:
    if n < 3:
        raise ValueError("jacobi2d needs n >= 3")
    inner = Loop(n - 2, start=1)
    nest_b = ParallelNest(
        loops=(inner, inner),
        refs=(
            Ref("A0", "A", level=1, coeffs=(n, 1)),
            Ref("A1", "A", level=1, coeffs=(n, 1), const=-1),
            Ref("A2", "A", level=1, coeffs=(n, 1), const=1),
            Ref("A3", "A", level=1, coeffs=(n, 1), const=n),
            Ref("A4", "A", level=1, coeffs=(n, 1), const=-n),
            Ref("B0", "B", level=1, coeffs=(n, 1)),
        ),
    )
    nest_a = ParallelNest(
        loops=(inner, inner),
        refs=(
            Ref("B1", "B", level=1, coeffs=(n, 1)),
            Ref("A5", "A", level=1, coeffs=(n, 1)),
        ),
    )
    return Program(name=f"jacobi2d-{n}-t{tsteps}", nests=(nest_b, nest_a) * tsteps)
