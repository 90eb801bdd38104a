"""PolyBench trmm (4.2, lower-triangular left multiply) as a PLUSS program.

    for (i < M) for (j < N) {
      for (k = i+1; k < M; k++)
        B[i][j] += A[k][i] * B[k][j];   // A0, B0, B1, B2
      B[i][j] = alpha * B[i][j];        // B3, B4 (post slot, level 1)
    }

Coverage this model adds: a *descending* triangular level (the k-loop
shrinks as i grows: start i+1, trip M-1-i -> `Loop(trip=m-1,
trip_coeff=-1, start=1, start_coeff=1)`), reaching trip 0 at the last
parallel iteration, plus post-slot references at a level whose subloop
is triangular (their body offset varies per parallel value,
core/trace.py::ref_offset_at).

B0 = B[k][j] omits the parallel variable -> share reference; threshold
family evaluated at the triangular level's maximum trip as in
models/syrk_tri.py.
"""

from __future__ import annotations

from ..ir import Loop, ParallelNest, Program, Ref


def trmm(m: int, n: int | None = None) -> Program:
    n = m if n is None else n
    if m < 2:
        raise ValueError("trmm needs m >= 2")
    nest = ParallelNest(
        loops=(
            Loop(m),
            Loop(n),
            Loop(trip=m - 1, trip_coeff=-1, start=1, start_coeff=1),
        ),
        refs=(
            Ref("A0", "A", level=2, coeffs=(1, 0, m)),
            Ref("B0", "B", level=2, coeffs=(0, 1, n),
                share_threshold=(1 * n + 1) * (m - 1) + 1),
            Ref("B1", "B", level=2, coeffs=(n, 1, 0)),
            Ref("B2", "B", level=2, coeffs=(n, 1, 0)),
            Ref("B3", "B", level=1, coeffs=(n, 1), slot="post"),
            Ref("B4", "B", level=1, coeffs=(n, 1), slot="post"),
        ),
    )
    return Program(name=f"trmm-{m}x{n}", nests=(nest,))
