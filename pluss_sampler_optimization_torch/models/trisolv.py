"""PolyBench trisolv (lower-triangular solve) as a PLUSS program.

    for (i < N) {
      x[i] = b[i];                          // B0, X0
      for (j < i)
        x[i] = x[i] - L[i][j] * x[j];       // X1, L0, X2, X3
      x[i] = x[i] / L[i][i];                // X4, L1, X5 (post, level 0)
    }

The source loop carries x[j] dependences across i; the PLUSS machine
models the static-chunk parallel schedule of the annotated loop exactly
as the reference would for any `#pragma pluss parallel` nest (the model
measures locality of the interleaving, not legality).

Coverage this model adds: a triangular level whose trip is *zero* at
the first parallel iterations (`Loop(trip=0, trip_coeff=1)`), post-slot
level-0 refs after a triangular subloop, a diagonal reference
(L[i][i] -> coefficient N+1), and a share reference (x[j], omits i)
that is also written at the same level. Depth-2 threshold family
1*T+1 at the maximum trip (models/mvt.py).
"""

from __future__ import annotations

from ..ir import Loop, ParallelNest, Program, Ref


def trisolv(n: int) -> Program:
    if n < 2:
        raise ValueError("trisolv needs n >= 2")
    thr = 1 * (n - 1) + 1
    nest = ParallelNest(
        loops=(Loop(n), Loop(trip=0, trip_coeff=1)),  # j in [0, i)
        refs=(
            Ref("B0", "b", level=0, coeffs=(1,)),
            Ref("X0", "x", level=0, coeffs=(1,)),
            Ref("X1", "x", level=1, coeffs=(1, 0)),
            Ref("L0", "L", level=1, coeffs=(n, 1)),
            Ref("X2", "x", level=1, coeffs=(0, 1), share_threshold=thr),
            Ref("X3", "x", level=1, coeffs=(1, 0)),
            Ref("X4", "x", level=0, coeffs=(1,), slot="post"),
            Ref("L1", "L", level=0, coeffs=(n + 1,), slot="post"),
            Ref("X5", "x", level=0, coeffs=(1,), slot="post"),
        ),
    )
    return Program(name=f"trisolv-{n}", nests=(nest,))
