"""PolyBench gesummv as a PLUSS program.

Generated-sampler conventions as in models/gemm.py applied to
PolyBench/C gesummv:

    for (i < N) {
      tmp[i] = 0;                             // T0
      y[i]   = 0;                             // Y0
      for (j < N) {
        tmp[i] = A[i][j] * x[j] + tmp[i];     // A0, X0, T1, T2
        y[i]   = B[i][j] * x[j] + y[i];       // B0, X1, Y1, Y2
      }
      y[i] = alpha * tmp[i] + beta * y[i];    // T3, Y3, Y4  (after the
    }                                         //  subloop: slot="post")

Coverage this model adds: level-0 references *after* the inner loop
(slot="post", the IR's placement arm that gemm/2mm/3mm/syrk/jacobi
never exercise — ref_body_offset must account for the whole subloop,
ir.py::ParallelNest.ref_body_offset), plus one share array (x) read by
two references in different statements. Depth-2 carried threshold
1*N+1 as in models/mvt.py.
"""

from __future__ import annotations

from ..ir import Loop, ParallelNest, Program, Ref


def gesummv(n: int) -> Program:
    thr = 1 * n + 1
    nest = ParallelNest(
        loops=(Loop(n), Loop(n)),
        refs=(
            Ref("T0", "tmp", level=0, coeffs=(1,)),
            Ref("Y0", "y", level=0, coeffs=(1,)),
            Ref("A0", "A", level=1, coeffs=(n, 1)),
            # x[j] is read by BOTH statements: the duplicated map is two
            # loads, not a read-modify-write pair (write=False keeps the
            # race detector from deriving a store here)
            Ref("X0", "x", level=1, coeffs=(0, 1), share_threshold=thr,
                write=False),
            Ref("T1", "tmp", level=1, coeffs=(1, 0)),
            Ref("T2", "tmp", level=1, coeffs=(1, 0)),
            Ref("B0", "B", level=1, coeffs=(n, 1)),
            Ref("X1", "x", level=1, coeffs=(0, 1), share_threshold=thr,
                write=False),
            Ref("Y1", "y", level=1, coeffs=(1, 0)),
            Ref("Y2", "y", level=1, coeffs=(1, 0)),
            Ref("T3", "tmp", level=0, coeffs=(1,), slot="post"),
            Ref("Y3", "y", level=0, coeffs=(1,), slot="post"),
            Ref("Y4", "y", level=0, coeffs=(1,), slot="post"),
        ),
    )
    return Program(name=f"gesummv-{n}", nests=(nest,))
