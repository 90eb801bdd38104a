"""PolyBench bicg as a PLUSS program.

Generated-sampler conventions as in models/gemm.py (statement order,
RHS operands in source order before the write — the C2/C3 pattern of
...ri-omp-seq.cpp:102-265) applied to PolyBench/C bicg:

    for (i < M) s[i] = 0;                     // nest 1: S_init
    for (i < N) {
      q[i] = 0;                               // Q0
      for (j < M) {
        s[j] = s[j] + r[i] * A[i][j];         // S0, R0, A0, S1
        q[i] = q[i] + A[i][j] * p[j];         // Q1, A1, P0, Q2
      }
    }

Coverage this model adds:

- a 1-deep parallel nest (level-0 references only) ahead of a 2-deep
  one, so thread clocks advance across a nest whose body has no
  subloop;
- share references that are *written* (s[j] omits i and statement 1
  stores to it): both the read S0 and the write S1 classify per access
  against the carried threshold, like GEMM's read-only B0;
- two distinct references to the same array element within one
  statement pair (A0/A1 back to back) producing constant short reuses.

Depth-2 carried-dependence threshold 1*M+1 as in models/mvt.py.
"""

from __future__ import annotations

from ..ir import Loop, ParallelNest, Program, Ref


def bicg(n: int, m: int | None = None) -> Program:
    m = n if m is None else m
    thr = 1 * m + 1
    nest1 = ParallelNest(
        loops=(Loop(m),),
        refs=(Ref("SI", "s", level=0, coeffs=(1,)),),
    )
    nest2 = ParallelNest(
        loops=(Loop(n), Loop(m)),
        refs=(
            Ref("Q0", "q", level=0, coeffs=(1,)),
            Ref("S0", "s", level=1, coeffs=(0, 1), share_threshold=thr),
            Ref("R0", "r", level=1, coeffs=(1, 0)),
            Ref("A0", "A", level=1, coeffs=(m, 1)),
            Ref("S1", "s", level=1, coeffs=(0, 1), share_threshold=thr),
            Ref("Q1", "q", level=1, coeffs=(1, 0)),
            Ref("A1", "A", level=1, coeffs=(m, 1)),
            Ref("P0", "p", level=1, coeffs=(0, 1), share_threshold=thr),
            Ref("Q2", "q", level=1, coeffs=(1, 0)),
        ),
    )
    return Program(name=f"bicg-{n}x{m}", nests=(nest1, nest2))
