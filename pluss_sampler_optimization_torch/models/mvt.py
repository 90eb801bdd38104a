"""PolyBench mvt as a PLUSS program.

The reference ships generated samplers only for GEMM; mvt follows the
same codegen conventions (statement-order references, operands in
source order then the write, share classification for references whose
address map omits the parallel induction variable — the rule documented
at ...ri-omp-seq.cpp:203-207) applied to PolyBench/C mvt:

    for (i < N) for (j < N)
      x1[i] = x1[i] + A[i][j] * y_1[j];   // X10, A0, Y10, X11
    for (i < N) for (j < N)
      x2[i] = x2[i] + A[j][i] * y_2[j];   // X20, A1, Y20, X21

Coverage this model adds over gemm/2mm/3mm/syrk:

- a *transposed* access A[j][i] (flat = j*N + i, coefficient on the
  inner variable larger than on the parallel one) — the closed-form
  next-use band enumeration (sampler/nextuse.py::_ref_vars orders
  coefficients descending) must treat the inner variable as the
  large-stride term;
- share references in a 2-deep nest (y_1/y_2 omit i). Their carried
  reuse across consecutive parallel iterations spans one inner loop of
  body accesses (~4N); the generated-code threshold family
  ((1*Tmid+1)*Tinner+1 at depth 3, ...ri-omp-seq.cpp:203) degenerates
  at depth 2 to 1*N+1, which separates the intra-line stride reuse
  (~body size) from the carried one exactly as GEMM's 16513 does.
"""

from __future__ import annotations

from ..ir import Loop, ParallelNest, Program, Ref


def mvt(n: int) -> Program:
    thr = 1 * n + 1
    nest1 = ParallelNest(
        loops=(Loop(n), Loop(n)),
        refs=(
            Ref("X10", "x1", level=1, coeffs=(1, 0)),
            Ref("A0", "A", level=1, coeffs=(n, 1)),
            Ref("Y10", "y_1", level=1, coeffs=(0, 1), share_threshold=thr),
            Ref("X11", "x1", level=1, coeffs=(1, 0)),
        ),
    )
    nest2 = ParallelNest(
        loops=(Loop(n), Loop(n)),
        refs=(
            Ref("X20", "x2", level=1, coeffs=(1, 0)),
            Ref("A1", "A", level=1, coeffs=(1, n)),  # A[j][i]
            Ref("Y20", "y_2", level=1, coeffs=(0, 1), share_threshold=thr),
            Ref("X21", "x2", level=1, coeffs=(1, 0)),
        ),
    )
    return Program(name=f"mvt-{n}", nests=(nest1, nest2))
