"""PolyBench GEMM as a PLUSS program.

Source kernel: c_lib/test/gemm.ppcg_omp.c:86-100 —

    #pragma pluss parallel
    for (c0 in 0..NI)            // parallel, static chunks
      for (c1 in 0..NJ) {
        C[c0][c1] *= beta;       // refs C0 (read), C1 (write)
        for (c2 in 0..NK)
          C[c0][c1] += alpha * A[c0][c2] * B[c2][c1];
                                 // refs A0, B0, C2 (read), C3 (write)
      }

Reference-name mapping documented at gemm.ppcg_omp.c:93-95; access order
C0 -> C1 -> A0 -> B0 -> C2 -> C3 is the generated state machine
(...ri-omp-seq.cpp:102-265). Address maps are GetAddress_*
(...ri-omp-seq.cpp:12-35): flat = idx0*N + idx1.

B0 is the only cross-thread ("share") reference: B[c2][c1] does not
involve the parallel variable c0, so all simulated threads race on its
lines. The generated classifier compares the private reuse against a
carried-dependence threshold:

- full-traversal variants: (1*N+1)*N+1  (= 16513 at N=128,
  ...ri-omp-seq.cpp:203);
- sampled r10 variant:     (4*N+2)*N    (= 65792 at N=128,
  ...rs-ri-opt-r10.cpp:2482) — one full c0-iteration of accesses.
"""

from __future__ import annotations

from ..ir import Loop, ParallelNest, Program, Ref


def gemm(n: int, ni: int | None = None, nj: int | None = None, nk: int | None = None,
         share_threshold_variant: str = "ri") -> Program:
    """GEMM program; `n` is the default for all three trip counts."""
    ni = n if ni is None else ni
    nj = n if nj is None else nj
    nk = n if nk is None else nk
    if share_threshold_variant == "ri":
        b0_threshold = (1 * nj + 1) * nk + 1  # ...ri-omp-seq.cpp:203
    elif share_threshold_variant == "r10":
        b0_threshold = (4 * nk + 2) * nj  # ...rs-ri-opt-r10.cpp:2482
    else:
        raise ValueError("share_threshold_variant must be 'ri' or 'r10'")

    nest = ParallelNest(
        loops=(Loop(ni), Loop(nj), Loop(nk)),
        refs=(
            Ref("C0", "C", level=1, coeffs=(nj, 1)),
            Ref("C1", "C", level=1, coeffs=(nj, 1)),
            Ref("A0", "A", level=2, coeffs=(nk, 0, 1)),
            Ref("B0", "B", level=2, coeffs=(0, 1, nj), share_threshold=b0_threshold),
            Ref("C2", "C", level=2, coeffs=(nj, 1, 0)),
            Ref("C3", "C", level=2, coeffs=(nj, 1, 0)),
        ),
    )
    return Program(name=f"gemm-{ni}x{nj}x{nk}", nests=(nest,))
