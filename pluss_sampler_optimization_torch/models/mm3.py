"""PolyBench 3mm as a PLUSS program (BASELINE.json config 4).

Same codegen conventions as models/gemm.py applied to PolyBench/C 3mm:

    for (i < NI) for (j < NJ) { E[i][j] = 0;              // E0 (write)
      for (k < NK) E[i][j] += A[i][k]*B[k][j]; }          // A0,B0,E1,E2
    for (i < NJ) for (j < NL) { F[i][j] = 0;              // F0
      for (k < NM) F[i][j] += C[i][k]*D[k][j]; }          // C0,D0,F1,F2
    for (i < NI) for (j < NL) { G[i][j] = 0;              // G0
      for (k < NJ) G[i][j] += E[i][k]*F[k][j]; }          // E3,F3,G1,G2

B0, D0 and F3 omit the parallel variable -> share references. E and F
carry cross-nest reuse into nest 3.
"""

from __future__ import annotations

from ..ir import Loop, ParallelNest, Program, Ref


def mm3(n: int, ni: int | None = None, nj: int | None = None, nk: int | None = None,
        nl: int | None = None, nm: int | None = None) -> Program:
    ni = n if ni is None else ni
    nj = n if nj is None else nj
    nk = n if nk is None else nk
    nl = n if nl is None else nl
    nm = n if nm is None else nm

    nest1 = ParallelNest(
        loops=(Loop(ni), Loop(nj), Loop(nk)),
        refs=(
            Ref("E0", "E", level=1, coeffs=(nj, 1)),
            Ref("A0", "A", level=2, coeffs=(nk, 0, 1)),
            Ref("B0", "B", level=2, coeffs=(0, 1, nj),
                share_threshold=(1 * nj + 1) * nk + 1),
            Ref("E1", "E", level=2, coeffs=(nj, 1, 0)),
            Ref("E2", "E", level=2, coeffs=(nj, 1, 0)),
        ),
    )
    nest2 = ParallelNest(
        loops=(Loop(nj), Loop(nl), Loop(nm)),
        refs=(
            Ref("F0", "F", level=1, coeffs=(nl, 1)),
            Ref("C0", "C", level=2, coeffs=(nm, 0, 1)),
            Ref("D0", "D", level=2, coeffs=(0, 1, nl),
                share_threshold=(1 * nl + 1) * nm + 1),
            Ref("F1", "F", level=2, coeffs=(nl, 1, 0)),
            Ref("F2", "F", level=2, coeffs=(nl, 1, 0)),
        ),
    )
    nest3 = ParallelNest(
        loops=(Loop(ni), Loop(nl), Loop(nj)),
        refs=(
            Ref("G0", "G", level=1, coeffs=(nl, 1)),
            Ref("E3", "E", level=2, coeffs=(nj, 0, 1)),
            Ref("F3", "F", level=2, coeffs=(0, 1, nl),
                share_threshold=(1 * nl + 1) * nj + 1),
            Ref("G1", "G", level=2, coeffs=(nl, 1, 0)),
            Ref("G2", "G", level=2, coeffs=(nl, 1, 0)),
        ),
    )
    return Program(name=f"3mm-{ni}", nests=(nest1, nest2, nest3))
