"""PolyBench adi (alternating-direction implicit solver) as a PLUSS program.

Each time step performs a column sweep then a row sweep; each sweep is
a forward recurrence followed by a *backward* substitution (PolyBench/C
4.2, scalars a..f unmodeled as usual). Column sweep:

    for (i in 1..N-1) {                       // parallel i
      v[0][i] = 1; p[i][0] = 0; q[i][0] = v[0][i];
      for (j in 1..N-1) {
        p[i][j] = -c / (a*p[i][j-1] + b);
        q[i][j] = (-d*u[j][i-1] + (1+2d)*u[j][i] - f*u[j][i+1]
                   - a*q[i][j-1]) / (a*p[i][j-1] + b);
      }
      v[N-1][i] = 1;
      for (j = N-2; j >= 1; j--)
        v[j][i] = p[i][j] * v[j+1][i] + q[i][j];
    }

The row sweep is the transposed mirror: u is written row-major
(u[i][j]), the source reads are v[i-1][j], v[i][j], v[i+1][j], and the
backward substitution runs u[i][j] = p[i][j]*u[i][j+1] + q[i][j].

The sibling forward/backward loops inside one parallel iteration are
distributed into separate parallel regions (the doitgen pattern). The
backward substitutions are *descending* inner loops
(`Loop(trip=n-2, start=n-2, step=-1)`) — trace positions follow the
normalized index (execution order) while address maps use the
iteration values, exactly the split core/trace.py encodes; no other
model exercises a negative inner step. Every reference involves the
parallel variable, so there are no share references (the stencil
boundary sharing sits below the classifier's radar as in
models/jacobi2d.py). Reference order per statement: RHS reads in
source order, then the write (models/mvt.py conventions).
"""

from __future__ import annotations

from ..ir import Loop, ParallelNest, Program, Ref


def _sweep(n: int, column: bool, src: str, dst: str):
    """(forward-recurrence nest, backward nest) of one ADI sweep.

    `column` selects the column sweep's indexing (dst inner-major
    dst[j][i], src rows along the parallel axis); the row sweep uses
    dst[i][j] and src columns.
    """
    inner = Loop(n - 2, start=1)
    back = Loop(n - 2, start=n - 2, step=-1)
    pq = (n, 1)  # p[i][j], q[i][j] in both sweeps
    if column:
        dst0 = ((1,), 0)  # dst[0][i]
        dstN = ((1,), n * (n - 1))  # dst[N-1][i]
        s_c, s_lo, s_hi = (1, n), -1, 1  # src[j][i -/+ 1]
        d_c, d_nxt = (1, n), n  # dst[j][i], dst[j+1][i]
    else:
        dst0 = ((n,), 0)  # dst[i][0]
        dstN = ((n,), n - 1)  # dst[i][N-1]
        s_c, s_lo, s_hi = (n, 1), -n, n  # src[i -/+ 1][j]
        d_c, d_nxt = (n, 1), 1  # dst[i][j], dst[i][j+1]
    fwd = ParallelNest(
        loops=(Loop(n - 2, start=1), inner),
        refs=(
            Ref("D0", dst, level=0, coeffs=dst0[0], const=dst0[1]),
            Ref("P0", "p", level=0, coeffs=(n,)),
            Ref("D1", dst, level=0, coeffs=dst0[0], const=dst0[1]),
            Ref("Q0", "q", level=0, coeffs=(n,)),
            Ref("P1", "p", level=1, coeffs=pq, const=-1),
            Ref("P2", "p", level=1, coeffs=pq),
            Ref("S0", src, level=1, coeffs=s_c, const=s_lo),
            Ref("S1", src, level=1, coeffs=s_c),
            Ref("S2", src, level=1, coeffs=s_c, const=s_hi),
            Ref("Q1", "q", level=1, coeffs=pq, const=-1),
            Ref("P3", "p", level=1, coeffs=pq, const=-1),
            Ref("Q2", "q", level=1, coeffs=pq),
            Ref("D2", dst, level=0, coeffs=dstN[0], const=dstN[1],
                slot="post"),
        ),
    )
    bwd = ParallelNest(
        loops=(Loop(n - 2, start=1), back),
        refs=(
            Ref("P4", "p", level=1, coeffs=pq),
            Ref("D3", dst, level=1, coeffs=d_c, const=d_nxt),
            Ref("Q3", "q", level=1, coeffs=pq),
            Ref("D4", dst, level=1, coeffs=d_c),
        ),
    )
    return fwd, bwd


def adi(n: int, tsteps: int = 1) -> Program:
    """u <-> v alternate as source/destination across the two sweeps."""
    if n < 3:
        raise ValueError("adi needs n >= 3")
    nests: list[ParallelNest] = []
    for _ in range(tsteps):
        nests.extend(_sweep(n, True, "u", "v"))
        nests.extend(_sweep(n, False, "v", "u"))
    return Program(name=f"adi-{n}-t{tsteps}", nests=tuple(nests))
