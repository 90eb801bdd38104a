"""PolyBench heat-3d as a PLUSS program.

Generated-sampler conventions as in models/gemm.py applied to
PolyBench heat-3d (3-D heat equation); each time step contributes two
3-deep parallel nests (B from A, then A from B), unrolled like
models/jacobi2d.py:

    for (i,j,k in 1..N-1)^3
      B[i][j][k] = 0.125*(A[i+1][j][k] - 2*A[i][j][k] + A[i-1][j][k])
                 + 0.125*(A[i][j+1][k] - 2*A[i][j][k] + A[i][j-1][k])
                 + 0.125*(A[i][j][k+1] - 2*A[i][j][k] + A[i][j][k-1])
                 + A[i][j][k];
    ... then the same statement with A and B swapped.

RHS reads in source order (A0..A9, three of them the repeated center
point), then the write (B0). Coverage this model adds: references whose
flat map has THREE nonzero coefficients (N*N, N, 1) — the next-use
band enumeration must recurse through two stride levels before the
unit-stride window (sampler/nextuse.py) — with +/-N^2 plane-stencil
constants. All references involve the parallel variable i, so there are
no share references, exactly as models/jacobi2d.py.
"""

from __future__ import annotations

from ..ir import Loop, ParallelNest, Program, Ref


def _stencil_refs(read: str, write: str, n: int) -> tuple[Ref, ...]:
    c = (n * n, n, 1)
    reads = [n * n, 0, -n * n, n, 0, -n, 1, 0, -1, 0]
    # the center point repeats four times among the RHS reads; write=False
    # keeps the race detector's duplicated-map convention from deriving a
    # store out of them (the store goes to the OTHER array)
    refs = [
        Ref(f"{read.upper()}{k}", read, level=2, coeffs=c, const=d,
            write=False)
        for k, d in enumerate(reads)
    ]
    refs.append(Ref(f"{write.upper()}W", write, level=2, coeffs=c,
                    write=True))
    return tuple(refs)


def heat3d(n: int, tsteps: int = 1) -> Program:
    if n < 3:
        raise ValueError("heat3d needs n >= 3")
    inner = Loop(n - 2, start=1)
    nest_b = ParallelNest(
        loops=(inner, inner, inner), refs=_stencil_refs("a", "b", n)
    )
    nest_a = ParallelNest(
        loops=(inner, inner, inner), refs=_stencil_refs("b", "a", n)
    )
    return Program(name=f"heat3d-{n}-t{tsteps}", nests=(nest_b, nest_a) * tsteps)
