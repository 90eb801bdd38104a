"""PolyBench fdtd-2d as a PLUSS program.

Generated-sampler conventions as in models/gemm.py applied to
PolyBench/C fdtd-2d (2-D finite-difference time domain); each time step
contributes four parallel nests, unrolled into the program's nest list
like models/jacobi2d.py:

    for (t < TSTEPS) {
      for (j < NY) ey[0][j] = _fict_[t];                 // F0, EY0
      for (i in 1..NX) for (j < NY)
        ey[i][j] = ey[i][j] - 0.5*(hz[i][j]-hz[i-1][j]); // EY1,HZ0,HZ1,EY2
      for (i < NX) for (j in 1..NY)
        ex[i][j] = ex[i][j] - 0.5*(hz[i][j]-hz[i][j-1]); // EX0,HZ2,HZ3,EX1
      for (i < NX-1) for (j < NY-1)
        hz[i][j] = hz[i][j] - 0.7*(ex[i][j+1] - ex[i][j]
                 + ey[i+1][j] - ey[i][j]);     // HZ4,EX2,EX3,EY3,EY4,HZ5
    }

Coverage this model adds: a *constant* reference (_fict_[t], no loop
variable at all — every simulated thread races on its single line, and
its address map degenerates to the affine constant); boundary nests
whose loop `start`/trip differ per nest over the same arrays; and the
jacobi-style +/-1 and +/-NY stencil constants in both dimensions.

F0 omits the parallel variable -> share reference; at depth 1 the
carried-threshold family (1*t1+1)*t2+1 / 1*t+1 (models/mvt.py)
degenerates to 1.
"""

from __future__ import annotations

from ..ir import Loop, ParallelNest, Program, Ref


def fdtd2d(nx: int, ny: int | None = None, tsteps: int = 1) -> Program:
    ny = nx if ny is None else ny
    if nx < 2 or ny < 2:
        raise ValueError("fdtd2d needs nx, ny >= 2")
    nests = []
    for t in range(tsteps):
        nests.append(ParallelNest(
            loops=(Loop(ny),),
            refs=(
                Ref("F0", "fict", level=0, coeffs=(0,), const=t,
                    share_threshold=1),
                Ref("EY0", "ey", level=0, coeffs=(1,)),
            ),
        ))
        nests.append(ParallelNest(
            loops=(Loop(nx - 1, start=1), Loop(ny)),
            refs=(
                Ref("EY1", "ey", level=1, coeffs=(ny, 1)),
                Ref("HZ0", "hz", level=1, coeffs=(ny, 1)),
                Ref("HZ1", "hz", level=1, coeffs=(ny, 1), const=-ny),
                Ref("EY2", "ey", level=1, coeffs=(ny, 1)),
            ),
        ))
        nests.append(ParallelNest(
            loops=(Loop(nx), Loop(ny - 1, start=1)),
            refs=(
                Ref("EX0", "ex", level=1, coeffs=(ny, 1)),
                Ref("HZ2", "hz", level=1, coeffs=(ny, 1)),
                Ref("HZ3", "hz", level=1, coeffs=(ny, 1), const=-1),
                Ref("EX1", "ex", level=1, coeffs=(ny, 1)),
            ),
        ))
        nests.append(ParallelNest(
            loops=(Loop(nx - 1), Loop(ny - 1)),
            refs=(
                Ref("HZ4", "hz", level=1, coeffs=(ny, 1)),
                Ref("EX2", "ex", level=1, coeffs=(ny, 1), const=1),
                Ref("EX3", "ex", level=1, coeffs=(ny, 1)),
                Ref("EY3", "ey", level=1, coeffs=(ny, 1), const=ny),
                Ref("EY4", "ey", level=1, coeffs=(ny, 1)),
                Ref("HZ5", "hz", level=1, coeffs=(ny, 1)),
            ),
        ))
    return Program(name=f"fdtd2d-{nx}x{ny}-t{tsteps}", nests=tuple(nests))
