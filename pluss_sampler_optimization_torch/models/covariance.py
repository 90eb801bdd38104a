"""PolyBench covariance as a PLUSS program.

Three parallel nests over M features x N observations (data is N x M):

    for (j < M) {                                  // parallel over j
      mean[j] = 0;                                 // ME0
      for (i < N) mean[j] += data[i][j];           // ME1, D0, ME2
      mean[j] /= float_n;                          // ME3, ME4 (post)
    }
    for (i < N) for (j < M) data[i][j] -= mean[j]; // D1, ME5, D2
    for (i < M) for (j = i; j < M; j++) {          // upper triangle
      cov[i][j] = 0;                               // CV0
      for (k < N)
        cov[i][j] += data[k][i] * data[k][j];      // D3, D4, CV1, CV2
      cov[i][j] /= (float_n - 1);                  // CV3, CV4 (post)
      cov[j][i] = cov[i][j];                       // CV5, CV6 (post)
    }

Coverage this model adds: an *ascending-start* triangular level
(j from i: `Loop(trip=m, trip_coeff=-1, start_coeff=1)`), mixed
rectangular and triangular nests in one program over shared arrays
(data written in nest 2, read in nest 3; the per-nest LAT flush
separates them), a transposed column walk (data[i][j] with parallel j
in nest 1), and the symmetric write-back cov[j][i] whose flat map
swaps coefficient magnitudes within one statement group.

Share references: data[i][j] in nest 1 involves the parallel j;
mean[j] in nest 2 and data[k][j] in nest 3 omit their parallel
variable. Thresholds from the generated family at maximum trips
(models/syrk_tri.py).
"""

from __future__ import annotations

from ..ir import Loop, ParallelNest, Program, Ref


def covariance(m: int, n: int | None = None) -> Program:
    n = m if n is None else n
    nest_mean = ParallelNest(
        loops=(Loop(m), Loop(n)),
        refs=(
            Ref("ME0", "mean", level=0, coeffs=(1,)),
            Ref("ME1", "mean", level=1, coeffs=(1, 0)),
            Ref("D0", "data", level=1, coeffs=(1, m)),  # data[i][j], j par
            Ref("ME2", "mean", level=1, coeffs=(1, 0)),
            Ref("ME3", "mean", level=0, coeffs=(1,), slot="post"),
            Ref("ME4", "mean", level=0, coeffs=(1,), slot="post"),
        ),
    )
    nest_center = ParallelNest(
        loops=(Loop(n), Loop(m)),
        refs=(
            Ref("D1", "data", level=1, coeffs=(m, 1)),
            Ref("ME5", "mean", level=1, coeffs=(0, 1),
                share_threshold=1 * m + 1),
            Ref("D2", "data", level=1, coeffs=(m, 1)),
        ),
    )
    nest_cov = ParallelNest(
        loops=(
            Loop(m),
            Loop(trip=m, trip_coeff=-1, start_coeff=1),  # j in [i, m)
            Loop(n),
        ),
        refs=(
            Ref("CV0", "cov", level=1, coeffs=(m, 1)),
            Ref("D3", "data", level=2, coeffs=(1, 0, m)),  # data[k][i]
            Ref("D4", "data", level=2, coeffs=(0, 1, m),  # data[k][j]
                share_threshold=(1 * m + 1) * n + 1),
            Ref("CV1", "cov", level=2, coeffs=(m, 1, 0)),
            Ref("CV2", "cov", level=2, coeffs=(m, 1, 0)),
            Ref("CV3", "cov", level=1, coeffs=(m, 1), slot="post"),
            Ref("CV4", "cov", level=1, coeffs=(m, 1), slot="post"),
            Ref("CV5", "cov", level=1, coeffs=(m, 1), slot="post"),
            Ref("CV6", "cov", level=1, coeffs=(1, m), slot="post"),
        ),
    )
    return Program(
        name=f"covariance-{m}x{n}",
        nests=(nest_mean, nest_center, nest_cov),
    )
