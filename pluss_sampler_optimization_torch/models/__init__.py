"""Benchmark models expressed in the loop-nest IR.

Each function returns a `Program` equivalent to one of the reference's
generated samplers (or the analogous PolyBench kernel for benchmarks the
reference's BASELINE configs name but ship no generated sampler for).
"""

from .adi import adi
from .atax import atax
from .bicg import bicg
from .covariance import covariance
from .doitgen import doitgen
from .fdtd2d import fdtd2d
from .gemm import gemm
from .gemver import gemver
from .gesummv import gesummv
from .heat3d import heat3d
from .jacobi2d import jacobi2d
from .mm2 import mm2
from .mm3 import mm3
from .mvt import mvt
from .syrk import syrk_rect
from .syrk_tri import syrk_tri
from .trisolv import trisolv
from .trmm import trmm

def build(name: str, n: int, tsteps: int = 1):
    """Build a registry model at size n (shared by cli.py and the
    analysis service). Raises KeyError for an unknown model and
    ValueError when tsteps is passed to a model without a time axis."""
    import inspect

    if name not in REGISTRY:
        raise KeyError(
            f"unknown model {name!r} (have {', '.join(sorted(REGISTRY))})"
        )
    fn = REGISTRY[name]
    if "tsteps" in inspect.signature(fn).parameters:
        return fn(n, tsteps=tsteps)
    if tsteps != 1:
        raise ValueError(f"model {name!r} has no time-step dimension")
    return fn(n)


REGISTRY = {
    "gemm": gemm,
    "2mm": mm2,
    "3mm": mm3,
    "syrk": syrk_rect,
    "jacobi-2d": jacobi2d,
    "mvt": mvt,
    "bicg": bicg,
    "gesummv": gesummv,
    "atax": atax,
    "gemver": gemver,
    "doitgen": doitgen,
    "fdtd-2d": fdtd2d,
    "heat-3d": heat3d,
    "syrk-tri": syrk_tri,
    "trmm": trmm,
    "trisolv": trisolv,
    "covariance": covariance,
    "adi": adi,
}

__all__ = [
    "gemm", "mm2", "mm3", "syrk_rect", "jacobi2d", "mvt", "bicg",
    "gesummv", "atax", "gemver", "doitgen", "fdtd2d", "heat3d",
    "syrk_tri", "trmm", "trisolv", "covariance", "adi", "REGISTRY",
    "build",
]
