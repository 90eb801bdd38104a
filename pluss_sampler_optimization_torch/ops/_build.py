"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each source in csrc/ is compiled on first use into
build/torch_kernels/ under the repository root, as a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
named by a digest of the source and the flags so an edited source
rebuilds. `-Xptxas -v` output (registers, spills) is kept beside the
library and returned by `build`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then the
    default toolkit location. Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from csrc/ at first use"
    )


def library_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(name: str, force: bool = False) -> tuple[str, str]:
    """Compile csrc/<name>.cu for sm_90a unless the library for this
    exact source exists. Returns (library path, nvcc's -Xptxas -v log).
    Raises RuntimeError with nvcc's output when the build fails."""
    out = library_path(name)
    log_path = out + ".log"
    if not force and os.path.exists(out):
        with open(log_path) as f:
            return out, f.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}"
        )
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, out)
    return out, log


def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path, _ = build(name)
            lib = ctypes.CDLL(path)
            _LIBS[name] = lib
        return lib
