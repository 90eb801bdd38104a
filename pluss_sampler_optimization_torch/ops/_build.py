"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each source in csrc/ is compiled on first use into
build/torch_kernels/ under the repository root, as a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
named by a digest of the source, the files it includes from csrc/
(`#include "name"`) and the flags, so an edited source rebuilds.
`-Xptxas -v` output (registers, spills) is kept beside the library and
returned by `build`. A library listed in PARTS compiles its source once
per set of `-D` defines there, all at once (one nvcc process each), and
links the objects into one library: the kernels of a part are the code
a single compile would give them, in a fraction of its time. Each nvcc run, and each make of native/
(`ensure_native`), is recorded in runtime/telemetry.py's build store
(`record_build`), and each library's first load in a process counts as a
cache hit (on disk already) or miss (built) there. A build holds a file
lock beside its library, so processes that start at once (the serving
fabric's workers) build a library once and load it whole.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Libraries built from parts: name -> the -D defines of each part.
# csrc/sampled_hist.cu: B1's rectangular instantiations with the entry,
# and its triangular ones; csrc/sampled_hist_buf.cu: B1's buffer form,
# and its per-row form for rows of at most one band-plan head per group
# and for up to three.
PARTS = {
    "sampled_hist": (("SAMPLED_HIST_TRI_PART=0",),
                     ("SAMPLED_HIST_TRI_PART=1",)),
    "sampled_hist_buf": ((), ("SAMPLED_HIST_ROWS_NHMAX=1",),
                         ("SAMPLED_HIST_ROWS_NHMAX=3",)),
}

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


def library_path(name: str, defines: tuple = ()) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        text = f.read()
    flags = " ".join(NVCC_FLAGS + tuple(defines))
    if not defines and name in PARTS:
        flags += " parts " + repr(PARTS[name])
    h = hashlib.sha256(text + flags.encode())
    for inc in re.findall(rb'^#include "([^"]+)"', text, re.M):
        with open(os.path.join(CSRC, inc.decode()), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(name: str, force: bool = False,
          defines: tuple = ()) -> tuple[str, str]:
    """Compile csrc/<name>.cu for sm_90a unless the library for this
    exact source and these `-D` defines (e.g. ("MAX_DESC=384",)) exists.
    Returns (library path, nvcc's -Xptxas -v log). Raises RuntimeError
    with nvcc's output when the build fails."""
    out = library_path(name, defines)
    log_path = out + ".log"
    if not force and os.path.exists(out):
        with open(log_path) as f:
            return out, f.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    # one build across processes: a process that finds the lock taken
    # waits for it, then loads what the holder renamed into place
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and os.path.exists(out):
            with open(log_path) as f:
                return out, f.read()
        return _build_locked(name, defines, out, log_path)


def _build_locked(name: str, defines: tuple, out: str,
                  log_path: str) -> tuple[str, str]:
    tmp = f"{out}.{os.getpid()}.tmp"
    src = os.path.join(CSRC, f"{name}.cu")
    t0 = time.perf_counter()
    if defines or name not in PARTS:
        cmd = [nvcc_path(), *NVCC_FLAGS, *(f"-D{x}" for x in defines),
               "-o", tmp, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        rc = proc.returncode
    else:
        log, rc = _build_parts(src, PARTS[name], tmp)
    _record_build(name, time.perf_counter() - t0)
    if rc != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (rc {rc}):\n{log}"
        )
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, out)
    return out, log


def _build_parts(src: str, parts, out: str) -> tuple[str, int]:
    """Compile `src` once per part's defines, all at once, and link the
    objects into the shared library `out`: (the logs, the first nonzero
    return code or 0)."""
    compile_flags = tuple(f for f in NVCC_FLAGS if f != "-shared")
    objs = [f"{out}.part{i}.o" for i in range(len(parts))]
    procs = [
        subprocess.Popen(
            [nvcc_path(), *compile_flags, *(f"-D{x}" for x in defines),
             "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for defines, obj in zip(parts, objs)
    ]
    logs, rc = [], 0
    for p in procs:
        logs.append(p.communicate()[0])
        rc = rc or p.returncode
    if rc == 0:
        link = subprocess.run(
            [nvcc_path(), "-shared", "-Xcompiler", "-fPIC", "-o", out, *objs],
            capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        rc = link.returncode
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    return "".join(logs), rc


def ptxas_report(log: str) -> list[dict]:
    """Per kernel entry of an `-Xptxas -v` log: its demangled name (a
    template argument kept, as `sampled_hist_kernel<2>`), registers,
    stack frame and spill bytes, in the log's order."""
    entries: dict = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            entries.setdefault(name, {"name": _demangle(name)})
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            name = m.group(1) if m.group(1) in entries else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            entries[name].update(stack=int(m.group(1)),
                                 spill_stores=int(m.group(2)),
                                 spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entries[name]["registers"] = int(m.group(1))
    return list(entries.values())


# Hopper's integer pipes, by SASS opcode: the ALU pipe (adds, logic,
# shifts, compares, selects, moves) and the FMA pipe (IMAD in all its
# forms, and the float multiply-adds) each take 16 lanes per clock per
# SM sub-partition, 64 per SM; each sub-partition issues one warp
# instruction per clock, 128 lanes per SM.
ALU_OPS = frozenset((
    "IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "ISETP", "ICMP",
    "SEL", "FSEL", "LEA", "PRMT", "MOV", "IABS", "IMNMX", "VIMNMX", "BMSK",
    "SGXT", "PLOP3", "P2R", "R2P", "FLO", "POPC", "BREV", "CSET", "CSETP",
))
FMA_OPS = frozenset(("IMAD", "IMUL", "FFMA", "FMUL", "FADD", "HFMA2",
                     "HADD2", "HMUL2"))
_SASS_LINE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)")


def cuobjdump_path() -> str:
    """cuobjdump beside nvcc (raises where there is none)."""
    path = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    if not os.path.exists(path):
        raise RuntimeError(f"cuobjdump not found at {path}")
    return path


def sass_counts(lib: str) -> dict:
    """count_sass of `cuobjdump -sass` on the library at `lib`."""
    return count_sass(subprocess.run(
        [cuobjdump_path(), "-sass", lib], check=True, capture_output=True,
        text=True).stdout)


def count_sass(out: str) -> dict:
    """{entry name (as ptxas_report names it): {"alu", "fma", "uniform",
    "other", "total": instructions}} of a `cuobjdump -sass` listing: each
    entry's instructions up to its last EXIT (the padding after it never
    runs), NOPs left out; "uniform" is the uniform datapath (U*
    opcodes), "other" memory, control and the rest."""
    counts: dict = {}
    name, ops = None, []

    def flush():
        if name is None:
            return
        last = max((i for i, op in enumerate(ops) if op == "EXIT"),
                   default=len(ops) - 1)
        c = {"alu": 0, "fma": 0, "uniform": 0, "other": 0}
        for op in ops[:last + 1]:
            if op == "NOP":
                continue
            base = op.split(".")[0]
            key = ("alu" if base in ALU_OPS else "fma" if base in FMA_OPS
                   else "uniform" if base.startswith("U") else "other")
            c[key] += 1
        c["total"] = sum(c.values())
        counts[_demangle(name)] = c

    for line in out.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            flush()
            name, ops = m.group(1), []
            continue
        m = _SASS_LINE.search(line)
        if m and name is not None:
            ops.append(m.group(1))
    flush()
    return counts


def _demangle(mangled: str) -> str:
    """`_Z19sampled_hist_kernelILi2ELi1EEv...` -> `sampled_hist_kernel<2, 1>`
    (int or bool template arguments; other names pass unchanged)."""
    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled
    n, at = int(m.group(1)), m.end()
    base = mangled[at:at + n]
    t = re.match(r"I((?:L[ib]\d+E)+)E", mangled[at + n:])
    if not t:
        return base
    args = [("true" if v == "1" else "false") if k == "b" else v
            for k, v in re.findall(r"L([ib])(\d+)E", t.group(1))]
    return f"{base}<{', '.join(args)}>"


def _record_build(name: str, seconds: float) -> None:
    from ..runtime import telemetry

    telemetry.record_build(name, seconds)


def ensure_native() -> None:
    """Make native/'s library where it is missing or older than its
    source (native.ensure_built's own test), and record the make."""
    from .. import native

    so, src = native._SO, native._SRC
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return
    t0 = time.perf_counter()
    native.ensure_built()
    _record_build("native", time.perf_counter() - t0)


def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            from ..runtime import telemetry

            telemetry.record_cache(os.path.exists(library_path(name)))
            path, _ = build(name)
            lib = ctypes.CDLL(path)
            _LIBS[name] = lib
        return lib
