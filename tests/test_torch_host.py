"""The PyTorch port's host layer against the JAX package (exact).

The port (pluss_sampler_optimization_torch) keeps its own copies of the
JAX package's jax-free modules; these tests pin the copies to the
originals, check that the trace tables and value overlays agree for
every registry model, that the CRI/AET stages give identical output on
oracle states, and that the tensor `sorted_k_unique` equals the JAX one.
They also pin the port's entry-point rules: no JAX in its process, CUDA
unless the CPU is asked for, and NotImplementedError for what this slice
does not run. Inputs are made from numpy seeds; every comparison is
exact.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_thread_env, one_torch_thread  # noqa: F401
from _torch_made import tri_step2_program

import pluss_sampler_optimization_torch as T
import pluss_sampler_optimization_tpu as J
from pluss_sampler_optimization_torch.core.trace import ProgramTrace as TTrace
from pluss_sampler_optimization_torch.ir import (
    Loop as TLoop,
    ParallelNest as TNest,
    Program as TProgram,
    Ref as TRef,
)
from pluss_sampler_optimization_torch.models import REGISTRY as T_MODELS
from pluss_sampler_optimization_torch.ops.histogram import (
    sorted_k_unique as t_sorted_k_unique,
)
from pluss_sampler_optimization_torch.runtime import aet as t_aet
from pluss_sampler_optimization_torch.runtime import cri as t_cri
from pluss_sampler_optimization_torch.runtime import report as t_report
from pluss_sampler_optimization_torch.runtime.hist import PRIState as TState
from pluss_sampler_optimization_tpu.core.trace import ProgramTrace as JTrace
from pluss_sampler_optimization_tpu.models import REGISTRY as J_MODELS
from pluss_sampler_optimization_tpu.ops.histogram import (
    sorted_k_unique as j_sorted_k_unique,
)
from pluss_sampler_optimization_tpu.oracle import run_numpy
from pluss_sampler_optimization_tpu.runtime import aet as j_aet
from pluss_sampler_optimization_tpu.runtime import cri as j_cri
from pluss_sampler_optimization_tpu.runtime import report as j_report

ROOT = os.path.join(os.path.dirname(__file__), "..")
TPU = os.path.join(ROOT, "pluss_sampler_optimization_tpu")
TORCH = os.path.join(ROOT, "pluss_sampler_optimization_torch")

# modules the port copies verbatim (relative imports make the bytes equal)
COPIED = (
    ["ir.py", "core/__init__.py", "core/schedule.py", "core/trace.py"]
    + [f"models/{f}" for f in sorted(os.listdir(os.path.join(TPU, "models")))
       if f.endswith(".py")]
    + [f"runtime/{f}" for f in ("hist.py", "pristate_typing.py", "cri.py",
                                "aet.py", "report.py", "baseline.py",
                                "timing.py", "debug.py")]
    + [f"oracle/{f}" for f in ("__init__.py", "serial.py", "numpy_ref.py",
                               "profiler.py")]
    + ["runtime/io.py"]
    + [f"native/{f}" for f in ("__init__.py", "pluss_native.cpp",
                               "Makefile")]
    + [f"analysis/{f}" for f in ("__init__.py", "validate.py", "deps.py",
                                 "bounds.py", "lint_common.py")]
    + [f"frontend/{f}" for f in ("__init__.py", "schema.py", "parse.py")]
    + ["runtime/lockwitness.py", "service/fingerprint.py"]
    + [f"service/fabric/{f}" for f in ("__init__.py", "ring.py", "wire.py",
                                       "worker.py", "router.py")]
    + [f"runtime/obs/{f}" for f in ("__init__.py", "exporters.py",
                                    "attribution.py", "ledger.py",
                                    "regress.py", "metrics.py",
                                    "slo.py", "fleet.py")]
    + ["runtime/faults.py", "service/breakers.py", "service/cache.py"]
    + [f"analysis/concurrency/{f}" for f in ("_scan.py", "graph.py",
                                             "lints.py", "fixtures.py")]
)


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_is_a_copy(rel):
    with open(os.path.join(TPU, rel)) as a, open(os.path.join(TORCH, rel)) as b:
        assert a.read() == b.read()


def test_registry_and_machine_config_match():
    assert list(T_MODELS) == list(J_MODELS)
    assert (dataclasses.asdict(T.MachineConfig())
            == dataclasses.asdict(J.MachineConfig()))
    for ratio in (0.1, 0.3, 1.0):
        for trips in ((16,), (16, 16), (7, 9, 33), (2048, 2048, 2048)):
            for excl in (True, False):
                a = T.SamplerConfig(ratio=ratio, exclude_last_iteration=excl)
                b = J.SamplerConfig(ratio=ratio, exclude_last_iteration=excl)
                assert a.num_samples(trips) == b.num_samples(trips)


@pytest.mark.parametrize("name", sorted(J_MODELS))
def test_trace_tables_and_vals_match(name):
    for n in (8, 13):
        jt = JTrace(J_MODELS[name](n), J.MachineConfig())
        tt = TTrace(T_MODELS[name](n), T.MachineConfig())
        np.testing.assert_array_equal(jt.nest_offsets, tt.nest_offsets)
        for a, b in zip(jt.nests, tt.nests):
            for f in dataclasses.fields(a.tables):
                x, y = getattr(a.tables, f.name), getattr(b.tables, f.name)
                if isinstance(x, np.ndarray):
                    np.testing.assert_array_equal(x, y)
                else:
                    assert x == y, f.name
            assert a.vals.keys() == b.vals.keys()
            for k in a.vals:
                np.testing.assert_array_equal(a.vals[k], b.vals[k])
            assert (a.npre, a.npost, a.tri, a.max_trips) == (
                b.npre, b.npost, b.tri, b.max_trips)


def _to_port_state(js) -> TState:
    return TState(
        thread_num=js.thread_num, bin_noshare=js.bin_noshare,
        noshare=[dict(h) for h in js.noshare],
        share=[{r: dict(h) for r, h in per.items()} for per in js.share],
    )


@pytest.mark.parametrize("name", ["gemm", "2mm", "jacobi-2d", "atax",
                                  "trmm", "covariance"])
def test_cri_aet_match_on_oracle_states(name):
    jm, tm = J.MachineConfig(), T.MachineConfig()
    js = run_numpy(J_MODELS[name](12), jm).state
    ts = _to_port_state(js)
    jr = j_cri.cri_distribute(js, 4, 4)
    tr = t_cri.cri_distribute(ts, 4, 4)
    assert jr == tr
    a, b = j_aet.aet_mrc(jr, jm), t_aet.aet_mrc(tr, tm)
    assert a.tobytes() == b.tobytes()
    assert j_report.mrc_lines(a) == t_report.mrc_lines(b)
    assert t_aet.mrc_l1_error(b, a) == 0.0


@pytest.mark.parametrize("seed,n,k,weighted", [
    (0, 0, 8, False), (1, 1, 8, False), (2, 500, 64, False),
    (3, 500, 4, False), (4, 2000, 16, True), (5, 300, 1, True),
    (6, 1000, 1024, False),
])
def test_sorted_k_unique_matches(seed, n, k, weighted):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-40, 40, size=n) * 16 + rng.integers(0, 16, size=n)
    valid = rng.random(n) < 0.7
    w = rng.integers(0, 9, size=n) if weighted else None
    got = t_sorted_k_unique(
        torch.from_numpy(vals), torch.from_numpy(valid), k,
        None if w is None else torch.from_numpy(w),
    )
    want = j_sorted_k_unique(
        jnp.asarray(vals), jnp.asarray(valid), k,
        None if w is None else jnp.asarray(w),
    )
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if n:  # overflow: n_unique stays the true distinct count
        assert int(got[2]) == len(np.unique(vals[valid]))


def test_port_imports_no_jax():
    """Importing and running the port (and chip_smoke.py) leaves jax and
    the JAX package out of sys.modules (a fresh interpreter, so this
    file's imports do not count)."""
    code = (
        "import sys\n"
        "import pluss_sampler_optimization_torch as T\n"
        "from pluss_sampler_optimization_torch.cli import main\n"
        "from pluss_sampler_optimization_torch.models import gemm\n"
        "import pluss_sampler_optimization_torch.ops.sampled_hist\n"
        "import pluss_sampler_optimization_torch.ops._build\n"
        "import pluss_sampler_optimization_torch.oracle.profiler\n"
        "import pluss_sampler_optimization_torch.runtime.debug\n"
        "import pluss_sampler_optimization_torch.runtime.timing\n"
        "from pluss_sampler_optimization_torch.parallel import "
        "run_exact_sharded\n"
        "from pluss_sampler_optimization_torch.sampler import analytic, "
        "dense, stream\n"
        "from pluss_sampler_optimization_torch.sampler.periodic import "
        "run_exact\n"
        "import pluss_sampler_optimization_torch.runtime.telemetry\n"
        "import pluss_sampler_optimization_torch.runtime.obs\n"
        "import pluss_sampler_optimization_torch.runtime.obs.stage_profile\n"
        "import pluss_sampler_optimization_torch.tools.profile_stages\n"
        "from pluss_sampler_optimization_torch.tools import (\n"
        "    check_bundle, check_dispatch_stats, check_drift, check_ledger,\n"
        "    check_profile, check_regression, check_slo,\n"
        "    check_telemetry_schema, check_service_store, check_chaos,\n"
        "    check_precision, loadgen, check_concurrency,\n"
        "    lint_determinism, assemble_trace, check_fabric, profile_cost)\n"
        "from pluss_sampler_optimization_torch.service.fabric import (\n"
        "    Router, WorkerServer, wire, worker, router)\n"
        "import pluss_sampler_optimization_torch.runtime.obs.fleet\n"
        "import pluss_sampler_optimization_torch.service\n"
        "import pluss_sampler_optimization_torch.parallel.placement\n"
        "import pluss_sampler_optimization_torch.analysis.concurrency\n"
        "from pluss_sampler_optimization_torch.sampler.sampled import "
        "run_sampled_multi\n"
        "import chip_smoke\n"
        "T.run_sampled(gemm(8), T.MachineConfig(), T.SamplerConfig(),"
        " device='cpu')\n"
        "assert run_exact(gemm(8), T.MachineConfig(), device='cpu')"
        ".engine == 'periodic'\n"
        "import contextlib, io, os, tempfile\n"
        "led = os.path.join(tempfile.mkdtemp(), 'l.jsonl')\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    assert main(['sample', '--n', '8', '--device', 'cpu',"
        " '--ledger', led]) == 0\n"
        "    assert main(['stats', '--ledger', led]) == 0\n"
        "    req = os.path.join(tempfile.mkdtemp(), 'r.jsonl')\n"
        "    open(req, 'w').write('{\"model\": \"gemm\", \"n\": 8, '\n"
        "                         '\"engine\": \"sampled\"}\\n')\n"
        "    assert main(['serve', '--device', 'cpu', '--requests', req,"
        " '--batch-window-ms', '1']) == 0\n"
        "run_sampled_multi([(gemm(8), T.MachineConfig(), None, False)],"
        " device='cpu')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'pluss_sampler_optimization_tpu'))]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120, env=one_thread_env(),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_run_sampled_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prog, m = T_MODELS["gemm"](8), T.MachineConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.run_sampled(prog, m, T.SamplerConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.run_sampled(prog, m, T.SamplerConfig(), device="cuda")
    from pluss_sampler_optimization_torch.cli import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["sample", "--n", "8"])
    from pluss_sampler_optimization_torch.sampler.sampled import warmup

    with pytest.raises(RuntimeError, match="no CUDA device"):
        warmup(prog, m)
    assert warmup(prog, m, device="cpu") is None


def test_unported_routes_raise():
    prog, m = T_MODELS["gemm"](8), T.MachineConfig()
    # runtime v2 runs (tests/test_torch_r10_v2.py); a triangular nest
    # runs (tests/test_torch_tri.py) unless a step is not 1, which the
    # closed form does not cover
    step2 = tri_step2_program(TLoop, TNest, TProgram, TRef)
    with pytest.raises(NotImplementedError, match="unit steps"):
        T.run_sampled(step2, m, T.SamplerConfig(), device="cpu")
    # the kernel backend on CPU tensors is an error, not the plain path
    with pytest.raises(ValueError, match="CUDA tensors"):
        T.run_sampled(prog, m, T.SamplerConfig(kernel_backend="cuda"),
                      device="cpu")
    # and so is the device draw's kernel on the CPU
    with pytest.raises(ValueError, match="CUDA device"):
        T.run_sampled(prog, m, T.SamplerConfig(kernel_backend="cuda",
                                               device_draw=True),
                      device="cpu")
    with pytest.raises(ValueError, match="kernel_backend"):
        T.SamplerConfig(kernel_backend="pallas")
