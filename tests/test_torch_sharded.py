"""The port's sharded sampled engine and kernel B2's plain version, against JAX.

- `pow2_hist_plain` (the plain version of csrc/pow2_hist.cu) equals the
  JAX package's Pallas `pow2_hist` in interpret mode on the inputs of
  tests/test_pallas.py, on 0 and negative values, and on the 2^31
  same-lane total; the .cu built as plain C++ with g++ (its host twin)
  equals the plain version; `exp_bin`, `exp_hist`, `fixed_k_unique`
  and `pad_keys` equal the JAX package's;
- `sampled_outputs_sharded` on meshes of 1, 2 and 8 CPU devices equals
  the JAX package's on its virtual 8-device CPU mesh (per-ref results
  and the psum'd pow2 histograms), and `run_sampled_sharded` folds to
  `run_sampled`'s state and MRC bytes, and with v2=True to the JAX
  package's v2 state;
- two (and four) gloo processes (`initialize_distributed` ->
  `build_global_mesh` -> `run_sampled_sharded`, tests/_torch_dist.py)
  print identical results, equal to the single-process engine's.

Inputs are made from numpy seeds; every comparison is exact.
"""

import ctypes
import dataclasses
import inspect
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_thread_env, one_torch_thread  # noqa: F401
from _torch_dist import (
    CFG,
    DEVICE_DRAW,
    DEVICE_RUNS,
    RUNS,
    check_workers,
    run_workers,
)
from _torch_made import tri_step2_program

import pluss_sampler_optimization_torch as T
import pluss_sampler_optimization_tpu as J
from pluss_sampler_optimization_torch.cli import main as t_main
from pluss_sampler_optimization_torch.ir import (
    Loop as TLoop,
    ParallelNest as TNest,
    Program as TProgram,
    Ref as TRef,
)
from pluss_sampler_optimization_torch.models import REGISTRY as T_MODELS
from pluss_sampler_optimization_torch.ops import histogram as TH
from pluss_sampler_optimization_torch.ops import pow2_hist as TP
from pluss_sampler_optimization_torch.parallel import (
    build_global_mesh as t_build_global_mesh,
    build_mesh as t_build_mesh,
    run_sampled_sharded as t_run_sharded,
    sampled_outputs_sharded as t_outputs_sharded,
)
from pluss_sampler_optimization_torch.runtime import aet as t_aet
from pluss_sampler_optimization_torch.runtime import cri as t_cri
from pluss_sampler_optimization_torch.runtime.baseline import (
    state_to_json as t_state_json,
)
from pluss_sampler_optimization_torch.sampler import sampled as TS
from pluss_sampler_optimization_tpu.cli import main as j_main
from pluss_sampler_optimization_tpu.models import REGISTRY as J_MODELS
from pluss_sampler_optimization_tpu.ops import histogram as JH
from pluss_sampler_optimization_tpu.ops.pallas_hist import pow2_hist
from pluss_sampler_optimization_tpu.parallel import (
    build_mesh as j_build_mesh,
    run_sampled_sharded as j_run_sharded,
    sampled_outputs_sharded as j_outputs_sharded,
)
from pluss_sampler_optimization_tpu.runtime.baseline import (
    state_to_json as j_state_json,
)
from pluss_sampler_optimization_tpu.sampler import sampled as JS

ROOT = os.path.join(os.path.dirname(__file__), "..")
CSRC = os.path.join(ROOT, "pluss_sampler_optimization_torch", "csrc")


def _cpu_mesh(n):
    return t_build_mesh(devices=["cpu"] * n)


def _jax_pow2(vals, w):
    return np.asarray(
        pow2_hist(jnp.asarray(vals), jnp.asarray(w), interpret=True)
    )


def _plain(vals, w):
    return TP.pow2_hist_plain(torch.from_numpy(np.asarray(vals)),
                              torch.from_numpy(np.asarray(w))).numpy()


# --- kernel B2's plain version against the Pallas kernel -------------


def _random_case(n):
    rng = np.random.default_rng(n)
    exp = rng.integers(0, 62, size=n)
    vals = (1 << exp.astype(np.int64)) + rng.integers(0, 1 << 20, size=n)
    vals = np.minimum(np.maximum(vals, 1), (1 << 62) - 1)
    return vals, rng.integers(0, 2, size=n)


def _additive_case(n):
    rng = np.random.default_rng(n + 7)
    return rng.integers(1, 1 << 40, size=n), rng.integers(0, 5, size=n)


def _boundary_case():
    vals = np.array(
        [1, 2, 3, 4, (1 << 31) - 1, 1 << 31, (1 << 32) - 1, 1 << 32,
         (1 << 32) + 1, (1 << 62) - 1, 1 << 40],
        dtype=np.int64,
    )
    return vals, np.ones(len(vals), dtype=np.int64)


def _zero_and_negative_case():
    # the ladder's own domain edge: 0 falls in no bin, x < 0 in bin 63
    vals = np.array([-5, 0, 3, -(1 << 62), 1, 0, -1, (1 << 62) - 1],
                    dtype=np.int64)
    return vals, np.array([1, 1, 1, 1, 1, 7, 2, 3], dtype=np.int64)


CASES = {
    **{f"random{n}": (lambda n=n: _random_case(n)) for n in (1, 100, 5000)},
    **{f"additive{n}": (lambda n=n: _additive_case(n)) for n in (100, 5000)},
    "boundary": _boundary_case,
    "all_masked": lambda: (np.ones(300, dtype=np.int64),
                           np.zeros(300, dtype=np.int64)),
    "zero_and_negative": _zero_and_negative_case,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pow2_hist_plain_matches_pallas_interpret(case):
    vals, w = CASES[case]()
    np.testing.assert_array_equal(_plain(vals, w), _jax_pow2(vals, w))


def test_pow2_hist_plain_zero_and_negative_bins():
    got = _plain(*_zero_and_negative_case())
    assert {b: int(c) for b, c in enumerate(got) if c} == {
        0: 1, 1: 1, 61: 3, 63: 4,
    }


def test_pow2_hist_plain_same_lane_total_2_31():
    """Two 2^30 weights in one lane of the TPU layout: the JAX package's
    auto guard widens and stays exact; int64 accumulation is exact."""
    vals = np.full(1024, 1 << 10, dtype=np.int64)
    w = np.zeros(1024, dtype=np.int64)
    w[0] = w[128] = 1 << 30
    want = np.zeros(64, dtype=np.int64)
    want[10] = 1 << 31
    np.testing.assert_array_equal(_jax_pow2(vals, w), want)
    np.testing.assert_array_equal(_plain(vals, w), want)


def test_pow2_hist_on_cpu_is_the_plain_version_and_launches_nothing():
    vals, w = _random_case(5000)
    n0 = TP.LAUNCHES
    for wt in (torch.from_numpy(w), torch.from_numpy(w.astype(bool))):
        got = TP.pow2_hist(torch.from_numpy(vals), wt)
        assert torch.equal(got, TP.pow2_hist_plain(torch.from_numpy(vals),
                                                   wt))
    assert TP.LAUNCHES == n0
    empty = TP.pow2_hist(torch.zeros(0, dtype=torch.int64),
                         torch.zeros(0, dtype=torch.bool))
    assert empty.tolist() == [0] * 64
    with pytest.raises(ValueError):
        TP.pow2_hist(torch.from_numpy(vals), torch.ones(len(vals)))
    with pytest.raises(ValueError):
        TP.pow2_hist(torch.from_numpy(vals), torch.ones(3, dtype=torch.bool))


def test_pow2_hist_auto_dispatch():
    vals, w = _random_case(100)
    v, wt = torch.from_numpy(vals), torch.from_numpy(w)
    want = torch.from_numpy(np.array(
        JH.exp_hist(jnp.asarray(vals), jnp.asarray(w))))
    assert torch.equal(TP.pow2_hist_auto(v, wt), want)
    assert torch.equal(TP.pow2_hist_auto(v, wt, "torch"), want)
    with pytest.raises(ValueError, match="CUDA tensors"):
        TP.pow2_hist_auto(v, wt, "cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        TP.pow2_hist_auto(v, wt, "pallas")


def test_pow2_hist_host_twin_matches_plain(tmp_path):
    """csrc/pow2_hist.cu built as plain C++ runs the kernel's binning and
    weight reads serially; it must equal the plain version on 2^16
    values over every bin, with bool and with int64 weights."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    lib_path = tmp_path / "libpow2_hist_host.so"
    subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
         "-o", str(lib_path), os.path.join(CSRC, "pow2_hist.cu")],
        check=True, capture_output=True, timeout=120,
    )
    fn = ctypes.CDLL(str(lib_path)).pow2_hist_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rng = np.random.default_rng(11)
    n = 1 << 16
    e = rng.integers(0, 63, size=n).astype(np.int64)
    lo = np.left_shift(np.int64(1), e)
    vals = lo + rng.integers(0, 1 << 62, size=n) % lo
    vals[rng.random(n) < 0.05] = 0
    neg = rng.random(n) < 0.05
    vals[neg] = -rng.integers(1, 1 << 62, size=int(neg.sum()))
    for w in (rng.random(n) < 0.7, rng.integers(-3, 1 << 40, size=n)):
        wire = np.ascontiguousarray(
            w.astype(np.uint8) if w.dtype == bool else w.astype(np.int64))
        out = np.zeros(64, dtype=np.int64)
        assert fn(vals.ctypes.data, wire.ctypes.data, int(w.dtype == bool),
                  n, out.ctypes.data) == 0
        want = _plain(vals, w)
        np.testing.assert_array_equal(out, want)
        assert (want != 0).sum() == 64


# --- the other histogram ops and pad_keys ----------------------------


def test_exp_bin_and_exp_hist_match():
    rng = np.random.default_rng(5)
    vals = rng.integers(-(1 << 62), 1 << 62, size=4000)
    vals[:6] = [0, 1, -1, (1 << 62) - 1, -(1 << 63), (1 << 63) - 1]
    np.testing.assert_array_equal(
        TH.exp_bin(torch.from_numpy(vals)).numpy(),
        np.asarray(JH.exp_bin(jnp.asarray(vals))),
    )
    w = rng.integers(0, 3, size=4000)
    for wt in (w, w.astype(bool)):
        np.testing.assert_array_equal(
            TH.exp_hist(torch.from_numpy(vals), torch.from_numpy(wt)).numpy(),
            np.asarray(JH.exp_hist(jnp.asarray(vals), jnp.asarray(wt))),
        )


@pytest.mark.parametrize("n_distinct,k", [(3, 64), (64, 64), (100, 64),
                                          (40, 2), (0, 8)])
def test_fixed_k_unique_matches(n_distinct, k):
    """Including over capacity (n_unique stays the true count) and a
    full table of 64 distinct keys."""
    rng = np.random.default_rng(n_distinct * 31 + k)
    pool = rng.choice(1 << 40, size=max(n_distinct, 1), replace=False)
    vals = pool[rng.integers(0, len(pool), size=3000)]
    valid = rng.random(3000) < (0.9 if n_distinct else 0.0)
    got = TH.fixed_k_unique(torch.from_numpy(vals), torch.from_numpy(valid),
                            k)
    want = JH.fixed_k_unique(jnp.asarray(vals), jnp.asarray(valid), k)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got[2]) == len(np.unique(vals[valid]))


def test_pad_keys_is_a_copy():
    assert inspect.getsource(TS.pad_keys) == inspect.getsource(JS.pad_keys)
    keys = np.arange(5, 42, dtype=np.int64)
    for args in ((8,), (3,), (8, 16, 64), (1, 4)):
        a, b = TS.pad_keys(keys, *args), JS.pad_keys(keys, *args)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
    with pytest.raises(ValueError):
        TS.pad_keys(keys[:0], 2)


# --- the sharded engine ----------------------------------------------


def _results_equal(jres, tres):
    assert [(r.name, r.noshare, r.share, r.cold, r.n_samples)
            for r in tres] == [(r.name, r.noshare, r.share, r.cold,
                                r.n_samples) for r in jres]


def _dense_equal(jd, td):
    assert len(jd) == len(td)
    for a, b in zip(jd, td):
        np.testing.assert_array_equal(b, np.asarray(a))


def _case(name, n, n_dev, ratio, seed, device_draw=None, args=None):
    """A case of test_sampled_outputs_sharded_matches_jax; the GEMM and
    2mm cases keep their ids."""
    cid = "-".join(str(x) for x in (name, n, n_dev, ratio, seed))
    if device_draw is not None or args is not None:
        cid = "-".join([name, *(str(a) for a in (args or (n,))),
                        str(n_dev), "device" if device_draw else "host"])
    return pytest.param(name, n, n_dev, ratio, seed, device_draw, args,
                        id=cid)


@pytest.mark.parametrize("name,n,n_dev,ratio,seed,device_draw,args", [
    _case("gemm", 16, 1, 0.25, 3), _case("gemm", 16, 2, 0.25, 3),
    _case("gemm", 16, 8, 0.25, 3), _case("2mm", 8, 8, 0.25, 3),
    # triangular nests on 8 shards, under each draw
    _case("trmm", 12, 8, 0.25, 3, False),
    _case("trmm", 12, 8, 0.25, 3, True),
    _case("covariance", 8, 8, 0.25, 3, False, (8, 6)),
    _case("covariance", 8, 8, 0.25, 3, True, (8, 6)),
])
def test_sampled_outputs_sharded_matches_jax(name, n, n_dev, ratio, seed,
                                             device_draw, args):
    """The per-ref results fold to run_sampled's state and MRC bytes. The
    rectangular cases also equal the JAX package's sharded engine (per-ref
    results and pow2 histograms); the triangular ones are held against
    run_sampled, which tests/test_torch_tri.py holds against the JAX
    package (its sharded engine would compile a kernel per ref for
    minutes here). The device draw runs at batch 64, which 8 shards
    divide, on both sides."""
    args = (n,) if args is None else args
    m = T.MachineConfig()
    cfg = T.SamplerConfig(ratio=ratio, seed=seed, device_draw=device_draw)
    kw = {"batch": 64} if device_draw else {}
    tres, td = t_outputs_sharded(
        T_MODELS[name](*args), m, cfg, mesh=_cpu_mesh(n_dev), device="cpu",
        **kw,
    )
    if device_draw is None:
        jres, jd = j_outputs_sharded(
            J_MODELS[name](n), J.MachineConfig(),
            J.SamplerConfig(ratio=ratio, seed=seed),
            mesh=j_build_mesh(n_dev),
        )
        _results_equal(jres, tres)
        _dense_equal(jd, td)
    assert all(d.any() for d in td)
    want, _ = T.run_sampled(T_MODELS[name](*args), m,
                            dataclasses.replace(cfg, fuse_refs=True),
                            device="cpu", **kw)
    state = TS.fold_results(tres, m.thread_num)
    assert t_state_json(state) == t_state_json(want)
    assert _mrc(state, m).tobytes() == _mrc(want, m).tobytes()


def _mrc(state, machine):
    T_ = machine.thread_num
    return t_aet.aet_mrc(t_cri.cri_distribute(state, T_, T_), machine)


def test_sharded_folds_like_run_sampled_and_jax_v2():
    """Padding (batch 40 over 3 shards), capacity regrows (2 slots) and
    a roomy capacity give the same results; the fold equals run_sampled's
    state and MRC bytes, and v2=True equals the JAX package's v2 state."""
    m, cfg = T.MachineConfig(), T.SamplerConfig(ratio=0.25, seed=3)
    prog = T_MODELS["gemm"](16)
    want_state, _ = T.run_sampled(
        prog, m, dataclasses.replace(cfg, fuse_refs=True), device="cpu")
    base, _ = t_outputs_sharded(prog, m, cfg, device="cpu", capacity=4096)
    small, _ = t_outputs_sharded(prog, m, cfg, mesh=_cpu_mesh(3), batch=40,
                                 capacity=2)
    assert [dataclasses.asdict(r) for r in small] == [
        dataclasses.asdict(r) for r in base
    ]
    state, res = t_run_sharded(prog, m, cfg, _cpu_mesh(3), batch=40,
                               capacity=2)
    assert t_state_json(state) == t_state_json(want_state)
    assert _mrc(state, m).tobytes() == _mrc(want_state, m).tobytes()
    v2_state, _ = t_run_sharded(prog, m, cfg, device="cpu", v2=True)
    j_v2, _ = j_run_sharded(
        J_MODELS["gemm"](16), J.MachineConfig(),
        J.SamplerConfig(ratio=0.25, seed=3), j_build_mesh(2), v2=True,
    )
    assert t_state_json(v2_state) == j_state_json(j_v2)
    assert not v2_state.bin_noshare


def test_sharded_unported_routes_and_meshes_raise(monkeypatch):
    m = T.MachineConfig()
    with pytest.raises(NotImplementedError, match="unit steps"):
        t_run_sharded(tri_step2_program(TLoop, TNest, TProgram, TRef), m,
                      T.SamplerConfig(), device="cpu")
    with pytest.raises(ValueError, match="mesh size dividing"):
        t_run_sharded(T_MODELS["gemm"](8), m,
                      T.SamplerConfig(device_draw=True), _cpu_mesh(3),
                      batch=40)
    with pytest.raises(ValueError, match="requested 3 devices, have 2"):
        t_build_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="disagrees"):
        t_run_sharded(T_MODELS["gemm"](8), m, T.SamplerConfig(),
                      _cpu_mesh(2), device="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_run_sharded(T_MODELS["gemm"](8), m,
                      T.SamplerConfig(kernel_backend="cuda"), device="cpu")
    assert t_build_mesh(1, devices=["cpu"] * 4).devices == (
        torch.device("cpu"),)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (t_build_mesh, t_build_global_mesh,
                 lambda: t_build_mesh(devices=["cuda:0"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_run_sharded(T_MODELS["gemm"](8), m, T.SamplerConfig())


def test_sample_cli_sharded_prints_the_jax_lines(capsys):
    args = ["sample", "--model", "gemm", "--n", "16", "--ratio", "0.3"]
    assert j_main(args + ["--engine", "sharded", "--platform", "cpu"]) == 0
    want = capsys.readouterr().out
    assert t_main(args + ["--engine", "sharded", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert t_main(args + ["--device", "cpu", "--fuse-refs"]) == 0
    assert got == want == capsys.readouterr().out
    assert "ref B0" in got and "max iteration count" in got


def test_sharded_path_imports_no_jax():
    """Both sharded forms and progressive precision run with neither
    jax nor the JAX package in sys.modules."""
    code = (
        "import sys\n"
        "import pluss_sampler_optimization_torch as T\n"
        "from pluss_sampler_optimization_torch.models import gemm\n"
        "from pluss_sampler_optimization_torch.parallel import (\n"
        "    build_mesh, initialize_distributed, run_sampled_sharded)\n"
        "from pluss_sampler_optimization_torch.sampler.sampled import (\n"
        "    run_sampled_progressive)\n"
        "for fuse in (None, True):\n"
        "    run_sampled_sharded(gemm(8), T.MachineConfig(),"
        " T.SamplerConfig(fuse_refs=fuse),"
        " build_mesh(devices=['cpu', 'cpu']), batch=64)\n"
        "run_sampled_progressive(gemm(8), T.MachineConfig(),"
        " T.SamplerConfig(max_rounds=2), device='cpu')\n"
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


# --- processes over gloo ---------------------------------------------


def _gloo(world, model="gemm", args=None, device_draw=False):
    """A case of the gloo test; GEMM's keep their ids (the world size)."""
    cid = str(world) if model == "gemm" else "-".join(
        [str(world), model, *(str(a) for a in args),
         "device" if device_draw else "host"])
    return pytest.param(world, model, args, device_draw, id=cid)


@pytest.mark.parametrize("world,model,args,device_draw", [
    _gloo(2), _gloo(4),
    _gloo(2, "trmm", (12,)), _gloo(2, "trmm", (12,), True),
    _gloo(2, "covariance", (8, 6)), _gloo(2, "covariance", (8, 6), True),
])
def test_gloo_processes_match_the_single_process_engine(world, model, args,
                                                         device_draw):
    """Both (all) ranks print identical results, equal to run_sampled's
    state and the one-device sharded results; a repeated identical
    initialize_distributed is a no-op and a conflicting one raises. The
    triangular cases run under each draw (the device draw replayed by
    every rank; at one batch, which keeps the ranks' collectives few)."""
    cfg, runs = (DEVICE_DRAW, DEVICE_RUNS[:1]) if device_draw else (CFG, RUNS)
    outs = run_workers(world, "cpu", cfg=cfg, runs=runs, model=model,
                       args=args)
    assert outs[0]["mesh"] == ["cpu"] * world
    check_workers(outs, "cpu", cfg=cfg, runs=runs, model=model, args=args)
