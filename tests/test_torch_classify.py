"""The port's per-sample classify and its fused kernel, against JAX.

- `classify_samples` and `per_sample_ri` of the port equal the JAX
  package's element by element on every rectangular registry model
  (adi's descending loops included), on numpy-drawn sample tuples;
- the CUDA source csrc/sampled_hist.cu, built as plain C++ with g++ (its
  host twin runs the same per-sample code serially, through the same
  per-level instantiation as the kernel), equals the plain torch
  version on every rectangular model: this checks the kernel's
  descriptor walk on a machine without a card;
- the plain version's hist-form outputs, through the exact pair
  reduction, equal the JAX package's Pallas kernel (interpret mode) on
  the small program of tests/test_pallas.py.

The triangular models (syrk-tri, trmm, trisolv, covariance) and B1's
triangular walk are held the same way in tests/test_torch_tri.py.

Every comparison is exact.
"""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_made import made_program

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
from pluss_sampler_optimization_torch.ops import sampled_hist as sh
from pluss_sampler_optimization_torch.sampler import sampled as TS
from pluss_sampler_optimization_tpu.core.trace import ProgramTrace as JTrace
from pluss_sampler_optimization_tpu.ir import (
    Loop as JLoop,
    ParallelNest as JNest,
    Program as JProgram,
    Ref as JRef,
)
from pluss_sampler_optimization_tpu.models import REGISTRY as J_MODELS
from pluss_sampler_optimization_tpu.ops.pallas_sampled import hist_kernel_for
from pluss_sampler_optimization_tpu.sampler import sampled as JS

RECT = sorted(
    name for name in J_MODELS
    if not any(n.is_triangular for n in J_MODELS[name](8).nests)
)


def test_fourteen_rectangular_models():
    assert len(RECT) == 14


def _samples(nt, ri, n, rng):
    """n uniform normalized tuples over the ref's full iteration box."""
    lv = int(nt.tables.ref_levels[ri])
    cols = [rng.integers(0, nt.nest.loops[l].trip, size=n)
            for l in range(lv + 1)]
    return np.stack(cols, axis=1).astype(np.int64)


@pytest.mark.parametrize("name", RECT)
def test_classify_matches_jax(name):
    rng = np.random.default_rng(len(name))
    for n in (16, 13):
        jprog, tprog = J_MODELS[name](n), T_MODELS[name](n)
        jm, tm = J.MachineConfig(), T.MachineConfig()
        jt, tt = JTrace(jprog, jm), TTrace(tprog, tm)
        for k, (jnt, tnt) in enumerate(zip(jt.nests, tt.nests)):
            tv = tnt.with_vals(sh.torch_vals(tnt.vals, "cpu"))
            for ri in range(jnt.tables.n_refs):
                s = _samples(jnt, ri, 48, rng)
                want = JS.classify_samples(jnt, ri, jnp.asarray(s))
                got = TS.classify_samples(tv, ri, torch.from_numpy(s))
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
                if n != 16 or ri % 2:
                    continue
                want = JS.per_sample_ri(jprog, jm, k, ri, s)
                got = TS.per_sample_ri(tprog, tm, k, ri, s, device="cpu")
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def host_twin(tmp_path_factory):
    """csrc/sampled_hist.cu built as plain C++: sampled_hist_host runs the
    kernel's per-sample code in a serial loop."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    src = sh.__file__.replace("ops/sampled_hist.py", "csrc/sampled_hist.cu")
    out = tmp_path_factory.mktemp("twin") / "libsampled_hist_host.so"
    subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
         "-Wall", "-Werror", "-o", str(out), src],
        check=True, capture_output=True, timeout=300,
    )
    fn = ctypes.CDLL(str(out)).sampled_hist_host
    p, q = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [p, p, q, q, p, ctypes.c_int, p, p, p, ctypes.c_int, p, p,
                   p]
    fn.restype = ctypes.c_int

    def run(nt, ri0, keys, mask, highs, rx, raw=False):
        R, B = keys.shape
        d = sh.build_descriptor(nt, ri0)
        res = np.empty_like(keys)
        hist = np.zeros((R, sh.N_BINS), np.int64)
        cold = np.zeros(R, np.int64)
        m8 = None if mask is None else mask.astype(np.uint8)
        hrec = sh.radix_records(highs)
        tri = (np.ascontiguousarray(nt.tri_base, np.int64) if nt.tri
               else None)
        rc = fn(keys.ctypes.data, None if m8 is None else m8.ctypes.data,
                R, B, d.ctypes.data, len(d), hrec.ctypes.data,
                rx.ctypes.data, None if tri is None else tri.ctypes.data,
                int(raw), res.ctypes.data, hist.ctypes.data, cold.ctypes.data)
        assert rc == 0
        return res, hist, cold

    run.raw = fn

    return run


def _bucket_inputs(trace, members, nt, cfg, rng):
    """One bucket's stacked keys with a random mask and key-0 padding,
    as the engine lays them out."""
    ri0 = members[0][1]
    highs, _ = TS._sample_highs(nt, ri0, cfg)
    ks = [TS.draw_sample_keys(nt, ri, cfg, seed=idx)[0]
          for idx, ri in members]
    B = max(len(x) for x in ks) + 7
    keys = np.empty((len(ks), B), np.int64)
    mask = rng.random((len(ks), B)) < 0.9
    for j, x in enumerate(ks):
        keys[j, :len(x)] = x
        keys[j, len(x):] = x[0]
        mask[j, len(x):] = False
    rx = np.array([ri for _, ri in members], np.int64)
    return keys, mask, TS._pad_highs(highs), rx


@pytest.mark.parametrize("name", RECT)
def test_kernel_source_host_twin_matches_plain(name, host_twin):
    rng = np.random.default_rng(7)
    cfg = T.SamplerConfig(ratio=0.5, seed=1)
    trace, rows = TS._program_rows(T_MODELS[name](16), T.MachineConfig())
    for (k, _), members in TS._bucket_rows(trace, rows).items():
        nt = trace.nests[k]
        keys, mask, ph, rx = _bucket_inputs(trace, members, nt, cfg, rng)
        got = host_twin(nt, members[0][1], keys, mask, ph, rx)
        want = sh.sampled_hist_plain(
            nt, members[0][1], torch.from_numpy(keys),
            torch.from_numpy(mask), ph, torch.from_numpy(rx),
        )
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b.numpy())


def test_host_twin_reaches_every_level_instantiation(host_twin):
    """The kernel holds one instantiation per source-ref level, picked by
    the descriptor's D_LV word: the 14 models' buckets reach all three,
    so the host-twin tests run every one; a level the kernel has no
    instantiation for is refused."""
    levels = set()
    for name in RECT:
        trace, rows = TS._program_rows(T_MODELS[name](16), T.MachineConfig())
        for (k, _), members in TS._bucket_rows(trace, rows).items():
            d = sh.build_descriptor(trace.nests[k], members[0][1])
            levels.add(int(d[sh.D_LV]))
    assert levels == {0, 1, 2}
    d[sh.D_LV] = 3
    keys = np.zeros((1, 4), np.int64)
    out = [np.zeros(n, np.int64) for n in (4, sh.N_BINS, 1)]
    hrec, rx = sh.radix_records([1, 1, 1]), np.zeros(1, np.int64)
    assert host_twin.raw(keys.ctypes.data, None, 1, 4, d.ctypes.data, len(d),
                         hrec.ctypes.data, rx.ctypes.data, None, 0,
                         *(x.ctypes.data for x in out)) == 1


def test_made_program_classify_matches_jax():
    """The made program of tests/_torch_made.py (three-head, two-head,
    constant and window groups, a descending level): the port's classify
    equals the JAX package's on every ref."""
    jprog = made_program(JLoop, JNest, JProgram, JRef)
    tprog = made_program(TLoop, TNest, TProgram, TRef)
    jnt = JTrace(jprog, J.MachineConfig()).nests[0]
    tnt = TTrace(tprog, T.MachineConfig()).nests[0]
    tv = tnt.with_vals(sh.torch_vals(tnt.vals, "cpu"))
    rng = np.random.default_rng(5)
    for ri in range(jnt.tables.n_refs):
        s = _samples(jnt, ri, 96, rng)
        want = JS.classify_samples(jnt, ri, jnp.asarray(s))
        got = TS.classify_samples(tv, ri, torch.from_numpy(s))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_host_twin_runs_every_instantiation(host_twin):
    """Through the made program's buckets, the host twin runs all 6
    instantiations (LV 0-2 by NHMAX 1 and 3), on groups of 0 to 3 heads,
    and equals the plain version, with a mask and without."""
    rng = np.random.default_rng(9)
    cfg = T.SamplerConfig(ratio=0.6, seed=3)
    prog = made_program(TLoop, TNest, TProgram, TRef)
    trace, rows = TS._program_rows(prog, T.MachineConfig())
    seen, heads = set(), set()
    for (k, _), members in TS._bucket_rows(trace, rows).items():
        nt = trace.nests[k]
        ri0 = members[0][1]
        d = sh.build_descriptor(nt, ri0)
        seen.add(sh.instantiation(d))
        heads.add((int(d[sh.D_LV]), sh.max_heads(d)))
        keys, mask, ph, rx = _bucket_inputs(trace, members, nt, cfg, rng)
        for m in (mask, None):
            got = host_twin(nt, ri0, keys, m, ph, rx)
            want = sh.sampled_hist_plain(
                nt, ri0, torch.from_numpy(keys),
                None if m is None else torch.from_numpy(m), ph,
                torch.from_numpy(rx),
            )
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b.numpy())
    assert seen == {(lv, nh, False) for lv in range(3) for nh in (1, 3)}
    assert heads == {(lv, nh) for lv in range(3) for nh in range(4)}


@pytest.mark.parametrize("name", RECT)
def test_kernel_source_host_twin_without_mask(name, host_twin):
    """The engine's own dispatches (cut short, never padded) pass no
    mask: every lane is live, as under an all-ones mask."""
    cfg = T.SamplerConfig(ratio=0.5, seed=1)
    trace, rows = TS._program_rows(T_MODELS[name](16), T.MachineConfig())
    for d in TS.plan_dispatches(trace, rows, cfg, torch.device("cpu"), 100,
                                "torch"):
        got = host_twin(d.nt, d.ref_idx, d.keys_RB.numpy(), None, d.highs,
                        d.rx_R.numpy())
        args = (d.keys_RB, None, d.highs, d.rx_R)
        want = sh.sampled_hist_plain(d.nt, d.ref_idx, *args)
        ones = sh.sampled_hist_plain(
            d.nt, d.ref_idx, d.keys_RB,
            torch.ones(d.keys_RB.shape, dtype=torch.bool), d.highs, d.rx_R,
        )
        for a, b, c in zip(got, want, ones):
            np.testing.assert_array_equal(a, b.numpy())
            np.testing.assert_array_equal(a, c.numpy())


_MINI_ARGS = dict(
    loops=(8, 8),
    refs=(("A0", "A", 1, (8, 1), None), ("B0", "B", 1, (0, 1), 9)),
)


def _mini(Loop, Nest, Program, Ref):
    """tests/test_pallas.py's small program, in either package's IR."""
    refs = tuple(
        Ref(n, a, level=lv, coeffs=c)
        if thr is None else Ref(n, a, level=lv, coeffs=c, share_threshold=thr)
        for n, a, lv, c, thr in _MINI_ARGS["refs"]
    )
    return Program(name="parity-mini", nests=(Nest(
        loops=tuple(Loop(t) for t in _MINI_ARGS["loops"]), refs=refs,
    ),))


@pytest.mark.parametrize("ref_idx", [0, 1])
def test_hist_form_matches_pallas_interpret(ref_idx):
    """The plain version plus the pair reduction give the Pallas
    kernel's five outputs (pair keys, counts, n_unique, cold, pow2
    noshare histogram) on one masked, padded dispatch."""
    jprog = _mini(JLoop, JNest, JProgram, JRef)
    tprog = _mini(TLoop, TNest, TProgram, TRef)
    jnt = JTrace(jprog, J.MachineConfig()).nests[0]
    tnt = TTrace(tprog, T.MachineConfig()).nests[0]
    rng = np.random.default_rng(11 + ref_idx)
    highs = [7, 7]
    keys = rng.integers(0, 49, size=(1, 300)).astype(np.int64)
    mask = rng.random((1, 300)) < 0.8
    ph = TS._pad_highs(highs)
    rx = np.array([ref_idx], np.int64)
    cap = 64
    kern = hist_kernel_for(
        jnt, ref_idx, JS._ref_sig_digest(jnt, ref_idx), interpret=True
    )
    want = kern(jnp.asarray(keys), jnp.asarray(mask), ph, jnt.vals,
                jnp.asarray(rx), cap, 1)
    got, _ = TS.bucket_dispatch(
        tnt, ref_idx, torch.from_numpy(keys), torch.from_numpy(mask), ph,
        torch.from_numpy(rx), cap, "torch",
    )
    assert TS._ref_sig_digest(tnt, ref_idx) == JS._ref_sig_digest(
        jnt, ref_idx)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got[4].sum()) + int(got[1].sum()) + int(got[3].sum()) == int(
        mask.sum())
