"""The port on triangular nests (syrk-tri, trmm, trisolv, covariance)
against the JAX package, and kernel B1's triangular walk on the CPU.

- `classify_samples` and `per_sample_ri` equal the JAX package's element
  by element on the triangular programs of tests/test_sampled.py, with
  samples drawn over the valid triangular domain, under the default
  machine and the two odd ones (3 threads of chunk 5, 5 of chunk 2);
- `run_sampled` folds to the JAX package's PRIState and MRC bytes
  (kernel_backend="xla", fuse_refs=False) under the device draw at the
  card's batch on syrk-tri (under the host draw, on all four:
  tests/test_torch_sampled.py);
- a masked triangular bucket dispatch of the plain version, through the
  pair reduction, equals the Pallas kernel in interpret mode;
- csrc/sampled_hist.cu built as plain C++ (the host twin of
  tests/test_torch_classify.py) equals the plain version on every
  triangular dispatch of the four models and of a made triangular
  program that reaches all 6 triangular instantiations;
- a triangular nest with a step other than 1 raises, as in the JAX
  package.

Every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_made import made_tri_program, tri_step2_program
from test_torch_classify import host_twin  # noqa: F401 (a fixture)

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
from pluss_sampler_optimization_torch.runtime import aet as t_aet
from pluss_sampler_optimization_torch.runtime import cri as t_cri
from pluss_sampler_optimization_torch.runtime.baseline import (
    state_to_json as t_state_json,
)
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
from pluss_sampler_optimization_tpu.runtime import aet as j_aet
from pluss_sampler_optimization_tpu.runtime import cri as j_cri
from pluss_sampler_optimization_tpu.runtime.baseline import (
    state_to_json as j_state_json,
)
from pluss_sampler_optimization_tpu.sampler import sampled as JS

TRI = ("syrk-tri", "trmm", "trisolv", "covariance")
# tests/test_sampled.py's triangular programs: ascending and descending
# triangular levels, zero-trip iterations, mixed rectangular and
# triangular nests, and sizes past chunk * threads (second-round chunks)
PROGRAMS = (
    ("syrk-tri", (9,)), ("syrk-tri", (10, 6)), ("trmm", (8,)),
    ("trmm", (7, 9)), ("trisolv", (13,)), ("covariance", (8, 6)),
    ("syrk-tri", (19, 5)), ("trmm", (18, 4)), ("trisolv", (21,)),
)
MACHINES = {"t4c4": {}, "t3c5": {"thread_num": 3, "chunk_size": 5},
            "t5c2": {"thread_num": 5, "chunk_size": 2}}


def test_four_triangular_models():
    assert sorted(name for name in J_MODELS if any(
        n.is_triangular for n in J_MODELS[name](8).nests)) == sorted(TRI)


def _valid_samples(nt, ri, seed):
    """Tuples drawn over the ref's valid (triangular) domain by the host
    draw, a copy of the JAX package's."""
    keys, highs = TS.draw_sample_keys(nt, ri, T.SamplerConfig(ratio=0.5),
                                      seed)
    return TS.decode_sample_keys(keys, highs)


@pytest.mark.parametrize("machine", sorted(MACHINES))
@pytest.mark.parametrize("name,args", PROGRAMS,
                         ids=[f"{n}{'x'.join(map(str, a))}"
                              for n, a in PROGRAMS])
def test_classify_matches_jax(name, args, machine):
    jprog, tprog = J_MODELS[name](*args), T_MODELS[name](*args)
    jm = J.MachineConfig(**MACHINES[machine])
    tm = T.MachineConfig(**MACHINES[machine])
    jt, tt = JTrace(jprog, jm), TTrace(tprog, tm)
    for k, (jnt, tnt) in enumerate(zip(jt.nests, tt.nests)):
        tv = tnt.with_vals(sh.torch_vals(tnt.vals, "cpu"))
        for ri in range(jnt.tables.n_refs):
            s = _valid_samples(tnt, ri, 3 + ri)
            want = JS.classify_samples(jnt, ri, jnp.asarray(s))
            got = TS.classify_samples(tv, ri, torch.from_numpy(s))
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            if not tnt.tri or ri % 3:
                continue
            want = JS.per_sample_ri(jprog, jm, k, ri, s)
            got = TS.per_sample_ri(tprog, tm, k, ri, s, device="cpu")
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_made_triangular_program_classify_matches_jax():
    """tests/_torch_made.py's triangular program (groups of 0 to 3 heads,
    post-slot refs after a triangular subloop, a level reaching zero
    trips): the port's classify equals the JAX package's on every ref."""
    jnt = JTrace(made_tri_program(JLoop, JNest, JProgram, JRef),
                 J.MachineConfig()).nests[0]
    tnt = TTrace(made_tri_program(TLoop, TNest, TProgram, TRef),
                 T.MachineConfig()).nests[0]
    tv = tnt.with_vals(sh.torch_vals(tnt.vals, "cpu"))
    for ri in range(jnt.tables.n_refs):
        s = _valid_samples(tnt, ri, 5)
        want = JS.classify_samples(jnt, ri, jnp.asarray(s))
        got = TS.classify_samples(tv, ri, torch.from_numpy(s))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _mrc(cri, aet, state, machine):
    T_ = machine.thread_num
    return aet.aet_mrc(cri.cri_distribute(state, T_, T_), machine)


def test_run_sampled_device_draw_folds_like_jax():
    """syrk-tri N=16, ratio 0.3, the device draw at the card's batch on
    both sides (B3's triangular draw, replayed in plain torch here)."""
    name, kw = "syrk-tri", {"batch": 1 << 20}
    jm, tm = J.MachineConfig(), T.MachineConfig()
    js, jres = JS.run_sampled(
        J_MODELS[name](16), jm, J.SamplerConfig(
            ratio=0.3, seed=0, kernel_backend="xla", fuse_refs=False,
            device_draw=True,
        ), **kw,
    )
    ts, tres = T.run_sampled(
        T_MODELS[name](16), tm,
        T.SamplerConfig(ratio=0.3, seed=0, device_draw=True,
                        fuse_refs=True),
        device="cpu", **kw,
    )
    assert t_state_json(ts) == j_state_json(js)
    assert (_mrc(t_cri, t_aet, ts, tm).tobytes()
            == _mrc(j_cri, j_aet, js, jm).tobytes())
    assert [(r.name, r.n_samples, r.cold) for r in tres] == [
        (r.name, r.n_samples, r.cold) for r in jres
    ]


def test_hist_form_matches_pallas_interpret():
    """trmm(8)'s B0 (level 2, a share ref): the plain version plus the
    pair reduction give the Pallas kernel's five outputs on one masked
    dispatch of valid keys."""
    ref_idx = 1
    jnt = JTrace(J_MODELS["trmm"](8), J.MachineConfig()).nests[0]
    tnt = TTrace(T_MODELS["trmm"](8), T.MachineConfig()).nests[0]
    keys, highs = TS.draw_sample_keys(tnt, ref_idx,
                                      T.SamplerConfig(ratio=0.9), 11)
    rng = np.random.default_rng(11 + ref_idx)
    keys = keys[None, :]
    mask = rng.random(keys.shape) < 0.8
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


def _twin_matches_plain(host_twin, prog, cfg, rng):
    """The host twin against the plain version on every dispatch of
    `prog` (the engine's, every lane live) and on each with a random
    mask; returns the triangular instantiations reached."""
    trace, rows = TS._program_rows(prog, T.MachineConfig())
    seen = set()
    for d in TS.plan_dispatches(trace, rows, cfg, torch.device("cpu"), 64,
                                "torch"):
        seen.add(sh.instantiation(sh.build_descriptor(d.nt, d.ref_idx)))
        keys = d.keys_RB.numpy()
        for mask in (None, rng.random(keys.shape) < 0.7):
            got = host_twin(d.nt, d.ref_idx, keys, mask, d.highs,
                            d.rx_R.numpy())
            want = sh.sampled_hist_plain(
                d.nt, d.ref_idx, d.keys_RB,
                None if mask is None else torch.from_numpy(mask), d.highs,
                d.rx_R,
            )
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b.numpy())
    return {x for x in seen if x[2]}


@pytest.mark.parametrize("name", TRI)
def test_kernel_source_host_twin_matches_plain(name, host_twin):
    rng = np.random.default_rng(17)
    seen = _twin_matches_plain(host_twin, T_MODELS[name](16),
                               T.SamplerConfig(ratio=0.5, seed=1), rng)
    assert seen and all(nh == 1 for _, nh, _ in seen)


def test_host_twin_runs_every_triangular_instantiation(host_twin):
    """The made triangular program's buckets reach all 6 instantiations
    sampled_hist_kernel<LV, NHMAX, true> (LV 0-2 by NHMAX 1 and 3), with
    groups of 0 to 3 heads at every level, and the twin equals the plain
    version on each."""
    prog = made_tri_program(TLoop, TNest, TProgram, TRef)
    seen = _twin_matches_plain(host_twin, prog,
                               T.SamplerConfig(ratio=0.6, seed=3),
                               np.random.default_rng(19))
    assert seen == {(lv, nh, True) for lv in range(3) for nh in (1, 3)}
    trace, rows = TS._program_rows(prog, T.MachineConfig())
    heads = {
        (int(d[sh.D_LV]), sh.max_heads(d))
        for d in (sh.build_descriptor(trace.nests[k], m[0][1])
                  for (k, _), m in TS._bucket_rows(trace, rows).items())
    }
    assert heads == {(lv, nh) for lv in range(3) for nh in range(4)}


def test_triangular_non_unit_step_raises():
    """As the JAX package's tests/test_sampled.py:270: the closed form
    covers triangular nests with unit steps only."""
    prog = tri_step2_program(TLoop, TNest, TProgram, TRef)
    with pytest.raises(NotImplementedError, match="unit steps"):
        T.run_sampled(prog, T.MachineConfig(), T.SamplerConfig(ratio=0.5),
                      device="cpu")
    nt = TTrace(prog, T.MachineConfig()).nests[0]
    with pytest.raises(NotImplementedError, match="unit steps"):
        sh.build_descriptor(nt, 0)
