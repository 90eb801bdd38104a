"""The port's sampled engine end to end against the JAX package (exact).

The port's run_sampled (host numpy draw, bucketed fused dispatches, the
plain classify+histogram on the CPU) must fold to the same PRIState and
the same MRC bytes as the JAX package's serial xla route on the same
seed, and its `sample` CLI must print the JAX CLI's lines.
"""

import dataclasses

import numpy as np
import pytest
from _torch_threads import one_torch_thread  # noqa: F401

import pluss_sampler_optimization_torch as T
import pluss_sampler_optimization_tpu as J
from pluss_sampler_optimization_torch.cli import main as t_main
from pluss_sampler_optimization_torch.models import REGISTRY as T_MODELS
from pluss_sampler_optimization_torch.runtime import aet as t_aet
from pluss_sampler_optimization_torch.runtime import cri as t_cri
from pluss_sampler_optimization_torch.runtime.baseline import (
    state_to_json as t_state_json,
)
from pluss_sampler_optimization_torch.sampler import sampled as TS
from pluss_sampler_optimization_tpu.cli import main as j_main
from pluss_sampler_optimization_tpu.models import REGISTRY as J_MODELS
from pluss_sampler_optimization_tpu.runtime import aet as j_aet
from pluss_sampler_optimization_tpu.runtime import cri as j_cri
from pluss_sampler_optimization_tpu.runtime.baseline import (
    state_to_json as j_state_json,
)
from pluss_sampler_optimization_tpu.sampler.sampled import (
    run_sampled as j_run_sampled,
)

RATIO, SEED = 0.3, 0


def _mrc(cri, aet, state, machine):
    T_ = machine.thread_num
    return aet.aet_mrc(cri.cri_distribute(state, T_, T_), machine)


@pytest.mark.parametrize("name", [
    "gemm", "2mm", "jacobi-2d",
    # the triangular nests (tests/test_torch_tri.py holds their classify)
    "syrk-tri", "trmm", "trisolv", "covariance",
])
def test_run_sampled_folds_like_jax(name):
    jm, tm = J.MachineConfig(), T.MachineConfig()
    js, jres = j_run_sampled(
        J_MODELS[name](16), jm, J.SamplerConfig(
            ratio=RATIO, seed=SEED, kernel_backend="xla", fuse_refs=False,
            device_draw=False,
        ),
    )
    ts, tres = T.run_sampled(
        T_MODELS[name](16), tm,
        T.SamplerConfig(ratio=RATIO, seed=SEED, fuse_refs=True),
        device="cpu",
    )
    assert t_state_json(ts) == j_state_json(js)
    assert (_mrc(t_cri, t_aet, ts, tm).tobytes()
            == _mrc(j_cri, j_aet, js, jm).tobytes())
    # same sample sets: names, counts and cold multiplicities per ref
    assert [(r.name, r.n_samples, r.cold) for r in tres] == [
        (r.name, r.n_samples, r.cold) for r in jres
    ]


def test_small_batch_and_capacity_regrow_fold_the_same():
    """Many dispatches per bucket and a capacity of 0 (every dispatch
    that carries a share pair regrows) give the one-dispatch result."""
    prog, m = T_MODELS["gemm"](16), T.MachineConfig()
    cfg = T.SamplerConfig(ratio=RATIO, seed=SEED, fuse_refs=True)
    want = TS.sampled_outputs(prog, m, cfg, device="cpu")
    assert any(r.share for r in want)
    got = TS.sampled_outputs(prog, m, cfg, device="cpu", batch=8,
                             capacity=0)
    assert [dataclasses.asdict(r) for r in got] == [
        dataclasses.asdict(r) for r in want
    ]
    plain = TS.sampled_outputs(
        prog, m, dataclasses.replace(cfg, kernel_backend="torch"),
        device="cpu",
    )
    assert [dataclasses.asdict(r) for r in plain] == [
        dataclasses.asdict(r) for r in want
    ]


def test_host_draw_matches_jax_stream():
    """draw_sample_keys is a verbatim copy: the same seed gives the same
    keys in both packages."""
    from pluss_sampler_optimization_torch.core.trace import ProgramTrace
    from pluss_sampler_optimization_tpu.core.trace import (
        ProgramTrace as JTrace,
    )
    from pluss_sampler_optimization_tpu.sampler import sampled as JS

    for name in ("gemm", "heat-3d"):
        jt = JTrace(J_MODELS[name](24), J.MachineConfig())
        tt = ProgramTrace(T_MODELS[name](24), T.MachineConfig())
        for jnt, tnt in zip(jt.nests, tt.nests):
            for ri in range(jnt.tables.n_refs):
                for seed in (0, 5):
                    a, ha = JS.draw_sample_keys(
                        jnt, ri, J.SamplerConfig(ratio=0.2), seed)
                    b, hb = TS.draw_sample_keys(
                        tnt, ri, T.SamplerConfig(ratio=0.2), seed)
                    np.testing.assert_array_equal(a, b)
                    assert ha == hb


@pytest.mark.parametrize("model,n,ratio", [
    ("gemm", 16, RATIO),
    ("trmm", 12, 0.3),  # a triangular nest
])
def test_sample_cli_prints_the_jax_lines(model, n, ratio, capsys):
    args = ["sample", "--model", model, "--n", str(n), "--ratio", str(ratio)]
    assert j_main(args + ["--platform", "cpu"]) == 0
    want = capsys.readouterr().out
    assert t_main(args + ["--device", "cpu", "--fuse-refs"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert "ref B0" in got and "max iteration count" in got
