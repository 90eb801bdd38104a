"""The sampled engine's raw route against the JAX package (exact).

The raw-noshare route (`raw_noshare=True`: runtime v2 and the r10
distribute; the plain version of kernel B1's raw form on the CPU) gives
the JAX package's xla per-ref results field for field, its v2 PRIState,
and the JAX CLI's `sample --runtime v2`, `--r10` and `--runtime v2
--r10` lines byte for byte; `results_from_samples` classifies the same
explicit samples to the same results; a default run's checkpoint tag is
the JAX package's. Host draw, N <= 16, ratio 0.25-0.3.
"""

import dataclasses

import numpy as np
import pytest
from _torch_threads import one_torch_thread  # noqa: F401

import pluss_sampler_optimization_torch as T
import pluss_sampler_optimization_tpu as J
from pluss_sampler_optimization_torch.cli import main as t_main
from pluss_sampler_optimization_torch.models import REGISTRY as T_MODELS
from pluss_sampler_optimization_torch.runtime.baseline import (
    state_to_json as t_state_json,
)
from pluss_sampler_optimization_torch.sampler import sampled as TS
from pluss_sampler_optimization_tpu.cli import main as j_main
from pluss_sampler_optimization_tpu.models import REGISTRY as J_MODELS
from pluss_sampler_optimization_tpu.runtime.baseline import (
    state_to_json as j_state_json,
)
from pluss_sampler_optimization_tpu.sampler import sampled as JS


def _asdicts(results):
    return [dataclasses.asdict(r) for r in results]


@pytest.mark.parametrize("name,n,ratio", [
    ("gemm", 16, 0.3), ("2mm", 12, 0.25), ("trmm", 12, 0.3),
])
def test_v2_state_and_results_match_jax(name, n, ratio):
    """run_sampled(v2=True) under both runners: the JAX package's v2
    state and its xla per-ref results (raw noshare keys), field for
    field; the v1 fold of the raw route equals the binned route's."""
    js, jres = JS.run_sampled(
        J_MODELS[name](n), J.MachineConfig(), J.SamplerConfig(
            ratio=ratio, seed=1, kernel_backend="xla", fuse_refs=False,
            device_draw=False,
        ), v2=True,
    )
    tm = T.MachineConfig()
    for fuse in (True, False):
        cfg = T.SamplerConfig(ratio=ratio, seed=1, fuse_refs=fuse)
        ts, tres = T.run_sampled(T_MODELS[name](n), tm, cfg, v2=True,
                                 device="cpu")
        assert t_state_json(ts) == j_state_json(js)
        assert _asdicts(tres) == _asdicts(jres)
        binned, _ = T.run_sampled(T_MODELS[name](n), tm, cfg, device="cpu")
        assert (t_state_json(TS.fold_results(tres, tm.thread_num))
                == t_state_json(binned))


@pytest.mark.parametrize("model,n", [("gemm", 16), ("trmm", 12)])
def test_sample_cli_r10_and_v2_print_the_jax_lines(model, n, capsys):
    args = ["sample", "--model", model, "--n", str(n), "--ratio", "0.3"]
    for extra in (["--runtime", "v2"], ["--r10"], ["--runtime", "v2",
                                                    "--r10"]):
        assert j_main(args + extra + ["--platform", "cpu"]) == 0
        want = capsys.readouterr().out
        assert t_main(args + extra + ["--device", "cpu"]) == 0
        got = capsys.readouterr().out
        assert got == want, extra
        if "--r10" in extra:
            assert "ref B0" in got and "\nB0\n" in got


def test_results_from_samples_matches_jax():
    """The same explicit sample tuples, classified by both packages."""
    prog_j, prog_t = J_MODELS["gemm"](12), T_MODELS["gemm"](12)
    rng = np.random.default_rng(4)
    samples = {"C0": rng.integers(0, 11, size=(40, 2)),
               "A0": rng.integers(0, 11, size=(30, 3)),
               "C3": rng.integers(0, 11, size=(25, 3))}
    want = JS.results_from_samples(prog_j, J.MachineConfig(), samples)
    got = TS.results_from_samples(prog_t, T.MachineConfig(), samples,
                                  device="cpu")
    assert _asdicts(got) == _asdicts(want)
    with pytest.raises(ValueError, match="unknown tracked refs"):
        TS.results_from_samples(prog_t, T.MachineConfig(), {"Z9": []},
                                device="cpu")


def test_default_checkpoint_tag_is_the_jax_packages():
    """A default run on the CPU (the host draw, no batch in the tag): the
    same tag, byte for byte; a raw run's carries its own suffix."""
    for name, n in (("gemm", 16), ("syrk-tri", 12)):
        jcfg = J.SamplerConfig(ratio=0.3, seed=2)
        tcfg = T.SamplerConfig(ratio=0.3, seed=2)
        jtag = JS._checkpoint_tagger(J_MODELS[name](n), J.MachineConfig(),
                                     jcfg, 1 << 17)
        ttag = TS._checkpoint_tagger(T_MODELS[name](n), T.MachineConfig(),
                                     tcfg, TS.CPU_BATCH, "cpu")
        assert ttag(3, "C0") == jtag(3, "C0")
        raw = TS._checkpoint_tagger(T_MODELS[name](n), T.MachineConfig(),
                                    tcfg, TS.CPU_BATCH, "cpu", raw=True)
        assert raw(3, "C0") == jtag(3, "C0") + "|raw"
