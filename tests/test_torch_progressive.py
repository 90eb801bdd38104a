"""The port's progressive precision against the JAX package (exact).

- `sampler/confidence.py` is a byte-equal copy, and the port's
  `runtime/faults.py` holds the JAX package's `_MASK`, `_mix` and
  `counter_u01` (equal by source);
- `run_sampled_progressive` on the CPU equals the JAX package's at
  GEMM(24) and trmm(12): states, per-ref results, `info`, every round's
  band width (==) and MRC bytes, for the full schedule
  (`max_rounds=3`), `tolerance=10.0` (stops after round 1), a
  `should_stop` deadline, an explicit `round_schedule` and `v2=True`;
  the full schedule's results equal `sampled_outputs(raw_noshare=True)`
  on the host draw;
- the `sample` CLI's `--max-rounds`, `--tolerance` and `--round-schedule`
  print the JAX CLI's stdout lines and its `progressive:` stderr line.

Every comparison is exact.
"""

import dataclasses
import inspect
import os

import pytest
import torch

import pluss_sampler_optimization_torch as T
import pluss_sampler_optimization_tpu as J
from pluss_sampler_optimization_torch.cli import main as t_main
from pluss_sampler_optimization_torch.models import REGISTRY as T_MODELS
from pluss_sampler_optimization_torch.runtime import faults as t_faults
from pluss_sampler_optimization_torch.runtime.baseline import (
    state_to_json as t_state_json,
)
from pluss_sampler_optimization_torch.sampler import confidence as t_conf
from pluss_sampler_optimization_torch.sampler import sampled as TS
from pluss_sampler_optimization_tpu.cli import main as j_main
from pluss_sampler_optimization_tpu.models import REGISTRY as J_MODELS
from pluss_sampler_optimization_tpu.runtime import faults as j_faults
from pluss_sampler_optimization_tpu.runtime.baseline import (
    state_to_json as j_state_json,
)
from pluss_sampler_optimization_tpu.sampler import sampled as JS

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU runs here are many small tensor operations, which
    one thread runs fastest; beside the suite's other workers a thread
    pool per process only contends. The worker's setting comes back
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_confidence_is_a_copy_and_the_counter_hash_equal():
    rel = os.path.join("sampler", "confidence.py")
    with open(os.path.join(ROOT, "pluss_sampler_optimization_tpu", rel)) as a, \
            open(os.path.join(ROOT, "pluss_sampler_optimization_torch",
                              rel)) as b:
        assert a.read() == b.read()
    assert t_faults._MASK == j_faults._MASK == (1 << 64) - 1
    for name in ("_mix", "counter_u01"):
        assert (inspect.getsource(getattr(t_faults, name))
                == inspect.getsource(getattr(j_faults, name)))
    assert t_conf.counter_u01 is t_faults.counter_u01
    for path in ((), ("mrc_bootstrap", 0, 1, 2, 3), ("x", -1, 1 << 70)):
        assert (t_faults.counter_u01(7, *path)
                == j_faults.counter_u01(7, *path))


def test_stream_order_and_sum_blocks_are_copies():
    for name in ("_stream_order", "_sum_blocks"):
        assert (inspect.getsource(getattr(TS, name))
                == inspect.getsource(getattr(JS, name)))


def _deadline_after(n):
    """should_stop that answers True from its n-th call on."""
    calls = []

    def stop():
        calls.append(1)
        return len(calls) >= n

    return stop


CASES = {
    "full": ({"max_rounds": 3}, False, None),
    "tolerance": ({"tolerance": 10.0}, False, None),
    "should_stop": ({"max_rounds": 4}, False, 2),
    "round_schedule": ({"round_schedule": (0.2, 0.45, 0.7, 1.0)}, False,
                       None),
    "v2": ({"max_rounds": 3}, True, None),
}


def _run(pkg, models, name, args, knobs, v2, stop, **kw):
    bands = []
    state, results, info = pkg.run_sampled_progressive(
        models[name](*args), (T if pkg is TS else J).MachineConfig(),
        (T if pkg is TS else J).SamplerConfig(ratio=0.3, seed=1, **knobs),
        v2=v2, on_round=lambda i: bands.append(
            (i["round"], i["rounds_total"], i["band_width"], i["converged"],
             i["mrc"].tobytes())),
        should_stop=None if stop is None else _deadline_after(stop), **kw)
    return state, results, info, bands


@pytest.mark.parametrize("name,args", [("gemm", (24,)), ("trmm", (12,))])
@pytest.mark.parametrize("case", sorted(CASES))
def test_progressive_matches_jax(name, args, case):
    knobs, v2, stop = CASES[case]
    ts, tres, tinfo, tb = _run(TS, T_MODELS, name, args, knobs, v2, stop,
                               device="cpu")
    js, jres, jinfo, jb = _run(JS, J_MODELS, name, args, knobs, v2, stop)
    assert t_state_json(ts) == j_state_json(js)
    assert [dataclasses.asdict(r) for r in tres] == [
        dataclasses.asdict(r) for r in jres]
    assert tinfo == jinfo
    assert tb == jb  # every round's band width (==) and interim MRC bytes
    if case == "tolerance":
        assert tinfo["rounds"] == 1 and tinfo["stopped"] == "converged"
    if case == "should_stop":
        assert tinfo["rounds"] == 2 and tinfo["stopped"] == "deadline"
        assert not tinfo["converged"]
    if tinfo["rounds"] == tinfo["rounds_total"]:
        # the full schedule is the host draw's one-shot sample set
        cfg = T.SamplerConfig(ratio=0.3, seed=1, device_draw=False)
        raw = TS.sampled_outputs(T_MODELS[name](*args), T.MachineConfig(),
                                 cfg, device="cpu", raw_noshare=True,
                                 batch=1 << 10)
        assert [dataclasses.asdict(r) for r in raw] == [
            dataclasses.asdict(r) for r in tres]
        one_shot, _ = T.run_sampled(T_MODELS[name](*args), T.MachineConfig(),
                                    cfg, device="cpu")
        if not v2:
            assert t_state_json(one_shot) == t_state_json(ts)


def test_progressive_chunks_regrow_and_counters():
    """Chunks of 64 keys and 1 pair slot give the same results (a regrow
    sticks); the counters count the rounds and one dispatch per
    chunk."""
    prog, m = T_MODELS["gemm"](16), T.MachineConfig()
    cfg = T.SamplerConfig(ratio=0.3, seed=2, max_rounds=2)
    base = TS.run_sampled_progressive(prog, m, cfg, device="cpu")
    counters: dict = {}
    spans: dict = {}
    small = TS.run_sampled_progressive(prog, m, cfg, device="cpu", batch=64,
                                       capacity=1, counters=counters,
                                       spans=spans)
    assert t_state_json(small[0]) == t_state_json(base[0])
    assert small[2] == base[2]
    assert counters["progressive_rounds"] == 2
    assert counters["capacity_regrows"] >= 1
    want = 0
    for r in small[1]:  # 4 blocks per round, each in chunks of 64 keys
        counts = t_conf.round_counts(r.n_samples, (0.5, 1.0))
        for lo, hi in zip([0] + counts[:-1], counts):
            want += sum(-(-(b - a) // 64)
                        for a, b in t_conf.block_bounds(lo, hi))
    assert counters["dispatches"] == want
    assert {"draw", "dispatch", "decode", "fold", "bootstrap"} <= set(spans)


def test_progressive_needs_cuda_unless_cpu_and_warns_on_device_draw(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.run_sampled_progressive(T_MODELS["gemm"](8), T.MachineConfig())
    with pytest.raises(ValueError, match="CUDA tensors"):
        TS.run_sampled_progressive(
            T_MODELS["gemm"](8), T.MachineConfig(),
            T.SamplerConfig(kernel_backend="cuda"), device="cpu")
    # the device draw is not the progressive stream: a warning, and the
    # host draw's results
    host = TS.run_sampled_progressive(
        T_MODELS["gemm"](8), T.MachineConfig(),
        T.SamplerConfig(max_rounds=2), device="cpu")
    with pytest.warns(UserWarning, match="always draws on the host"):
        dev = TS.run_sampled_progressive(
            T_MODELS["gemm"](8), T.MachineConfig(),
            T.SamplerConfig(max_rounds=2, device_draw=True), device="cpu")
    assert t_state_json(dev[0]) == t_state_json(host[0])


@pytest.mark.parametrize("flags", [
    ["--max-rounds", "3"], ["--tolerance", "10"],
    ["--round-schedule", "0.25,0.5,1.0", "--runtime", "v2"],
    ["--max-rounds", "2", "--r10"],
])
def test_sample_cli_progressive_prints_the_jax_lines(capsys, flags):
    args = ["sample", "--model", "gemm", "--n", "16", "--ratio", "0.3",
            *flags]
    assert j_main(args + ["--platform", "cpu"]) == 0
    want = capsys.readouterr()
    assert t_main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert got.out == want.out
    line = [x for x in got.err.splitlines() if x.startswith("progressive:")]
    assert line == [x for x in want.err.splitlines()
                    if x.startswith("progressive:")]
    assert len(line) == 1
    if "--tolerance" in flags:
        assert line[0].startswith("progressive: rounds 1/4")
