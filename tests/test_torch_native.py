"""The native CPU engines of the port against its torch route and the JAX
package.

native/ is a byte-equal copy of the JAX package's (pinned by
tests/test_torch_host.py::COPIED): a C++ serial walk (run_serial_native,
and run_parallel_native, one OS thread per simulated thread), and the
sampled engine's CPU reduction (classify_reduce), built with make at
first use. The port's sampled engine takes it under
kernel_backend="native" on the CPU only. Held here, exactly:

- run_serial_native and run_parallel_native against the port's numpy
  oracle on registry models and the made nests past kernel B1's old
  limits, and against the JAX package's native walk on gemm;
- kernel_backend="native" against the port's "torch" route, result for
  result (the per-ref results, not only the folded state), on registry
  models and the made nests, under the host draw and the device draw;
- the same against the JAX package's native route once, on gemm at a
  small N (the JAX sampled engine compiles, so this is the file's one
  JAX sampled run);
- its counters, and its refusal off the CPU.
"""

import dataclasses

import pytest
import torch
from _torch_made import distinct_maps_program, past_limits_programs
from _torch_native import native_built

import pluss_sampler_optimization_torch as T
import pluss_sampler_optimization_tpu as J
from pluss_sampler_optimization_torch import native as t_native
from pluss_sampler_optimization_torch.ir import Loop, ParallelNest, Program, Ref
from pluss_sampler_optimization_torch.models import REGISTRY as T_MODELS
from pluss_sampler_optimization_torch.oracle import run_numpy
from pluss_sampler_optimization_torch.sampler import sampled as TS
from pluss_sampler_optimization_tpu import native as j_native
from pluss_sampler_optimization_tpu.models import REGISTRY as J_MODELS
from pluss_sampler_optimization_tpu.sampler import sampled as JS

MODELS = ("gemm", "syrk-tri", "trmm", "jacobi-2d", "mvt", "heat-3d")


@pytest.fixture(autouse=True, scope="module")
def _built():
    native_built()


def _same_state(a, b):
    assert a.total_accesses == b.total_accesses
    for t in range(len(b.state.noshare)):
        assert a.state.noshare[t] == b.state.noshare[t], t
        assert a.state.share[t] == b.state.share[t], t


def _made(n):
    return past_limits_programs(Loop, ParallelNest, Program, Ref, n)


@pytest.mark.parametrize("name", MODELS)
def test_native_walks_equal_the_numpy_oracle(name):
    prog, m = T_MODELS[name](12), T.MachineConfig(thread_num=3, chunk_size=2)
    want = run_numpy(prog, m)
    _same_state(t_native.run_serial_native(prog, m), want)
    _same_state(t_native.run_parallel_native(prog, m), want)


def test_native_walks_on_the_made_nests():
    m = T.MachineConfig()
    for prog in _made(8):
        want = run_numpy(prog, m)
        _same_state(t_native.run_serial_native(prog, m), want)
        _same_state(t_native.run_parallel_native(prog, m), want)


def test_native_walk_equals_the_jax_package():
    got = t_native.run_serial_native(T_MODELS["gemm"](24), T.MachineConfig())
    want = j_native.run_serial_native(J_MODELS["gemm"](24),
                                      J.MachineConfig())
    _same_state(got, want)
    assert got.per_tid_accesses == want.per_tid_accesses


def _outputs(prog, cfg, backend, counters=None):
    return TS.sampled_outputs(
        prog, T.MachineConfig(), dataclasses.replace(
            cfg, kernel_backend=backend), device="cpu", counters=counters)


@pytest.mark.parametrize("name", MODELS)
def test_native_route_equals_the_torch_route(name):
    prog = T_MODELS[name](16)
    cfg = T.SamplerConfig(ratio=0.3, seed=2)
    counters: dict = {}
    got = _outputs(prog, cfg, "native", counters)
    assert got == _outputs(prog, cfg, "torch")
    assert counters["dispatches_native"] == counters["dispatches"]
    assert counters["native_chunk_plan"] == counters["dispatches"]


@pytest.mark.parametrize("k", range(4), ids=["distinct24", "one-map9",
                                              "one-map17", "one-map9-tri"])
def test_native_route_on_the_made_nests(k):
    """The made nests, the distinct maps cut to 24 refs (the native route
    never builds B1's descriptor; both routes' plain classify walks
    every group of every ref)."""
    prog = (distinct_maps_program(Loop, ParallelNest, Program, Ref, 8, 24)
            if k == 0 else _made(8)[k])
    cfg = T.SamplerConfig(ratio=0.4, seed=k)
    assert _outputs(prog, cfg, "native") == _outputs(prog, cfg, "torch")


def test_native_route_device_draw_chunks_and_regrows():
    """The device draw forced on the CPU (masked chunks), chunks of 512
    keys and a capacity of 1 (every chunk regrows): equal results."""
    prog = T_MODELS["syrk-tri"](16)
    cfg = T.SamplerConfig(ratio=0.5, seed=1, device_draw=True)
    kw = dict(device="cpu", batch=512, capacity=1)
    counters: dict = {}
    got = TS.sampled_outputs(prog, T.MachineConfig(), dataclasses.replace(
        cfg, kernel_backend="native"), counters=counters, **kw)
    want = TS.sampled_outputs(prog, T.MachineConfig(), dataclasses.replace(
        cfg, kernel_backend="torch"), **kw)
    assert got == want
    assert counters["capacity_regrows"] > 0
    assert counters["native_chunk_plan"] > len(got)


def test_native_route_equals_the_jax_native_route():
    """gemm N=16: the port's native route against the JAX package's
    (its raw XLA classify, then the same C++ pass), per-ref results and
    folded state."""
    jcfg = J.SamplerConfig(ratio=0.3, seed=1, kernel_backend="native")
    want = JS.sampled_outputs(J_MODELS["gemm"](16), J.MachineConfig(), jcfg)
    got = _outputs(T_MODELS["gemm"](16), T.SamplerConfig(ratio=0.3, seed=1),
                   "native")
    assert [dataclasses.asdict(r) for r in got] == [
        dataclasses.asdict(r) for r in want]


def test_native_route_refuses_the_card(monkeypatch):
    """Off the CPU "native" raises, naming device="cpu"; under the raw
    route (v2) it gives way to the plain classify, as the JAX package's
    hist backends do."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = T.SamplerConfig(ratio=0.3, kernel_backend="native")
    with pytest.raises(ValueError, match='device="cpu"'):
        T.run_sampled(T_MODELS["gemm"](8), T.MachineConfig(), cfg,
                      device="cuda")
    monkeypatch.undo()
    with pytest.warns(UserWarning, match="raw-noshare"):
        got = TS.sampled_outputs(T_MODELS["gemm"](8), T.MachineConfig(),
                                 cfg, device="cpu", raw_noshare=True)
    assert got == TS.sampled_outputs(
        T_MODELS["gemm"](8), T.MachineConfig(),
        dataclasses.replace(cfg, kernel_backend="torch"), device="cpu",
        raw_noshare=True)


@pytest.mark.parametrize("n_refs", [32, 33, 64])
def test_exact_engines_past_32_refs(n_refs):
    """The exact engines' packed keys hold a ref field of ref_bits(nest)
    bits: the JAX package's 5 bits fold wrong states past 32 refs (at 33
    distinct maps, N=16, tid 0's noshare[1] is 13328 in its dense and
    periodic engines against 13568 in its native walk), so the made
    nests are held against the native walk, which packs nothing."""
    from pluss_sampler_optimization_torch.sampler import dense as TD
    from pluss_sampler_optimization_torch.sampler.periodic import (
        run_exact,
        run_periodic,
    )
    from pluss_sampler_optimization_torch.sampler.stream import run_stream

    prog = distinct_maps_program(Loop, ParallelNest, Program, Ref, 12,
                                 n_refs)
    m = T.MachineConfig()
    want = t_native.run_serial_native(prog, m)
    for fn in (run_exact, run_periodic, TD.run_dense, run_stream):
        _same_state(fn(prog, m, device="cpu"), want)
    nt = TS._program_rows(prog, m)[0].nests[0]
    assert TD.ref_bits(nt) == (5 if n_refs <= 32 else 6)
