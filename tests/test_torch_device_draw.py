"""The sampled engines with the device draw, against the JAX package (exact).

- `SamplerConfig().device_draw` (None) resolves as the JAX package's
  auto does: the device draw on a CUDA device, the host draw on the CPU;
- `run_sampled(..., SamplerConfig(device_draw=True), device="cpu")`
  folds to the JAX package's PRIState and MRC bytes with the same sample
  counts and cold multiplicities per ref, on gemm, 2mm, 3mm and
  jacobi-2d, at the CPU batch and at the card's (2^20);
- `sampled_outputs_sharded` with the device draw on CPU meshes of 1, 2
  and 8 equals the JAX package's sharded engine (its scan form) per ref,
  and folds to `run_sampled`'s state; two gloo processes, each replaying
  the draw and keeping its rows, give the same;
- the sharded engine's non-dividing-mesh rule raises or warns as the JAX
  package's does;
- the `sample` CLI with `--device-draw` prints the JAX CLI's lines.

Every comparison is exact.
"""

import dataclasses
import warnings

import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_dist import DEVICE_DRAW, DEVICE_RUNS, check_workers, run_workers

import pluss_sampler_optimization_torch as T
import pluss_sampler_optimization_tpu as J
from pluss_sampler_optimization_torch.cli import main as t_main
from pluss_sampler_optimization_torch.models import REGISTRY as T_MODELS
from pluss_sampler_optimization_torch.parallel import build_mesh
from pluss_sampler_optimization_torch.parallel import sharded as TSH
from pluss_sampler_optimization_torch.runtime import aet as t_aet
from pluss_sampler_optimization_torch.runtime import cri as t_cri
from pluss_sampler_optimization_torch.runtime.baseline import (
    state_to_json as t_state_json,
)
from pluss_sampler_optimization_torch.sampler import sampled as TS
from pluss_sampler_optimization_tpu.cli import main as j_main
from pluss_sampler_optimization_tpu.models import REGISTRY as J_MODELS
from pluss_sampler_optimization_tpu.parallel import (
    build_mesh as j_build_mesh,
    sampled_outputs_sharded as j_outputs_sharded,
)
from pluss_sampler_optimization_tpu.runtime import aet as j_aet
from pluss_sampler_optimization_tpu.runtime import cri as j_cri
from pluss_sampler_optimization_tpu.runtime.baseline import (
    state_to_json as j_state_json,
)
from pluss_sampler_optimization_tpu.sampler.sampled import (
    run_sampled as j_run_sampled,
)


def _mrc(cri, aet, state, machine):
    T_ = machine.thread_num
    return aet.aet_mrc(cri.cri_distribute(state, T_, T_), machine)


def test_auto_resolves_as_the_jax_package():
    """None: the device draw on CUDA (no card needed to resolve), the
    host draw on the CPU; True and False as they say."""
    auto, on, off = (T.SamplerConfig(), T.SamplerConfig(device_draw=True),
                     T.SamplerConfig(device_draw=False))
    assert TS._use_device_draw(auto, torch.device("cuda")) is True
    assert TS._use_device_draw(auto, "cuda:1") is True
    assert TS._use_device_draw(auto, torch.device("cpu")) is False
    for dev in ("cpu", torch.device("cuda")):
        assert TS._use_device_draw(on, dev) is True
        assert TS._use_device_draw(off, dev) is False


@pytest.mark.parametrize("name,n,batch", [
    ("gemm", 16, None), ("2mm", 16, None), ("3mm", 12, None),
    ("jacobi-2d", 32, None), ("gemm", 24, 1 << 20),
])
def test_run_sampled_device_draw_folds_like_jax(name, n, batch):
    jm, tm = J.MachineConfig(), T.MachineConfig()
    kw = {} if batch is None else {"batch": batch}
    js, jres = j_run_sampled(
        J_MODELS[name](n), jm,
        J.SamplerConfig(ratio=0.3, seed=1, device_draw=True), **kw)
    ts, tres = T.run_sampled(
        T_MODELS[name](n), tm,
        T.SamplerConfig(ratio=0.3, seed=1, device_draw=True, fuse_refs=True),
        device="cpu", **kw)
    assert t_state_json(ts) == j_state_json(js)
    assert (_mrc(t_cri, t_aet, ts, tm).tobytes()
            == _mrc(j_cri, j_aet, js, jm).tobytes())
    assert [(r.name, r.n_samples, r.cold) for r in tres] == [
        (r.name, r.n_samples, r.cold) for r in jres
    ]


def test_replayed_members_fold_like_jax(monkeypatch):
    """Buffers planned at s + 2 slots, at batch 1 (the JAX package scans
    a buffer in whole batches): some members of a bucket replay
    their draw with a grown buffer and dispatch apart from the others;
    the run still folds to the JAX package's state and MRC bytes."""
    from pluss_sampler_optimization_torch.sampler import draw as TD
    from pluss_sampler_optimization_tpu.sampler import draw as JD

    batch = 1
    for mod in (JD, TD):
        def tight(nt, ri, cfg, batch, plan=mod.plan_draw):
            p = plan(nt, ri, cfg, batch)
            return None if p is None else (p[2] + 2, *p[1:])

        monkeypatch.setattr(mod, "plan_draw", tight)
    jm, tm = J.MachineConfig(), T.MachineConfig()
    js, _ = j_run_sampled(
        J_MODELS["gemm"](16), jm,
        J.SamplerConfig(ratio=0.3, seed=0, device_draw=True), batch=batch)
    prog = T_MODELS["gemm"](16)
    cfg = T.SamplerConfig(ratio=0.3, seed=0, device_draw=True,
                          fuse_refs=True)
    trace, rows = TS._program_rows(prog, tm)
    ds = list(TS.plan_dispatches(trace, rows, cfg, torch.device("cpu"),
                                 batch, "auto"))
    buckets = [{idx for idx, _ in m}
               for m in TS._bucket_rows(trace, rows).values() if len(m) > 1]
    assert any(len(d.members) < len(b) and d.members[0][0] in b
               for d in ds for b in buckets)
    ts, _ = T.run_sampled(prog, tm, cfg, device="cpu", batch=batch)
    assert t_state_json(ts) == j_state_json(js)
    assert (_mrc(t_cri, t_aet, ts, tm).tobytes()
            == _mrc(j_cri, j_aet, js, jm).tobytes())


def test_device_draw_dispatches_are_masked_views():
    """A device-drawn bucket dispatches column spans of its drawn buffer
    and chosen mask (views, no copies), at most 8 batches wide; their
    chosen lanes are exactly the samples; the plain route equals the
    default; a tiny batch with capacity 0 folds the same."""
    prog, m = T_MODELS["gemm"](16), T.MachineConfig()
    cfg = T.SamplerConfig(ratio=0.3, seed=2, device_draw=True,
                          fuse_refs=True)
    trace, rows = TS._program_rows(prog, m)
    ds = list(TS.plan_dispatches(trace, rows, cfg, torch.device("cpu"), 8,
                                 "auto"))
    assert any(d.keys_RB.shape[1] < d.keys_RB.stride(0) for d in ds
               if d.keys_RB.shape[0] > 1)
    chosen = {}
    for d in ds:
        assert d.mask_RB is not None and d.keys_RB.shape[1] <= 8 * 8
        assert d.mask_RB.stride() == d.keys_RB.stride()
        for (idx, _), row in zip(d.members, d.mask_RB):
            chosen[idx] = chosen.get(idx, 0) + int(row.sum())
    want = TS.sampled_outputs(prog, m, cfg, device="cpu", batch=8)
    assert [chosen[i] for i in range(len(rows))] == [
        r.n_samples for r in want]
    plain = TS.sampled_outputs(
        prog, m, dataclasses.replace(cfg, kernel_backend="torch"),
        device="cpu", batch=8, capacity=0)
    assert [dataclasses.asdict(r) for r in plain] == [
        dataclasses.asdict(r) for r in want
    ]


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_sharded_device_draw_matches_jax_and_run_sampled(n_dev):
    """The per-ref device-draw form (the scan form: each shard's block
    of the drawn buffer in batch/n_dev-row steps, merged on the shard),
    2 pair slots (regrows). The fold equals run_sampled's state and MRC
    bytes at the same batch, with one read back per ref and per regrow;
    on 8 shards the raw per-ref results and pow2 histograms also equal
    the JAX package's (its scan form on its virtual 8-device mesh), and
    so do the port's fused form's and those of the kernel route's logic
    (B1's plain raw form per step, the histogram of the gathered
    pairs)."""
    prog, m = T_MODELS["gemm"](16), T.MachineConfig()
    cfg = T.SamplerConfig(ratio=0.25, seed=3, device_draw=True)
    batch = 64
    counters: dict = {}
    tres, td = TSH.sampled_outputs_sharded(
        prog, m, cfg, build_mesh(devices=["cpu"] * n_dev), batch=batch,
        capacity=2, counters=counters)
    assert counters["fetches"] == len(tres) + counters.get(
        "capacity_regrows", 0)
    if n_dev == 8:
        jres, jd = j_outputs_sharded(
            J_MODELS["gemm"](16), J.MachineConfig(),
            J.SamplerConfig(ratio=0.25, seed=3, device_draw=True,
                            fuse_refs=False),
            mesh=j_build_mesh(n_dev), batch=batch)
        want = [(r.name, r.noshare, r.share, r.cold, r.n_samples)
                for r in jres]
        want_d = [list(map(int, b)) for b in jd]
        fused = TSH.sampled_outputs_sharded(
            prog, m, dataclasses.replace(cfg, fuse_refs=True),
            build_mesh(devices=["cpu"] * n_dev), batch=batch, capacity=2)
        route = TSH._kernel_route
        TSH._kernel_route = lambda backend, mesh: True
        try:
            kernel_logic = TSH.sampled_outputs_sharded(
                prog, m, cfg, build_mesh(devices=["cpu"] * n_dev),
                batch=batch, capacity=2)
        finally:
            TSH._kernel_route = route
        for res, dense in ((tres, td), fused, kernel_logic):
            assert [(r.name, r.noshare, r.share, r.cold, r.n_samples)
                    for r in res] == want
            assert [list(map(int, a)) for a in dense] == want_d
    want, _ = T.run_sampled(prog, m, cfg, device="cpu", batch=batch)
    state = TS.fold_results(tres, m.thread_num)
    assert t_state_json(state) == t_state_json(want)
    assert (_mrc(t_cri, t_aet, state, m).tobytes()
            == _mrc(t_cri, t_aet, want, m).tobytes())


def test_non_dividing_mesh_rule(monkeypatch):
    """A mesh size that does not divide the batch: explicit True raises,
    auto (where it resolves to the device draw) warns and takes the host
    stream, as the JAX package's sharded engine does."""
    prog, m = T_MODELS["gemm"](8), T.MachineConfig()
    mesh = build_mesh(devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="mesh size dividing"):
        TSH.run_sampled_sharded(prog, m, T.SamplerConfig(device_draw=True),
                                mesh, batch=40)
    monkeypatch.setattr(TSH, "_use_device_draw",
                        lambda cfg, dev: cfg.device_draw is not False)
    with pytest.warns(UserWarning, match="downgrades to the host draw"):
        st, _ = TSH.run_sampled_sharded(prog, m, T.SamplerConfig(), mesh,
                                        batch=40)
    host, _ = T.run_sampled(prog, m, T.SamplerConfig(device_draw=False),
                            device="cpu")
    assert t_state_json(st) == t_state_json(host)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        TSH.run_sampled_sharded(prog, m, T.SamplerConfig(), mesh, batch=42)


def test_gloo_processes_device_draw():
    """Two ranks, each replaying the draw on its own device and keeping
    its rows, print identical results equal to the single-process
    engines' at each batch."""
    outs = run_workers(2, "cpu", cfg=DEVICE_DRAW, runs=DEVICE_RUNS)
    check_workers(outs, "cpu", cfg=DEVICE_DRAW, runs=DEVICE_RUNS)


@pytest.mark.parametrize("engine", ["sampled", "sharded"])
def test_sample_cli_device_draw_prints_the_jax_lines(engine, capsys):
    args = ["sample", "--model", "gemm", "--n", "16", "--ratio", "0.3",
            "--device-draw"]
    assert j_main(args + ["--platform", "cpu"]) == 0
    want = capsys.readouterr().out
    assert t_main(args + ["--engine", engine, "--device", "cpu",
                          "--fuse-refs"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert "ref B0" in got and "max iteration count" in got
    assert t_main(args[:-1] + ["--no-device-draw", "--device", "cpu"]) == 0
    assert capsys.readouterr().out != want
