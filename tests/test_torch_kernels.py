"""The hand-written CUDA kernels against their plain torch versions, on the card.

Marked `gpu`: every test skips where torch sees no CUDA device (decided
inside the `cuda` fixture, never at import); the multi-card tests also
skip with fewer than two cards. On a machine with a card:

    python -m pytest tests/test_torch_kernels.py -q -p no:cacheprovider --noconftest

(`--noconftest` because tests/conftest.py sets up JAX, which this file
does not use.) Every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch
from _torch_dist import check_workers, run_workers
from _torch_made import made_program, made_tri_program

import pluss_sampler_optimization_torch as T
from pluss_sampler_optimization_torch.ir import (
    Loop,
    ParallelNest,
    Program,
    Ref,
)
from pluss_sampler_optimization_torch.models import REGISTRY
from pluss_sampler_optimization_torch.ops import pow2_hist as p2
from pluss_sampler_optimization_torch.ops import sampled_hist as sh
from pluss_sampler_optimization_torch.ops import threefry_draw as td
from pluss_sampler_optimization_torch.parallel import (
    build_mesh,
    run_sampled_sharded,
)
from pluss_sampler_optimization_torch.runtime.baseline import state_to_json
from pluss_sampler_optimization_torch.sampler import draw as D
from pluss_sampler_optimization_torch.sampler import sampled as S

pytestmark = pytest.mark.gpu

RECT = ["2mm", "3mm", "adi", "atax", "bicg", "doitgen", "fdtd-2d", "gemm",
        "gemver", "gesummv", "heat-3d", "jacobi-2d", "mvt", "syrk"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("name", RECT)
def test_kernel_matches_plain(name, cuda):
    """Every bucket of the model, with a random mask and key-0 padding
    and again unpadded with no mask, through the kernel and the plain
    version on the card."""
    rng = np.random.default_rng(3)
    cfg = T.SamplerConfig(ratio=0.3, seed=2)
    trace, rows = S._program_rows(REGISTRY[name](48), T.MachineConfig())
    for (k, _), members in S._bucket_rows(trace, rows).items():
        nt, ri0 = trace.nests[k], members[0][1]
        highs, _ = S._sample_highs(nt, ri0, cfg)
        ks = [S.draw_sample_keys(nt, ri, cfg, seed=idx)[0]
              for idx, ri in members]
        B = len(ks[0]) + 100
        keys = np.stack([np.concatenate([x, np.full(100, x[0])])
                         for x in ks])
        mask = rng.random(keys.shape) < 0.9
        mask[:, -100:] = False
        args = (
            torch.from_numpy(keys).to(cuda), torch.from_numpy(mask).to(cuda),
            S._pad_highs(highs),
            torch.tensor([ri for _, ri in members], device=cuda),
        )
        assert args[0].shape == (len(members), B)
        n0 = sh.LAUNCHES
        got = sh.sampled_hist(nt, ri0, *args)
        want = sh.sampled_hist_plain(nt, ri0, *args)
        # no mask, as the engine dispatches: every lane live
        live = (args[0][:, :-100].contiguous(), None, *args[2:])
        got_live = sh.sampled_hist(nt, ri0, *live)
        assert sh.LAUNCHES == n0 + 2
        want_live = sh.sampled_hist_plain(nt, ri0, *live)
        torch.cuda.synchronize()
        for a, b in zip((*got, *got_live), (*want, *want_live)):
            assert torch.equal(a, b)


def test_kernel_matches_plain_on_every_instantiation(cuda):
    """The made program of tests/_torch_made.py launches all 6
    instantiations (LV 0-2 by NHMAX 1 and 3), each equal to the plain
    version."""
    cfg = T.SamplerConfig(ratio=0.6, seed=3)
    prog = made_program(Loop, ParallelNest, Program, Ref)
    trace, rows = S._program_rows(prog, T.MachineConfig())
    seen = set()
    for d in S.plan_dispatches(trace, rows, cfg, cuda, 1 << 20, "cuda"):
        seen.add(sh.instantiation(d.desc))
        args = (d.keys_RB, d.mask_RB, d.highs, d.rx_R)
        got = sh.sampled_hist(d.nt, d.ref_idx, *args, desc=d.desc)
        want = sh.sampled_hist_plain(d.nt, d.ref_idx, *args)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert seen == {(lv, nh, False) for lv in range(3) for nh in (1, 3)}


def test_kernel_matches_plain_on_every_triangular_instantiation(cuda):
    """The made triangular program launches all 6 triangular
    instantiations (LV 0-2 by NHMAX 1 and 3) under the device draw and
    the host draw, each equal to the plain version."""
    prog = made_tri_program(Loop, ParallelNest, Program, Ref)
    trace, rows = S._program_rows(prog, T.MachineConfig())
    seen = set()
    for dd in (True, False):
        cfg = T.SamplerConfig(ratio=0.6, seed=3, device_draw=dd)
        for d in S.plan_dispatches(trace, rows, cfg, cuda, 1 << 20, "cuda"):
            seen.add(sh.instantiation(d.desc))
            args = (d.keys_RB, d.mask_RB, d.highs, d.rx_R)
            got = sh.sampled_hist(d.nt, d.ref_idx, *args, desc=d.desc,
                                  tri_base=d.tri_base)
            want = sh.sampled_hist_plain(d.nt, d.ref_idx, *args)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    assert seen == {(lv, nh, True) for lv in range(3) for nh in (1, 3)}


@pytest.mark.parametrize("name", ["syrk-tri", "trmm", "trisolv",
                                  "covariance"])
def test_triangular_run_sampled_kernel_equals_plain_on_card(name, cuda):
    """The triangular models at N=64: the kernel route (B3's triangular
    draw, B1's triangular walk) folds to the plain route's state, and to
    the CPU's under the host draw."""
    prog, m = REGISTRY[name](64), T.MachineConfig()
    for dd in (True, False):
        cfg = T.SamplerConfig(ratio=0.2, seed=0, device_draw=dd)
        n0 = sh.LAUNCHES
        got, _ = S.run_sampled(prog, m, cfg)
        assert sh.LAUNCHES > n0
        plain, _ = S.run_sampled(
            prog, m, dataclasses.replace(cfg, kernel_backend="torch"))
        assert state_to_json(got) == state_to_json(plain)
        if not dd:
            cpu, _ = S.run_sampled(prog, m, cfg, device="cpu")
            assert state_to_json(got) == state_to_json(cpu)


def test_kernel_rejects_what_it_does_not_take(cuda):
    trace, rows = S._program_rows(REGISTRY["gemm"](16), T.MachineConfig())
    nt = trace.nests[0]
    keys = torch.zeros((1, 8), dtype=torch.int64, device=cuda)
    mask = torch.ones((1, 8), dtype=torch.bool, device=cuda)
    rx = torch.zeros(1, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        sh.sampled_hist_cuda(nt, 0, keys.int(), mask, [15, 15, 1], rx)
    with pytest.raises(ValueError):
        sh.sampled_hist_cuda(nt, 0, keys, mask, [15, 15], rx)
    with pytest.raises(ValueError):
        sh.sampled_hist_cuda(nt, 0, keys.cpu(), mask, [15, 15, 1], rx)


@pytest.mark.parametrize("name", ["gemm", "jacobi-2d"])
def test_run_sampled_kernel_equals_plain_on_card(name, cuda):
    """The default on the card (device draw on B3, classify on B1), the
    plain route on the card, and the device draw on the CPU at the
    card's batch."""
    prog, m = REGISTRY[name](64), T.MachineConfig()
    cfg = T.SamplerConfig(ratio=0.2, seed=0)
    n0, n3 = sh.LAUNCHES, td.LAUNCHES
    st_k, res_k = T.run_sampled(prog, m, cfg)
    assert sh.LAUNCHES > n0 and td.LAUNCHES > n3
    st_t, res_t = T.run_sampled(
        prog, m, dataclasses.replace(cfg, kernel_backend="torch"))
    st_c, _ = T.run_sampled(prog, m, dataclasses.replace(
        cfg, device_draw=True), device="cpu", batch=S.DEFAULT_BATCH)
    assert state_to_json(st_k) == state_to_json(st_t) == state_to_json(st_c)
    assert [dataclasses.asdict(r) for r in res_k] == [
        dataclasses.asdict(r) for r in res_t
    ]


@pytest.mark.parametrize("made", [made_program, made_tri_program])
def test_raw_form_matches_plain_on_every_instantiation(made, cuda):
    """B1's raw-noshare form on the made programs (all 12
    instantiations): bit-equal to the plain version's raw form, the
    histogram empty, and every masked-in sample either a residual pair
    or cold; the binned form's hist plus its pairs hold the same
    samples."""
    prog = made(Loop, ParallelNest, Program, Ref)
    trace, rows = S._program_rows(prog, T.MachineConfig())
    seen = set()
    for dd in (True, False):
        cfg = T.SamplerConfig(ratio=0.6, seed=3, device_draw=dd)
        for d in S.plan_dispatches(trace, rows, cfg, cuda, 1 << 20, "cuda"):
            seen.add(sh.instantiation(d.desc))
            args = (d.keys_RB, d.mask_RB, d.highs, d.rx_R)
            n0 = sh.LAUNCHES
            got = sh.sampled_hist(d.nt, d.ref_idx, *args, desc=d.desc,
                                  tri_base=d.tri_base, raw=True)
            assert sh.LAUNCHES == n0 + 1
            want = sh.sampled_hist_plain(d.nt, d.ref_idx, *args, raw=True)
            binned = sh.sampled_hist(d.nt, d.ref_idx, *args, desc=d.desc,
                                     tri_base=d.tri_base)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            residual, hist, cold = got
            assert not hist.any() and torch.equal(cold, binned[2])
            live = (torch.ones_like(d.keys_RB, dtype=torch.bool)
                    if d.mask_RB is None else d.mask_RB)
            pairs = (residual != sh.SENTINEL).sum(dim=1)
            assert torch.equal(pairs + cold, live.sum(dim=1))
            assert torch.equal(
                (binned[0] != sh.SENTINEL).sum(dim=1) + binned[1].sum(dim=1),
                pairs)
    want = {(lv, nh) for lv in range(3) for nh in (1, 3)}
    assert {(lv, nh) for lv, nh, _ in seen} == want


@pytest.mark.parametrize("name", ["gemm", "trmm"])
def test_raw_route_launches_b1_and_equals_the_cpu(name, cuda):
    """sampled_outputs(raw_noshare=True) on the card runs B1 (never the
    plain version) and gives the CPU's per-ref results under the host
    draw, field for field; v2 and the v1 fold of the raw route equal
    the plain route's on the card."""
    prog, m = REGISTRY[name](48), T.MachineConfig()
    cfg = T.SamplerConfig(ratio=0.3, seed=1, device_draw=False)
    n0 = sh.LAUNCHES
    got = S.sampled_outputs(prog, m, cfg, raw_noshare=True)
    assert sh.LAUNCHES > n0
    cpu = S.sampled_outputs(prog, m, cfg, device="cpu", raw_noshare=True)
    assert [dataclasses.asdict(r) for r in got] == [
        dataclasses.asdict(r) for r in cpu]
    for v2 in (False, True):
        st, _ = S.run_sampled(prog, m, T.SamplerConfig(ratio=0.3, seed=1),
                              v2=v2)
        plain, _ = S.run_sampled(prog, m, T.SamplerConfig(
            ratio=0.3, seed=1, kernel_backend="torch"), v2=v2)
        assert state_to_json(st) == state_to_json(plain)


def test_pipeline_depths_runners_and_resume_on_card(cuda, tmp_path):
    """On the card: pipeline depths 1 and 4, the serial runner and a
    resumed run give the same per-ref results; depth 1 stalls once per
    dispatch; warmup launches B1 and B3 and leaves the run's results
    unchanged."""
    prog, m = REGISTRY["gemm"](64), T.MachineConfig()
    cfg = T.SamplerConfig(ratio=0.2, seed=0)
    n1, n3 = sh.LAUNCHES, td.LAUNCHES
    S.warmup(prog, m, cfg)
    assert sh.LAUNCHES > n1 and td.LAUNCHES > n3
    runs = {}
    for key, c in (("d4", cfg),
                   ("d1", dataclasses.replace(cfg, pipeline_depth=1)),
                   ("serial", dataclasses.replace(cfg, fuse_refs=False))):
        counters: dict = {}
        runs[key] = [dataclasses.asdict(r) for r in S.sampled_outputs(
            prog, m, c, counters=counters, batch=1 << 12)]
        if key == "d1":
            assert counters["pipeline_stalls"] == counters["dispatches"]
    assert runs["d1"] == runs["d4"] == runs["serial"]
    ck = tmp_path / "ck"
    S.sampled_outputs(prog, m, cfg, batch=1 << 12, checkpoint_dir=str(ck))
    (ck / "ref_001.json").unlink()
    counters = {}
    got = S.sampled_outputs(prog, m, cfg, batch=1 << 12, counters=counters,
                            checkpoint_dir=str(ck))
    assert [dataclasses.asdict(r) for r in got] == runs["d4"]
    assert counters["refs_per_dispatch"] == 1


def _b2_made_input(n, seed):
    """n values over all 64 ladder bins, 0 and negatives included."""
    rng = np.random.default_rng(seed)
    e = rng.integers(0, 63, size=n).astype(np.int64)
    lo = np.left_shift(np.int64(1), e)
    vals = lo + rng.integers(0, 1 << 62, size=n) % lo  # bin e
    vals[rng.random(n) < 0.05] = 0
    neg = rng.random(n) < 0.05
    vals[neg] = -rng.integers(1, 1 << 62, size=int(neg.sum()))
    vals[:4] = [0, -(1 << 62), (1 << 62) - 1, -1]
    return vals, rng


@pytest.mark.parametrize("weights", ["bool", "int"])
def test_pow2_hist_kernel_matches_plain(weights, cuda):
    vals, rng = _b2_made_input(1 << 20, 7)
    w = (rng.random(len(vals)) < 0.8 if weights == "bool"
         else rng.integers(-3, 1 << 20, size=len(vals)))
    v, wt = torch.from_numpy(vals).to(cuda), torch.from_numpy(w).to(cuda)
    n0 = p2.LAUNCHES
    got = p2.pow2_hist(v, wt)
    assert p2.LAUNCHES == n0 + 1
    want = p2.pow2_hist_plain(v, wt)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int((want != 0).sum()) == 64


def test_pow2_hist_kernel_same_bin_total_2_31(cuda):
    """The JAX package's overflow boundary: exact in int64."""
    vals = torch.full((1024,), 1 << 10, dtype=torch.int64, device=cuda)
    w = torch.zeros(1024, dtype=torch.int64, device=cuda)
    w[0] = w[128] = 1 << 30
    got = p2.pow2_hist(vals, w)
    assert torch.equal(got, p2.pow2_hist_plain(vals, w))
    assert int(got[10]) == 1 << 31 and int(got.sum()) == 1 << 31


def test_pow2_hist_kernel_empty_and_rejects(cuda):
    n0 = p2.LAUNCHES
    got = p2.pow2_hist(torch.zeros(0, dtype=torch.int64, device=cuda),
                       torch.zeros(0, dtype=torch.bool, device=cuda))
    assert p2.LAUNCHES == n0 and got.tolist() == [0] * 64
    v = torch.ones(8, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        p2.pow2_hist(v, torch.ones(8, device=cuda))
    with pytest.raises(ValueError):
        p2.pow2_hist(v, torch.ones(8, dtype=torch.bool))


def _b2_buffers(n, weights, cuda):
    """n + 16 made values and weights on the card, for views at offsets."""
    vals, rng = _b2_made_input(n + 16, n)
    w = (rng.random(n + 16) < 0.7 if weights == "bool"
         else rng.integers(-3, 1 << 40, size=n + 16))
    return torch.from_numpy(vals).to(cuda), torch.from_numpy(w).to(cuda)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 255, 4097, 1 << 16, 41944])
@pytest.mark.parametrize("weights", ["bool", "int"])
def test_pow2_hist_kernel_sizes_and_misaligned_views(n, weights, cuda):
    """Every size against the plain version, at element offsets 0-15 of
    values and of weights (misaligned views such as v[1:], w[3:] take the
    scalar head and, where the offsets' parities differ, scalar weight
    loads); each call launches once."""
    v, w = _b2_buffers(n, weights, cuda)
    for vo, wo in [(0, 0), (1, 3), (3, 1), (1, 1), (0, 5), (2, 2),
                   (7, 15), (15, 0), (4, 12)]:
        vv, ww = v[vo:vo + n], w[wo:wo + n]
        n0 = p2.LAUNCHES
        got = p2.pow2_hist(vv, ww)
        assert p2.LAUNCHES == n0 + 1
        assert torch.equal(got, p2.pow2_hist_plain(vv, ww)), (vo, wo)


def test_pow2_hist_kernel_back_to_back_and_two_streams(cuda):
    """Calls in a row on one stream, and calls on two streams whose
    launches may overlap, each equal the plain version: every (device,
    stream) chains its own outputs, each launch zeroing the next one's."""
    v, w = _b2_buffers(1 << 20, "bool", cuda)
    outs = [p2.pow2_hist(v[:-16], w[:-16]) for _ in range(3)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    for s in streams:
        with torch.cuda.stream(s):
            outs += [p2.pow2_hist(v[:-16], w[:-16]) for _ in range(4)]
    torch.cuda.synchronize()
    want = p2.pow2_hist_plain(v[:-16], w[:-16])
    for got in outs:
        assert torch.equal(got, want)
    for s in (torch.cuda.current_stream(), *streams):
        assert not p2._NEXT[(v.device.index, s.cuda_stream)].any()


def test_pow2_hist_kernel_is_one_device_operation(cuda):
    """After a stream's first call (which zeroes its output), a call is
    the kernel alone: no fill, no memset, no copy. (The trace may miss
    some of the calls' kernels, never add an operation.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    v, w = _b2_buffers(1 << 16, "bool", cuda)
    p2.pow2_hist(v, w)
    torch.cuda.synchronize()
    calls = 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            p2.pow2_hist(v, w)
        torch.cuda.synchronize()
    dev = [e.name for e in prof.events() if e.device_type != DeviceType.CPU]
    assert 0 < len(dev) <= calls, dev
    assert all("pow2_hist_kernel" in x for x in dev), dev


@pytest.mark.parametrize("fuse", [None, False])
def test_two_shards_on_one_card_fold_like_run_sampled(fuse, cuda):
    """The host draw: any batch gives the same sample sets. Both sharded
    forms (None: the fused form, the default on CUDA) launch B1's raw
    form on the shards and B2 over the gathered pairs, one per ref row
    and chunk."""
    prog, m = REGISTRY["gemm"](64), T.MachineConfig()
    cfg = T.SamplerConfig(ratio=0.2, seed=0, device_draw=False,
                          fuse_refs=fuse)
    n0, n1 = p2.LAUNCHES, sh.LAUNCHES
    counters: dict = {}
    st_s, res = run_sampled_sharded(
        prog, m, cfg, build_mesh(devices=["cuda:0", "cuda:0"]), batch=512,
        counters=counters)
    assert p2.LAUNCHES > n0 and sh.LAUNCHES > n1
    assert ("dispatches_fused" in counters) == (fuse is None)
    st, _ = T.run_sampled(prog, m, cfg)
    st_c, res_c = run_sampled_sharded(prog, m, cfg, device="cpu")
    assert state_to_json(st_s) == state_to_json(st) == state_to_json(st_c)
    assert [dataclasses.asdict(r) for r in res] == [
        dataclasses.asdict(r) for r in res_c
    ]


@pytest.fixture
def cards(cuda):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    return n


# A fresh process touches cuda:0 only, reads telemetry.device_metrics, and
# asks the driver which cards hold a primary context.
_IDLE_CARDS = """
import ctypes, json, torch
from pluss_sampler_optimization_torch.runtime import telemetry
x = torch.zeros(1, device="cuda:0")
torch.cuda.synchronize()
metrics = telemetry.device_metrics()
cu = ctypes.CDLL("libcuda.so.1")
active = []
for i in range(torch.cuda.device_count()):
    dev, flags, on = ctypes.c_int(), ctypes.c_uint(), ctypes.c_int()
    assert cu.cuDeviceGet(ctypes.byref(dev), i) == 0
    assert cu.cuDevicePrimaryCtxGetState(dev, ctypes.byref(flags),
                                         ctypes.byref(on)) == 0
    active.append(on.value)
print(json.dumps({"metrics": metrics, "active": active}))
"""


def test_device_metrics_opens_no_context_on_idle_cards(cards):
    """device_metrics names every card and reads its allocator counters
    without creating a context on a card the process never used."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.join(os.path.dirname(__file__), "..")
    out = subprocess.run([sys.executable, "-c", _IDLE_CARDS], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["active"] == [1] + [0] * (cards - 1)
    m = got["metrics"]
    assert m["platform"] == "gpu" and m["device_count"] == cards
    assert [d["id"] for d in m["devices"]] == list(range(min(cards, 8)))
    assert m["devices"][0]["memory"]["bytes_in_use"] > 0
    assert all(d["memory"]["bytes_in_use"] == 0 for d in m["devices"][1:])


@pytest.mark.parametrize("fuse", [None, False])
@pytest.mark.parametrize("device_draw", [False, True])
def test_sharded_over_every_card_folds_like_run_sampled(device_draw, fuse,
                                                        cards):
    """One process, one shard per card, in either form: each card runs
    B1 on its own columns, and the reduction gathers onto cuda:0. The
    device draw runs on cuda:0 and each shard takes its columns on its
    own card; its sample sets depend on the batch, so every run here
    takes the same one, which the mesh divides."""
    prog, m = REGISTRY["gemm"](256), T.MachineConfig()
    cfg = T.SamplerConfig(ratio=0.2, seed=0, device_draw=device_draw,
                          fuse_refs=fuse)
    mesh, batch = build_mesh(), 1024 * cards
    assert mesh.size == cards
    n0, n1, b3 = p2.LAUNCHES, sh.LAUNCHES, td.LAUNCHES
    st_s, res = run_sampled_sharded(prog, m, cfg, mesh, batch=batch)
    assert p2.LAUNCHES > n0
    assert sh.LAUNCHES - n1 >= cards
    assert (td.LAUNCHES > b3) == device_draw
    st, _ = T.run_sampled(prog, m, cfg, batch=batch)
    _, res_1 = run_sampled_sharded(prog, m, cfg, build_mesh(1), batch=batch)
    assert state_to_json(st_s) == state_to_json(st)
    assert [dataclasses.asdict(r) for r in res] == [
        dataclasses.asdict(r) for r in res_1
    ]


def test_nccl_processes_match_the_single_process_engine(cards):
    """One process per card over NCCL (tests/_torch_dist.py): every rank
    prints run_sampled's state and the one-device sharded results."""
    outs = run_workers(cards, "cuda", n=64, timeout=600)
    assert outs[0]["mesh"] == [f"cuda:{i}" for i in range(cards)]
    check_workers(outs, "cuda", n=64)


def test_two_shards_on_one_card_device_draw(cuda):
    """The device draw at one batch: two shards, run_sampled and the CPU
    all draw the same sample sets. In the per-ref (scan) form B1
    launches once per shard per batch step of every ref's buffer and B2
    once per ref, and each ref is read back once."""
    prog, m = REGISTRY["gemm"](64), T.MachineConfig()
    cfg = T.SamplerConfig(ratio=0.2, seed=0, device_draw=True,
                          fuse_refs=False)
    mesh = build_mesh(devices=["cuda:0", "cuda:0"])
    n0, n1, n3 = p2.LAUNCHES, sh.LAUNCHES, td.LAUNCHES
    counters: dict = {}
    st_s, res = run_sampled_sharded(prog, m, cfg, mesh, batch=512,
                                    counters=counters)
    assert td.LAUNCHES > n3
    steps = 0
    trace, rows = S._program_rows(prog, m)
    for idx, (k, ri, _) in enumerate(rows):
        B = D.plan_draw(trace.nests[k], ri, cfg, 512)[0]
        steps += B // 512
    assert sh.LAUNCHES == n1 + 2 * steps
    assert p2.LAUNCHES == n0 + len(rows)
    assert counters["fetches"] == len(rows)
    fused, _ = run_sampled_sharded(
        prog, m, dataclasses.replace(cfg, fuse_refs=True), mesh, batch=512)
    assert state_to_json(fused) == state_to_json(st_s)
    st, _ = T.run_sampled(prog, m, cfg, batch=512)
    st_c, res_c = run_sampled_sharded(prog, m, cfg, device="cpu", batch=512)
    assert state_to_json(st_s) == state_to_json(st) == state_to_json(st_c)
    assert [dataclasses.asdict(r) for r in res] == [
        dataclasses.asdict(r) for r in res_c
    ]


def test_progressive_on_card_equals_cpu(cuda):
    """Progressive precision on the card (B1's raw form per chunk) gives
    the CPU's states, results, info and band widths, and launches B1 once
    per chunk."""
    prog, m = REGISTRY["gemm"](64), T.MachineConfig()
    cfg = T.SamplerConfig(ratio=0.2, seed=0, max_rounds=3)
    outs = []
    for device in ("cuda", "cpu"):
        bands: list = []
        counters: dict = {}
        n1 = sh.LAUNCHES
        st, res, info = S.run_sampled_progressive(
            prog, m, cfg, device=device, batch=512, counters=counters,
            on_round=lambda i, bands=bands: bands.append(i["band_width"]))
        assert sh.LAUNCHES - n1 == (counters["dispatches"]
                                    if device == "cuda" else 0)
        outs.append((state_to_json(st), [dataclasses.asdict(r) for r in res],
                     info, bands))
    assert outs[0] == outs[1]


def test_nccl_processes_device_draw(cards):
    """Every rank replays the device draw on its own card and keeps its
    rows; the results equal the single-process engines' at each batch."""
    from _torch_dist import DEVICE_DRAW, DEVICE_RUNS

    outs = run_workers(cards, "cuda", n=64, timeout=600, cfg=DEVICE_DRAW,
                       runs=DEVICE_RUNS)
    check_workers(outs, "cuda", n=64, cfg=DEVICE_DRAW, runs=DEVICE_RUNS)


# --- kernel B3: the device draw's threefry streams --------------------

# every remainder kind: powers of two (1, 2, 2^32, 2^46), spans above
# 2^32 (one block, a 32-bit reciprocal: GEMM-2048's depth-3 box
# 8,577,357,823) and below it (two blocks, three remainders: GEMM-2048's
# depth-2 box 4,190,209, syrk-tri N=1536's 2,356,225 and 3,616,805,375)
B3_SPANS = [1, 2, 3, (1 << 32) - 1, 1 << 32, (1 << 32) + 1, (1 << 45) - 1,
            8_577_357_823, 1 << 46, 4_190_209, 2_356_225, 3_616_805_375,
            1_000_000_007, (1 << 45) + 7]


def _b3_keys(R, seed):
    rng = np.random.default_rng(seed)
    return [tuple(int(x) for x in rng.integers(0, 1 << 32, size=2))
            for _ in range(R)]


@pytest.mark.parametrize("B", [1, 17, 1023, 1026, (1 << 14) + 3, 1 << 20])
def test_threefry_kernel_matches_plain(B, cuda):
    """Both entries, bit-equal to the plain versions for every span
    (span > 2^32 wraps randint's multiplier to 0), with and without the
    valid mask; one launch per call."""
    keys = _b3_keys(3, B)
    for span in B3_SPANS:
        n0 = td.LAUNCHES
        got = td.threefry_randint(keys, B, span, cuda)
        assert td.LAUNCHES == n0 + 1
        want = td.threefry_randint_plain(keys, B, span, cuda)
        torch.cuda.synchronize()
        assert torch.equal(got, want), span
        assert int(got.min()) >= 0 and int(got.max()) < span
    valid = torch.from_numpy(
        np.random.default_rng(B).random((3, B)) < 0.7).to(cuda)
    for v in (None, valid, valid.to(torch.uint8)):
        n0 = td.LAUNCHES
        got = td.threefry_bits(keys, B, cuda, v)
        assert td.LAUNCHES == n0 + 1
        assert torch.equal(got, td.threefry_bits_plain(keys, B, cuda, v))


def test_threefry_kernel_many_rows(cuda):
    """More rows than one launch holds: one launch per MAX_ROWS rows."""
    R = td.MAX_ROWS + 5
    keys = _b3_keys(R, 1)
    n0 = td.LAUNCHES
    got = td.threefry_randint(keys, 1000, 12345, cuda)
    valid = torch.ones((R, 1000), dtype=torch.bool, device=cuda)
    bits = td.threefry_bits(keys, 1000, cuda, valid)
    assert td.LAUNCHES == n0 + 4
    assert torch.equal(got, td.threefry_randint_plain(keys, 1000, 12345,
                                                      cuda))
    assert torch.equal(bits, td.threefry_bits_plain(keys, 1000, cuda))


def test_threefry_kernel_segments_and_misaligned_mask(cuda, monkeypatch):
    """Columns split into launches (SEGMENT made small: counters from a
    launch's own low word), and a mask row that starts off a 4-byte
    boundary (a view one row into a larger mask): equal to plain."""
    keys = _b3_keys(3, 7)
    B = 10_001
    monkeypatch.setattr(td, "SEGMENT", 1 << 12)
    for span in (12345, 8_577_357_823, 1 << 20):
        n0 = td.LAUNCHES
        got = td.threefry_randint(keys, B, span, cuda)
        assert td.LAUNCHES == n0 + 3
        assert torch.equal(got, td.threefry_randint_plain(keys, B, span,
                                                          cuda))
    monkeypatch.undo()
    rng = np.random.default_rng(3)
    big = torch.from_numpy(rng.random((4, 4099)) < 0.5).to(cuda)
    flat = torch.from_numpy(rng.random(3 * 2048 + 1) < 0.5).to(cuda)
    for v in (big[1:], big[:3], flat[1:].view(3, 2048)):
        B = v.shape[1]
        got = td.threefry_bits(keys, B, cuda, v)
        assert torch.equal(got, td.threefry_bits_plain(keys, B, cuda, v))


def test_threefry_kernel_refuses_a_wrong_record(cuda, monkeypatch):
    """A record that is not the span's is refused by the launcher: the
    entry raises, and nothing falls back to the plain version."""
    rec = td.remainder_record(12345)
    monkeypatch.setattr(td, "remainder_record",
                        lambda span: rec._replace(recip=rec.recip + 1))
    with pytest.raises(RuntimeError, match="launch failed"):
        td.threefry_randint(_b3_keys(1, 0), 64, 12345, cuda)


def test_threefry_kernel_rejects_what_it_does_not_take(cuda):
    keys = _b3_keys(2, 0)
    valid = torch.ones((2, 8), dtype=torch.bool, device=cuda)
    for bad in (valid.long(), valid[:, :4], valid.cpu(), valid[:1],
                torch.ones((2, 16), dtype=torch.bool,
                           device=cuda)[:, ::2]):
        with pytest.raises(ValueError):
            td.threefry_bits_cuda(keys, 8, cuda, bad)
    for args in ((keys, 8, 0), (keys, 8, (1 << 46) + 1), (keys, 0, 5),
                 ([(1 << 32, 0)], 8, 5), ([], 8, 5)):
        with pytest.raises(ValueError):
            td.threefry_randint_cuda(*args, cuda)
    with pytest.raises(ValueError, match="CUDA device"):
        td.threefry_randint_cuda(keys, 8, 5, "cpu")


@pytest.mark.parametrize("name", ["gemm", "2mm"])
def test_device_draw_on_card_equals_cpu(name, cuda):
    """Each bucket's draw on the card equals the CPU's: keys, chosen
    mask, s and highs; a bucket is one launch per stream."""
    cfg = T.SamplerConfig(ratio=0.2, seed=5)
    trace, rows = S._program_rows(REGISTRY[name](48), T.MachineConfig())
    for (k, _), members in S._bucket_rows(trace, rows).items():
        nt = trace.nests[k]
        args = (nt, [ri for _, ri in members], cfg,
                [cfg.seed * 1000003 + idx for idx, _ in members], 1 << 12)
        n0 = td.LAUNCHES
        got = D.draw_bucket_keys_device(*args)  # CUDA by default
        assert td.LAUNCHES == n0 + 2  # no member of these retries
        want = D.draw_bucket_keys_device(*args, "cpu")
        assert len(got) == len(want) == 1  # the bucket's one buffer
        g, w = got[0], want[0]
        assert g.keys.is_cuda and g.positions == w.positions
        assert torch.equal(g.keys.cpu(), w.keys)
        assert torch.equal(g.chosen.cpu(), w.chosen)
        assert (g.s, g.highs) == (w.s, w.highs)
        assert (g.chosen.sum(dim=1) == g.s).all()


def _row_bucket_inputs(progs, cfg, dev, rng):
    """Every union bucket of `progs` with rows from two or more programs:
    (nests, refs, keys, mask, radices, rx) of one per-row launch, each
    row its own member's draw padded with a masked tail."""
    plans = [S._program_rows(p, T.MachineConfig()) for p in progs]
    for members in S._bucket_rows_multi(plans).values():
        if len({j for j, *_ in members}) < 2:
            continue
        nts = [plans[j][0].nests[k] for j, _idx, k, _ri in members]
        ris = [ri for *_, ri in members]
        hs, ks = [], []
        for nt, (_j, idx, _k, ri) in zip(nts, members):
            highs, _ = S._sample_highs(nt, ri, cfg)
            hs.append(S._pad_highs(highs))
            ks.append(S.draw_sample_keys(nt, ri, cfg, seed=idx)[0])
        B = max(len(x) for x in ks) + 9
        keys = np.stack([np.concatenate([x, np.full(B - len(x), x[0])])
                         for x in ks])
        mask = rng.random(keys.shape) < 0.9
        for r, x in enumerate(ks):
            mask[r, len(x):] = False
        yield (nts, ris, torch.from_numpy(keys).to(dev),
               torch.from_numpy(mask).to(dev), hs,
               torch.tensor(ris, device=dev))


# triangular rows share a signature only where their base tables have
# one shape: trmm 40 and 46, syrk-tri 52 and 60 do
@pytest.mark.parametrize("models", [(("gemm", 48), ("gemm", 64), ("2mm", 40)),
                                    (("trmm", 40), ("trmm", 46)),
                                    (("syrk-tri", 52), ("syrk-tri", 60))])
def test_per_row_form_matches_plain_and_per_program_launches(models, cuda):
    """B1's per-row form (rows of different programs sharing a
    signature) equals its plain version and the same rows launched one
    program at a time, in both launch flags."""
    rng = np.random.default_rng(5)
    cfg = T.SamplerConfig(ratio=0.3, seed=4)
    progs = [REGISTRY[m](n) for m, n in models]
    n_launches = 0
    for nts, ris, keys, mask, hs, rx in _row_bucket_inputs(progs, cfg, cuda,
                                                           rng):
        for raw in (False, True):
            r0 = sh.ROWS_LAUNCHES
            got = sh.sampled_hist_rows(nts, ris, keys, mask, hs, rx, raw=raw)
            assert sh.ROWS_LAUNCHES == r0 + 1
            want = sh.sampled_hist_rows_plain(nts, ris, keys, mask, hs, rx,
                                              raw)
            per = [sh.sampled_hist_cuda(nts[r], ris[r], keys[r:r + 1],
                                        mask[r:r + 1], hs[r], rx[r:r + 1],
                                        raw=raw) for r in range(len(nts))]
            for i, (a, b) in enumerate(zip(got, want)):
                assert torch.equal(a, b)
                assert torch.equal(a, torch.cat([p[i] for p in per]))
            n_launches += 1
    assert n_launches


def test_threefry_span_per_row_matches_plain_and_solo_launches(cuda):
    """B3's randint with a span per row (every remainder kind mixed in
    one call) equals its plain version and each row's solo launch."""
    rng = np.random.default_rng(8)
    keys = [tuple(int(x) for x in rng.integers(0, 1 << 32, size=2))
            for _ in range(6)]
    spans = [1 << 20, 1000, (1 << 40) + 3, 7, 1 << 33, 4_190_209]
    for B in (1, 1023, 1 << 16):
        r0 = td.ROWS_LAUNCHES
        got = td.threefry_randint(keys, B, spans, cuda)
        assert td.ROWS_LAUNCHES == r0 + 3  # one launch per remainder kind
        assert torch.equal(got, td.threefry_randint_plain(keys, B, spans,
                                                          cuda))
        solo = torch.cat([td.threefry_randint([k], B, sp, cuda)
                          for k, sp in zip(keys, spans)])
        assert torch.equal(got, solo)


def test_run_sampled_multi_on_card_equals_solo(cuda):
    """A batch of mixed models and sizes on the card: each member equal
    to its solo run_sampled, through the per-row forms."""
    jobs = [(REGISTRY["gemm"](64), T.MachineConfig(),
             T.SamplerConfig(ratio=0.2, seed=0), False),
            (REGISTRY["gemm"](96), T.MachineConfig(),
             T.SamplerConfig(ratio=0.2, seed=1), False),
            (REGISTRY["2mm"](64), T.MachineConfig(),
             T.SamplerConfig(ratio=0.2, seed=0), True),
            (REGISTRY["trmm"](72), T.MachineConfig(),
             T.SamplerConfig(ratio=0.2, seed=2), False)]
    b1, b3 = sh.ROWS_LAUNCHES, td.ROWS_LAUNCHES
    outs = S.run_sampled_multi(jobs, capacity=2)
    assert sh.ROWS_LAUNCHES > b1 and td.ROWS_LAUNCHES > b3
    for (p, m, c, v2), (state, res) in zip(jobs, outs):
        st, r2 = S.run_sampled(p, m, c, v2=v2)
        assert state_to_json(state) == state_to_json(st)
        assert [(a.noshare, a.share, a.cold, a.n_samples) for a in res] == [
            (a.noshare, a.share, a.cold, a.n_samples) for a in r2]


def test_serve_on_card_raises_nothing(cuda, tmp_path):
    """The CLI's serve on the card: sampled (solo and in a batch window)
    and exact requests answer ok, and a repeat answers from the store."""
    import json

    from pluss_sampler_optimization_torch.cli import main

    reqs = tmp_path / "r.jsonl"
    reqs.write_text("".join(json.dumps(d) + "\n" for d in (
        {"id": "a", "model": "gemm", "n": 128, "engine": "sampled"},
        {"id": "b", "model": "syrk", "n": 96, "engine": "sampled",
         "seed": 1},
        {"id": "c", "model": "gemm", "n": 64, "engine": "exact"},
    )))
    for rnd in range(2):
        out = tmp_path / f"o{rnd}.jsonl"
        assert main(["serve", "--cache-dir", str(tmp_path / "s"),
                     "--batch-window-ms", "50", "--requests", str(reqs),
                     "--responses", str(out)]) == 0
        docs = [json.loads(x) for x in out.read_text().splitlines()]
        assert [d["ok"] for d in docs] == [True] * 3
        assert all(not d["degraded"] for d in docs)
        if rnd:
            assert {d["cache"] for d in docs} == {"disk"}
