"""The hand-written CUDA kernel against its plain torch version, on the card.

Marked `gpu`: every test skips where torch sees no CUDA device (decided
inside the `cuda` fixture, never at import). On a machine with a card:

    python -m pytest tests/test_torch_kernels.py -q -p no:cacheprovider --noconftest

(`--noconftest` because tests/conftest.py sets up JAX, which this file
does not use.) Every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import pluss_sampler_optimization_torch as T
from pluss_sampler_optimization_torch.models import REGISTRY
from pluss_sampler_optimization_torch.ops import sampled_hist as sh
from pluss_sampler_optimization_torch.runtime.baseline import state_to_json
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
    prog, m = REGISTRY[name](64), T.MachineConfig()
    cfg = T.SamplerConfig(ratio=0.2, seed=0)
    n0 = sh.LAUNCHES
    st_k, res_k = T.run_sampled(prog, m, cfg)
    assert sh.LAUNCHES > n0
    st_t, res_t = T.run_sampled(
        prog, m, dataclasses.replace(cfg, kernel_backend="torch"))
    st_c, _ = T.run_sampled(prog, m, cfg, device="cpu")
    assert state_to_json(st_k) == state_to_json(st_t) == state_to_json(st_c)
    assert [dataclasses.asdict(r) for r in res_k] == [
        dataclasses.asdict(r) for r in res_t
    ]
