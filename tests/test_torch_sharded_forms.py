"""The port's sharded scan and fused forms and their merges, against JAX.

- `merge_pair_sets` and the weighted `fixed_k_unique` equal the JAX
  package's on numpy-seeded inputs: one the JAX package resolves in its
  hash rounds, one where it falls back to its sort, and one over
  capacity;
- `dense_from_pairs` (the kernel route's pow2 histogram of merged
  noshare pairs) equals the JAX package's `exp_hist(max(ri, 1), ...)` on
  made pairs, reuse values below 1 included;
- the fused sharded form under the host draw equals the JAX package's
  `_sampled_outputs_sharded_fused` on 2- and 8-device CPU meshes (GEMM
  and syrk-tri): per-ref results, dense histograms, states and MRC
  bytes; the same with the kernel route's logic (kernel B1's plain raw
  form on the shards and the histogram from the gathered pairs);
- both forms under the device draw fold to the port's `run_sampled` at
  the same batch, with forced capacity regrows (2 slots), and read back
  once per ref (per-ref form) or per bucket group (fused form);
- the `sample` CLI's `--engine sharded --fuse-refs` lines equal the JAX
  CLI's.

Inputs are made from numpy seeds; every comparison is exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

import pluss_sampler_optimization_torch as T
import pluss_sampler_optimization_tpu as J
from pluss_sampler_optimization_torch.cli import main as t_main
from pluss_sampler_optimization_torch.models import REGISTRY as T_MODELS
from pluss_sampler_optimization_torch.ops import histogram as TH
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
from pluss_sampler_optimization_tpu.ops import histogram as JH
from pluss_sampler_optimization_tpu.parallel import (
    build_mesh as j_build_mesh,
    sampled_outputs_sharded as j_outputs_sharded,
)
from pluss_sampler_optimization_tpu.runtime.baseline import (
    state_to_json as j_state_json,
)
from pluss_sampler_optimization_tpu.sampler import sampled as JS

M = T.MachineConfig()


def _mrc(state):
    T_ = M.thread_num
    return t_aet.aet_mrc(t_cri.cri_distribute(state, T_, T_), M)


def _cpu_mesh(n):
    return build_mesh(devices=["cpu"] * n)


def _as_tuples(results):
    return [(r.name, r.noshare, r.share, r.cold, r.n_samples)
            for r in results]


# --- the merges ------------------------------------------------------


def _jax_hash_resolves(vals, valid, k, rounds):
    """Whether the JAX package's fixed_k_unique resolves every valid
    entry in its hash rounds (else its lax.cond takes the sort): its
    claiming rule, replayed with its own _round_hash."""
    h_slots = 1 << (max(1024, 4 * k) - 1).bit_length()
    remaining = valid.copy()
    for r in range(rounds):
        h = np.asarray(JH._round_hash(jnp.asarray(vals),
                                      r * 0x9E3779B97F4A7C15 + r, h_slots))
        tab = {}
        for slot, v in zip(h[remaining].tolist(), vals[remaining].tolist()):
            tab[slot] = max(tab.get(slot, v), v)
        won = remaining & np.array([tab.get(s) == v for s, v in
                                    zip(h.tolist(), vals.tolist())])
        remaining &= ~won
    return not remaining.any()


# (name, distinct keys, entries, k, JAX rounds, hash path resolves)
MERGE_CASES = {
    "hash": (12, 500, 64, 2, True),
    "fallback": (3000, 6000, 4096, 1, False),
    "overflow": (200, 2000, 64, 2, True),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_weighted_fixed_k_unique_matches_jax(case):
    n_distinct, n, k, rounds, resolves = MERGE_CASES[case]
    rng = np.random.default_rng(n_distinct + k)
    pool = rng.choice(1 << 40, size=n_distinct, replace=False) * 16 + 15
    vals = pool[rng.integers(0, n_distinct, size=n)]
    valid = rng.random(n) < 0.9
    w = rng.integers(1, 1 << 20, size=n)
    assert _jax_hash_resolves(vals, valid, k, rounds) == resolves
    want = JH.fixed_k_unique(jnp.asarray(vals), jnp.asarray(valid), k,
                             rounds=rounds, weights=jnp.asarray(w))
    got = TH.fixed_k_unique(torch.from_numpy(vals), torch.from_numpy(valid),
                            k, weights=torch.from_numpy(w))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got[2]) == len(np.unique(vals[valid]))
    assert (int(got[2]) > k) == (case == "overflow")


def _pair_set(rng, pool, n, cap):
    """A fixed-capacity pair set as a step's reduction leaves it: unique
    keys ascending, positive counts, empty slots -1/0."""
    keys = np.unique(rng.choice(pool, size=n))[:cap]
    out_k = np.full(cap, -1, dtype=np.int64)
    out_c = np.zeros(cap, dtype=np.int64)
    out_k[:len(keys)] = keys
    out_c[:len(keys)] = rng.integers(1, 1000, size=len(keys))
    return out_k, out_c


@pytest.mark.parametrize("n_pool,cap", [(10, 64), (60, 64), (300, 64),
                                        (5, 2), (4000, 1024)])
def test_merge_pair_sets_matches_jax(n_pool, cap):
    """Two pair sets drawn from one pool (shared keys add up), over
    capacity where the pool is larger, and a capacity whose JAX hash
    rounds take three rounds."""
    rng = np.random.default_rng(n_pool * 7 + cap)
    pool = rng.choice(1 << 36, size=n_pool, replace=False) * 16 + 15
    a = _pair_set(rng, pool, cap, cap)
    b = _pair_set(rng, pool, cap, cap)
    got = TH.merge_pair_sets(*(torch.from_numpy(x) for x in (*a, *b)), cap)
    want = JH.merge_pair_sets(*(jnp.asarray(x) for x in (*a, *b)), cap)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    both = np.concatenate([a[0][a[1] > 0], b[0][b[1] > 0]])
    assert int(got[2]) == len(np.unique(both))


def test_dense_from_pairs_matches_exp_hist():
    """The kernel route's histogram of gathered pairs [n_dev, R, cap]
    equals exp_hist(max(ri, 1)) over the noshare samples they count, a
    reuse of 0 or below in bin 0, share slots and empty slots left out."""
    rng = np.random.default_rng(3)
    n_dev, R, cap = 3, 2, 16
    ri = rng.integers(-5, 1 << 30, size=(n_dev, R, cap))
    ri[0, 0, :4] = [0, -1, 1, -(1 << 20)]
    slot = np.where(rng.random((n_dev, R, cap)) < 0.7, 15,
                    rng.integers(0, 15, size=(n_dev, R, cap)))
    slot[0, 0, :4] = 15
    keys = ri * 16 + slot
    counts = rng.integers(1, 50, size=(n_dev, R, cap))
    counts[1, 1, 10:] = 0
    keys[1, 1, 10:] = -1
    got = TSH.dense_from_pairs(torch.from_numpy(keys),
                               torch.from_numpy(counts))
    for j in range(R):
        w = np.where((slot[:, j] == 15) & (counts[:, j] > 0),
                     counts[:, j], 0).reshape(-1)
        want = JH.exp_hist(jnp.maximum(jnp.asarray(ri[:, j].reshape(-1)), 1),
                           jnp.asarray(w))
        np.testing.assert_array_equal(got[j].numpy(), np.asarray(want))
    assert int(got[0][0]) >= int(counts[0, 0, :4].sum())


# --- the fused form against the JAX package --------------------------

FUSED = [("gemm", (16,), 2), ("gemm", (16,), 8), ("syrk-tri", (12,), 2),
         ("syrk-tri", (12,), 8)]
_JAX_FUSED: dict = {}


# Host-draw chunks of 16 samples: each bucket's keys span several chunks
# (a chunk group of 4 or 8, padded with each row's first key) and the
# padded width stays small (at the CPU's default batch every row would be
# padded to 2^17 lanes).
FUSED_BATCH = 16


def _jax_fused(name, args, n_dev):
    """The JAX package's fused sharded run (host draw); one run per
    triangular model (its kernels compile per bucket for seconds)."""
    key = (name, args, n_dev if name == "gemm" else None)
    if key not in _JAX_FUSED:
        cfg = J.SamplerConfig(ratio=0.25, seed=3, fuse_refs=True,
                              device_draw=False)
        _JAX_FUSED[key] = j_outputs_sharded(
            J_MODELS[name](*args), J.MachineConfig(), cfg,
            mesh=j_build_mesh(n_dev if name == "gemm" else 8),
            batch=FUSED_BATCH)
    return _JAX_FUSED[key]


@pytest.mark.parametrize("name,args,n_dev", FUSED)
@pytest.mark.parametrize("route", ["plain", "kernel-logic"])
def test_fused_host_draw_matches_jax(name, args, n_dev, route, monkeypatch):
    """Per-ref results, dense histograms, states and MRC bytes equal the
    JAX package's fused form. "kernel-logic" takes the kernel route's
    code on the CPU: kernel B1's plain raw form per shard step and the
    histogram of the gathered noshare pairs."""
    if route == "kernel-logic":
        monkeypatch.setattr(TSH, "_kernel_route", lambda backend, mesh: True)
    cfg = T.SamplerConfig(ratio=0.25, seed=3, fuse_refs=True,
                          device_draw=False)
    counters: dict = {}
    tres, td = TSH.sampled_outputs_sharded(
        T_MODELS[name](*args), M, cfg, mesh=_cpu_mesh(n_dev),
        batch=FUSED_BATCH, counters=counters)
    jres, jd = _jax_fused(name, args, n_dev)
    assert _as_tuples(tres) == _as_tuples(jres)
    assert [list(map(int, a)) for a in jd] == [list(map(int, b))
                                                for b in td]
    assert counters["fuse_refs"] == 1
    assert counters["dispatches_fused"] == counters["fetches"] >= (
        counters["ref_buckets"])
    state = TS.fold_results(tres, M.thread_num)
    jstate = JS.fold_results(jres, J.MachineConfig().thread_num)
    assert t_state_json(state) == j_state_json(jstate)
    want, _ = T.run_sampled(T_MODELS[name](*args), M, cfg, device="cpu")
    assert _mrc(state).tobytes() == _mrc(want).tobytes()


# --- both forms under the device draw, regrows, read backs ------------


@pytest.mark.parametrize("name,args", [("gemm", (16,)), ("trmm", (12,)),
                                       ("covariance", (8, 6))])
@pytest.mark.parametrize("fuse", [False, True])
def test_device_draw_forms_match_run_sampled(name, args, fuse):
    """Both forms on 1, 2 and 8 shards at batch 64 (several steps per
    shard) with 2 pair slots (trmm regrows), and on 8 with the default
    64: equal results, folding to run_sampled's state and MRC bytes at
    the same batch. The per-ref form reads back once per ref
    and once more per regrow; the fused form once per bucket group."""
    prog = T_MODELS[name](*args)
    cfg = T.SamplerConfig(ratio=0.25, seed=3, device_draw=True,
                          fuse_refs=fuse)
    want, wres = T.run_sampled(prog, M, dataclasses.replace(cfg,
                                                            fuse_refs=True),
                               device="cpu", batch=64)
    first = None
    for n_dev, cap in ((1, 2), (2, 2), (8, 2), (8, 64)):
        counters: dict = {}
        spans: dict = {}
        res, dense = TSH.sampled_outputs_sharded(
            prog, M, cfg, mesh=_cpu_mesh(n_dev), batch=64, capacity=cap,
            counters=counters, spans=spans)
        regrows = counters.get("capacity_regrows", 0)
        assert counters["dispatches"] == counters["fetches"]
        if fuse:
            assert counters["fetches"] == (counters["dispatches_fused"]
                                           + regrows)
        else:
            assert counters["fetches"] == len(res) + regrows
        assert set(spans) <= {"draw", "shard_put", "dispatch_psum",
                              "gather_fetch", "merge"}
        if cap == 2 and name == "trmm":
            assert regrows > 0
        got = [dataclasses.asdict(r) for r in res]
        if first is None:
            first = (got, [list(map(int, d)) for d in dense])
        assert (got, [list(map(int, d)) for d in dense]) == first
    state = TS.fold_results(res, M.thread_num)
    assert t_state_json(state) == t_state_json(want)
    assert _mrc(state).tobytes() == _mrc(want).tobytes()
    assert [(r.name, r.n_samples, r.cold) for r in res] == [
        (r.name, r.n_samples, r.cold) for r in wres]


def test_fused_is_the_default_only_where_fuse_refs_resolves_on():
    """fuse_refs=None on a CPU mesh takes the per-ref form (no fused
    counters), True the fused one; both give equal results."""
    prog = T_MODELS["gemm"](12)
    outs = {}
    for fuse in (None, True):
        counters: dict = {}
        res, _ = TSH.sampled_outputs_sharded(
            prog, M, T.SamplerConfig(ratio=0.3, fuse_refs=fuse),
            mesh=_cpu_mesh(2), batch=64, counters=counters)
        assert ("dispatches_fused" in counters) == bool(fuse)
        outs[fuse] = [dataclasses.asdict(r) for r in res]
    assert outs[None] == outs[True]


@pytest.mark.parametrize("flags", [["--fuse-refs"],
                                   ["--fuse-refs", "--runtime", "v2",
                                    "--r10"]])
def test_sample_cli_sharded_forms_print_the_jax_lines(capsys, flags):
    args = ["sample", "--model", "gemm", "--n", "16", "--ratio", "0.3",
            "--engine", "sharded", *flags]
    assert j_main(args + ["--platform", "cpu"]) == 0
    want = capsys.readouterr().out
    assert t_main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert "ref B0" in got and "max iteration count" in got
