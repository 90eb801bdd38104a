"""The port's device draw (sampler/draw.py) against the JAX package's (exact).

- the constants, `bucket_size` and `plan_draw` are the JAX package's;
- `draw_sample_keys_device` on the CPU (the plain threefry streams)
  returns the JAX package's sorted keys, `chosen` mask, s and highs for
  every rectangular ref of gemm, 2mm and mvt, and, at the draw level,
  for the triangular refs of trmm and syrk-tri, over several seeds and
  batches (one at the card's 2^20);
- the bucket draw's rows equal the per-ref draws, and the JAX package's
  bucket draw;
- with a buffer too small for s, both packages' draw bodies give the
  same U, n_chosen and sorted keys, and the retry loop grows the buffer
  to the same B and the same sample set.

Inputs are the packages' own draws from the same seeds; every
comparison is exact. The JAX side runs on the CPU as its own tests do.
"""

import numpy as np
import pytest
import torch

import pluss_sampler_optimization_torch as T
import pluss_sampler_optimization_tpu as J
from pluss_sampler_optimization_torch.core.trace import ProgramTrace
from pluss_sampler_optimization_torch.models import REGISTRY as T_MODELS
from pluss_sampler_optimization_torch.sampler import draw as TD
from pluss_sampler_optimization_torch.sampler import sampled as TS
from pluss_sampler_optimization_tpu.core.trace import (
    ProgramTrace as JTrace,
)
from pluss_sampler_optimization_tpu.models import REGISTRY as J_MODELS
from pluss_sampler_optimization_tpu.sampler import draw as JD


def _traces(name, n):
    return (JTrace(J_MODELS[name](n), J.MachineConfig()),
            ProgramTrace(T_MODELS[name](n), T.MachineConfig()))


def _cfgs(ratio, seed):
    return (J.SamplerConfig(ratio=ratio, seed=seed, device_draw=True),
            T.SamplerConfig(ratio=ratio, seed=seed, device_draw=True))


def _same_draw(j, t):
    """A JAX draw (device arrays) and a port draw (tensors) agree."""
    assert (j is None) == (t is None)
    if j is None:
        return
    np.testing.assert_array_equal(np.asarray(j[0]), t[0].numpy())
    np.testing.assert_array_equal(np.asarray(j[1]), t[1].numpy())
    assert j[2] == t[2] and tuple(j[3]) == tuple(t[3])
    assert int(t[1].sum()) == t[2]


def test_constants_and_plan_are_the_jax_packages():
    assert TD.DEVICE_DRAW_MAX_SLOTS == JD.DEVICE_DRAW_MAX_SLOTS == 1 << 28
    assert TD._SENT == JD._SENT == np.iinfo(np.int64).max
    assert TD._DEVICE_DRAW_MAX_SPACE == JD._DEVICE_DRAW_MAX_SPACE == 1 << 46
    for m in (0, 1, 63, 64, 65, 1000, 4097, 123456, 1 << 20, 3 << 20):
        for batch in (1, 40, 512, 1 << 17, 1 << 20):
            assert TD.bucket_size(m, batch) == JD.bucket_size(m, batch)
    for name in sorted(T_MODELS):
        jt, tt = _traces(name, 16)
        jc, tc = _cfgs(0.2, 0)
        for jnt, tnt in zip(jt.nests, tt.nests):
            for ri in range(jnt.tables.n_refs):
                for batch in (64, 1 << 20):
                    assert (TD.plan_draw(tnt, ri, tc, batch)
                            == JD.plan_draw(jnt, ri, jc, batch))


@pytest.mark.parametrize("name,n,seed,batch", [
    ("gemm", 16, 0, 256), ("gemm", 24, 5, 1 << 20), ("2mm", 12, 3, 256),
    ("mvt", 24, 1, 128),
])
def test_rect_draw_matches_jax(name, n, seed, batch):
    jt, tt = _traces(name, n)
    jc, tc = _cfgs(0.3, seed)
    for k, (jnt, tnt) in enumerate(zip(jt.nests, tt.nests)):
        for ri in range(jnt.tables.n_refs):
            sd = seed * 1000003 + 10 * k + ri
            _same_draw(
                JD.draw_sample_keys_device(jnt, ri, jc, sd, batch),
                TD.draw_sample_keys_device(tnt, ri, tc, sd, batch, "cpu"))


def test_draw_steps_are_profiler_ranges():
    """Each step of a rectangular draw runs inside its named profiler
    range (draw.STEPS), which a trace of the draw breaks its time down
    by; the draw under the profiler is the draw without it."""
    from torch.profiler import ProfilerActivity, profile

    _, tt = _traces("gemm", 16)
    _, tc = _cfgs(0.3, 0)
    nt = tt.nests[0]
    want = TD.draw_sample_keys_device(nt, 0, tc, 5, 256, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = TD.draw_sample_keys_device(nt, 0, tc, 5, 256, "cpu")
    assert set(TD.STEPS) <= {e.name for e in prof.events()}
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("name,n", [("trmm", 16), ("syrk-tri", 12)])
def test_tri_draw_matches_jax(name, n):
    """Box draw with rejection: out-of-bounds candidates become _SENT,
    which sorts last and is never chosen."""
    jt, tt = _traces(name, n)
    jc, tc = _cfgs(0.4, 2)
    n_rejected = 0
    for jnt, tnt in zip(jt.nests, tt.nests):
        for ri in range(jnt.tables.n_refs):
            for sd in (0, 7):
                j = JD.draw_sample_keys_device(jnt, ri, jc, sd, 128)
                t = TD.draw_sample_keys_device(tnt, ri, tc, sd, 128, "cpu")
                _same_draw(j, t)
                n_rejected += int((t[0] == TD._SENT).sum())
                assert not bool((t[0][t[1]] == TD._SENT).any())
    assert n_rejected > 0


def test_bucket_draw_matches_per_ref_and_jax():
    """Every member row of a multi-ref bucket's one draw equals its
    per-ref draw, and the JAX package's bucket draw."""
    jt, tt = _traces("gemm", 32)
    jc, tc = _cfgs(0.3, 7)
    nt = tt.nests[0]
    by_sig = {}
    for ri in range(nt.tables.n_refs):
        by_sig.setdefault(TS._kernel_sig(nt, ri), []).append(ri)
    buckets = [m for m in by_sig.values() if len(m) >= 2]
    assert buckets
    batch = 1 << 12
    for members in buckets:
        seeds = [tc.seed * 1000003 + ri for ri in members]
        got = TD.draw_bucket_keys_device(nt, members, tc, seeds, batch,
                                         "cpu")
        want = JD.draw_bucket_keys_device(jt.nests[0], members, jc, seeds,
                                          batch)
        # every member certified at the first attempt: one group, the
        # bucket's whole [R, B] buffer, which the engine dispatches
        (g,) = got
        assert g.positions == list(range(len(members)))
        assert g.keys.shape == (len(members), want[0][0].shape[0])
        for j, (ri, sd, w) in enumerate(zip(members, seeds, want)):
            row = (g.keys[j], g.chosen[j], g.s, g.highs)
            _same_draw(w, row)
            ref = TD.draw_sample_keys_device(nt, ri, tc, sd, batch, "cpu")
            assert torch.equal(row[0], ref[0]) and torch.equal(row[1], ref[1])


def _tight_plans(monkeypatch):
    """Plan every draw at a buffer of s + 2 slots in both packages, so a
    bucket's first attempt certifies some members and not others."""
    for mod in (JD, TD):
        def tight(nt, ri, cfg, batch, plan=mod.plan_draw):
            p = plan(nt, ri, cfg, batch)
            return None if p is None else (p[2] + 2, *p[1:])

        monkeypatch.setattr(mod, "plan_draw", tight)


def test_bucket_draw_replays_uncertified_members_like_jax(monkeypatch):
    """A member the bucket's first attempt leaves short replays its own
    retry into a group of its own with its grown buffer; certified
    members stay slices of the bucket's buffer; every row equals the JAX
    package's bucket draw and the port's per-ref draw."""
    _tight_plans(monkeypatch)
    replayed = sliced = 0
    for name, seed in (("gemm", 0), ("2mm", 0), ("2mm", 4)):
        jt, tt = _traces(name, 16)
        jc, tc = _cfgs(0.3, seed)
        trace, rows = TS._program_rows(T_MODELS[name](16), T.MachineConfig())
        for (k, _), members in TS._bucket_rows(trace, rows).items():
            ris = [ri for _, ri in members]
            seeds = [tc.seed * 1000003 + idx for idx, _ in members]
            nt = trace.nests[k]
            got = TD.draw_bucket_keys_device(nt, ris, tc, seeds, 8, "cpu")
            want = JD.draw_bucket_keys_device(jt.nests[k], ris, jc, seeds, 8)
            assert sorted(p for g in got for p in g.positions) == list(
                range(len(ris)))
            s = TD.plan_draw(nt, ris[0], tc, 8)[2]
            for g in got:
                certified = g.keys.shape[1] == s + 2
                replayed += not certified
                sliced += certified and len(ris) > 1
                assert certified or len(g.positions) == 1
                for j, p in enumerate(g.positions):
                    row = (g.keys[j], g.chosen[j], g.s, g.highs)
                    _same_draw(want[p], row)
                    ref = TD.draw_sample_keys_device(nt, ris[p], tc,
                                                     seeds[p], 8, "cpu")
                    assert torch.equal(row[0], ref[0])
    assert replayed and sliced


def test_draw_device_defaults_to_cuda():
    """With no device the draws run on CUDA, as every entry point of the
    port does: without a card they raise instead of drawing on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    nt = _traces("gemm", 16)[1].nests[0]
    cfg = _cfgs(0.3, 0)[1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.draw_sample_keys_device(nt, 0, cfg, 0, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.draw_bucket_keys_device(nt, [0, 1], cfg, [0, 1], 8)


def test_short_buffer_and_retry_match_jax(monkeypatch):
    """A buffer too small for s: the draw bodies agree on U, n_chosen and
    the keys; the retry loops (a planned B of one batch where s needs
    more) grow to the same B and draw the same set."""
    import jax.numpy as jnp

    from pluss_sampler_optimization_torch.sampler import threefry

    base = TD._draw_base_key(11)
    jbase = JD._draw_base_key(11)
    space, s, B = 5000, 3000, 2048
    jsk, jch, jU, jn = JD._rect_draw_body(jbase, jnp.int64(space),
                                          jnp.int64(s), B)
    tsk, tch, tU, tn = TD._rect_draw_body([base], space, s, B, "cpu")
    assert int(jU) == int(tU[0]) < s and int(jn) == int(tn[0])
    np.testing.assert_array_equal(np.asarray(jsk), tsk[0].numpy())
    np.testing.assert_array_equal(np.asarray(jch), tch[0].numpy())
    assert threefry.fold_in(base, 0) != base  # attempts fold distinct keys

    jt, tt = _traces("gemm", 24)
    jc, tc = _cfgs(0.3, 4)
    batch = 64
    for mod, nt, cfg in ((JD, jt.nests[0], jc), (TD, tt.nests[0], tc)):
        plan = mod.plan_draw

        def short(nt, ri, cfg, batch, plan=plan):
            p = plan(nt, ri, cfg, batch)
            return None if p is None else (batch, *p[1:])

        monkeypatch.setattr(mod, "plan_draw", short)
    grown = 0
    for ri in range(tt.nests[0].tables.n_refs):
        j = JD.draw_sample_keys_device(jt.nests[0], ri, jc, 3, batch)
        t = TD.draw_sample_keys_device(tt.nests[0], ri, tc, 3, batch, "cpu")
        _same_draw(j, t)
        grown += t[0].shape[0] > batch
    assert grown >= 4  # the depth-3 refs retried with larger buffers
