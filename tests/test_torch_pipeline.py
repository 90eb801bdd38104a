"""The sampled engine's runners, pipeline and checkpoints (port vs itself).

The contracts of the JAX package's tests/test_fusion.py (resume in a
bucket, the depth knob) and tests/test_sampled.py (checkpoints), on the
CPU with the host draw: pipeline depths 1 and 4, the bucket runner and
the serial runner, and a resumed run give equal per-ref results; a raw
run never loads a binned file; a foreign or corrupt file recomputes; a
checkpoint directory the JAX package wrote resumes here with the same
folded state.
"""

import dataclasses
import json

import pytest
from _torch_threads import one_torch_thread  # noqa: F401

import pluss_sampler_optimization_torch as T
import pluss_sampler_optimization_tpu as J
from pluss_sampler_optimization_torch.models import REGISTRY as T_MODELS
from pluss_sampler_optimization_torch.runtime.baseline import (
    state_to_json as t_state_json,
)
from pluss_sampler_optimization_torch.sampler import sampled as TS
from pluss_sampler_optimization_tpu.models import REGISTRY as J_MODELS
from pluss_sampler_optimization_tpu.runtime.baseline import (
    state_to_json as j_state_json,
)
from pluss_sampler_optimization_tpu.sampler import sampled as JS

BASE = T.SamplerConfig(ratio=0.3, seed=0)
M = T.MachineConfig()


def _run(prog, cfg, **kw):
    counters: dict = {}
    res = TS.sampled_outputs(prog, M, cfg, device="cpu", counters=counters,
                             **kw)
    return [dataclasses.asdict(r) for r in res], counters


def test_auto_resolves_as_the_jax_package():
    assert TS._use_fused(BASE, "cuda") and not TS._use_fused(BASE, "cpu")
    for dev in ("cpu", "cuda"):
        assert TS._use_fused(dataclasses.replace(BASE, fuse_refs=True), dev)
        assert not TS._use_fused(dataclasses.replace(BASE, fuse_refs=False),
                                 dev)


@pytest.mark.parametrize("raw", [False, True])
def test_depths_and_runners_give_equal_results(raw):
    """Depth 1 stalls after every dispatch, depth 4 less; the serial
    runner (one ref per dispatch) at depth 1 and 4 and the bucket runner
    give the same results, also with several dispatches per ref and
    capacity regrows (batch 64, capacity 0)."""
    prog = T_MODELS["gemm"](16)
    runs = {}
    for fuse in (True, False):
        for depth in (1, 4):
            cfg = dataclasses.replace(BASE, fuse_refs=fuse,
                                      pipeline_depth=depth)
            runs[fuse, depth] = _run(prog, cfg, batch=64, capacity=0,
                                     raw_noshare=raw)
    want = runs[True, 4][0]
    assert all(r == want for r, _ in runs.values())
    # the serial runner drains a ref's dispatches before the next ref
    # draws (the JAX package's serial runner): 3 of each ref's dispatches
    # fly without a stall; the bucket runner's pipeline spans buckets
    per_ref = [TS._host_fuse_plan(r["n_samples"], 64)[1] for r in want]
    stalls4 = {True: runs[True, 4][1]["dispatches"] - 3,
               False: sum(max(0, d - 3) for d in per_ref)}
    assert sum(per_ref) == runs[False, 4][1]["dispatches"]
    for fuse in (True, False):
        c1, c4 = runs[fuse, 1][1], runs[fuse, 4][1]
        assert c1["pipeline_stalls"] == c1["dispatches"] > 3
        assert c4.get("pipeline_stalls", 0) == stalls4[fuse]
        assert (c1["pipeline_depth"], c4["pipeline_depth"]) == (1, 4)
        assert c1["capacity_regrows"] >= 1
    assert runs[False, 4][1]["refs_per_dispatch"] == 1
    assert runs[True, 4][1]["refs_per_dispatch"] > 1
    assert runs[True, 4][1]["ref_buckets"] == 4
    assert runs[False, 4][1]["ref_buckets"] == 6


def test_resume_masks_checkpointed_members(tmp_path):
    """A bucket whose other member is checkpointed dispatches the
    de-checkpointed one alone; the resumed run equals the uninterrupted
    one; a fully checkpointed rerun draws and dispatches nothing."""
    ck = str(tmp_path / "ck")
    prog = T_MODELS["gemm"](16)
    cfg = dataclasses.replace(BASE, fuse_refs=True)
    full, _ = _run(prog, cfg, checkpoint_dir=ck)
    assert len(list((tmp_path / "ck").glob("ref_*.json"))) == 6
    (tmp_path / "ck" / "ref_001.json").unlink()  # C1 of {C0, C1}
    got, c = _run(prog, cfg, checkpoint_dir=ck)
    assert got == full
    assert c["ref_buckets"] == 1 and c["refs_per_dispatch"] == 1

    def boom(*a, **k):
        raise AssertionError("a resumed run must not draw a finished ref")

    orig, TS.draw_sample_keys = TS.draw_sample_keys, boom
    try:
        again, c = _run(prog, cfg, checkpoint_dir=ck)
    finally:
        TS.draw_sample_keys = orig
    assert again == full
    assert c.get("dispatches", 0) == 0 and c.get("ref_buckets", 0) == 0
    serial, _ = _run(prog, dataclasses.replace(BASE, fuse_refs=False),
                     checkpoint_dir=ck)
    assert serial == full


def test_raw_and_binned_runs_never_share_files(tmp_path):
    """A raw run (v2, r10) never loads a binned run's file, nor the
    reverse: each recomputes and keeps its own route's keys."""
    ck = str(tmp_path / "ck")
    prog = T_MODELS["gemm"](16)
    binned, _ = _run(prog, BASE)
    raw, _ = _run(prog, BASE, raw_noshare=True)
    assert binned != raw  # the binned route keeps pow2 bins

    def tags():
        return [json.loads(p.read_text())["tag"]
                for p in (tmp_path / "ck").glob("ref_*.json")]

    assert _run(prog, BASE, checkpoint_dir=ck)[0] == binned
    assert not any(t.endswith("|raw") for t in tags())
    assert _run(prog, BASE, checkpoint_dir=ck, raw_noshare=True)[0] == raw
    assert len(tags()) == 6 and all(t.endswith("|raw") for t in tags())
    assert _run(prog, BASE, checkpoint_dir=ck)[0] == binned
    assert not any(t.endswith("|raw") for t in tags())


def test_foreign_corrupt_and_stale_files_recompute(tmp_path):
    ck = tmp_path / "ck"
    ck.mkdir()
    (ck / "ref_000.json").write_text("[]")  # valid JSON, wrong shape
    (ck / "ref_001.json").write_text("{not json")
    prog = T_MODELS["gemm"](16)
    want, _ = _run(prog, BASE)
    assert _run(prog, BASE, checkpoint_dir=str(ck))[0] == want
    # another sampler config's tag: recomputed, not reused
    other = dataclasses.replace(BASE, ratio=0.5)
    got, _ = _run(prog, other, checkpoint_dir=str(ck))
    assert sum(r["n_samples"] for r in got) > sum(
        r["n_samples"] for r in want)
    # the same name with another structure (gemm's r10 threshold)
    r10 = T_MODELS["gemm"](16, share_threshold_variant="r10")
    got, _ = _run(r10, other, checkpoint_dir=str(ck))
    assert got == _run(r10, other)[0]


def test_jax_checkpoint_dir_resumes_with_equal_state(tmp_path):
    """Files the JAX package wrote (its xla results, raw noshare keys)
    load in the port's default run, which then draws nothing, and fold to
    the JAX package's state bytes."""
    ck = str(tmp_path / "ck")
    js, _ = JS.run_sampled(J_MODELS["gemm"](16), J.MachineConfig(),
                           J.SamplerConfig(ratio=0.3, seed=0),
                           checkpoint_dir=ck)

    def boom(*a, **k):
        raise AssertionError("every ref should load from the JAX files")

    orig, TS.draw_sample_keys = TS.draw_sample_keys, boom
    try:
        ts, _ = T.run_sampled(T_MODELS["gemm"](16), M, BASE, device="cpu",
                              checkpoint_dir=ck)
    finally:
        TS.draw_sample_keys = orig
    assert t_state_json(ts) == j_state_json(js)


def test_warmup_on_the_cpu_does_nothing():
    assert TS.warmup(T_MODELS["gemm"](16), M, BASE, device="cpu") is None
