"""The port's telemetry (runtime/telemetry.py) and the engines' spans,
counters and gauges against the JAX package's, on the CPU.

Each engine family runs once on each side (gemm at N=8, the analytic
engine on syrk-tri(8) with its host fold cut off so that it classifies,
on the JAX side through its compiled path, the host draw throughout) under an enabled telemetry run; the span paths
(names along their nesting, each with its attribute keys) and the
counter and gauge names must be equal, but for the JAX-only names below.
The port's documents pass both packages' schema validators and dispatch
checks; results are bit-identical with telemetry off, on and
device-synced; the disabled path is pinned like the JAX package's.
"""

import dataclasses
import functools
import inspect
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

import pluss_sampler_optimization_torch as T
import pluss_sampler_optimization_tpu as J
from pluss_sampler_optimization_torch.models import REGISTRY as T_MODELS
from pluss_sampler_optimization_torch.runtime import telemetry as TT
from pluss_sampler_optimization_torch.sampler import sampled as TS
from pluss_sampler_optimization_torch.tools import (
    check_dispatch_stats as t_dispatch,
    check_telemetry_schema as t_schema,
)
from pluss_sampler_optimization_tpu.models import REGISTRY as J_MODELS
from pluss_sampler_optimization_tpu.runtime import telemetry as JT
from pluss_sampler_optimization_tpu.sampler import sampled as JS

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "tools"))
import check_dispatch_stats as j_dispatch  # noqa: E402
import check_telemetry_schema as j_schema  # noqa: E402

# Names only the JAX package emits, each with its reason; the batching
# counters of the JAX service (batches_formed, dispatches_batched,
# ref_buckets_union, ...) come with the service and no engine run here
# emits them.
JAX_ONLY = {
    "kernel_cache_hits": "the JAX engines' jit-kernel caches "
    "(counted_lru_cache, sampled.py's _kernel_cache); the port builds "
    "each CUDA library once per process and keeps no compiled-kernel cache",
    "kernel_cache_misses": "as kernel_cache_hits",
    "kernel_cache_evictions": "as kernel_cache_hits",
    "kernel_cache_size": "as kernel_cache_hits (a gauge)",
    "kernel_cache_maxsize": "as kernel_cache_hits (a gauge)",
    "eager_dispatches": "the JAX analytic engine's un-jitted path for "
    "chunk shapes it has not compiled; every port chunk is one launch",
}

N = 8
M_T, M_J = T.MachineConfig(), J.MachineConfig()


def _t_mesh(n):
    from pluss_sampler_optimization_torch.parallel import build_mesh

    return build_mesh(devices=["cpu"] * n)


def _j_mesh(n):
    from pluss_sampler_optimization_tpu.parallel import build_mesh

    return build_mesh(n)


def _t_cfg(**kw):
    return T.SamplerConfig(ratio=0.3, device_draw=False, **kw)


def _j_cfg(**kw):
    return J.SamplerConfig(ratio=0.3, device_draw=False, **kw)


def _t_sharded(fuse):
    from pluss_sampler_optimization_torch.parallel import run_sampled_sharded

    return run_sampled_sharded(T_MODELS["gemm"](N), M_T,
                               _t_cfg(fuse_refs=fuse), mesh=_t_mesh(8))


def _j_sharded(fuse):
    from pluss_sampler_optimization_tpu.parallel import run_sampled_sharded

    return run_sampled_sharded(J_MODELS["gemm"](N), M_J,
                               _j_cfg(fuse_refs=fuse), mesh=_j_mesh(8))


def _t_engine(name):
    from pluss_sampler_optimization_torch.sampler import (
        analytic,
        dense,
        periodic,
        stream,
    )

    return {
        "exact": lambda p: periodic.run_exact(p, M_T, device="cpu"),
        "analytic": lambda p: analytic.run_analytic(p, M_T, device="cpu",
                                                    host_cutoff=0),
        "dense": lambda p: dense.run_dense(p, M_T, device="cpu"),
        "stream": lambda p: stream.run_stream(p, M_T, device="cpu"),
    }[name]


def _j_analytic(p):
    """The JAX analytic engine's compiled classify (its path on an
    accelerator; on the CPU it runs tiny key sets op by op, a path with
    no fetch span)."""
    from pluss_sampler_optimization_tpu.sampler import analytic

    eager = analytic._take_eager_path
    analytic._take_eager_path = lambda *a: False
    try:
        return analytic.run_analytic(p, M_J, host_cutoff=0)
    finally:
        analytic._take_eager_path = eager


def _j_engine(name):
    from pluss_sampler_optimization_tpu.sampler import (
        dense,
        periodic,
        stream,
    )

    return {
        "exact": lambda p: periodic.run_exact(p, M_J),
        "analytic": _j_analytic,
        "dense": lambda p: dense.run_dense(p, M_J),
        "stream": lambda p: stream.run_stream(p, M_J),
    }[name]


# id -> (the port's run, the JAX package's run), each returning a state
CASES = {
    "sampled_serial": (
        lambda: T.run_sampled(T_MODELS["gemm"](N), M_T,
                              _t_cfg(fuse_refs=False), device="cpu")[0],
        lambda: JS.run_sampled(J_MODELS["gemm"](N), M_J,
                               _j_cfg(fuse_refs=False))[0],
    ),
    "sampled_fused": (
        lambda: T.run_sampled(T_MODELS["gemm"](N), M_T,
                              _t_cfg(fuse_refs=True), device="cpu")[0],
        lambda: JS.run_sampled(J_MODELS["gemm"](N), M_J,
                               _j_cfg(fuse_refs=True))[0],
    ),
    "sharded_per_ref": (lambda: _t_sharded(False)[0],
                        lambda: _j_sharded(False)[0]),
    "sharded_fused": (lambda: _t_sharded(True)[0],
                      lambda: _j_sharded(True)[0]),
    "progressive": (
        lambda: TS.run_sampled_progressive(
            T_MODELS["gemm"](N), M_T, _t_cfg(max_rounds=2),
            device="cpu")[0],
        lambda: JS.run_sampled_progressive(
            J_MODELS["gemm"](N), M_J, _j_cfg(max_rounds=2))[0],
    ),
    **{name: (lambda name=name, model=model: _t_engine(name)(
                  T_MODELS[model](N)).state,
              lambda name=name, model=model: _j_engine(name)(
                  J_MODELS[model](N)).state)
       for name, model in (("exact", "gemm"), ("analytic", "syrk-tri"),
                           ("dense", "gemm"), ("stream", "gemm"))},
}
FUSED = ("sampled_fused", "sharded_fused")


def _recorded(mod, fn) -> tuple:
    tele = mod.enable()
    try:
        state = fn()
    finally:
        mod.disable()
    return tele.to_json(), state


@functools.lru_cache(maxsize=None)
def _docs(case: str) -> tuple:
    """(port document, JAX document, port state, JAX state) of one case."""
    t_fn, j_fn = CASES[case]
    t_doc, t_state = _recorded(TT, t_fn)
    j_doc, j_state = _recorded(JT, j_fn)
    return t_doc, j_doc, t_state, j_state


def _span_paths(doc) -> set:
    """Every span as "parent[attr keys]/.../name[attr keys]"."""
    out = set()

    def walk(sp, prefix):
        path = f"{prefix}/{sp['name']}[{','.join(sorted(sp.get('attrs', {})))}]"
        out.add(path)
        for c in sp["children"]:
            walk(c, path)

    for root in doc["spans"]:
        walk(root, "")
    return out


def _names(doc, key) -> set:
    return set(doc[key]) - set(JAX_ONLY)


@pytest.mark.parametrize("case", sorted(CASES))
def test_span_counter_and_gauge_names_match_the_jax_package(case):
    t_doc, j_doc, t_state, j_state = _docs(case)
    assert _span_paths(t_doc) == _span_paths(j_doc)
    assert set(t_doc["counters"]) == _names(j_doc, "counters")
    assert set(t_doc["gauges"]) == _names(j_doc, "gauges")
    assert not set(t_doc["counters"]) & set(JAX_ONLY)
    # the same sample sets and exact engines: the same folded state
    for a, b in ((t_state.noshare, j_state.noshare),
                 (t_state.share, j_state.share)):
        assert a == b
    # the same dispatches, read backs and plan, where the forms agree
    for name in ("dispatches", "ref_buckets", "expected_chunks",
                 "progressive_rounds"):
        if case.startswith("sharded") and name == "dispatches":
            continue  # a JAX mesh step is one program; the port's per shard
        for key in ("counters", "gauges"):
            if name in j_doc[key]:
                assert t_doc[key][name] == j_doc[key][name], name


@pytest.mark.parametrize("case", sorted(CASES))
def test_documents_pass_both_schema_and_dispatch_checks(case):
    t_doc = _docs(case)[0]
    assert t_schema.validate(t_doc) == []
    assert j_schema.validate(t_doc) == []
    for checker in (t_dispatch, j_dispatch):
        error, note = checker.check(t_doc)
        assert error is None
        assert ("skipped" in note) == (case not in FUSED), note


@pytest.mark.parametrize("fuse", [False, True])
def test_results_bit_identical_off_on_and_synced(fuse):
    prog, cfg = T_MODELS["syrk-tri"](12), _t_cfg(fuse_refs=fuse)
    runs = []
    for sync in (None, False, True):
        if sync is not None:
            TT.enable(device_sync=sync)
        try:
            state, results = T.run_sampled(prog, M_T, cfg, device="cpu")
        finally:
            TT.disable()
        runs.append((state.noshare, state.share,
                     [dataclasses.asdict(r) for r in results]))
    assert runs[0] == runs[1] == runs[2]


def test_disabled_mode_is_noop_with_bounded_overhead():
    """As the JAX package's test: nothing records, span() hands back one
    shared no-op object, 200k no-op spans + counters in < 1 s; and the
    engines' own helpers (sampled._span / _count, which also fill the
    callers' dicts) stay within 4 s for 200k."""
    from pluss_sampler_optimization_torch.sampler.sampled import _count, _span

    assert TT.current() is None
    s1 = TT.span("x", attr=1)
    assert s1 is TT.span("y") is TT._NULL_SPAN
    with s1 as sp:
        assert sp.block("value") == "value"
    TT.count("nope")
    TT.record_fetch([1, 2])
    t0 = time.perf_counter()
    for _ in range(200_000):
        with TT.span("hot"):
            pass
        TT.count("c")
    dt = time.perf_counter() - t0
    assert dt < 1.0, f"disabled-path overhead too high: {dt:.3f}s"
    t0 = time.perf_counter()
    for _ in range(200_000):
        with _span(None, "hot"):
            pass
        _count(None, "c")
    dt = time.perf_counter() - t0
    assert dt < 4.0, f"disabled helper overhead too high: {dt:.3f}s"
    assert TT.current() is None


def test_public_api_and_verbatim_functions():
    public = ["enable", "disable", "current", "span", "count", "gauge",
              "event", "record_fetch", "counted_lru_cache", "warn_once",
              "set_metrics_sink", "set_record_sink", "span_paths_by_thread",
              "compile_counters_snapshot", "cpu_features_hash",
              "host_fingerprint", "read_cpu_throttle", "device_metrics"]
    for name in public:
        assert callable(getattr(TT, name)), name
    assert TT.SCHEMA_VERSION == JT.SCHEMA_VERSION
    for name in ("cpu_features_hash", "host_fingerprint",
                 "read_cpu_throttle", "span_paths_by_thread", "count",
                 "gauge", "event", "counted_lru_cache", "warn_once",
                 "span", "current", "set_metrics_sink", "set_record_sink"):
        assert (inspect.getsource(getattr(TT, name))
                == inspect.getsource(getattr(JT, name))), name
    for cls in ("Telemetry", "Span"):
        # summary_lines differs in its build line only (the output is
        # pinned line for line below)
        for meth in ("to_json", "to_dict", "find_spans", "_span", "event"):
            a = getattr(getattr(TT, cls), meth, None)
            if a is not None:
                assert (inspect.getsource(a) == inspect.getsource(
                    getattr(getattr(JT, cls), meth))), (cls, meth)
    assert set(JT.compile_counters_snapshot()) == set(
        TT.compile_counters_snapshot())


def _fixed(mod):
    """A stopped Telemetry of module `mod` with made spans, counters and
    an event, and no build or compile activity."""
    tele = mod.Telemetry()
    tele._jax_final = tele._jax_base
    tele._duration_s = 1.25
    root = mod.Span(tele, "engine", {"engine": "sampled"})
    root.wall_s = 1.0
    for name, wall in (("draw", 0.25), ("dispatch", 0.5), ("draw", 0.125)):
        child = mod.Span(tele, name, {})
        child.wall_s = wall
        root.children.append(child)
    tele.roots.append(root)
    tele._n_spans = 4
    tele.counters.update(dispatches=3, fetches=2)
    tele.events.append({"name": "kernel_backend", "t_s": 0.5,
                        "backend": "x"})
    return tele


def test_summary_lines_line_for_line():
    assert _fixed(TT).summary_lines() == _fixed(JT).summary_lines()


def test_builds_land_in_the_enabled_run_only():
    """A build on another thread lands in the run enabled at the time,
    not in one disabled before it; the compile counters count it."""
    before = TT.compile_counters_snapshot()
    old = TT.enable()
    TT.disable()
    tele = TT.enable()
    th = threading.Thread(target=TT.record_build, args=("made_lib", 0.5))
    th.start()
    th.join()
    TT.record_cache(hit=False)
    TT.disable()
    TT.record_build("made_lib", 0.25)  # after the run: in neither
    doc = tele.to_json()
    key = TT.BUILD_PREFIX + "made_lib"
    assert doc["jax_monitoring"]["events"][key] == 1
    assert doc["jax_monitoring"]["durations"][key] == {"total_s": 0.5,
                                                        "count": 1}
    assert key not in old.to_json()["jax_monitoring"]["events"]
    assert any("compiles: 1 backend compiles, 0.50s" in line
               for line in tele.summary_lines())
    now = TT.compile_counters_snapshot()
    assert now["backend_compiles"] - before["backend_compiles"] == 2
    assert now["cache_misses"] - before["cache_misses"] == 1
    assert now["compile_requests"] - before["compile_requests"] == 1
    assert j_schema.validate(doc) == []


def test_device_metrics_opens_no_context(monkeypatch):
    """On the CPU: platform "cpu". With a (faked) pair of cards: each
    card's name and allocator counters, and no call that would create a
    context on an idle card (mem_get_info)."""
    assert TT.device_metrics()["platform"] == "cpu"

    class Props:
        total_memory = 80 << 30

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i: f"card{i}")
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda i: 10 + i)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda i: 20 + i)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props())

    def no_context(*a, **k):
        raise AssertionError("mem_get_info creates a context")

    monkeypatch.setattr(torch.cuda, "mem_get_info", no_context)
    got = TT.device_metrics()
    assert got == {"platform": "gpu", "device_count": 2, "devices": [
        {"id": i, "kind": f"card{i}", "memory": {
            "bytes_in_use": 10 + i, "peak_bytes_in_use": 20 + i,
            "bytes_limit": 80 << 30}} for i in range(2)]}


def test_span_block_syncs_only_cuda_values(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)

    class FakeCuda:
        is_cuda = True
        device = "cuda:1"

    tele = TT.enable(device_sync=True)
    try:
        with TT.span("host") as sp:
            assert sp.block(torch.zeros(3)).shape == (3,)
        with TT.span("card") as sp:
            val = {"a": [np.zeros(1), (FakeCuda(),)]}
            assert sp.block(val) is val
    finally:
        TT.disable()
    assert calls == ["cuda:1"]
    assert all(s.sync_s is not None for s in tele.roots)
    tele = TT.enable()
    try:
        with TT.span("nosync") as sp:
            sp.block(FakeCuda())
    finally:
        TT.disable()
    assert calls == ["cuda:1"] and tele.roots[0].sync_s is None
