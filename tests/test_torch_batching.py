"""Cross-request batching in the port against each member's solo run and
against the JAX package, on the CPU.

run_sampled_multi folds every member to its solo run_sampled's results,
field for field (mixed models, sizes, machines and draws, a v2 member,
a capacity regrow), and on the host draw to the JAX package's
run_sampled_multi state; the union buckets are the JAX package's. The
per-row forms: kernel B1's per-row host twin (its CUDA source built with
g++) equals its plain version and the same rows through the
per-program twin, and B3's span-per-row twin equals each row's solo
span. The service's batch window answers as the JAX service's.
"""

import ctypes
import io
import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import pluss_sampler_optimization_torch as T
import pluss_sampler_optimization_tpu as J
from pluss_sampler_optimization_torch import service as TS
from pluss_sampler_optimization_torch.models import REGISTRY as T_MODELS
from pluss_sampler_optimization_torch.ops import sampled_hist as sh
from pluss_sampler_optimization_torch.ops import threefry_draw as td
from pluss_sampler_optimization_torch.runtime.baseline import (
    state_to_json as t_state_json,
)
from pluss_sampler_optimization_torch.sampler import draw as TD
from pluss_sampler_optimization_torch.sampler import sampled as TSA
from pluss_sampler_optimization_tpu import service as JS
from pluss_sampler_optimization_tpu.models import REGISTRY as J_MODELS
from pluss_sampler_optimization_tpu.runtime.baseline import (
    state_to_json as j_state_json,
)
from pluss_sampler_optimization_tpu.sampler import sampled as JSA

CSRC = os.path.join(os.path.dirname(__file__), "..",
                    "pluss_sampler_optimization_torch", "csrc")
MC = T.MachineConfig

@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch intra-op thread while this file's services run: their
    pool threads each run small torch ops at once, and a team of
    intra-op threads per op only spins against the other test workers'
    processes (a run of this file beside another took 130 s where it
    alone takes 25)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (model, size, seed, device_draw, v2, machine)
JOBS = {
    "host": [("gemm", 12, 1, False, False, MC()),
             ("gemm", 16, 2, False, False, MC()),
             ("2mm", 12, 1, False, True, MC()),
             ("trmm", 12, 3, False, False, MC()),
             ("syrk", 10, 0, False, False, MC(thread_num=3, chunk_size=2)),
             ("syrk-tri", 12, 4, False, False, MC())],
    "device": [("gemm", 12, 1, True, False, MC()),
               ("gemm", 14, 5, True, False, MC()),
               ("syrk-tri", 12, 5, True, False, MC()),
               ("gemm", 12, 1, False, False, MC()),
               ("trmm", 10, 2, True, True, MC())],
}
# the JAX package's batch (its compiles: two sizes of one signature set)
JAX_JOBS = [("gemm", 8, 0), ("gemm", 10, 1)]


def _jobs(spec):
    return [(T_MODELS[m](n), mach,
             T.SamplerConfig(ratio=0.3, seed=s, device_draw=dd), v2)
            for m, n, s, dd, v2, mach in spec]


def _fields(results):
    return [(r.name, r.noshare, r.share, r.cold, r.n_samples)
            for r in results]


@pytest.mark.parametrize("kind,capacity", [("host", 64), ("device", 64),
                                           ("host", 1)])
def test_run_sampled_multi_equals_each_solo_run(kind, capacity):
    jobs = _jobs(JOBS[kind])
    counters: dict = {}
    outs = TSA.run_sampled_multi(jobs, batch=1 << 12, capacity=capacity,
                                 device="cpu", counters=counters)
    assert counters["dispatches_batched"] == counters["dispatches"] > 0
    assert counters["batch_jobs"] == len(jobs)
    if capacity == 1:
        assert counters["capacity_regrows"] >= 1
    for (p, m, c, v2), (state, res) in zip(jobs, outs):
        st, solo = TSA.run_sampled(p, m, c, v2=v2, device="cpu",
                                   batch=1 << 12)
        assert _fields(res) == _fields(solo)
        assert t_state_json(state) == t_state_json(st)


def test_run_sampled_multi_equals_the_jax_packages_on_the_host_draw():
    t_jobs = [(T_MODELS[m](n), T.MachineConfig(),
               T.SamplerConfig(ratio=0.3, seed=s, device_draw=False), False)
              for m, n, s in JAX_JOBS]
    j_jobs = [(J_MODELS[m](n), J.MachineConfig(),
               J.SamplerConfig(ratio=0.3, seed=s, device_draw=False), False)
              for m, n, s in JAX_JOBS]
    for (ts, _), (js, _) in zip(TSA.run_sampled_multi(t_jobs, device="cpu"),
                                JSA.run_sampled_multi(j_jobs)):
        assert t_state_json(ts) == j_state_json(js)


def test_union_buckets_are_the_jax_packages():
    progs = [("gemm", 12), ("2mm", 10), ("syrk", 9), ("trmm", 11),
             ("gemm", 16)]
    t_plans = [TSA._program_rows(T_MODELS[m](n), T.MachineConfig())
               for m, n in progs]
    j_plans = [JSA._program_kernels(J_MODELS[m](n), J.MachineConfig())
               for m, n in progs]
    assert (list(TSA._bucket_rows_multi(t_plans).items())
            == list(JSA._bucket_rows_multi(j_plans).items()))


def test_device_draw_multi_equals_each_members_own_draw():
    """draw_bucket_keys_device_multi (B3's plain streams here, one span
    per row) gives each member its draw_sample_keys_device rows."""
    entries = []
    for m, n, seed, _dd, _v2, mach in JOBS["device"]:
        cfg = T.SamplerConfig(ratio=0.3, seed=seed)
        trace, rows = TSA._program_rows(T_MODELS[m](n), mach)
        for idx, (k, ri, _sig) in enumerate(rows):
            entries.append((trace.nests[k], ri, cfg, seed * 1000003 + idx))
    got = TD.draw_bucket_keys_device_multi(entries, 1 << 12, "cpu")
    for (nt, ri, cfg, sd), g in zip(entries, got):
        want = TD.draw_sample_keys_device(nt, ri, cfg, sd, 1 << 12, "cpu")
        assert (g is None) == (want is None)
        if g is not None:
            assert torch.equal(g[0], want[0]) and torch.equal(g[1], want[1])
            assert g[2:] == want[2:]


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    """csrc/sampled_hist.cu and csrc/threefry_draw.cu built as plain C++:
    the per-row form's twin (sampled_hist_host_rows), the per-program
    twin, and B3's span-per-row twin."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("rows")
    libs = {}
    for name, flags in (("sampled_hist", ["-Wall", "-Werror"]),
                        ("threefry_draw", [])):
        so = out / f"lib{name}_host.so"
        subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O1", "-shared",
                        "-fPIC", *flags, "-o", str(so),
                        os.path.join(CSRC, f"{name}.cu")],
                       check=True, capture_output=True, timeout=300)
        libs[name] = ctypes.CDLL(str(so))
    p, q, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    rows = libs["sampled_hist"].sampled_hist_host_rows
    rows.argtypes = [p, p, q, q, p, i, p, p, p, q, i, p, p, p]
    rows.restype = i
    one = libs["sampled_hist"].sampled_hist_host
    one.argtypes = [p, p, q, q, p, i, p, p, p, i, p, p, p]
    one.restype = i
    b3 = libs["threefry_draw"].threefry_randint_rows_host
    b3.argtypes = td._ROWS_ARGTYPES[:-1]
    b3.restype = i
    solo = libs["threefry_draw"].threefry_randint_host
    solo.argtypes = td._RANDINT_ARGTYPES[:-1]
    solo.restype = i
    return {"rows": rows, "one": one, "b3": b3, "b3_solo": solo}


def _union_rows(progs, cfg, rng):
    """Every union bucket of `progs` with rows of two or more programs,
    as host arrays: (nests, refs, keys, mask, radices, rx)."""
    plans = [TSA._program_rows(p, T.MachineConfig()) for p in progs]
    for members in TSA._bucket_rows_multi(plans).values():
        if len({j for j, *_ in members}) < 2:
            continue
        nts = [plans[j][0].nests[k] for j, _idx, k, _ri in members]
        ris = [ri for *_, ri in members]
        hs, ks = [], []
        for nt, (_j, idx, _k, ri) in zip(nts, members):
            highs, _ = TSA._sample_highs(nt, ri, cfg)
            hs.append(TSA._pad_highs(highs))
            ks.append(TSA.draw_sample_keys(nt, ri, cfg, seed=idx)[0])
        B = max(len(x) for x in ks) + 5
        keys = np.empty((len(ks), B), np.int64)
        mask = rng.random((len(ks), B)) < 0.9
        for r, x in enumerate(ks):
            keys[r, :len(x)] = x
            keys[r, len(x):] = x[0]
            mask[r, len(x):] = False
        yield nts, ris, keys, mask, hs, np.array(ris, np.int64)


@pytest.mark.parametrize("models", [
    (("gemm", 8), ("gemm", 12), ("2mm", 10), ("syrk", 9)),
    (("trmm", 10), ("trmm", 13), ("syrk-tri", 12), ("syrk-tri", 9)),
    (("covariance", 10), ("covariance", 12), ("trisolv", 11),
     ("trisolv", 14)),
])
def test_per_row_twin_equals_plain_and_per_program_launches(models, twins):
    rng = np.random.default_rng(11)
    cfg = T.SamplerConfig(ratio=0.5, seed=1)
    progs = [T_MODELS[m](n) for m, n in models]
    n_buckets = 0
    for nts, ris, keys, mask, hs, rx in _union_rows(progs, cfg, rng):
        R, B = keys.shape
        descs = sh.rows_matrix([sh.build_descriptor(nt, ri)
                                for nt, ri in zip(nts, ris)])
        hrs = np.stack([sh.radix_records(h) for h in hs])
        tris = sh.tri_rows(nts, "cpu")
        tris = None if tris is None else tris.numpy()
        m8 = mask.astype(np.uint8)
        for raw in (False, True):
            res = np.empty_like(keys)
            hist = np.zeros((R, sh.N_BINS), np.int64)
            cold = np.zeros(R, np.int64)
            assert twins["rows"](
                keys.ctypes.data, m8.ctypes.data, R, B, descs.ctypes.data,
                descs.shape[1], hrs.ctypes.data, rx.ctypes.data,
                None if tris is None else tris.ctypes.data,
                0 if tris is None else tris.shape[1], int(raw),
                res.ctypes.data, hist.ctypes.data, cold.ctypes.data) == 0
            want = sh.sampled_hist_rows_plain(
                nts, ris, torch.from_numpy(keys), torch.from_numpy(mask),
                hs, torch.from_numpy(rx), raw)
            for a, b in zip((res, hist, cold), want):
                np.testing.assert_array_equal(a, b.numpy())
            for r in range(R):  # row r through the per-program twin
                d = sh.build_descriptor(nts[r], ris[r])
                tri = (np.ascontiguousarray(nts[r].tri_base, np.int64)
                       if nts[r].tri else None)
                pr = np.empty(B, np.int64)
                ph = np.zeros(sh.N_BINS, np.int64)
                pc = np.zeros(1, np.int64)
                kr, mr = keys[r].copy(), m8[r].copy()
                assert twins["one"](
                    kr.ctypes.data, mr.ctypes.data, 1, B, d.ctypes.data,
                    len(d), hrs[r].ctypes.data, rx[r:r + 1].ctypes.data,
                    None if tri is None else tri.ctypes.data, int(raw),
                    pr.ctypes.data, ph.ctypes.data, pc.ctypes.data) == 0
                np.testing.assert_array_equal(pr, res[r])
                np.testing.assert_array_equal(ph, hist[r])
                assert pc[0] == cold[r]
        n_buckets += 1
    assert n_buckets


def test_per_row_form_refuses_rows_without_one_instantiation():
    cfg_nt = TSA._program_rows(T_MODELS["gemm"](8), T.MachineConfig())[0]
    tri_nt = TSA._program_rows(T_MODELS["syrk-tri"](8),
                               T.MachineConfig())[0]
    a = sh.build_descriptor(cfg_nt.nests[0], 0)
    levels = {int(sh.build_descriptor(cfg_nt.nests[0], r)[sh.D_LV])
              for r in range(cfg_nt.nests[0].tables.n_refs)}
    assert len(levels) > 1
    b = next(sh.build_descriptor(cfg_nt.nests[0], r)
             for r in range(cfg_nt.nests[0].tables.n_refs)
             if sh.build_descriptor(cfg_nt.nests[0], r)[sh.D_LV] != a[sh.D_LV])
    for pair in ((a, b), (a, sh.build_descriptor(tri_nt.nests[0], 1))):
        with pytest.raises(ValueError, match="no instantiation"):
            sh.rows_instantiation(pair)
    keys = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        sh.sampled_hist_rows_cuda([cfg_nt.nests[0]], [0], keys, None,
                                  [np.ones(3, np.int64)],
                                  torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA"):
        td.threefry_randint_cuda([(1, 2)], 8, [5], "cpu")


@pytest.mark.parametrize("B", [1, 17, 1023, 1026, (1 << 14) + 3])
def test_b3_span_per_row_twin_equals_solo_spans_and_plain(B, twins):
    rng = np.random.default_rng(B)
    keys = [tuple(int(x) for x in rng.integers(0, 1 << 32, size=2))
            for _ in range(7)]
    spans = [1 << 20, 1000, (1 << 40) + 3, 7, 1 << 33, 4_190_209, 1]
    out = torch.zeros((len(keys), B), dtype=torch.int64)
    n = td.launch_randint_rows(lambda *a: twins["b3"](*a[:-1]),
                               td.randint_words(keys), B, spans, out, None)
    assert n == 3  # one launch per remainder kind present
    assert torch.equal(out, td.threefry_randint_plain(keys, B, spans))
    for r, (k, sp) in enumerate(zip(keys, spans)):
        solo = torch.zeros((1, B), dtype=torch.int64)
        td.launch_randint(lambda *a: twins["b3_solo"](*a[:-1]),
                          td.randint_words([k]), B, sp, solo, None)
        assert torch.equal(out[r], solo[0])


def test_service_batch_window_answers_as_the_jax_service(tmp_path):
    """One admission window of the JAX_JOBS requests: one batch, each
    response the JAX service's (and its solo run's digest)."""
    lines = [{"id": f"b{i}", "model": m, "n": n, "engine": "sampled",
              "ratio": 0.3, "seed": s, "device_draw": False}
             for i, (m, n, s) in enumerate(JAX_JOBS)]
    out = {}
    for mod, kw in ((JS, {}), (TS, {"device": "cpu"})):
        with mod.AnalysisService(batch_window_ms=300, batch_max_refs=512,
                                 **kw) as svc:
            buf = io.StringIO()
            mod.serve_jsonl(svc, io.StringIO(
                "".join(json.dumps(d) + "\n" for d in lines)), buf)
            stats = svc.executor.stats()
        assert (stats["batches_formed"], stats["batch_members"],
                stats["batch_fallback_solo"]) == (1, len(lines), 0)
        out[mod] = [json.loads(x) for x in buf.getvalue().splitlines()]
    drop = {"latency_s", "trace_id", "span_id", "queue_s", "execute_s"}
    assert ([{k: v for k, v in d.items() if k not in drop} for d in out[TS]]
            == [{k: v for k, v in d.items() if k not in drop}
                for d in out[JS]])
    assert all(d["ok"] and not d["degraded"] for d in out[TS])
