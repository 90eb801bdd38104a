"""The port's analysis service against the JAX package's, on the CPU.

The same request lines through both services (AnalysisService and
serve_jsonl, the CLI's serve and its service-routed flags) answer with
the same bytes but for timings and ids: oracle, numpy, exact and
host-draw sampled requests, malformed lines, and the shed, deadline,
breaker and fault-spec cases; their ledger rows, stats and healthz
agree too. A store written by either service answers the other with no
engine work. The copied modules (config's service classes, the
concurrency analysis' target list) are pinned by source, and the tool
twins print the JAX tools' lines. Every comparison is exact.
"""

import contextlib
import importlib.util
import inspect
import io
import json
import os
import shutil

import pytest
from _torch_threads import one_torch_thread  # noqa: F401

import pluss_sampler_optimization_torch.config as TC
import pluss_sampler_optimization_tpu.config as JC
from pluss_sampler_optimization_torch import service as TS
from pluss_sampler_optimization_torch.cli import main as t_main
from pluss_sampler_optimization_torch.runtime import faults as t_faults
from pluss_sampler_optimization_torch.runtime.obs import ledger as t_ledger
from pluss_sampler_optimization_tpu import service as JS
from pluss_sampler_optimization_tpu.cli import main as j_main
from pluss_sampler_optimization_tpu.runtime import faults as j_faults

# the JAX service's engine modules, imported before its pool threads
# would import them concurrently (which can fail there on a cold
# process; the port's executor imports its engines up front)
from pluss_sampler_optimization_tpu.oracle import numpy_ref, serial  # noqa
from pluss_sampler_optimization_tpu.sampler import (  # noqa
    analytic, dense, periodic, sampled, stream)

ROOT = os.path.join(os.path.dirname(__file__), "..")

# serving metadata that differs run to run: timings, minted ids, stamps,
# the hosts' build or compile deltas, in-flight levels read mid-run
VOLATILE = {"latency_s", "trace_id", "span_id", "queue_s", "execute_s",
            "batch_wait_s", "utilization", "created_at", "ts",
            "compile_delta", "in_flight", "executing", "queue_depth",
            "batch_queue_depth", "batched_p50_latency_s",
            "solo_p50_latency_s", "ledger", "ledger_tail", "reopen_in_s"}


LINES = [
    {"id": "o", "model": "gemm", "n": 8, "engine": "oracle"},
    {"id": "v2", "model": "syrk", "n": 8, "engine": "oracle",
     "runtime": "v2"},
    {"id": "np", "model": "syrk", "n": 10, "engine": "numpy"},
    {"id": "ex", "model": "trmm", "n": 10, "engine": "exact"},
    {"id": "pe", "model": "gemm", "n": 12, "engine": "periodic",
     "threads": 3},
    {"id": "sa", "model": "gemm", "n": 12, "engine": "sampled",
     "ratio": 0.3, "seed": 1},
    {"id": "sb", "model": "2mm", "n": 10, "engine": "sampled",
     "ratio": 0.3, "seed": 2, "runtime": "v2"},
    {"id": "bad", "model": "nope"},
    {"id": "unk", "model": "gemm", "bogus": 1},
    {"id": "kb", "model": "gemm", "n": 8, "engine": "sampled",
     "kernel_backend": "auto"},
]


def _strip(d):
    if isinstance(d, dict):
        return {k: _strip(v) for k, v in d.items() if k not in VOLATILE}
    if isinstance(d, list):
        return [_strip(x) for x in d]
    return d


def _serve(mod, lines, tmp, name, **kw):
    """(response docs, ledger rows, stats, healthz) of one serve_jsonl
    batch through package `mod`'s service."""
    led = os.path.join(tmp, f"{name}.jsonl")
    with mod.AnalysisService(cache_dir=os.path.join(tmp, name),
                             ledger_path=led, **kw) as svc:
        out = io.StringIO()
        text = "".join(
            (x if isinstance(x, str) else json.dumps(x)) + "\n"
            for x in lines)
        mod.serve_jsonl(svc, io.StringIO(text), out)
        stats, health = svc.stats(), svc.healthz()
    docs = [json.loads(x) for x in out.getvalue().splitlines()]
    return docs, list(t_ledger.read_rows(led)), stats, health


def _rows(rows):
    """Ledger rows without their volatile fields, in a canonical order
    (rows land as requests finish)."""
    return sorted(_strip(rows), key=lambda r: json.dumps(r, sort_keys=True))


def _both(lines, tmp, **kw):
    j = _serve(JS, lines, str(tmp), "j", **kw)
    t = _serve(TS, lines, str(tmp), "t", device="cpu", **kw)
    return j, t


def test_service_config_is_the_jax_packages():
    for name in ("BatchConfig", "ResilienceConfig", "FaultConfig"):
        assert (inspect.getsource(getattr(TC, name))
                == inspect.getsource(getattr(JC, name))), name
    assert TC.FAULT_SITES == JC.FAULT_SITES
    assert TC.FAULT_KINDS == JC.FAULT_KINDS
    for name in ("__post_init__", "resolve"):
        assert (inspect.getsource(getattr(TC.ReplicaConfig, name))
                == inspect.getsource(getattr(JC.ReplicaConfig, name)))
    assert ([(f.name, f.default) for f in
             TC.dataclasses.fields(TC.ReplicaConfig)]
            == [(f.name, f.default) for f in
                JC.dataclasses.fields(JC.ReplicaConfig)])


def test_concurrency_package_is_the_copy_with_the_ports_targets():
    with open(os.path.join(ROOT, "pluss_sampler_optimization_tpu",
                           "analysis", "concurrency", "__init__.py")) as f:
        want = f.read().replace('"pluss_sampler_optimization_tpu/',
                                '"pluss_sampler_optimization_torch/')
    with open(os.path.join(ROOT, "pluss_sampler_optimization_torch",
                           "analysis", "concurrency", "__init__.py")) as f:
        assert f.read() == want


def test_serve_lines_ledger_stats_and_healthz_equal_the_jax_service(tmp_path):
    (jd, jl, js, jh), (td, tl, ts, th) = _both(LINES, tmp_path)
    assert _strip(td) == _strip(jd)
    assert [d["ok"] for d in td] == [True] * 7 + [False] * 2 + [True]
    assert _rows(tl) == _rows(jl)
    assert _strip(ts) == _strip(js)
    assert _strip(th) == _strip(jh)
    # the same requests again: answered from the mem tier by both
    (jd2, *_), (td2, *_) = _both(LINES[:7], tmp_path)
    assert {d["cache"] for d in td2} == {"disk"}
    assert _strip(td2) == _strip(jd2)


def test_serve_line_faults_and_deadlines_equal_the_jax_service(tmp_path):
    """A serve_line fault on line 1 (one structured error response) and a
    deadline spent before the first attempt (exact degrades to sampled,
    a degraded result never stored)."""
    # seed 7 at p 0.5: the counter hash fires on line 1 alone
    spec = {"seed": 7, "rules": [{"site": "serve_line", "kind": "raise",
                                  "p": 0.5}]}
    lines = [
        {"id": "o", "model": "gemm", "n": 8, "engine": "oracle"},
        {"id": "d", "model": "gemm", "n": 12, "engine": "exact",
         "deadline_s": 1e-9, "ratio": 0.3},
        {"id": "o2", "model": "syrk", "n": 8, "engine": "oracle"},
    ]
    out = []
    for mod, cfg, fmod in ((JS, JC, j_faults), (TS, TC, t_faults)):
        fmod.install(cfg.FaultConfig(seed=spec["seed"],
                                     rules=spec["rules"]))
        try:
            kw = {} if mod is JS else {"device": "cpu"}
            out.append(_serve(mod, lines, str(tmp_path),
                              f"f{len(out)}", **kw))
        finally:
            fmod.uninstall()
    (jd, jl, js, _), (td, tl, ts, _) = out
    assert _strip(td) == _strip(jd)
    assert td[1]["degraded"][0]["reason"] == \
        "deadline exhausted before attempt"
    assert td[1]["engine_used"] == "sampled"
    assert ["fault injected" in (d.get("error") or "") for d in td] == [
        True, False, False]
    assert _rows(tl) == _rows(jl)
    assert _strip(ts) == _strip(js)


def test_shed_and_breaker_outcomes_equal_the_jax_service():
    """Shedding during a drain, and an engine breaker opened by an
    injected failure failing the next request fast."""
    outs = []
    for mod, cfg, fmod, kw in ((JS, JC, j_faults, {}),
                               (TS, TC, t_faults, {"device": "cpu"})):
        res = cfg.ResilienceConfig(breaker_failures=1,
                                   breaker_probation_s=300.0)
        docs = []
        with mod.AnalysisService(resilience=res, **kw) as svc:
            fmod.install(cfg.FaultConfig(seed=1, rules=(
                {"site": "engine_execute", "kind": "raise", "p": 1.0,
                 "match": {"engine": "oracle"}},)))
            try:
                for rid, n in (("f1", 8), ("f2", 9)):
                    r = svc.analyze(mod.AnalysisRequest(
                        model="gemm", n=n, engine="oracle", id=rid))
                    docs.append(r.to_jsonl_dict())
            finally:
                fmod.uninstall()
            svc.begin_shutdown()
            docs.append(svc.analyze(mod.AnalysisRequest(
                model="gemm", n=8, engine="numpy", id="s")).to_jsonl_dict())
            stats = svc.stats()
        outs.append((docs, stats))
    (jd, js), (td, ts) = outs
    assert _strip(td) == _strip(jd)
    assert "circuit breaker open" in td[1]["error"]
    assert td[2]["shed"] and "draining" in td[2]["error"]
    assert _strip(ts) == _strip(js)


def test_stores_answer_across_the_packages(tmp_path):
    """A store written by the JAX service answers the port with no
    engine work (a runner that raises), and the reverse."""
    lines = [LINES[0], LINES[3], LINES[5]]

    def no_engine(*a, **kw):
        raise AssertionError("engine work on a warm store")

    for writer, reader, kw_w, kw_r in (
            (JS, TS, {}, {"device": "cpu"}),
            (TS, JS, {"device": "cpu"}, {})):
        store = str(tmp_path / f"{writer.__name__}")
        with writer.AnalysisService(cache_dir=store, **kw_w) as svc:
            want = [svc.analyze(writer.parse_request_line(json.dumps(d)))
                    for d in lines]
        with reader.AnalysisService(cache_dir=store, runner=no_engine,
                                    **kw_r) as svc:
            got = [svc.analyze(reader.parse_request_line(json.dumps(d)))
                   for d in lines]
        assert [g.cache for g in got] == ["disk"] * 3
        assert [g.mrc_digest for g in got] == [w.mrc_digest for w in want]
        assert [g.dump_lines for g in got] == [w.dump_lines for w in want]


def test_kernel_backend_takes_the_ports_values():
    for kb, port in (("xla", "torch"), ("pallas", "cuda")):
        with pytest.raises(ValueError, match=f"use '{port}'"):
            TS.AnalysisRequest(model="gemm", engine="sampled",
                               kernel_backend=kb)
    fps = {TS.AnalysisRequest(model="gemm", n=8, engine="sampled",
                              kernel_backend=kb).fingerprint()
           for kb in (None, "auto", "cuda", "torch", "native")}
    assert fps == {JS.AnalysisRequest(model="gemm", n=8,
                                      engine="sampled").fingerprint()}


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def test_cli_serve_equals_the_jax_cli(tmp_path):
    reqs = tmp_path / "r.jsonl"
    reqs.write_text("".join(json.dumps(d) + "\n" for d in LINES))
    outs = []
    for main, tag, extra in ((j_main, "j", []),
                             (t_main, "t", ["--device", "cpu"])):
        resp = tmp_path / f"{tag}.jsonl"
        rc, _out, err = _cli(main, [
            "serve", "--requests", str(reqs), "--responses", str(resp),
            "--cache-dir", str(tmp_path / f"s{tag}"), "--max-workers", "2",
            "--ledger", str(tmp_path / f"l{tag}.jsonl"), *extra])
        assert rc == 0
        outs.append(([json.loads(x) for x in resp.read_text().splitlines()],
                     err))
    assert _strip(outs[1][0]) == _strip(outs[0][0])
    assert outs[1][1] == outs[0][1]  # "serve: 3 request(s) failed ..."


@pytest.mark.parametrize("argv", [
    ["sample", "--n", "8", "--batch-window-ms", "5"],
    ["acc", "--n", "8", "--replicas", "2"],
    ["acc", "--n", "8", "--deadline-s", "1"],
    ["acc", "--n", "8", "--max-retries", "2", "--queue-limit", "3"],
    ["acc", "--n", "8", "--fault-spec", "f.json"],
    ["acc", "--n", "8", "--metrics-port", "0"],
    ["sample", "--n", "8", "--debug-bundle-dir", "d"],
    ["sample", "--n", "8", "--profile-hz", "5"],
    ["sample", "--n", "8", "--stats-interval-s", "1"],
    ["serve", "--no-shed"],
    ["serve", "--warmup-from-ledger", "2"],
    ["serve", "--replicas", "-1"],
    ["serve", "--profile-out", "p.json"],
    ["acc", "--n", "8", "--cache-dir", "d", "--engine", "native"],
    ["sample", "--n", "8", "--cache-dir", "d", "--r10"],
    ["trace", "--cache-dir", "d"],
])
def test_cli_service_flag_checks_equal_the_jax_cli(argv):
    """The JAX CLI's refusal, word for word (its stage-profile tool is
    the port's tools/profile_stages.py)."""
    j = _cli(j_main, argv)
    t = _cli(t_main, argv)
    assert j[0] != 0 and t[0] == j[0].replace("profile_tpu_stages",
                                              "profile_stages"), (t, j)


def test_cli_cache_dir_routes_through_the_service(tmp_path):
    """acc and sample with --cache-dir print the direct path's lines,
    the JAX CLI's, and answer a repeat from the store."""
    for argv in (["acc", "--engine", "exact", "--model", "trmm", "--n",
                  "12"],
                 ["sample", "--n", "12", "--ratio", "0.3", "--seed", "2"]):
        direct = _cli(t_main, [*argv, "--device", "cpu"])
        served = [_cli(t_main, [*argv, "--device", "cpu", "--cache-dir",
                                str(tmp_path / "t")]) for _ in range(2)]
        jax = _cli(j_main, [*argv, "--cache-dir", str(tmp_path / "j")])
        assert direct[0] == 0 and direct[1] == jax[1]
        assert [s[1] for s in served] == [direct[1]] * 2


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_check_service_store_twin_prints_the_jax_tools_lines(tmp_path):
    from pluss_sampler_optimization_torch.tools import check_service_store

    with TS.AnalysisService(cache_dir=str(tmp_path / "s"),
                            device="cpu") as svc:
        svc.analyze(TS.AnalysisRequest(model="gemm", n=8, engine="oracle"))
    sub = next(p for p in (tmp_path / "s").iterdir() if p.is_dir())
    (sub / ("0" * 64 + ".json")).write_text("{not json")
    (sub / "x.json.tmp").write_text("")
    jt = _jax_tool("check_service_store")
    for gc in ([], ["--gc"]):
        for tag in ("t", "j"):
            shutil.copytree(tmp_path / "s", tmp_path / tag)
        got = _cli(check_service_store.main, [str(tmp_path / "t"), *gc])
        want = _cli(jt.main, [str(tmp_path / "j"), *gc])
        assert got == tuple(x.replace(str(tmp_path / "j"), str(
            tmp_path / "t")) if isinstance(x, str) else x for x in want)
        assert "1 valid, 1 corrupt" in got[1]
        for tag in ("t", "j"):
            shutil.rmtree(tmp_path / tag)


def test_check_chaos_twin_passes_and_replays():
    """The deterministic phases: chaos vs baseline with replay and
    quarantine, breakers, serve-line faults, the progressive deadline,
    under the lock witness."""
    from pluss_sampler_optimization_torch.tools import check_chaos

    rc, out, err = _cli(check_chaos.main, ["--seeds", "1", "--device",
                                           "cpu"])
    assert rc == 0, err
    assert out.splitlines()[0].startswith("check_chaos: seed 0: OK (")
    assert out.splitlines()[-1] == "check_chaos: 1 seed(s), 0 problem(s)"


def test_check_precision_twin_passes():
    from pluss_sampler_optimization_torch.tools import check_precision

    rc, out, err = _cli(check_precision.main, [
        "--seeds", "0", "--models", "gemm", "--n", "16", "--device", "cpu"])
    assert rc == 0, err
    assert out == ("check_precision: ok (1 seed(s) x 1 model(s), deadline "
                   "gate on)\n")


def test_loadgen_twin_draws_the_jax_requests_and_serves_them():
    from pluss_sampler_optimization_torch.tools import loadgen

    jl = _jax_tool("loadgen")
    kw = dict(mix=(("low", 0.3), ("normal", 0.4), ("high", 0.3)),
              unique_frac=0.5, tolerance_mix=((0.05, 0.5), (None, 0.5)))
    assert ([r.payload() | {"id": r.id, "priority": r.priority}
             for r in loadgen.make_requests(24, 3, **kw)]
            == [r.payload() | {"id": r.id, "priority": r.priority}
                for r in jl.make_requests(24, 3, **kw)])
    assert loadgen.arrival_offsets(16, 200.0, 2) == jl.arrival_offsets(
        16, 200.0, 2)
    rc, out, _ = _cli(loadgen.main, [
        "--requests", "12", "--rate", "500", "--queue-limit", "1000",
        "--service-time-s", "0", "--device", "cpu"])
    rep = json.loads(out)
    assert rc == 0 and (rep["submitted"], rep["ok"], rep["failed"]) == (
        12, 12, 0)


def test_concurrency_and_determinism_twins_print_the_jax_tools_lines():
    from pluss_sampler_optimization_torch.tools import (
        check_concurrency,
        lint_determinism,
    )

    for tool, name, argv in ((check_concurrency, "check_concurrency",
                              ["--fixtures"]),
                             (lint_determinism, "lint_determinism",
                              ["--fixtures"])):
        assert _cli(tool.main, argv) == _cli(_jax_tool(name).main, argv)
    rc, out, _ = _cli(check_concurrency.main, [])
    assert rc == 0 and out.startswith("check_concurrency: ")
    assert " 0 violation(s)" in out
    rc, out, _ = _cli(lint_determinism.main, [])
    assert rc == 0 and " 0 violation(s)" in out


def test_progressive_fires_round_exec_by_fault_key():
    from pluss_sampler_optimization_torch.models import gemm
    from pluss_sampler_optimization_torch.sampler.sampled import (
        run_sampled_progressive,
    )

    inj = t_faults.install(TC.FaultConfig(seed=0, rules=(
        {"site": "round_exec", "kind": "raise", "p": 1.0,
         "match": {"round": 1}},)))
    try:
        with pytest.raises(t_faults.FaultInjected):
            run_sampled_progressive(
                gemm(12), TC.MachineConfig(),
                TC.SamplerConfig(ratio=0.3, max_rounds=3), device="cpu",
                fault_key="fp")
        # a key the rule does not match ("round" 0) fired nothing
        assert inj.total_fired() == 1
    finally:
        t_faults.uninstall()
