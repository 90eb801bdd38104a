"""The port's observability layer (runtime/obs/, the CLI's observability
flags and `stats`, the tool twins) against the JAX package's, on the CPU.

A CLI ledger row of the port equals the JAX CLI's but for its time
stamp, latency and build deltas (the same request fingerprint and MRC
digest); `stats` and the offline gates print the JAX package's bytes over
one made ledger; the Chrome trace and Prometheus documents are the copied
exporters'; the drift audit's row is the JAX package's; the recorder's
bundle passes both bundle gates; the stage profile gives every stage of
the JAX result; an entry point that asks for a card and finds none
raises.
"""

import contextlib
import importlib.util
import inspect
import io
import json
import os
import re
import subprocess
import sys

import pytest
import torch

import pluss_sampler_optimization_torch.config as TC
import pluss_sampler_optimization_tpu.config as JC
from pluss_sampler_optimization_torch.cli import main as t_main
from pluss_sampler_optimization_torch.models import REGISTRY as T_MODELS
from pluss_sampler_optimization_torch.runtime.obs import (
    drift as t_drift,
    exporters as t_exporters,
    ledger as t_ledger,
    recorder as t_recorder,
)
from pluss_sampler_optimization_torch.tools import (
    check_bundle as t_check_bundle,
    check_drift as t_check_drift,
    check_ledger as t_check_ledger,
    check_profile as t_check_profile,
    check_regression as t_check_regression,
    check_slo as t_check_slo,
)

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv) -> tuple:
    """(exit code, stdout, stderr) of a main(argv) in this process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def _made_ledger(path: str) -> None:
    """Request rows of several engines, tiers and outcomes, drift rows
    with and without a breach, and a bench row, with fixed stamps."""
    rows = []
    for i, (eng, used, cache, deg, lat) in enumerate((
        ("exact", "periodic", "miss", [], 0.5),
        ("exact", "analytic", "mem", [], 0.001),
        ("exact", "sampled", "miss", ["exact->sampled"], 0.9),
        ("sampled", "sampled", None, [], 0.25),
        ("sampled", "sampled", "disk", [], 0.01),
        ("dense", "dense", None, [], 1.5),
    )):
        rows.append({
            "kind": "request", "source": "cli", "ok": True,
            "fingerprint": f"{i:02x}" * 32, "engine_requested": eng,
            "engine_used": used, "model": "gemm", "n": 16 + i,
            "latency_s": lat, "cache": cache, "degraded": deg,
            "mrc_digest": f"{i:016x}", "compile_delta": {"cache_hits": i},
        })
    rows.append({
        "kind": "request", "source": "cli", "ok": False,
        "fingerprint": None, "engine_requested": "stream",
        "engine_used": None, "model": "mvt", "n": 8, "latency_s": 2.0,
        "cache": None, "degraded": [], "mrc_digest": None,
        "error": "made failure",
    })
    for breach, delta in ((False, 0.1), (True, 0.5)):
        rows.append({
            "kind": "drift", "source": "drift", "ok": not breach,
            "breach": breach, "model": "gemm", "n": 48, "ratio": 0.3,
            "seed": 0, "engine_exact": "periodic", "samples": 1000,
            "latency_s": 0.75, "thresholds": dict(t_drift.DRIFT_THRESHOLDS),
            "mrc_digest_exact": "a" * 16, "mrc_digest_sampled": "b" * 16,
            "max_abs_delta": delta, "mean_abs_delta": delta / 10,
            "support": 100, "len_exact": 100, "len_sampled": 100,
        })
    rows.append({
        "kind": "bench", "source": "bench", "ok": True,
        "metric": "made", "value": 1.0, "unit": "x", "engine": "sampled",
        "model": "gemm", "n": 4096, "latency_s": 2.2, "device": "cpu",
        "mrc_digest": "c" * 16,
    })
    for k, row in enumerate(rows):
        row["ts"] = 1_700_000_000.0 + k
        t_ledger.append(path, row)


def test_slo_config_is_the_jax_class():
    assert (inspect.getsource(TC.SLOConfig)
            == inspect.getsource(JC.SLOConfig))


def test_cli_ledger_row_equals_the_jax_cli(tmp_path):
    argv = ["sample", "--model", "gemm", "--n", "16", "--ratio", "0.3"]
    j_led, t_led = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    want = subprocess.run(
        [sys.executable, "-m", "pluss_sampler_optimization_tpu", *argv,
         "--platform", "cpu", "--ledger", j_led],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert want.returncode == 0, want.stderr
    rc, out, _ = _run(t_main, [*argv, "--device", "cpu", "--ledger", t_led])
    assert rc == 0 and out == want.stdout
    (j_row,), (t_row,) = t_ledger.read_rows(j_led), t_ledger.read_rows(t_led)
    assert t_row["fingerprint"] and t_row["mrc_digest"]
    assert isinstance(t_row["compile_delta"], dict)
    for row in (j_row, t_row):
        for key in ("ts", "latency_s", "compile_delta"):
            row.pop(key)
    assert t_row == j_row


@pytest.mark.parametrize("argv", [
    ["acc", "--engine", "exact", "--model", "syrk-tri", "--n", "20"],
    ["acc", "--engine", "oracle", "--runtime", "v2", "--threads", "3"],
    ["sample", "--engine", "sampled", "--ratio", "0.25", "--seed", "7",
     "--device-draw"],
    ["sample", "--engine", "sampled", "--no-device-draw", "--runtime",
     "v2"],
    ["speed", "--engine", "dense", "--chunk", "2"],
], ids=["exact", "oracle-v2", "sampled-device", "sampled-host", "dense"])
def test_fingerprint_is_the_jax_services(argv):
    """The CLI rows' fingerprint: the JAX package's
    AnalysisRequest(...).fingerprint(program) for the same flags (the
    fields its CLI's _request_from_args sets that can shape it)."""
    from pluss_sampler_optimization_torch import cli as t_cli
    from pluss_sampler_optimization_tpu.models import REGISTRY as J_MODELS
    from pluss_sampler_optimization_tpu.service import AnalysisRequest

    args = t_cli._parser().parse_args(argv)
    program = T_MODELS[args.model](args.n)
    got = t_cli._request_from_args(args, args.engine).fingerprint(program)
    want = AnalysisRequest(
        model=args.model, n=args.n, tsteps=args.tsteps, engine=args.engine,
        runtime=args.runtime, threads=args.threads, chunk=args.chunk,
        ratio=args.ratio, seed=args.seed, device_draw=args.device_draw,
    ).fingerprint(J_MODELS[args.model](args.n))
    assert got == want


def test_stats_prints_the_jax_clis_bytes(tmp_path, capsys):
    from pluss_sampler_optimization_tpu.cli import main as j_main

    led = str(tmp_path / "ledger.jsonl")
    _made_ledger(led)
    with open(led, "a") as f:
        f.write("not json\n")
    outs = []
    for main in (t_main, j_main):
        assert main(["stats", "--ledger", led]) == 0
        outs.append(capsys.readouterr())
    assert outs[0].out == outs[1].out and outs[0].err == outs[1].err
    assert "drift" in outs[0].out and "warning: 1 invalid" in outs[0].err
    with pytest.raises(SystemExit, match="stats mode needs --ledger"):
        t_main(["stats"])


@pytest.mark.parametrize("tool,argv", [
    ("check_ledger", ["{led}"]),
    ("check_ledger", ["{led}", "--stats"]),
    ("check_regression", ["--ledger", "{led}", "--bench", "{dir}/none*"]),
    ("check_slo", ["{led}"]),
    ("check_slo", ["{led}", "--latency-p95-s", "0.1"]),
], ids=["ledger", "ledger-stats", "regression", "slo", "slo-latency"])
def test_offline_gates_print_the_jax_tools_bytes(tool, argv, tmp_path):
    led = str(tmp_path / "ledger.jsonl")
    _made_ledger(led)
    argv = [a.format(led=led, dir=tmp_path) for a in argv]
    twin = {"check_ledger": t_check_ledger,
            "check_regression": t_check_regression,
            "check_slo": t_check_slo}[tool]
    assert _run(twin.main, argv) == _run(_jax_tool(tool).main, argv)


def test_cli_documents_come_from_the_copied_exporters(tmp_path):
    from pluss_sampler_optimization_tpu.runtime.obs import (
        exporters as j_exporters,
    )

    p = {k: str(tmp_path / k) for k in ("t.json", "c.json", "m.prom")}
    prof = str(tmp_path / "prof")
    rc, _, err = _run(t_main, [
        "sample", "--model", "gemm", "--n", "12", "--ratio", "0.3",
        "--device", "cpu", "--fuse-refs", "--telemetry-out", p["t.json"],
        "--trace-out", p["c.json"], "--metrics-out", p["m.prom"],
        "--profile-dir", prof])
    assert rc == 0 and err.startswith("telemetry: run ")
    with open(p["t.json"]) as f:
        doc = json.load(f)
    with open(p["c.json"]) as f:
        trace = f.read()
    with open(p["m.prom"]) as f:
        prom = f.read()
    for mod in (t_exporters, j_exporters):
        assert trace == mod.chrome_trace_text(doc)
        assert prom == mod.prometheus_text(doc)
    assert re.search(r"^pluss_dispatches_total \d+$", prom, re.M)
    names = {e["name"] for e in json.loads(trace)["traceEvents"]
             if e["ph"] == "X"}
    assert {"engine", "bucket", "draw", "dispatch", "fetch",
            "merge"} <= names
    (tr,) = os.listdir(prof)
    assert tr.endswith(".pt.trace.json")
    with open(os.path.join(prof, tr)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_drift_row_is_the_jax_packages(tmp_path):
    from pluss_sampler_optimization_tpu.runtime.obs import drift as j_drift

    led = str(tmp_path / "ledger.jsonl")
    got = t_drift.drift_audit("gemm", 16, device="cpu", ledger_path=led)
    want = j_drift.drift_audit("gemm", 16)
    assert not got["breach"]
    assert t_ledger.read_rows(led) == [got]
    for row in (got, want):
        row.pop("ts", None)
        row.pop("latency_s")
        row.pop("ledger_version", None)
    assert got == want
    rc, out, _ = _run(t_check_drift.main, [
        "--models", "gemm", "--n", "16", "--device", "cpu"])
    assert rc == 0 and out.startswith("gemm n=16 ratio=0.3 (exact=periodic)")


def test_recorder_bundle_passes_both_bundle_gates(tmp_path):
    bdir = str(tmp_path / "bundles")
    led = str(tmp_path / "ledger.jsonl")
    _made_ledger(led)
    rec = t_recorder.FlightRecorder(bdir, profile=True, ledger_path=led)
    rec.record_request({"id": "r1", "ok": True, "latency_s": 0.1})
    path = rec.dump("dump_debug", trigger={"who": "test"})
    with open(path) as f:
        doc = json.load(f)
    assert doc["profile"] is None  # the CUDA snapshot: CUDA only
    assert doc["devices"]["platform"] == "cpu"
    assert len(doc["ledger_tail"]) > 0
    assert t_recorder.validate_bundle(doc) == []
    assert _run(t_check_bundle.main, [bdir]) == _run(
        _jax_tool("check_bundle").main, [bdir])
    assert t_check_bundle.main([bdir]) == 0


def test_check_profile_twin_report_and_determinism():
    """The determinism and schema arm (the timed overhead gate runs on
    the card): the JAX tool's report, ok."""
    got = t_check_profile.check_determinism()
    assert got == _jax_tool("check_profile").check_determinism()
    assert got["ok"]
    rc, out, _ = _run(t_check_profile.main, ["--skip-engine", "--json"])
    assert rc == 0 and json.loads(out)["determinism"] == got


def test_profile_stages_gives_every_jax_stage():
    from pluss_sampler_optimization_torch.runtime.obs.stage_profile import (
        profile_stages,
    )
    from pluss_sampler_optimization_tpu.runtime.obs import stage_profile

    src = inspect.getsource(stage_profile)
    want = set(re.findall(r'med_time\(\s*"(\w+)"', src)) | set(
        re.findall(r'stage_ms\["(\w+)"\]', src))
    assert len(want) == 7
    lines = []
    res = profile_stages(n=12, reps=1, device="cpu", out=lines.append)
    assert set(res["stage_ms"]) == want
    assert set(res) == {"device", "model", "n", "ref", "batch", "stage_ms",
                        "profile"}
    assert res["device"] == "cpu" and res["profile"] is None
    assert all(ms > 0 for ms in res["stage_ms"].values())


def test_no_fallback_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    led = str(tmp_path / "ledger.jsonl")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_main(["sample", "--n", "8", "--ledger", led,
                "--telemetry-out", str(tmp_path / "t.json")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_drift.drift_audit("gemm", 8)
    assert not os.path.exists(led)
