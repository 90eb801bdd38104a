"""The port's fabric command lines against the JAX CLI's, on the CPU.

`serve-worker` and `serve-router` with their flags: the refusals word for
word (the fabric flags outside the fabric modes, --stats-interval-s
included, and the modes' own checks), a supervised `serve-router
--workers 2` batch whose responses and stderr lines are the JAX CLI's
(but for addresses, pids and the port's spawn-to-ready line), a
SIGTERM drain of a real fabric with its flight-recorder bundles, the
port's meaning of --worker-devices (devices of --device), and the
check_fabric twin's report without its kill phase (whose victim must
have work in flight at its probe: a timing the card's requests give,
run there by chip_smoke.py).
"""

import contextlib
import glob
import importlib.util
import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time

import pytest
from _torch_threads import (  # noqa: F401
    ONE_THREAD_ENV,
    one_thread_env,
    one_torch_thread,
)

from pluss_sampler_optimization_torch.cli import main as t_main
from pluss_sampler_optimization_torch.service.fabric import parse_hostport
from pluss_sampler_optimization_tpu.cli import main as j_main

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TIMEOUT_S = 300.0

VOLATILE = {"latency_s", "trace_id", "span_id", "queue_s", "execute_s",
            "batch_wait_s", "utilization", "created_at", "ts",
            "compile_delta", "worker_s"}


def _strip(d):
    if isinstance(d, dict):
        return {k: _strip(v) for k, v in d.items() if k not in VOLATILE}
    if isinstance(d, list):
        return [_strip(x) for x in d]
    return d


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [
    ["serve-router"],
    ["serve-router", "--workers", "0"],
    ["serve-router", "--workers", "1", "--worker", "127.0.0.1:1"],
    ["serve-router", "--workers", "1", "--profile-hz", "5"],
    ["serve-router", "--workers", "1", "--regress-bench", "b.json",
     "--ledger-gc-interval-s", "1", "--ledger", "l.jsonl"],
    ["serve-worker", "--workers", "2"],
    ["serve-worker", "--worker", "127.0.0.1:1"],
    ["serve-worker", "--worker-id", "-1"],
    ["serve-worker", "--worker-devices", "0"],
    ["serve-worker", "--program-json", "g.json"],
    ["serve", "--stats-interval-s", "1"],
    ["serve", "--listen", "127.0.0.1:0", "--no-fabric-trace"],
    ["sample", "--n", "8", "--stats-interval-s", "1"],
    ["sample", "--n", "8", "--worker-devices", "2", "--worker-id", "3"],
    ["acc", "--n", "8", "--hb-interval-s", "1", "--hb-timeout-s", "2",
     "--reconnect-attempts", "1", "--reconnect-delay-s", "0.1"],
])
def test_fabric_flag_checks_equal_the_jax_cli(argv):
    j = _cli(j_main, argv)
    t = _cli(t_main, argv)
    assert j[0] != 0 and t[0] == j[0], (t, j)


def test_worker_devices_are_devices_of_device(monkeypatch):
    """--worker-devices D: the first D cards under --device cuda
    (refused past the visible count, naming --device), D replicas' worth
    of a named device otherwise; the JAX CLI's virtual CPU slice has no
    counterpart in a process without jax."""
    import torch

    from pluss_sampler_optimization_torch import cli

    rc, _out, err = _cli(t_main, ["serve-worker", "--worker-devices", "2"])
    assert "--device cuda" in str(rc) and "0 visible" in str(rc)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    args = cli._parser().parse_args(
        ["serve-worker", "--worker-devices", "2"])
    cli._check_serve_args(args)
    assert cli._service_device(args) == ["cuda:0", "cuda:1"]
    for device, want in (("cpu", ["cpu"] * 3), ("cuda:1", ["cuda:1"] * 3)):
        args = cli._parser().parse_args(
            ["serve-worker", "--worker-devices", "3", "--device", device])
        cli._check_serve_args(args)
        assert cli._service_device(args) == want
    # a router forwards it, with --device, to every worker it spawns
    args = cli._parser().parse_args(["serve-router", "--workers", "1"])
    assert cli._service_device(args) == "cuda"


def _norm_err(text: str) -> list[str]:
    """stderr lines without what differs run to run (addresses, pids,
    the port's spawn-to-ready seconds)."""
    lines = []
    for ln in text.splitlines():
        if re.search(r"worker \d+ ready [0-9.]+s after spawn", ln):
            continue
        ln = re.sub(r"127\.0\.0\.1:\d+", "ADDR", ln)
        ln = re.sub(r"\(pid \d+\)", "(pid P)", ln)
        lines.append(ln)
    return sorted(lines)


@pytest.fixture
def one_thread_children(monkeypatch):
    """The fabric's processes (router, workers) at one torch thread."""
    for k, v in ONE_THREAD_ENV.items():
        monkeypatch.setenv(k, v)


def test_cli_serve_router_equals_the_jax_cli(tmp_path, one_thread_children):
    """A supervised 2-worker fabric over a mixed batch (sampled lines, a
    duplicate, a malformed line, a stats line): the port's responses are
    the JAX CLI's, and so are its stderr lines."""
    base = {"model": "gemm", "n": 12, "engine": "sampled", "ratio": 0.3}
    lines = [json.dumps({**base, "seed": s, "id": f"r{s}"})
             for s in (1, 2, 3)]
    lines += [json.dumps({**base, "seed": 1, "id": "dup"}),
              '{"id": "mal", "model": ',
              json.dumps({"id": "o", "model": "gemm", "n": 8,
                          "engine": "oracle"})]
    reqs = tmp_path / "r.jsonl"
    reqs.write_text("\n".join(lines) + "\n")
    runs = {}
    jax_extra = ["--platform", "cpu", "--compilation-cache-dir",
                 os.path.join(ROOT, ".jax_cache", "tests")]
    for tag, main, extra in (("j", j_main, jax_extra),
                             ("t", t_main, ["--device", "cpu"])):
        resp = tmp_path / f"{tag}.jsonl"
        rc, out, err = _cli(main, [
            "serve-router", "--workers", "2", "--requests", str(reqs),
            "--responses", str(resp), "--cache-dir", str(tmp_path / tag),
            "--stats-interval-s", "0.5", *extra])
        assert rc == 0, err
        runs[tag] = ([json.loads(x) for x in resp.read_text().splitlines()],
                     out, _norm_err(err))
    (t_docs, t_out, t_err), (j_docs, j_out, j_err) = runs["t"], runs["j"]
    assert _strip(t_docs) == _strip(j_docs)
    assert [d.get("worker_id") for d in t_docs] == \
        [d.get("worker_id") for d in j_docs]
    assert t_out == j_out and t_err == j_err


def test_fabric_sigterm_drain_subprocess(tmp_path):
    """A real supervised fabric under SIGTERM: the router stops
    accepting, the workers drain, every process writes its final
    flight-recorder bundle, the tree exits 0, and the router prints each
    worker's seconds from spawn to its ready line."""
    bundles = str(tmp_path / "bundles")
    err_path = str(tmp_path / "router.err")
    cmd = [
        sys.executable, "-m", "pluss_sampler_optimization_torch.cli",
        "serve-router", "--workers", "2", "--listen", "127.0.0.1:0",
        "--device", "cpu", "--stats-interval-s", "0.5",
        "--cache-dir", str(tmp_path / "store"),
        "--ledger", str(tmp_path / "ledger.jsonl"),
        "--debug-bundle-dir", bundles,
    ]
    with open(err_path, "w") as errf:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.DEVNULL,
                                stderr=errf, text=True,
                                env=one_thread_env())
    try:
        addr = None
        deadline = time.time() + TIMEOUT_S
        while time.time() < deadline:
            text = open(err_path).read()
            if "JSONL TCP front on " in text:
                spec = text.split("JSONL TCP front on ", 1)[1]
                addr = parse_hostport(spec.splitlines()[0])
                break
            assert proc.poll() is None, f"router died: {text[-800:]}"
            time.sleep(0.25)
        assert addr is not None, "fabric never opened its TCP front"
        sock = socket.create_connection(addr, timeout=30)
        rf = sock.makefile("r", encoding="utf-8")
        wf = sock.makefile("w", encoding="utf-8")
        wf.write(json.dumps({"id": "st-1", "model": "gemm", "n": 16,
                             "engine": "oracle"}) + "\n")
        wf.flush()
        doc = json.loads(rf.readline())
        assert doc["id"] == "st-1" and doc["ok"]
        sock.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    err = open(err_path).read()
    assert "graceful shutdown" in err
    assert len(re.findall(r"worker \d ready [0-9.]+s after spawn", err)) == 2
    assert glob.glob(os.path.join(bundles, "BUNDLE_*_shutdown.json"))
    for wid in (0, 1):
        got = glob.glob(os.path.join(bundles, f"worker{wid}",
                                     "BUNDLE_*_shutdown.json"))
        assert got, f"worker {wid} wrote no shutdown bundle ({err[-500:]})"


def test_check_fabric_twin_report(tmp_path, one_thread_children):
    """The check_fabric twin's identity, warm, restarts and fleet phases
    with real supervised CPU workers: no problem, the report's per-phase
    responses equal the JAX service's for the JAX gate's request set,
    every worker's spawn-to-ready seconds, and no re-dispatch or link
    reconnect where no worker was killed."""
    from pluss_sampler_optimization_torch.tools import check_fabric
    from pluss_sampler_optimization_tpu import service as JS

    spec = importlib.util.spec_from_file_location(
        "jax_tools_check_fabric", os.path.join(ROOT, "tools",
                                               "check_fabric.py"))
    j_gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_gate)
    lines = j_gate.request_lines()
    assert check_fabric.request_lines() == lines
    out = tmp_path / "report.json"
    rc = check_fabric.main(["--device", "cpu", "--phases",
                            "identity,warm,restarts,fleet",
                            "--json", str(out)])
    report = json.loads(out.read_text())
    assert rc == 0 and report["problems"] == []
    with JS.AnalysisService(max_workers=2) as svc:
        fout = io.StringIO()
        JS.serve_jsonl(svc, io.StringIO("\n".join(lines) + "\n"), fout)
    want = {d["id"]: [d["ok"], d["fingerprint"], d["mrc_digest"]]
            for d in map(json.loads, fout.getvalue().splitlines())}
    phases = report["phases"]
    assert set(phases) == {"w1", "w2", "w2warm", "fleet"}
    workers = {"w1": 1, "w2": 2, "w2warm": 2, "fleet": 2}
    for tag, ph in phases.items():
        got = {i: [d["ok"], d["fingerprint"], d["mrc_digest"]]
               for i, d in ph["docs"].items()}
        assert got == want, tag
        assert sorted(ph["ready_s"]) == [str(i) for i in
                                         range(workers[tag])], tag
        assert ph["redispatched"] == [], tag
    assert all(d["cache"] != "miss"
               for d in phases["w2warm"]["docs"].values())
    assert phases["fleet"]["router"] == {
        "redispatched": 0, "reconnects": {"0": 0, "1": 0}}
