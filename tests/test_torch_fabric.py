"""The port's serving fabric against the JAX package's, on the CPU.

The fabric's modules (service/fabric/{wire,worker,router,__init__}.py,
runtime/obs/fleet.py) are byte-equal copies, pinned by
tests/test_torch_host.py::COPIED; config's FabricConfig by source here.
What these tests hold is that the copies, over the port's service,
answer as the JAX fabric does:

- bit identity: the same mixed request set (three sampled fingerprints,
  a byte-different duplicate, an inline program that is the first's
  structural twin) served by the JAX service directly and by a 3-worker
  JAX fabric, and by the port's service, 1- and 3-worker fabrics, cold
  and warm, streamed and one at a time, with a batch window and with
  tracing off, gives the same (ok, fingerprint, mrc_digest,
  engine_used) per id;
- the wire layer, parse_hostport, the router's hostile lines, the
  handshake's refusal, the TCP front driven by the loadgen twin's
  --connect, trace propagation into the workers' ledger rows, the fleet
  stats and the trace assembly (the assemble_trace twin prints the JAX
  tool's bytes), and progressive partials interleaved across workers
  with a worker failing over.

The CLI's fabric modes run as real subprocesses in
tests/test_torch_fabric_cli.py. Nothing here depends on timing but the
fabric's own bounded waits.
"""

import dataclasses
import importlib.util
import inspect
import io
import json
import os
import socket
import struct
import threading

import pytest
from _torch_threads import one_torch_thread  # noqa: F401

import pluss_sampler_optimization_torch.config as TC
import pluss_sampler_optimization_tpu.config as JC
from pluss_sampler_optimization_torch import service as TS
from pluss_sampler_optimization_torch.frontend import program_to_json
from pluss_sampler_optimization_torch.models import build
from pluss_sampler_optimization_torch.runtime.obs import fleet as t_fleet
from pluss_sampler_optimization_torch.runtime.obs import ledger as t_ledger
from pluss_sampler_optimization_torch.service import fabric as TF
from pluss_sampler_optimization_tpu import service as JS
from pluss_sampler_optimization_tpu.runtime.obs import fleet as j_fleet
from pluss_sampler_optimization_tpu.service import fabric as JF

# the JAX service's engine modules, imported before its pool threads
# would import them concurrently (which can fail there on a cold
# process; the port's executor imports its engines up front)
from pluss_sampler_optimization_tpu.sampler import sampled  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMEOUT_S = 300.0

# test-speed fabric: fast heartbeats, quick bounded reconnect
_CFG = dict(hb_interval_s=0.2, hb_timeout_s=5.0, reconnect_attempts=2,
            reconnect_delay_s=0.1, connect_timeout_s=10.0,
            drain_timeout_s=60.0)
T_CFG, J_CFG = TC.FabricConfig(**_CFG), JC.FabricConfig(**_CFG)

# the client-supplied trace id pinned on fb-1: it must ride the wire
# into the worker's own ledger row
TRACE_PIN = "cafe" * 4

# serving metadata that differs run to run
VOLATILE = {"latency_s", "trace_id", "span_id", "queue_s", "execute_s",
            "batch_wait_s", "utilization", "created_at", "ts",
            "compile_delta", "worker_s"}


def _strip(d):
    if isinstance(d, dict):
        return {k: _strip(v) for k, v in d.items() if k not in VOLATILE}
    if isinstance(d, list):
        return [_strip(x) for x in d]
    return d


def _sig(doc: dict) -> tuple:
    return (doc.get("ok"), doc.get("fingerprint"),
            doc.get("mrc_digest"), doc.get("engine_used"))


def _mixed_lines() -> list[str]:
    """tests/test_fabric.py's set: 3 solo fingerprints, a byte-different
    duplicate of fb-0 and an inline program that is fb-0's structural
    twin; fb-1 carries a client trace id."""
    base = {"model": "gemm", "n": 16, "engine": "sampled", "ratio": 0.2}
    lines = [
        json.dumps({**base, "seed": 7100 + k, "threads": 2 + (k % 3),
                    "id": f"fb-{k}",
                    **({"trace_id": TRACE_PIN} if k == 1 else {})})
        for k in range(3)
    ]
    lines.append(json.dumps({**base, "seed": 7100, "threads": 2,
                             "id": "fb-dup"}))
    lines.append(json.dumps({
        "id": "fb-custom",
        "program": program_to_json(build("gemm", 16)),
        "engine": "sampled", "ratio": 0.2, "seed": 7100, "threads": 2,
    }))
    return lines


LINES = _mixed_lines()


def _service(pkg, i=None, **kw):
    if pkg is TS:
        kw["device"] = "cpu"
    return pkg.AnalysisService(max_workers=2, worker_id=i, **kw)


def _run_fabric(pkg, fab, cfg, n_workers: int, cache_dir, lines,
                solo: bool = False, ledger: str | None = None,
                probe: dict | None = None, **svc_kw) -> dict:
    """Serve `lines` through an in-process router over n real worker
    stacks of package `pkg`; returns {id: response doc}. solo=True
    submits one line at a time (each awaited before the next)."""
    services = [
        _service(pkg, i, cache_dir=(None if cache_dir is None
                                    else str(cache_dir)),
                 ledger_path=ledger, **svc_kw)
        for i in range(n_workers)
    ]
    workers = []
    try:
        for i, svc in enumerate(services):
            ws = fab.WorkerServer(svc, worker_id=i, fabric=cfg)
            ws.start()
            workers.append(ws)
        router = fab.Router([ws.address for ws in workers], cfg,
                            ledger_path=ledger)
        router.start()
        try:
            if solo:
                docs = []
                for no, ln in enumerate(lines, start=1):
                    doc = router.submit_line(ln, no).wait(
                        timeout=TIMEOUT_S)
                    assert doc is not None
                    docs.append(doc)
            else:
                fout = io.StringIO()
                router.serve_stream(
                    io.StringIO("\n".join(lines) + "\n"), fout)
                docs = [json.loads(ln)
                        for ln in fout.getvalue().splitlines()]
            if probe is not None:
                probe["stats"] = router.fleet_stats(refresh=True)
                probe["prometheus"] = router.fleet_prometheus_text()
        finally:
            router.close(graceful=True)
    finally:
        for ws in workers:
            ws.close()
        for svc in services:
            svc.close()
    assert len(docs) == len(lines)
    return {d["id"]: d for d in docs}


def _direct(pkg, lines, cache_dir=None, **kw) -> dict:
    with _service(pkg, cache_dir=cache_dir, **kw) as svc:
        fout = io.StringIO()
        pkg.serve_jsonl(svc, io.StringIO("\n".join(lines) + "\n"), fout)
    return {d["id"]: d for d in
            (json.loads(ln) for ln in fout.getvalue().splitlines())}


@pytest.fixture(scope="module")
def jax_answers(tmp_path_factory):
    """The JAX service's and the JAX 3-worker fabric's answers to
    LINES, cold."""
    tmp = tmp_path_factory.mktemp("jax_fabric")
    direct = _direct(JS, LINES, str(tmp / "direct"))
    fabric = _run_fabric(JS, JF, J_CFG, 3, tmp / "store", LINES)
    return direct, fabric


@pytest.fixture(scope="module")
def fabric3_cold(tmp_path_factory):
    """ONE cold 3-worker ledger-backed port fabric run, read by the bit
    identity and the tracing/fleet tests (tracing on, fb-1 with a
    client trace id)."""
    tmp = tmp_path_factory.mktemp("fabric3")
    ledger = str(tmp / "ledger.jsonl")
    probe: dict = {}
    docs = _run_fabric(TS, TF, T_CFG, 3, tmp / "store", LINES,
                       ledger=ledger, probe=probe)
    return {"store": tmp / "store", "ledger": ledger, "docs": docs,
            "probe": probe}


def test_fabric_config_is_the_jax_packages():
    assert inspect.getsource(TC.FabricConfig) == \
        inspect.getsource(JC.FabricConfig)
    assert dataclasses.asdict(TC.FabricConfig()) == \
        dataclasses.asdict(JC.FabricConfig())
    assert TF.__all__ == JF.__all__
    assert (TF.WIRE_VERSION, TF.MAX_FRAME_BYTES) == \
        (JF.WIRE_VERSION, JF.MAX_FRAME_BYTES)


# -- wire framing ------------------------------------------------------


def _pair(fab):
    a, b = socket.socketpair()
    return fab.wire.Conn(a), fab.wire.Conn(b)


@pytest.mark.parametrize("fab", [TF, JF], ids=["port", "jax"])
def test_wire_roundtrip_and_eof_semantics(fab):
    ca, cb = _pair(fab)
    ca.send({"type": "ping", "t": 7})
    ca.send({"type": "request", "seq": 1, "line": "x" * 2048})
    assert cb.recv(timeout=5) == {"type": "ping", "t": 7}
    assert cb.recv(timeout=5)["seq"] == 1
    ca.close()
    assert cb.recv(timeout=5) is None
    cb.close()
    # the same bytes on the wire from either package
    assert TF.encode_frame({"a": [1, "x"]}) == JF.encode_frame(
        {"a": [1, "x"]})


def test_wire_refuses_oversized_and_malformed_frames():
    wire = TF.wire
    ca, cb = _pair(TF)
    with pytest.raises(wire.FrameTooLarge):
        ca.send({"pad": "x" * (wire.MAX_FRAME_BYTES + 16)})
    ca._sock.sendall(struct.pack(">I", wire.MAX_FRAME_BYTES + 1))
    with pytest.raises(wire.FrameTooLarge):
        cb.recv(timeout=5)
    ca.close()
    cb.close()
    ca, cb = _pair(TF)
    ca._sock.sendall(struct.pack(">I", 8) + b"not-json")
    with pytest.raises(wire.WireError):
        cb.recv(timeout=5)
    ca.close()
    cb.close()
    ca, cb = _pair(TF)
    ca._sock.sendall(struct.pack(">I", 64) + b"partial")
    ca.close()
    with pytest.raises(wire.ConnectionClosed):
        cb.recv(timeout=5)
    cb.close()


@pytest.mark.parametrize("spec", ["10.0.0.2:80", ":9100", "localhost:1",
                                  "nope", "host:", "host:abc"])
def test_parse_hostport(spec):
    def answer(fn):
        try:
            return fn(spec)
        except ValueError as e:
            return ("ValueError", str(e))

    assert answer(TF.parse_hostport) == answer(JF.parse_hostport)


# -- the tentpole invariant --------------------------------------------


def test_bit_identity_1_vs_3_workers_cold_warm_solo_batched(
        tmp_path, jax_answers, fabric3_cold):
    """Same bytes whatever the topology or the package: the JAX service
    and JAX fabric, the port's service, 1-worker and 3-worker fabrics
    cold, warm streamed, warm one at a time with tracing off, and cold
    with a batch window (the per-row batched engine)."""
    j_direct, j_fabric = jax_answers
    want = {i: _sig(d) for i, d in j_direct.items()}
    assert all(d["ok"] for d in j_direct.values())
    assert j_direct["fb-dup"]["fingerprint"] \
        == j_direct["fb-custom"]["fingerprint"] \
        == j_direct["fb-0"]["fingerprint"]
    store = fabric3_cold["store"]
    runs = {
        "jax-3w-cold": j_fabric,
        "port-direct": _direct(TS, LINES),
        "port-1w-cold": _run_fabric(TS, TF, T_CFG, 1, tmp_path / "f1",
                                    LINES),
        "port-3w-cold": fabric3_cold["docs"],
        "port-3w-warm": _run_fabric(TS, TF, T_CFG, 3, store, LINES),
        "port-3w-warm-solo-notrace": _run_fabric(
            TS, TF, dataclasses.replace(T_CFG, trace_enabled=False), 3,
            store, LINES, solo=True),
        "port-2w-cold-window": _run_fabric(
            TS, TF, T_CFG, 2, tmp_path / "fw", LINES,
            batch_window_ms=20),
    }
    for tag, docs in runs.items():
        assert {i: _sig(d) for i, d in docs.items()} == want, tag
        if tag.startswith("port-") and tag != "port-direct":
            assert all("worker_id" in d for d in docs.values()), tag
    for tag in ("port-3w-warm", "port-3w-warm-solo-notrace"):
        assert all(d["cache"] != "miss" for d in runs[tag].values()), tag
    # 3 workers: affinity keeps equal fingerprints on one worker, as in
    # the JAX fabric
    for docs in (runs["port-3w-cold"], j_fabric):
        by_fp: dict = {}
        for d in docs.values():
            by_fp.setdefault(d["fingerprint"], set()).add(d["worker_id"])
        assert all(len(ws) == 1 for ws in by_fp.values())
    assert {i: d["worker_id"] for i, d in runs["port-3w-cold"].items()} \
        == {i: d["worker_id"] for i, d in j_fabric.items()}


# -- router edge cases -------------------------------------------------


def _edge_docs(pkg, fab, cfg, tmp):
    with _service(pkg, cache_dir=str(tmp)) as svc:
        ws = fab.WorkerServer(svc, worker_id=0, fabric=cfg)
        ws.start()
        router = fab.Router([ws.address], cfg)
        router.start()
        try:
            big = ('{"id": "big-id", "model": "gemm", "pad": "'
                   + "x" * (pkg.api.MAX_REQUEST_LINE_BYTES + 64) + '"}')
            docs = [router.submit_line(big, 1).wait(timeout=30)]
            routed = router.counters["routed"]
            for no, line in ((2, '{"id": "mal", "model": '),
                             (3, '{"id": "uf", "model": "gemm", '
                                 '"bogus": 1}'),
                             (4, '{"id": "hz", "type": "healthz"}')):
                docs.append(router.submit_line(line, no).wait(timeout=60))
        finally:
            router.close(graceful=True)
            ws.close()
    return docs, routed


def test_router_oversized_and_malformed_lines(tmp_path):
    t_docs, t_routed = _edge_docs(TS, TF, T_CFG, tmp_path / "t")
    j_docs, j_routed = _edge_docs(JS, JF, J_CFG, tmp_path / "j")
    assert t_routed == j_routed == 0
    t_hz, j_hz = t_docs.pop(), j_docs.pop()
    assert _strip(t_docs) == _strip(j_docs)
    big, mal, uf = t_docs
    assert big["id"] == "big-id" and not big["ok"]
    assert mal["id"] is None and "invalid JSON" in mal["error"]
    assert uf["id"] == "uf" and "bogus" in uf["error"]
    # the router answers healthz itself; only its address differs
    for hz in (t_hz, j_hz):
        hz["healthz"]["workers"]["0"].pop("addr")
        hz["healthz"]["workers"]["0"].pop("rtt_p95_s")
        hz["healthz"]["workers"]["0"].pop("last_pong_age_s")
    assert t_hz == j_hz


def test_worker_rejects_handshake_version_mismatch():
    wire = TF.wire
    with _service(TS, cache_dir=None) as svc:
        ws = TF.WorkerServer(svc, worker_id=0, fabric=T_CFG)
        host, port = ws.start()
        try:
            conn = wire.connect(host, port, timeout=5)
            conn.send({"type": "hello", "wire_version": 99})
            reply = conn.recv(timeout=10)
            assert reply["type"] == "error"
            assert "wire version mismatch" in reply["error"]
            assert reply["wire_version"] == JF.WIRE_VERSION
            try:
                assert conn.recv(timeout=10) is None
            except wire.ConnectionClosed:
                pass
            conn.close()
            assert ws.stats_counters["handshake_rejected"] == 1
        finally:
            ws.close()


# -- TCP front + the loadgen twin ---------------------------------------


def test_tcp_front_loadgen_connect_and_hostile_lines(tmp_path, capsys):
    """The router's JSONL TCP front: the loadgen twin's connect_run (and
    its --connect command line) get every response back by id, equal to
    the JAX service's for the JAX loadgen's requests, and hostile client
    lines are answered in-stream without killing the connection."""
    from pluss_sampler_optimization_torch.tools import loadgen

    spec = importlib.util.spec_from_file_location(
        "jax_tools_loadgen", os.path.join(ROOT, "tools", "loadgen.py"))
    j_loadgen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_loadgen)
    reqs = loadgen.make_requests(3, seed=5)
    assert [loadgen.request_jsonl(r) for r in reqs] == \
        [j_loadgen.request_jsonl(r) for r in j_loadgen.make_requests(
            3, seed=5)]
    offs = loadgen.arrival_offsets(3, 200.0, seed=5)
    with _service(TS, cache_dir=str(tmp_path / "c"),
                  ledger_path=str(tmp_path / "l.jsonl")) as svc:
        ws = TF.WorkerServer(svc, worker_id=0, fabric=T_CFG)
        ws.start()
        router = TF.Router([ws.address], T_CFG)
        router.start()
        host, port = router.serve_tcp("127.0.0.1", 0)
        try:
            report = loadgen.connect_run(f"{host}:{port}", reqs, offs,
                                         timeout_s=TIMEOUT_S)
            assert report["submitted"] == 3 and report["ok"] == 3
            assert report["failed"] == 0 and report["missing"] == 0
            assert report["latency_p95_s"] is not None
            assert report["overhead_p50_s"] is not None
            assert loadgen.main(["--connect", f"{host}:{port}",
                                 "--requests", "3", "--seed", "5",
                                 "--rate", "200"]) == 0
            printed = json.loads(capsys.readouterr().out)
            assert printed["ok"] == 3 and printed["connect"] == \
                f"{host}:{port}"

            sock = socket.create_connection((host, port), timeout=10)
            rf = sock.makefile("r", encoding="utf-8")
            wf = sock.makefile("w", encoding="utf-8")
            wf.write('{"id": "bad-json", "model": \n')
            wf.write(json.dumps({"id": "hz", "type": "healthz"}) + "\n")
            wf.flush()
            got = [json.loads(rf.readline()) for _ in range(2)]
            bad = [d for d in got if not d.get("ok")]
            assert len(bad) == 1 and bad[0]["id"] is None
            assert "invalid JSON" in bad[0]["error"]
            hz = [d for d in got if d.get("id") == "hz"][0]
            assert hz["ok"] and hz["healthz"]["role"] == "router"
            sock.close()
        finally:
            router.close(graceful=True)
            ws.close()
    # what the fabric served is what the JAX service computes
    served = {(r["fingerprint"], r["mrc_digest"]) for r in
              t_ledger.read_rows(str(tmp_path / "l.jsonl"))
              if r.get("kind") == "request"}
    j_direct = _direct(JS, [loadgen.request_jsonl(r) for r in reqs])
    assert served == {(d["fingerprint"], d["mrc_digest"])
                      for d in j_direct.values()}
    assert len(served) == 3


# -- fabric-wide tracing & fleet telemetry ------------------------------


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_propagation_fleet_stats_and_assembly(fabric3_cold, tmp_path,
                                                   capsys):
    from pluss_sampler_optimization_torch.tools import (
        assemble_trace,
        check_ledger,
    )

    docs = fabric3_cold["docs"]
    assert all(d["ok"] for d in docs.values())
    assert all(d.get("execute_s") is not None for d in docs.values())
    fs = fabric3_cold["probe"]["stats"]
    assert fs["role"] == "router"
    assert fs["fleet"]["workers"] == 3
    per = [w["executor"]["submitted"] for w in fs["worker_stats"].values()]
    assert fs["fleet"]["executor"]["submitted"] == sum(per) == len(LINES)
    assert "pluss_fabric_workers_up 3" in fabric3_cold["probe"]["prometheus"]

    rows = t_ledger.read_rows(fabric3_cold["ledger"])
    router_rows = [r for r in rows
                   if r.get("source") == t_ledger.ROUTER_SOURCE]
    worker_rows = [r for r in rows if r.get("kind") == "request"
                   and r.get("worker_id") is not None]
    assert len(router_rows) == len(LINES)
    assert all("worker_id" not in r for r in router_rows)
    assert all(r["router"]["worker_id"] in (0, 1, 2) for r in router_rows)
    assert check_ledger.check_trace_join(rows) == []
    assert check_ledger.check_worker_sharding(rows, ring_workers=3) == []
    assert any(r["trace_id"] == TRACE_PIN for r in router_rows)
    assert any(r.get("trace_id") == TRACE_PIN for r in worker_rows)

    traces = t_fleet.assemble_traces(rows)
    assert traces == j_fleet.assemble_traces(rows)
    assert set(traces) == {r["trace_id"] for r in router_rows}
    names = [ev["name"] for ev in traces[TRACE_PIN]["traceEvents"]]
    assert names[2:8] == ["request", "router_queue", "route",
                          "worker_rtt", "wire_out", "wire_back"]
    assert "worker" in names and "execute" in names

    # the assemble_trace twin prints and writes the JAX tool's bytes
    j_tool = _jax_tool("assemble_trace")
    outs = []
    for tag, main in (("t", assemble_trace.main), ("j", j_tool.main)):
        d = tmp_path / tag
        assert main([fabric3_cold["ledger"], "--list"]) == 0
        assert main([fabric3_cold["ledger"]]) == 0
        assert main([fabric3_cold["ledger"], "--trace-id", TRACE_PIN,
                     "--out", str(tmp_path / f"{tag}.json")]) == 0
        assert main([fabric3_cold["ledger"], "--out-dir", str(d)]) == 0
        assert main([fabric3_cold["ledger"], "--trace-id", "f" * 16]) == 1
        text = capsys.readouterr()
        files = {p: (d / p).read_bytes() for p in sorted(os.listdir(d))}
        outs.append((text.out.replace(str(tmp_path / tag), "D"),
                     text.err, (tmp_path / f"{tag}.json").read_bytes(),
                     files))
    assert outs[0] == outs[1]
    assert len(outs[0][3]) == len(traces)


def test_assemble_chrome_trace_golden():
    """tests/test_fabric.py's pinned layout, through both packages'
    fleet modules: the same events and the same bytes."""
    router_row = {
        "trace_id": "feedface00000001", "span_id": "r1",
        "fingerprint": "fp", "model": "gemm",
        "engine_requested": "sampled", "ok": True, "cache": "miss",
        "latency_s": 0.01, "source": "fabric.router",
        "router": {"worker_id": 1, "hops": 1,
                   "router_queue_s": 0.001, "route_s": 0.0005,
                   "worker_rtt_s": 0.008, "worker_s": 0.006,
                   "wire_s": 0.002, "wire_out_s": 0.001,
                   "wire_back_s": 0.001},
    }
    worker_row = {"worker_id": 1, "span_id": "w1", "cache": "miss",
                  "latency_s": 0.006, "queue_s": 0.001,
                  "execute_s": 0.005}
    doc = t_fleet.assemble_chrome_trace(router_row, [worker_row])
    assert doc == j_fleet.assemble_chrome_trace(router_row, [worker_row])
    spans = [(e["name"], e["ts"], e["dur"])
             for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert spans == [
        ("request", 0.0, 10000.0), ("router_queue", 0.0, 1000.0),
        ("route", 1000.0, 500.0), ("worker_rtt", 1500.0, 8000.0),
        ("wire_out", 1500.0, 1000.0), ("wire_back", 8500.0, 1000.0),
        ("worker", 2500.0, 6000.0), ("queue", 2500.0, 1000.0),
        ("execute", 3500.0, 5000.0),
    ]
    assert t_fleet.trace_text(doc) == j_fleet.trace_text(doc)


# -- progressive partial streaming ---------------------------------------


def _prog_line(i: int, seed=None) -> str:
    return json.dumps({
        "id": f"pp-{i}", "model": "gemm", "n": 16, "engine": "sampled",
        "ratio": 0.2, "seed": 7600 + i if seed is None else seed,
        "tolerance": 0.0, "max_rounds": 3,
    })


def test_fabric_streams_partials_interleaved_and_failover():
    """Progressive requests through a 2-worker port fabric: every
    partial forwards with its request's id, rounds 1..3 in order per id
    however the requests interleave, the final digests equal the JAX
    service's, and after worker 0 dies (bounded reconnect, re-dispatch)
    partials still stream under the right id from the survivor."""
    services = [_service(TS, i, cache_dir=None) for i in range(2)]
    workers = []
    partials: list = []
    plock = threading.Lock()

    def on_partial(doc):
        with plock:
            partials.append(dict(doc))

    lines = [_prog_line(i) for i in range(4)]
    try:
        for i, svc in enumerate(services):
            ws = TF.WorkerServer(svc, worker_id=i, fabric=T_CFG)
            ws.start()
            workers.append(ws)
        router = TF.Router([ws.address for ws in workers], T_CFG)
        router.start()
        try:
            entries = [router.submit_line(ln, no, on_partial=on_partial)
                       for no, ln in enumerate(lines, start=1)]
            docs = [e.wait(timeout=TIMEOUT_S) for e in entries]
            assert all(d is not None and d.get("ok") for d in docs)
            assert all(d.get("converged") for d in docs)
            assert router.counters["partials_dropped_stale"] == 0
            assert router.counters["partials_forwarded"] == len(partials)
            per: dict = {}
            for p in partials:
                assert p.get("partial") is True
                per.setdefault(p["id"], []).append(p["round"])
            assert set(per) == {f"pp-{i}" for i in range(4)}
            assert all(r == [1, 2, 3] for r in per.values())

            workers[0].close()
            with plock:
                partials.clear()
            line = _prog_line("f", seed=7650)
            doc = router.submit_line(line, 99, on_partial=on_partial
                                     ).wait(timeout=TIMEOUT_S)
            assert doc is not None and doc.get("ok")
            with plock:
                got = [p["round"] for p in partials if p["id"] == "pp-f"]
            assert got == [1, 2, 3]
            docs.append(doc)
        finally:
            router.close(graceful=True)
    finally:
        for ws in workers:
            ws.close()
        for svc in services:
            svc.close()
    j_direct = _direct(JS, lines + [line])
    assert {d["id"]: (d["fingerprint"], d["mrc_digest"]) for d in docs} \
        == {i: (d["fingerprint"], d["mrc_digest"])
            for i, d in j_direct.items() if not d.get("partial")}
