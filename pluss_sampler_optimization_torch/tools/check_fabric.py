"""CI gate for the multi-process serving fabric (service/fabric/).

The port's twin of the JAX package's tools/check_fabric.py: its phases
and lines, on the port's CLI, with every worker on --device (default
cuda; the JAX gate's --comp-cache has no counterpart, the port keeps no
compile cache). --phases runs a subset (the kill phase's victim must
have work in flight at its probe, which depends on how long the
requests take: the card's requests, not the CPU tests'), --requests
FILE serves that JSONL batch instead of the built-in one, and --json
PATH writes the report: each phase's responses, seconds, each worker's
seconds from spawn to its ready line (and, on CUDA, to load its context
and kernel libraries), and the router's link reconnects and
re-dispatches.

The fabric's contract is that sharding is INVISIBLE in the results:
a request set served by a router over N workers yields the same
fingerprints and the same MRC bytes as the single-process stack,
cold and warm, and the consistent-hash assignment is a pure function
of the worker-id set (stable across restarts). This gate pins all of
that against REAL processes — the `serve-router --workers N`
supervisor spawning full CLI worker subprocesses — because the
in-process tests (tests/test_fabric.py) can't catch what only
process boundaries break: argv forwarding, the ready-line handshake,
shared-ledger appends, signal handling, and orphaned children.

Phases (each on a mixed solo/duplicate/custom-program request set):

  identity      the same batch through 1 worker and through 2
                workers: per-id (ok, fingerprint, mrc_digest)
                identical — sharding changed no bytes
  warm          the 2-worker run repeated over its own disk cache:
                identical digests again, zero cache misses
  restarts      fingerprint->worker assignment read back from the
                two 2-worker runs' ledgers is identical, and every
                row sits on its ring assignment
                (tools/check_ledger.py::check_worker_sharding)
  kill          a 3-worker fabric on the TCP front: the busiest
                worker is SIGKILLed mid-load; every request still
                resolves exactly once, ok responses stay
                bit-identical, and re-dispatched ones record the
                worker_disconnect hop; SIGTERM then drains the rest
  fleet         a 2-worker fabric on the TCP front with tracing and
                a flight recorder: after the batch, the router's
                ledger rows JOIN every worker row on trace_id
                (tools/check_ledger.py::check_trace_join and one
                assembled Chrome trace per request), the `metrics`
                control line's merged counters equal the sum of its
                per-worker sections, and `dump_debug` fans out — one
                bundle per worker plus the router's own
  orphans       after every phase, no worker process survives its
                router

    python -m pluss_sampler_optimization_torch.tools.check_fabric
        [--device cuda|cpu] [--phases identity,warm,restarts,kill,fleet]
        [--requests FILE] [--json PATH] [--keep]

Wired into tier-1 (without the kill phase) by tests/test_torch_fabric.py.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time

from pluss_sampler_optimization_torch.tools import check_ledger

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
)))

RUN_TIMEOUT_S = 300.0
_READY_RE = re.compile(
    r"serve-router: worker (\d+) up at \S+ \(pid (\d+)\)"
)
_SPAWN_RE = re.compile(
    r"serve-router: worker (\d+) ready ([0-9.]+)s after spawn"
)
_WARM_RE = re.compile(
    r"serve-worker: worker (\d+): CUDA context and kernel libraries "
    r"loaded in ([0-9.]+)s"
)
_TCP_RE = re.compile(r"JSONL TCP front on (\S+):(\d+)")
PHASES = ("identity", "warm", "restarts", "kill", "fleet")
# the run's device (--device) and what each phase saw (--json)
DEVICE = ["cuda"]
REPORT: dict = {}


def request_lines() -> list[str]:
    """The mixed batch: 6 solo sampled requests with distinct
    fingerprints, 2 byte-different duplicates of solo-0 (they must
    coalesce/cache-hit ON solo-0's owning worker), and one inline
    custom-program request that is the structural twin of solo-0
    (same fingerprint through the frontend path)."""
    from pluss_sampler_optimization_torch.frontend import (
        program_to_json,
    )
    from pluss_sampler_optimization_torch.models import build

    base = {"model": "gemm", "n": 16, "engine": "sampled",
            "ratio": 0.2}
    lines = [
        json.dumps({**base, "seed": 4200 + k,
                    "threads": 2 + (k % 3), "id": f"cf-solo-{k}"})
        for k in range(6)
    ]
    for d in range(2):
        lines.append(json.dumps({**base, "seed": 4200, "threads": 2,
                                 "id": f"cf-dup-{d}"}))
    lines.append(json.dumps({
        "id": "cf-custom", "program": program_to_json(build("gemm", 16)),
        "engine": "sampled", "ratio": 0.2, "seed": 4200, "threads": 2,
    }))
    return lines


def _env() -> dict:
    return dict(os.environ)


def _cmd(n_workers: int, cache: str, ledger: str) -> list[str]:
    return [
        sys.executable, "-m", "pluss_sampler_optimization_torch.cli",
        "serve-router", "--workers", str(n_workers),
        "--cache-dir", cache, "--ledger", ledger,
        "--device", DEVICE[0],
        "--batch-window-ms", "5",
    ]


def _note(tag: str, t0: float, err: str, docs: dict,
          stats: dict | None = None) -> None:
    """One phase's entry in the --json report."""
    REPORT[tag] = {
        "seconds": round(time.perf_counter() - t0, 3),
        "ready_s": {int(w): float(s) for w, s in _SPAWN_RE.findall(err)},
        "warm_s": {int(w): float(s) for w, s in _WARM_RE.findall(err)},
        "redispatched": sorted(
            i for i, d in docs.items()
            if any(isinstance(g, dict)
                   and g.get("reason") == "worker_disconnect"
                   for g in (d.get("degraded") or []))
        ),
        "docs": {i: {k: d.get(k) for k in
                     ("ok", "fingerprint", "mrc_digest", "cache",
                      "worker_id", "latency_s", "execute_s")}
                 for i, d in docs.items()},
        "router": stats,
    }


def run_batch(tag: str, n_workers: int, lines: list[str], tmp: str,
              cache: str | None = None,
              problems: list | None = None) -> dict:
    """One supervisor run over the request file; returns {id: doc}."""
    cache = cache or os.path.join(tmp, f"cache_{tag}")
    reqs = os.path.join(tmp, f"reqs_{tag}.jsonl")
    with open(reqs, "w") as f:
        f.write("\n".join(lines) + "\n")
    cmd = _cmd(n_workers, cache, os.path.join(tmp, f"ledger_{tag}.jsonl")
               ) + ["--requests", reqs]
    t0 = time.perf_counter()
    proc = subprocess.run(
        cmd, cwd=REPO, env=_env(), capture_output=True, text=True,
        timeout=RUN_TIMEOUT_S,
    )
    if proc.returncode != 0 and problems is not None:
        problems.append(
            f"{tag}: serve-router exited {proc.returncode}: "
            f"{proc.stderr[-800:]}"
        )
    docs = {}
    for ln in proc.stdout.splitlines():
        if ln.strip():
            doc = json.loads(ln)
            docs[doc.get("id")] = doc
    _note(tag, t0, proc.stderr, docs)
    return docs


def _sig(doc: dict) -> tuple:
    return (doc.get("ok"), doc.get("fingerprint"),
            doc.get("mrc_digest"))


def _compare(tag: str, want: dict, got: dict, problems: list) -> None:
    ids = sorted(want)
    if sorted(got) != ids:
        problems.append(f"{tag}: response ids {sorted(got)} != {ids}")
        return
    diff = {
        i: (_sig(got[i]), _sig(want[i]))
        for i in ids if _sig(got[i]) != _sig(want[i])
    }
    if diff:
        problems.append(
            f"{tag}: (ok, fingerprint, mrc_digest) diverged from the "
            f"1-worker reference: {diff}"
        )


def _ledger_assignment(path: str, problems: list, tag: str,
                       n_workers: int) -> dict:
    """fingerprint -> worker_id from a fabric run's ledger, plus the
    ring-sharding validation over the same rows."""
    rows = []
    with open(path) as f:
        for ln in f:
            if ln.strip():
                rows.append(json.loads(ln))
    got = {}
    for row in rows:
        if row.get("kind") == "request" and \
                row.get("worker_id") is not None:
            prev = got.setdefault(row["fingerprint"],
                                  int(row["worker_id"]))
            if prev != int(row["worker_id"]):
                problems.append(
                    f"{tag}: fingerprint {row['fingerprint'][:16]}... "
                    f"served by workers {prev} AND {row['worker_id']} "
                    "in one run (affinity broken)"
                )
    for v in check_ledger.check_worker_sharding(
            rows, ring_workers=n_workers):
        problems.append(f"{tag}: {v}")
    if not got:
        problems.append(f"{tag}: ledger {path} has no attributed "
                        "request rows")
    return got


def orphan_pids(token: str) -> list[int]:
    """PIDs of surviving processes whose cmdline carries `token`
    (the run's unique tmp path — matches only our workers)."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmdline = f.read().decode("utf-8", "replace")
        except OSError:
            continue
        if token in cmdline and "serve-" in cmdline:
            out.append(int(pid))
    return out


def _no_orphans(tag: str, token: str, problems: list) -> None:
    for _ in range(20):  # children may still be mid-reap
        pids = orphan_pids(token)
        if not pids:
            return
        time.sleep(0.25)
    problems.append(f"{tag}: orphaned fabric process(es) survived: "
                    f"{pids}")
    for pid in pids:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass


def _router_stats(rf, wf, tag: str) -> dict | None:
    """The router's own counters and links, from a `stats` control
    line on the TCP front: re-dispatches and per-link reconnects (a
    heartbeat timeout is a reconnect)."""
    wf.write(json.dumps({"id": f"cf-{tag}-stats", "type": "stats"})
             + "\n")
    wf.flush()
    doc = json.loads(rf.readline())
    st = doc.get("stats") or {}
    return {
        "redispatched": (st.get("counters") or {}).get("redispatched"),
        "reconnects": {
            w: s.get("reconnects")
            for w, s in (st.get("workers") or {}).items()
        },
    }


def check_kill_redispatch(lines: list[str], reference: dict,
                          tmp: str, problems: list) -> None:
    """The live-fire phase: a 3-worker fabric on the TCP front, the
    busiest worker SIGKILLed while its requests are in flight."""
    err_path = os.path.join(tmp, "kill_router.err")
    t0 = time.perf_counter()
    cmd = _cmd(3, os.path.join(tmp, "cache_kill"),
               os.path.join(tmp, "ledger_kill.jsonl")
               ) + ["--listen", "127.0.0.1:0"]
    with open(err_path, "w") as errf:
        router = subprocess.Popen(
            cmd, cwd=REPO, env=_env(), stdout=subprocess.DEVNULL,
            stderr=errf, text=True,
        )
    try:
        addr, pids = None, {}
        deadline = time.time() + RUN_TIMEOUT_S
        while time.time() < deadline and addr is None:
            text = open(err_path).read()
            for wid, pid in _READY_RE.findall(text):
                pids[int(wid)] = int(pid)
            m = _TCP_RE.search(text)
            if m:
                addr = (m.group(1), int(m.group(2)))
                break
            if router.poll() is not None:
                problems.append(
                    f"kill: router died during startup: {text[-800:]}"
                )
                return
            time.sleep(0.25)
        if addr is None or len(pids) != 3:
            problems.append(f"kill: fabric never came up "
                            f"(addr={addr}, workers={sorted(pids)})")
            return

        sock = socket.create_connection(addr, timeout=30.0)
        rf = sock.makefile("r", encoding="utf-8")
        wf = sock.makefile("w", encoding="utf-8")
        for ln in lines:
            wf.write(ln + "\n")
        wf.write(json.dumps({"id": "cf-hz", "type": "healthz"}) + "\n")
        wf.flush()

        want = {json.loads(ln)["id"] for ln in lines}
        docs: dict = {}
        victim = None
        sock.settimeout(RUN_TIMEOUT_S)
        while len(docs) < len(want):
            doc = json.loads(rf.readline())
            if doc.get("id") == "cf-hz":
                # pick the worker with the most in-flight work — the
                # kill must provably strand requests for re-dispatch
                workers = doc.get("healthz", {}).get("workers", {})
                victim = max(
                    workers,
                    key=lambda w: workers[w]["in_flight"],
                )
                if workers[victim]["in_flight"] < 1:
                    problems.append(
                        "kill: no worker had in-flight work at the "
                        f"healthz probe ({workers}) — the kill phase "
                        "proved nothing; slow the requests down"
                    )
                os.kill(pids[int(victim)], signal.SIGKILL)
                continue
            if doc.get("id") in want and doc["id"] not in docs:
                docs[doc["id"]] = doc
            elif doc.get("id") in docs:
                problems.append(f"kill: duplicate response for "
                                f"{doc['id']} (exactly-once violated)")
        stats = _router_stats(rf, wf, "kill")
        sock.close()
        _note("kill", t0, open(err_path).read(), docs, stats)

        _compare("kill", reference, docs, problems)
        hopped = [
            i for i, d in docs.items()
            if any(isinstance(g, dict)
                   and g.get("reason") == "worker_disconnect"
                   for g in (d.get("degraded") or []))
        ]
        if not hopped:
            problems.append(
                "kill: a worker died with work in flight but no "
                "response records a worker_disconnect re-dispatch hop"
            )
        else:
            print(f"check_fabric: kill: worker {victim} SIGKILLed, "
                  f"{len(hopped)} request(s) re-dispatched "
                  f"({sorted(hopped)})")
        survivors = [d.get("worker_id") for d in docs.values()
                     if d.get("id") in hopped]
        if victim is not None and int(victim) in survivors:
            problems.append(
                f"kill: re-dispatched requests still attribute dead "
                f"worker {victim}"
            )

        router.send_signal(signal.SIGTERM)
        try:
            rc = router.wait(timeout=90.0)
        except subprocess.TimeoutExpired:
            problems.append("kill: router did not drain on SIGTERM")
            router.kill()
            router.wait(timeout=10.0)
            return
        if rc != 0:
            problems.append(
                f"kill: router exited {rc} after SIGTERM drain: "
                f"{open(err_path).read()[-800:]}"
            )
    finally:
        if router.poll() is None:
            router.kill()
            router.wait(timeout=10.0)


def check_fleet_observability(lines: list[str], reference: dict,
                              tmp: str, problems: list) -> None:
    """The fleet-telemetry phase: a 2-worker fabric on the TCP front
    with tracing on and the flight recorder armed. Runs the batch,
    then asserts (1) the shared ledger's trace join — every worker
    row's trace_id appears in a router row, and every request
    assembles into a Chrome trace from ledger rows alone; (2) the
    merged `metrics` view is consistent — fleet counters equal the
    sum of the per-worker sections; (3) `dump_debug` fans out — a
    bundle per worker plus the router's own."""
    from pluss_sampler_optimization_torch.runtime.obs import fleet

    err_path = os.path.join(tmp, "fleet_router.err")
    ledger_path = os.path.join(tmp, "ledger_fleet.jsonl")
    bundle_dir = os.path.join(tmp, "bundles_fleet")
    # reuse the identity phase's warm disk cache: the batch is all
    # hits, so this phase pays only process startup — trace spans and
    # ledger rows are written for hits exactly as for misses
    t0 = time.perf_counter()
    cmd = _cmd(2, os.path.join(tmp, "cache_w2"), ledger_path) + [
        "--listen", "127.0.0.1:0",
        "--debug-bundle-dir", bundle_dir,
    ]
    with open(err_path, "w") as errf:
        router = subprocess.Popen(
            cmd, cwd=REPO, env=_env(), stdout=subprocess.DEVNULL,
            stderr=errf, text=True,
        )
    try:
        addr = None
        deadline = time.time() + RUN_TIMEOUT_S
        while time.time() < deadline:
            text = open(err_path).read()
            m = _TCP_RE.search(text)
            if m:
                addr = (m.group(1), int(m.group(2)))
                break
            if router.poll() is not None:
                problems.append(
                    f"fleet: router died during startup: {text[-800:]}"
                )
                return
            time.sleep(0.25)
        if addr is None:
            problems.append("fleet: TCP front never came up")
            return

        sock = socket.create_connection(addr, timeout=30.0)
        rf = sock.makefile("r", encoding="utf-8")
        wf = sock.makefile("w", encoding="utf-8")
        want = {json.loads(ln)["id"] for ln in lines}
        for ln in lines:
            wf.write(ln + "\n")
        wf.flush()
        docs: dict = {}
        sock.settimeout(RUN_TIMEOUT_S)
        while len(docs) < len(want):
            doc = json.loads(rf.readline())
            if doc.get("id") in want:
                docs[doc["id"]] = doc
        _compare("fleet", reference, docs, problems)

        # batch settled — now the control plane, one line per kind
        control: dict = {}
        for kind in ("stats", "metrics", "dump_debug"):
            wf.write(json.dumps({"id": f"cf-{kind}", "type": kind})
                     + "\n")
            wf.flush()
            doc = json.loads(rf.readline())
            if not doc.get("ok"):
                problems.append(f"fleet: {kind} control line failed: "
                                f"{doc.get('error')}")
                return
            control[kind] = doc[kind]
        stats = _router_stats(rf, wf, "fleet")
        sock.close()
        _note("fleet", t0, open(err_path).read(), docs, stats)

        st = control["stats"]
        if len(st.get("worker_stats") or {}) != 2:
            problems.append(
                "fleet: stats did not report both workers: "
                f"{sorted(st.get('worker_stats') or {})}"
            )
        fleet_sub = (st.get("fleet", {}).get("executor", {})
                     .get("submitted"))
        per_sub = sum(
            w.get("executor", {}).get("submitted", 0)
            for w in (st.get("worker_stats") or {}).values()
        )
        if fleet_sub != per_sub or not per_sub:
            problems.append(
                f"fleet: stats fleet.executor.submitted {fleet_sub} "
                f"!= sum of workers {per_sub}"
            )

        mx = control["metrics"]
        sums: dict = {}
        for name in ("service_submitted", "service_requests"):
            merged = (mx.get("counters") or {}).get(name)
            sums[name] = sum(
                (w.get("counters") or {}).get(name, 0)
                for w in (mx.get("workers") or {}).values()
            )
            if merged != sums[name] or not sums[name]:
                problems.append(
                    f"fleet: merged counter {name}={merged} != sum "
                    f"of per-worker sections {sums[name]}"
                )
        want_line = (
            "pluss_service_submitted_total "
            f"{float(sums['service_submitted']):g}"
        )
        if want_line not in (mx.get("prometheus") or ""):
            problems.append(
                "fleet: merged prometheus exposition does not carry "
                "the summed service_submitted"
            )

        dd = control["dump_debug"]
        worker_bundles = {
            wid: (sec or {}).get("bundle")
            for wid, sec in (dd.get("workers") or {}).items()
        }
        if len(worker_bundles) != 2 or not all(
            worker_bundles.values()
        ):
            problems.append(
                f"fleet: dump_debug did not produce a bundle on "
                f"every worker: {worker_bundles}"
            )
        if not dd.get("bundle"):
            problems.append(
                "fleet: dump_debug produced no router bundle"
            )

        router.send_signal(signal.SIGTERM)
        try:
            rc = router.wait(timeout=90.0)
        except subprocess.TimeoutExpired:
            problems.append("fleet: router did not drain on SIGTERM")
            router.kill()
            router.wait(timeout=10.0)
            return
        if rc != 0:
            problems.append(
                f"fleet: router exited {rc} after SIGTERM drain: "
                f"{open(err_path).read()[-800:]}"
            )

        for path in [p for p in worker_bundles.values() if p] + [
            dd.get("bundle")
        ]:
            if path and not os.path.exists(path):
                problems.append(
                    f"fleet: dump_debug bundle {path} missing on disk"
                )

        # the join + assembly leg: ledger rows alone reconstruct the
        # fabric's view of every request
        rows = []
        with open(ledger_path) as f:
            for ln in f:
                if ln.strip():
                    rows.append(json.loads(ln))
        for v in check_ledger.check_trace_join(rows):
            problems.append(f"fleet: {v}")
        router_rows = [
            r for r in rows
            if r.get("kind") == "request"
            and r.get("source") == "fabric.router"
        ]
        if len(router_rows) != len(lines):
            problems.append(
                f"fleet: {len(lines)} requests -> "
                f"{len(router_rows)} router ledger rows"
            )
        traces = fleet.assemble_traces(rows)
        unassembled = {
            r.get("trace_id") for r in router_rows
        } - set(traces)
        if unassembled:
            problems.append(
                f"fleet: trace(s) did not assemble: {unassembled}"
            )
        # every EXECUTED request must join a worker track; coalesced
        # duplicates legitimately ride the executing request's worker
        # row, so the floor is the distinct-fingerprint count
        with_worker = [
            tid for tid, doc in traces.items()
            if any(ev.get("pid") == 2 and ev.get("ph") == "X"
                   for ev in doc["traceEvents"])
        ]
        n_fp = len({r.get("fingerprint") for r in router_rows})
        if len(with_worker) < n_fp:
            problems.append(
                f"fleet: only {len(with_worker)} of {len(traces)} "
                f"assembled traces carry a worker track "
                f"(expected >= {n_fp} distinct fingerprints)"
            )
        print(f"check_fabric: fleet: {len(traces)} trace(s) "
              f"assembled, merged metrics consistent, "
              f"{len(worker_bundles)}+1 bundles")
    finally:
        if router.poll() is None:
            router.kill()
            router.wait(timeout=10.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="fabric CI gate: subprocess router+workers, "
        "1-vs-2-worker bit-identity, restart-stable sharding, "
        "worker-kill re-dispatch, fleet telemetry, zero orphans"
    )
    ap.add_argument("--device", default="cuda",
                    help="the workers' device: cuda (default), cuda:K "
                    "or cpu")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    f"{','.join(PHASES)} (the 1-worker reference and "
                    "the orphan checks always run)")
    ap.add_argument("--requests", default=None, metavar="FILE",
                    help="serve this JSONL batch (one request object "
                    "per line, each with a unique id) instead of the "
                    "built-in one")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the report (per phase: responses, "
                    "seconds, workers' spawn-to-ready seconds, the "
                    "router's reconnects and re-dispatches) here")
    ap.add_argument("--keep", action="store_true",
                    help="keep the scratch directory for debugging")
    args = ap.parse_args(argv)
    DEVICE[0] = args.device
    REPORT.clear()
    phases = {p for p in args.phases.split(",") if p}
    if phases - set(PHASES):
        raise SystemExit(f"unknown phase(s) {sorted(phases - set(PHASES))}"
                         f" (have {', '.join(PHASES)})")

    problems: list[str] = []
    tmp = tempfile.mkdtemp(prefix="check_fabric_")
    if args.requests:
        with open(args.requests) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
    else:
        lines = request_lines()
    t0 = time.perf_counter()
    try:
        one = run_batch("w1", 1, lines, tmp, problems=problems)
        _no_orphans("w1", tmp, problems)
        if len(one) != len(lines):
            problems.append(f"w1: {len(lines)} lines -> {len(one)} "
                            "responses")
            raise SystemExit  # reference run broken, nothing to compare
        bad = {i: d.get("error") for i, d in one.items()
               if not d.get("ok")}
        if bad:
            problems.append(f"w1: reference requests failed: {bad}")
        print(f"check_fabric: w1 reference in "
              f"{time.perf_counter() - t0:.1f}s")

        if phases & {"identity", "warm", "restarts", "fleet"}:
            # the fleet phase serves from this run's store
            two = run_batch("w2", 2, lines, tmp, problems=problems)
            _no_orphans("w2", tmp, problems)
            if "identity" in phases:
                _compare("w2-cold", one, two, problems)

        if phases & {"warm", "restarts"}:
            warm = run_batch("w2warm", 2, lines, tmp,
                             cache=os.path.join(tmp, "cache_w2"),
                             problems=problems)
            _no_orphans("w2warm", tmp, problems)
            if "warm" in phases:
                _compare("w2-warm", one, warm, problems)
                misses = [i for i, d in warm.items()
                          if d.get("ok") and d.get("cache") == "miss"]
                if misses:
                    problems.append(f"w2-warm: cache misses on a warm "
                                    f"disk cache: {misses}")

        if "restarts" in phases:
            a1 = _ledger_assignment(
                os.path.join(tmp, "ledger_w2.jsonl"), problems, "w2", 2)
            a2 = _ledger_assignment(
                os.path.join(tmp, "ledger_w2warm.jsonl"), problems,
                "w2warm", 2)
            moved = {fp: (a1[fp], a2[fp])
                     for fp in set(a1) & set(a2) if a1[fp] != a2[fp]}
            if moved:
                problems.append(
                    "restart: fingerprint->worker assignment moved "
                    f"across restarts: "
                    f"{ {k[:16]: v for k, v in moved.items()} }"
                )
        print(f"check_fabric: identity+warm+restart in "
              f"{time.perf_counter() - t0:.1f}s")

        if "kill" in phases:
            check_kill_redispatch(lines, one, tmp, problems)
            _no_orphans("kill", tmp, problems)

        if "fleet" in phases:
            check_fleet_observability(lines, one, tmp, problems)
            _no_orphans("fleet", tmp, problems)
    except SystemExit:
        pass
    finally:
        if args.keep:
            print(f"check_fabric: scratch kept at {tmp}")
        else:
            shutil.rmtree(tmp, ignore_errors=True)
    for p in problems:
        print(f"check_fabric: FAIL: {p}", file=sys.stderr)
    print(f"check_fabric: {len(problems)} problem(s) in "
          f"{time.perf_counter() - t0:.1f}s")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"problems": problems, "phases": REPORT}, f,
                      indent=1, sort_keys=True)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
