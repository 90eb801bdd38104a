"""Fabric worker: one engine process serving framed request lines.

A `WorkerServer` wraps one AnalysisService — the FULL single-process
stack: executor, replica pool, preflight, in-memory LRU over this
process's device slice — behind a TCP listener speaking the fabric
wire protocol (service/fabric/wire.py). The router forwards RAW
request lines, and the worker runs them through the SAME per-line
semantics serve_jsonl applies (oversize cap with best-effort id echo,
the serve_line chaos site, structured per-line errors, control types),
so a request means byte-for-byte the same thing served directly or
through the fabric — the transport can re-route bytes, never change
them.

Concurrency model: one router connection at a time (re-accepted after
a drop — the router's bounded reconnect dials back in). The reader
thread parses/submits each request frame in arrival order (exactly
serve_jsonl's submit pass, so duplicates coalesce); responses are sent
from future done-callbacks as executions finish, out of order, tagged
with the request frame's `seq`. A send on a dead socket is dropped
silently: the router re-dispatches the seq after reconnecting and the
re-submission coalesces or cache-hits to the bit-identical result.

Chaos: every request frame fires the `worker_exec` site —
raise-kind faults become structured error responses; a `disconnect`
fault makes the worker sever the router connection mid-load (the
partition scenario tools/check_chaos.py pins).
"""

from __future__ import annotations

import dataclasses
import json
import re
import socket
import threading
import time
from concurrent.futures import CancelledError

from ...runtime import faults
from .. import api
from . import wire


def handle_line(service, line: str, line_no: int = 0,
                trace_id: str | None = None, on_partial=None):
    """serve_jsonl's per-line read-pass semantics for ONE line.

    Returns ("doc", response_dict) for lines answerable immediately
    (oversize, malformed, control types) or ("ticket", ticket,
    request) for a submitted request — the caller awaits the future
    and builds the response with `response_doc`. Mirrors
    api.serve_jsonl branch for branch so fabric-served lines produce
    identical structured responses.

    `on_partial`, when given, receives each streamed progressive-
    precision round doc (the request `id` stamped in, exactly as
    serve_jsonl emits it) — only requests that actually ask for
    progressive precision register a callback.

    `trace_id` is the router-propagated trace context: a parsed
    request that names no trace_id of its own ADOPTS it (so the worker
    ledger row, exemplars, and bundles join the router's view of the
    request) — a trace_id in the raw line wins, and both sides agree
    on it since the router parses the same bytes. Trace context is
    serving metadata: it never enters the payload or fingerprint.
    """
    line = line.strip()
    doc_id = None
    if len(line) > api.MAX_REQUEST_LINE_BYTES:
        m = re.search(r'"id"\s*:\s*"([^"\\]{1,120})"', line[:4096])
        if m:
            doc_id = m.group(1)
        service.executor._count("frontend_rejected")
        return ("doc", {
            "id": doc_id, "ok": False, "line": line_no,
            "error": (
                f"request line of {len(line)} bytes exceeds the "
                f"{api.MAX_REQUEST_LINE_BYTES}-byte limit"
            ),
        })
    try:
        faults.fire("serve_line", key=line_no)
        doc = json.loads(line)
    except faults.FaultInjected as e:
        return ("doc", {"id": None, "ok": False, "line": line_no,
                        "error": f"fault injected: {e}"})
    except RecursionError:
        m = re.search(r'"id"\s*:\s*"([^"\\]{1,120})"', line[:4096])
        if m:
            doc_id = m.group(1)
        service.executor._count("frontend_rejected")
        return ("doc", {"id": doc_id, "ok": False, "line": line_no,
                        "error": "invalid JSON: nesting too deep"})
    except ValueError as e:
        return ("doc", {"id": None, "ok": False, "line": line_no,
                        "error": f"invalid JSON: {e}"})
    if isinstance(doc, dict):
        doc_id = doc.get("id")
    if isinstance(doc, dict) and doc.get("type") is not None:
        kind = doc.get("type")
        if kind not in api.CONTROL_TYPES:
            return ("doc", {
                "id": doc_id, "ok": False, "line": line_no,
                "error": (
                    f"unknown request type {kind!r} "
                    f"(have {', '.join(api.CONTROL_TYPES)})"
                ),
            })
        # over the fabric every control line evaluates as it arrives:
        # the batch-deterministic deferral serve_jsonl applies to
        # metrics/dump_debug has no meaning when frames from many
        # clients interleave on one worker
        try:
            payload = {
                "healthz": service.healthz,
                "stats": service.stats,
                "metrics": service.metrics,
                "dump_debug": service.dump_debug,
            }[kind]()
            return ("doc", {"id": doc_id, "ok": True, "type": kind,
                            kind: payload})
        except Exception as e:
            return ("doc", {"id": doc_id, "ok": False, "line": line_no,
                            "error": f"introspection failed: {e!r}"})
    try:
        request = api.parse_request_line(line)
        if trace_id and request.trace_id is None:
            request = dataclasses.replace(request, trace_id=trace_id)
        cb = None
        if on_partial is not None and api.progressive_requested(request):
            def cb(doc, _rid=request.id):
                msg = dict(doc)
                msg["id"] = _rid
                on_partial(msg)
        ticket = service.submit(request, on_partial=cb)
        return ("ticket", ticket, request)
    except Exception as e:
        out = {"id": doc_id, "ok": False, "line": line_no,
               "error": api._error_msg(e)}
        diags = getattr(e, "diagnostics", None)
        if diags:
            out["diagnostics"] = diags
        return ("doc", out)


def response_doc(ticket, request, line_no: int = 0) -> dict:
    """Await a ticket and build its serve-protocol response dict —
    serve_jsonl's response-pass semantics for one entry (shed and
    blow-up handling included)."""
    try:
        outcome = ticket.future.result()
        return api._response_from_outcome(
            request, ticket.fingerprint, outcome
        ).to_jsonl_dict()
    except CancelledError:
        return {
            "id": request.id, "ok": False, "line": line_no,
            "shed": True,
            "error": ("shed: service shutting down "
                      "(queued request cancelled)"),
        }
    except Exception as e:
        return {
            "id": request.id, "ok": False, "line": line_no,
            "error": f"execution failed: {e!r}",
        }


# Snapshot sections a `stats` frame may request; also the default
# when the frame names none.
STATS_SECTIONS = ("healthz", "stats", "metrics", "slo_inputs",
                  "dump_debug")
DEFAULT_STATS_WANT = ("stats", "metrics", "slo_inputs")


def _slo_inputs(slo: dict | None) -> dict:
    """Pre-digested burn-rate inputs from THIS process's live
    registry, for the router's fleet SLO sentinel: per-window latency
    violation fraction (against the router-supplied threshold),
    window observation count (the merge weight), the observed p95,
    and the windowed service_* counters. All monotonic-window reads —
    nothing here needs clock agreement with the router."""
    from ...runtime.obs import metrics as obs_metrics
    from ...runtime.obs.slo import LATENCY_HISTOGRAM

    reg = obs_metrics.get()
    if reg is None:
        return {"enabled": False, "windows": {}}
    slo = slo if isinstance(slo, dict) else {}
    threshold = slo.get("threshold")
    labels = slo.get("windows") or list(reg.window_labels())
    hist = reg.snapshot().get("histograms", {}).get(
        LATENCY_HISTOGRAM, {})
    out: dict = {"enabled": True, "threshold": threshold,
                 "histogram": LATENCY_HISTOGRAM, "windows": {}}
    for lbl in labels:
        try:
            win = {
                "latency_count": int(
                    hist.get("windows", {}).get(lbl, {})
                    .get("count") or 0
                ),
                "latency_p95": reg.histogram_quantile(
                    LATENCY_HISTOGRAM, lbl, 0.95
                ),
                "service_submitted": reg.counter_window(
                    "service_submitted", lbl),
                "service_failed": reg.counter_window(
                    "service_failed", lbl),
                "service_degraded": reg.counter_window(
                    "service_degraded", lbl),
            }
            win["latency_frac_over"] = (
                reg.histogram_fraction_over(
                    LATENCY_HISTOGRAM, lbl, float(threshold)
                ) if threshold is not None else None
            )
        except KeyError:
            continue  # a window label this registry doesn't keep
        out["windows"][lbl] = win
    return out


def telemetry_snapshot(service, want=None, slo: dict | None = None
                       ) -> dict:
    """The worker's answer to a `stats` frame: one key per requested
    section. Sections map onto the serve protocol's control responses
    (healthz/stats/metrics/dump_debug) plus the fleet-only
    `slo_inputs`; a section that fails reports {"error": ...} in
    place so one broken subsystem can't blank the whole poll."""
    if not isinstance(want, (list, tuple)) or not want:
        want = DEFAULT_STATS_WANT
    out: dict = {}
    for key in want:
        if key not in STATS_SECTIONS:
            out[str(key)] = {"error": f"unknown section {key!r}"}
            continue
        try:
            if key == "slo_inputs":
                out[key] = _slo_inputs(slo)
            else:
                out[key] = getattr(service, key)()
        except Exception as e:
            out[key] = {"error": repr(e)}
    return out


class WorkerServer:
    """One fabric worker endpoint over an AnalysisService."""

    def __init__(self, service, worker_id: int = 0,
                 host: str = "127.0.0.1", port: int = 0,
                 fabric=None):
        from ...config import FabricConfig

        self.service = service
        self.worker_id = int(worker_id)
        self.fabric = fabric if fabric is not None else FabricConfig()
        self._host = host
        self._port = port
        self._listener: socket.socket | None = None
        self._thread: threading.Thread | None = None
        self._conn: wire.Conn | None = None
        self._stop = threading.Event()
        self._drained = threading.Event()
        # outstanding seq -> Future, so a drain can await everything
        # this worker accepted before saying `bye`
        self._outstanding: dict = {}
        self._lock = threading.Lock()
        self.stats_counters = {
            "connections": 0, "requests": 0, "responses": 0,
            "partials": 0,
            "handshake_rejected": 0, "faults_disconnect": 0,
            "stats_polls": 0,
        }

    # -- lifecycle -----------------------------------------------------

    def start(self) -> tuple[str, int]:
        """Bind, listen, and serve in a daemon thread. Returns the
        bound (host, port) — port 0 resolves to an ephemeral one."""
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((self._host, self._port))
        ls.listen(4)
        self._listener = ls
        self._host, self._port = ls.getsockname()[:2]
        self._thread = threading.Thread(
            target=self._accept_loop,
            name=f"pluss-fabric-worker-{self.worker_id}", daemon=True,
        )
        self._thread.start()
        return (self._host, self._port)

    @property
    def address(self) -> tuple[str, int]:
        return (self._host, self._port)

    def close(self) -> None:
        """Stop accepting and sever the live connection (the abrupt
        worker-kill the chaos gate exercises — no drain)."""
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        conn = self._conn
        if conn is not None:
            conn.close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def join_drained(self, timeout: float | None = None) -> bool:
        """Wait until a `shutdown` frame completed its drain."""
        return self._drained.wait(timeout)

    def drain_local(self) -> None:
        """Signal-initiated drain (no router `shutdown` frame, e.g.
        SIGTERM straight at the worker): stop accepting, await every
        accepted request — done-callbacks still push responses if the
        router link survives — then close."""
        with self._lock:
            pending = list(self._outstanding.values())
        for fut in pending:
            try:
                fut.result(timeout=self.fabric.drain_timeout_s)
            except Exception:
                pass  # its done-callback already sent the error doc
        self.close()
        self._drained.set()

    # -- serving -------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return  # listener closed
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = wire.Conn(sock)
            self._conn = conn
            self.stats_counters["connections"] += 1
            try:
                self._serve_conn(conn)
            except (wire.WireError, OSError, socket.timeout):
                pass  # link dropped: back to accept (router redials)
            finally:
                conn.close()
                if self._conn is conn:
                    self._conn = None

    def _handshake(self, conn: wire.Conn) -> bool:
        hello = conn.recv(timeout=self.fabric.connect_timeout_s)
        if hello is None or hello.get("type") != "hello":
            conn.send({
                "type": "error",
                "error": "expected a hello frame",
                "wire_version": wire.WIRE_VERSION,
            })
            return False
        if hello.get("wire_version") != wire.WIRE_VERSION:
            # structured refusal the router (and the mismatch test)
            # can read, then close: no half-agreed protocol
            self.stats_counters["handshake_rejected"] += 1
            conn.send({
                "type": "error",
                "error": (
                    f"wire version mismatch: router speaks "
                    f"{hello.get('wire_version')!r}, worker speaks "
                    f"{wire.WIRE_VERSION}"
                ),
                "wire_version": wire.WIRE_VERSION,
            })
            return False
        conn.send({"type": "hello", "wire_version": wire.WIRE_VERSION,
                   "worker_id": self.worker_id})
        return True

    def _serve_conn(self, conn: wire.Conn) -> None:
        if not self._handshake(conn):
            return
        while not self._stop.is_set():
            frame = conn.recv(timeout=None)
            if frame is None:
                return  # clean EOF: router went away
            kind = frame.get("type")
            if kind == "ping":
                conn.send({"type": "pong", "t": frame.get("t")})
            elif kind == "request":
                self._handle_request(conn, frame)
            elif kind == "stats":
                self._handle_stats(conn, frame)
            elif kind == "shutdown":
                self._drain(conn)
                return
            else:
                conn.send({
                    "type": "error",
                    "error": f"unknown frame type {kind!r}",
                })

    def _send_response(self, conn: wire.Conn, seq, doc: dict,
                       trace: dict | None = None) -> None:
        doc = dict(doc)
        doc["worker_id"] = self.worker_id
        frame = {"type": "response", "seq": seq, "doc": doc}
        if trace is not None:
            frame["trace"] = trace
        try:
            conn.send(frame)
            self.stats_counters["responses"] += 1
        except (wire.WireError, OSError):
            # link already dead — the router will re-dispatch this seq
            # after reconnecting; dropping the send keeps exactly-once
            # resolution at the ROUTER, where it is enforced
            pass

    def _handle_request(self, conn: wire.Conn, frame: dict) -> None:
        seq = frame.get("seq")
        line = frame.get("line")
        line_no = int(frame.get("line_no") or 0)
        t_recv = time.perf_counter()
        trace_in = frame.get("trace")
        trace_id = (trace_in.get("trace_id")
                    if isinstance(trace_in, dict) else None)

        def _trace_out() -> dict | None:
            # the router's RTT minus this delta is the wire time; both
            # deltas are single-host monotonic, so no clock agreement
            # between router and worker is ever assumed
            if trace_id is None:
                return None
            return {"trace_id": trace_id,
                    "worker_s": round(
                        time.perf_counter() - t_recv, 6)}

        self.stats_counters["requests"] += 1
        if not isinstance(line, str):
            self._send_response(conn, seq, {
                "id": None, "ok": False, "line": line_no,
                "error": "request frame without a 'line' string",
            }, trace=_trace_out())
            return
        try:
            faults.fire("worker_exec", key=seq,
                        worker_id=self.worker_id)
        except faults.DisconnectFault:
            # simulate the worker side of a partition: drop the router
            # link mid-load and go back to accept — in-flight
            # executions keep running; their sends fall on the dead
            # socket and the router re-dispatches after reconnect
            self.stats_counters["faults_disconnect"] += 1
            raise wire.ConnectionClosed("injected worker disconnect")
        except faults.FaultInjected as e:
            self._send_response(conn, seq, {
                "id": None, "ok": False, "line": line_no,
                "error": f"fault injected: {e}",
            }, trace=_trace_out())
            return
        def _partial(doc, conn=conn, seq=seq):
            # best-effort stream: a partial lost to a dead link is
            # simply gone (the final response is what the router
            # re-dispatches for; partials are never replayed)
            try:
                conn.send({"type": "partial", "seq": seq, "doc": doc})
                self.stats_counters["partials"] += 1
            except (wire.WireError, OSError):
                pass

        handled = handle_line(self.service, line, line_no,
                              trace_id=trace_id, on_partial=_partial)
        if handled[0] == "doc":
            self._send_response(conn, seq, handled[1],
                                trace=_trace_out())
            return
        _tag, ticket, request = handled
        with self._lock:
            self._outstanding[seq] = ticket.future

        def _done(_fut, conn=conn, seq=seq, ticket=ticket,
                  request=request, line_no=line_no):
            with self._lock:
                self._outstanding.pop(seq, None)
            self._send_response(
                conn, seq, response_doc(ticket, request, line_no),
                trace=_trace_out(),
            )

        ticket.future.add_done_callback(_done)

    # -- fleet telemetry ----------------------------------------------

    def _handle_stats(self, conn: wire.Conn, frame: dict) -> None:
        """`stats` frame: build the requested telemetry snapshot and
        echo the token. A broken section must never take the link (or
        the worker) down — it is reported in place."""
        self.stats_counters["stats_polls"] += 1
        snapshot = telemetry_snapshot(
            self.service, frame.get("want"), slo=frame.get("slo")
        )
        try:
            conn.send({"type": "stats", "token": frame.get("token"),
                       "worker_id": self.worker_id,
                       "snapshot": snapshot})
        except (wire.WireError, OSError):
            pass  # router re-polls after reconnecting

    def _drain(self, conn: wire.Conn) -> None:
        """`shutdown` frame: stop reading, await every accepted
        request (responses flow from their done-callbacks), then
        `bye`. The CLI layer tears the service down afterwards."""
        with self._lock:
            pending = list(self._outstanding.values())
        for fut in pending:
            try:
                fut.result(timeout=self.fabric.drain_timeout_s)
            except Exception:
                pass  # its done-callback already sent the error doc
        try:
            conn.send({"type": "bye", "worker_id": self.worker_id})
        except (wire.WireError, OSError):
            pass
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        self._drained.set()
