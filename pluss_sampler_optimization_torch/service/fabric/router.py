"""Fabric router: fingerprint-sharded dispatch over N engine workers.

The router is the fabric's thin control plane: it accepts the
EXISTING serve JSONL protocol — from a file/stdin batch (exactly like
`serve` mode) and from TCP clients speaking plain JSONL lines — and
forwards each request line, RAW, to one worker chosen by consistent-
hashing the request's service fingerprint (service/fingerprint.py)
onto the worker ring (service/fabric/ring.py). Raw-line forwarding is
the bit-identity lever: the worker parses/validates/fingerprints the
same bytes serve_jsonl would, so the fabric can never change what a
request means — only where it runs. The router executes no engine
work and never initializes a device backend; it parses lines only to
compute the routing fingerprint (jax-free code: models + frontend +
service/fingerprint.py).

Routing rules, in order:
- oversize lines (> api.MAX_REQUEST_LINE_BYTES) are refused AT the
  router with serve_jsonl's exact error + best-effort id echo (the
  payload never travels);
- control lines answer AT the router: `healthz` with the fabric view
  (link states, per-link heartbeat RTT), `stats`/`metrics` with the
  MERGED fleet view (per-worker sections polled over `stats` frames
  plus numeric fleet sums / summed registry snapshots), and
  `dump_debug` by fanning out to every worker and writing a router
  bundle that indexes the per-worker bundles by trace_id; unknown
  types and malformed lines still forward by content digest — the
  owning worker produces the identical structured error serve_jsonl
  would;
- everything else routes by its service fingerprint, computed here
  exactly as the worker will compute it (memoized per canonical
  payload), falling back to the line's content digest when the line
  cannot be parsed/built.

Failure semantics: each worker link runs per-connection heartbeats
(ping/pong every FabricConfig.hb_interval_s; silence past
hb_timeout_s fails the link) and a BOUNDED reconnect schedule. A
reconnect re-sends that link's in-flight frames (the worker's
re-submission coalesces or cache-hits bit-identically). Exhausted
reconnects declare the worker DEAD: its in-flight requests re-dispatch
to each fingerprint's ring successor among the survivors — EXACTLY
once per hop, recorded in the response's degrade chain as
{"from": "worker:K", "to": "worker:J", "reason":
"worker_disconnect"}, the same shape replica re-routes use. Entry
ownership makes resolution exactly-once: a response is accepted only
from a seq's current owner, so a zombie link's late answer is dropped.

Chaos: every request-frame send fires the `worker_conn` site —
latency/hang delay the send; raise/disconnect sever that link
(bounded reconnect, then re-dispatch), which is the seeded partition
scenario tools/check_chaos.py pins.
"""

from __future__ import annotations

import json
import re
import socket
import threading
import time
import uuid
from collections import deque

from ...runtime import faults
from ...runtime.obs import ledger as obs_ledger
from ...runtime.obs import metrics as obs_metrics
from .. import api
from ..fingerprint import content_digest
from . import wire
from .ring import HashRing

# Live-registry histogram names the router observes into (module-level
# obs_metrics.observe: no-ops when no registry is enabled). Per-link
# series ride the same names with a `_worker_<id>` suffix.
HB_RTT_HISTOGRAM = "fabric_hb_rtt_s"
WIRE_HISTOGRAM = "fabric_wire_s"


def _id_echo(line: str) -> str | None:
    """serve_jsonl's best-effort id echo for refused lines."""
    m = re.search(r'"id"\s*:\s*"([^"\\]{1,120})"', line[:4096])
    return m.group(1) if m else None


class Entry:
    """One routed request line: resolved exactly once."""

    __slots__ = ("seq", "line", "line_no", "req_id", "fp", "owner",
                 "hops", "degrade", "doc", "trace_id", "span_id",
                 "meta", "t_created", "t_routed", "t_sent", "_event",
                 "_callback", "_lock", "on_partial")

    def __init__(self, seq: int, line: str, line_no: int):
        self.seq = seq
        self.line = line
        self.line_no = line_no
        # streamed progressive-precision round docs forward through
        # this callback (set by the serving front before routing)
        self.on_partial = None
        self.req_id: str | None = None
        self.fp: str | None = None
        self.owner: int | None = None
        self.hops = 0
        self.degrade: list = []
        self.doc: dict | None = None
        # trace context + span stamps (router-local perf_counter —
        # every span is a single-host monotonic delta)
        self.trace_id: str | None = None
        self.span_id: str | None = None
        self.meta: dict | None = None  # parsed model/n/engine
        self.t_created = time.perf_counter()
        self.t_routed: float | None = None
        self.t_sent: float | None = None
        self._event = threading.Event()
        self._callback = None
        self._lock = threading.Lock()

    def on_done(self, fn) -> None:
        """Run fn(doc) at resolution (immediately if already done)."""
        with self._lock:
            if self.doc is None:
                self._callback = fn
                return
        fn(self.doc)

    def wait(self, timeout: float | None = None) -> dict | None:
        self._event.wait(timeout)
        return self.doc

    @property
    def resolved(self) -> bool:
        return self.doc is not None


class WorkerLink:
    """One router->worker connection with heartbeats and bounded
    reconnect. Owns the in-flight entries routed to its worker."""

    def __init__(self, router: "Router", index: int,
                 host: str, port: int):
        self.router = router
        self.index = index
        self.worker_id = index  # refined by the worker's hello
        self.host = host
        self.port = port
        self.state = "connecting"  # connecting | up | dead
        self.inflight: dict[int, Entry] = {}
        self.dispatched = 0
        self.reconnects = 0
        # heartbeat RTTs (token-matched pongs) + the wall time of the
        # last pong, for healthz's rtt_p95_s / last_pong_age_s
        self.rtts: deque = deque(maxlen=64)
        self.last_pong: float | None = None
        # the worker's latest periodic telemetry snapshot (stats
        # frames), feeding the merged fleet stats//metrics view
        self.last_snapshot: dict | None = None
        self.last_snapshot_at: float | None = None
        self._stats_waiters: dict = {}  # token -> [Event, payload]
        self._conn: wire.Conn | None = None
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self._bye = threading.Event()
        self._up_once = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"pluss-fabric-link-{index}",
            daemon=True,
        )

    def start(self) -> None:
        self._thread.start()

    def wait_up(self, timeout: float | None = None) -> bool:
        self._up_once.wait(timeout)
        return self.state == "up"

    # -- dispatch ------------------------------------------------------

    def dispatch(self, entry: Entry) -> None:
        """Adopt the entry (it survives reconnects in `inflight`) and
        push its frame if the link is up — a down link sends it on
        reconnect, a dying one hands it to re-dispatch."""
        with self._lock:
            self.inflight[entry.seq] = entry
            entry.owner = self.worker_id
            self.dispatched += 1
        if self.state == "up":
            self._send_request(entry)

    def _send_request(self, entry: Entry) -> None:
        conn = self._conn
        if conn is None:
            return
        frame = {"type": "request", "seq": entry.seq,
                 "line": entry.line, "line_no": entry.line_no}
        if entry.trace_id is not None:
            frame["trace"] = {
                "trace_id": entry.trace_id,
                "span_id": entry.span_id,
                "sent_s": round(time.perf_counter(), 6),
            }
        try:
            faults.fire("worker_conn", key=entry.seq,
                        worker_id=self.worker_id)
            entry.t_sent = time.perf_counter()
            conn.send(frame)
        except wire.FrameTooLarge:
            # this entry can never travel: answer it, don't kill the
            # link (pop first so re-dispatch cannot double-answer)
            with self._lock:
                self.inflight.pop(entry.seq, None)
            self.router._resolve(entry, {
                "id": entry.req_id or _id_echo(entry.line),
                "ok": False, "line": entry.line_no,
                "error": "request line does not fit a fabric frame",
            })
        except (faults.FaultInjected, wire.WireError, OSError):
            # injected or real send failure: sever the link — the
            # reader notices, reconnect re-sends everything in flight
            conn.close()

    # -- connection lifecycle ------------------------------------------

    def _run(self) -> None:
        fabric = self.router.fabric
        attempts = 0
        while not self._closed.is_set():
            conn = None
            try:
                conn = wire.connect(
                    self.host, self.port,
                    timeout=fabric.connect_timeout_s,
                )
                conn.send({"type": "hello",
                           "wire_version": wire.WIRE_VERSION,
                           "role": "router"})
                hello = conn.recv(timeout=fabric.connect_timeout_s)
                if hello is None or hello.get("type") != "hello":
                    raise wire.WireError(
                        "handshake refused: "
                        + str((hello or {}).get("error")
                              or "no hello reply")
                    )
                wid = hello.get("worker_id")
                if isinstance(wid, int):
                    self.worker_id = wid
                self._conn = conn
                self.state = "up"
                attempts = 0
                self._up_once.set()
                # re-send everything still in flight: the responses
                # lost with the old socket re-materialize from the
                # worker's cache/singleflight, bit-identical
                with self._lock:
                    pending = list(self.inflight.values())
                for entry in pending:
                    self._send_request(entry)
                self._read_loop(conn)
                return  # clean exit (bye/close)
            except (wire.WireError, OSError, socket.timeout):
                pass
            finally:
                if conn is not None and self._conn is conn:
                    self._conn = None
                if conn is not None:
                    conn.close()
            if self._closed.is_set():
                return
            self.state = "connecting"
            attempts += 1
            self.reconnects += 1
            if attempts > fabric.reconnect_attempts:
                self.state = "dead"
                self.router._on_link_dead(self)
                return
            time.sleep(fabric.reconnect_delay_s)

    def _read_loop(self, conn: wire.Conn) -> None:
        fabric = self.router.fabric
        while not self._closed.is_set():
            frame = conn.recv(timeout=fabric.hb_timeout_s)
            if frame is None:
                raise wire.ConnectionClosed("worker closed the link")
            kind = frame.get("type")
            if kind == "response":
                self.router._on_response(self, frame)
            elif kind == "partial":
                self.router._on_partial(self, frame)
            elif kind == "pong":
                self._on_pong(frame)
            elif kind == "stats":
                self._on_stats(frame)
            elif kind == "bye":
                self._bye.set()
                return
            # error frames are just liveness traffic

    def ping(self) -> None:
        conn = self._conn
        if self.state == "up" and conn is not None:
            try:
                # the token is this process's perf_counter: the echo
                # yields the link RTT from one monotonic clock
                conn.send({"type": "ping",
                           "t": time.perf_counter()})
            except (wire.WireError, OSError):
                conn.close()

    def _on_pong(self, frame: dict) -> None:
        """Pongs used to be discarded liveness traffic; the echoed
        token now yields the per-link heartbeat RTT."""
        self.last_pong = time.time()
        t = frame.get("t")
        if not isinstance(t, (int, float)):
            return
        rtt = time.perf_counter() - float(t)
        if rtt < 0:  # a pre-restart token echoed late
            return
        self.rtts.append(rtt)
        obs_metrics.observe(HB_RTT_HISTOGRAM, rtt)
        obs_metrics.observe(
            f"{HB_RTT_HISTOGRAM}_worker_{self.worker_id}", rtt
        )

    def rtt_p95_s(self) -> float | None:
        rtts = sorted(self.rtts)
        if not rtts:
            return None
        return rtts[min(len(rtts) - 1, int(0.95 * (len(rtts) - 1)))]

    # -- fleet telemetry ----------------------------------------------

    def request_stats(self, want, extra: dict | None = None,
                      timeout: float = 5.0) -> dict | None:
        """Synchronously poll this worker's telemetry snapshot over a
        `stats` frame; None when the link is down or the worker does
        not answer inside `timeout`."""
        conn = self._conn
        if self.state != "up" or conn is None:
            return None
        token = self.router._next_stats_token()
        waiter = [threading.Event(), None]
        with self._lock:
            self._stats_waiters[token] = waiter
        frame = {"type": "stats", "token": token, "want": list(want)}
        if extra:
            frame.update(extra)
        try:
            conn.send(frame)
        except (wire.WireError, OSError):
            with self._lock:
                self._stats_waiters.pop(token, None)
            conn.close()
            return None
        waiter[0].wait(timeout)
        with self._lock:
            self._stats_waiters.pop(token, None)
        snap = waiter[1]
        return snap if isinstance(snap, dict) else None

    def _on_stats(self, frame: dict) -> None:
        with self._lock:
            waiter = self._stats_waiters.pop(frame.get("token"), None)
        if waiter is not None:
            waiter[1] = frame.get("snapshot")
            waiter[0].set()

    def drain_inflight(self) -> list[Entry]:
        with self._lock:
            entries = list(self.inflight.values())
            self.inflight.clear()
        return entries

    def take(self, seq: int) -> Entry | None:
        with self._lock:
            return self.inflight.pop(seq, None)

    def peek(self, seq: int) -> Entry | None:
        """Non-removing inflight lookup — partial frames observe the
        entry without resolving it (the response frame still pops)."""
        with self._lock:
            return self.inflight.get(seq)

    def shutdown(self, timeout: float) -> bool:
        """Graceful: ask the worker to drain, wait for its bye."""
        conn = self._conn
        if conn is not None and self.state == "up":
            try:
                conn.send({"type": "shutdown"})
            except (wire.WireError, OSError):
                pass
            self._bye.wait(timeout)
        self.close()
        return self._bye.is_set()

    def close(self) -> None:
        self._closed.set()
        conn = self._conn
        if conn is not None:
            conn.close()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)


class Router:
    """The fabric's dispatch plane over a set of worker addresses."""

    def __init__(self, worker_addrs, fabric=None,
                 ledger_path: str | None = None):
        from ...config import FabricConfig

        if not worker_addrs:
            raise ValueError("router needs at least one worker "
                             "address")
        self.fabric = fabric if fabric is not None else FabricConfig()
        # the router's OWN schema-v2 rows (source fabric.router): one
        # per traced response, carrying the span block that
        # tools/assemble_trace.py joins with the worker's row
        self.ledger_path = ledger_path
        # burn-rate parameters forwarded with every periodic stats
        # poll so workers pre-digest slo_inputs; the CLI sets this
        # from SLOConfig when the fleet sentinel is wired
        self.slo_params: dict | None = None
        self.slo_sentinel = None  # fleet SLOSentinel (CLI-attached)
        self.links = [
            WorkerLink(self, i, host, port)
            for i, (host, port) in enumerate(worker_addrs)
        ]
        self._ring: HashRing | None = None
        self._seq = 0
        self._stats_token = 0
        self._lock = threading.Lock()
        self._fp_memo: dict[str, str] = {}
        self._draining = False
        self._listener: socket.socket | None = None
        self._client_threads: list[threading.Thread] = []
        self._ticker: threading.Thread | None = None
        self._stats_ticker: threading.Thread | None = None
        self._stop = threading.Event()
        # trace_id -> worker_id for the last traced responses: the
        # dump_debug fan-out bundle's per-request index
        self._recent_traces: deque = deque(maxlen=256)
        self.counters = {
            "lines": 0, "routed": 0, "local": 0, "redispatched": 0,
            "responses": 0, "dropped_stale": 0, "no_worker": 0,
            "partials_forwarded": 0, "partials_dropped_stale": 0,
            "tcp_clients": 0, "stats_polls": 0, "router_rows": 0,
            "ledger_write_failed": 0,
        }

    def _next_stats_token(self) -> int:
        with self._lock:
            self._stats_token += 1
            return self._stats_token

    # -- lifecycle -----------------------------------------------------

    def start(self, wait_up: bool = True) -> "Router":
        """Connect every link (handshakes resolve worker ids), build
        the ring over the REPORTED ids — a pure function of the id
        set, so assignment is stable across router restarts — and
        start the heartbeat ticker."""
        for link in self.links:
            link.start()
        if wait_up:
            deadline = time.time() + self.fabric.connect_timeout_s
            for link in self.links:
                link.wait_up(max(0.1, deadline - time.time()))
        self._ring = HashRing(
            [link.worker_id for link in self.links],
            vnodes=self.fabric.ring_vnodes,
        )
        self._by_id = {link.worker_id: link for link in self.links}
        self._ticker = threading.Thread(
            target=self._heartbeat_loop, name="pluss-fabric-hb",
            daemon=True,
        )
        self._ticker.start()
        self._stats_ticker = threading.Thread(
            target=self._stats_loop, name="pluss-fabric-stats",
            daemon=True,
        )
        self._stats_ticker.start()
        return self

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.fabric.hb_interval_s):
            for link in self.links:
                link.ping()

    def _stats_loop(self) -> None:
        """Periodic fleet telemetry poll: refresh every live link's
        snapshot so stats//metrics/GET /metrics and the fleet SLO
        sentinel read recent per-worker data without blocking."""
        interval = self.fabric.stats_interval_s
        while not self._stop.wait(interval):
            if self._draining:
                continue
            try:
                self.poll_workers(
                    ("stats", "metrics", "slo_inputs"),
                    timeout=min(interval, 5.0), store=True,
                )
            except Exception:
                pass  # telemetry must never take routing down

    def alive_ids(self) -> set:
        return {link.worker_id for link in self.links
                if link.state != "dead"}

    # -- routing -------------------------------------------------------

    def _routing_fingerprint(self, line: str
                             ) -> tuple[str, dict | None]:
        """(fingerprint, meta) for this line. The fingerprint is the
        worker's service fingerprint — computed HERE with the same
        parse/build path (jax-free), memoized per canonical payload;
        content digest for lines a worker will refuse (their errors
        need determinism, not affinity; meta is None for those).
        `meta` carries the parsed serving metadata the router's own
        ledger row needs (model/n/engine + any caller trace_id)."""
        try:
            request = api.parse_request_line(line)
            key = json.dumps(request.payload(), sort_keys=True,
                             default=str)
            fp = self._fp_memo.get(key)
            if fp is None:
                fp = request.fingerprint()
                if len(self._fp_memo) >= 4096:
                    self._fp_memo.clear()
                self._fp_memo[key] = fp
            return fp, {
                "model": request.model, "n": request.n,
                "engine": request.engine,
                "trace_id": request.trace_id,
            }
        except Exception:
            return content_digest({"line": line}), None

    def submit_line(self, line: str, line_no: int = 0,
                    on_partial=None) -> Entry:
        """Route one JSONL line; returns its Entry (resolving to the
        serve-protocol response dict). `on_partial` receives any
        progressive-precision round docs the owning worker streams
        ahead of the final response (already id-tagged)."""
        with self._lock:
            self._seq += 1
            entry = Entry(self._seq, line.strip(), line_no)
        entry.on_partial = on_partial
        self.counters["lines"] += 1
        line = entry.line
        if len(line) > api.MAX_REQUEST_LINE_BYTES:
            entry.req_id = _id_echo(line)
            self.counters["local"] += 1
            self._resolve(entry, {
                "id": entry.req_id, "ok": False, "line": line_no,
                "error": (
                    f"request line of {len(line)} bytes exceeds the "
                    f"{api.MAX_REQUEST_LINE_BYTES}-byte limit"
                ),
            })
            return entry
        try:
            doc = json.loads(line)
        except ValueError:
            doc = None
        if isinstance(doc, dict):
            entry.req_id = doc.get("id")
        if isinstance(doc, dict) and doc.get("type") in (
            "healthz", "stats", "metrics", "dump_debug"
        ):
            # fabric-local introspection: the router IS the authority
            # on link/dispatch state AND — via the stats-frame fan-out
            # — on the merged fleet view, so no control line rides to
            # one arbitrary worker anymore: stats/metrics answer with
            # per-worker sections plus fleet sums, dump_debug makes
            # EVERY worker (and the router) write a bundle
            kind = doc["type"]
            try:
                payload = {
                    "healthz": self.healthz,
                    "stats": self.fleet_stats,
                    "metrics": self.fleet_metrics,
                    "dump_debug": self.fleet_dump_debug,
                }[kind]()
                out = {"id": entry.req_id, "ok": True,
                       "type": kind, kind: payload}
            except Exception as e:
                out = {"id": entry.req_id, "ok": False,
                       "line": line_no,
                       "error": f"introspection failed: {e!r}"}
            self.counters["local"] += 1
            self._resolve(entry, out)
            return entry
        if self._draining:
            self._resolve(entry, {
                "id": entry.req_id, "ok": False, "line": line_no,
                "shed": True,
                "error": "shed: router shutting down",
            })
            return entry
        entry.fp, entry.meta = self._routing_fingerprint(line)
        if self.fabric.trace_enabled and entry.meta is not None:
            # adopt the caller's trace_id when the line names one
            # (the worker parses the same bytes and agrees), mint
            # otherwise — either way router and worker rows join
            entry.trace_id = (entry.meta.get("trace_id")
                              or uuid.uuid4().hex[:16])
            entry.span_id = uuid.uuid4().hex[:16]
        self._route(entry)
        return entry

    def _route(self, entry: Entry) -> None:
        entry.t_routed = time.perf_counter()
        try:
            wid = self._ring.assign(entry.fp, alive=self.alive_ids())
        except LookupError:
            self.counters["no_worker"] += 1
            self._resolve(entry, {
                "id": entry.req_id, "ok": False,
                "line": entry.line_no,
                "error": "no live fabric workers",
            })
            return
        self.counters["routed"] += 1
        self._by_id[wid].dispatch(entry)

    # -- link events ---------------------------------------------------

    def _on_response(self, link: WorkerLink, frame: dict) -> None:
        t_done = time.perf_counter()
        seq = frame.get("seq")
        doc = frame.get("doc")
        entry = link.take(seq) if isinstance(seq, int) else None
        if entry is None or entry.owner != link.worker_id:
            # a zombie link answering a re-dispatched seq: the current
            # owner's answer is the one that counts — exactly-once
            self.counters["dropped_stale"] += 1
            return
        if not isinstance(doc, dict):
            doc = {"id": entry.req_id, "ok": False,
                   "line": entry.line_no,
                   "error": "malformed response frame from worker"}
        if entry.degrade:
            # the re-dispatch hops this entry survived, ahead of any
            # engine-level degradation the worker recorded — the same
            # chain shape replica re-routes use
            doc = dict(doc)
            doc["degraded"] = entry.degrade + list(
                doc.get("degraded") or []
            )
        self.counters["responses"] += 1
        if entry.trace_id is not None:
            try:
                self._record_spans(link, entry, frame, doc, t_done)
            except Exception:
                self.counters["ledger_write_failed"] += 1
        self._resolve(entry, doc)

    def _record_spans(self, link: WorkerLink, entry: Entry,
                      frame: dict, doc: dict, t_done: float) -> None:
        """Per-request router spans: every duration is a delta on THIS
        process's perf_counter; the worker contributes only its own
        recv->send delta (`worker_s`), so the wire split needs no
        cross-host clock agreement. wire_s = RTT - worker_s, halved
        into out/back (symmetric-path estimate, Cristian's
        algorithm)."""
        trace = frame.get("trace")
        worker_s = (trace.get("worker_s")
                    if isinstance(trace, dict) else None)
        rtt = (t_done - entry.t_sent
               if entry.t_sent is not None else None)
        wire_s = None
        if (rtt is not None and isinstance(worker_s, (int, float))):
            wire_s = max(0.0, rtt - float(worker_s))
        self._recent_traces.append(
            {"trace_id": entry.trace_id, "worker_id": link.worker_id}
        )
        if wire_s is not None:
            obs_metrics.observe(WIRE_HISTOGRAM, wire_s,
                                exemplar=entry.trace_id)
            obs_metrics.observe(
                f"{WIRE_HISTOGRAM}_worker_{link.worker_id}", wire_s
            )
        if self.ledger_path is None or entry.meta is None:
            return

        def _span(v):
            return None if v is None else round(float(v), 6)

        cache = doc.get("cache")
        row = {
            "kind": "request",
            "source": obs_ledger.ROUTER_SOURCE,
            "ok": bool(doc.get("ok")),
            "fingerprint": entry.fp,
            "engine_requested": entry.meta["engine"],
            "engine_used": doc.get("engine_used"),
            "model": entry.meta["model"],
            "n": entry.meta["n"],
            "latency_s": _span(t_done - entry.t_created),
            "cache": (cache if cache in obs_ledger.CACHE_TIERS
                      else None),
            "degraded": list(doc.get("degraded") or []),
            "mrc_digest": doc.get("mrc_digest"),
            "trace_id": entry.trace_id,
            "span_id": entry.span_id,
            "router": {
                "worker_id": link.worker_id,
                "hops": entry.hops,
                "router_queue_s": _span(
                    entry.t_routed - entry.t_created
                    if entry.t_routed is not None else None),
                "route_s": _span(
                    entry.t_sent - entry.t_routed
                    if entry.t_sent is not None
                    and entry.t_routed is not None else None),
                "worker_rtt_s": _span(rtt),
                "worker_s": _span(worker_s),
                "wire_s": _span(wire_s),
                "wire_out_s": _span(
                    wire_s / 2 if wire_s is not None else None),
                "wire_back_s": _span(
                    wire_s / 2 if wire_s is not None else None),
            },
        }
        try:
            obs_ledger.append(self.ledger_path, row)
            self.counters["router_rows"] += 1
        except Exception:
            self.counters["ledger_write_failed"] += 1

    def _on_partial(self, link: WorkerLink, frame: dict) -> None:
        """A streamed progressive-precision round from a worker:
        forward to the seq's CURRENT owner's client, never resolve.
        The same exactly-once ownership rule responses obey applies —
        a zombie link's stream for a re-dispatched seq is dropped (the
        new owner re-streams its own rounds)."""
        seq = frame.get("seq")
        doc = frame.get("doc")
        entry = link.peek(seq) if isinstance(seq, int) else None
        if (entry is None or entry.owner != link.worker_id
                or not isinstance(doc, dict)):
            self.counters["partials_dropped_stale"] += 1
            return
        self.counters["partials_forwarded"] += 1
        cb = entry.on_partial
        if cb is not None:
            try:
                cb(doc)
            except Exception:
                pass  # a client write failure never takes the link down

    def _on_link_dead(self, link: WorkerLink) -> None:
        """Reconnects exhausted: re-dispatch the dead worker's
        in-flight entries to each fingerprint's ring successor."""
        entries = link.drain_inflight()
        for entry in entries:
            entry.hops += 1
            if entry.hops >= len(self.links):
                self._resolve(entry, {
                    "id": entry.req_id, "ok": False,
                    "line": entry.line_no,
                    "error": ("no live fabric workers after "
                              f"{entry.hops} re-dispatch(es)"),
                })
                continue
            old = entry.owner
            alive = self.alive_ids()
            try:
                new = self._ring.assign(entry.fp, alive=alive)
            except LookupError:
                self.counters["no_worker"] += 1
                self._resolve(entry, {
                    "id": entry.req_id, "ok": False,
                    "line": entry.line_no,
                    "error": "no live fabric workers",
                })
                continue
            entry.degrade.append({
                "from": f"worker:{old}", "to": f"worker:{new}",
                "reason": "worker_disconnect",
            })
            self.counters["redispatched"] += 1
            self._by_id[new].dispatch(entry)

    def _resolve(self, entry: Entry, doc: dict) -> None:
        with entry._lock:
            if entry.doc is not None:
                return
            entry.doc = doc
            callback = entry._callback
            entry._callback = None
        entry._event.set()
        if callback is not None:
            try:
                callback(doc)
            except Exception:
                pass

    # -- introspection -------------------------------------------------

    def healthz(self) -> dict:
        now = time.time()
        return {
            "status": ("ok" if self.alive_ids() else "no_workers"),
            "role": "router",
            "workers": {
                str(link.worker_id): {
                    "addr": f"{link.host}:{link.port}",
                    "state": link.state,
                    "in_flight": len(link.inflight),
                    "rtt_p95_s": link.rtt_p95_s(),
                    "last_pong_age_s": (
                        round(now - link.last_pong, 3)
                        if link.last_pong is not None else None
                    ),
                }
                for link in self.links
            },
            "ring": list(self._ring.worker_ids) if self._ring else [],
        }

    def stats(self) -> dict:
        return {
            "role": "router",
            "counters": dict(self.counters),
            "workers": {
                str(link.worker_id): {
                    "state": link.state,
                    "dispatched": link.dispatched,
                    "in_flight": len(link.inflight),
                    "reconnects": link.reconnects,
                }
                for link in self.links
            },
        }

    # -- fleet telemetry ----------------------------------------------

    def poll_workers(self, want, timeout: float = 5.0,
                     store: bool = False) -> dict:
        """Fan a `stats` frame out to every live link (one thread
        each — a stuck worker can't serialize the poll) and collect
        {worker_id: snapshot}. `store` keeps each snapshot on its link
        for the non-blocking readers (GET /metrics, the sentinel)."""
        extra = ({"slo": self.slo_params}
                 if self.slo_params is not None else None)
        results: dict = {}
        lock = threading.Lock()

        def _one(link: WorkerLink) -> None:
            snap = link.request_stats(want, extra=extra,
                                      timeout=timeout)
            if snap is None:
                return
            with lock:
                results[link.worker_id] = snap
            if store:
                # merge by section: a narrow poll (say metrics-only)
                # must not blank the slo_inputs the sentinel reads
                link.last_snapshot = {
                    **(link.last_snapshot or {}), **snap
                }
                link.last_snapshot_at = time.time()

        threads = []
        for link in self.links:
            if link.state != "up":
                continue
            t = threading.Thread(
                target=_one, args=(link,),
                name=f"pluss-fabric-poll-{link.worker_id}",
                daemon=True,
            )
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout + 1.0)
        self.counters["stats_polls"] += 1
        return results

    def _worker_snapshots(self, want, refresh: bool,
                          timeout: float = 5.0) -> dict:
        """{worker_id: snapshot} — freshly polled, or each link's last
        periodic snapshot when `refresh` is False (falling back to one
        live poll if nothing has been collected yet)."""
        if refresh:
            return self.poll_workers(want, timeout=timeout,
                                     store=True)
        snaps = {
            link.worker_id: link.last_snapshot
            for link in self.links
            if link.last_snapshot is not None
        }
        if snaps:
            return snaps
        return self.poll_workers(want, timeout=timeout, store=True)

    def fleet_stats(self, refresh: bool = True) -> dict:
        """The `stats` control line's fleet answer: the router-local
        view plus each worker's `stats` section and the numeric fleet
        sums (runtime/obs/fleet.py) — consistent with the
        single-process shapes per worker, summed per fleet."""
        from ...runtime.obs import fleet as obs_fleet

        snaps = self._worker_snapshots(
            ("stats", "metrics", "slo_inputs"), refresh
        )
        return obs_fleet.fleet_stats(self.stats(), snaps)

    def fleet_metrics(self, refresh: bool = True) -> dict:
        """The `metrics` control line's fleet answer: per-worker
        registry snapshots merged with the router's own registry
        (counters/histogram buckets summed — the same shape a
        single-process `metrics` response has), plus the per-worker
        originals and the fleet SLO report when a sentinel runs."""
        from ...runtime.obs import fleet as obs_fleet

        snaps = self._worker_snapshots(("metrics",), refresh)
        reg = obs_metrics.get()
        out = obs_fleet.fleet_metrics(
            reg.snapshot() if reg is not None else None, snaps
        )
        if self.slo_sentinel is not None:
            out["slo"] = self.slo_sentinel.last_report
        return out

    def fleet_prometheus_text(self, prefix: str = "pluss_") -> str:
        """GET /metrics for the router: the merged fleet exposition
        (router registry + every worker's last-polled snapshot summed
        bucket-by-bucket). Reads the periodic snapshots — a scrape
        never blocks on N workers."""
        from ...runtime.obs import fleet as obs_fleet

        snaps = self._worker_snapshots(("metrics",), refresh=False,
                                       timeout=2.0)
        reg = obs_metrics.get()
        merged = obs_fleet.merge_registry_snapshots(
            ([reg.snapshot()] if reg is not None else [])
            + [s.get("metrics") for s in snaps.values()
               if isinstance(s.get("metrics"), dict)]
        )
        gauges = merged.setdefault("gauges", {})
        gauges["fabric_workers_up"] = sum(
            1 for link in self.links if link.state == "up"
        )
        for link in self.links:
            gauges[f"fabric_in_flight_worker_{link.worker_id}"] = len(
                link.inflight
            )
        from ...runtime.obs import exporters

        return "\n".join(exporters.prometheus_registry_lines(
            merged, prefix=prefix
        )) + "\n"

    def fleet_dump_debug(self) -> dict:
        """The `dump_debug` control line's fleet answer: every worker
        writes its own bundle (stats-frame fan-out), then the router
        writes one more whose trigger indexes the per-worker bundle
        paths and the recent trace_id -> worker_id routing decisions —
        one request, one joined post-mortem."""
        from ...runtime.obs import recorder as obs_recorder

        snaps = self.poll_workers(
            ("dump_debug",), timeout=self.fabric.drain_timeout_s
        )
        workers = {
            str(wid): snap.get("dump_debug")
            for wid, snap in snaps.items()
        }
        rec = obs_recorder.get()
        out: dict = {
            "enabled": rec is not None or any(
                isinstance(w, dict) and w.get("enabled")
                for w in workers.values()
            ),
            "fleet": True,
            "workers": workers,
            "trace_index": list(self._recent_traces),
        }
        if rec is not None:
            out["bundle"] = rec.dump("dump_debug", trigger={
                "fan_out": {
                    wid: (w or {}).get("bundle")
                    for wid, w in workers.items()
                    if isinstance(w, dict)
                },
                "trace_index": list(self._recent_traces),
            })
            out["bundle_dir"] = rec.bundle_dir
            out["recorder"] = rec.stats()
            out["bundles"] = rec.bundle_index()
        return out

    # -- serving fronts ------------------------------------------------

    def serve_stream(self, fin, fout) -> int:
        """The serve-mode front: read a JSONL batch, dispatch every
        line up front (affinity batches per worker; duplicates
        coalesce ON the owning worker), then emit responses in input
        order. Returns the failure count, like serve_jsonl. A
        GracefulShutdown in either pass stops reading and answers
        everything already dispatched."""
        entries: list[Entry] = []
        # partials stream from link reader threads while this thread
        # is still reading/emitting: one lock per output stream
        wlock = threading.Lock()

        def _stream_partial(doc: dict) -> None:
            with wlock:
                fout.write(json.dumps(doc) + "\n")
                fout.flush()

        try:
            for line_no, line in enumerate(fin, start=1):
                if not line.strip():
                    continue
                entries.append(self.submit_line(
                    line, line_no, on_partial=_stream_partial
                ))
        except api.GracefulShutdown:
            self._draining = True
        failures = 0
        for entry in entries:
            while True:
                try:
                    doc = entry.wait(
                        timeout=self.fabric.drain_timeout_s
                    )
                    break
                except api.GracefulShutdown:
                    self._draining = True
                    continue
            if doc is None:
                doc = {"id": entry.req_id, "ok": False,
                       "line": entry.line_no,
                       "error": "fabric response timed out"}
                self._resolve(entry, doc)
                doc = entry.doc
            if not doc.get("ok"):
                failures += 1
            with wlock:
                fout.write(json.dumps(doc) + "\n")
                fout.flush()
        return failures

    def serve_tcp(self, host: str = "127.0.0.1", port: int = 0
                  ) -> tuple[str, int]:
        """The TCP front: clients speak plain JSONL lines (loadgen
        --connect drives this); responses stream back AS READY —
        clients match them by `id`, since affinity dispatch makes
        input-order completion meaningless across workers."""
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((host, port))
        ls.listen(16)
        self._listener = ls
        bound = ls.getsockname()[:2]
        t = threading.Thread(target=self._accept_clients,
                             name="pluss-fabric-tcp", daemon=True)
        t.start()
        return bound

    def _accept_clients(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return
            self.counters["tcp_clients"] += 1
            t = threading.Thread(
                target=self._serve_client, args=(sock,),
                name="pluss-fabric-client", daemon=True,
            )
            t.start()
            self._client_threads.append(t)

    def _serve_client(self, sock: socket.socket) -> None:
        wlock = threading.Lock()
        pending: list[Entry] = []
        rfile = sock.makefile("r", encoding="utf-8", newline="\n")
        wfile = sock.makefile("w", encoding="utf-8", newline="\n")

        def _emit(doc: dict) -> None:
            with wlock:
                try:
                    wfile.write(json.dumps(doc) + "\n")
                    wfile.flush()
                except (OSError, ValueError):
                    pass  # client went away; nothing to answer

        try:
            for line_no, line in enumerate(rfile, start=1):
                if not line.strip():
                    continue
                entry = self.submit_line(line, line_no,
                                         on_partial=_emit)
                pending.append(entry)
                entry.on_done(_emit)
            for entry in pending:
                entry.wait(timeout=self.fabric.drain_timeout_s)
        except (OSError, ValueError):
            pass
        finally:
            try:
                rfile.close()
                wfile.close()
                sock.close()
            except OSError:
                pass

    # -- shutdown ------------------------------------------------------

    def begin_shutdown(self) -> None:
        """Stop accepting: the TCP listener closes, later lines shed
        with structured responses; dispatched work keeps draining."""
        self._draining = True
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass

    def close(self, graceful: bool = True) -> None:
        """Tear the fabric's router side down. Graceful: drain
        in-flight entries, ask every live worker to drain (`shutdown`
        frame -> `bye`), then close links."""
        self.begin_shutdown()
        self._stop.set()
        if graceful:
            deadline = time.time() + self.fabric.drain_timeout_s
            for link in self.links:
                with link._lock:
                    snapshot = list(link.inflight.values())
                for entry in snapshot:
                    entry.wait(timeout=max(0.1,
                                           deadline - time.time()))
            for link in self.links:
                link.shutdown(timeout=max(
                    0.1, deadline - time.time()
                ))
        for link in self.links:
            link.close()
        # anything still unresolved (dead workers mid-drain) answers
        # as an error so no caller blocks forever
        for link in self.links:
            for entry in link.drain_inflight():
                self._resolve(entry, {
                    "id": entry.req_id, "ok": False,
                    "line": entry.line_no,
                    "error": "router closed before a worker answered",
                })
        if self._ticker is not None and self._ticker.is_alive():
            self._ticker.join(timeout=2.0)
        if (self._stats_ticker is not None
                and self._stats_ticker.is_alive()):
            self._stats_ticker.join(timeout=2.0)
