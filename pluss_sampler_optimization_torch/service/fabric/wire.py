"""Length-delimited JSON frames: the fabric's wire protocol.

Router and workers speak frames over TCP sockets: a 4-byte big-endian
length prefix followed by one UTF-8 JSON object. The frame payload cap
derives from serve_jsonl's per-line budget (api.MAX_REQUEST_LINE_BYTES
is 1 MiB) with headroom for the envelope's JSON re-escaping, so a
request line the serve protocol accepts always fits in one frame and a
hostile frame is refused BEFORE its payload is materialized as
objects.

Frame vocabulary (the `type` field):

    hello     handshake, both directions. Carries `wire_version`; the
              worker's reply carries its `worker_id`. A version
              mismatch is answered with an `error` frame and the
              connection is closed (tests/test_fabric.py pins it).
    request   router -> worker: {"seq": N, "line": <raw JSONL request
              line>, "line_no": M}. The RAW line is forwarded, so the
              worker's parse/validate/fingerprint path is byte-for-
              byte the one serve_jsonl runs — the transport cannot
              change what a request means. May carry an optional
              `trace` block {"trace_id": hex16, "span_id": hex16,
              "sent_s": <sender perf_counter>}: the worker ADOPTS the
              caller's trace_id (unless the raw line itself names
              one, which both sides then agree on), so worker ledger
              rows, exemplars, and bundles join the router's view of
              the same request. Trace context never enters the
              request payload or fingerprint — placement and tracing
              are both invisible to the MRC bytes.
    partial   worker -> router: {"seq": N, "doc": <partial dict>}.
              An interim progressive-precision result for the request
              dispatched as `seq` — `doc` carries `partial: true`,
              the request `id`, `round`/`rounds_total`, `band_width`,
              and the interim MRC digest/lines. Zero or more partials
              precede the request's single `response` frame; the
              router forwards them immediately (never re-ordered,
              never cached) to whichever client owns the seq.
    response  worker -> router: {"seq": N, "doc": <serve response
              dict>}. Out-of-order by design; the router re-orders by
              seq for file mode and matches by id for TCP clients.
              May carry `trace` {"trace_id": hex16, "worker_s":
              <worker-side recv->send delta, its own monotonic
              clock>} so the router can split its measured RTT into
              wire time vs worker time without cross-host clocks.
    ping/pong heartbeats (router pings, worker echoes the `t` token;
              the router matches tokens to measure per-link RTT).
    stats     both directions. Router -> worker {"token": N, "want":
              [...], ...} requests a telemetry snapshot; the worker
              replies {"token": N, "snapshot": {...}} with one key
              per `want` entry (healthz/stats/metrics/slo_inputs/
              dump_debug). This is how the router serves the merged
              fleet view of `stats`/`metrics` and fans `dump_debug`
              out to every worker.
    shutdown  router -> worker: drain in-flight work, answer
              everything, reply `bye`, and stop.
    bye       worker -> router: drain complete, closing.
    error     structured refusal (handshake version mismatch, a
              malformed frame the peer could still answer).

Everything here is pure stdlib — the router process imports this
without touching jax.
"""

from __future__ import annotations

import json
import socket
import struct
import threading

# v2: optional `trace` blocks on request/response frames + the
# `stats` frame type (fleet telemetry).
# v3: the `partial` frame type (streamed progressive-precision
# interim results). The handshake still gates on exact equality —
# both ends ship in this repo.
WIRE_VERSION = 3

# Frame payload cap: the serve protocol's 1 MiB request-line budget,
# times 4 for the envelope's JSON re-escaping (every quote/backslash
# in the forwarded line doubles; control characters sextuple), plus
# 4 KiB for type/seq/line_no. Any line serve_jsonl accepts fits;
# a pathological expansion beyond this is answered by the router with
# a structured error instead of traveling (router._send_request).
MAX_FRAME_BYTES = (1 << 22) + 4096

_LEN = struct.Struct(">I")


class WireError(RuntimeError):
    """A protocol violation on a fabric connection."""


class FrameTooLarge(WireError):
    """A frame announcing (or encoding to) more than MAX_FRAME_BYTES."""


class ConnectionClosed(WireError):
    """The peer closed the connection (clean EOF mid-stream)."""


def encode_frame(doc: dict) -> bytes:
    """One wire frame for `doc` (length prefix + compact JSON)."""
    payload = json.dumps(
        doc, sort_keys=True, separators=(",", ":")
    ).encode("utf-8")
    if len(payload) > MAX_FRAME_BYTES:
        raise FrameTooLarge(
            f"frame of {len(payload)} bytes exceeds the "
            f"{MAX_FRAME_BYTES}-byte limit"
        )
    return _LEN.pack(len(payload)) + payload


class Conn:
    """One framed connection: locked sends, buffered recvs.

    Sends are serialized by a lock so concurrent senders (the worker's
    response callbacks, the router's heartbeat ticker) never interleave
    frame bytes. `recv` honors an optional timeout via the socket
    timeout; a clean EOF between frames returns None, an EOF inside a
    frame raises ConnectionClosed.
    """

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._send_lock = threading.Lock()
        self._closed = False

    def send(self, doc: dict) -> None:
        data = encode_frame(doc)
        with self._send_lock:
            self._sock.sendall(data)

    def _recv_exact(self, n: int) -> bytes | None:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                if buf:
                    raise ConnectionClosed(
                        "connection closed mid-frame"
                    )
                return None
            buf += chunk
        return buf

    def recv(self, timeout: float | None = None) -> dict | None:
        """The next frame's decoded object, or None on clean EOF.

        Raises socket.timeout when `timeout` elapses between frames,
        FrameTooLarge/WireError on protocol violations.
        """
        self._sock.settimeout(timeout)
        head = self._recv_exact(_LEN.size)
        if head is None:
            return None
        (length,) = _LEN.unpack(head)
        if length > MAX_FRAME_BYTES:
            # refuse before reading the body: the cap is the OOM guard
            raise FrameTooLarge(
                f"frame announcing {length} bytes exceeds the "
                f"{MAX_FRAME_BYTES}-byte limit"
            )
        body = self._recv_exact(length)
        if body is None:
            raise ConnectionClosed("connection closed before frame body")
        try:
            doc = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, ValueError) as e:
            raise WireError(f"malformed frame payload: {e}") from e
        if not isinstance(doc, dict):
            raise WireError("frame payload must be a JSON object")
        return doc

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    @property
    def closed(self) -> bool:
        return self._closed


def connect(host: str, port: int, timeout: float | None = None) -> Conn:
    """Dial a fabric peer and wrap the socket."""
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return Conn(sock)


def parse_hostport(spec: str) -> tuple[str, int]:
    """"HOST:PORT" -> (host, port); host defaults to 127.0.0.1."""
    host, sep, port = spec.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(
            f"expected HOST:PORT (or :PORT), got {spec!r}"
        )
    return (host or "127.0.0.1", int(port))
