"""Multi-process serving fabric: a fingerprint-sharded router over N
engine workers.

Layers (each its own module, each independently testable):

    wire.py    length-delimited JSON frames over sockets (the fabric
               wire protocol: hello/request/response/ping/pong/
               shutdown/bye/error), with a hard frame cap
    ring.py    consistent hashing of request fingerprints onto worker
               ids — affinity, restart stability, bounded failover
    worker.py  WorkerServer: a TCP front over ONE full serving stack
               (AnalysisService: executor + replica pool + preflight
               + in-memory LRU over its own device slice), parsing
               forwarded request lines with serve_jsonl's exact
               per-line semantics
    router.py  Router: the dispatch plane — heartbeats, bounded
               reconnect, exactly-once re-dispatch to ring
               successors, file/stdin AND TCP serving fronts

The fabric invariant: same MRC bytes and same fingerprints for one
process vs N workers, cold and warm, solo and batched
(tests/test_fabric.py pins it; tools/check_fabric.py gates it in CI
with real subprocesses).
"""

from .ring import HashRing
from .router import Entry, Router, WorkerLink
from .wire import (
    MAX_FRAME_BYTES,
    WIRE_VERSION,
    Conn,
    ConnectionClosed,
    FrameTooLarge,
    WireError,
    connect,
    encode_frame,
    parse_hostport,
)
from .worker import WorkerServer, handle_line, response_doc

__all__ = [
    "HashRing",
    "Entry",
    "Router",
    "WorkerLink",
    "WorkerServer",
    "handle_line",
    "response_doc",
    "Conn",
    "ConnectionClosed",
    "FrameTooLarge",
    "WireError",
    "connect",
    "encode_frame",
    "parse_hostport",
    "MAX_FRAME_BYTES",
    "WIRE_VERSION",
]
