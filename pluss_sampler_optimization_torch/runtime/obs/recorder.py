"""Flight recorder: tail-retained request records + post-mortem bundles.

The port's copy of the JAX package's runtime/obs/recorder.py; only the
optional device-memory capture of `profile=True` differs: a CUDA caching
allocator snapshot (torch.cuda.memory._snapshot) pickled beside the
bundle instead of jax.profiler's device memory profile.

The live registry (runtime/obs/metrics.py) and the SLO sentinel
(runtime/obs/slo.py) tell you THAT something broke — a breached burn
rate, a quarantined replica, a drift excursion — but by the time a
human looks, the evidence is gone: counters have no per-request
detail, the per-run Telemetry belongs to one CLI run, and serve mode
handles thousands of requests between two scrapes. The flight recorder
closes that gap the way production trace systems do with tail-based
sampling: record everything cheaply in a bounded ring, keep the full
detail only for the interesting minority (errors, degradations, drift
breaches, latency outliers above a windowed p99), and on an anomaly
trigger dump an atomic, schema-versioned post-mortem bundle with
everything a debugging session needs.

Feed path — the existing telemetry sinks, extended by one leg:

- per-request records: the service executor assembles one dict per
  completed/failed/expired request (trace/span ids, stage timings,
  engine/cache/batch/replica outcome) and hands it to
  `record(outcome)` right where it already observes stage histograms;
- anomaly events: `telemetry.event()` mirrors into the recorder via
  `telemetry.set_record_sink` exactly like `count()`/`gauge()` mirror
  into the metrics registry — so `slo_breach`, `replica_quarantined`,
  `drift_breach`, and `perf_regression` emissions reach the trigger
  logic without their emit sites knowing the recorder exists.

Triggers (each rate-limited per reason so a breach storm writes one
bundle, not thousands): SLO sentinel breach, request failure, replica
quarantine, drift breach, a perf-regression sentinel breach
(runtime/obs/regress.py), and the explicit paths — a `dump_debug`
serve request or SIGUSR2 on the serve process.

Bundles are written with runtime/io.py::atomic_write_json under
`--debug-bundle-dir`, validated BEFORE the write by `validate_bundle`
— the single source of truth shared with tools/check_bundle.py, the
same validate()-reuse pattern as ledger.validate_row /
cache.validate_record.

Observation only: the recorder never touches engine inputs or
outputs, and MRC bytes are pinned bit-identical recorder on vs off
(tests/test_recorder.py).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from .. import lockwitness, telemetry
from ..io import atomic_write_json

BUNDLE_VERSION = 1
ACCEPTED_BUNDLE_VERSIONS = (1,)

# Bundle reasons: the five anomaly/explicit trigger paths plus the
# regression sentinel, the SIGUSR2 serve hook, and the final bundle
# the serve loop writes on graceful shutdown (SIGTERM/SIGINT drain).
REASONS = (
    "slo_breach",
    "request_failure",
    "replica_quarantine",
    "drift_breach",
    "perf_regression",
    "dump_debug",
    "signal",
    "shutdown",
)

# telemetry.event() names that fire a bundle when they reach the
# record sink, mapped to their bundle reason.
TRIGGER_EVENTS = {
    "slo_breach": "slo_breach",
    "replica_quarantined": "replica_quarantine",
    "drift_breach": "drift_breach",
    "perf_regression": "perf_regression",
}

# Ring-record retention classes (record["retained"] when kept).
RETAIN_REASONS = ("error", "degraded", "event", "latency_outlier")

_NUM = (int, float)


def _is_num(v) -> bool:
    return isinstance(v, _NUM) and not isinstance(v, bool)


def _span_tree(record: dict) -> dict:
    """Synthesize the request's span tree from its stage timings.

    Serve mode runs without a per-run Telemetry, so the recorder
    rebuilds the span shape the executor would have recorded: a
    `request` root spanning the whole latency with one child per
    non-null stage, in pipeline order. Matches Span.to_dict()'s
    {name, start_s, wall_s, children} shape so trace tooling that
    reads telemetry exports can read bundles too.
    """
    total = record.get("latency_s")
    root: dict = {
        "name": "request",
        "start_s": 0.0,
        "wall_s": float(total) if _is_num(total) else 0.0,
        "attrs": {
            k: record.get(k)
            for k in ("trace_id", "span_id", "engine_used", "cache")
            if record.get(k) is not None
        },
        "children": [],
    }
    t = 0.0
    for stage in ("queue_s", "batch_wait_s", "execute_s", "fetch_s"):
        v = record.get(stage)
        if not _is_num(v):
            continue
        root["children"].append({
            "name": stage[:-2],
            "start_s": round(t, 9),
            "wall_s": float(v),
            "children": [],
        })
        t += float(v)
    return root


def validate_bundle(doc) -> list[str]:
    """All schema violations of one parsed bundle (empty = valid).

    Single source of truth for the writer (validate-before-write, a
    recorder bug fails loudly rather than poisoning the bundle dir)
    AND the offline checker (tools/check_bundle.py). Unknown extra
    keys are allowed, same policy as ledger.validate_row.
    """
    errors: list[str] = []
    if not isinstance(doc, dict):
        return ["bundle is not a JSON object"]
    if doc.get("bundle_version") not in ACCEPTED_BUNDLE_VERSIONS:
        errors.append(
            f"bundle_version must be one of {ACCEPTED_BUNDLE_VERSIONS},"
            f" got {doc.get('bundle_version')!r}"
        )
    if doc.get("reason") not in REASONS:
        errors.append(
            f"'reason' must be one of {REASONS}, got "
            f"{doc.get('reason')!r}"
        )
    if not _is_num(doc.get("ts")) or doc.get("ts", -1) < 0:
        errors.append("'ts' must be a non-negative number")
    if not isinstance(doc.get("trigger"), dict):
        errors.append("'trigger' must be an object")
    if not isinstance(doc.get("records"), list):
        errors.append("'records' must be a list")
    else:
        for i, rec in enumerate(doc["records"]):
            if not isinstance(rec, dict):
                errors.append(f"records[{i}] is not an object")
                continue
            if rec.get("kind") not in ("request", "event"):
                errors.append(
                    f"records[{i}].kind must be 'request' or 'event'"
                )
            if not _is_num(rec.get("ts")) or rec.get("ts", -1) < 0:
                errors.append(
                    f"records[{i}].ts must be a non-negative number"
                )
            if not _is_num(rec.get("seq")):
                errors.append(f"records[{i}].seq must be a number")
            if rec.get("kind") == "request":
                if not isinstance(rec.get("ok"), bool):
                    errors.append(
                        f"records[{i}].ok must be a boolean"
                    )
                if not isinstance(rec.get("span_tree"), dict):
                    errors.append(
                        f"records[{i}].span_tree must be an object"
                    )
            r = rec.get("retained")
            if r is not None and r not in RETAIN_REASONS:
                errors.append(
                    f"records[{i}].retained must be one of "
                    f"{RETAIN_REASONS} or null, got {r!r}"
                )
    for key in ("registry", "config", "state"):
        v = doc.get(key)
        if v is not None and not isinstance(v, dict):
            errors.append(f"'{key}' must be an object or null")
    if not isinstance(doc.get("ledger_tail"), list):
        errors.append("'ledger_tail' must be a list")
    for key in ("host", "devices", "compile_counters", "stats"):
        if not isinstance(doc.get(key), dict):
            errors.append(f"'{key}' must be an object")
    p = doc.get("profile")
    if p is not None and not isinstance(p, str):
        errors.append("'profile' must be a string path or null")
    # the live sampling profiler's snapshot (runtime/obs/profiler.py)
    # rides bundles when --profile-hz is on — distinct from `profile`
    # (the CUDA memory snapshot's file path)
    ps = doc.get("profile_snapshot")
    if ps is not None and not isinstance(ps, dict):
        errors.append("'profile_snapshot' must be an object or null")
    return errors


def _profiler_snapshot(top: int = 50):
    """The live sampling profiler's snapshot with the stack list
    trimmed to the heaviest `top` entries (a bundle is point-in-time
    evidence, not a full export — /debug/profile serves the whole
    thing); None when the profiler is off. Never raises: a profiler
    problem must not sink a post-mortem dump."""
    try:
        from . import profiler

        snap = profiler.snapshot()
    except Exception:
        return None
    if snap is None:
        return None
    snap["stacks"] = snap["stacks"][:top]
    return snap


def _cuda_memory_snapshot(path: str):
    """Pickle torch.cuda.memory._snapshot() to `path` and return it;
    None where torch has no initialized CUDA context (a CPU run), or
    when the capture fails — a post-mortem dump never fails on it."""
    try:
        import pickle

        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return None
        snap = torch.cuda.memory._snapshot()
        with open(path, "wb") as f:
            pickle.dump(snap, f)
        return path
    except Exception:
        return None


class FlightRecorder:
    """Bounded ring of request records + trigger-driven bundle writer.

    Constant memory by construction: one deque of at most `capacity`
    recent records (the context around an anomaly), one deque of at
    most `retain_capacity` interesting records promoted out of the
    ring instead of being evicted (the tail-retention keep set), and a
    fixed-size latency window for the outlier threshold. Everything
    else is O(1) counters.
    """

    def __init__(self, bundle_dir: str, capacity: int = 256,
                 retain_capacity: int = 128,
                 ledger_path: str | None = None,
                 ledger_tail_rows: int = 64,
                 config: dict | None = None,
                 min_interval_s: float = 300.0,
                 outlier_window: int = 512,
                 outlier_min_count: int = 20,
                 state_provider=None, profile: bool = False):
        if capacity < 1 or retain_capacity < 1:
            raise ValueError("capacity and retain_capacity must be >= 1")
        self.bundle_dir = os.fspath(bundle_dir)
        os.makedirs(self.bundle_dir, exist_ok=True)
        self.capacity = int(capacity)
        self.retain_capacity = int(retain_capacity)
        self.ledger_path = ledger_path
        self.ledger_tail_rows = int(ledger_tail_rows)
        self.config = dict(config) if config else None
        self.min_interval_s = float(min_interval_s)
        self.outlier_min_count = int(outlier_min_count)
        self.profile = bool(profile)
        # Called at dump time for live serving state (replica pool
        # snapshot, executor stats); attached by the CLI once the
        # service exists, so construction order stays flexible.
        self.state_provider = state_provider
        self._lock = lockwitness.make_rlock("FlightRecorder._lock")
        self._ring: deque = deque()
        self._retained: deque = deque(maxlen=self.retain_capacity)
        self._latencies: deque = deque(maxlen=max(8, outlier_window))
        self._seq = 0
        self._bundle_seq = 0
        self._seen = 0
        self._evicted = 0
        self._last_bundle: dict[str, float] = {}  # reason -> monotonic
        self._last_bundle_file: str | None = None
        self._triggers: dict[str, int] = {}
        self._suppressed = 0
        self._write_failed = 0

    # -- classification ------------------------------------------------

    def _latency_p99(self) -> float | None:
        """Nearest-rank p99 over the recorder's own rolling latency
        window; None until `outlier_min_count` samples exist (no
        threshold from thin data)."""
        if len(self._latencies) < self.outlier_min_count:
            return None
        vals = sorted(self._latencies)
        idx = max(0, min(len(vals) - 1,
                         int(round(0.99 * (len(vals) - 1)))))
        return vals[idx]

    def _classify(self, record: dict) -> str | None:
        """Retention class of a record, or None for the boring
        majority. Order matters: an error that is also slow retains
        as 'error'."""
        if record.get("kind") == "event":
            # Only anomaly events earn retention — routine emissions
            # (ledger_gc, export notices) ride the ring like any
            # boring record and age out.
            name = record.get("name") or ""
            if name in TRIGGER_EVENTS or name.endswith("_failed"):
                return "event"
            return None
        if record.get("ok") is False or record.get("error"):
            return "error"
        if record.get("degraded"):
            return "degraded"
        lat = record.get("latency_s")
        if _is_num(lat):
            p99 = self._latency_p99()
            if p99 is not None and float(lat) > p99:
                return "latency_outlier"
        return None

    # -- feed paths ----------------------------------------------------

    def record_request(self, record: dict) -> None:
        """Ingest one per-request record from the executor.

        Stamps seq/ts/kind and the synthesized span tree, classifies
        for retention, and — when the record is a failure — fires the
        request_failure trigger. Never raises into the serving path.
        """
        try:
            rec = dict(record)
            rec.setdefault("kind", "request")
            rec.setdefault("ok", not rec.get("error"))
            failed = rec["ok"] is False or bool(rec.get("error"))
            with self._lock:
                evicted = self._ingest_locked(rec)
                if _is_num(rec.get("latency_s")):
                    self._latencies.append(float(rec["latency_s"]))
            self._emit_retained_evicted(evicted)
            telemetry.count("recorder_records")
            if failed:
                self.trigger("request_failure", trigger={
                    k: rec.get(k)
                    for k in ("trace_id", "span_id", "model", "n",
                              "engine_requested", "error")
                })
        except Exception:
            telemetry.count("recorder_record_failed")

    def record_event(self, name: str, data: dict) -> None:
        """telemetry.event() sink leg: anomaly events become retained
        ring records, and trigger events fire a bundle."""
        rec = {"kind": "event", "name": name, "data": dict(data)}
        with self._lock:
            evicted = self._ingest_locked(rec)
        self._emit_retained_evicted(evicted)
        reason = TRIGGER_EVENTS.get(name)
        if reason is not None:
            self.trigger(reason, trigger={"event": name, **data})

    def _ingest_locked(self, rec: dict) -> int:
        """Stamp + append under the lock, promoting the interesting
        on eviction (tail-based retention). Returns how many retained
        records fell off so the caller can emit telemetry after
        releasing `_lock` — the sink legs (metrics registry, and
        record_event right back into this recorder) take their own
        locks."""
        self._seq += 1
        self._seen += 1
        rec["seq"] = self._seq
        rec.setdefault("ts", round(time.time(), 3))
        if rec.get("kind") == "request":
            rec["span_tree"] = _span_tree(rec)
        rec["retained"] = self._classify(rec)
        self._ring.append(rec)
        retained_evicted = 0
        while len(self._ring) > self.capacity:
            old = self._ring.popleft()
            if old.get("retained") is not None:
                if len(self._retained) == self._retained.maxlen:
                    retained_evicted += 1
                self._retained.append(old)
            else:
                self._evicted += 1
        return retained_evicted

    @staticmethod
    def _emit_retained_evicted(evicted: int) -> None:
        for _ in range(evicted):
            telemetry.count("recorder_retained_evicted")

    # -- triggers / bundles --------------------------------------------

    def trigger(self, reason: str, trigger: dict | None = None,
                force: bool = False) -> str | None:
        """Maybe write a bundle for `reason`; returns its path.

        Rate-limited per reason (min_interval_s, monotonic clock) so
        an SLO breach re-evaluated every sentinel tick or a failing
        replica in a tight loop yields ONE bundle per window; `force`
        (the explicit dump_debug / SIGUSR2 paths) bypasses the limit.
        Never raises: a failed write counts recorder_bundle_failed.
        """
        now = time.monotonic()
        with self._lock:
            last = self._last_bundle.get(reason)
            suppressed = (
                not force
                and last is not None
                and (now - last) < self.min_interval_s
            )
            if suppressed:
                self._suppressed += 1
            else:
                self._last_bundle[reason] = now
                self._triggers[reason] = (
                    self._triggers.get(reason, 0) + 1
                )
        if suppressed:
            # sink emission after release (C_SINK_UNDER_LOCK): the
            # suppressed counter must not extend the hold time
            telemetry.count("recorder_bundle_suppressed")
            return None
        try:
            path = self._write_bundle(reason, trigger or {})
        except Exception:
            with self._lock:
                self._write_failed += 1
            telemetry.count("recorder_bundle_failed")
            return None
        telemetry.count("debug_bundles_written")
        return path

    def dump(self, reason: str = "dump_debug",
             trigger: dict | None = None) -> str | None:
        """Explicit bundle (the serve `dump_debug` request / SIGUSR2
        hook): always writes, no rate limit."""
        return self.trigger(reason, trigger=trigger, force=True)

    def snapshot_records(self) -> list[dict]:
        """Retained keep-set + current ring, in ingest order."""
        with self._lock:
            return [dict(r) for r in self._retained] + [
                dict(r) for r in self._ring
            ]

    def stats(self) -> dict:
        with self._lock:
            return {
                "records_seen": self._seen,
                "ring": len(self._ring),
                "retained": len(self._retained),
                "evicted": self._evicted,
                "bundles_written": self._bundle_seq,
                "bundles_suppressed": self._suppressed,
                "bundle_write_failed": self._write_failed,
                "triggers": dict(self._triggers),
                "last_bundle": self._last_bundle_file,
                "latency_p99_s": self._latency_p99(),
            }

    def _write_bundle(self, reason: str, trigger: dict) -> str:
        from . import metrics as obs_metrics
        from . import ledger as obs_ledger

        reg = obs_metrics.get()
        state = None
        if self.state_provider is not None:
            try:
                state = self.state_provider()
            except Exception as e:
                state = {"error": repr(e)}
        ledger_tail: list = []
        if self.ledger_path:
            ledger_tail = obs_ledger.tail(
                self.ledger_path, self.ledger_tail_rows
            )
        with self._lock:
            self._bundle_seq += 1
            seq = self._bundle_seq
            records = self.snapshot_records()
        name = "BUNDLE_%s_%d_%04d_%s.json" % (
            time.strftime("%Y%m%dT%H%M%SZ", time.gmtime()),
            os.getpid(), seq, reason,
        )
        path = os.path.join(self.bundle_dir, name)
        profile_path = None
        if self.profile:
            # Optional device-memory capture: a point-in-time snapshot
            # of the CUDA caching allocator (torch.cuda.memory._snapshot)
            # is the only capture that makes sense post-hoc, pickled
            # beside the bundle. None off CUDA, and None when the
            # capture fails.
            profile_path = _cuda_memory_snapshot(path[:-5] + ".memsnap.pickle")
        doc = {
            "bundle_version": BUNDLE_VERSION,
            "reason": reason,
            "ts": round(time.time(), 3),
            "bundle_seq": seq,
            "trigger": trigger,
            "records": records,
            "registry": reg.snapshot() if reg is not None else None,
            "ledger_tail": ledger_tail,
            "config": self.config,
            "state": state,
            "host": telemetry.host_fingerprint(speed_probe=False),
            "devices": telemetry.device_metrics(),
            "compile_counters": telemetry.compile_counters_snapshot(),
            "stats": self.stats(),
            "profile": profile_path,
            "profile_snapshot": _profiler_snapshot(),
        }
        errors = validate_bundle(doc)
        if errors:
            raise ValueError(
                "invalid bundle: " + "; ".join(errors)
            )
        atomic_write_json(path, doc)
        with self._lock:
            self._last_bundle_file = path
        return path

    def bundle_index(self) -> list[dict]:
        """Written bundles in this recorder's dir, oldest first —
        the `GET /debug/bundles` / dump_debug listing. Reads only
        dirents + stat (reason is embedded in the filename), so
        listing stays cheap with many bundles."""
        out = []
        try:
            names = sorted(
                n for n in os.listdir(self.bundle_dir)
                if n.startswith("BUNDLE_") and n.endswith(".json")
            )
        except OSError:
            return out
        for n in names:
            p = os.path.join(self.bundle_dir, n)
            try:
                st = os.stat(p)
            except OSError:
                continue
            stem = n[:-5].split("_")
            out.append({
                "file": n,
                "reason": "_".join(stem[4:]) if len(stem) > 4 else None,
                "bytes": st.st_size,
                "mtime": round(st.st_mtime, 3),
            })
        return out

    def close(self) -> None:
        pass  # symmetry with the other obs lifecycles; nothing owned


# -- process-global switch --------------------------------------------

_recorder: "FlightRecorder | None" = None
_recorder_lock = lockwitness.make_lock("recorder._recorder_lock")


def enable(bundle_dir: str, **kwargs) -> FlightRecorder:
    """Install a fresh process-global recorder and hook it into the
    telemetry event path (`telemetry.event` mirrors into it). Returns
    the recorder. Each call replaces the previous one."""
    global _recorder
    with _recorder_lock:
        rec = FlightRecorder(bundle_dir, **kwargs)
        _recorder = rec
        telemetry.set_record_sink(rec)
    return rec


def disable() -> "FlightRecorder | None":
    """Unhook and drop the global recorder; returns it (None if
    idle)."""
    global _recorder
    with _recorder_lock:
        rec = _recorder
        _recorder = None
        telemetry.set_record_sink(None)
    return rec


def get() -> "FlightRecorder | None":
    return _recorder


def record(outcome: dict) -> None:
    """Feed one per-request record into the global recorder; no-op
    when disabled. The serving hot path calls this, so the disabled
    cost is one global read + None check."""
    rec = _recorder
    if rec is not None:
        rec.record_request(outcome)
