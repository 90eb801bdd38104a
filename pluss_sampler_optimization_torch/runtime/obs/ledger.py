"""Append-only run ledger: one JSONL row per engine/service execution.

Every run of the engines/service used to vanish once its per-run
telemetry JSON was written — no history, no regression signal across
runs. The ledger is the longitudinal record: the service executor, the
CLI acc/speed/sample modes, bench.py, and the drift monitor each
append one row per execution, all into one file, so a single artifact
answers "what ran, how fast, from which cache tier, degraded how, and
did the MRC change".

Row contract (LEDGER_VERSION, enforced by `validate_row` — the single
source of truth shared with tools/check_ledger.py, the same pattern as
service/cache.py::validate_record):

- every row: `ledger_version`, `ts` (unix seconds), `kind`
  ("request" | "drift" | "bench"), `source` (who wrote it), `ok`;
- kind "request" (service executor / CLI modes): `engine_requested`,
  `engine_used`, `model`, `n`, `latency_s`, `cache` disposition
  (null = direct run, "miss" = cold, "mem"/"disk" = warm tiers),
  `degraded` chain ([{from, to, reason}]), optional `fingerprint`
  (the service content address — CLI rows carry it too when the
  engine is service-addressable, so direct and served executions of
  the same request join on one key), optional `compile_delta`
  (nonzero jax compile-counter movement during the execution) and
  `mrc_digest`, and — for members of a cross-request batched
  execution — `batch_id`/`batch_members`, so joined executions stay
  auditable (the `stats` aggregate rolls them into batch occupancy
  and batched-vs-solo latency); service rows executed under a
  replica pool also carry `replica_id` (which device group served
  the execution — the aggregate's per-replica occupancy) and the
  full `request` payload (what ledger-driven warm start replays);
  rows written by a fabric worker process (service/fabric/) also
  carry `worker_id`, so one shared ledger shards by worker — the
  aggregate's `workers` rollup, with tools/check_ledger.py --stats
  validating rows land on their fingerprint's ring assignment;
- kind "drift" (runtime/obs/drift.py): the sampled-vs-exact MRC error
  metrics (`max_abs_delta` / `mean_abs_delta`) and the `breach` flag;
- kind "bench" (bench.py): the headline `metric`/`value` plus the same
  mrc_digest/latency fields.

Appends are durable single-write O_APPEND lines
(runtime/io.py::append_text_line): concurrent writers never interleave
and a crash leaves at most one truncated tail line, which every reader
here skips (and tools/check_ledger.py --gc removes). Rows are
validated BEFORE hitting the file — a writer bug fails loudly at the
call site, never poisons the ledger.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time

from ..io import append_text_line, atomic_write_text

# v2 (current): request rows gain the trace context (`trace_id`
# joining the row to its — possibly shared — execution span via
# `span_id`) plus per-stage timings (`queue_s`, `batch_wait_s`,
# `execute_s`) and the singleflight `coalesced` join count. All new
# fields are optional, so v1 rows written by older processes remain
# valid: readers accept every version in ACCEPTED_VERSIONS, writers
# stamp LEDGER_VERSION.
LEDGER_VERSION = 2
ACCEPTED_VERSIONS = (1, 2)

KINDS = ("request", "drift", "bench")

# `source` of the fabric router's OWN request rows
# (service/fabric/router.py): one per traced routed response, carrying
# the `router` span block (wire/queue overhead, owning worker) and
# joining the worker's "service" row on trace_id. Aggregation rolls
# them into the `fleet` section — NEVER into the request/engine stats,
# which would double-count every fabric-served request.
ROUTER_SOURCE = "fabric.router"

# numeric span fields a `router` block may carry (all optional and
# nullable; tools/assemble_trace.py turns them into Chrome trace spans)
ROUTER_SPANS = ("router_queue_s", "route_s", "wire_out_s",
                "worker_rtt_s", "wire_back_s", "wire_s", "worker_s")

# cache dispositions a request row may carry: None = direct engine run
# (no store in the path), "miss" = cold service execution, "mem" /
# "disk" = warm service tiers
CACHE_TIERS = (None, "miss", "mem", "disk")

_NUM = (int, float)


def mrc_digest(mrc) -> str:
    """16-hex digest of an MRC's float64 bytes.

    Bit-identical curves (the warm-repeat / exact-engine contract)
    digest identically; any numeric drift changes the digest. Used to
    make degraded or drifted responses attributable in the ledger
    without storing the (up to 327k-entry) curve itself.
    """
    import numpy as np

    a = np.ascontiguousarray(np.asarray(mrc, dtype=np.float64))
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def _is_num(v) -> bool:
    return isinstance(v, _NUM) and not isinstance(v, bool)


def validate_row(row) -> list[str]:
    """All schema violations of one parsed ledger row (empty = valid).

    Single source of truth for `append` (validate-before-write) AND
    the offline checker (tools/check_ledger.py). Unknown extra keys
    are allowed — rows may carry source-specific context (reps,
    thresholds, evidence pointers) without a version bump.
    """
    errors: list[str] = []
    if not isinstance(row, dict):
        return ["row is not a JSON object"]
    if row.get("ledger_version") not in ACCEPTED_VERSIONS:
        errors.append(
            f"ledger_version must be one of {ACCEPTED_VERSIONS}, got "
            f"{row.get('ledger_version')!r}"
        )
    if not _is_num(row.get("ts")) or row.get("ts", -1) < 0:
        errors.append("'ts' must be a non-negative number")
    kind = row.get("kind")
    if kind not in KINDS:
        errors.append(f"'kind' must be one of {KINDS}, got {kind!r}")
    if not isinstance(row.get("source"), str) or not row.get("source"):
        errors.append("'source' must be a non-empty string")
    if not isinstance(row.get("ok"), bool):
        errors.append("'ok' must be a boolean")

    def need_str(key, nullable=False):
        v = row.get(key)
        if v is None and nullable:
            return
        if not isinstance(v, str):
            errors.append(f"'{key}' must be a string"
                          + (" or null" if nullable else ""))

    def need_num(key, nullable=False):
        v = row.get(key)
        if v is None and nullable:
            return
        if not _is_num(v):
            errors.append(f"'{key}' must be a number"
                          + (" or null" if nullable else ""))

    if kind == "request":
        need_str("engine_requested")
        need_str("engine_used", nullable=True)
        need_str("model")
        need_num("n")
        need_num("latency_s", nullable=True)
        if row.get("cache") not in CACHE_TIERS:
            errors.append(
                f"'cache' must be one of {CACHE_TIERS}, got "
                f"{row.get('cache')!r}"
            )
        if not isinstance(row.get("degraded"), list):
            errors.append("'degraded' must be a list")
        need_str("fingerprint", nullable=True)
        need_str("mrc_digest", nullable=True)
        if "compile_delta" in row and not isinstance(
            row["compile_delta"], dict
        ):
            errors.append("'compile_delta' must be an object")
        # batched executions join on these (service/executor.py):
        # optional — solo rows simply omit them
        if "batch_id" in row:
            need_str("batch_id", nullable=True)
        if "batch_members" in row:
            need_num("batch_members", nullable=True)
        # v2 trace context + per-stage timings: optional in both
        # versions (a v1 row never carries them; a v2 row may omit
        # stages that did not apply, e.g. batch_wait for solo runs)
        if "trace_id" in row:
            need_str("trace_id", nullable=True)
        if "span_id" in row:
            need_str("span_id", nullable=True)
        for stage in ("queue_s", "batch_wait_s", "execute_s"):
            if stage in row:
                need_num(stage, nullable=True)
        if "coalesced" in row:
            need_num("coalesced", nullable=True)
        # replica-pool context: which device group served the
        # execution, and the replayable request payload warm start
        # reads — optional, solo/poolless rows simply omit them
        if "replica_id" in row:
            need_num("replica_id", nullable=True)
        # fabric context: which worker process of a multi-process
        # fabric appended this row (service/fabric/) — optional,
        # single-process rows omit it. tools/check_ledger.py --stats
        # additionally validates rows shard by ring assignment
        if "worker_id" in row:
            need_num("worker_id", nullable=True)
        # the fabric router's span block (source fabric.router rows):
        # which worker the request was routed to plus the router-side
        # monotonic-delta spans assemble_trace joins on trace_id
        if "router" in row:
            rb = row["router"]
            if not isinstance(rb, dict):
                errors.append("'router' must be an object")
            else:
                for key in ("worker_id", "hops") + ROUTER_SPANS:
                    v = rb.get(key)
                    if v is not None and not _is_num(v):
                        errors.append(
                            f"'router.{key}' must be a number or null"
                        )
        if "request" in row and not isinstance(row["request"], dict):
            errors.append("'request' must be an object")
        # ir-preflight verdict (service/api.py static-analysis gate):
        # "ok" | "race" on served rows, "invalid" on rejection rows —
        # optional, rows from preflight-disabled services omit it
        if "preflight" in row:
            need_str("preflight", nullable=True)
        # resilience outcomes (service/executor.py): shed = refused at
        # the admission gate; hedged = a duplicate dispatch raced for
        # this row; retries = extra attempts spent. All optional —
        # quiet rows omit them, keeping their pre-resilience bytes
        for flag in ("shed", "hedged"):
            if flag in row and not isinstance(row[flag], bool):
                errors.append(f"'{flag}' must be a boolean")
        if "retries" in row:
            need_num("retries", nullable=True)
        # progressive precision (service/executor.py): rounds actually
        # run, the final bootstrap confidence-band width, and whether
        # the band converged (vs a deadline partial_final). All
        # optional — non-progressive rows keep their exact bytes
        if "rounds" in row:
            need_num("rounds", nullable=True)
        if "band_width" in row:
            need_num("band_width", nullable=True)
        if "converged" in row and not isinstance(
            row["converged"], bool
        ):
            errors.append("'converged' must be a boolean")
        # per-request utilization attribution block
        # (runtime/obs/attribution.py): optional — rows written
        # without the attribution layer keep their exact shape
        if "utilization" in row and row["utilization"] is not None:
            from .attribution import validate_block

            errors.extend(validate_block(row["utilization"]))
    elif kind == "drift":
        need_str("model")
        need_num("n")
        need_num("max_abs_delta")
        need_num("mean_abs_delta")
        if not isinstance(row.get("breach"), bool):
            errors.append("'breach' must be a boolean")
        # progressive-precision audits may judge against their own
        # confidence band (runtime/obs/drift.py::breach_verdict) —
        # optional, band-less rows stay valid unchanged
        if "band_width" in row:
            need_num("band_width", nullable=True)
    elif kind == "bench":
        need_str("metric")
        need_num("value")
    return errors


def append(path: str, row: dict) -> dict:
    """Stamp, validate, and durably append one row; returns the row.

    Stamps `ledger_version` and `ts` when absent. Raises ValueError on
    an invalid row — writers that must never fail a request wrap this
    (service/executor.py counts `service_ledger_write_failed`).
    """
    row = dict(row)
    row.setdefault("ledger_version", LEDGER_VERSION)
    row.setdefault("ts", round(time.time(), 3))
    errors = validate_row(row)
    if errors:
        raise ValueError(
            "invalid ledger row: " + "; ".join(errors)
        )
    append_text_line(
        path, json.dumps(row, sort_keys=True, separators=(",", ":"))
    )
    return row


def iter_rows(path: str):
    """Yield (line_no, row | None, error | None) per non-blank line.

    Unparseable or schema-invalid lines come back with row=None and
    the reason — readers decide whether to skip (stats) or report
    (the checker). Never raises on content, only on an unreadable
    file.
    """
    with open(path) as f:
        for line_no, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError as e:
                yield line_no, None, f"invalid JSON: {e}"
                continue
            errors = validate_row(row)
            if errors:
                yield line_no, None, "; ".join(errors)
                continue
            yield line_no, row, None


def read_rows(path: str) -> list[dict]:
    """All valid rows, in file order (invalid lines skipped)."""
    return [row for _ln, row, _err in iter_rows(path) if row is not None]


def tail(path: str, n: int = 5) -> list[dict]:
    """The last n valid rows (empty list for a missing ledger)."""
    try:
        rows = read_rows(path)
    except OSError:
        return []
    return rows[-n:] if n > 0 else []


# -- scan / compaction (tools/check_ledger.py + serve-mode GC) ---------


def scan(path: str, max_age_days: float = 0.0,
         max_rows: int = 0, now: float | None = None) -> dict:
    """Classify every ledger line for compaction.

    Returns {"valid": [rows...], "invalid": [(line_no, error)],
    "stale": [rows...], "surplus": [rows...]} — stale (older than
    max_age_days, 0 = no age limit) and surplus (beyond the newest
    max_rows, 0 = unbounded) rows are valid rows that `compact` would
    drop. Single source of truth shared by tools/check_ledger.py and
    the serve-mode background GC.
    """
    out: dict = {"valid": [], "invalid": [], "stale": [], "surplus": []}
    if now is None:
        now = time.time()
    max_age_s = max_age_days * 86400.0
    fresh: list = []
    for line_no, row, error in iter_rows(path):
        if row is None:
            out["invalid"].append((line_no, error))
            continue
        if max_age_s > 0 and (now - float(row["ts"])) > max_age_s:
            out["stale"].append(row)
            continue
        fresh.append(row)
    if max_rows > 0 and len(fresh) > max_rows:
        out["surplus"] = fresh[: len(fresh) - max_rows]
        fresh = fresh[len(fresh) - max_rows:]
    out["valid"] = fresh
    return out


def compact(path: str, max_age_days: float = 0.0,
            max_rows: int = 0) -> dict:
    """Atomically rewrite the ledger keeping only valid, fresh rows.

    The scan classifies; when anything would be dropped, the kept rows
    are rewritten via atomic_write_text (tmp + fsync + rename), so a
    reader — or a concurrent appender racing the rename — always sees
    a complete file. Returns the scan dict with a "dropped" count
    added (0 = the file was already clean and was left untouched).
    """
    s = scan(path, max_age_days=max_age_days, max_rows=max_rows)
    dropped = (
        len(s["invalid"]) + len(s["stale"]) + len(s["surplus"])
    )
    if dropped:
        atomic_write_text(path, "".join(
            json.dumps(row, sort_keys=True, separators=(",", ":"))
            + "\n"
            for row in s["valid"]
        ))
    s["dropped"] = dropped
    return s


class LedgerGC:
    """Serve-mode background ledger compaction on a fixed interval.

    Soak runs append one row per request; without a bound the ledger
    grows past what `tail`/`aggregate` readers can usefully scan. This
    thread runs `compact(path, max_age_days, max_rows)` every
    `interval_s` seconds, counting each pass into telemetry (and so
    the live registry): `ledger_gc_runs`, and `ledger_gc_dropped` when
    rows were actually removed. A failing pass counts
    `ledger_gc_failed` and never takes the serving loop down.
    """

    def __init__(self, path: str, interval_s: float = 60.0,
                 max_rows: int = 0, max_age_days: float = 0.0):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.path = path
        self.interval_s = float(interval_s)
        self.max_rows = int(max_rows)
        self.max_age_days = float(max_age_days)
        self.last_scan: dict | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def run_once(self) -> dict:
        """One compaction pass (also the final flush on close)."""
        from .. import telemetry

        s = compact(self.path, max_age_days=self.max_age_days,
                    max_rows=self.max_rows)
        self.last_scan = s
        telemetry.count("ledger_gc_runs")
        if s["dropped"]:
            telemetry.count("ledger_gc_dropped", s["dropped"])
            telemetry.event(
                "ledger_gc", path=self.path, dropped=s["dropped"],
                kept=len(s["valid"]),
            )
        return s

    def _loop(self) -> None:
        from .. import telemetry

        while not self._stop.wait(self.interval_s):
            try:
                self.run_once()
            except Exception:
                telemetry.count("ledger_gc_failed")

    def start(self) -> "LedgerGC":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, name="pluss-ledger-gc", daemon=True
        )
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# -- aggregation (the CLI `stats` mode) --------------------------------


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile on a pre-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = max(0, min(len(sorted_vals) - 1,
                     int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def aggregate(rows: list[dict]) -> dict:
    """Roll a ledger up into the per-engine serving picture: request
    counts, p50/p95 latency, cache-tier hit rates, degradation and
    failure counts, plus the latest drift metrics per (model, n) and
    the bench row count."""
    requests: dict = {}
    drift: dict = {}
    bench = 0
    by_kind: dict = {}
    batches: dict = {}
    lat_batched: list[float] = []
    lat_solo: list[float] = []
    # unified service counters (the ledger view of the same numbers
    # the executor's `stats` snapshot and the Prometheus export
    # report): one row per non-coalesced submit, plus the row's
    # `coalesced` count for singleflight joiners
    service = {"submitted": 0, "coalesced": 0, "completed": 0,
               "failed": 0, "degraded": 0, "preflight_rejected": 0,
               "race_flagged": 0, "shed": 0, "retried": 0,
               "hedged": 0}
    # per-replica occupancy at execution grain: one request row per
    # served execution, grouped by the replica that ran it — the
    # ledger face of the executor's `replicas` snapshot and the
    # requests_routed_r* counters
    replicas: dict = {}
    # per-fabric-worker rollup: a shared ledger written by N worker
    # processes (service/fabric/) shards by worker_id; this is the
    # offline face of the router's per-link dispatch counters
    workers: dict = {}
    # the router's OWN rows (source fabric.router): per-worker routed
    # share + wire/queue overhead percentiles. They describe the same
    # requests the worker rows do, so they are rolled up HERE and
    # excluded from every request/engine/service stat below — counting
    # them there would double every fabric-served request
    fleet_workers: dict = {}
    fleet_wire: list[float] = []
    fleet_overhead: list[float] = []
    for row in rows:
        kind = row["kind"]
        by_kind[kind] = by_kind.get(kind, 0) + 1
        if kind == "request" and row.get("source") == ROUTER_SOURCE:
            rb = row.get("router") or {}
            wid = rb.get("worker_id")
            f = fleet_workers.setdefault(
                int(wid) if wid is not None else -1,
                {"rows": 0, "ok": 0, "redispatched": 0},
            )
            f["rows"] += 1
            if row["ok"]:
                f["ok"] += 1
            if rb.get("hops"):
                f["redispatched"] += 1
            if rb.get("wire_s") is not None:
                fleet_wire.append(float(rb["wire_s"]))
            parts = [rb.get("router_queue_s"), rb.get("route_s"),
                     rb.get("wire_s")]
            if any(p is not None for p in parts):
                fleet_overhead.append(
                    sum(float(p) for p in parts if p is not None)
                )
            continue
        if kind == "request":
            if row.get("source") == "service":
                joiners = int(row.get("coalesced") or 0)
                service["submitted"] += 1 + joiners
                service["coalesced"] += joiners
                # shed rows are neither completions nor failures: the
                # service refused the work at the admission gate (the
                # same three-way split the executor's live counters
                # report)
                if row.get("shed"):
                    service["shed"] += 1
                else:
                    service[
                        "completed" if row["ok"] else "failed"
                    ] += 1
                if row.get("degraded"):
                    service["degraded"] += 1
                service["retried"] += int(row.get("retries") or 0)
                if row.get("hedged"):
                    service["hedged"] += 1
                pf = row.get("preflight")
                if pf == "invalid":
                    service["preflight_rejected"] += 1
                elif pf == "race":
                    service["race_flagged"] += 1
            rid = row.get("replica_id")
            if rid is not None:
                r = replicas.setdefault(
                    int(rid), {"rows": 0, "ok": 0, "degraded": 0}
                )
                r["rows"] += 1
                if row["ok"]:
                    r["ok"] += 1
                if row.get("degraded"):
                    r["degraded"] += 1
            wid = row.get("worker_id")
            if wid is not None:
                w = workers.setdefault(int(wid), {
                    "rows": 0, "ok": 0, "degraded": 0,
                    "latencies": [],
                    "cache": {"mem": 0, "disk": 0, "miss": 0,
                              "direct": 0},
                })
                w["rows"] += 1
                if row["ok"]:
                    w["ok"] += 1
                if row.get("degraded"):
                    w["degraded"] += 1
                if row.get("latency_s") is not None:
                    w["latencies"].append(float(row["latency_s"]))
                wtier = row.get("cache")
                w["cache"][wtier if wtier else "direct"] += 1
            bid = row.get("batch_id")
            if bid is not None:
                b = batches.setdefault(bid, {"rows": 0, "members": 0})
                b["rows"] += 1
                b["members"] = max(
                    b["members"], int(row.get("batch_members") or 0)
                )
            # cold executions only: warm tiers would swamp the
            # batched-vs-solo latency comparison
            if row["ok"] and row.get("cache") == "miss" and (
                row.get("latency_s") is not None
            ):
                (lat_batched if bid is not None
                 else lat_solo).append(float(row["latency_s"]))
            eng = row["engine_requested"]
            agg = requests.setdefault(eng, {
                "count": 0, "ok": 0, "failed": 0, "degraded": 0,
                "latencies": [], "busy_fractions": [],
                "unattributed_fractions": [],
                "cache": {"mem": 0, "disk": 0, "miss": 0, "direct": 0},
            })
            util = row.get("utilization")
            if isinstance(util, dict):
                bf = util.get("busy_fraction")
                uf = util.get("unattributed_fraction")
                if isinstance(bf, (int, float)):
                    agg["busy_fractions"].append(float(bf))
                if isinstance(uf, (int, float)):
                    agg["unattributed_fractions"].append(float(uf))
            agg["count"] += 1
            if row["ok"]:
                agg["ok"] += 1
            else:
                agg["failed"] += 1
            if row.get("degraded"):
                agg["degraded"] += 1
            if row.get("latency_s") is not None:
                agg["latencies"].append(float(row["latency_s"]))
            tier = row.get("cache")
            agg["cache"][tier if tier else "direct"] += 1
        elif kind == "drift":
            # latest row wins per (model, n): the monitor's current view
            drift[(row["model"], row["n"])] = row
        elif kind == "bench":
            bench += 1
    for agg in requests.values():
        lats = sorted(agg.pop("latencies"))
        agg["p50_latency_s"] = round(_percentile(lats, 0.50), 6)
        agg["p95_latency_s"] = round(_percentile(lats, 0.95), 6)
        warm = agg["cache"]["mem"] + agg["cache"]["disk"]
        served = warm + agg["cache"]["miss"]
        agg["cache_hit_rate"] = (
            round(warm / served, 3) if served else None
        )
        # utilization attribution rollup: mean busy + tail
        # unattributed per engine (rows without a block contribute
        # nothing — both stay None when no row carried one)
        busy = agg.pop("busy_fractions")
        unatt = sorted(agg.pop("unattributed_fractions"))
        agg["utilization_rows"] = len(busy)
        agg["mean_busy_fraction"] = (
            round(sum(busy) / len(busy), 4) if busy else None
        )
        agg["p95_unattributed_fraction"] = (
            round(_percentile(unatt, 0.95), 4) if unatt else None
        )
    for w in workers.values():
        wl = sorted(w.pop("latencies"))
        w["p50_latency_s"] = round(_percentile(wl, 0.50), 6)
        w["p95_latency_s"] = round(_percentile(wl, 0.95), 6)
        wwarm = w["cache"]["mem"] + w["cache"]["disk"]
        wserved = wwarm + w["cache"]["miss"]
        w["cache_hit_rate"] = (
            round(wwarm / wserved, 3) if wserved else None
        )
    occupancy = sorted(
        max(b["rows"], b["members"]) for b in batches.values()
    )
    lat_batched.sort()
    lat_solo.sort()
    batching = {
        "batches": len(batches),
        "batched_requests": sum(b["rows"] for b in batches.values()),
        "occupancy_p50": _percentile(occupancy, 0.50),
        "occupancy_p95": _percentile(occupancy, 0.95),
        "batched_p50_latency_s": round(
            _percentile(lat_batched, 0.50), 6
        ),
        "solo_p50_latency_s": round(_percentile(lat_solo, 0.50), 6),
    }
    fleet = None
    if fleet_workers:
        total = sum(f["rows"] for f in fleet_workers.values())
        for f in fleet_workers.values():
            f["share"] = round(f["rows"] / total, 3) if total else 0.0
        fleet_wire.sort()
        fleet_overhead.sort()
        fleet = {
            "rows": total,
            "workers": fleet_workers,
            "wire_p50_s": round(_percentile(fleet_wire, 0.50), 6),
            "wire_p95_s": round(_percentile(fleet_wire, 0.95), 6),
            "overhead_p50_s": round(
                _percentile(fleet_overhead, 0.50), 6),
            "overhead_p95_s": round(
                _percentile(fleet_overhead, 0.95), 6),
        }
    return {
        "rows": len(rows),
        "by_kind": by_kind,
        "requests": requests,
        "drift": [
            drift[k] for k in sorted(drift, key=lambda k: (k[0], k[1]))
        ],
        "bench_rows": bench,
        "batching": batching,
        "service": service,
        "replicas": replicas,
        "workers": workers,
        "fleet": fleet,
    }


def format_stats(agg: dict) -> list[str]:
    """The aggregate as the CLI `stats` mode's printed table."""
    lines = [
        "ledger: %d rows (%s)" % (
            agg["rows"],
            ", ".join(f"{k}={v}"
                      for k, v in sorted(agg["by_kind"].items()))
            or "empty",
        )
    ]
    if agg["requests"]:
        lines.append(
            f"{'engine':<10} {'reqs':>5} {'ok':>4} {'fail':>4} "
            f"{'p50_s':>9} {'p95_s':>9} {'mem':>4} {'disk':>4} "
            f"{'miss':>4} {'dir':>4} {'hit%':>5} {'degr':>4}"
        )
        for eng in sorted(agg["requests"]):
            a = agg["requests"][eng]
            c = a["cache"]
            hit = (
                f"{a['cache_hit_rate'] * 100:.0f}"
                if a["cache_hit_rate"] is not None else "-"
            )
            lines.append(
                f"{eng:<10} {a['count']:>5} {a['ok']:>4} "
                f"{a['failed']:>4} {a['p50_latency_s']:>9.4f} "
                f"{a['p95_latency_s']:>9.4f} {c['mem']:>4} "
                f"{c['disk']:>4} {c['miss']:>4} {c['direct']:>4} "
                f"{hit:>5} {a['degraded']:>4}"
            )
    util_parts = [
        "%s busy=%.2f p95_unattr=%.2f (%d rows)" % (
            eng, a["mean_busy_fraction"],
            a["p95_unattributed_fraction"], a["utilization_rows"],
        )
        for eng, a in sorted(agg["requests"].items())
        if a.get("mean_busy_fraction") is not None
    ]
    if util_parts:
        lines.append("utilization: " + ", ".join(util_parts))
    for row in agg["drift"]:
        lines.append(
            "drift %s n=%d: max_abs=%.4f mean_abs=%.5f %s" % (
                row["model"], row["n"], row["max_abs_delta"],
                row["mean_abs_delta"],
                "BREACH" if row["breach"] else "ok",
            )
        )
    b = agg.get("batching")
    if b and b["batches"]:
        lines.append(
            "batching: %d batches, %d member rows, occupancy "
            "p50=%g p95=%g, cold p50 batched=%.4fs solo=%.4fs" % (
                b["batches"], b["batched_requests"],
                b["occupancy_p50"], b["occupancy_p95"],
                b["batched_p50_latency_s"], b["solo_p50_latency_s"],
            )
        )
    svc = agg.get("service") or {}
    if svc.get("preflight_rejected") or svc.get("race_flagged"):
        lines.append(
            "preflight: %d rejected (invalid IR), %d served with a "
            "race verdict" % (
                svc.get("preflight_rejected", 0),
                svc.get("race_flagged", 0),
            )
        )
    reps = agg.get("replicas")
    if reps:
        parts = ", ".join(
            "r%d=%d%s" % (
                rid, r["rows"],
                (" (degraded %d)" % r["degraded"])
                if r["degraded"] else "",
            )
            for rid, r in sorted(reps.items())
        )
        lines.append(
            "replicas: %d active, executions %s" % (len(reps), parts)
        )
    fws = agg.get("workers")
    if fws:
        parts = ", ".join(
            "w%d=%d p50=%.4fs p95=%.4fs hit%%=%s%s" % (
                wid, w["rows"], w["p50_latency_s"],
                w["p95_latency_s"],
                ("%.0f" % (w["cache_hit_rate"] * 100))
                if w["cache_hit_rate"] is not None else "-",
                (" (degraded %d)" % w["degraded"])
                if w["degraded"] else "",
            )
            for wid, w in sorted(fws.items())
        )
        lines.append(
            "workers: %d fabric worker(s), %s" % (len(fws), parts)
        )
    fl = agg.get("fleet")
    if fl:
        parts = " ".join(
            "w%d=%.0f%%%s" % (
                wid, f["share"] * 100,
                (" (redisp %d)" % f["redispatched"])
                if f["redispatched"] else "",
            )
            for wid, f in sorted(fl["workers"].items())
        )
        lines.append(
            "fleet: %d routed rows, share %s, wire p50=%.6fs "
            "p95=%.6fs, overhead p50=%.6fs p95=%.6fs" % (
                fl["rows"], parts, fl["wire_p50_s"],
                fl["wire_p95_s"], fl["overhead_p50_s"],
                fl["overhead_p95_s"],
            )
        )
    svc = agg.get("service")
    if svc and svc["submitted"]:
        lines.append(
            "service: submitted=%d coalesced=%d completed=%d "
            "failed=%d degraded=%d" % (
                svc["submitted"], svc["coalesced"], svc["completed"],
                svc["failed"], svc["degraded"],
            )
        )
    if svc and (svc.get("shed") or svc.get("retried")
                or svc.get("hedged")):
        lines.append(
            "resilience: shed=%d retried=%d hedged=%d" % (
                svc.get("shed", 0), svc.get("retried", 0),
                svc.get("hedged", 0),
            )
        )
    if agg["bench_rows"]:
        lines.append(f"bench rows: {agg['bench_rows']}")
    return lines
