"""Two-tier content-addressed result store.

Tier 1 is a bounded in-memory LRU (OrderedDict, same discipline as the
kernel signature caches in sampler/sampled.py); tier 2 is an on-disk
store addressed by fingerprint — `<dir>/<fp[:2]>/<fp>.json`, the
standard content-address fan-out so a hot directory never accumulates
hundreds of thousands of siblings.

Records are versioned JSON (STORE_VERSION) written atomically
(runtime/io.py::atomic_write_json — a killed process never leaves a
truncated record). Loads are corruption-tolerant by contract: any
unreadable/unparseable/wrong-version/mis-addressed record is a MISS
(counted as `service_cache_corrupt`), never an exception — the
executor simply recomputes and overwrites. A corrupt file is also
QUARANTINED: atomically renamed to `<fp>.json.corrupt` (counted
`cache_corrupt_quarantined`), so a record that keeps failing
validation is parsed once, not on every subsequent hit, and the
damaged bytes survive for post-mortem while `put` rewrites the live
address. `tools/check_service_store.py` audits and garbage-collects
a store offline with the same validation.

Chaos: the disk tier carries the `cache_load` / `cache_store`
injection sites (runtime/faults.py): a corrupt-kind fault mangles the
just-parsed record (driving the real quarantine path end to end), a
raise-kind store fault exercises the degrade-to-memory-only path.
Both are inert no-ops unless an injector is installed.

Telemetry: `service_cache_hit_mem` / `service_cache_hit_disk` /
`service_cache_miss` / `service_cache_corrupt` /
`service_cache_corrupt_quarantined` / `service_cache_evictions`
counters land in the active run, so a serve session's JSON export
shows its hit ratio next to the engines' own dispatch counters.
"""

from __future__ import annotations

import collections
import json
import os
import threading

from ..runtime import faults, lockwitness, telemetry
from ..runtime.io import atomic_write_json

# Version of the RESULT RECORD shape (the dict produced by
# service/executor.py::execute_request). Bump together with any change
# to that shape; fingerprint.FINGERPRINT_VERSION covers the KEY side.
STORE_VERSION = 1

# Keys every stored record must carry to be served from cache.
REQUIRED_KEYS = (
    "store_version",
    "fingerprint",
    "engine_used",
    "total_accesses",
    "access_label",
    "rih",
    "mrc",
    "dump_lines",
    "created_at",
)


def validate_record(record, fingerprint: str | None = None) -> list[str]:
    """All schema violations of one parsed record (empty = valid).

    Single source of truth for the in-process load path AND the
    offline store checker (tools/check_service_store.py), exactly the
    pattern tools/check_telemetry_schema.py::validate set.
    """
    errors: list[str] = []
    if not isinstance(record, dict):
        return ["record is not a JSON object"]
    if record.get("store_version") != STORE_VERSION:
        errors.append(
            f"store_version must be {STORE_VERSION}, got "
            f"{record.get('store_version')!r}"
        )
    for key in REQUIRED_KEYS:
        if key not in record:
            errors.append(f"missing required key '{key}'")
    if fingerprint is not None and record.get("fingerprint") != fingerprint:
        errors.append(
            f"fingerprint mismatch: record says "
            f"{record.get('fingerprint')!r}, address is {fingerprint!r}"
        )
    mrc = record.get("mrc")
    if not (
        isinstance(mrc, list)
        and all(
            isinstance(v, (int, float)) and not isinstance(v, bool)
            for v in mrc
        )
    ):
        errors.append("'mrc' must be a list of numbers")
    rih = record.get("rih")
    if not (
        isinstance(rih, dict)
        and all(
            isinstance(k, str)
            and isinstance(v, (int, float))
            and not isinstance(v, bool)
            for k, v in rih.items()
        )
    ):
        errors.append("'rih' must be an object of numeric counts")
    if not isinstance(record.get("dump_lines"), list) or not all(
        isinstance(ln, str) for ln in record.get("dump_lines", [])
    ):
        errors.append("'dump_lines' must be a list of strings")
    ta = record.get("total_accesses")
    if not isinstance(ta, (int, float)) or isinstance(ta, bool):
        errors.append("'total_accesses' must be a number")
    if not isinstance(record.get("engine_used"), str):
        errors.append("'engine_used' must be a string")
    return errors


class ResultCache:
    """Thread-safe two-tier store; `cache_dir=None` is memory-only."""

    def __init__(self, cache_dir: str | None = None,
                 mem_entries: int = 128):
        self.cache_dir = os.fspath(cache_dir) if cache_dir else None
        self.mem_entries = mem_entries
        self._mem: collections.OrderedDict = collections.OrderedDict()
        self._lock = lockwitness.make_lock("ResultCache._lock")
        # instance-local mirror of the telemetry counters: the serve
        # introspection protocol (`stats` request) must report cache
        # health even when no telemetry run is active
        self._stats = collections.Counter()
        if self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)

    def stats(self) -> dict:
        """Lifetime counters + current occupancy, for the service's
        `stats` introspection response."""
        with self._lock:
            out = dict(self._stats)
            out.setdefault("hit_mem", 0)
            out.setdefault("hit_disk", 0)
            out.setdefault("miss", 0)
            out.setdefault("corrupt", 0)
            out.setdefault("corrupt_quarantined", 0)
            out.setdefault("evictions", 0)
            out.setdefault("write_failed", 0)
            out["mem_entries"] = len(self._mem)
        out["mem_capacity"] = self.mem_entries
        out["disk_tier"] = bool(self.cache_dir)
        return out

    def _count(self, key: str) -> None:
        with self._lock:
            self._stats[key] += 1

    def path_for(self, fingerprint: str) -> str:
        if not self.cache_dir:
            raise ValueError("cache has no disk tier")
        return os.path.join(
            self.cache_dir, fingerprint[:2], fingerprint + ".json"
        )

    # -- lookup -------------------------------------------------------

    def get(self, fingerprint: str):
        """(record, tier) with tier in {"mem", "disk"}, or (None,
        "miss"). Corrupt disk entries are misses; the caller
        recomputes and `put` overwrites them."""
        with self._lock:
            rec = self._mem.get(fingerprint)
            if rec is not None:
                self._mem.move_to_end(fingerprint)
                self._stats["hit_mem"] += 1
        if rec is not None:
            # sink emission stays outside the critical section: the
            # metrics registry has its own lock and the flight
            # recorder does real work (C_SINK_UNDER_LOCK)
            telemetry.count("service_cache_hit_mem")
            return rec, "mem"
        if self.cache_dir:
            rec = self._load_disk(fingerprint)
            if rec is not None:
                with self._lock:
                    evicted = self._mem_put_locked(fingerprint, rec)
                self._emit_evictions(evicted)
                self._count("hit_disk")
                telemetry.count("service_cache_hit_disk")
                return rec, "disk"
        self._count("miss")
        telemetry.count("service_cache_miss")
        return None, "miss"

    def _load_disk(self, fingerprint: str):
        path = self.path_for(fingerprint)
        try:
            with open(path) as f:
                rec = json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError):
            self._corrupt(path)
            return None
        rec = faults.mangle("cache_load", rec, key=fingerprint)
        if validate_record(rec, fingerprint):
            self._corrupt(path)
            return None
        return rec

    def _corrupt(self, path: str) -> None:
        """Count one corrupt record and quarantine the file: an atomic
        rename to `*.corrupt` so the bad bytes are (a) never re-parsed
        on the next lookup — the address misses cleanly until `put`
        rewrites it — and (b) preserved for offline post-mortem
        (tools/check_service_store.py reports them as stray files)."""
        self._count("corrupt")
        telemetry.count("service_cache_corrupt")
        try:
            os.replace(path, path + ".corrupt")
        except OSError:
            return
        self._count("corrupt_quarantined")
        telemetry.count("service_cache_corrupt_quarantined")

    # -- store --------------------------------------------------------

    def put(self, fingerprint: str, record: dict) -> None:
        with self._lock:
            evicted = self._mem_put_locked(fingerprint, record)
        self._emit_evictions(evicted)
        if self.cache_dir:
            path = self.path_for(fingerprint)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            try:
                faults.fire("cache_store", key=fingerprint)
                atomic_write_json(path, record)
            except (OSError, faults.FaultInjected):
                # a full/readonly disk (or an injected store fault)
                # degrades to memory-only serving; the result itself
                # still reaches the caller
                self._count("write_failed")
                telemetry.count("service_cache_write_failed")

    def _mem_put_locked(self, fingerprint: str, record: dict) -> int:
        """Install + LRU-evict; caller holds `_lock`. Returns the
        eviction count so the caller can emit telemetry after
        release."""
        self._mem[fingerprint] = record
        self._mem.move_to_end(fingerprint)
        evicted = 0
        while len(self._mem) > self.mem_entries:
            self._mem.popitem(last=False)
            self._stats["evictions"] += 1
            evicted += 1
        return evicted

    @staticmethod
    def _emit_evictions(evicted: int) -> None:
        for _ in range(evicted):
            telemetry.count("service_cache_evictions")
