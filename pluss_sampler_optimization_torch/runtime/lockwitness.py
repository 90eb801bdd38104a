"""Opt-in runtime lockdep witness for the serving runtime.

The static analyzer (analysis/concurrency/) predicts the lock-order
graph; this module observes the real one. Every lock in the threaded
modules is created through the factories here — `make_lock`,
`make_rlock`, `make_condition` — each tagged with the SAME name the
static analyzer derives ("RequestExecutor._lock",
"BatchScheduler._cv", "telemetry._lock", ...). Disabled (the
default), the factories return plain `threading` primitives: zero
wrappers, zero overhead, and the decision is made once at lock
creation, not per acquire.

Enabled (PLUSS_LOCK_WITNESS=1 in the environment, or `enable()`
before the objects under test are constructed), each acquire records
an edge held -> acquired into a global observed-order graph and
checks it against the edges seen so far: an acquire whose REVERSE
edge is already on record is a lock-order inversion — the runtime
proof of what C_LOCK_CYCLE detects statically. Releases track hold
times; holds longer than `long_hold_s` are kept as outliers (the
runtime twin of C_BLOCKING_UNDER_LOCK).

Nothing is emitted inline: recording telemetry from inside the
witness would route through the telemetry sinks' own locks and
perturb the very graph being observed. Callers pull `report()` at a
quiet point (the chaos gate does, after its seeds) and forward the
inversions/outliers to telemetry themselves — `emit_report()` does
both. `tools/check_chaos.py` then asserts observed ⊆ static and zero
inversions, closing the soundness loop the ISSUE asks for.
"""

from __future__ import annotations

import os
import threading
import time

__all__ = [
    "enable", "disable", "enabled", "reset",
    "make_lock", "make_rlock", "make_condition",
    "held_names", "observed_edges", "report", "emit_report",
]

_enabled = bool(os.environ.get("PLUSS_LOCK_WITNESS"))
_long_hold_s = float(
    os.environ.get("PLUSS_LOCK_WITNESS_LONG_HOLD_S", "0.2")
)
_MAX_RECORDS = 200  # inversion/outlier records kept (not counts)

# witness bookkeeping lock — a plain Lock, never itself witnessed
_STATE = threading.Lock()
_edges: dict = {}        # (held, acquired) -> count
_inversions: list = []   # [{edge, reverse_first_seen, thread}]
_inversion_count = 0
_holds: dict = {}        # name -> [count, total_s, max_s]
_long_holds: list = []   # [{name, held_s, thread}]
_long_hold_count = 0
_tls = threading.local()


def enabled() -> bool:
    return _enabled


def enable(long_hold_s: float | None = None) -> None:
    """Turn the witness on for locks created AFTER this call."""
    global _enabled, _long_hold_s
    _enabled = True
    if long_hold_s is not None:
        _long_hold_s = float(long_hold_s)


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Drop all observations (not the enabled flag)."""
    global _inversion_count, _long_hold_count
    with _STATE:
        _edges.clear()
        _inversions.clear()
        _holds.clear()
        _long_holds.clear()
        _inversion_count = 0
        _long_hold_count = 0


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def held_names() -> tuple:
    """Witnessed locks the CURRENT thread holds right now (test
    probes assert sinks run with this empty of source locks)."""
    return tuple(name for name, _t0 in _stack())


def _record_acquire(name: str) -> None:
    global _inversion_count
    stack = _stack()
    held = [h for h, _t0 in stack if h != name]
    if held:
        with _STATE:
            for h in held:
                _edges[(h, name)] = _edges.get((h, name), 0) + 1
                if (name, h) in _edges:
                    _inversion_count += 1
                    if len(_inversions) < _MAX_RECORDS:
                        _inversions.append({
                            "edge": [h, name],
                            "reverse": [name, h],
                            "thread":
                                threading.current_thread().name,
                        })
    stack.append((name, time.perf_counter()))


def _record_release(name: str) -> None:
    global _long_hold_count
    stack = _stack()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i][0] == name:
            _n, t0 = stack.pop(i)
            held_s = time.perf_counter() - t0
            with _STATE:
                slot = _holds.setdefault(name, [0, 0.0, 0.0])
                slot[0] += 1
                slot[1] += held_s
                slot[2] = max(slot[2], held_s)
                if held_s >= _long_hold_s:
                    _long_hold_count += 1
                    if len(_long_holds) < _MAX_RECORDS:
                        _long_holds.append({
                            "name": name,
                            "held_s": round(held_s, 6),
                            "thread":
                                threading.current_thread().name,
                        })
            return


class _WitnessLock:
    """Wrapper around Lock/RLock recording order + hold times."""

    def __init__(self, inner, name: str):
        self._inner = inner
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            _record_acquire(self.name)
        return got

    def release(self) -> None:
        _record_release(self.name)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()


class _WitnessCondition:
    """Condition wrapper; wait() un-records the lock while the
    underlying condition has it released, so a thread parked in
    wait() never reads as holding the lock."""

    def __init__(self, name: str, lock=None):
        self._inner = threading.Condition(lock)
        self.name = name

    def acquire(self, *a, **kw):
        got = self._inner.acquire(*a, **kw)
        if got:
            _record_acquire(self.name)
        return got

    def release(self) -> None:
        _record_release(self.name)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def wait(self, timeout: float | None = None):
        _record_release(self.name)
        try:
            return self._inner.wait(timeout)
        finally:
            _record_acquire(self.name)

    def wait_for(self, predicate, timeout: float | None = None):
        _record_release(self.name)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            _record_acquire(self.name)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


def make_lock(name: str):
    return _WitnessLock(threading.Lock(), name) if _enabled \
        else threading.Lock()


def make_rlock(name: str):
    return _WitnessLock(threading.RLock(), name) if _enabled \
        else threading.RLock()


def make_condition(name: str, lock=None):
    return _WitnessCondition(name, lock) if _enabled \
        else threading.Condition(lock)


def observed_edges() -> set:
    """The observed lock-order graph as {(held, acquired)} name
    pairs — directly comparable to the static analyzer's
    AnalysisResult.edge_pairs()."""
    with _STATE:
        return set(_edges)


def report() -> dict:
    """Snapshot of everything observed. Pure read; emits nothing."""
    with _STATE:
        return {
            "enabled": _enabled,
            "edges": [
                {"src": a, "dst": b, "count": c}
                for (a, b), c in sorted(_edges.items())
            ],
            "inversions": list(_inversions),
            "inversion_count": _inversion_count,
            "long_holds": list(_long_holds),
            "long_hold_count": _long_hold_count,
            "long_hold_s": _long_hold_s,
            "holds": {
                name: {
                    "count": c,
                    "total_s": round(t, 6),
                    "max_s": round(m, 6),
                }
                for name, (c, t, m) in sorted(_holds.items())
            },
        }


def emit_report() -> dict:
    """report(), then forward inversions and long-hold outliers to
    telemetry — called at a quiet point, never from inside a lock."""
    from . import telemetry

    doc = report()
    for inv in doc["inversions"]:
        telemetry.event("lock_witness_inversion", **inv)
    for lh in doc["long_holds"]:
        telemetry.event("lock_witness_long_hold", **lh)
    if doc["inversion_count"]:
        telemetry.count("lock_witness_inversions",
                        doc["inversion_count"])
    return doc
