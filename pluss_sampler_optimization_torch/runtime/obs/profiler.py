"""Sampling wall-clock profiler with telemetry-span attribution.

The telemetry spans (runtime/telemetry.py) time what we chose to
instrument; the five bench rounds of a flat ~80–110× headline showed
the limits of that: the gaps BETWEEN spans — interpreter overhead
around dispatches, queue handoffs, device-idle stretches — are
exactly the time nobody can account for. This module is the
complementary view: a background thread samples every live thread's
Python stack at a configurable rate (`sys._current_frames()`-based —
no signals, works from any thread, never interrupts user code) and
folds the samples into bounded collapsed-stack counts.

The key move is the join with the span layer: each sample is tagged
with the sampled thread's *current telemetry span path* (read from
the cross-thread registry `telemetry.span_paths_by_thread()`), so
every flame cell is attributable to a request stage
(draw/dispatch/fetch/merge/queue/...) or explicitly `unattributed` —
the unattributed fraction is the finding, not noise to discard.

Exports:

- `snapshot()` — JSON-safe dict (schema `PROFILE_VERSION`): sample
  totals, attribution stats, per-span-path sample seconds, and the
  collapsed stacks sorted by weight (deterministic order);
- `write_speedscope(path)` — speedscope-compatible JSON
  (https://www.speedscope.app; "sampled" profile, one weighted sample
  per collapsed stack, a synthetic `span:<path>` root frame carrying
  the attribution);
- `write_collapsed(path)` — classic `frame;frame;frame count` text
  (flamegraph.pl / speedscope both ingest it).

All exports are atomic writes (runtime/io.py) and byte-stable given a
fixed sample log: folding is order-independent (a dict keyed by
(span path, frame tuple)) and every export sorts deterministically,
so exporting the same collected samples twice produces identical
bytes (tools/check_profile.py gates this).

Costs are bounded by construction: stack depth is capped, the fold
table is capped (overflow samples are counted, never grown), and the
sampler thread holds the profiler lock only to fold one sample.
Overhead on the hot engine path is pinned < 3% with MRC bytes
bit-identical profiler on vs off (tools/check_profile.py, tier-1 via
tests/test_profiler.py).
"""

from __future__ import annotations

import os
import random
import sys
import threading
import time

from .. import lockwitness, telemetry
from ..io import atomic_write_text

PROFILE_VERSION = 1

# Fold-table bound: a pathological workload degrades to counting
# overflow samples under the sentinel key instead of growing without
# bound. 4096 distinct (span path, stack) keys is far beyond what the
# serving stack produces in practice.
MAX_STACKS = 4096
MAX_DEPTH = 64

UNATTRIBUTED = "unattributed"

# Frames from these path fragments are the profiler/observability
# machinery itself; samples landing there on the *sampler* thread are
# excluded at collection time (the sampler skips its own thread), and
# the package-path test below is how a sample on any other thread is
# classified as in-request work.
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
)))


# co_filename -> (the file part of its frame label, whether the file
# lives under _PKG_ROOT). Bounded by the number of source files; a
# sample names every frame of every thread, and os.path.relpath alone
# costs several microseconds a call, all of it under the GIL.
_FILES: dict = {}


def _file_of(fn: str) -> tuple:
    got = _FILES.get(fn)
    if got is None:
        if fn.startswith(_PKG_ROOT):
            got = (os.path.relpath(fn, _PKG_ROOT), True)
        else:
            got = (os.path.basename(fn), False)
        _FILES[fn] = got
    return got


def _frame_name(code) -> str:
    """Stable frame label: module path relative to the repo when the
    file lives under it, else the basename — plus the function name.
    Uses co_firstlineno (stable per function) rather than the current
    line, so one function folds to one frame."""
    return f"{_file_of(code.co_filename)[0]}:{code.co_name}:" \
        f"{code.co_firstlineno}"


class SamplingProfiler:
    """Background wall-clock sampler over every live thread.

    Not self-starting: `start()` spawns the daemon sampler thread,
    `stop()` joins it; `sample_once()` is the testable unit (and what
    the loop calls). The fold table and stats live behind one
    lockwitness-minted lock; the sampler thread takes it only to fold
    one pre-built sample batch, and no telemetry sink is ever called
    under it."""

    def __init__(self, hz: float = 99.0, max_stacks: int = MAX_STACKS,
                 max_depth: int = MAX_DEPTH):
        if hz <= 0:
            raise ValueError("hz must be > 0")
        self.hz = float(hz)
        self.max_stacks = int(max_stacks)
        self.max_depth = int(max_depth)
        self._lock = lockwitness.make_lock("SamplingProfiler._lock")
        # (span_path, frames_tuple) -> sample count. Guarded by _lock.
        self._counts_locked: dict = {}
        self._samples_locked = 0
        self._attributed_locked = 0
        self._in_request_locked = 0
        self._overflow_locked = 0
        self._t0 = time.perf_counter()
        self._duration_s: float | None = None
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None

    # -- collection ---------------------------------------------------

    def start(self) -> "SamplingProfiler":
        if self._thread is not None:
            return self
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._loop, name="pluss-profiler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> "SamplingProfiler":
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._duration_s is None:
            self._duration_s = time.perf_counter() - self._t0
        return self

    def _loop(self) -> None:
        interval = 1.0 / self.hz
        # Dither every wait uniformly over [0.5, 1.5] periods (the
        # mean stays 1/hz, so the count -> seconds weighting holds).
        # A fixed period phase-locks with periodic request loops:
        # every tick then lands at the same phase of the loop, which
        # biases the flame toward that phase and — when the phase is
        # a dispatch-critical section — charges a worst-case
        # preemption to every single request (observed as whole
        # processes where the overhead gate read 4-5% while dithered
        # runs of the same build read < 1%).
        rng = random.Random()
        while not self._stop_evt.wait(interval * (0.5 + rng.random())):
            try:
                self.sample_once()
            except Exception:
                # A single bad sample (thread torn down mid-walk)
                # must never kill the sampler; the next tick retries.
                pass

    def sample_once(self) -> int:
        """Sample every live thread (except the sampler itself) once;
        returns the number of samples folded. Builds the whole batch
        lock-free, then folds it under the profiler lock."""
        me = threading.get_ident()
        span_paths = telemetry.span_paths_by_thread()
        frames = sys._current_frames()
        file_of = _file_of
        batch = []
        for tid in sorted(frames):
            if tid == me:
                continue
            stack = []
            in_request = False
            f = frames[tid]
            depth = 0
            while f is not None and depth < self.max_depth:
                code = f.f_code
                name, inside = file_of(code.co_filename)
                stack.append(f"{name}:{code.co_name}:{code.co_firstlineno}")
                if inside:
                    in_request = True
                f = f.f_back
                depth += 1
            stack.reverse()  # root -> leaf
            path = span_paths.get(tid, "")
            batch.append((path, tuple(stack), in_request))
        self._fold(batch)
        return len(batch)

    def _fold(self, batch) -> None:
        with self._lock:
            for path, stack, in_request in batch:
                self._samples_locked += 1
                if path:
                    self._attributed_locked += 1
                    self._in_request_locked += 1
                elif in_request:
                    self._in_request_locked += 1
                key = (path or UNATTRIBUTED, stack)
                cur = self._counts_locked.get(key)
                if cur is not None:
                    self._counts_locked[key] = cur + 1
                elif len(self._counts_locked) < self.max_stacks:
                    self._counts_locked[key] = 1
                else:
                    self._overflow_locked += 1

    def ingest(self, span_path: str, frames, count: int = 1,
               in_request: bool | None = None) -> None:
        """Fold a pre-recorded sample (the fixed-sample-log path the
        byte-stability tests and gate use): `frames` root->leaf."""
        if in_request is None:
            in_request = bool(span_path)
        self._fold(
            [(span_path, tuple(frames), bool(in_request))] * int(count)
        )

    # -- export -------------------------------------------------------

    def _state(self):
        with self._lock:
            return (
                dict(self._counts_locked),
                self._samples_locked,
                self._attributed_locked,
                self._in_request_locked,
                self._overflow_locked,
            )

    def snapshot(self) -> dict:
        """JSON-safe point-in-time view; deterministic given a fixed
        sample log (stacks sorted by descending count, then key)."""
        counts, samples, attributed, in_request, overflow = (
            self._state()
        )
        dur = self._duration_s
        if dur is None:
            dur = time.perf_counter() - self._t0
        sample_s = 1.0 / self.hz
        span_seconds: dict = {}
        for (path, _stack), c in counts.items():
            span_seconds[path] = span_seconds.get(path, 0) + c
        stacks = [
            {
                "span": path,
                "frames": list(stack),
                "count": c,
                "seconds": round(c * sample_s, 6),
            }
            for (path, stack), c in sorted(
                counts.items(), key=lambda kv: (-kv[1], kv[0])
            )
        ]
        completeness = (
            round(attributed / in_request, 4) if in_request else None
        )
        return {
            "profile_version": PROFILE_VERSION,
            "hz": self.hz,
            "duration_s": round(dur, 6),
            "samples": samples,
            "samples_attributed": attributed,
            "samples_in_request": in_request,
            "attribution_completeness": completeness,
            "stacks_overflowed": overflow,
            "span_seconds": {
                p: round(c * sample_s, 6)
                for p, c in sorted(span_seconds.items())
            },
            "stacks": stacks,
        }

    def collapsed_text(self) -> str:
        """`span:<path>;frame;frame count` lines, sorted — the
        flamegraph.pl/speedscope-ingestable collapsed format."""
        counts, *_ = self._state()
        lines = []
        for (path, stack), c in counts.items():
            cells = [f"span:{path}"] + list(stack)
            lines.append((";".join(cells), c))
        lines.sort()
        return "".join(f"{key} {c}\n" for key, c in lines)

    def speedscope(self, name: str = "pluss-profile") -> dict:
        """Speedscope file-format dict: one "sampled" profile whose
        samples are the collapsed stacks (weight = count / hz), each
        rooted at a synthetic `span:<path>` frame so the flame view
        groups by request stage."""
        counts, samples, *_ = self._state()
        sample_s = 1.0 / self.hz
        frame_index: dict = {}
        frames_out: list = []

        def fi(label: str) -> int:
            i = frame_index.get(label)
            if i is None:
                i = frame_index[label] = len(frames_out)
                frames_out.append({"name": label})
            return i

        samples_out = []
        weights = []
        for (path, stack), c in sorted(counts.items()):
            samples_out.append(
                [fi(f"span:{path}")] + [fi(s) for s in stack]
            )
            weights.append(round(c * sample_s, 6))
        end = round(sum(weights), 6)
        return {
            "$schema": "https://www.speedscope.app/"
                       "file-format-schema.json",
            "name": name,
            "activeProfileIndex": 0,
            "exporter": "pluss-profiler",
            "shared": {"frames": frames_out},
            "profiles": [{
                "type": "sampled",
                "name": name,
                "unit": "seconds",
                "startValue": 0,
                "endValue": end,
                "samples": samples_out,
                "weights": weights,
            }],
        }

    def write_speedscope(self, path: str,
                         name: str = "pluss-profile") -> None:
        import json

        atomic_write_text(
            path,
            json.dumps(self.speedscope(name=name), sort_keys=True,
                       separators=(",", ":")) + "\n",
        )

    def write_collapsed(self, path: str) -> None:
        atomic_write_text(path, self.collapsed_text())


def validate_snapshot(doc) -> list[str]:
    """All schema violations of a profiler snapshot (empty = valid);
    shared by tools/check_profile.py and the /debug/profile route's
    consumers."""
    errors: list[str] = []
    if not isinstance(doc, dict):
        return ["snapshot is not a JSON object"]
    if doc.get("profile_version") != PROFILE_VERSION:
        errors.append(
            f"profile_version must be {PROFILE_VERSION}, got "
            f"{doc.get('profile_version')!r}"
        )
    for key in ("hz", "duration_s"):
        v = doc.get(key)
        if not isinstance(v, (int, float)) or isinstance(v, bool) \
                or v < 0:
            errors.append(f"'{key}' must be a non-negative number")
    for key in ("samples", "samples_attributed",
                "samples_in_request", "stacks_overflowed"):
        v = doc.get(key)
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            errors.append(
                f"'{key}' must be a non-negative integer"
            )
    c = doc.get("attribution_completeness")
    if c is not None and (
        not isinstance(c, (int, float)) or isinstance(c, bool)
        or not (0.0 <= c <= 1.0)
    ):
        errors.append(
            "'attribution_completeness' must be in [0, 1] or null"
        )
    if not isinstance(doc.get("span_seconds"), dict):
        errors.append("'span_seconds' must be an object")
    stacks = doc.get("stacks")
    if not isinstance(stacks, list):
        errors.append("'stacks' must be a list")
    else:
        for i, s in enumerate(stacks):
            if not isinstance(s, dict):
                errors.append(f"stacks[{i}] is not an object")
                continue
            if not isinstance(s.get("span"), str) or not s["span"]:
                errors.append(
                    f"stacks[{i}].span must be a non-empty string"
                )
            if not isinstance(s.get("frames"), list):
                errors.append(f"stacks[{i}].frames must be a list")
            n = s.get("count")
            if not isinstance(n, int) or isinstance(n, bool) or n < 1:
                errors.append(
                    f"stacks[{i}].count must be a positive integer"
                )
    return errors


# -- process-global switch --------------------------------------------

_profiler: "SamplingProfiler | None" = None
_profiler_lock = lockwitness.make_lock("profiler._profiler_lock")


def enable(hz: float = 99.0, **kwargs) -> SamplingProfiler:
    """Start (replacing any active) process-global profiler and its
    sampler thread; returns it. The serve CLI calls this for
    --profile-hz."""
    global _profiler
    with _profiler_lock:
        prev = _profiler
        _profiler = None
    if prev is not None:
        prev.stop()
    prof = SamplingProfiler(hz=hz, **kwargs).start()
    with _profiler_lock:
        _profiler = prof
    return prof


def disable() -> "SamplingProfiler | None":
    """Stop and drop the global profiler; returns it (already
    stopped, so its snapshot/exports describe the whole enabled
    window), or None when idle."""
    global _profiler
    with _profiler_lock:
        prof = _profiler
        _profiler = None
    if prof is not None:
        prof.stop()
    return prof


def get() -> "SamplingProfiler | None":
    return _profiler


def snapshot() -> "dict | None":
    """The global profiler's snapshot, or None when off — the
    MetricsServer /debug/profile route and the flight recorder's
    bundle writer both read this."""
    prof = _profiler
    if prof is None:
        return None
    return prof.snapshot()
