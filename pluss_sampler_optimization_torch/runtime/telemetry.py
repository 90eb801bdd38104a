"""Telemetry runtime — spans, counters, and device metrics for every
engine.

The port's copy of the JAX package's runtime/telemetry.py: the same
public API and the same JSON document (SCHEMA_VERSION, every key of
`to_json`), so the JAX package's tools/check_telemetry_schema.py
accepts a port document. Three parts differ: `Span.block` waits for a
CUDA device, the compile capture records the port's own kernel builds
(nvcc per csrc/ source, make of native/) instead of jax.monitoring
events, and `device_metrics` reads torch.cuda. This module is the
shared spine of the port's observability:

- **Hierarchical spans.** `with span("draw"):` records wall time into
  the per-run `Telemetry` object's span tree; spans nest via a
  thread-local stack. The span handle's `.block(value)` optionally
  adds device-sync timing (`torch.cuda.synchronize` when the value is
  or holds a CUDA tensor, recorded as `sync_s`) when the run was
  enabled with `device_sync=True`; with device sync off it returns the
  value untouched, so instrumented code never changes the engines'
  async dispatch pipelines.
- **Counters / gauges / events.** `count("dispatch")` style counters
  (the engines count dispatches and bytes fetched to host), free-form
  gauges, and bounded structured events (`event("accel_probe", ...)`).
  The sampled engine's cross-ref fusion adds a small contract here:
  `dispatches_fused` counts dispatches that carried a stacked ref
  bucket, `pipeline_stalls` counts forced drains of the depth-bounded
  async pipeline, and the end-of-run gauges `ref_buckets`,
  `expected_chunks`, `refs_per_dispatch`, and `pipeline_overlap_s`
  describe the bucket plan — tools/check_dispatch_stats.py audits
  `dispatches <= ref_buckets * expected_chunks + capacity_regrows`
  from an exported run to catch silent fusion regressions.
  The service's cross-request batching extends the contract:
  `batches_formed` / `batch_members` count admission-window flushes
  and their member totals, `dispatches_batched` marks dispatches that
  carried rows from several requests, the `batch_occupancy` /
  `batch_queue_depth` gauges track the scheduler, `batch_jobs` +
  `ref_buckets_union` describe the union bucket plan (the checker
  prefers `ref_buckets_union` for its bound when present), and
  `service_batch_failed` / `service_batch_fallback_solo` count
  batch-level failures and members degraded to solo execution.
- **Build capture.** The port's compile events are its own builds:
  each nvcc build of a csrc/ source (ops/_build.py, also on a
  background thread) and each make of native/ calls `record_build`,
  which adds an event and a duration under
  `/pluss_torch/kernel_build/<library>` to a process-global store
  (under a lock), and the kernel loaders count their library-cache
  hits and misses into it. Each `Telemetry` snapshots the store at
  enable and exports the delta under the document's `jax_monitoring`
  key (the schema's name for it), so a run's JSON reports only its own
  builds; a run that is disabled keeps its final snapshot, so a later
  build never lands in it. `compile_counters_snapshot()` keeps the JAX
  package's dict shape: `backend_compiles` / `backend_compile_s` count
  the builds, the cache counts are the loaders' hits and misses.
- **Host/device metrics.** `host_fingerprint()` (identity + optional
  measured speed probe), `cpu_features_hash()` (cache-dir scoping),
  `read_cpu_throttle()` (cgroup-v2 counters), and `device_metrics()`
  (platform, device count, per-card name and memory from torch.cuda)
  all live here.
- **Structured JSON export** with a stable schema
  (`SCHEMA_VERSION`; validated by tools/check_telemetry_schema.py and
  pinned by tests/test_telemetry.py) plus a compact stderr summary.

The module-level enable switch keeps the disabled path a no-op: when
no run is active, `span()` returns a shared singleton context manager
and `count()`/`record_fetch()` are a single attribute check — the
overhead bound is pinned by test (test_telemetry.py), and with
telemetry disabled the instrumented engines are bit-identical to the
uninstrumented code because nothing in this module executes.
"""

from __future__ import annotations

import json
import sys
import threading
import time

from . import lockwitness

SCHEMA_VERSION = 1

# Recorded-span cap: a pathological run (millions of chunks) degrades
# to counting dropped spans instead of growing without bound.
_MAX_SPANS = 50_000
_MAX_EVENTS = 1_000

_lock = lockwitness.make_lock("telemetry._lock")
_tls = threading.local()
_current: "Telemetry | None" = None

# Cross-thread span visibility for the sampling profiler
# (runtime/obs/profiler.py): thread-local span stacks are invisible
# from any other thread, but the profiler's sampler thread must join
# `sys._current_frames()` (keyed by thread ident) with "what span is
# that thread inside right now". Each thread registers its own stack
# list here (under _lock) the first time it opens a span; the sampler
# reads a copied snapshot under the same lock. The stack lists
# themselves are mutated lock-free by their owning thread (append/pop
# in Span.__enter__/__exit__) — a concurrent reader may observe a
# stack mid-push and attribute one sample to the parent span instead
# of the child, which is exactly the tolerance a statistical profiler
# has anyway.
_thread_stacks: dict = {}

# Live metrics sink (runtime/obs/metrics.py registry) — when set by
# metrics.enable(), count()/gauge() mirror every write into it, so the
# per-run Telemetry and the live serving registry are two views of one
# write path. Kept as a bare module global read on the hot path: the
# disabled cost is one load + None check per call.
_metrics_sink = None


def set_metrics_sink(sink) -> None:
    """Install (or with None, remove) the live metrics sink. Called by
    runtime.obs.metrics.enable()/disable(); the sink needs `inc(name,
    v)` and `set_gauge(name, v)`."""
    global _metrics_sink
    _metrics_sink = sink


def metrics_sink():
    return _metrics_sink


# Flight-recorder sink (runtime/obs/recorder.py) — the second leg of
# the sink path: where _metrics_sink mirrors numeric count()/gauge()
# writes, _record_sink mirrors event() emissions, so anomaly events
# (slo_breach, replica_quarantined, drift_breach, ...) reach the
# recorder's trigger logic without every emit site knowing about it.
# Same discipline as the metrics sink: bare global, one None check on
# the disabled path, and a failing sink never takes the caller down.
_record_sink = None


def set_record_sink(sink) -> None:
    """Install (or with None, remove) the flight-recorder sink. Called
    by runtime.obs.recorder.enable()/disable(); the sink needs
    `record_event(name, data)`."""
    global _record_sink
    _record_sink = sink


def record_sink():
    return _record_sink


class _NullSpan:
    """Shared no-op span: the entire disabled-telemetry hot path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def block(self, value):
        return value


_NULL_SPAN = _NullSpan()


class Span:
    __slots__ = ("name", "attrs", "start_s", "wall_s", "sync_s",
                 "children", "_t0", "_tele")

    def __init__(self, tele: "Telemetry", name: str, attrs: dict):
        self._tele = tele
        self.name = name
        self.attrs = attrs
        self.children: list = []
        self.start_s = 0.0
        self.wall_s = 0.0
        self.sync_s = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        self.start_s = round(self._t0 - self._tele._t0, 6)
        stack = _span_stack()
        if stack:
            stack[-1].children.append(self)
        else:
            with _lock:
                self._tele.roots.append(self)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self.wall_s = round(time.perf_counter() - self._t0, 6)
        stack = _span_stack()
        if stack and stack[-1] is self:
            stack.pop()
        return False

    def block(self, value):
        """Optionally record device-sync time: with the run enabled
        under device_sync=True, wait for the card when `value` is or
        holds a CUDA tensor (torch.cuda.synchronize on its device) and
        record the span-start -> ready latency as sync_s (host values
        are ready when they exist); otherwise pass the value through
        untouched (no extra synchronization — the engines' async
        pipelines stay async)."""
        if self._tele.device_sync:
            dev = _cuda_device_of(value)
            if dev is not None:
                import torch

                torch.cuda.synchronize(dev)
            self.sync_s = round(time.perf_counter() - self._t0, 6)
        return value

    def to_dict(self) -> dict:
        d: dict = {"name": self.name, "start_s": self.start_s,
                   "wall_s": self.wall_s}
        if self.attrs:
            d["attrs"] = self.attrs
        if self.sync_s is not None:
            d["sync_s"] = self.sync_s
        d["children"] = [c.to_dict() for c in self.children]
        return d


def _cuda_device_of(value):
    """The device of the first CUDA tensor in `value` (a tensor, or
    lists, tuples, dicts and named tuples of them), else None."""
    stack = [value]
    while stack:
        x = stack.pop()
        if isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif getattr(x, "is_cuda", False):
            return x.device
    return None


def _span_stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _reset_span_stack()
    return stack


def _reset_span_stack() -> list:
    """Install a fresh span stack for the calling thread and register
    it in the cross-thread registry the profiler samples."""
    stack = _tls.stack = []
    with _lock:
        _thread_stacks[threading.get_ident()] = stack
    return stack


def span_paths_by_thread() -> dict:
    """Snapshot {thread_ident: "root/child/..."} of every registered
    thread's current span path ("" when the thread is idle between
    spans). Prunes entries for threads that no longer exist, so the
    registry stays bounded by the live thread count. Called from the
    profiler's sampler thread next to `sys._current_frames()`, which
    uses the same ident keys."""
    live = {
        t.ident for t in threading.enumerate() if t.ident is not None
    }
    with _lock:
        for tid in [t for t in _thread_stacks if t not in live]:
            del _thread_stacks[tid]
        snap = {
            tid: list(stack)
            for tid, stack in _thread_stacks.items()
        }
    return {
        tid: "/".join(s.name for s in stack)
        for tid, stack in snap.items()
    }


class Telemetry:
    """One run's recorded telemetry: span tree, counters, gauges,
    events, and the build-store baseline for delta export."""

    def __init__(self, device_sync: bool = False):
        self.device_sync = device_sync
        self.roots: list[Span] = []
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.events: list[dict] = []
        self._n_spans = 0
        self._t0 = time.perf_counter()
        self._duration_s: float | None = None
        self._jax_base = _monitor_snapshot()
        self._jax_final: dict | None = None

    # -- recording ----------------------------------------------------

    def _span(self, name: str, attrs: dict):
        if self._n_spans >= _MAX_SPANS:
            self.counters["spans_dropped"] = (
                self.counters.get("spans_dropped", 0) + 1
            )
            return _NULL_SPAN
        self._n_spans += 1
        return Span(self, name, attrs)

    def count(self, name: str, inc: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + inc

    def gauge(self, name: str, value) -> None:
        self.gauges[name] = value

    def event(self, name: str, **data) -> None:
        if len(self.events) >= _MAX_EVENTS:
            self.counters["events_dropped"] = (
                self.counters.get("events_dropped", 0) + 1
            )
            return
        self.events.append({"name": name, "t_s": round(
            time.perf_counter() - self._t0, 6), **data})

    # -- export -------------------------------------------------------

    def find_spans(self, name: str) -> list[Span]:
        """All recorded spans with this name, in tree preorder."""
        out: list[Span] = []

        def walk(s: Span) -> None:
            if s.name == name:
                out.append(s)
            for c in s.children:
                walk(c)

        for r in self.roots:
            walk(r)
        return out

    def jax_delta(self) -> dict:
        """This run's builds: event counts and duration totals since
        enable (final snapshot once disabled), in the shape of the JAX
        package's jax.monitoring delta."""
        now = self._jax_final or _monitor_snapshot()
        events = {
            k: v - self._jax_base["events"].get(k, 0)
            for k, v in now["events"].items()
            if v - self._jax_base["events"].get(k, 0)
        }
        durations = {}
        for k, (tot, cnt) in now["durations"].items():
            b_tot, b_cnt = self._jax_base["durations"].get(k, (0.0, 0))
            if cnt - b_cnt:
                durations[k] = {
                    "total_s": round(tot - b_tot, 4),
                    "count": cnt - b_cnt,
                }
        return {"events": events, "durations": durations}

    def to_json(self, speed_probe: bool = False) -> dict:
        dur = self._duration_s
        if dur is None:
            dur = time.perf_counter() - self._t0
        return {
            "schema_version": SCHEMA_VERSION,
            "enabled": True,
            "duration_s": round(dur, 6),
            "spans": [r.to_dict() for r in self.roots],
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "events": list(self.events),
            "jax_monitoring": self.jax_delta(),
            "device": device_metrics(),
            "host": host_fingerprint(speed_probe=speed_probe),
        }

    def write_json(self, path: str, speed_probe: bool = False) -> None:
        from .io import atomic_write_json

        atomic_write_json(path, self.to_json(speed_probe=speed_probe))

    def summary_lines(self, top: int = 12) -> list[str]:
        """Compact human summary: root spans with their heaviest
        children, counters, and the compile totals."""
        lines = []
        dur = self._duration_s
        if dur is None:
            dur = time.perf_counter() - self._t0
        lines.append(f"telemetry: run {dur:.3f}s, "
                     f"{self._n_spans} spans")

        agg: dict[str, tuple[float, int]] = {}

        def walk(s: Span) -> None:
            tot, cnt = agg.get(s.name, (0.0, 0))
            agg[s.name] = (tot + s.wall_s, cnt + 1)
            for c in s.children:
                walk(c)

        for r in self.roots:
            walk(r)
        for name, (tot, cnt) in sorted(
            agg.items(), key=lambda kv: -kv[1][0]
        )[:top]:
            lines.append(f"  span {name:<24s} {tot:9.3f}s  x{cnt}")
        if self.counters:
            parts = ", ".join(
                f"{k}={v:g}" for k, v in sorted(self.counters.items())
            )
            lines.append(f"  counters: {parts}")
        jd = self.jax_delta()
        bc = _build_totals(jd["durations"])
        if bc:
            lines.append(
                f"  compiles: {bc['count']} backend compiles, "
                f"{bc['total_s']:.2f}s"
            )
        for ev in self.events:
            lines.append(f"  event: {json.dumps(ev)[:160]}")
        return lines

    def print_summary(self, file=None) -> None:
        file = file if file is not None else sys.stderr
        for line in self.summary_lines():
            print(line, file=file)


# -- module-level switch ----------------------------------------------


def enable(device_sync: bool = False) -> Telemetry:
    """Start a telemetry run (replacing any active one) and return its
    Telemetry; the builds from here on land in the run's delta."""
    global _current
    tele = Telemetry(device_sync=device_sync)
    _reset_span_stack()
    _current = tele
    return tele


def disable() -> "Telemetry | None":
    """Stop recording; stamps the run duration and the final build
    snapshot so later exports describe exactly the enabled window.
    Returns the stopped Telemetry (None if idle)."""
    global _current
    tele = _current
    _current = None
    if tele is not None:
        tele._duration_s = time.perf_counter() - tele._t0
        tele._jax_final = _monitor_snapshot()
    return tele


def current() -> "Telemetry | None":
    return _current


def span(name: str, **attrs):
    """Context manager recording one hierarchical span; the shared
    no-op singleton when telemetry is disabled."""
    tele = _current
    if tele is None:
        return _NULL_SPAN
    return tele._span(name, attrs)


def count(name: str, inc: float = 1) -> None:
    tele = _current
    if tele is not None:
        tele.count(name, inc)
    sink = _metrics_sink
    if sink is not None:
        sink.inc(name, inc)


def gauge(name: str, value) -> None:
    tele = _current
    if tele is not None:
        tele.gauge(name, value)
    sink = _metrics_sink
    if sink is not None:
        sink.set_gauge(name, value)


def event(name: str, **data) -> None:
    tele = _current
    if tele is not None:
        tele.event(name, **data)
    sink = _record_sink
    if sink is not None:
        # Observation must never sink the observed: a recorder bug
        # (full disk under the bundle dir, a bad state provider) is
        # its own problem, not the serving request's.
        try:
            sink.record_event(name, dict(data))
        except Exception:
            pass


def record_fetch(host_tree):
    """Count a device->host fetch's payload bytes (and the fetch
    itself) into the active run; pass-through, engines wrap the host
    arrays of a read back once the host decodes them:
    `out = record_fetch(tuple(x.numpy() for x in host))`.
    """
    tele = _current
    if tele is None:
        return host_tree
    nbytes = 0
    stack = [host_tree]
    while stack:
        x = stack.pop()
        if isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
        else:
            nbytes += int(getattr(x, "nbytes", 0))
    tele.count("fetches")
    tele.count("bytes_fetched_to_host", nbytes)
    return host_tree


def counted_lru_cache(maxsize: int = 128,
                      counter: str = "kernel_cache"):
    """functools.lru_cache with telemetry hit/miss counters and an
    occupancy gauge.

    Drop-in for the kernel caches scattered across the engines
    (stream/draw/periodic/dense/sharded program-kernel caches): every
    lookup lands in `<counter>_hits` / `<counter>_misses` of the
    active run, so a telemetry export shows compiled-kernel reuse next
    to the result-cache counters the service records, and the
    `<counter>_size` / `<counter>_maxsize` gauges expose current
    occupancy vs capacity (cache pressure is visible in the
    Prometheus export before evictions start). `cache_clear` /
    `cache_info` pass through (tests clear these caches directly).
    The hit/miss attribution reads cache_info around the call — exact
    single-threaded; under concurrent lookups a race can misattribute
    a count, never miscompute a result."""
    import functools

    def deco(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            # count() below feeds both the run and the live registry;
            # skip the cache_info bookkeeping only when neither view
            # is listening.
            if _current is None and _metrics_sink is None:
                return cached(*args, **kwargs)
            before = cached.cache_info().hits
            out = cached(*args, **kwargs)
            info = cached.cache_info()
            if info.hits > before:
                count(counter + "_hits")
            else:
                count(counter + "_misses")
            gauge(counter + "_size", info.currsize)
            gauge(counter + "_maxsize", info.maxsize)
            return out

        wrapper.cache_clear = cached.cache_clear
        wrapper.cache_info = cached.cache_info
        wrapper.__wrapped__ = cached
        return wrapper

    return deco


_warned_once: set = set()


def warn_once(key, message: str, **data) -> None:
    """One-line stderr warning, once per key per process, recorded as
    a telemetry event when a run is active (the event records every
    occurrence; only the stderr line dedupes)."""
    event("warning", key=str(key), message=message, **data)
    if key in _warned_once:
        return
    _warned_once.add(key)
    print(message, file=sys.stderr)


def __getattr__(name: str):
    """`telemetry.exporters` resolves to runtime/obs/exporters.py —
    the exporters live in the obs package (they pull in the ledger's
    neighbors), but callers reach them through the telemetry module
    they export. Lazy so the disabled-telemetry import stays light."""
    if name == "exporters":
        from .obs import exporters

        return exporters
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}"
    )


# -- build capture ------------------------------------------------------

# Process-global store of the port's builds: {"events": {key: n},
# "durations": {key: (total_s, n)}}. Builds can run on a background
# thread, so every write and every snapshot holds _build_lock; each run
# exports the delta between its two snapshots.
BUILD_PREFIX = "/pluss_torch/kernel_build/"
_CACHE_PREFIX = "/pluss_torch/kernel_cache/"
_build_lock = threading.Lock()
_monitor: dict = {"events": {}, "durations": {}}


def record_build(library: str, seconds: float) -> None:
    """One build of `library` (an nvcc build of csrc/<library>.cu, or
    "native" for a make of native/) that took `seconds`: an event and a
    duration under BUILD_PREFIX + library."""
    key = BUILD_PREFIX + library
    with _build_lock:
        ev = _monitor["events"]
        ev[key] = ev.get(key, 0) + 1
        tot, cnt = _monitor["durations"].get(key, (0.0, 0))
        # raw accumulation; rounding happens once at export so
        # per-event rounding error never piles up
        _monitor["durations"][key] = (tot + seconds, cnt + 1)


def record_cache(hit: bool) -> None:
    """A kernel loader's first request for a library in this process:
    a hit when the built library was already on disk, a miss when it
    had to be built."""
    key = _CACHE_PREFIX + ("cache_hits" if hit else "cache_misses")
    with _build_lock:
        ev = _monitor["events"]
        ev[key] = ev.get(key, 0) + 1
        req = _CACHE_PREFIX + "compile_requests"
        ev[req] = ev.get(req, 0) + 1


def _monitor_snapshot() -> dict:
    with _build_lock:
        return {
            "events": dict(_monitor["events"]),
            "durations": dict(_monitor["durations"]),
        }


def _build_totals(durations: dict) -> dict | None:
    """{"count", "total_s"} over every build key of an exported
    durations dict; None when it holds no build."""
    parts = [v for k, v in durations.items() if k.startswith(BUILD_PREFIX)]
    if not parts:
        return None
    return {"count": sum(p["count"] for p in parts),
            "total_s": round(sum(p["total_s"] for p in parts), 4)}


_COMPILE_EVENT_KEYS = {
    "cache_hits": _CACHE_PREFIX + "cache_hits",
    "cache_misses": _CACHE_PREFIX + "cache_misses",
    "compile_requests": _CACHE_PREFIX + "compile_requests",
}


def compile_counters_snapshot() -> dict:
    """The JAX package's compile-counter dict (cache hits/misses/
    requests + backend compile count/seconds), from the process-global
    build store: the builds are the backend compiles, the loaders'
    library-cache hits and misses the cache counts."""
    store = _monitor_snapshot()
    snap = {
        name: store["events"].get(key, 0)
        for name, key in _COMPILE_EVENT_KEYS.items()
    }
    tot = sum(t for k, (t, _n) in store["durations"].items()
              if k.startswith(BUILD_PREFIX))
    cnt = sum(n for k, (_t, n) in store["durations"].items()
              if k.startswith(BUILD_PREFIX))
    snap["backend_compile_s"] = round(tot, 2)
    snap["backend_compiles"] = cnt
    return snap


# -- host / device metrics --------------------------------------------


def cpu_features_hash() -> str:
    """8-hex digest of the host CPU's model + ISA flags.

    XLA:CPU AOT cache entries bake in machine features INCLUDING
    tuning pseudo-features (prefer-no-gather/prefer-no-scatter) that
    are not part of the cache key; loading an entry compiled on a
    different host logs 'machine type ... doesn't match' warnings,
    risks SIGILL, and silently skews timings. bench.py scopes its
    CPU-fallback cache dir by this hash so executables never cross
    hosts; the model+flags lines cover every input XLA's feature
    detection uses.
    """
    import hashlib
    import platform

    try:
        with open("/proc/cpuinfo") as f:
            txt = f.read()
    except OSError:
        txt = ""
    lines = [
        ln for ln in txt.splitlines()
        # x86 naming first; ARM and friends spell identity differently
        # ('Features', 'CPU implementer', ...) — match those stable
        # identity lines explicitly rather than hashing the whole
        # first block, which contains per-boot-calibrated fields
        # (BogoMIPS, cpu MHz on some kernels) that would churn the
        # scoped cache dir across boots for no codegen-relevant reason
        if ln.startswith((
            "model name", "flags",
            "Features", "CPU implementer", "CPU architecture",
            "CPU variant", "CPU part", "CPU revision",
        ))
    ]
    # /proc/cpuinfo repeats identity lines once per logical CPU;
    # dedupe so the digest is invariant to the visible core count (two
    # containers on the same CPU model must share a cache dir)
    lines = list(dict.fromkeys(lines))[:8]
    # last resort (exotic /proc/cpuinfo): the whole first block, minus
    # lines with known per-boot fields
    ident = "\n".join(lines) if lines else "\n".join(
        ln for ln in txt.split("\n\n")[0].splitlines()
        if not ln.lower().startswith(("bogomips", "cpu mhz"))
    )
    ident += "|" + platform.machine()
    return hashlib.sha256(ident.encode()).hexdigest()[:8]


def host_fingerprint(speed_probe: bool = True) -> dict:
    """Identity + (optionally) measured speed of the host.

    Identity: /proc/cpuinfo model/frequency, boot/machine ids
    (same-container detection), hostname, and the CPU features hash.
    The speed probe is a fixed numpy workload (int64 sort + matmul,
    the engines' two dominant CPU primitives, ~0.5 s) whose wall time
    directly ranks hosts even when nominal frequencies lie (VMs pin
    cpu MHz to a constant); bench.py records it on every run — it was
    what explained the round-3 33% driver-vs-validation spread.
    Telemetry JSON exports skip it by default to stay cheap.
    """
    fp: dict = {}
    try:
        with open("/proc/cpuinfo") as f:
            txt = f.read()
        for key, tag in (("model name", "cpu_model"),
                         ("cpu MHz", "cpu_mhz"),
                         ("bogomips", "bogomips")):
            for line in txt.splitlines():
                if line.startswith(key):
                    fp[tag] = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    for path, tag in (("/proc/sys/kernel/random/boot_id", "boot_id"),
                      ("/etc/machine-id", "machine_id")):
        try:
            with open(path) as f:
                fp[tag] = f.read().strip()
        except OSError:
            pass
    try:
        import socket

        fp["hostname"] = socket.gethostname()
    except OSError:
        pass
    fp["cpu_features_hash"] = cpu_features_hash()
    if speed_probe:
        import numpy as np

        rng = np.random.default_rng(0)
        vals = rng.integers(0, 1 << 62, size=1 << 21, dtype=np.int64)
        mat = rng.standard_normal((256, 256))
        t0 = time.perf_counter()
        for _ in range(4):
            np.sort(vals)
        acc = mat
        for _ in range(8):
            acc = acc @ mat
        fp["speed_probe_s"] = round(time.perf_counter() - t0, 3)
    return fp


def read_cpu_throttle():
    """cgroup-v2 CPU throttle counters, or None when unreadable. A
    contended/quota-limited container shows up here even when loadavg
    looks calm."""
    try:
        with open("/sys/fs/cgroup/cpu.stat") as f:
            d = dict(
                line.split() for line in f if len(line.split()) == 2
            )
        return {
            k: int(d[k])
            for k in ("nr_throttled", "throttled_usec")
            if k in d
        }
    except (OSError, ValueError):
        return None


def device_metrics(max_devices: int = 8) -> dict:
    """Platform + per-card memory: "gpu" where torch sees a CUDA card
    (each card's name, and bytes in use, peak and limit from the caching
    allocator's counters and the card's total memory), "cpu" otherwise.
    Reads no free-memory figure: torch.cuda.mem_get_info would create a
    context on every card it asks, also the ones a run never touched.
    Never raises — a broken CUDA install yields {"error": ...} so telemetry
    export cannot sink a run."""
    try:
        import torch

        if not torch.cuda.is_available():
            import platform

            return {"platform": "cpu", "device_count": 1,
                    "devices": [{"id": 0,
                                 "kind": platform.machine() or "cpu"}]}
        n = torch.cuda.device_count()
        out: dict = {"platform": "gpu", "device_count": n, "devices": []}
        for i in range(min(n, max_devices)):
            out["devices"].append({
                "id": i,
                "kind": torch.cuda.get_device_name(i),
                "memory": {
                    "bytes_in_use": int(torch.cuda.memory_allocated(i)),
                    "peak_bytes_in_use": int(
                        torch.cuda.max_memory_allocated(i)),
                    "bytes_limit": int(
                        torch.cuda.get_device_properties(i).total_memory),
                },
            })
        return out
    except Exception as e:
        return {"platform": "unknown", "device_count": 0,
                "devices": [], "error": repr(e)}
