"""Process-global live metrics registry for the serving layer.

Per-run Telemetry (runtime/telemetry.py) answers "what happened during
this run" after the fact; a serving process needs the complementary
question — "what is happening right now" — answered continuously and
cheaply. This module is that second view over the SAME write path:
`metrics.enable()` installs the registry as the telemetry module's
metrics sink, so every existing `telemetry.count` / `telemetry.gauge`
call site (engines, `counted_lru_cache`, executor/cache/batch-scheduler
stats) feeds both the active per-run Telemetry (when one is enabled)
and the live registry, with no second instrumentation pass.

Three instrument kinds:

- **counters** — monotone floats with, in addition to the lifetime
  total, bounded rolling windows (30s ring of 1s slots, 5m ring of 10s
  slots) so rates and burn rates can be computed without scraping
  twice;
- **gauges** — last-write-wins scalars;
- **histograms** — fixed-bucket latency histograms (Prometheus
  cumulative-bucket semantics) with the same rolling windows per
  bucket, windowed quantile estimates by bucket interpolation, and an
  optional exemplar (trace id) retained per bucket for the OpenMetrics
  exposition.

Rolling windows are time-sliced rings: each slot covers `slot_s`
seconds and stores the slot's increments plus the epoch (absolute slot
index) it was written in; a reader sums only slots whose epoch is
still inside the window, so stale slots cost nothing to expire. All
instruments are thread-safe behind one registry lock; the fast path is
a dict lookup + a few float adds.

The scrape side lives here too: `MetricsServer` is a stdlib
`http.server` thread serving the registry in Prometheus text format
(name sanitization shared with runtime/obs/exporters.py) on
`GET /metrics`, for the CLI's `--metrics-port` flag. `serve_jsonl`'s
`metrics` control request returns the same snapshot as JSON.
"""

from __future__ import annotations

import json
import threading
import time

from .. import lockwitness


# Default latency buckets (seconds). Chosen to resolve both the
# sub-millisecond cache-hit path and multi-second exact-engine runs;
# +Inf is implicit as the last bucket.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

# (label, window span seconds, number of ring slots). Slot width is
# span/slots: 30s of 1s slots, 300s of 10s slots.
DEFAULT_WINDOWS = (("30s", 30.0, 30), ("5m", 300.0, 30))


class _ScalarWindow:
    """Rolling sum of increments over `span_s` seconds, sliced into
    `slots` ring slots. Not self-locking — the owning registry
    serializes access."""

    __slots__ = ("label", "span_s", "slots", "slot_s", "_vals",
                 "_epochs")

    def __init__(self, label: str, span_s: float, slots: int):
        self.label = label
        self.span_s = float(span_s)
        self.slots = int(slots)
        self.slot_s = self.span_s / self.slots
        self._vals = [0.0] * self.slots
        self._epochs = [-1] * self.slots

    def add(self, value: float, now: float) -> None:
        epoch = int(now // self.slot_s)
        idx = epoch % self.slots
        if self._epochs[idx] != epoch:
            self._vals[idx] = 0.0
            self._epochs[idx] = epoch
        self._vals[idx] += value

    def total(self, now: float) -> float:
        oldest = int(now // self.slot_s) - self.slots + 1
        return sum(
            v for v, e in zip(self._vals, self._epochs) if e >= oldest
        )


class _HistogramWindow:
    """Rolling per-bucket counts + sum/count over one ring window."""

    __slots__ = ("label", "span_s", "slots", "slot_s", "_counts",
                 "_sums", "_ns", "_epochs")

    def __init__(self, label: str, span_s: float, slots: int,
                 n_buckets: int):
        self.label = label
        self.span_s = float(span_s)
        self.slots = int(slots)
        self.slot_s = self.span_s / self.slots
        self._counts = [[0] * n_buckets for _ in range(self.slots)]
        self._sums = [0.0] * self.slots
        self._ns = [0] * self.slots
        self._epochs = [-1] * self.slots

    def observe(self, bucket_i: int, value: float, now: float) -> None:
        epoch = int(now // self.slot_s)
        idx = epoch % self.slots
        if self._epochs[idx] != epoch:
            row = self._counts[idx]
            for i in range(len(row)):
                row[i] = 0
            self._sums[idx] = 0.0
            self._ns[idx] = 0
            self._epochs[idx] = epoch
        self._counts[idx][bucket_i] += 1
        self._sums[idx] += value
        self._ns[idx] += 1

    def aggregate(self, now: float):
        """(per-bucket counts, sum, n) over the live slots."""
        oldest = int(now // self.slot_s) - self.slots + 1
        n_buckets = len(self._counts[0]) if self._counts else 0
        counts = [0] * n_buckets
        total = 0.0
        n = 0
        for idx in range(self.slots):
            if self._epochs[idx] < oldest:
                continue
            row = self._counts[idx]
            for i in range(n_buckets):
                counts[i] += row[i]
            total += self._sums[idx]
            n += self._ns[idx]
        return counts, total, n


def _quantile_from_buckets(counts, uppers, q: float):
    """Quantile estimate from per-bucket (non-cumulative) counts by
    linear interpolation inside the target bucket; the +Inf bucket
    reports its lower edge (the last finite upper bound). None when
    empty."""
    n = sum(counts)
    if n <= 0:
        return None
    rank = q * n
    seen = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if seen + c >= rank:
            if i >= len(uppers):       # +Inf bucket
                return uppers[-1] if uppers else None
            lo = uppers[i - 1] if i > 0 else 0.0
            hi = uppers[i]
            frac = (rank - seen) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        seen += c
    return uppers[-1] if uppers else None


class RollingHistogram:
    """Fixed-bucket histogram: lifetime cumulative counts + sum/count,
    rolling windows, and one retained exemplar per bucket. Bucket i
    holds observations <= buckets[i]; the final slot is +Inf. Not
    self-locking — the registry serializes."""

    def __init__(self, name: str, buckets=DEFAULT_BUCKETS,
                 windows=DEFAULT_WINDOWS):
        self.name = name
        self.buckets = tuple(float(b) for b in buckets)
        n = len(self.buckets) + 1          # + the +Inf bucket
        self.counts = [0] * n
        self.sum = 0.0
        self.count = 0
        self.exemplars: list = [None] * n  # (exemplar_id, value) | None
        self.windows = [
            _HistogramWindow(lbl, span, slots, n)
            for lbl, span, slots in windows
        ]

    def _bucket_index(self, value: float) -> int:
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                return i
        return len(self.buckets)

    def observe(self, value: float, exemplar=None,
                now: float | None = None) -> None:
        value = float(value)
        if now is None:
            now = time.time()
        i = self._bucket_index(value)
        self.counts[i] += 1
        self.sum += value
        self.count += 1
        if exemplar is not None:
            self.exemplars[i] = (str(exemplar), value)
        for w in self.windows:
            w.observe(i, value, now)

    def window_fraction_over(self, label: str, threshold: float,
                             now: float | None = None):
        """Estimated fraction of the window's observations strictly
        above `threshold` (linear interpolation inside the straddling
        bucket); None when the window is empty."""
        if now is None:
            now = time.time()
        for w in self.windows:
            if w.label != label:
                continue
            counts, _, n = w.aggregate(now)
            if n <= 0:
                return None
            below = 0.0
            for i, ub in enumerate(self.buckets):
                lo = self.buckets[i - 1] if i > 0 else 0.0
                if ub <= threshold:
                    below += counts[i]
                elif lo < threshold:
                    below += counts[i] * (threshold - lo) / (ub - lo)
                    break
                else:
                    break
            return min(1.0, max(0.0, 1.0 - below / n))
        raise KeyError(f"unknown window {label!r}")

    def window_quantile(self, label: str, q: float,
                        now: float | None = None):
        if now is None:
            now = time.time()
        for w in self.windows:
            if w.label == label:
                counts, _, _ = w.aggregate(now)
                return _quantile_from_buckets(counts, self.buckets, q)
        raise KeyError(f"unknown window {label!r}")

    def snapshot(self, now: float | None = None) -> dict:
        if now is None:
            now = time.time()
        cum = 0
        buckets = {}
        exemplars = {}
        for i, ub in enumerate(self.buckets):
            cum += self.counts[i]
            buckets[f"{ub:g}"] = cum
            if self.exemplars[i] is not None:
                exemplars[f"{ub:g}"] = list(self.exemplars[i])
        buckets["+Inf"] = cum + self.counts[-1]
        if self.exemplars[-1] is not None:
            exemplars["+Inf"] = list(self.exemplars[-1])
        out = {
            "count": self.count,
            "sum": self.sum,
            "buckets": buckets,
            "exemplars": exemplars,
            "windows": {},
        }
        for w in self.windows:
            counts, total, n = w.aggregate(now)
            out["windows"][w.label] = {
                "count": n,
                "sum": total,
                "p50": _quantile_from_buckets(counts, self.buckets, 0.50),
                "p95": _quantile_from_buckets(counts, self.buckets, 0.95),
                "p99": _quantile_from_buckets(counts, self.buckets, 0.99),
            }
        return out


class MetricsRegistry:
    """Thread-safe live instrument store. Instruments are created on
    first write; names are raw telemetry names (sanitization happens at
    exposition time, with deterministic collision suffixes — see
    exporters.prometheus_registry_lines)."""

    def __init__(self, buckets=DEFAULT_BUCKETS,
                 windows=DEFAULT_WINDOWS):
        self._lock = lockwitness.make_lock("MetricsRegistry._lock")
        self._buckets = tuple(buckets)
        self._windows = tuple(windows)
        self._counters: dict = {}          # name -> float total
        self._counter_windows: dict = {}   # name -> [_ScalarWindow...]
        self._gauges: dict = {}
        self._hists: dict = {}

    # -- write path (the telemetry sink protocol) ---------------------

    def inc(self, name: str, inc: float = 1,
            now: float | None = None) -> None:
        if now is None:
            now = time.time()
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + inc
            wins = self._counter_windows.get(name)
            if wins is None:
                wins = [_ScalarWindow(lbl, span, slots)
                        for lbl, span, slots in self._windows]
                self._counter_windows[name] = wins
            for w in wins:
                w.add(inc, now)

    def set_gauge(self, name: str, value) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float, exemplar=None,
                buckets=None, now: float | None = None) -> None:
        if now is None:
            now = time.time()
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = RollingHistogram(
                    name, buckets or self._buckets, self._windows
                )
                self._hists[name] = h
            h.observe(value, exemplar=exemplar, now=now)

    # -- read path ----------------------------------------------------

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def counter_window(self, name: str, label: str,
                       now: float | None = None) -> float:
        """Sum of increments to `name` inside the rolling window."""
        if now is None:
            now = time.time()
        with self._lock:
            wins = self._counter_windows.get(name)
            if not wins:
                return 0.0
            for w in wins:
                if w.label == label:
                    return w.total(now)
        raise KeyError(f"unknown window {label!r}")

    def gauge_value(self, name: str, default=None):
        with self._lock:
            return self._gauges.get(name, default)

    def histogram_quantile(self, name: str, label: str, q: float,
                           now: float | None = None):
        """Windowed quantile of histogram `name`; None when the
        histogram is absent or the window is empty."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                return None
            return h.window_quantile(label, q, now=now)

    def histogram_fraction_over(self, name: str, label: str,
                                threshold: float,
                                now: float | None = None):
        """Windowed fraction of observations above `threshold`; None
        when the histogram is absent or the window is empty."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                return None
            return h.window_fraction_over(label, threshold, now=now)

    def window_labels(self) -> tuple:
        return tuple(lbl for lbl, _, _ in self._windows)

    def snapshot(self, now: float | None = None) -> dict:
        """Point-in-time JSON-safe view of every instrument."""
        if now is None:
            now = time.time()
        with self._lock:
            out = {
                "counters": dict(self._counters),
                "counter_windows": {
                    name: {w.label: w.total(now) for w in wins}
                    for name, wins in self._counter_windows.items()
                },
                "gauges": dict(self._gauges),
                "histograms": {
                    name: h.snapshot(now)
                    for name, h in self._hists.items()
                },
            }
        return out

    def prometheus_text(self, prefix: str = "pluss_") -> str:
        """Prometheus exposition of the live registry (histogram
        buckets + exemplars included); delegates to the exporters
        module so run-export and live-scrape share one sanitizer and
        one collision policy."""
        from . import exporters

        return "\n".join(
            exporters.prometheus_registry_lines(self, prefix=prefix)
        ) + "\n"

    # Exposed for the exporter: a consistent (counters, gauges, hists)
    # view without copying histogram internals.
    def _export_view(self):
        with self._lock:
            return (dict(self._counters), dict(self._gauges),
                    dict(self._hists))


# -- process-global switch --------------------------------------------

_registry: "MetricsRegistry | None" = None
_registry_lock = lockwitness.make_lock("metrics._registry_lock")


def enable(buckets=DEFAULT_BUCKETS,
           windows=DEFAULT_WINDOWS) -> MetricsRegistry:
    """Install a fresh process-global registry and hook it into the
    telemetry write path (`telemetry.count`/`gauge` mirror into it).
    Returns the registry. Idempotent-per-call: each call replaces the
    previous registry."""
    from .. import telemetry

    global _registry
    with _registry_lock:
        reg = MetricsRegistry(buckets=buckets, windows=windows)
        _registry = reg
        telemetry.set_metrics_sink(reg)
    return reg


def disable() -> "MetricsRegistry | None":
    """Unhook and drop the global registry; returns it (None if
    idle)."""
    from .. import telemetry

    global _registry
    with _registry_lock:
        reg = _registry
        _registry = None
        telemetry.set_metrics_sink(None)
    return reg


def get() -> "MetricsRegistry | None":
    return _registry


def observe(name: str, value: float, exemplar=None) -> None:
    """Record into the global registry's histogram `name`; no-op when
    the registry is disabled. The serving hot path calls this, so the
    disabled cost is one global read + None check."""
    reg = _registry
    if reg is not None:
        reg.observe(name, value, exemplar=exemplar)


# -- scrape endpoint --------------------------------------------------


class MetricsServer:
    """Background stdlib HTTP server for external probes.

    Routes: `GET /metrics` (and `/`) always serve the registry in
    Prometheus text format; when the optional `healthz` / `stats` /
    `bundles` callables are wired (the serve-mode CLI passes the
    AnalysisService's introspection methods and the flight recorder's
    bundle index), `GET /healthz`, `GET /stats`, and
    `GET /debug/bundles` serve their JSON — the same bodies the JSONL
    control requests answer with, so liveness probes and dashboards
    don't need to speak the serving protocol. `/healthz` stays
    answerable even without a service callable (plain liveness of the
    scrape server itself). The `profile` callable (the serve CLI
    passes `profiler.snapshot`) backs `GET /debug/profile`: the live
    sampling-profiler snapshot when the profiler is running, and a
    structured 404 JSON body (not a bare HTML error page) when it is
    off, so pollers always get machine-readable state. The optional
    `prometheus` callable overrides the `/metrics` body entirely (the
    fabric router passes its merged fleet exposition,
    fabric/router.py `fleet_prometheus_text`, so one scrape covers
    every worker); when it raises, the local registry is served as
    the fallback. `port=0` binds an ephemeral port (read it back from
    `.port`). Serves 404 elsewhere and never raises into the serving
    thread."""

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1", prefix: str = "pluss_",
                 healthz=None, stats=None, bundles=None,
                 profile=None, prometheus=None):
        import http.server

        reg = registry

        def _json_route(path: str):
            """(status, payload) for `path`, or None for no route."""
            if path == "/healthz":
                return 200, (healthz() if healthz is not None else {
                    "status": "ok", "service": False,
                })
            if path == "/stats" and stats is not None:
                return 200, stats()
            if path == "/debug/bundles" and bundles is not None:
                return 200, bundles()
            if path == "/debug/profile" and profile is not None:
                snap = profile()
                if snap is None:
                    return 404, {
                        "error": "profiler not running",
                        "status": 404,
                        "hint": "start serve mode with "
                                "--profile-hz HZ to enable the "
                                "sampling profiler",
                    }
                return 200, snap
            return None

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib naming)
                path = self.path.split("?", 1)[0]
                status = 200
                if path in ("/metrics", "/"):
                    try:
                        if prometheus is not None:
                            try:
                                text = prometheus()
                            except Exception:
                                text = reg.prometheus_text(
                                    prefix=prefix
                                )
                        else:
                            text = reg.prometheus_text(prefix=prefix)
                        body = text.encode()
                        ctype = ("text/plain; version=0.0.4; "
                                 "charset=utf-8")
                    except Exception as e:  # pragma: no cover
                        self.send_error(500, repr(e))
                        return
                else:
                    try:
                        routed = _json_route(path)
                    except Exception as e:  # pragma: no cover
                        self.send_error(500, repr(e))
                        return
                    if routed is None:
                        self.send_error(404)
                        return
                    status, payload = routed
                    body = (json.dumps(payload) + "\n").encode()
                    ctype = "application/json"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request stderr
                pass

        self._httpd = http.server.ThreadingHTTPServer(
            (host, int(port)), _Handler
        )
        self._httpd.daemon_threads = True
        self.host = self._httpd.server_address[0]
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name="pluss-metrics-scrape", daemon=True,
        )
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
