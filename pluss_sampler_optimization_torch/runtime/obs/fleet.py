"""Fleet telemetry: merge per-worker snapshots, back the fleet SLO
sentinel, and assemble cross-process traces.

The fabric router (service/fabric/router.py) polls each worker's
telemetry over `stats` wire frames; everything here is the pure-data
half of that loop — jax-free, socket-free functions the router, the
offline tools, and the tests share:

- **merge_registry_snapshots** — N MetricsRegistry.snapshot() dicts
  into one: counters/windows summed, histogram buckets summed
  bucket-by-bucket (every process uses the same default bucket edges,
  so cumulative semantics survive the sum), window quantiles taken as
  the max across workers (a merged quantile cannot be computed from
  quantiles; the max is the conservative fleet tail).
- **fleet_stats / fleet_metrics** — the `stats`/`metrics` control
  lines' fleet answers: per-worker sections verbatim (the
  single-process shapes, labeled by worker id) plus the numeric fleet
  sums, so `fleet == sum(workers)` is checkable instrument by
  instrument.
- **FleetView** — duck-types the MetricsRegistry read methods the SLO
  sentinel uses (histogram_fraction_over / histogram_quantile /
  counter_window), backed by the workers' pre-digested `slo_inputs`
  snapshots: violation fractions merge count-weighted, counters sum,
  quantiles take the fleet max. One sentinel then evaluates
  fleet-level burn rates with the unmodified runtime/obs/slo.py.
- **trace_index / assemble_chrome_trace** — join router rows (source
  ledger.ROUTER_SOURCE, carrying the `router` span block) with worker
  rows (source "service") on trace_id and emit one Chrome trace per
  request: the router track shows router_queue/route/wire_out/
  worker_rtt/wire_back, the worker track shows queue/batch_wait/
  execute inside the worker's own span. Every duration is a
  monotonic delta measured on ONE host; the worker track is placed
  INSIDE the router's RTT via the wire split (RTT - worker_s halved),
  so no cross-host clock agreement is ever assumed.
"""

from __future__ import annotations

import json

from . import ledger as obs_ledger


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def deep_sum(dicts) -> dict:
    """Recursive numeric merge of dicts: numeric leaves sum, nested
    dicts recurse, everything else (strings, lists, mixed types) is
    dropped — the result is exactly the summable part of the inputs,
    in first-seen key order."""
    keys: list = []
    for d in dicts:
        if isinstance(d, dict):
            for k in d:
                if k not in keys:
                    keys.append(k)
    out: dict = {}
    for k in keys:
        vals = [d[k] for d in dicts if isinstance(d, dict) and k in d]
        nums = [v for v in vals if _is_num(v)]
        subs = [v for v in vals if isinstance(v, dict)]
        if subs and not nums:
            out[k] = deep_sum(subs)
        elif nums and not subs:
            out[k] = sum(nums)
    return out


def _merge_histograms(hists: list) -> dict:
    """Merge RollingHistogram.snapshot() dicts: buckets (cumulative,
    shared edges) and sum/count add; the first exemplar per bucket is
    kept; window counts/sums add while window quantiles take the max
    across workers (the conservative fleet tail)."""
    out: dict = {"count": 0, "sum": 0.0, "buckets": {},
                 "exemplars": {}, "windows": {}}
    for h in hists:
        if not isinstance(h, dict):
            continue
        out["count"] += int(h.get("count") or 0)
        out["sum"] += float(h.get("sum") or 0.0)
        for le, cum in (h.get("buckets") or {}).items():
            out["buckets"][le] = out["buckets"].get(le, 0) + int(cum)
        for le, ex in (h.get("exemplars") or {}).items():
            out["exemplars"].setdefault(le, ex)
        for lbl, win in (h.get("windows") or {}).items():
            m = out["windows"].setdefault(lbl, {
                "count": 0, "sum": 0.0,
                "p50": None, "p95": None, "p99": None,
            })
            m["count"] += int(win.get("count") or 0)
            m["sum"] += float(win.get("sum") or 0.0)
            for q in ("p50", "p95", "p99"):
                v = win.get(q)
                if v is not None and (m[q] is None or v > m[q]):
                    m[q] = v
    return out


def merge_registry_snapshots(snapshots) -> dict:
    """N MetricsRegistry.snapshot() dicts -> one snapshot of the same
    shape (fit for exporters.prometheus_registry_lines): counters and
    counter windows summed, numeric gauges summed (non-numeric
    dropped), histograms merged bucket-by-bucket."""
    snaps = [s for s in snapshots if isinstance(s, dict)]
    counters: dict = {}
    counter_windows: dict = {}
    gauges: dict = {}
    hist_names: list = []
    for s in snaps:
        for name, v in (s.get("counters") or {}).items():
            if _is_num(v):
                counters[name] = counters.get(name, 0.0) + v
        for name, wins in (s.get("counter_windows") or {}).items():
            m = counter_windows.setdefault(name, {})
            for lbl, v in (wins or {}).items():
                if _is_num(v):
                    m[lbl] = m.get(lbl, 0.0) + v
        for name, v in (s.get("gauges") or {}).items():
            if _is_num(v):
                gauges[name] = gauges.get(name, 0.0) + v
        for name in (s.get("histograms") or {}):
            if name not in hist_names:
                hist_names.append(name)
    histograms = {
        name: _merge_histograms([
            (s.get("histograms") or {}).get(name) for s in snaps
        ])
        for name in hist_names
    }
    return {
        "counters": counters,
        "counter_windows": counter_windows,
        "gauges": gauges,
        "histograms": histograms,
    }


def fleet_stats(router_stats: dict, worker_snapshots: dict) -> dict:
    """The `stats` control line's fleet document: the router-local
    stats verbatim (role/counters/workers), each worker's own `stats`
    section under worker_stats (per-worker labels, single-process
    shapes), and the numeric fleet sums under `fleet` — so
    fleet == sum(workers) is checkable key by key."""
    workers: dict = {}
    for wid in sorted(worker_snapshots, key=str):
        snap = worker_snapshots[wid]
        if isinstance(snap, dict) and isinstance(
            snap.get("stats"), dict
        ):
            workers[str(wid)] = snap["stats"]
    out = dict(router_stats)
    out["worker_stats"] = workers
    out["fleet"] = {
        "workers": len(workers),
        "executor": deep_sum([
            w.get("executor") for w in workers.values()
        ]),
        "cache": deep_sum([w.get("cache") for w in workers.values()]),
    }
    return out


def fleet_metrics(own_snapshot: dict | None,
                  worker_snapshots: dict) -> dict:
    """The `metrics` control line's fleet document: the merged
    registry snapshot at the top level (the exact keys a
    single-process `metrics` response carries), the merged Prometheus
    exposition, and each worker's unmerged snapshot under `workers`.
    """
    from . import exporters

    per_worker: dict = {}
    for wid in sorted(worker_snapshots, key=str):
        snap = worker_snapshots[wid]
        m = snap.get("metrics") if isinstance(snap, dict) else None
        if isinstance(m, dict) and m.get("enabled", True):
            per_worker[str(wid)] = {
                k: v for k, v in m.items() if k != "prometheus"
            }
    merged = merge_registry_snapshots(
        ([own_snapshot] if own_snapshot is not None else [])
        + list(per_worker.values())
    )
    out: dict = {
        "enabled": bool(per_worker) or own_snapshot is not None,
        "fleet": {"workers": len(per_worker)},
    }
    out.update(merged)
    out["prometheus"] = "\n".join(
        exporters.prometheus_registry_lines(merged)
    ) + "\n"
    out["workers"] = per_worker
    return out


class FleetView:
    """The fleet as one registry, for the SLO sentinel.

    Duck-types exactly the MetricsRegistry read methods
    slo._registry_checks calls, backed by each live link's last
    `slo_inputs` snapshot (the worker pre-digests its own rolling
    windows — every number here was computed against a single
    process's monotonic clock):

    - histogram_fraction_over: count-weighted mean of the workers'
      violation fractions (the exact fleet fraction, since each
      worker reports fraction * its own observation count);
    - counter_window: sum across workers;
    - histogram_quantile: max across workers (quantiles don't merge;
      the max is the conservative fleet tail, reported as burn-check
      detail only).
    """

    def __init__(self, router):
        self.router = router

    def _inputs(self):
        for link in self.router.links:
            snap = link.last_snapshot
            si = (snap.get("slo_inputs")
                  if isinstance(snap, dict) else None)
            if isinstance(si, dict) and si.get("enabled"):
                yield si

    def _windows(self, label: str):
        for si in self._inputs():
            win = (si.get("windows") or {}).get(label)
            if isinstance(win, dict):
                yield win

    def histogram_fraction_over(self, name: str, label: str,
                                threshold: float, now=None):
        num = 0.0
        den = 0
        for win in self._windows(label):
            n = int(win.get("latency_count") or 0)
            frac = win.get("latency_frac_over")
            if n > 0 and frac is not None:
                num += float(frac) * n
                den += n
        return (num / den) if den else None

    def histogram_quantile(self, name: str, label: str, q: float,
                           now=None):
        if abs(q - 0.95) > 1e-9:
            return None
        vals = [win.get("latency_p95")
                for win in self._windows(label)]
        vals = [v for v in vals if v is not None]
        return max(vals) if vals else None

    def counter_window(self, name: str, label: str, now=None
                       ) -> float:
        return sum(
            float(win.get(name) or 0.0)
            for win in self._windows(label)
        )


# -- cross-process trace assembly --------------------------------------


def trace_index(rows) -> dict:
    """{trace_id: {"router": row | None, "workers": [rows]}} over
    parsed ledger rows. Router rows are the fabric.router-source
    request rows; worker rows are the fabric workers' "service" rows
    (worker_id stamped). The LAST router row per trace_id wins — a
    re-dispatched request writes one row per resolution attempt only
    at the final owner, so duplicates only arise from replayed
    ledgers."""
    out: dict = {}
    for row in rows:
        if row.get("kind") != "request":
            continue
        tid = row.get("trace_id")
        if not tid:
            continue
        slot = out.setdefault(tid, {"router": None, "workers": []})
        if row.get("source") == obs_ledger.ROUTER_SOURCE:
            slot["router"] = row
        elif row.get("worker_id") is not None:
            slot["workers"].append(row)
    return out


def _event(name: str, ts_s: float, dur_s: float, pid: int, tid: int,
           args: dict | None = None) -> dict:
    ev: dict = {
        "name": name, "cat": "span", "ph": "X",
        "ts": round(ts_s * 1e6, 3),
        "dur": round(max(0.0, dur_s) * 1e6, 3),
        "pid": pid, "tid": tid,
    }
    if args:
        ev["args"] = {k: v for k, v in args.items() if v is not None}
    return ev


def assemble_chrome_trace(router_row: dict,
                          worker_rows: list | None = None) -> dict:
    """One request's end-to-end Chrome trace from ledger rows alone.

    t=0 is the router's submit; the router track (pid 1) lays out
    router_queue -> route -> wire_out -> worker_rtt -> wire_back from
    the row's `router` span block, and the worker track (pid 2)
    places the worker's own span inside the RTT at wire_out's end,
    with the worker row's queue_s/batch_wait_s/execute_s stages
    nested inside. All placements are sums of single-host monotonic
    deltas — no timestamp from one host is ever compared with a
    timestamp from another.
    """
    rb = router_row.get("router") or {}

    def _f(key, default=0.0):
        v = rb.get(key)
        return float(v) if v is not None else default

    queue = _f("router_queue_s")
    route = _f("route_s")
    wire_out = _f("wire_out_s")
    rtt = _f("worker_rtt_s")
    worker_s = _f("worker_s",
                  default=max(0.0, rtt - 2 * wire_out))
    wire_back = _f("wire_back_s")
    total = float(router_row.get("latency_s") or (
        queue + route + rtt
    ))
    t_sent = queue + route
    t_worker = t_sent + wire_out

    events: list = [
        {"name": "process_name", "ph": "M", "pid": 1,
         "args": {"name": "router"}},
        {"name": "process_name", "ph": "M", "pid": 2,
         "args": {"name": "worker %s" % rb.get("worker_id")}},
    ]
    events.append(_event("request", 0.0, total, 1, 1, {
        "trace_id": router_row.get("trace_id"),
        "span_id": router_row.get("span_id"),
        "fingerprint": router_row.get("fingerprint"),
        "model": router_row.get("model"),
        "engine": router_row.get("engine_requested"),
        "ok": router_row.get("ok"),
        "cache": router_row.get("cache"),
        "hops": rb.get("hops"),
    }))
    events.append(_event("router_queue", 0.0, queue, 1, 2))
    events.append(_event("route", queue, route, 1, 2,
                         {"worker_id": rb.get("worker_id")}))
    events.append(_event("worker_rtt", t_sent, rtt, 1, 2))
    events.append(_event("wire_out", t_sent, wire_out, 1, 3))
    events.append(_event("wire_back", t_sent + rtt - wire_back,
                         wire_back, 1, 3))

    for i, wrow in enumerate(worker_rows or [], start=1):
        events.append(_event("worker", t_worker, worker_s, 2, i, {
            "worker_id": wrow.get("worker_id"),
            "span_id": wrow.get("span_id"),
            "cache": wrow.get("cache"),
            "coalesced": wrow.get("coalesced"),
            "latency_s": wrow.get("latency_s"),
        }))
        cursor = t_worker
        for stage in ("queue_s", "batch_wait_s", "execute_s"):
            v = wrow.get(stage)
            if v is None:
                continue
            events.append(_event(stage[:-2], cursor, float(v), 2, i))
            cursor += float(v)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "exporter": "pluss_sampler_optimization_tpu.fleet",
            "trace_id": router_row.get("trace_id"),
        },
    }


def assemble_traces(rows, trace_id: str | None = None) -> dict:
    """{trace_id: chrome_trace_doc} for every joinable trace in the
    rows (router row present), or just the one requested."""
    idx = trace_index(rows)
    out: dict = {}
    for tid in sorted(idx):
        if trace_id is not None and tid != trace_id:
            continue
        slot = idx[tid]
        if slot["router"] is None:
            continue
        out[tid] = assemble_chrome_trace(
            slot["router"], slot["workers"]
        )
    return out


def trace_text(doc: dict) -> str:
    """Deterministic bytes for one assembled trace."""
    return json.dumps(doc, sort_keys=True, indent=1) + "\n"
