"""Telemetry exporters: Chrome trace_event JSON and Prometheus text.

The telemetry layer's own JSON export (Telemetry.to_json) is the
stable machine-readable record, but neither of the two standard
tool ecosystems reads it directly:

- **Chrome trace_event** (`chrome_trace_json` / CLI `--trace-out`) —
  the span tree as complete ("X") events loadable in Perfetto
  (ui.perfetto.dev) or chrome://tracing. Nesting is preserved exactly:
  each ROOT span gets its own `tid` track (spans from concurrent
  service threads never interleave on one track), children nest by
  timestamp containment within their root's track, and a span's
  device-sync measurement (`Span.block` under device_sync=True) rides
  in `args.sync_s`. Telemetry events become instant ("i") events on
  tid 0.
- **Prometheus text exposition** (`prometheus_lines` / CLI
  `--metrics-out`) — counters as `<prefix><name>_total` counter
  samples, numeric gauges as `<prefix><name>` gauges, plus the run
  duration; names are sanitized to the Prometheus grammar
  (`[a-zA-Z_:][a-zA-Z0-9_:]*`). The file form suits the node-exporter
  textfile collector; a serving wrapper can expose it on /metrics
  verbatim.

Both exporters accept either a live `Telemetry` object or an
already-exported telemetry JSON document (so saved
`--telemetry-out` files convert offline), and both are deterministic
functions of the run: exporting the same stopped run twice is
byte-identical (pinned by tests/test_obs.py).
"""

from __future__ import annotations

import json
import re

from ..io import atomic_write_text


def _doc(tele_or_doc) -> dict:
    """Normalize the input: a Telemetry object exports itself, a dict
    (a parsed --telemetry-out file) passes through."""
    if isinstance(tele_or_doc, dict):
        return tele_or_doc
    return tele_or_doc.to_json()


# -- Chrome trace_event ------------------------------------------------


def _span_events(span: dict, tid: int, out: list) -> None:
    ev: dict = {
        "name": span["name"],
        "cat": "span",
        "ph": "X",
        # trace_event timestamps are microseconds; floats are legal and
        # keep the containment exact (no rounding can push a child's
        # end past its parent's)
        "ts": round(span["start_s"] * 1e6, 3),
        "dur": round(span["wall_s"] * 1e6, 3),
        "pid": 1,
        "tid": tid,
    }
    args = dict(span.get("attrs") or {})
    if span.get("sync_s") is not None:
        args["sync_s"] = span["sync_s"]
    if args:
        ev["args"] = args
    out.append(ev)
    for child in span.get("children", ()):
        _span_events(child, tid, out)


def chrome_trace_events(tele_or_doc) -> list[dict]:
    """The run's spans/events as a trace_event list, in deterministic
    order (metadata, then spans in preorder per root, then instants).
    """
    doc = _doc(tele_or_doc)
    events: list[dict] = [{
        "name": "process_name",
        "ph": "M",
        "pid": 1,
        "args": {"name": "pluss"},
    }]
    # one tid per ROOT span: root trees come from thread-local stacks,
    # so siblings from different service threads may overlap in time —
    # on separate tracks the viewer (and the round-trip test) can rely
    # purely on timestamp containment for nesting
    for i, root in enumerate(doc.get("spans", []), start=1):
        events.append({
            "name": "thread_name",
            "ph": "M",
            "pid": 1,
            "tid": i,
            "args": {"name": f"{root['name']} #{i}"},
        })
    for i, root in enumerate(doc.get("spans", []), start=1):
        _span_events(root, i, events)
    for ev in doc.get("events", []):
        data = {k: v for k, v in ev.items() if k not in ("name", "t_s")}
        ie: dict = {
            "name": ev.get("name", "event"),
            "cat": "event",
            "ph": "i",
            "s": "g",
            "ts": round(float(ev.get("t_s", 0.0)) * 1e6, 3),
            "pid": 1,
            "tid": 0,
        }
        if data:
            ie["args"] = data
        events.append(ie)
    return events


def chrome_trace_json(tele_or_doc) -> dict:
    return {
        "traceEvents": chrome_trace_events(tele_or_doc),
        "displayTimeUnit": "ms",
        "otherData": {"exporter": "pluss_sampler_optimization_tpu"},
    }


def chrome_trace_text(tele_or_doc) -> str:
    """Serialized trace, deterministic bytes for a given run."""
    return json.dumps(
        chrome_trace_json(tele_or_doc), sort_keys=True, indent=1
    ) + "\n"


def write_chrome_trace(path: str, tele_or_doc) -> None:
    atomic_write_text(path, chrome_trace_text(tele_or_doc))


# -- Prometheus text exposition ----------------------------------------

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def prometheus_metric_name(name: str, prefix: str = "pluss_") -> str:
    """Sanitize an arbitrary telemetry counter/gauge name into the
    Prometheus metric-name grammar (invalid chars -> '_', leading
    digit guarded by the prefix)."""
    out = prefix + re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    assert _NAME_OK.match(out), out
    return out


def resolve_prometheus_names(pairs) -> dict:
    """Collision-safe name assignment. `pairs` is a list of
    (raw_key, base_name); returns {raw_key: unique_metric_name}.

    Two distinct telemetry names can sanitize to the same Prometheus
    name (e.g. "cache/hits" and "cache.hits" both become
    "pluss_cache_hits") — emitting both would silently overwrite one
    sample in the scraper. When a sanitized name is claimed by more
    than one raw key, the first key in sorted order keeps the base
    name and every other key gets a deterministic 8-hex suffix derived
    from its raw key, so the mapping is stable across processes and
    insertion orders."""
    import hashlib

    groups: dict = {}
    for raw, base in pairs:
        groups.setdefault(base, []).append(raw)
    out: dict = {}
    for base, raws in groups.items():
        if len(raws) == 1:
            out[raws[0]] = base
            continue
        for i, raw in enumerate(sorted(raws, key=repr)):
            if i == 0:
                out[raw] = base
            else:
                digest = hashlib.sha1(
                    repr(raw).encode()
                ).hexdigest()[:8]
                out[raw] = f"{base}_{digest}"
    return out


def prometheus_lines(tele_or_doc, prefix: str = "pluss_") -> list[str]:
    """Counters (as `*_total`), numeric gauges, and the run duration
    in text exposition format, sorted by metric name (deterministic
    bytes for a given run). Non-numeric gauges are skipped — the
    exposition format has no string samples. Sanitization collisions
    get deterministic suffixes (resolve_prometheus_names)."""
    doc = _doc(tele_or_doc)
    pairs: list = []
    for name in doc.get("counters", {}):
        pairs.append(
            (("counter", name),
             prometheus_metric_name(name, prefix) + "_total")
        )
    for name, value in doc.get("gauges", {}).items():
        if isinstance(value, bool) or not isinstance(
            value, (int, float)
        ):
            continue
        pairs.append(
            (("gauge", name), prometheus_metric_name(name, prefix))
        )
    names = resolve_prometheus_names(pairs)
    metrics: list[tuple[str, str, float]] = []
    for name, value in doc.get("counters", {}).items():
        metrics.append(
            (names[("counter", name)], "counter", float(value))
        )
    for name, value in doc.get("gauges", {}).items():
        if isinstance(value, bool) or not isinstance(
            value, (int, float)
        ):
            continue
        metrics.append((names[("gauge", name)], "gauge", float(value)))
    metrics.append(
        (prefix + "run_duration_seconds", "gauge",
         float(doc.get("duration_s", 0.0)))
    )
    lines: list[str] = []
    for name, mtype, value in sorted(metrics):
        lines.append(f"# TYPE {name} {mtype}")
        lines.append(f"{name} {value:g}")
    return lines


def prometheus_registry_lines(registry,
                              prefix: str = "pluss_") -> list[str]:
    """Live-registry exposition: counters (with `_total`), numeric
    gauges, and histograms (cumulative `_bucket{le=...}` series plus
    `_sum`/`_count`, with OpenMetrics exemplars where a trace id was
    recorded). Shares the sanitizer and the collision policy with the
    per-run exporter; accepts a MetricsRegistry or its snapshot()
    dict."""
    snap = (registry if isinstance(registry, dict)
            else registry.snapshot())
    pairs: list = []
    for name in snap.get("counters", {}):
        pairs.append(
            (("counter", name),
             prometheus_metric_name(name, prefix) + "_total")
        )
    for name, value in snap.get("gauges", {}).items():
        if isinstance(value, bool) or not isinstance(
            value, (int, float)
        ):
            continue
        pairs.append(
            (("gauge", name), prometheus_metric_name(name, prefix))
        )
    for name in snap.get("histograms", {}):
        pairs.append(
            (("histogram", name), prometheus_metric_name(name, prefix))
        )
    names = resolve_prometheus_names(pairs)

    blocks: list[tuple[str, list[str]]] = []
    for name, value in snap.get("counters", {}).items():
        out = names[("counter", name)]
        blocks.append((out, [f"# TYPE {out} counter",
                             f"{out} {float(value):g}"]))
    for name, value in snap.get("gauges", {}).items():
        if isinstance(value, bool) or not isinstance(
            value, (int, float)
        ):
            continue
        out = names[("gauge", name)]
        blocks.append((out, [f"# TYPE {out} gauge",
                             f"{out} {float(value):g}"]))
    for name, hist in snap.get("histograms", {}).items():
        out = names[("histogram", name)]
        body = [f"# TYPE {out} histogram"]
        exemplars = hist.get("exemplars", {})
        for le, cum in hist["buckets"].items():
            line = f'{out}_bucket{{le="{le}"}} {cum}'
            ex = exemplars.get(le)
            if ex is not None:
                line += (f' # {{trace_id="{ex[0]}"}}'
                         f" {float(ex[1]):g}")
            body.append(line)
        body.append(f"{out}_sum {float(hist['sum']):g}")
        body.append(f"{out}_count {int(hist['count'])}")
        blocks.append((out, body))

    lines: list[str] = []
    for _, body in sorted(blocks, key=lambda b: b[0]):
        lines.extend(body)
    return lines


def prometheus_text(tele_or_doc, prefix: str = "pluss_") -> str:
    return "\n".join(prometheus_lines(tele_or_doc, prefix)) + "\n"


def write_prometheus(path: str, tele_or_doc,
                     prefix: str = "pluss_") -> None:
    atomic_write_text(path, prometheus_text(tele_or_doc, prefix))
