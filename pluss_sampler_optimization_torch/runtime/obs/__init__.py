"""Observability subsystem: run ledger, exporters, drift monitoring.

Three longitudinal layers over the per-run telemetry in
runtime/telemetry.py (which only ever describes ONE run and vanishes
once its JSON is written):

- **ledger** — an append-only, schema-versioned JSONL ledger with one
  row per engine/service execution (fingerprint, engine, latency,
  cache disposition, degradation chain, compile-counter deltas, MRC
  digest), written from the service executor, the CLI modes, bench.py,
  and the drift monitor; validated/GC'd by tools/check_ledger.py and
  aggregated by the CLI `stats` mode.
- **exporters** — the Telemetry span tree as Chrome `trace_event` JSON
  (Perfetto / chrome://tracing) and the counters/gauges as Prometheus
  text exposition, behind the CLI `--trace-out` / `--metrics-out`
  flags (also importable as `telemetry.exporters`).
- **drift** — small-config sampled-vs-exact MRC audits (max/mean
  absolute miss-ratio delta) appended to the ledger and gated by
  tools/check_drift.py, so the executor's silent exact→sampled
  degradation has a continuously watched accuracy bound.
- **metrics** — the LIVE view: a process-global registry of counters,
  gauges, and rolling-window latency histograms fed by the same
  telemetry.count/gauge write path, scrapeable in Prometheus text
  format (`--metrics-port` / the serve `metrics` request).
- **slo** — the burn-rate sentinel over the registry windows and the
  ledger tail (latency p95, error/degradation budget, drift status,
  batch occupancy), emitting `slo_breach` events and gated offline by
  tools/check_slo.py.
- **recorder** — the flight recorder: a bounded ring of per-request
  records with tail-based retention (errors, degradations, drift
  breaches, latency outliers kept; the boring majority dropped), fed
  by the executor and the telemetry event sink, dumping atomic
  schema-versioned post-mortem bundles on anomaly triggers (SLO
  breach, request failure, replica quarantine, drift breach,
  perf regression, explicit dump_debug / SIGUSR2); validated offline
  by tools/check_bundle.py.
- **regress** — the performance regression sentinel: per-engine /
  per-stage latency and compile-count distributions across ledger
  history plus the BENCH_r*.json headline trajectory, flagged beyond
  a noise band; gated offline by tools/check_regression.py and
  evaluated live by the serve-mode SLO sentinel.

Everything here is observation only: with no ledger path and no export
flag nothing in this package executes, and engine results are pinned
bit-identical with observability enabled vs disabled
(tests/test_obs.py, tests/test_live_obs.py).
"""

from . import (
    drift, exporters, ledger, metrics, recorder, regress, slo,
)

__all__ = [
    "drift", "exporters", "ledger", "metrics", "recorder",
    "regress", "slo",
]
