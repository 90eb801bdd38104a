"""SLO burn-rate sentinel over the live registry and the ledger tail.

The metrics registry (runtime/obs/metrics.py) answers "what are the
numbers right now"; this module answers the operator question one
level up — "are we inside budget, and if not, how fast are we burning
it". Objectives come from config.SLOConfig; the evaluation uses the
SRE multi-window burn-rate formulation:

- each objective defines a *budget*: the fraction of requests allowed
  to violate it (latency_budget for "slower than latency_p95_s",
  error_budget for "failed or degraded");
- the *burn rate* of a window is the observed violation fraction
  divided by the budget — 1.0 means the error budget is being spent
  exactly as fast as the SLO allows;
- a check breaches only when the burn rate exceeds the threshold in
  BOTH the short window (fast signal) and the long window (evidence
  the regression is sustained), so one slow request can't fire but a
  sustained regression fires within ~one short window.

Two evaluation sources, same report shape:

- **live** (`evaluate(config, registry=...)`) — latency from the
  `request_total_s` rolling histogram, error rates from the
  windowed `service_*` counters the executor mirrors into the
  registry; used by the serve-mode sentinel thread.
- **ledger tail** (`evaluate(config, rows=...)`) — the same checks
  recomputed from request-row timestamps/latencies (windows anchored
  at the newest row, so archived ledgers audit their own era), plus
  the drift-breach and batch-occupancy checks that only the ledger
  can answer; used by tools/check_slo.py as the offline CI gate.

`SLOSentinel` is the serve-mode background thread: every `interval_s`
it evaluates, stores the latest report (surfaced in the `metrics`
serve response), counts `slo_evaluations`, and on breach emits an
`slo_breach` telemetry event plus the `slo_breach` counter (both of
which mirror straight back into the registry — a scrape shows the
breach without reading the report).
"""

from __future__ import annotations

import re
import threading
import time

from .. import telemetry
from ...config import SLOConfig

DEFAULT_SLO = SLOConfig()

# Histogram the executor records total request latency into.
LATENCY_HISTOGRAM = "request_total_s"


def window_span_s(label: str) -> float:
    """Seconds covered by a window label like "30s" / "5m" / "1h"."""
    m = re.fullmatch(r"(\d+(?:\.\d+)?)([smh])", label)
    if not m:
        raise ValueError(f"bad window label {label!r}")
    mult = {"s": 1.0, "m": 60.0, "h": 3600.0}[m.group(2)]
    return float(m.group(1)) * mult


def _burn_check(name: str, fractions: dict, budget: float,
                threshold: float, detail: dict) -> dict:
    """Build one check from per-window violation fractions. A window
    with no data (None) contributes no evidence; breaching requires
    BOTH windows over threshold."""
    burn = {
        lbl: (None if frac is None else frac / budget)
        for lbl, frac in fractions.items()
    }
    over = [b is not None and b > threshold for b in burn.values()]
    breach = len(over) > 0 and all(over)
    out = {"name": name, "ok": not breach, "burn": burn,
           "budget": budget}
    out.update(detail)
    return out


def _registry_checks(config: SLOConfig, registry, now) -> list[dict]:
    checks: list[dict] = []
    short, long_ = config.windows
    if config.latency_p95_s is not None:
        fracs = {
            lbl: registry.histogram_fraction_over(
                LATENCY_HISTOGRAM, lbl, config.latency_p95_s, now=now
            )
            for lbl in (short, long_)
        }
        checks.append(_burn_check(
            "latency_p95", fracs, config.latency_budget,
            config.burn_rate_threshold,
            {"latency_p95_s": config.latency_p95_s,
             "observed_p95": {
                 lbl: registry.histogram_quantile(
                     LATENCY_HISTOGRAM, lbl, 0.95, now=now)
                 for lbl in (short, long_)
             }},
        ))
    fracs = {}
    for lbl in (short, long_):
        submitted = registry.counter_window("service_submitted", lbl,
                                            now=now)
        bad = (registry.counter_window("service_failed", lbl, now=now)
               + registry.counter_window("service_degraded", lbl,
                                         now=now))
        fracs[lbl] = (bad / submitted) if submitted > 0 else None
    checks.append(_burn_check(
        "error_budget", fracs, config.error_budget,
        config.burn_rate_threshold, {},
    ))
    return checks


def _row_checks(config: SLOConfig, rows: list, now) -> list[dict]:
    from . import ledger as ledger_mod

    checks: list[dict] = []
    short, long_ = config.windows
    spans = {short: window_span_s(short), long_: window_span_s(long_)}
    req = [r for r in rows if r.get("kind") == "request"]
    if now is None:
        now = max((float(r["ts"]) for r in req), default=time.time())

    def in_window(lbl):
        return [r for r in req
                if now - float(r["ts"]) <= spans[lbl]]

    if config.latency_p95_s is not None:
        fracs = {}
        for lbl in (short, long_):
            win = [r for r in in_window(lbl)
                   if r.get("latency_s") is not None]
            fracs[lbl] = (
                sum(1 for r in win
                    if float(r["latency_s"]) > config.latency_p95_s)
                / len(win)
            ) if win else None
        checks.append(_burn_check(
            "latency_p95", fracs, config.latency_budget,
            config.burn_rate_threshold,
            {"latency_p95_s": config.latency_p95_s},
        ))
    fracs = {}
    for lbl in (short, long_):
        win = in_window(lbl)
        # submit-weighted, matching the live counters: a row speaks
        # for itself plus its singleflight joiners
        total = sum(1 + int(r.get("coalesced") or 0) for r in win)
        bad = sum(
            (1 + int(r.get("coalesced") or 0))
            for r in win
            if (not r["ok"]) or r.get("degraded")
        )
        fracs[lbl] = (bad / total) if total > 0 else None
    checks.append(_burn_check(
        "error_budget", fracs, config.error_budget,
        config.burn_rate_threshold, {},
    ))

    # drift: any breached drift row inside the long window (latest per
    # (model, n) wins, same rule as the ledger aggregate)
    latest: dict = {}
    for r in rows:
        if r.get("kind") == "drift":
            latest[(r["model"], r["n"])] = r
    breached = [
        {"model": m, "n": n}
        for (m, n), r in sorted(latest.items())
        if r.get("breach") and now - float(r["ts"]) <= spans[long_]
    ]
    checks.append({
        "name": "drift", "ok": not breached, "burn": None,
        "breached": breached,
    })

    if config.min_batch_occupancy is not None:
        occ = ledger_mod.aggregate(req)["batching"]["occupancy_p50"]
        has_batches = any(r.get("batch_id") for r in req)
        ok = (not has_batches) or occ >= config.min_batch_occupancy
        checks.append({
            "name": "batch_occupancy", "ok": ok, "burn": None,
            "occupancy_p50": occ,
            "min_batch_occupancy": config.min_batch_occupancy,
        })
    return checks


def evaluate(config: SLOConfig = DEFAULT_SLO, registry=None,
             rows=None, now=None) -> dict:
    """Evaluate every applicable SLO check; returns
    {"ok", "checks": [...], "windows"}. With a registry the live
    latency/error checks run; with ledger rows the row-derived checks
    (including drift and occupancy) run; with both, both sets run
    (check names are distinct per source only for latency/error — the
    registry wins, rows add drift/occupancy)."""
    checks: list[dict] = []
    if registry is not None:
        checks.extend(_registry_checks(config, registry, now))
    if rows is not None:
        row_checks = _row_checks(config, rows, now)
        if registry is not None:
            # live counters already cover latency/error; keep only the
            # ledger-exclusive checks to avoid double reporting
            row_checks = [c for c in row_checks
                          if c["name"] in ("drift", "batch_occupancy")]
        checks.extend(row_checks)
    return {
        "ok": all(c["ok"] for c in checks),
        "checks": checks,
        "windows": list(config.windows),
    }


def format_report(report: dict) -> list[str]:
    """Human-readable lines, one per check, for the CLI gate."""
    lines = []
    for c in report["checks"]:
        status = "ok" if c["ok"] else "BREACH"
        if c.get("burn"):
            burns = " ".join(
                f"burn[{lbl}]={'-' if b is None else format(b, '.3g')}"
                for lbl, b in c["burn"].items()
            )
            lines.append(f"slo {c['name']}: {status} {burns} "
                         f"budget={c['budget']:g}")
        else:
            lines.append(f"slo {c['name']}: {status}")
    lines.append(
        "slo overall: " + ("ok" if report["ok"] else "BREACH")
    )
    return lines


class SLOSentinel:
    """Background evaluator for serve mode: periodically runs
    `evaluate` against the live registry (and the ledger tail when a
    path is configured), keeps the latest report, and emits
    `slo_breach` telemetry (event + counter, mirrored into the
    registry) for every breached check."""

    def __init__(self, config: SLOConfig = DEFAULT_SLO, registry=None,
                 ledger_path: str | None = None,
                 interval_s: float = 10.0, tail_rows: int = 512,
                 regress_bench: list[str] | None = None,
                 regress_noise_band: float | None = None):
        self.config = config
        self.registry = registry
        self.ledger_path = ledger_path
        self.interval_s = float(interval_s)
        self.tail_rows = int(tail_rows)
        # Perf-regression leg (runtime/obs/regress.py): evaluated on
        # the same tick over the same ledger tail, plus any BENCH_r*
        # evidence files handed in. None band = module default.
        self.regress_bench = list(regress_bench or [])
        self.regress_noise_band = regress_noise_band
        self.last_report: dict | None = None
        self.last_regression: dict | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def evaluate_once(self, now=None) -> dict:
        rows = None
        if self.ledger_path:
            from . import ledger as ledger_mod

            rows = ledger_mod.tail(self.ledger_path, self.tail_rows)
        report = evaluate(self.config, registry=self.registry,
                          rows=rows, now=now)
        self.last_report = report
        telemetry.count("slo_evaluations")
        for c in report["checks"]:
            if not c["ok"]:
                telemetry.count("slo_breach")
                burn = c.get("burn") or {}
                telemetry.event(
                    "slo_breach", check=c["name"],
                    **{f"burn_{lbl}": b for lbl, b in burn.items()
                       if b is not None},
                )
        self._evaluate_regression(rows)
        return report

    def _evaluate_regression(self, rows) -> None:
        """The perf-regression leg of the tick: ledger-tail + bench
        trajectory through regress.evaluate(). A breach counts
        `perf_regression` into the live registry and the event reaches
        the flight recorder's bundle trigger via the record sink; a
        broken evaluation only counts — neither takes serving down."""
        if rows is None and not self.regress_bench:
            return
        from . import regress

        try:
            kwargs = {}
            if self.regress_noise_band is not None:
                kwargs["noise_band"] = self.regress_noise_band
            rep = regress.evaluate(
                rows=rows, bench_paths=self.regress_bench, **kwargs
            )
        except Exception:
            telemetry.count("regress_eval_failed")
            return
        self.last_regression = rep
        if not rep["ok"]:
            telemetry.count("perf_regression")
            telemetry.event(
                "perf_regression",
                regressed=[c["check"] for c in rep["regressed"]],
            )

    def start(self) -> "SLOSentinel":
        if self._thread is not None:
            return self

        def _loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.evaluate_once()
                except Exception:  # never kill serving on a bad eval
                    telemetry.count("slo_eval_failed")

        self._thread = threading.Thread(
            target=_loop, name="pluss-slo-sentinel", daemon=True
        )
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
