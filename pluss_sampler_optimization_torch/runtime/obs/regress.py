"""Performance regression sentinel over ledger history + bench evidence.

The ledger (runtime/obs/ledger.py) and the BENCH_r*.json evidence
sidecars record the repo's performance trajectory, but until now they
were passive artifacts: a silent 2x latency regression or a collapsed
benchmark headline only surfaced when a human re-read the numbers.
This module turns the trajectory into a guarded invariant:

- **ledger history** — per-engine request latency (p50), per-stage
  execute latency, and per-request compile-count distributions, each
  split into an older baseline half and a newer recent half by row
  timestamp; a recent half worse than baseline beyond the noise band
  is a regression;
- **bench evidence** — the headline metric series across BENCH_r*.json
  files (one value per round); the newest value falling below (for
  throughput) or above (for latency) the median of the prior rounds
  beyond the noise band is a regression.

The noise band is deliberately wide by default (25%): engines run on
shared CI hosts and the gate exists to catch step changes (an
accidental recompile per request, a lost fusion), not 3% jitter.

Consumed two ways, same evaluate():

- offline: tools/check_regression.py, the CI gate (nonzero exit on
  regression), run clean over the repo's real BENCH_r01–r05 history;
- live: the serve-mode SLO sentinel evaluates the ledger tail each
  tick; a breach counts `perf_regression` into the live registry and
  the emitted event reaches the flight recorder's bundle trigger
  (runtime/obs/recorder.py) through the record-sink path.
"""

from __future__ import annotations

import json
import os

from .ledger import _percentile

DEFAULT_NOISE_BAND = 0.25
# Ledger halves below this many rows per side say nothing: skip, don't
# guess. Bench series need fewer — each point is already a median-ish
# round headline.
DEFAULT_MIN_SAMPLES = 5
DEFAULT_MIN_BENCH_POINTS = 3

# Mean compiles/request may legitimately wobble by a fraction of a
# compile (one extra cold shape in the recent half); the absolute
# slack keeps tiny-denominator ratios from flagging noise.
COMPILE_ABS_SLACK = 0.5


def _higher_is_better(metric: str, unit: str | None) -> bool:
    """Direction of a bench headline: throughput-like metrics regress
    downward, latency-like metrics regress upward."""
    m = (metric or "").lower()
    u = (unit or "").lower()
    if "latency" in m or u in ("s", "ms", "us"):
        return False
    return True


def _split_halves(vals: list) -> tuple[list, list]:
    mid = len(vals) // 2
    return vals[:mid], vals[mid:]


def _check(name: str, baseline: float, recent: float,
           n_baseline: int, n_recent: int, noise_band: float,
           higher_is_better: bool = False,
           abs_slack: float = 0.0) -> dict:
    """One named comparison. Regressed when `recent` is worse than
    `baseline` by more than the band (plus any absolute slack)."""
    if higher_is_better:
        limit = baseline * (1.0 - noise_band) - abs_slack
        ok = recent >= limit
    else:
        limit = baseline * (1.0 + noise_band) + abs_slack
        ok = recent <= limit
    return {
        "check": name,
        "baseline": round(float(baseline), 6),
        "recent": round(float(recent), 6),
        "limit": round(float(limit), 6),
        "n_baseline": n_baseline,
        "n_recent": n_recent,
        "higher_is_better": higher_is_better,
        "ok": bool(ok),
    }


# -- ledger history ----------------------------------------------------


def evaluate_ledger_rows(rows: list[dict],
                         noise_band: float = DEFAULT_NOISE_BAND,
                         min_samples: int = DEFAULT_MIN_SAMPLES,
                         ) -> list[dict]:
    """Baseline-vs-recent checks over valid ledger request rows:
    per-engine p50 total latency, p50 execute-stage latency, and mean
    backend compiles per request. Engines without `min_samples` rows
    in BOTH halves are skipped (no check, not a pass)."""
    per_engine: dict = {}
    for row in rows:
        if row.get("kind") != "request" or not row.get("ok"):
            continue
        eng = row.get("engine_used") or row.get("engine_requested")
        if not eng:
            continue
        e = per_engine.setdefault(
            eng, {"latency": [], "execute": [], "compiles": []}
        )
        ts = float(row.get("ts", 0.0))
        lat = row.get("latency_s")
        e["latency"].append(
            (ts, float(lat)) if lat is not None else None
        )
        ex = row.get("execute_s")
        e["execute"].append(
            (ts, float(ex)) if ex is not None else None
        )
        cd = row.get("compile_delta")
        e["compiles"].append(
            (ts, float((cd or {}).get("backend_compiles", 0) or 0))
        )
    checks: list[dict] = []
    for eng in sorted(per_engine):
        e = per_engine[eng]
        series = {
            "latency_p50_s": ([p for p in e["latency"] if p], "p50"),
            "execute_p50_s": ([p for p in e["execute"] if p], "p50"),
            "compiles_mean": (e["compiles"], "mean"),
        }
        for label, (pairs, agg) in series.items():
            pairs = sorted(pairs)  # oldest -> newest by ts
            base, recent = _split_halves([v for _ts, v in pairs])
            if len(base) < min_samples or len(recent) < min_samples:
                continue
            if agg == "p50":
                b = _percentile(sorted(base), 0.50)
                r = _percentile(sorted(recent), 0.50)
                slack = 0.0
            else:
                b = sum(base) / len(base)
                r = sum(recent) / len(recent)
                slack = COMPILE_ABS_SLACK
            checks.append(_check(
                f"ledger:{eng}:{label}", b, r, len(base),
                len(recent), noise_band, abs_slack=slack,
            ))
    return checks


# -- bench evidence ----------------------------------------------------


def load_bench_history(paths: list[str]) -> list[dict]:
    """Parse BENCH_r*.json evidence files into headline points.

    Each file's "tail" holds the bench run's last stdout lines; the
    headline is the JSON metric line ({"metric", "value", "unit",
    ...}). Files without a parsable metric line (a crashed round)
    yield no point — the series simply has a hole, the same policy as
    every other ledger reader. Points come back in input path order,
    so sorted BENCH_r01..r05 paths give chronological order.
    """
    points: list[dict] = []
    for path in paths:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        found = None
        parsed = doc.get("parsed")
        if isinstance(parsed, dict) and "metric" in parsed \
                and "value" in parsed:
            found = parsed
        else:
            for line in doc.get("tail") or []:
                if not isinstance(line, str):
                    continue
                line = line.strip()
                if not line.startswith("{"):
                    continue
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue
                if isinstance(obj, dict) and "metric" in obj \
                        and "value" in obj:
                    found = obj
        if found is None:
            continue
        try:
            value = float(found["value"])
        except (TypeError, ValueError):
            continue
        points.append({
            "path": os.path.basename(path),
            "metric": str(found["metric"]),
            "value": value,
            "unit": found.get("unit"),
        })
    return points


def evaluate_bench_history(points: list[dict],
                           noise_band: float = DEFAULT_NOISE_BAND,
                           min_points: int = DEFAULT_MIN_BENCH_POINTS,
                           ) -> list[dict]:
    """Newest-vs-history checks per bench metric: the latest point
    against the median of all prior points. Series shorter than
    `min_points` are skipped."""
    by_metric: dict = {}
    for p in points:
        by_metric.setdefault(p["metric"], []).append(p)
    checks: list[dict] = []
    for metric in sorted(by_metric):
        series = by_metric[metric]
        if len(series) < min_points:
            continue
        prior = sorted(p["value"] for p in series[:-1])
        newest = series[-1]
        baseline = _percentile(prior, 0.50)
        checks.append(_check(
            f"bench:{metric}", baseline, newest["value"],
            len(prior), 1, noise_band,
            higher_is_better=_higher_is_better(
                metric, newest.get("unit")
            ),
        ))
    return checks


# -- combined ----------------------------------------------------------


def evaluate(rows: list[dict] | None = None,
             bench_paths: list[str] | None = None,
             noise_band: float = DEFAULT_NOISE_BAND,
             min_samples: int = DEFAULT_MIN_SAMPLES) -> dict:
    """The full regression report: ledger checks + bench checks.

    ok=True means no check regressed — including the vacuous case of
    too little history for any check at all ("insufficient data" is
    reported, never failed: a fresh deployment has no trajectory to
    regress against).
    """
    checks: list[dict] = []
    if rows:
        checks.extend(evaluate_ledger_rows(
            rows, noise_band=noise_band, min_samples=min_samples
        ))
    bench_points: list[dict] = []
    if bench_paths:
        bench_points = load_bench_history(bench_paths)
        checks.extend(evaluate_bench_history(
            bench_points, noise_band=noise_band
        ))
    return {
        "ok": all(c["ok"] for c in checks),
        "checks": checks,
        "regressed": [c for c in checks if not c["ok"]],
        "noise_band": noise_band,
        "ledger_rows": len(rows or ()),
        "bench_points": len(bench_points),
    }


def format_report(report: dict) -> list[str]:
    """The report as printable lines (the CI gate / serve stderr)."""
    lines = [
        "regression: %s (%d check(s), band ±%.0f%%, %d ledger row(s),"
        " %d bench point(s))" % (
            "ok" if report["ok"] else "REGRESSED",
            len(report["checks"]), report["noise_band"] * 100.0,
            report["ledger_rows"], report["bench_points"],
        )
    ]
    for c in report["checks"]:
        direction = "min" if c["higher_is_better"] else "max"
        lines.append(
            "  %-36s %s baseline=%g recent=%g (%s allowed %g, "
            "n=%d/%d)" % (
                c["check"], "ok" if c["ok"] else "REGRESSED",
                c["baseline"], c["recent"], direction, c["limit"],
                c["n_baseline"], c["n_recent"],
            )
        )
    if not report["checks"]:
        lines.append("  (insufficient history for any check)")
    return lines
