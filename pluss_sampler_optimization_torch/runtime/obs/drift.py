"""Accuracy-drift monitor: sampled-vs-exact MRC audits.

The port's copy of the JAX package's runtime/obs/drift.py; only
`drift_audit` differs, by its `device` (the engines' own resolution:
CUDA unless the CPU is asked for).

PLUSS's value is a *model* — sampled MRCs standing in for exact
locality analysis — and the service executor even degrades
exact→sampled silently under deadline pressure. Nothing watched the
model-quality side until now: this module runs small-config audits
pitting the sampled engine against the exact router (the same
engines the service dispatches), computes MRC error metrics over the
curve, appends them to the run ledger, and flags threshold breaches
as telemetry events. tools/check_drift.py is the CI gate (nonzero
exit on breach), exercised from tier-1.

Metrics: `max_abs_delta` (worst-case miss-ratio error at any cache
size) and `mean_abs_delta` (average over the common support). The
default thresholds are calibrated against the measured seed-0 CPU
values at the default audit configs (gemm/mvt n=48, ratio 0.3:
max_abs ≈ 0.135 / 0.050) with ~2.5x headroom, so the gate trips on a
real sampler regression, not on the known sampling noise floor.

Progressive-precision audits carry their OWN noise floor: a bootstrap
confidence band (sampler/confidence.py) around the sampled curve.
When an audit (or a replayed ledger row) carries `band_width`, the
breach verdict is `max_abs_delta > band_width` — the sampled curve
left its statistical uncertainty — instead of the global calibrated
thresholds. Band-less rows (every pre-progressive row) keep the
global path, so an old ledger re-evaluates byte-for-byte.
"""

from __future__ import annotations

import math
import time

from .. import telemetry
from . import ledger as obs_ledger

# Gate thresholds for one audit; see module docstring for calibration.
DRIFT_THRESHOLDS = {
    "max_abs_delta": 0.35,
    "mean_abs_delta": 0.05,
}

# Default audit matrix for tools/check_drift.py: gemm (the reference's
# anchor model) plus mvt (a non-gemm family with a different curve
# shape) — small enough that the pair audits in seconds on CPU.
DEFAULT_AUDIT_MODELS = ("gemm", "mvt")
DEFAULT_AUDIT_N = 48
DEFAULT_AUDIT_RATIO = 0.3


def mrc_drift_metrics(mrc_exact, mrc_sampled) -> dict:
    """Max/mean absolute miss-ratio delta over the common support.

    The curves may differ in length (the sampled histogram's support
    can be smaller); the comparison runs over the common prefix — the
    same convention as runtime/aet.py::mrc_l1_error — and both lengths
    are recorded so a support collapse is itself visible.
    """
    import numpy as np

    a = np.asarray(mrc_exact, dtype=np.float64)
    b = np.asarray(mrc_sampled, dtype=np.float64)
    m = min(len(a), len(b))
    if m == 0:
        return {
            "max_abs_delta": 1.0, "mean_abs_delta": 1.0,
            "support": 0, "len_exact": len(a), "len_sampled": len(b),
        }
    d = np.abs(a[:m] - b[:m])
    return {
        "max_abs_delta": round(float(d.max()), 6),
        "mean_abs_delta": round(float(d.mean()), 6),
        "support": m,
        "len_exact": int(len(a)),
        "len_sampled": int(len(b)),
    }


def breach_verdict(metrics: dict, thresholds: dict | None = None,
                   band_width=None) -> bool:
    """Whether one audit's error metrics constitute a breach.

    With a finite non-negative `band_width` (a progressive-precision
    run's bootstrap confidence band), the verdict is per-row:
    max_abs_delta beyond the band means the error exceeds what the
    band attributes to sampling noise. Otherwise — band-less rows,
    one-shot audits, and every row written before bands existed — the
    global DRIFT_THRESHOLDS apply unchanged (the migration contract
    tests/test_precision.py pins)."""
    if (isinstance(band_width, (int, float))
            and not isinstance(band_width, bool)
            and math.isfinite(float(band_width))
            and float(band_width) >= 0.0):
        return float(metrics["max_abs_delta"]) > float(band_width)
    thresholds = thresholds or DRIFT_THRESHOLDS
    return any(
        metrics[key] > limit for key, limit in thresholds.items()
    )


def row_breach(row: dict, thresholds: dict | None = None) -> bool:
    """Re-evaluate a ledger drift row's breach verdict: band-aware
    when the row carries `band_width`, global-threshold otherwise."""
    return breach_verdict(row, thresholds=thresholds,
                          band_width=row.get("band_width"))


def drift_audit(
    model: str,
    n: int = DEFAULT_AUDIT_N,
    ratio: float = DEFAULT_AUDIT_RATIO,
    seed: int = 0,
    machine=None,
    thresholds: dict | None = None,
    ledger_path: str | None = None,
    source: str = "drift",
    band_width: float | None = None,
    device=None,
) -> dict:
    """One sampled-vs-exact audit -> the ledger "drift" row (appended
    to `ledger_path` when given, returned either way).

    Reuses the production engines end to end: the exact side goes
    through the exact router (sampler/periodic.py::run_exact — the
    periodic/analytic/dense auto-route), the sampled side through
    run_sampled with a deterministic seed, and both fold through the
    same CRI + AET pipeline the service serves. A threshold breach is
    recorded in the row (`breach`, `ok`), counted
    (`drift_breach` telemetry counter) and emitted as a `drift_breach`
    telemetry event; tools/check_drift.py turns it into a nonzero
    exit. Both sides run on `device`, resolved as run_sampled resolves
    it (CUDA unless device="cpu"; no card and no CPU asked for raises).
    """
    from ...config import MachineConfig, SamplerConfig
    from ...models import build as build_model
    from ...sampler.sampled import resolve_device
    from ..aet import aet_mrc
    from ..cri import cri_distribute

    device = resolve_device(device)
    machine = machine if machine is not None else MachineConfig()
    thresholds = dict(thresholds or DRIFT_THRESHOLDS)
    program = build_model(model, n)
    T = machine.thread_num

    t0 = time.perf_counter()
    with telemetry.span("drift_audit", model=model, n=n):
        from ...sampler.periodic import run_exact
        from ...sampler.sampled import run_sampled

        with telemetry.span("drift_exact"):
            exact = run_exact(program, machine, device=device)
            mrc_exact = aet_mrc(
                cri_distribute(exact.state, T, T), machine
            )
        with telemetry.span("drift_sampled"):
            state, results = run_sampled(
                program, machine,
                SamplerConfig(ratio=ratio, seed=seed), device=device,
            )
            mrc_sampled = aet_mrc(cri_distribute(state, T, T), machine)
    metrics = mrc_drift_metrics(mrc_exact, mrc_sampled)
    breach = breach_verdict(metrics, thresholds,
                            band_width=band_width)
    row = {
        "kind": "drift",
        "source": source,
        "ok": not breach,
        "breach": breach,
        "model": model,
        "n": n,
        "ratio": ratio,
        "seed": seed,
        "engine_exact": getattr(exact, "engine", "exact"),
        "samples": int(sum(r.n_samples for r in results)),
        "latency_s": round(time.perf_counter() - t0, 6),
        "thresholds": thresholds,
        "mrc_digest_exact": obs_ledger.mrc_digest(mrc_exact),
        "mrc_digest_sampled": obs_ledger.mrc_digest(mrc_sampled),
        **metrics,
    }
    if band_width is not None:
        row["band_width"] = round(float(band_width), 6)
    # static per-model priors (analysis/bounds.py): the facts the
    # audit row lets an offline reader sanity-check BOTH curves
    # against (compulsory-miss floor, exact cold footprint) — and the
    # exact curve is cross-checked right here, so a drift audit also
    # gates the analyzer's own bounds
    try:
        from ... import analysis

        report = analysis.analyze_program(program, machine)
        row["static_priors"] = analysis.drift_priors(report)
        row["static_bounds_violations"] = analysis.check_static_bounds(
            report, mrc_exact, machine
        )
    except Exception as e:  # priors are advisory, never sink an audit
        row["static_priors"] = {"error": repr(e)}
    if breach:
        telemetry.count("drift_breach")
        telemetry.event(
            "drift_breach", model=model, n=n,
            max_abs_delta=metrics["max_abs_delta"],
            mean_abs_delta=metrics["mean_abs_delta"],
        )
    if ledger_path:
        row = obs_ledger.append(ledger_path, row)
    return row
