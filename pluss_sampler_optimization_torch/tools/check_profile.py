"""Gate the sampling profiler's three standing claims.

The port's twin of the JAX package's tools/check_profile.py: the same
command line and output, on the port's modules.

The profiler (pluss_sampler_optimization_torch/runtime/obs/profiler.py)
is allowed on the serving path only because it is (a) deterministic,
(b) nearly free, and (c) actually attributes the samples it takes.
This tool is the offline auditor for all three, the
tools/check_ledger.py pattern applied to profiles:

1. determinism + schema: a fixed sample log folded in two different
   orders must produce the SAME snapshot (validated by the shared
   `validate_snapshot`) and byte-identical speedscope/collapsed
   exports — and exporting twice must produce identical bytes;
2. overhead: hot engine wall profiler-on vs profiler-off must stay
   under --overhead-budget-pct (default 3%) at the gated rate, with
   the MRC digest bit-identical across the two runs (the profiler
   must not perturb results, only observe them).  The on arm samples
   at up to 8x the gated rate and the measurement is scaled back
   down — per-sample cost is linear in hz, and the amplification
   divides an environment noise floor comparable to the budget
   itself by the same factor (see check_engine for the full
   estimator);
3. attribution: of the in-request samples taken during a span-wrapped
   engine run, at least --completeness-floor (default 80%) must carry
   a telemetry span path — an unattributed majority means the span
   registry and the sampler disagree about thread identity.

Exit 0 when every check passes, 1 otherwise; --json prints the full
verdict document. Wired into tier-1 via tests/test_torch_obs.py.

    python -m pluss_sampler_optimization_torch.tools.check_profile
        [--n 48] [--json] [--device cuda|cpu]

The engine checks run the sampled engine on --device (default cuda).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

# A fixed sample log (span path, frames root->leaf, count): folding it
# in any order must yield one canonical profile. Shapes mirror real
# collection — shared frame prefixes, an unattributed tail, a
# multi-stage request path.
FIXED_SAMPLES = [
    ("service_request/execute/draw",
     ("cli.py:main:10", "sampler/sampled.py:run_sampled:40",
      "sampler/draw.py:draw_sample_keys_device:25"), 7),
    ("service_request/execute/dispatch",
     ("cli.py:main:10", "sampler/sampled.py:run_sampled:40",
      "sampler/sampled.py:_dispatch:90"), 5),
    ("service_request/fetch",
     ("cli.py:main:10", "runtime/telemetry.py:fetch_to_host:470"), 3),
    ("service_request/queue",
     ("service/executor.py:_admit:120",), 2),
    ("", ("threading.py:_bootstrap:900",), 4),
]


def check_determinism() -> dict:
    """Fold the fixed log forward and reversed; snapshots and export
    bytes must match exactly."""
    from pluss_sampler_optimization_torch.runtime.obs import profiler

    profs = []
    for order in (FIXED_SAMPLES, list(reversed(FIXED_SAMPLES))):
        p = profiler.SamplingProfiler(hz=100.0)
        for path, frames, count in order:
            p.ingest(path, frames, count)
        p._duration_s = 1.0  # pin: snapshots must not embed wall time
        profs.append(p)
    a, b = profs
    snap_a, snap_b = a.snapshot(), b.snapshot()
    errors = profiler.validate_snapshot(snap_a)
    out: dict = {"schema_errors": errors}
    out["snapshots_equal"] = snap_a == snap_b

    def export_bytes(p):
        with tempfile.TemporaryDirectory() as d:
            ss, cl = (os.path.join(d, "p.speedscope.json"),
                      os.path.join(d, "p.collapsed"))
            p.write_speedscope(ss)
            p.write_collapsed(cl)
            with open(ss, "rb") as f1, open(cl, "rb") as f2:
                return f1.read(), f2.read()

    ab1, ab2 = export_bytes(a), export_bytes(a)  # same profiler twice
    bb = export_bytes(b)
    out["exports_byte_stable"] = ab1 == ab2
    out["exports_order_independent"] = ab1 == bb
    out["ok"] = (not errors and out["snapshots_equal"]
                 and out["exports_byte_stable"]
                 and out["exports_order_independent"])
    return out


def check_engine(n: int, model: str, hz: float, reps: int,
                 overhead_budget_pct: float,
                 completeness_floor: float, device=None) -> dict:
    """Overhead + MRC identity + attribution completeness on the hot
    sampled-engine path."""
    from pluss_sampler_optimization_torch import (
        MachineConfig,
        SamplerConfig,
    )
    from pluss_sampler_optimization_torch.models import REGISTRY
    from pluss_sampler_optimization_torch.runtime import telemetry
    from pluss_sampler_optimization_torch.runtime.aet import aet_mrc
    from pluss_sampler_optimization_torch.runtime.cri import (
        cri_distribute,
    )
    from pluss_sampler_optimization_torch.runtime.obs import (
        attribution,
        ledger,
        profiler,
    )
    from pluss_sampler_optimization_torch.sampler.sampled import (
        run_sampled,
        warmup,
    )

    machine = MachineConfig()
    prog = REGISTRY[model](n)
    cfg = SamplerConfig(ratio=0.1, seed=0)
    telemetry.enable()

    def digest(state):
        T = machine.thread_num
        return ledger.mrc_digest(
            aet_mrc(cri_distribute(state, T, T), machine)
        )

    def one_run():
        with telemetry.span("service_request", engine="sampled"):
            with telemetry.span("execute"):
                state, _results = run_sampled(prog, machine, cfg,
                                              device=device)
        return state

    warmup(prog, machine, cfg, device=device)
    one_run()  # settle caches before either timed arm

    d_off = digest(one_run())

    # Overhead estimator, built against measured host pathologies
    # (each one produced real gate flakes before its countermeasure):
    #
    # - each timing sample covers a BLOCK of runs, never one run: at
    #   ~10ms per run the 3% budget is ~0.3ms, inside single-run
    #   scheduler jitter, while a ~30-40ms block is an order of
    #   magnitude above it;
    # - off/on blocks alternate within a pair AND the pair order
    #   alternates: process state only degrades (allocator, caches),
    #   so a fixed off-first order systematically charges the drift
    #   to the on arm;
    # - the cycle collector is paused over the timed rounds (one
    #   collect up front): gen2 passes land on random blocks with
    #   multi-ms cost and were the dominant jitter source;
    # - min per arm over MANY pairs: this host's speed wanders in
    #   multi-second episodes (+-20% block wall between episodes), so
    #   both arms must sample several episodes for their minima to
    #   reach the same floor — and failing rounds retry, ACCUMULATING
    #   pairs rather than replacing them.  Noise only ever inflates a
    #   min, so a genuine overhead (present in every on block)
    #   survives every retry while a slow episode does not;
    # - the on arm samples at AMP x the gated rate and the measured
    #   overhead is scaled back down (per-sample cost is linear in
    #   hz; the dithered sampler has no phase term).  This is lock-in
    #   amplification for a sub-noise signal: the environment noise
    #   floor here is ~+-2.5% — the same order as the 3% budget —
    #   and amplification divides it by AMP on the reported number
    #   while leaving a genuine per-sample regression untouched.
    runs_per_timing = 4
    amp = max(1.0, min(8.0, 1000.0 / hz))
    off_ts: list = []
    on_ts: list = []

    def timed_block():
        t0 = time.perf_counter()
        for _ in range(runs_per_timing):
            one_run()
        return time.perf_counter() - t0

    def timed_block_on():
        profiler.enable(hz=hz * amp)
        try:
            return timed_block()
        finally:
            profiler.disable()

    def interleaved_round(k):
        import gc

        gc.collect()
        gc.disable()
        try:
            for i in range(k):
                if i % 2 == 0:
                    off_ts.append(timed_block())
                    on_ts.append(timed_block_on())
                else:
                    on_ts.append(timed_block_on())
                    off_ts.append(timed_block())
        finally:
            gc.enable()

    def overhead_now():
        return ((min(on_ts) - min(off_ts)) / min(off_ts)
                * 100.0 / amp)

    interleaved_round(reps)
    for _retry in range(2):
        if overhead_now() < overhead_budget_pct:
            break
        interleaved_round(reps)
    off_s = min(off_ts) / runs_per_timing
    on_s = min(on_ts) / runs_per_timing

    # Attribution arm: one longer profiled window (timing no longer
    # matters here), digesting the on-arm state AFTER the profiler
    # stops — the digest math is gate harness work, not request work,
    # and would otherwise collect in-request-but-unattributed samples
    # that dilute the completeness the gate is measuring.
    prof = profiler.enable(hz=hz)
    try:
        for _ in range(reps):
            state_on = one_run()
    finally:
        profiler.disable()
    d_on = digest(state_on)
    snap = prof.snapshot()
    telemetry.disable()

    overhead_pct = round(100.0 * (on_s - off_s) / off_s / amp, 2)
    completeness = snap["attribution_completeness"]
    out = {
        "engine": "sampled",
        "model": model,
        "n": n,
        "hz": hz,
        "runs_per_timing": runs_per_timing,
        "overhead_amplification": amp,
        "overhead_measured_hz": hz * amp,
        "disabled_s": round(off_s, 4),
        "enabled_s": round(on_s, 4),
        "overhead_pct": overhead_pct,
        "overhead_budget_pct": overhead_budget_pct,
        "overhead_ok": overhead_pct < overhead_budget_pct,
        "mrc_digest_off": d_off,
        "mrc_digest_on": d_on,
        "mrc_bit_identical": d_off == d_on,
        "samples": snap["samples"],
        "samples_in_request": snap["samples_in_request"],
        "attribution_completeness": completeness,
        "completeness_floor": completeness_floor,
        # a run too fast to collect in-request samples proves nothing
        # either way; completeness gates only when there is evidence
        "completeness_ok": (
            completeness is None
            or completeness >= completeness_floor
        ),
        "schema_errors": profiler.validate_snapshot(snap),
        "breakdown": attribution.sample_breakdown(snap),
    }
    out["ok"] = (out["overhead_ok"] and out["mrc_bit_identical"]
                 and out["completeness_ok"]
                 and not out["schema_errors"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=48,
                    help="problem size for the hot-path checks")
    ap.add_argument("--model", default="gemm")
    ap.add_argument("--hz", type=float, default=99.0,
                    help="sampling rate for the overhead arm")
    ap.add_argument("--reps", type=int, default=16,
                    help="off/on block pairs per timing round (min "
                    "per arm: noise on this path is strictly "
                    "additive)")
    ap.add_argument("--overhead-budget-pct", type=float, default=3.0)
    ap.add_argument("--completeness-floor", type=float, default=0.8)
    ap.add_argument("--skip-engine", action="store_true",
                    help="determinism/schema checks only (no engine "
                    "runs)")
    ap.add_argument("--json", action="store_true",
                    help="print the full verdict document")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    doc: dict = {"determinism": check_determinism()}
    if not args.skip_engine:
        doc["engine"] = check_engine(
            args.n, args.model, args.hz, max(1, args.reps),
            args.overhead_budget_pct, args.completeness_floor,
            device=args.device,
        )
    ok = all(section["ok"] for section in doc.values())
    doc["ok"] = ok

    if args.json:
        print(json.dumps(doc, indent=1, sort_keys=True))
    else:
        det = doc["determinism"]
        print(f"determinism: {'ok' if det['ok'] else 'FAIL'} "
              f"(schema_errors={len(det['schema_errors'])}, "
              f"order_independent={det['exports_order_independent']})")
        eng = doc.get("engine")
        if eng:
            print(
                f"engine: {'ok' if eng['ok'] else 'FAIL'} "
                f"(overhead {eng['overhead_pct']:+.2f}% of budget "
                f"{eng['overhead_budget_pct']:g}%, mrc_identical="
                f"{eng['mrc_bit_identical']}, completeness="
                f"{eng['attribution_completeness']})"
            )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
