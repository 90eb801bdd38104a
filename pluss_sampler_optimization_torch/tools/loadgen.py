"""Open-loop load generator for the analysis service.

The port's twin of the JAX package's tools/loadgen.py: the same
command line and output, on the port's modules. `--device` (default
cuda) is the service's device; `--connect` (a TCP client of the serving
fabric's listeners) waits for the port's fabric and is refused.

Closed-loop clients (submit, wait, repeat) can never demonstrate
overload: arrival slows to match completion, so the queue never
grows and shedding never fires. This tool is OPEN-loop — request i
is submitted at a pre-computed arrival offset whether or not earlier
requests have finished — which is what makes admission control
observable: offered load can exceed capacity, the executor queue
grows, and the service must either shed or let latency collapse.

Everything is deterministic. Arrival gaps are inverse-CDF
exponential draws (Poisson process) from the chaos layer's counter
hash (runtime/faults.py::counter_u01), the priority mix and the
hot/unique fingerprint split are drawn the same way, and the
synthetic runner's service time is fixed (plus optional seeded
jitter) — so a load run replays exactly from its seed, and
shed-on vs shed-off runs of the SAME arrival sequence compare.

The synthetic runner executes ONE real engine run per program (the
record pipeline stays the production one, so MRC digests are real
and bit-comparable), memoizes the engine output, and answers every
later request with a deterministic sleep + the memoized result:
service time becomes a knob instead of a measurement artifact.

    python -m pluss_sampler_optimization_torch.tools.loadgen --requests 100 --rate 300 \
        --queue-limit 6 --service-time-s 0.03 [--no-shed] \
        [--mix low:0.2,normal:0.6,high:0.2] [--burst 0.1:0.2:3] \
        [--tolerance-mix 0.05:0.5,none:0.5] \
        [--deadline-mix 0.5:0.3,none:0.7] \
        [--fault-spec FILE] [--ledger PATH] [--json PATH]

--tolerance-mix / --deadline-mix draw per-request progressive-
precision knobs (tolerance / deadline_s; "none" = absent) from the
same counter-hash stream, so a precision-mixed load run replays
exactly. The report then carries a `precision` section — progressive
requests split into converged vs partial_final vs shed, plus the
partial-frame count per request.

Reused as a library by the check_chaos twin (its synthetic runner and
request sets).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import threading
import time

from pluss_sampler_optimization_torch.runtime import faults
from pluss_sampler_optimization_torch.runtime.obs import (
    ledger as obs_ledger,
)

# every generated request addresses this tiny program; distinct
# fingerprints come from the sampled engine's seed parameter
MODEL = "gemm"
MODEL_N = 16


def arrival_offsets(n: int, rate_rps: float, seed: int,
                    burst: tuple | None = None) -> list[float]:
    """Absolute submit offsets (seconds from t0) for n requests.

    A Poisson process at `rate_rps`: gap i is an inverse-CDF
    exponential draw from counter_u01(seed, "arrival", i), so the
    schedule is a pure function of (seed, n, rate). `burst` =
    (start_s, duration_s, multiplier) scales the instantaneous rate
    inside the window — a deterministic flash crowd.
    """
    if rate_rps <= 0:
        raise ValueError("rate_rps must be > 0")
    out: list[float] = []
    t = 0.0
    for i in range(n):
        rate = rate_rps
        if burst is not None:
            b0, bd, bm = burst
            if b0 <= t < b0 + bd:
                rate = rate_rps * bm
        u = faults.counter_u01(seed, "arrival", i)
        # u in [0, 1): -log1p(-u) is exp(1) without a log(0) edge
        t += -math.log1p(-u) / rate
        out.append(t)
    return out


def parse_mix(spec: str) -> tuple:
    """"low:0.2,normal:0.6,high:0.2" -> (("low", .2), ...)."""
    from pluss_sampler_optimization_torch.service import PRIORITY_CLASSES

    out = []
    for part in spec.split(","):
        name, _, w = part.partition(":")
        name = name.strip()
        if name not in PRIORITY_CLASSES:
            raise ValueError(
                f"unknown priority {name!r} "
                f"(have {', '.join(PRIORITY_CLASSES)})"
            )
        out.append((name, float(w) if w else 1.0))
    if not out or sum(w for _, w in out) <= 0:
        raise ValueError(f"empty/zero-weight mix {spec!r}")
    return tuple(out)


def parse_value_mix(spec: str) -> tuple:
    """"0.05:0.5,none:0.5" -> ((0.05, 0.5), (None, 0.5)): a weighted
    mix of numeric knob values, "none" meaning the knob is absent."""
    out = []
    for part in spec.split(","):
        val, _, w = part.partition(":")
        val = val.strip().lower()
        v = None if val in ("none", "off", "-") else float(val)
        out.append((v, float(w) if w else 1.0))
    if not out or sum(w for _, w in out) <= 0:
        raise ValueError(f"empty/zero-weight value mix {spec!r}")
    return tuple(out)


def _draw_mix(mix: tuple, seed: int, tag: str, i: int):
    """One weighted draw from a ((value, weight), ...) mix, keyed
    (seed, tag, i) on the counter-hash stream — replays exactly."""
    total = sum(w for _, w in mix)
    u = faults.counter_u01(seed, tag, i) * total
    acc = 0.0
    for v, w in mix:
        acc += w
        if u < acc:
            return v
    return mix[-1][0]


def make_requests(n: int, seed: int,
                  mix: tuple = (("normal", 1.0),),
                  unique_frac: float = 1.0,
                  hot_set: int = 4,
                  tolerance_mix: tuple | None = None,
                  deadline_mix: tuple | None = None) -> list:
    """n AnalysisRequests, deterministic from (seed, mix, unique_frac).

    A request is "unique" (fresh fingerprint — forced cache miss and
    a real execution) with probability unique_frac; the rest draw
    from `hot_set` shared fingerprints, exercising the cache and
    singleflight coalescing under load. Priorities follow `mix`.
    The thread count cycles so MRC digests DIFFER between requests
    (the record pipeline folds the memoized engine state per the
    request's machine config) — a cross-wired response under chaos
    shows up as a digest mismatch, not a silent coincidence.

    `tolerance_mix` / `deadline_mix` (parse_value_mix shapes) draw a
    per-request tolerance / deadline_s from the same stream — a
    drawn tolerance makes the request progressive-precision.
    """
    from pluss_sampler_optimization_torch.service import AnalysisRequest

    total = sum(w for _, w in mix)
    reqs = []
    for i in range(n):
        u = faults.counter_u01(seed, "prio", i) * total
        prio = mix[-1][0]
        acc = 0.0
        for name, w in mix:
            acc += w
            if u < acc:
                prio = name
                break
        if faults.counter_u01(seed, "unique", i) < unique_frac:
            rseed = 1000 + i
        else:
            rseed = int(
                faults.counter_u01(seed, "hot", i) * max(1, hot_set)
            )
        tol = (_draw_mix(tolerance_mix, seed, "tol", i)
               if tolerance_mix else None)
        ddl = (_draw_mix(deadline_mix, seed, "ddl", i)
               if deadline_mix else None)
        reqs.append(AnalysisRequest(
            model=MODEL, n=MODEL_N, engine="sampled", ratio=0.2,
            seed=rseed, threads=2 + (rseed % 3), priority=prio,
            id=f"lg-{i}", tolerance=tol, deadline_s=ddl,
        ))
    return reqs


def synthetic_runner(service_time_s: float = 0.0, seed: int = 0,
                     jitter_frac: float = 0.0):
    """A service runner with a knob for service time.

    The first call per program runs the REAL oracle engine and
    memoizes its output; every later call sleeps the configured
    service time (plus seeded jitter drawn from the request seed —
    deterministic per request, not per attempt) and returns the
    memoized output. Records still flow through the production
    build_record pipeline, so MRC digests are real and identical
    across runs of the same request set.
    """
    from pluss_sampler_optimization_torch.service import AnalysisRequest
    from pluss_sampler_optimization_torch.service.executor import (
        default_runner,
    )

    memo: dict = {}
    lock = threading.Lock()

    def runner(engine, program, machine, request):
        with lock:
            res = memo.get(program.name)
            if res is None:
                # memoize from a CANONICAL request, not the caller:
                # under concurrency the first arrival is a race, and
                # an arrival-dependent memo would break the chaos
                # gate's replay property
                canon = AnalysisRequest(model=MODEL, n=MODEL_N,
                                        engine="oracle")
                res = default_runner("oracle", program,
                                     canon.machine(), canon)
                memo[program.name] = res
        if service_time_s > 0:
            jit = 0.0
            if jitter_frac > 0:
                jit = jitter_frac * faults.counter_u01(
                    seed, "svc", request.seed
                )
            time.sleep(service_time_s * (1.0 + jit))
        return res

    return runner


def run_load(service, requests: list, offsets: list[float],
             timeout_s: float = 120.0) -> dict:
    """Submit `requests` open-loop at `offsets`, await every ticket,
    and fold the responses into a goodput/tail-latency report.

    Submission never waits on completion (that would close the
    loop); a submit that sheds resolves its future immediately, so
    overload costs the client microseconds, not a queue slot.
    """
    from pluss_sampler_optimization_torch.service.executor import (
        progressive_requested,
    )

    t0 = time.perf_counter()
    prog_ids = {r.id for r in requests if progressive_requested(r)}
    partial_counts: dict = {}
    plock = threading.Lock()
    tickets = []
    for req, off in zip(requests, offsets):
        now = time.perf_counter() - t0
        if off > now:
            time.sleep(off - now)

        def _on_partial(doc, _rid=req.id):
            with plock:
                partial_counts[_rid] = partial_counts.get(_rid, 0) + 1

        tickets.append(service.submit(req, on_partial=_on_partial))
    resps = [service.result(t, timeout=timeout_s) for t in tickets]
    wall = time.perf_counter() - t0

    ok = [r for r in resps if r.ok]
    shed = [r for r in resps if r.shed]
    failed = [r for r in resps if not r.ok and not r.shed]
    lats = sorted(
        r.latency_s for r in ok if r.latency_s is not None
    )
    report = {
        "submitted": len(resps),
        "ok": len(ok),
        "shed": len(shed),
        "failed": len(failed),
        "retried": sum(r.retries for r in resps),
        "hedged": sum(1 for r in resps if r.hedged),
        "wall_s": round(wall, 4),
        "offered_rps": round(len(resps) / max(1e-9, wall), 2),
        "goodput_rps": round(len(ok) / max(1e-9, wall), 2),
    }
    for name, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
        report[f"latency_{name}_s"] = (
            round(obs_ledger._percentile(lats, q), 6) if lats
            else None
        )
    report["precision"] = _precision_section(
        [dataclasses.asdict(r) for r in resps], partial_counts,
        prog_ids,
    )
    report["responses"] = resps  # stripped before JSON/ledger output
    return report


def _precision_section(docs: list, partial_counts: dict,
                       prog_ids: set) -> dict:
    """The progressive-precision rollup of one load run: how many
    requests asked for progressive sampling, of those how many
    converged vs hit a deadline partial_final vs were shed before
    running, and how many partial frames streamed per progressive
    request."""
    prog = [d for d in docs if d.get("id") in prog_ids]
    ran = [d for d in prog if d.get("rounds") is not None]
    frames = sum(partial_counts.values())
    return {
        "progressive": len(prog),
        "converged": sum(1 for d in ran if d.get("converged")),
        "partial_final": sum(
            1 for d in ran if d.get("partial_final")
        ),
        "shed": sum(1 for d in prog if d.get("shed")),
        "partial_frames": frames,
        "partials_per_request": (
            round(frames / len(ran), 2) if ran else None
        ),
    }


def _strip(report: dict) -> dict:
    return {k: v for k, v in report.items() if k != "responses"}


def overload_run(shed_enabled: bool, n: int = 100,
                 rate_rps: float = 300.0, queue_limit: int = 6,
                 max_workers: int = 2, service_time_s: float = 0.03,
                 seed: int = 0, mix: tuple = (("normal", 1.0),),
                 burst: tuple | None = None,
                 cache_dir: str | None = None,
                 ledger_path: str | None = None,
                 timeout_s: float = 120.0,
                 tolerance_mix: tuple | None = None,
                 deadline_mix: tuple | None = None,
                 device="cuda") -> dict:
    """One pinned overload experiment: offered load ~rate_rps against
    a service whose capacity is max_workers / service_time_s, with
    the admission gate on or off. Returns the run_load report plus
    the executor's resilience counters — the shed-on/shed-off pair
    of these reports is the PR's overload acceptance evidence.
    """
    from pluss_sampler_optimization_torch.config import ResilienceConfig
    from pluss_sampler_optimization_torch.service import AnalysisService

    res = ResilienceConfig(
        queue_limit=queue_limit, shed_enabled=shed_enabled
    )
    reqs = make_requests(n, seed, mix=mix,
                         tolerance_mix=tolerance_mix,
                         deadline_mix=deadline_mix)
    offs = arrival_offsets(n, rate_rps, seed, burst=burst)
    with AnalysisService(
        max_workers=max_workers, cache_dir=cache_dir,
        runner=synthetic_runner(service_time_s, seed=seed),
        ledger_path=ledger_path, resilience=res, device=device,
    ) as svc:
        report = run_load(svc, reqs, offs, timeout_s=timeout_s)
        st = svc.executor.stats()
    report["shed_enabled"] = shed_enabled
    report["queue_limit"] = queue_limit
    report["capacity_rps"] = round(
        max_workers / max(1e-9, service_time_s), 2
    )
    report["executor"] = {
        k: st.get(k, 0)
        for k in ("submitted", "completed", "failed", "shed",
                  "coalesced", "retried", "hedged", "hedge_wins",
                  "breaker_opened", "breaker_reclosed")
    }
    return report


def overload_comparison(n: int = 100, rate_rps: float = 300.0,
                        queue_limit: int = 6, max_workers: int = 2,
                        service_time_s: float = 0.03, seed: int = 0,
                        timeout_s: float = 120.0,
                        device="cuda") -> dict:
    """The headline pair: the SAME deterministic arrival sequence
    with shedding on vs off. Expected shape — shed-on holds p95 near
    (queue_limit x service_time) at reduced goodput; shed-off serves
    everything but p95 collapses toward n/capacity seconds."""
    kw = dict(n=n, rate_rps=rate_rps, queue_limit=queue_limit,
              max_workers=max_workers, service_time_s=service_time_s,
              seed=seed, timeout_s=timeout_s, device=device)
    on = _strip(overload_run(True, **kw))
    off = _strip(overload_run(False, **kw))
    p95_on = on["latency_p95_s"] or 0.0
    p95_off = off["latency_p95_s"] or 0.0
    return {
        "shed_on": on,
        "shed_off": off,
        "p95_collapse_factor": round(p95_off / max(1e-9, p95_on), 2),
    }


def write_report_row(path: str, report: dict,
                     metric: str = "loadgen_goodput_rps") -> None:
    obs_ledger.append(path, {
        "kind": "bench", "source": "tools/loadgen.py",
        "ok": report.get("failed", 0) == 0,
        "metric": metric, "value": report["goodput_rps"],
        "report": _strip(report),
    })


def _parse_burst(spec: str) -> tuple:
    parts = spec.split(":")
    if len(parts) != 3:
        raise ValueError(
            f"--burst wants start:duration:multiplier, got {spec!r}"
        )
    return (float(parts[0]), float(parts[1]), float(parts[2]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="open-loop Poisson load against the analysis "
        "service (deterministic from --seed)"
    )
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--rate", type=float, default=300.0,
                    help="offered arrival rate, requests/s")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queue-limit", type=int, default=6)
    ap.add_argument("--no-shed", action="store_true")
    ap.add_argument("--max-workers", type=int, default=2)
    ap.add_argument("--service-time-s", type=float, default=0.03,
                    help="synthetic per-request service time")
    ap.add_argument("--mix", default="normal:1",
                    help="priority mix, e.g. low:0.2,normal:0.6,"
                    "high:0.2")
    ap.add_argument("--unique-frac", type=float, default=1.0,
                    help="fraction of requests with fresh "
                    "fingerprints (rest hit a small hot set)")
    ap.add_argument("--burst", default=None,
                    help="start:duration:multiplier rate burst")
    ap.add_argument("--tolerance-mix", default=None,
                    help="progressive tolerance mix, e.g. "
                    "0.05:0.5,none:0.5 (value:weight pairs; 'none' "
                    "keeps a request one-shot)")
    ap.add_argument("--deadline-mix", default=None,
                    help="deadline_s mix, e.g. 0.5:0.3,none:0.7 — "
                    "with --tolerance-mix this exercises the "
                    "partial_final degrade path")
    ap.add_argument("--connect", default=None, metavar="HOST:PORT",
                    help="drive a live serve/serve-router TCP "
                    "listener instead of an in-process service "
                    "(service-side knobs like --queue-limit belong "
                    "to the server process then)")
    ap.add_argument("--fault-spec", default=None,
                    help="arm runtime/faults.py from this JSON spec "
                    "for the duration of the run")
    ap.add_argument("--compare-shed", action="store_true",
                    help="run the same arrivals twice (shed on/off) "
                    "and report the comparison")
    ap.add_argument("--ledger", default=None,
                    help="append a bench row with the report")
    ap.add_argument("--json", default=None,
                    help="write the full report as JSON")
    ap.add_argument("--timeout-s", type=float, default=120.0)
    ap.add_argument("--device", default="cuda",
                    help="the service's device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.connect:
        raise SystemExit(
            "--connect drives a serve-router/serve-worker listener; "
            "the port's serving fabric waits for its own slice (run "
            "the JAX package's tools/loadgen.py against one)"
        )

    mix = parse_mix(args.mix)
    tol_mix = (parse_value_mix(args.tolerance_mix)
               if args.tolerance_mix else None)
    ddl_mix = (parse_value_mix(args.deadline_mix)
               if args.deadline_mix else None)
    burst = _parse_burst(args.burst) if args.burst else None
    injector = None
    if args.fault_spec:
        injector = faults.install_from_file(args.fault_spec)
        print(f"loadgen: faults armed (seed {injector.config.seed}, "
              f"{len(injector.config.rules)} rule(s))")
    try:
        if args.compare_shed:
            report = overload_comparison(
                n=args.requests, rate_rps=args.rate,
                queue_limit=args.queue_limit,
                max_workers=args.max_workers,
                service_time_s=args.service_time_s, seed=args.seed,
                timeout_s=args.timeout_s, device=args.device,
            )
            headline = report["shed_on"]
        else:
            report = _strip(overload_run(
                not args.no_shed, n=args.requests,
                rate_rps=args.rate, queue_limit=args.queue_limit,
                max_workers=args.max_workers,
                service_time_s=args.service_time_s, seed=args.seed,
                mix=mix, burst=burst, timeout_s=args.timeout_s,
                tolerance_mix=tol_mix, deadline_mix=ddl_mix,
                device=args.device,
            ))
            headline = report
    finally:
        if injector is not None:
            faults.uninstall()
            print(f"loadgen: faults fired "
                  f"{injector.total_fired()} time(s)")
    print(json.dumps(report, indent=2, sort_keys=True))
    if args.ledger:
        write_report_row(args.ledger, headline)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
