"""Seeded chaos gate for the hardened serving stack.

The port's twin of the JAX package's tools/check_chaos.py: its
deterministic phases, with its command line and lines, on the port's
service (every service on --device, default cuda). Each phase's
outcome is decided by fault keys (runtime/faults.py draws per (site,
key, occurrence)) and replayed by key, never by timing: the requests
of a run go one at a time and a quarantined replica stays out for the
run, where the JAX gate submits them together and lets a replica back
after 0.2 s, and the JAX gate's timing-decided phases (attempt
timeouts, hedging, the overload shed-on/off tails) and its fabric phase
(the port's fabric waits for its own slice) are not run.

Fault injection without a gate is a demo, not a test. This checker
arms runtime/faults.py with known seeds and asserts the properties
the resilience layer exists to provide:

  resolve-once   every submitted request resolves exactly once —
                 ok, failed, or shed — never lost, never doubled
  bit-identity   every success under chaos (retried, hedged, served
                 after cache corruption) carries the SAME MRC digest
                 as the fault-free baseline run of the same request
  replay         a chaos run is a pure function of (seed, spec):
                 running it twice yields the same fault counts, the
                 same per-request ok map, the same digests
  quarantine     corrupted disk records are renamed *.corrupt,
                 counted, and transparently recomputed
  precision      a seeded round_exec hang mid-schedule makes a
                 progressive-precision request's deadline expire
                 between rounds: the service answers with exactly one
                 partial_final (precision:* degrade hop, confidence
                 band from the last completed round), and the whole
                 outcome replays exactly from (seed, spec)

Phases run per seed (--seeds N => seeds 0..N-1); any violated
property is reported and fails the gate. Wired into tier-1 by
tests/test_torch_service.py.

    python -m pluss_sampler_optimization_torch.tools.check_chaos
        [--seeds 3] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import glob
import io
import json
import os
import shutil
import sys
import tempfile
import time

from pluss_sampler_optimization_torch.config import (
    FaultConfig,
    ResilienceConfig,
)
from pluss_sampler_optimization_torch.runtime import faults, lockwitness
from pluss_sampler_optimization_torch.tools import loadgen

TIMEOUT_S = 120.0
# the services' device (main's --device): the replica phases put two
# replicas on it
DEVICE = ["cuda"]


def _requests(n: int, seed: int, unique_frac: float = 1.0) -> list:
    """Deterministic request set with caller-supplied trace ids, so
    replica_dispatch fault decisions (keyed on trace_id) replay."""
    reqs = loadgen.make_requests(n, seed, unique_frac=unique_frac)
    import dataclasses

    return [
        dataclasses.replace(r, trace_id=f"{r.id}-t") for r in reqs
    ]


def _service(cache_dir, resilience, seed, replicas=None,
             service_time_s: float = 0.005):
    from pluss_sampler_optimization_torch.service import AnalysisService

    return AnalysisService(
        cache_dir=cache_dir, max_workers=4, replicas=replicas,
        runner=loadgen.synthetic_runner(service_time_s, seed=seed),
        resilience=resilience, device=DEVICE[0],
    )


def _run_all(svc, reqs) -> list:
    """Each request answered before the next is submitted: an injected
    engine failure is absorbed by a replica re-route while the other
    replica is closed and by an executor retry once it is not, so with
    requests in flight together which layer absorbs it (and the
    `retried` count a replay compares) would be a race between them."""
    return [svc.result(svc.submit(r), timeout=TIMEOUT_S) for r in reqs]


def _digests(resps) -> dict:
    return {r.id: r.mrc_digest for r in resps}


def _chaos_resilience(seed: int) -> ResilienceConfig:
    # max_retries covers the summed max_fires of the failing
    # engine_execute rules below (2 raise + 1 compile_failure), so a
    # request can exhaust every injected failure and still succeed.
    # Timing-coupled features stay OUT of this config — no
    # attempt_timeout_s, no hedge_after_s — because this phase also
    # checks exact REPLAY, and a wall-clock race (did the hedge fire
    # before the attempt finished?) would change occurrence counts
    # between runs; hangs/timeouts and hedging get their own phases.
    # breaker_failures sits above any consecutive-failure run the mix
    # can produce (the dedicated breaker phase tests breakers). A
    # quarantined replica stays out for the run (the probation is the
    # replica pool's too): its return after a probation would depend on
    # how long the run took to get there.
    return ResilienceConfig(
        max_retries=4,
        backoff_base_s=0.01, backoff_max_s=0.05, backoff_seed=seed,
        breaker_failures=50, breaker_probation_s=300.0,
    )


def _chaos_spec(seed: int) -> FaultConfig:
    return FaultConfig(seed=seed, rules=(
        {"site": "engine_execute", "kind": "raise", "p": 0.35,
         "max_fires": 2},
        {"site": "engine_execute", "kind": "compile_failure",
         "p": 0.15, "max_fires": 1},
        {"site": "replica_dispatch", "kind": "raise", "p": 0.2,
         "max_fires": 1},
        {"site": "replica_dispatch", "kind": "latency", "p": 0.25,
         "latency_s": 0.03, "max_fires": 2},
        {"site": "cache_store", "kind": "raise", "p": 0.4,
         "max_fires": 1},
    ))


def _chaos_run(seed: int, reqs, cache_dir: str) -> dict:
    """One armed run; returns the replay-comparable summary."""
    injector = faults.install(_chaos_spec(seed))
    try:
        with _service(cache_dir, _chaos_resilience(seed), seed,
                      replicas=2) as svc:
            resps = _run_all(svc, reqs)
            st = svc.executor.stats()
        stats = injector.stats()
    finally:
        faults.uninstall()
    return {
        "ok_by_id": {r.id: r.ok for r in resps},
        "digests": _digests(resps),
        "fired_by_kind": stats["fired_by_kind"],
        "resolved": len(resps),
        "retried": st.get("retried", 0),
        "shed": st.get("shed", 0),
        "errors": {r.id: r.error for r in resps if not r.ok},
    }


def check_chaos_vs_baseline(seed: int, tmp: str,
                            problems: list) -> None:
    """Baseline digests -> chaos run (resolve-once, bit-identity) ->
    replay (determinism) -> corrupt-on-load quarantine."""
    reqs = _requests(8, seed, unique_frac=0.75)

    with _service(os.path.join(tmp, "base"), _chaos_resilience(seed),
                  seed, replicas=2) as svc:
        base = _run_all(svc, reqs)
    if not all(r.ok for r in base):
        problems.append(f"seed {seed}: fault-free baseline failed: "
                        f"{[r.error for r in base if not r.ok]}")
        return
    baseline = _digests(base)

    runs = [
        _chaos_run(seed, reqs, os.path.join(tmp, f"chaos{i}"))
        for i in (0, 1)
    ]
    run = runs[0]
    if run["resolved"] != len(reqs):
        problems.append(
            f"seed {seed}: {run['resolved']} of {len(reqs)} chaos "
            "requests resolved (resolve-once violated)"
        )
    if sum(run["fired_by_kind"].values()) == 0:
        problems.append(f"seed {seed}: chaos run injected nothing — "
                        "the gate tested no faults")
    bad = [i for i, ok in run["ok_by_id"].items() if not ok]
    if bad:
        problems.append(
            f"seed {seed}: chaos requests failed despite a retry "
            f"budget covering every injected fault: "
            f"{ {i: run['errors'][i] for i in bad} }"
        )
    mismatch = {
        i: (d, baseline.get(i))
        for i, d in run["digests"].items()
        if run["ok_by_id"][i] and d != baseline.get(i)
    }
    if mismatch:
        problems.append(f"seed {seed}: chaos successes are NOT "
                        f"bit-identical to baseline: {mismatch}")
    failing = sum(
        run["fired_by_kind"].get(k, 0)
        for k in ("raise", "compile_failure", "hang")
    )
    if failing and run["retried"] == 0:
        problems.append(f"seed {seed}: {failing} failing fault(s) "
                        "fired but nothing was retried")
    if runs[0] != runs[1]:
        diff = {k: (runs[0][k], runs[1][k]) for k in runs[0]
                if runs[0][k] != runs[1][k]}
        problems.append(f"seed {seed}: chaos run did not replay "
                        f"from (seed, spec): {diff}")

    # corruption quarantine: re-read the chaos run's disk store with
    # every first load mangled; records must be quarantined, counted,
    # and recomputed to the baseline digests
    store = os.path.join(tmp, "chaos0")
    n_disk = len(glob.glob(os.path.join(store, "*", "*.json")))
    faults.install(FaultConfig(seed=seed, rules=(
        {"site": "cache_load", "kind": "corrupt", "p": 1.0,
         "max_fires": 1},
    )))
    try:
        with _service(store, _chaos_resilience(seed), seed) as svc:
            resps = _run_all(svc, reqs)
            cache_stats = svc.cache.stats()
    finally:
        faults.uninstall()
    if not all(r.ok for r in resps):
        problems.append(f"seed {seed}: requests failed after cache "
                        "corruption (should recompute)")
    if _digests(resps) != baseline:
        problems.append(f"seed {seed}: post-corruption recomputes "
                        "are not bit-identical to baseline")
    quarantined = cache_stats.get("corrupt_quarantined", 0)
    n_corrupt = len(glob.glob(os.path.join(store, "*", "*.corrupt")))
    if n_disk and quarantined < 1:
        problems.append(f"seed {seed}: {n_disk} disk records but "
                        "none quarantined under corrupt faults")
    if quarantined != n_corrupt:
        problems.append(
            f"seed {seed}: quarantine count {quarantined} != "
            f"{n_corrupt} *.corrupt files on disk"
        )


def check_breaker_recovery(seed: int, problems: list) -> None:
    """Failures open the engine breaker, open fails fast, and after
    faults stop the half-open probe re-closes it; the first request
    served after recovery is bit-identical to its fault-free run."""
    from pluss_sampler_optimization_torch.service import AnalysisRequest

    reqs = [
        AnalysisRequest(model=loadgen.MODEL, n=loadgen.MODEL_N,
                        engine="sampled", ratio=0.2, seed=9000 + k,
                        id=f"br-{k}", trace_id=f"br-{k}-t")
        for k in range(5)
    ]
    with _service(None, None, seed) as svc:
        want = svc.analyze(reqs[0], timeout=TIMEOUT_S).mrc_digest

    # a probation of a fifth of the wait below: the re-close is decided
    # by the probe, not by how fast the first three requests ran
    res = ResilienceConfig(breaker_failures=2,
                           breaker_probation_s=0.05)
    faults.install(FaultConfig(seed=seed, rules=(
        {"site": "engine_execute", "kind": "raise", "p": 1.0},
    )))
    try:
        with _service(None, res, seed) as svc:
            r1 = svc.analyze(reqs[1], timeout=TIMEOUT_S)
            r2 = svc.analyze(reqs[2], timeout=TIMEOUT_S)
            r3 = svc.analyze(reqs[3], timeout=TIMEOUT_S)
            if r1.ok or r2.ok:
                problems.append(f"seed {seed}: p=1.0 raise faults "
                                "did not fail requests")
            if r3.ok or "circuit breaker open" not in (r3.error or ""):
                problems.append(
                    f"seed {seed}: third request was not failed fast "
                    f"by the open breaker (error: {r3.error!r})"
                )
            faults.uninstall()
            time.sleep(0.25)  # let probation elapse
            r4 = svc.analyze(reqs[4], timeout=TIMEOUT_S)
            r5 = svc.analyze(reqs[0], timeout=TIMEOUT_S)
            st = svc.executor.stats()
    finally:
        faults.uninstall()
    if not (r4.ok and r5.ok):
        problems.append(f"seed {seed}: service did not recover after "
                        f"probation ({r4.error!r}, {r5.error!r})")
    elif r5.mrc_digest != want:
        problems.append(f"seed {seed}: post-recovery result is not "
                        "bit-identical to the fault-free run")
    br = (st.get("breakers") or {}).get("sampled") or {}
    if st.get("breaker_opened", 0) < 1 \
            or st.get("breaker_open_skips", 0) < 1 \
            or st.get("breaker_reclosed", 0) < 1 \
            or br.get("state") != "closed":
        problems.append(
            f"seed {seed}: breaker lifecycle counters wrong: "
            f"opened={st.get('breaker_opened')} "
            f"skips={st.get('breaker_open_skips')} "
            f"reclosed={st.get('breaker_reclosed')} state={br}"
        )


def check_serve_line_faults(seed: int, problems: list) -> None:
    """serve_jsonl under per-line faults: every input line still gets
    exactly one response entry; faulted lines carry the injected
    error, the rest succeed."""
    from pluss_sampler_optimization_torch.service import serve_jsonl

    lines = [
        json.dumps({"model": loadgen.MODEL, "n": loadgen.MODEL_N,
                    "engine": "sampled", "ratio": 0.2,
                    "seed": 1000 + k, "id": f"sv-{k}"})
        for k in range(4)
    ]
    injector = faults.install(FaultConfig(seed=seed, rules=(
        {"site": "serve_line", "kind": "raise", "p": 0.5},
    )))
    try:
        with _service(None, None, seed) as svc:
            fout = io.StringIO()
            failures = serve_jsonl(
                svc, io.StringIO("\n".join(lines) + "\n"), fout
            )
        fired = injector.stats()["fired_by_kind"].get("raise", 0)
    finally:
        faults.uninstall()
    entries = [json.loads(ln) for ln in
               fout.getvalue().splitlines() if ln.strip()]
    faulted = [e for e in entries
               if "fault injected" in (e.get("error") or "")]
    if len(entries) != len(lines):
        problems.append(f"seed {seed}: {len(lines)} serve lines -> "
                        f"{len(entries)} responses")
    if len(faulted) != fired or failures != fired:
        problems.append(
            f"seed {seed}: serve_line fired {fired} but "
            f"{len(faulted)} faulted entries / {failures} failures"
        )
    if any(not e.get("ok") for e in entries
           if e not in faulted):
        problems.append(f"seed {seed}: non-faulted serve lines "
                        "failed")


def check_progressive_deadline(seed: int, problems: list) -> None:
    """A seeded round_exec hang on round 1 (with a deadline sized to
    cover round 0 but not the hang) forces the progressive engine to
    stop at a round boundary: the request must resolve to exactly one
    partial_final carrying a precision:* degrade hop and the last
    streamed round's band, and a second armed run must reproduce the
    identical (rounds, band, digest) tuple — the round count is a
    pure function of (fault spec, deadline), never machine speed.

    Uses a REAL AnalysisService (not the synthetic runner): the
    progressive round loop IS the engine under test."""
    from pluss_sampler_optimization_torch.service import (
        AnalysisService,
        serve_jsonl,
    )

    line = json.dumps({
        "id": "prog-dl", "model": loadgen.MODEL, "n": 32,
        "engine": "sampled", "ratio": 0.3, "seed": 7000 + seed,
        "tolerance": 0.0, "max_rounds": 3, "deadline_s": 1.0,
    })

    def run():
        faults.install(FaultConfig(seed=seed, rules=(
            {"site": "round_exec", "kind": "hang", "hang_s": 3.0,
             "match": {"round": 1}, "p": 1.0, "max_fires": 1},
        )))
        try:
            with AnalysisService(cache_dir=None, device=DEVICE[0]) as svc:
                fout = io.StringIO()
                serve_jsonl(svc, io.StringIO(line + "\n"), fout)
        finally:
            faults.uninstall()
        docs = [json.loads(ln)
                for ln in fout.getvalue().splitlines()]
        return ([d for d in docs if d.get("partial")],
                [d for d in docs if not d.get("partial")])

    partials, finals = run()
    if len(finals) != 1 or not finals[0].get("partial_final"):
        problems.append(
            f"seed {seed}: progressive deadline did not yield exactly "
            f"one partial_final ({len(finals)} finals, "
            f"{finals[0] if finals else None})"
        )
        return
    final = finals[0]
    if not any(str(h.get("reason", "")).startswith("precision:")
               for h in (final.get("degraded") or [])):
        problems.append(
            f"seed {seed}: partial_final lacks a precision:* degrade "
            f"hop: {final.get('degraded')}"
        )
    if not partials or final.get("band_width") > \
            partials[-1]["band_width"]:
        problems.append(
            f"seed {seed}: partial_final band "
            f"{final.get('band_width')} exceeds the last streamed "
            f"partial ({partials[-1]['band_width'] if partials else None})"
        )
    partials2, finals2 = run()
    want = (final.get("rounds"), final.get("band_width"),
            final.get("mrc_digest"), len(partials))
    final2 = finals2[0] if finals2 else {}
    got = (final2.get("rounds"), final2.get("band_width"),
           final2.get("mrc_digest"), len(partials2))
    if want != got:
        problems.append(
            f"seed {seed}: progressive deadline replay diverged: "
            f"{want} != {got}"
        )


def check_witness_identity(seed: int, problems: list) -> None:
    """The lock witness must be a pure observer: the same request set
    served witness-off and witness-on yields bit-identical MRC
    digests. Runs only when the gate armed the witness (the off-run
    services are built inside a disable/enable window, so their locks
    come out plain)."""
    reqs = _requests(4, seed + 17)
    lockwitness.disable()
    try:
        with _service(None, None, seed) as svc:
            off = _digests(_run_all(svc, reqs))
    finally:
        lockwitness.enable()
    with _service(None, None, seed) as svc:
        on = _digests(_run_all(svc, reqs))
    if on != off:
        diff = {k: (on[k], off.get(k)) for k in on
                if on[k] != off.get(k)}
        problems.append(
            f"seed {seed}: MRC digests differ witness-on vs "
            f"witness-off: {diff}"
        )


def check_witness_report(problems: list) -> None:
    """After every seed ran under the armed witness: no lock-order
    inversion was observed at runtime, and every observed (held ->
    acquired) pair is in the static analyzer's lock-order graph — the
    static graph is a sound superset of reality."""
    from pluss_sampler_optimization_torch.analysis import concurrency

    doc = lockwitness.report()
    if doc["inversion_count"]:
        problems.append(
            f"lock witness observed {doc['inversion_count']} "
            f"lock-order inversion(s): {doc['inversions']}"
        )
    static = set(concurrency.analyze_files().edge_pairs())
    unmodeled = lockwitness.observed_edges() - static
    if unmodeled:
        problems.append(
            "runtime lock orders missing from the static graph "
            f"(analyzer unsound): {sorted(unmodeled)}"
        )
    print(f"check_chaos: witness: {len(doc['edges'])} observed "
          f"edge(s), {doc['inversion_count']} inversion(s), "
          f"{len(static)} static edge(s)")


def run_seed(seed: int, witness: bool = False) -> list[str]:
    problems: list[str] = []
    tmp = tempfile.mkdtemp(prefix=f"check_chaos_s{seed}_")
    try:
        t0 = time.perf_counter()
        check_chaos_vs_baseline(seed, tmp, problems)
        check_breaker_recovery(seed, problems)
        check_serve_line_faults(seed, problems)
        check_progressive_deadline(seed, problems)
        if witness:
            check_witness_identity(seed, problems)
        print(f"check_chaos: seed {seed}: "
              f"{'OK' if not problems else 'FAIL'} "
              f"({time.perf_counter() - t0:.1f}s)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="seeded chaos gate: fault injection, retries, "
        "breakers, quarantine, and partial results"
    )
    ap.add_argument("--seeds", type=int, default=3,
                    help="run seeds 0..N-1 (default 3)")
    ap.add_argument("--no-witness", action="store_true",
                    help="run without the lockdep witness (skips the "
                    "inversion/superset and on-vs-off identity checks)")
    ap.add_argument("--device", default="cuda",
                    help="the services' device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    DEVICE[0] = args.device
    if faults.get() is not None:
        # a leftover injector would corrupt every phase's baseline
        faults.uninstall()
    witness = not args.no_witness
    was_enabled = lockwitness.enabled()
    if witness:
        lockwitness.reset()
        lockwitness.enable()
    problems: list[str] = []
    try:
        for seed in range(args.seeds):
            problems += run_seed(seed, witness=witness)
        if witness:
            check_witness_report(problems)
    finally:
        # leave the process as found: in-process callers (the tests)
        # must not inherit an armed witness
        if witness and not was_enabled:
            lockwitness.disable()
            lockwitness.reset()
    for p in problems:
        print(f"check_chaos: FAIL: {p}", file=sys.stderr)
    print(f"check_chaos: {args.seeds} seed(s), "
          f"{len(problems)} problem(s)")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
