"""Request execution: engines behind a degradation chain, under
singleflight coalescing, bounded concurrency, and per-request
deadlines.

This is the layer that turns "a sampler you run" into "a service you
query":

- **One pipeline per request.** `execute_request` runs the selected
  engine, folds the state through the reference pipeline
  (cri_distribute -> aet_mrc), and assembles the versioned result
  record service/cache.py stores — including the byte-exact acc dump
  lines, so a cache hit can serve the CLI's accuracy protocol without
  touching an engine.
- **Deadline-driven degradation.** Each request may carry a deadline;
  when the preferred engine fails or overruns it, the executor falls
  down the chain (exact -> sampled, periodic -> analytic -> sampled,
  ...) and records every downgrade in the response AND as a
  `service_degraded` telemetry event. An overrun attempt is abandoned
  (its thread finishes into the void — Python cannot cancel a running
  kernel launch sequence), counted as `service_deadline_abandoned`. Degraded
  results are NOT written to the persistent cache: the fingerprint
  addresses the canonical result of the REQUESTED engine, and a
  sampled stand-in must not masquerade as it on the next warm hit.
- **Singleflight.** N identical in-flight requests coalesce onto one
  execution future keyed by fingerprint; every caller shares the one
  result (counted as `service_coalesced`). Combined with the cache
  this gives the acceptance invariant: a warm repeat performs ZERO
  engine executions, and N concurrent identical submissions perform
  exactly ONE.
- **Bounded concurrency.** A ThreadPoolExecutor caps concurrent
  pipelines; `service_queue_depth` gauges the in-flight count.
- **Replica routing.** With a replica pool configured
  (service/replicas.py), every engine execution — a solo chain
  attempt or a whole flushed batch window — runs inside ONE replica's
  device scope: least-loaded routing, work stealing between idle
  replicas, and failure quarantine. A quarantine re-route lands in
  the request's degradation chain (`{"from": "replica:K", ...}`), so
  the completion is counted `service_degraded` and the SLO sentinel's
  error budget sees it; like other degraded results it is never
  persisted to the cache. max_workers is clamped UP to the replica
  count — fewer pool threads than replicas would strand replicas
  idle with work queued behind busy ones.
- **Resilience (config.py::ResilienceConfig).** Four layers, all
  off/neutral by default and all pure serving policy (never in the
  fingerprint; retried/hedged results are seed-derived and therefore
  bit-identical — tools/check_chaos.py pins it):
  * per-attempt timeouts + bounded retry with deterministic seeded
    exponential backoff (runtime/faults.py::backoff_delay — jitter
    from a counter hash, never the wall clock);
  * hedged dispatch: a routed execution still unresolved after
    `hedge_after_s` is duplicated onto a second replica; first result
    wins, the still-queued loser is cancelled
    (`service_hedged`/`service_hedge_wins`);
  * per-engine circuit breakers (service/breakers.py) with half-open
    probation: a repeatedly-failing engine is skipped cheaply down
    the degrade chain (`service_breaker_open_skips`) until a probe
    re-closes it — the replica pool runs the same state machine per
    replica;
  * admission control: with a `queue_limit`, a submit that would
    queue past its priority class's share is SHED at the gate —
    a structured `shed: true` outcome in microseconds instead of a
    deadline timeout after seconds of queueing (`service_shed`).
  Every outcome (retried/hedged/shed/broken-open) is counted on all
  three counter surfaces and stamped on the request's ledger row.
- **Chaos.** Engine attempts pass the `engine_execute` fault-
  injection site (runtime/faults.py) — a no-op unless a chaos spec is
  installed, so the default path stays zero-overhead and
  bit-identical.

- **Devices.** The engines run on the device of the enclosing
  replica scope (parallel/placement.py::device_scope): a replica's
  device, or the executor's own `device=` (CUDA when None, which raises
  without a card; "cpu" runs on the CPU). `default_runner` and
  `default_batch_runner` pass that device to the engines explicitly.

The engine table and the runner hook are module-level / constructor
injection points so tests can wrap them (e.g. add a barrier to force
overlap, or a sleep to force a deadline) without monkeypatching
engine internals.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
import uuid
from concurrent.futures import (
    FIRST_COMPLETED,
    Future,
    ThreadPoolExecutor,
    TimeoutError as FuturesTimeoutError,
    wait as futures_wait,
)

from ..config import (
    BatchConfig, MachineConfig, ReplicaConfig, ResilienceConfig,
    SamplerConfig,
)
from ..ir import Program
from ..parallel import placement
from ..runtime import faults, lockwitness, report, telemetry
from ..runtime.aet import aet_mrc
from ..runtime.cri import cri_distribute
from ..runtime.obs import ledger as obs_ledger
from .breakers import CircuitBreaker
from .cache import STORE_VERSION, ResultCache
from .replicas import ReplicaPool


def _import_engines() -> None:
    """Import every engine module the runners reach, once, before any
    pool thread does: the pool's threads would otherwise import them
    concurrently at their first requests, and a concurrent first import
    of modules with import cycles can hand a thread a partly initialized
    module (the JAX package's service shows it: KeyError or ImportError
    responses on a cold process)."""
    from ..oracle import numpy_ref, serial  # noqa: F401
    from ..sampler import analytic, dense, periodic, sampled  # noqa: F401
    from ..sampler import stream  # noqa: F401

# Fallback order per requested engine: the exact family degrades
# toward the sampled engine (cheap, approximate, always applicable).
# Engines absent here (oracle, numpy, sampled, ...) have no fallback —
# a failure is the response's error.
DEGRADE_CHAINS = {
    "exact": ("exact", "sampled"),
    "periodic": ("periodic", "analytic", "sampled"),
    "analytic": ("analytic", "sampled"),
    "dense": ("dense", "stream", "sampled"),
    "stream": ("stream", "sampled"),
}

SERVICE_ENGINES = (
    "oracle", "numpy", "dense", "stream", "periodic", "analytic",
    "exact", "sampled",
)


def degrade_chain(engine: str) -> tuple[str, ...]:
    return DEGRADE_CHAINS.get(engine, (engine,))


class _AttemptTimeout(Exception):
    """Internal: one chain attempt overran its per-attempt budget."""


# Priority classes and the fraction of the admission queue_limit each
# may fill before it sheds: low-priority work sheds first, high last,
# so a saturated queue keeps serving its most important traffic.
PRIORITY_CLASSES = ("low", "normal", "high")
_PRIORITY_HEADROOM = {"low": 0.5, "normal": 0.75, "high": 1.0}


def default_runner(engine: str, program: Program,
                   machine: MachineConfig, request):
    """Run one engine -> (result-with-.state/.total_accesses, per_ref).

    The same engine dispatch cli.py::_run_engine performs, restricted
    to the service's request schema (no r10/checkpoint/shard knobs), on
    the enclosing device scope's device (placement.active_device(); the
    engines' CUDA default where there is none)."""
    v2 = request.runtime == "v2"
    device = placement.active_device()
    if engine == "oracle":
        from ..oracle.serial import run_serial

        return run_serial(program, machine, v2=v2), None
    if engine == "numpy":
        from ..oracle.numpy_ref import run_numpy

        return run_numpy(program, machine), None
    if engine == "dense":
        from ..sampler.dense import run_dense

        return run_dense(program, machine, device=device), None
    if engine == "stream":
        from ..sampler.stream import run_stream

        return run_stream(program, machine, device=device), None
    if engine == "periodic":
        from ..sampler.periodic import run_periodic

        return run_periodic(program, machine, device=device), None
    if engine == "analytic":
        from ..sampler.analytic import run_analytic

        return run_analytic(program, machine, device=device), None
    if engine == "exact":
        from ..sampler.periodic import run_exact

        return run_exact(program, machine, device=device), None
    if engine == "sampled":
        from ..sampler.sampled import run_sampled

        state, results = run_sampled(
            program, machine, sampler_config(request), v2=v2,
            device=device,
        )
        return _sampled_namespace(state, results), results
    raise ValueError(f"unknown service engine {engine!r}")


def sampler_config(request) -> SamplerConfig:
    """The SamplerConfig one request's sampled execution uses — shared
    by the solo runner and the batch runner so a member's config (and
    hence its sample streams) cannot depend on which path served it."""
    kw = {}
    if request.device_draw is not None:
        kw["device_draw"] = request.device_draw
    if request.fuse_refs is not None:
        kw["fuse_refs"] = request.fuse_refs
    if request.pipeline_depth is not None:
        kw["pipeline_depth"] = request.pipeline_depth
    if getattr(request, "kernel_backend", None) is not None:
        kw["kernel_backend"] = request.kernel_backend
    if getattr(request, "tolerance", None) is not None:
        kw["tolerance"] = request.tolerance
    if getattr(request, "max_rounds", None) is not None:
        kw["max_rounds"] = request.max_rounds
    if getattr(request, "round_schedule", None) is not None:
        kw["round_schedule"] = tuple(request.round_schedule)
    return SamplerConfig(ratio=request.ratio, seed=request.seed, **kw)


def progressive_requested(request) -> bool:
    """Whether this request opted into the progressive-precision
    driver: any of the three knobs set on a sampled request. Like
    fuse_refs, the knobs stay out of the fingerprint — a converged
    progressive run is bit-identical to the one-shot result at the
    final ratio, so the cached record answers both forms."""
    return request.engine == "sampled" and any(
        getattr(request, k, None) is not None
        for k in ("tolerance", "max_rounds", "round_schedule")
    )


def _sampled_namespace(state, results):
    import types

    return types.SimpleNamespace(
        state=state,
        total_accesses=sum(r.n_samples for r in results),
        engine="sampled",
    )


def default_batch_runner(jobs):
    """Run several sampled requests as ONE batched engine execution.

    `jobs` is [(request, program, machine)]; the return is one
    (result-namespace, per_ref) pair per job, each bit-identical to
    default_runner("sampled", ...) on that job alone
    (sampler/sampled.py::run_sampled_multi), on the enclosing device
    scope's device."""
    from ..sampler.sampled import run_sampled_multi

    outs = run_sampled_multi([
        (program, machine, sampler_config(request),
         request.runtime == "v2")
        for request, program, machine in jobs
    ], device=placement.active_device())
    return [
        (_sampled_namespace(state, results), results)
        for state, results in outs
    ]


def execute_request(request, program: Program, machine: MachineConfig,
                    engine: str, fingerprint: str,
                    runner=default_runner, trace_id: str | None = None,
                    span_id: str | None = None) -> dict:
    """One engine execution folded into a versioned result record.

    `engine` is the chain element actually being attempted (it may
    differ from request.engine after degradation). The optional trace
    context lands in the `service_exec` span attrs so the run's trace
    export joins the execution to its request(s) and ledger row(s)."""
    telemetry.count("service_exec_started")
    attrs = {"engine": engine, "program": program.name}
    if trace_id is not None:
        attrs["trace_id"] = trace_id
    if span_id is not None:
        attrs["span_id"] = span_id
    with telemetry.span("service_exec", **attrs):
        # chaos site: one occurrence per attempt of this fingerprint,
        # so retries/hedges draw fresh (but deterministic) decisions
        faults.fire("engine_execute", key=fingerprint,
                    engine=engine, model=program.name)
        res, per_ref = runner(engine, program, machine, request)
        record = build_record(
            request, machine, engine, fingerprint, res, per_ref
        )
    telemetry.count("service_exec_done")
    return record


def build_record(request, machine: MachineConfig, engine: str,
                 fingerprint: str, res, per_ref) -> dict:
    """Fold one engine result (state + per-ref outputs) through the
    reference pipeline into the versioned record service/cache.py
    stores. Shared by the solo path and the batch path, so a batch
    member's record is byte-for-byte the one its solo run would
    cache."""
    rih = cri_distribute(
        res.state, machine.thread_num, machine.thread_num
    )
    mrc = aet_mrc(rih, machine)
    label = "samples" if per_ref is not None else "accesses"
    dump_lines = []
    dump_lines += report.noshare_dump(res.state)
    dump_lines += report.share_dump(res.state)
    dump_lines += report.rih_dump(rih)
    dump_lines += report.mrc_lines(mrc)
    dump_lines.append(
        f"max iteration count: {res.total_accesses} {label}"
    )
    record = {
        "store_version": STORE_VERSION,
        "fingerprint": fingerprint,
        "request": request.payload(),
        "engine_requested": request.engine,
        "engine_used": getattr(res, "engine", None) or engine,
        "total_accesses": int(res.total_accesses),
        "access_label": label,
        "rih": {str(k): float(v) for k, v in sorted(rih.items())},
        "mrc": [float(v) for v in mrc],
        "dump_lines": dump_lines,
        "created_at": time.time(),
    }
    if per_ref is not None:
        record["per_ref_lines"] = [
            f"ref {r.name}: {r.n_samples} samples, cold {r.cold:g}"
            for r in per_ref
        ]
    return record


@dataclasses.dataclass
class _BatchEntry:
    """One request queued in the batch admission window."""

    request: object
    program: Program
    machine: MachineConfig
    fingerprint: str
    future: Future
    refs: int  # tracked refs this member contributes to max_refs
    enqueued_at: float  # perf_counter at submit
    deadline: float | None  # absolute perf_counter bound, or None
    # perf_counter when the admission window flushed this entry; the
    # enqueued_at..flushed_at interval is the member's batch_wait
    # stage, flushed_at..execution-start its (pool) queue stage
    flushed_at: float | None = None
    # ir-preflight summary dict (verdict/races) from the service's
    # static-analysis gate, riding along to outcome/response/ledger
    preflight: object = None


class BatchScheduler:
    """Bounded admission window between submit and engine execution.

    Compatible concurrent requests (today: every sampled request — the
    engine batches at kernel-signature grain, so ANY mix of models/N
    is mergeable) queue here instead of going straight to the pool.
    A batch flushes when the OLDEST member has waited window_ms, or
    earlier when the summed tracked-ref count reaches max_refs; the
    overflow remainder seeds the next batch (overflow splitting).
    A member whose deadline expires while queued is evicted and failed
    immediately with deadline_abandoned counted — it never rides the
    batch just to have its result discarded.

    Purely a scheduler: WHAT each member computes is pinned bit-equal
    to its solo run by the engine layer (run_sampled_multi), so the
    only observable trade-off is latency (up to window_ms of added
    wait) against dispatch amortization (batch_occupancy refs per
    fused dispatch).
    """

    def __init__(self, executor: "RequestExecutor",
                 window_ms: float, max_refs: int):
        self._executor = executor
        self._window_s = max(0.0, window_ms) / 1000.0
        self._max_refs = max(1, max_refs)
        self._queue: list[_BatchEntry] = []
        self._cv = lockwitness.make_condition("BatchScheduler._cv")
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="pluss-batch-window",
        )
        self._thread.start()

    def queue_depth(self) -> int:
        with self._cv:
            return len(self._queue)

    def enqueue(self, entry: _BatchEntry) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError("batch scheduler is closed")
            self._queue.append(entry)
            depth = len(self._queue)
            self._cv.notify()
        # gauge outside the condition lock (C_SINK_UNDER_LOCK): the
        # sink takes the metrics-registry lock
        telemetry.gauge("batch_queue_depth", depth)

    def close(self) -> None:
        """Stop admitting; the loop flushes whatever is queued before
        exiting, so no enqueued future is ever left unresolved."""
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join(timeout=5.0)

    # -- window loop --------------------------------------------------

    def _pop_batch_locked(self) -> list[_BatchEntry]:
        """Greedy prefix up to max_refs. The first entry is always
        taken (an oversize single request still runs — max_refs bounds
        merging, not admissible work); the remainder re-queues and,
        its window having effectively elapsed, flushes on the next
        loop iteration."""
        batch: list[_BatchEntry] = []
        total = 0
        while self._queue:
            e = self._queue[0]
            if batch and total + e.refs > self._max_refs:
                break
            batch.append(self._queue.pop(0))
            total += e.refs
        return batch

    def _loop(self) -> None:
        while True:
            expired: list[_BatchEntry] = []
            batch: list[_BatchEntry] = []
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue and self._closed:
                    return
                flush_at = self._queue[0].enqueued_at + self._window_s
                while not self._closed:
                    now = time.perf_counter()
                    live = []
                    for e in self._queue:
                        if e.deadline is not None and e.deadline <= now:
                            expired.append(e)
                        else:
                            live.append(e)
                    if expired:
                        # fail the expiries NOW (their futures resolve
                        # outside the lock below) instead of holding
                        # them until the window flushes; the survivors
                        # keep waiting on the next outer iteration
                        self._queue = live
                        break
                    if now >= flush_at or (
                        sum(e.refs for e in self._queue)
                        >= self._max_refs
                    ):
                        batch = self._pop_batch_locked()
                        break
                    wake = flush_at
                    for e in self._queue:
                        if e.deadline is not None:
                            wake = min(wake, e.deadline)
                    self._cv.wait(timeout=max(0.0, wake - now))
                else:
                    # closed: drain whatever is still queued (one
                    # max_refs-bounded batch per outer iteration)
                    batch = self._pop_batch_locked()
                depth = len(self._queue)
            # executor work — and telemetry, whose sinks take their
            # own locks — runs OUTSIDE the condition lock: expiry
            # resolves futures (whose callbacks take executor locks)
            # and _submit_batch touches the pool
            telemetry.gauge("batch_queue_depth", depth)
            for e in expired:
                self._executor._expire_queued(e)
            if batch:
                self._executor._submit_batch(batch)


class RequestExecutor:
    """Singleflight + bounded concurrency + deadlines over
    `execute_request`. One instance backs one AnalysisService."""

    def __init__(self, cache: ResultCache | None = None,
                 max_workers: int = 4, runner=default_runner,
                 ledger_path: str | None = None,
                 batching: BatchConfig | None = None,
                 batch_runner=default_batch_runner,
                 replicas: ReplicaConfig | int | None = None,
                 resilience: ResilienceConfig | None = None,
                 worker_id: int | None = None,
                 device=None):
        _import_engines()
        self.cache = cache if cache is not None else ResultCache()
        # the engines' device: None (CUDA, every visible card for a
        # replica pool), one device, or a replica pool's device list
        self.device = device
        self.runner = runner
        self.batch_runner = batch_runner
        self.ledger_path = ledger_path
        # fabric attribution: when this executor is one worker of a
        # multi-process fabric, every ledger row it appends carries the
        # worker id, so a shared ledger shards cleanly by the router's
        # ring assignment (tools/check_ledger.py --stats validates it)
        self.worker_id = worker_id
        self._resilience = (
            resilience if resilience is not None else ResilienceConfig()
        )
        self._draining = False
        # per-engine circuit breakers, created lazily on first attempt
        self._breakers: dict[str, CircuitBreaker] = {}
        self._replicas: ReplicaPool | None = None
        if replicas is not None:
            cfg = (
                replicas if isinstance(replicas, ReplicaConfig)
                else ReplicaConfig(count=replicas)
            )
            self._replicas = ReplicaPool(
                cfg, devices=self._pool_devices(cfg),
                resilience=self._resilience,
            )
            n = len(self._replicas)
            if max_workers < n:
                # fewer pool threads than replicas silently strands
                # replicas: a replica only receives work a pool thread
                # submits, so an unreachable replica sits idle while
                # work queues behind the few reachable ones
                telemetry.warn_once(
                    f"max_workers_clamped:{max_workers}:{n}",
                    f"--max-workers {max_workers} < {n} replicas "
                    f"would strand replicas idle; clamped to {n}",
                    requested=max_workers, replicas=n,
                )
                telemetry.count("max_workers_clamped")
                max_workers = n
        self.max_workers = max_workers
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers,
            thread_name_prefix="pluss-service",
        )
        self._inflight: dict[str, Future] = {}
        self._lock = lockwitness.make_lock("RequestExecutor._lock")
        # instance-local counters backing the serve `stats`/`healthz`
        # introspection protocol — telemetry counters only exist while
        # a run is enabled, but a long-lived service must answer
        # introspection requests at any time
        self._stats = collections.Counter()
        # singleflight joiners per in-flight fingerprint, drained into
        # the executing request's ledger row (`coalesced`) so the
        # ledger aggregate reproduces the live submitted/coalesced
        # counters exactly
        self._coalesced_by_fp = collections.Counter()
        # progressive-precision partial-frame subscribers per in-flight
        # fingerprint: every submit (executor AND coalesced joiners)
        # may register a callback; the executing round loop fires all
        # of them after each completed round
        self._partial_subs: dict[str, list] = {}
        # batching observability for stats(): per-batch member counts
        # and cold (cache-miss) latencies batched vs solo, bounded so a
        # long-lived service cannot grow them without limit
        self._batch_occupancy: list[int] = []
        self._lat_batched: list[float] = []
        self._lat_solo: list[float] = []
        self._obs_cap = 512
        self._batcher = (
            BatchScheduler(self, batching.window_ms, batching.max_refs)
            if batching is not None else None
        )
        # compile-counter deltas in ledger rows read the port's build
        # store (runtime/telemetry.py::record_build), which records every
        # kernel build of the process from its start: nothing to register

    def _pool_devices(self, cfg: ReplicaConfig):
        """The replica pool's devices: every visible card (None) where
        the executor names none, its list where it names several, and
        one device repeated once per requested replica (at least one)
        where it names one, so "cpu" with 4 replicas serves four on the
        CPU and "cuda:0" with 2 two on one card."""
        if self.device is None:
            return None
        if isinstance(self.device, (list, tuple)):
            return list(self.device)
        return [self.device] * max(1, cfg.count or 1)

    def _scope_device(self):
        """The device an execution outside the replica pool runs on: the
        executor's own (the first of a list), or None (the engines'
        CUDA default)."""
        if isinstance(self.device, (list, tuple)):
            return self.device[0] if self.device else None
        return self.device

    def stats(self) -> dict:
        """Executor health snapshot: queue depth (submitted futures
        not yet executing), in-flight count, singleflight coalesces,
        and the lifetime execution/degradation counters."""
        with self._lock:
            out = dict(self._stats)
            inflight = len(self._inflight)
            occupancy = sorted(self._batch_occupancy)
            lat_b = sorted(self._lat_batched)
            lat_s = sorted(self._lat_solo)
        for key in ("submitted", "coalesced", "completed", "failed",
                    "degraded", "deadline_abandoned", "active",
                    "ledger_rows", "ledger_write_failed",
                    "batches_formed", "batch_members",
                    "batch_fallback_solo", "preflight_rejected",
                    "frontend_rejected", "race_warnings",
                    "shed", "retried", "hedged", "hedge_wins",
                    "hedge_cancelled", "breaker_opened",
                    "breaker_reclosed", "breaker_open_skips",
                    "partial_final", "progressive_converged",
                    "partials_emitted"):
            out.setdefault(key, 0)
        active = out.pop("active")
        out["in_flight"] = inflight
        out["executing"] = active
        out["queue_depth"] = max(0, inflight - active)
        out["max_workers"] = self.max_workers
        out["batch_queue_depth"] = (
            self._batcher.queue_depth() if self._batcher else 0
        )
        if occupancy:
            out["batch_occupancy_p50"] = obs_ledger._percentile(
                occupancy, 0.50
            )
            out["batch_occupancy_p95"] = obs_ledger._percentile(
                occupancy, 0.95
            )
        if lat_b:
            out["batched_p50_latency_s"] = round(
                obs_ledger._percentile(lat_b, 0.50), 6
            )
        if lat_s:
            out["solo_p50_latency_s"] = round(
                obs_ledger._percentile(lat_s, 0.50), 6
            )
        if self._replicas is not None:
            # per-replica occupancy — the instance-local face of the
            # same counts /metrics exports (requests_routed_r*) and
            # check_ledger --stats aggregates (rows' replica_id)
            out["replicas"] = self._replicas.snapshot()
        out["draining"] = self._draining
        out["queue_limit"] = self._resilience.queue_limit
        with self._lock:
            brs = dict(self._breakers)
        if brs:
            out["breakers"] = {
                eng: br.snapshot() for eng, br in sorted(brs.items())
            }
        return out

    def _note_latency(self, outcome: dict, batched: bool) -> None:
        """Collect cold-execution latencies for the batched-vs-solo
        stats comparison (warm cache hits would swamp both sides)."""
        if outcome["record"] is None or outcome["cache"] != "miss":
            return
        dest = self._lat_batched if batched else self._lat_solo
        with self._lock:
            if len(dest) < self._obs_cap:
                dest.append(outcome["latency_s"])

    # Instance-counter -> telemetry/registry name, the one write path
    # behind the three counter surfaces (serve `stats`, the Prometheus
    # export, the ledger aggregate): every _count lands in the
    # instance snapshot AND — via telemetry.count, which mirrors into
    # the live metrics registry — in both exported views, under one
    # name. "active" is a +/-1 level, not a monotone counter, so it
    # stays instance-local (stats() reports it as `executing`).
    _TELE_COUNTS = {
        "submitted": "service_submitted",
        "coalesced": "service_coalesced",
        "completed": "service_completed",
        "failed": "service_failed",
        "degraded": "service_degraded",
        "deadline_abandoned": "service_deadline_abandoned",
        "ledger_rows": "service_ledger_rows",
        "ledger_write_failed": "service_ledger_write_failed",
        "batches_formed": "batches_formed",
        "batch_members": "batch_members",
        "batch_fallback_solo": "service_batch_fallback_solo",
        "preflight_rejected": "ir_preflight_failures",
        "frontend_rejected": "frontend_rejected",
        "race_warnings": "race_warnings",
        "shed": "service_shed",
        "retried": "service_retried",
        "hedged": "service_hedged",
        "hedge_wins": "service_hedge_wins",
        "hedge_cancelled": "service_hedge_cancelled",
        "breaker_opened": "service_breaker_opened",
        "breaker_reclosed": "service_breaker_reclosed",
        "breaker_open_skips": "service_breaker_open_skips",
        "partial_final": "service_partial_final",
        "progressive_converged": "service_progressive_converged",
        "partials_emitted": "service_partials_emitted",
        "partial_emit_failed": "service_partial_emit_failed",
    }

    def _count(self, key: str, inc: int = 1) -> None:
        with self._lock:
            self._stats[key] += inc
        name = self._TELE_COUNTS.get(key)
        if name is not None:
            telemetry.count(name, inc)

    # -- public -------------------------------------------------------

    def submit(self, request, program: Program,
               machine: MachineConfig, fingerprint: str,
               preflight: dict | None = None,
               on_partial=None) -> Future:
        """Schedule (or join) the execution for one fingerprint.

        The returned future resolves to the full response dict (record
        + serving metadata). Identical fingerprints submitted while
        one is in flight share its future (and its trace/span ids —
        one execution, one span, N joined callers). `preflight` is the
        service's static-analysis summary (verdict/races); it rides
        the outcome into the response and the ledger row. Coalesced
        joiners share the executing request's summary — same
        fingerprint, same IR, same verdict.

        `on_partial` (progressive-precision requests) is called with
        one interim-result doc per completed round, from the executing
        thread; coalesced joiners register their own callback on the
        shared execution, so every subscriber streams the same
        rounds."""
        telemetry.count("service_requests")
        telemetry.count("service_submitted")
        if getattr(request, "trace_id", None) is None:
            # mint the trace context here so every downstream surface
            # (span attrs, ledger row, exemplars, response) can join
            # on it even for callers that never set one
            request = dataclasses.replace(
                request, trace_id=uuid.uuid4().hex[:16]
            )
        submitted_at = time.perf_counter()
        batchable = (
            self._batcher is not None and self._batchable(request)
        )
        entry = None
        shed_reason = None
        with self._lock:
            self._stats["submitted"] += 1
            fut = self._inflight.get(fingerprint)
            if fut is not None:
                self._stats["coalesced"] += 1
                # joiners ride the executing request's ledger row —
                # remembered per fingerprint so the row can report how
                # many submissions it answered
                self._coalesced_by_fp[fingerprint] += 1
                if on_partial is not None:
                    self._partial_subs.setdefault(
                        fingerprint, []
                    ).append(on_partial)
            else:
                # admission gate — AFTER the coalesce join (joining an
                # in-flight execution costs nothing, so it is never
                # shed) and BEFORE any queue/pool state is touched, so
                # a shed is a cheap structured refusal, not an
                # expensive timeout
                priority = getattr(request, "priority", "normal")
                if self._draining:
                    shed_reason = (
                        "service draining (shutdown in progress)"
                    )
                elif (self._resilience.queue_limit is not None
                        and self._resilience.shed_enabled):
                    depth = (len(self._inflight)
                             - self._stats.get("active", 0))
                    limit = self._admission_limit(priority)
                    if depth >= limit:
                        shed_reason = (
                            f"queue depth {depth} at admission limit "
                            f"{limit} for priority {priority!r}"
                        )
        if fut is not None:
            # count outside the lock (C_SINK_UNDER_LOCK): the sink
            # takes the metrics-registry lock
            telemetry.count("service_coalesced")
            return fut
        if shed_reason is not None:
            return self._shed(request, fingerprint, shed_reason,
                              preflight, submitted_at)
        with self._lock:
            # re-check the singleflight join: the gate ran outside
            # the first critical section, so an identical fingerprint
            # may have landed in between
            coalesced = self._inflight.get(fingerprint)
            if on_partial is not None and (
                coalesced is not None or not batchable
            ):
                self._partial_subs.setdefault(
                    fingerprint, []
                ).append(on_partial)
            if coalesced is not None:
                self._stats["coalesced"] += 1
                self._coalesced_by_fp[fingerprint] += 1
            elif batchable:
                # the admission window resolves this future itself;
                # singleflight still coalesces identical fingerprints
                # onto it while it waits or runs
                fut = Future()
                fut.set_running_or_notify_cancel()
                entry = _BatchEntry(
                    request=request, program=program, machine=machine,
                    fingerprint=fingerprint, future=fut,
                    refs=sum(len(n.refs) for n in program.nests),
                    enqueued_at=submitted_at,
                    deadline=(
                        None if request.deadline_s is None
                        else time.perf_counter() + request.deadline_s
                    ),
                    preflight=preflight,
                )
                self._inflight[fingerprint] = fut
            else:
                fut = self._pool.submit(
                    self._process, request, program, machine,
                    fingerprint, submitted_at, preflight,
                )
                self._inflight[fingerprint] = fut
            depth = len(self._inflight)
        # sinks outside the lock (C_SINK_UNDER_LOCK)
        if coalesced is not None:
            telemetry.count("service_coalesced")
            return coalesced
        telemetry.gauge("service_queue_depth", depth)

        def _done(_f, fp=fingerprint):
            with self._lock:
                self._inflight.pop(fp, None)
                self._partial_subs.pop(fp, None)
                depth = len(self._inflight)
            telemetry.gauge("service_queue_depth", depth)

        # registered OUTSIDE the lock: a future that already finished
        # runs the callback synchronously on this thread, and the
        # callback itself takes the lock
        fut.add_done_callback(_done)
        if entry is not None:
            self._batcher.enqueue(entry)
        return fut

    @staticmethod
    def _batchable(request) -> bool:
        """The compatibility predicate: which requests may share a
        batched execution. Today exactly the sampled engine — the only
        one with a multi-job runner; kernel-signature bucketing makes
        any mix of models/N/configs mergeable within it. Progressive
        requests run their own round loop (deadline checks and partial
        streaming between rounds), so they always execute solo."""
        return (request.engine == "sampled"
                and not progressive_requested(request))

    def _admission_limit(self, priority: str) -> int:
        """Queue slots this priority class may fill before shedding
        (a fraction of queue_limit; high priority gets the full
        limit, so under saturation low-priority traffic sheds
        first)."""
        frac = _PRIORITY_HEADROOM.get(
            priority, _PRIORITY_HEADROOM["normal"]
        )
        return max(1, math.ceil(self._resilience.queue_limit * frac))

    def _shed(self, request, fingerprint: str, reason: str,
              preflight, submitted_at: float) -> Future:
        """Refuse one submission at the admission gate with a
        STRUCTURED outcome, never an exception: counted `shed` (not
        `failed` — the service declined the work, it did not botch
        it), stamped on its own ledger row, and resolved in
        microseconds instead of timing out after seconds of
        queueing."""
        self._count("shed")
        telemetry.event(
            "service_shed", fingerprint=fingerprint, reason=reason,
            priority=getattr(request, "priority", "normal"),
        )
        outcome = {
            "record": None,
            "cache": None,
            "degraded": [],
            "error": f"shed: {reason}",
            "shed": True,
            "latency_s": round(time.perf_counter() - submitted_at, 6),
            "mrc_digest": None,
            "trace_id": getattr(request, "trace_id", None),
            "span_id": None,
            "queue_s": None,
            "execute_s": None,
            "replica_id": None,
            "preflight": preflight,
        }
        self._record_flight(request, outcome, extra={"shed": True})
        if self.ledger_path:
            self._append_ledger_row(
                request, fingerprint, outcome,
                telemetry.compile_counters_snapshot(),
            )
        fut: Future = Future()
        fut.set_running_or_notify_cancel()
        fut.set_result(outcome)
        return fut

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self) -> None:
        """Begin graceful shutdown: every LATER submit sheds at the
        admission gate, and work still queued in the pool (submitted
        but not yet executing) is cancelled — its waiters observe
        CancelledError, which the serve loop answers with a structured
        shed response. Executions already running finish normally:
        this drains the service, it does not abort it."""
        with self._lock:
            already = self._draining
            self._draining = True
            pending = list(self._inflight.values())
        if already:
            return
        telemetry.event("service_draining")
        for fut in pending:
            # queued pool futures cancel; executing (and batch-window)
            # futures refuse and resolve normally during the drain
            if fut.cancel():
                self._count("shed")

    def shutdown(self) -> None:
        if self._batcher is not None:
            # flush the admission window through the pool BEFORE the
            # pool stops accepting work
            self._batcher.close()
        self._pool.shutdown(wait=True)
        if self._replicas is not None:
            # last: every pool worker has returned, so no execution
            # is still waiting on a replica future
            self._replicas.close()

    # -- replica routing ----------------------------------------------

    def _execute_routed(self, fn, trace_id=None, members: int = 1,
                        meta: dict | None = None):
        """Run one engine execution (a solo chain attempt or a whole
        batch window) on the replica pool when one exists, inline
        otherwise. Returns (fn's result, replica_id|None, re-route
        degradation events).

        Hedging: with `hedge_after_s` configured and >= 2 replicas, a
        routed dispatch still unresolved after the hedge delay is
        duplicated onto a second replica (tail-latency insurance
        against a straggler). First result wins; the losing copy is
        cancelled while still queued (ReplicaPool.try_cancel) or, if
        already executing, finishes into the void. Both copies compute
        the same seed-derived bytes, so whichever wins the response is
        bit-identical — hedging can only change WHEN the answer
        arrives, never WHAT it is."""
        if self._replicas is None:
            dev = self._scope_device()
            if dev is None:
                return fn(), None, []
            with placement.device_scope([dev]):
                return fn(), None, []
        hedge_s = self._resilience.hedge_after_s
        if hedge_s is None or len(self._replicas) < 2:
            return self._replicas.run(
                fn, trace_id=trace_id, members=members
            )
        primary = self._replicas.submit(
            fn, trace_id=trace_id, members=members
        )
        try:
            return primary.result(timeout=hedge_s)
        except FuturesTimeoutError:
            pass
        self._count("hedged")
        if meta is not None:
            meta["hedged"] = True
        telemetry.event("service_hedged", trace_id=trace_id,
                        hedge_after_s=hedge_s)
        hedge = self._replicas.submit(
            fn, trace_id=trace_id, members=members
        )
        futures_wait((primary, hedge), return_when=FIRST_COMPLETED)
        winner, loser = (
            (primary, hedge) if primary.done() else (hedge, primary)
        )
        if winner is hedge:
            self._count("hedge_wins")
        if self._replicas.try_cancel(loser):
            self._count("hedge_cancelled")
        else:
            # the loser is executing (or finished) — let it resolve in
            # the background so its replica bookkeeping stays honest
            loser.add_done_callback(lambda f: f.exception())
        return winner.result()

    def _absorb_replica_events(self, degraded: list, events,
                               fingerprint: str) -> None:
        """Fold the pool's quarantine re-route events into a request's
        degradation chain, mirroring engine downgrades: each lands in
        the response/ledger `degraded` list AND as a
        `service_degraded` telemetry event (the completion is then
        counted degraded, which is what the SLO error budget reads)."""
        for info in events:
            degraded.append(dict(info))
            telemetry.event(
                "service_degraded", fingerprint=fingerprint, **info
            )

    def warm_structures(self, jobs) -> int:
        """Pre-compile sampled kernel signatures: `jobs` is
        [(program, machine, SamplerConfig|None)]. With a pool, every
        replica compiles on ITS devices (structure-keyed, so repeats
        are free); without one, a single inline warmup. Returns the
        number of warmup executions performed. Used by ledger-driven
        warm start (`--warmup-from-ledger`)."""
        done = 0
        for program, machine, cfg in jobs:
            if self._replicas is not None:
                done += self._replicas.warmup(program, machine, cfg)
            else:
                from ..sampler.sampled import warmup

                warmup(program, machine, cfg, device=self._scope_device())
                done += 1
        return done

    # -- worker -------------------------------------------------------

    def _process(self, request, program, machine,
                 fingerprint: str,
                 submitted_at: float | None = None,
                 preflight: dict | None = None) -> dict:
        start = time.perf_counter()
        t0 = submitted_at if submitted_at is not None else start
        queue_s = None if submitted_at is None else start - submitted_at
        trace_id = getattr(request, "trace_id", None)
        span_id = None
        execute_s = None
        self._count("active")
        compiles0 = (
            telemetry.compile_counters_snapshot()
            if self.ledger_path else None
        )
        try:
            with telemetry.span("service_request",
                                engine=request.engine,
                                program=program.name,
                                trace_id=trace_id):
                fetch_t0 = time.perf_counter()
                record, tier = self.cache.get(fingerprint)
                fetch_s = time.perf_counter() - fetch_t0
                degraded: list[dict] = []
                error = None
                replica_id = None
                meta = {"retries": 0, "hedged": False}
                if record is None:
                    span_id = uuid.uuid4().hex[:16]
                    exec_t0 = time.perf_counter()
                    record, degraded, error, replica_id = (
                        self._run_chain(
                            request, program, machine, fingerprint,
                            trace_id=trace_id, span_id=span_id,
                            meta=meta,
                        )
                    )
                    execute_s = time.perf_counter() - exec_t0
                    if record is not None and not degraded:
                        self.cache.put(fingerprint, record)
        finally:
            self._count("active", -1)
        self._count("completed" if record is not None else "failed")
        if degraded:
            self._count("degraded")
        outcome = {
            "record": record,
            "cache": tier,
            "degraded": degraded,
            "error": error,
            "latency_s": round(time.perf_counter() - t0, 6),
            "mrc_digest": (
                obs_ledger.mrc_digest(record["mrc"])
                if record is not None else None
            ),
            "trace_id": trace_id,
            "span_id": span_id,
            "queue_s": queue_s,
            "execute_s": execute_s,
            "replica_id": replica_id,
            "preflight": preflight,
            "retries": meta["retries"],
            "hedged": meta["hedged"],
        }
        prog = meta.get("progressive")
        if prog is not None:
            # progressive-precision outcome fields (schema-v2
            # optional): rounds completed, tightest band reached,
            # whether the run converged; partial_final marks the
            # deadline-truncated form (already a precision:* degrade
            # hop above, so it was kept out of the cache)
            outcome["rounds"] = prog["rounds"]
            outcome["band_width"] = prog["band_width"]
            outcome["converged"] = prog["converged"]
            if prog.get("partial_final"):
                outcome["partial_final"] = True
        self._attribute_utilization(outcome, compiles0,
                                    fetch_s=fetch_s)
        self._observe_stages(outcome, queue_s=queue_s,
                             execute_s=execute_s, fetch_s=fetch_s)
        self._record_flight(request, outcome)
        self._note_latency(outcome, batched=False)
        if self.ledger_path:
            self._append_ledger_row(
                request, fingerprint, outcome, compiles0
            )
        return outcome

    def _observe_stages(self, outcome: dict, queue_s=None,
                        batch_wait_s=None, execute_s=None,
                        fetch_s=None) -> None:
        """Record the per-stage request histograms into the live
        registry (no-op when metrics are disabled), with the request's
        trace_id as the exemplar."""
        from ..runtime.obs import metrics as obs_metrics

        if obs_metrics.get() is None:
            return
        ex = outcome.get("trace_id")
        for name, value in (
            ("request_queue_s", queue_s),
            ("request_batch_wait_s", batch_wait_s),
            ("request_execute_s", execute_s),
            ("request_fetch_s", fetch_s),
            ("request_total_s", outcome.get("latency_s")),
        ):
            if value is not None:
                obs_metrics.observe(name, value, exemplar=ex)

    def _attribute_utilization(self, outcome: dict, compiles0,
                               fetch_s=None) -> None:
        """Fold the request's stage seconds into a `utilization`
        block (runtime/obs/attribution.py) on the outcome — wall vs
        executing vs queue/batch-wait vs fetch, plus the execution's
        jit-compile seconds when a compile baseline was snapped — and
        mirror the busy/idle/unattributed fractions into the live
        gauges. Attribution is observation only: it must never sink
        the request."""
        from ..runtime.obs import attribution

        try:
            compile_s = None
            if compiles0 is not None:
                now = telemetry.compile_counters_snapshot()
                delta = (
                    now.get("backend_compile_s", 0.0)
                    - compiles0.get("backend_compile_s", 0.0)
                )
                if delta > 0:
                    compile_s = round(delta, 6)
            block = attribution.request_utilization(
                wall_s=outcome.get("latency_s"),
                execute_s=outcome.get("execute_s"),
                queue_s=outcome.get("queue_s"),
                batch_wait_s=outcome.get("batch_wait_s"),
                fetch_s=fetch_s,
                compile_s=compile_s,
            )
            if block is not None:
                outcome["utilization"] = block
                attribution.record_gauges(block)
        except Exception:
            self._count("utilization_failed")

    def _record_flight(self, request, outcome: dict,
                       extra: dict | None = None) -> None:
        """Feed one per-request record into the flight recorder
        (runtime/obs/recorder.py); no-op when disabled. The record is
        the outcome minus the payload-heavy `record` field, plus the
        request identity — what a post-mortem needs to reconstruct the
        request's path without shipping MRC arrays into every bundle.
        A failed request fires the recorder's request_failure trigger
        from inside record()."""
        from ..runtime.obs import recorder as obs_recorder

        if obs_recorder.get() is None:
            return
        rec = {
            "trace_id": outcome.get("trace_id"),
            "span_id": outcome.get("span_id"),
            "model": request.model,
            "n": request.n,
            "engine_requested": request.engine,
            "engine_used": (
                outcome["record"].get("engine_used")
                if outcome.get("record") else None
            ),
            "ok": outcome.get("record") is not None,
            "error": outcome.get("error"),
            "cache": outcome.get("cache"),
            "degraded": outcome.get("degraded"),
            "latency_s": outcome.get("latency_s"),
            "queue_s": outcome.get("queue_s"),
            "batch_wait_s": outcome.get("batch_wait_s"),
            "execute_s": outcome.get("execute_s"),
            "replica_id": outcome.get("replica_id"),
            "mrc_digest": outcome.get("mrc_digest"),
        }
        if outcome.get("utilization") is not None:
            rec["utilization"] = outcome["utilization"]
        pf = outcome.get("preflight")
        if isinstance(pf, dict) and pf.get("verdict"):
            rec["preflight"] = pf["verdict"]
        if extra:
            rec.update(extra)
        obs_recorder.record(rec)

    # -- batched worker -----------------------------------------------

    def _submit_batch(self, entries: list[_BatchEntry]) -> None:
        """Hand one flushed admission window to the pool (called by
        the BatchScheduler loop, never under its condition lock)."""
        now = time.perf_counter()
        for e in entries:
            e.flushed_at = now
        self._pool.submit(self._process_batch, entries)

    def _process_batch(self, entries: list[_BatchEntry]) -> None:
        """Run one flushed window as (at most) one batched engine
        execution, resolving every member's future.

        Members are peeled off first when the batch cannot or need not
        carry them: warm cache hits are served immediately (zero
        executions — the singleflight/caching invariant), queued
        deadline expiries fail immediately, and members whose program
        fails to lower (pre-flight kernel build) fall back to the solo
        chain. Everything left runs through ONE batch_runner call; a
        batch-level failure degrades every member to solo execution
        rather than failing them collectively."""
        exec_start = time.perf_counter()
        compiles0 = (
            telemetry.compile_counters_snapshot()
            if self.ledger_path else None
        )
        runnable: list[_BatchEntry] = []
        for e in entries:
            if e.deadline is not None and e.deadline <= time.perf_counter():
                self._expire_queued(e)
                continue
            fetch_t0 = time.perf_counter()
            record, tier = self.cache.get(e.fingerprint)
            fetch_s = time.perf_counter() - fetch_t0
            if record is not None:
                self._count("completed")
                outcome = {
                    "record": record,
                    "cache": tier,
                    "degraded": [],
                    "error": None,
                    "latency_s": round(
                        time.perf_counter() - e.enqueued_at, 6
                    ),
                    "mrc_digest": obs_ledger.mrc_digest(record["mrc"]),
                    "trace_id": getattr(e.request, "trace_id", None),
                    "span_id": None,
                    "batch_wait_s": self._batch_wait_s(e),
                    "queue_s": self._queue_wait_s(e, exec_start),
                }
                self._observe_stages(
                    outcome, queue_s=outcome["queue_s"],
                    batch_wait_s=outcome["batch_wait_s"],
                    fetch_s=fetch_s,
                )
                self._finish(e, outcome, compiles0)
                continue
            try:
                # pre-flight: an unlowerable program must not poison
                # the shared dispatch — send it down the solo chain
                # (whose own error handling owns the failure)
                from ..sampler.sampled import _program_rows

                _program_rows(e.program, e.machine)
            except Exception:
                self._solo_fallback(e, compiles0)
                continue
            runnable.append(e)
        if not runnable:
            return
        batch_id = uuid.uuid4().hex[:8]
        # ONE span for the shared execution: every member's ledger row
        # and response joins it on span_id (the trace-context upgrade
        # over the coarse batch_id join)
        span_id = uuid.uuid4().hex[:16]
        self._count("batches_formed")
        self._count("batch_members", len(runnable))
        with self._lock:
            if len(self._batch_occupancy) < self._obs_cap:
                self._batch_occupancy.append(len(runnable))
        telemetry.gauge("batch_occupancy", len(runnable))
        self._count("active")
        telemetry.count("service_exec_started")

        def _run_window():
            # the span opens on the EXECUTING thread (a replica worker
            # when a pool routes the window), so its attrs carry the
            # replica's device scope implicitly
            with telemetry.span("service_exec", engine="sampled",
                                batch=len(runnable), batch_id=batch_id,
                                span_id=span_id):
                return self.batch_runner([
                    (e.request, e.program, e.machine) for e in runnable
                ])

        meta = {"retries": 0, "hedged": False}
        try:
            exec_t0 = time.perf_counter()
            outs, batch_rid, batch_events = self._execute_routed(
                _run_window,
                trace_id=getattr(runnable[0].request, "trace_id", None),
                members=len(runnable), meta=meta,
            )
            execute_s = time.perf_counter() - exec_t0
            telemetry.count("service_exec_done")
        except Exception:
            # one shared dispatch failed: no member is served a
            # collective error — each re-runs solo
            telemetry.count("service_batch_failed")
            for e in runnable:
                self._solo_fallback(e, compiles0)
            return
        finally:
            self._count("active", -1)
        for e, (res, per_ref) in zip(runnable, outs):
            try:
                fetch_t0 = time.perf_counter()
                record = build_record(
                    e.request, e.machine, "sampled", e.fingerprint,
                    res, per_ref,
                )
                # per-member cache write: EVERY member lands in the
                # store under its own fingerprint, so a warm repeat of
                # any of them is a hit with zero executions — except
                # after a quarantine re-route, which (like any other
                # degradation) is served but never persisted
                if not batch_events:
                    self.cache.put(e.fingerprint, record)
                fetch_s = time.perf_counter() - fetch_t0
            except Exception:
                self._solo_fallback(e, compiles0)
                continue
            self._count("completed")
            degraded: list[dict] = []
            self._absorb_replica_events(
                degraded, batch_events, e.fingerprint
            )
            if degraded:
                self._count("degraded")
            outcome = {
                "record": record,
                "cache": "miss",
                "degraded": degraded,
                "error": None,
                # from enqueue: the member's latency honestly includes
                # its admission-window wait — the trade-off the
                # batched-vs-solo stats exist to show
                "latency_s": round(
                    time.perf_counter() - e.enqueued_at, 6
                ),
                "mrc_digest": obs_ledger.mrc_digest(record["mrc"]),
                "trace_id": getattr(e.request, "trace_id", None),
                # the SHARED execution span: N member rows, one span
                "span_id": span_id,
                "batch_wait_s": self._batch_wait_s(e),
                "queue_s": self._queue_wait_s(e, exec_start),
                "execute_s": execute_s,
                # the replica that ultimately served the window (the
                # re-route target when quarantine moved it)
                "replica_id": batch_rid,
                # a hedged window marks every member it carried
                "hedged": meta["hedged"],
            }
            self._observe_stages(
                outcome, queue_s=outcome["queue_s"],
                batch_wait_s=outcome["batch_wait_s"],
                execute_s=execute_s, fetch_s=fetch_s,
            )
            self._note_latency(outcome, batched=True)
            self._finish(e, outcome, compiles0, batch_id=batch_id,
                         batch_members=len(runnable))

    @staticmethod
    def _batch_wait_s(e: _BatchEntry):
        """Admission-window wait of one member (None before flush)."""
        if e.flushed_at is None:
            return None
        return max(0.0, e.flushed_at - e.enqueued_at)

    @staticmethod
    def _queue_wait_s(e: _BatchEntry, exec_start: float):
        """Pool wait between window flush and batch-worker start."""
        if e.flushed_at is None:
            return None
        return max(0.0, exec_start - e.flushed_at)

    def _solo_fallback(self, e: _BatchEntry, compiles0) -> None:
        """Degrade one batch member to the solo execution chain."""
        self._count("batch_fallback_solo")
        trace_id = getattr(e.request, "trace_id", None)
        span_id = uuid.uuid4().hex[:16]
        exec_t0 = time.perf_counter()
        meta = {"retries": 0, "hedged": False}
        try:
            record, degraded, error, replica_id = self._run_chain(
                e.request, e.program, e.machine, e.fingerprint,
                trace_id=trace_id, span_id=span_id, meta=meta,
            )
            if record is not None and not degraded:
                self.cache.put(e.fingerprint, record)
        except Exception as exc:
            record, degraded, error, replica_id = None, [], repr(exc), None
        execute_s = time.perf_counter() - exec_t0
        self._count("completed" if record is not None else "failed")
        if degraded:
            self._count("degraded")
        outcome = {
            "record": record,
            "cache": "miss",
            "degraded": degraded,
            "error": error,
            "latency_s": round(time.perf_counter() - e.enqueued_at, 6),
            "mrc_digest": (
                obs_ledger.mrc_digest(record["mrc"])
                if record is not None else None
            ),
            "trace_id": trace_id,
            "span_id": span_id,
            "batch_wait_s": self._batch_wait_s(e),
            "execute_s": execute_s,
            "replica_id": replica_id,
            "retries": meta["retries"],
            "hedged": meta["hedged"],
        }
        self._observe_stages(
            outcome, batch_wait_s=outcome["batch_wait_s"],
            execute_s=execute_s,
        )
        self._note_latency(outcome, batched=False)
        self._finish(e, outcome, compiles0)

    def _expire_queued(self, e: _BatchEntry) -> None:
        """Fail a member whose deadline passed while it sat in the
        admission window — immediately, instead of riding the batch
        and discarding the result afterward (the deadline fix)."""
        self._count("deadline_abandoned")
        self._count("failed")
        outcome = {
            "record": None,
            "cache": None,
            "degraded": [],
            "error": (
                f"deadline {e.request.deadline_s}s expired in the "
                "batch admission window (deadline_abandoned)"
            ),
            "latency_s": round(time.perf_counter() - e.enqueued_at, 6),
            "mrc_digest": None,
            "trace_id": getattr(e.request, "trace_id", None),
            "span_id": None,
            "batch_wait_s": round(
                time.perf_counter() - e.enqueued_at, 6
            ),
        }
        self._observe_stages(
            outcome, batch_wait_s=outcome["batch_wait_s"]
        )
        compiles0 = (
            telemetry.compile_counters_snapshot()
            if self.ledger_path else None
        )
        self._finish(e, outcome, compiles0)

    def _finish(self, e: _BatchEntry, outcome: dict, compiles0,
                batch_id: str | None = None,
                batch_members: int | None = None) -> None:
        """Ledger + future resolution for one batch member."""
        if e.preflight is not None:
            outcome.setdefault("preflight", e.preflight)
        self._attribute_utilization(outcome, compiles0)
        self._record_flight(
            e.request, outcome,
            extra=(
                {"batch_id": batch_id, "batch_members": batch_members}
                if batch_id is not None else None
            ),
        )
        if self.ledger_path:
            extra = {}
            if batch_id is not None:
                extra = {"batch_id": batch_id,
                         "batch_members": batch_members}
            self._append_ledger_row(
                e.request, e.fingerprint, outcome, compiles0,
                extra=extra,
            )
        e.future.set_result(outcome)

    def _append_ledger_row(self, request, fingerprint: str,
                           outcome: dict, compiles0: dict,
                           extra: dict | None = None) -> None:
        """One ledger row per execution (cache hits included, since a
        served response is an execution of the SERVICE even when the
        engine never ran; coalesced callers share the executing row).
        A ledger failure must never sink the request — it is counted
        and dropped."""
        record = outcome["record"]
        now = telemetry.compile_counters_snapshot()
        compile_delta = {
            k: v - compiles0.get(k, 0)
            for k, v in now.items()
            if v - compiles0.get(k, 0)
        }
        row = {
            "kind": "request",
            "source": "service",
            "ok": record is not None,
            "fingerprint": fingerprint,
            "engine_requested": request.engine,
            "engine_used": (
                record.get("engine_used") if record else None
            ),
            "model": request.model,
            "n": request.n,
            "latency_s": outcome["latency_s"],
            "cache": outcome["cache"],
            "degraded": outcome["degraded"],
            "compile_delta": {
                k: round(v, 4) if isinstance(v, float) else v
                for k, v in compile_delta.items()
            },
            "mrc_digest": outcome["mrc_digest"],
        }
        # v2 trace context + per-stage timings + singleflight join
        # count: the row must reproduce the live counters' view of
        # this request (submitted = 1 + coalesced) and join its
        # (possibly shared) execution span on span_id
        row["trace_id"] = outcome.get("trace_id")
        row["span_id"] = outcome.get("span_id")
        if outcome.get("replica_id") is not None:
            row["replica_id"] = outcome["replica_id"]
        if self.worker_id is not None:
            row["worker_id"] = self.worker_id
        # the full request payload makes the ledger replayable: warm
        # start (--warmup-from-ledger) rebuilds the row's program/
        # machine/sampler config from it to pre-compile the kernels a
        # restarted serve process is about to need
        try:
            row["request"] = request.payload()
        except Exception:
            pass
        pf = outcome.get("preflight")
        if isinstance(pf, dict) and pf.get("verdict"):
            # schema-v2 optional field: the preflight verdict string
            # ("ok" | "race"; rejections write their own row from the
            # service with verdict "invalid")
            row["preflight"] = pf["verdict"]
            if pf.get("signature"):
                # custom (inline-program) rows carry the structural
                # signature, so a model:"custom" row is attributable
                # to a nest shape without replaying the document
                row["signature"] = pf["signature"]
        # schema-v2 resilience outcomes: only stamped when they
        # happened, so pre-resilience rows and quiet requests keep the
        # exact same shape (and bytes) as before
        if outcome.get("shed"):
            row["shed"] = True
        if outcome.get("hedged"):
            row["hedged"] = True
        if outcome.get("retries"):
            row["retries"] = int(outcome["retries"])
        # schema-v2 progressive-precision columns: stamped only for
        # progressive executions, so every other row keeps its exact
        # pre-progressive bytes. band_width is finite by the time a
        # round has completed; guard anyway so a ledger row can never
        # carry a non-JSON float
        if outcome.get("rounds") is not None:
            row["rounds"] = int(outcome["rounds"])
        bw = outcome.get("band_width")
        if bw is not None and math.isfinite(float(bw)):
            row["band_width"] = round(float(bw), 6)
        if outcome.get("converged") is not None:
            row["converged"] = bool(outcome["converged"])
        for stage in ("queue_s", "batch_wait_s", "execute_s"):
            v = outcome.get(stage)
            if v is not None:
                row[stage] = round(float(v), 6)
        # schema-v2 utilization attribution block: stamped only when
        # the attribution layer produced one, so rows without it keep
        # their exact pre-attribution bytes
        if outcome.get("utilization") is not None:
            row["utilization"] = outcome["utilization"]
        with self._lock:
            row["coalesced"] = self._coalesced_by_fp.pop(
                fingerprint, 0
            )
        if outcome["error"] is not None:
            row["error"] = str(outcome["error"])[:300]
        if extra:
            row.update(extra)
        try:
            obs_ledger.append(self.ledger_path, row)
            self._count("ledger_rows")
        except Exception:
            self._count("ledger_write_failed")

    def _breaker(self, engine: str) -> CircuitBreaker:
        """The lazily-created per-engine circuit breaker."""
        with self._lock:
            br = self._breakers.get(engine)
            if br is None:
                r = self._resilience
                br = CircuitBreaker(
                    failures=r.breaker_failures,
                    probation_s=r.breaker_probation_s,
                    escalation=r.breaker_escalation,
                    probation_max_s=r.breaker_probation_max_s,
                )
                self._breakers[engine] = br
            return br

    def _fire_partial(self, fingerprint: str, doc: dict) -> None:
        """Deliver one interim-round doc to every partial subscriber
        of this fingerprint (executor + coalesced joiners). A
        subscriber blow-up is ITS problem — counted, never allowed to
        sink the executing round loop."""
        with self._lock:
            subs = list(self._partial_subs.get(fingerprint, ()))
        for cb in subs:
            try:
                cb(doc)
            except Exception:
                self._count("partial_emit_failed")

    def _run_progressive(self, request, program, machine, fingerprint,
                         trace_id: str | None = None,
                         span_id: str | None = None,
                         meta: dict | None = None):
        """The progressive-precision execution path (same return shape
        as _run_chain): rounds of increasing sample prefixes with a
        bootstrap confidence band between rounds, streaming one
        `partial` doc per completed round to the subscribers.

        Deadline handling is COOPERATIVE, not an engine downgrade:
        when the request deadline expires at a round boundary, the
        tightest band reached so far IS the answer — returned as a
        `partial_final` record with a `precision:band=<w>@round=<r>`
        degrade hop. The hop makes the result degraded, so the
        existing cache guard keeps it out of the persistent cache;
        converged runs (band under tolerance, or the full schedule —
        which is bit-identical to the one-shot sampled run) return
        undegraded and cache under the normal fingerprint."""
        from ..sampler.sampled import run_sampled_progressive

        deadline = (
            None if request.deadline_s is None
            else time.perf_counter() + request.deadline_s
        )
        v2 = request.runtime == "v2"

        def should_stop() -> bool:
            return (deadline is not None
                    and time.perf_counter() >= deadline)

        def on_round(info) -> None:
            self._count("partials_emitted")
            self._fire_partial(fingerprint, {
                "partial": True,
                "round": info["round"],
                "rounds_total": info["rounds_total"],
                "band_width": float(info["band_width"]),
                "converged": bool(info["converged"]),
                "mrc_digest": obs_ledger.mrc_digest(info["mrc"]),
                "mrc_len": int(len(info["mrc"])),
                "mrc_lines": report.mrc_lines(
                    info["mrc"], header=False
                ),
            })

        attrs = {"engine": "sampled", "program": program.name,
                 "progressive": True}
        if trace_id is not None:
            attrs["trace_id"] = trace_id
        if span_id is not None:
            attrs["span_id"] = span_id
        try:
            with telemetry.span("service_exec", **attrs):
                faults.fire("engine_execute", key=fingerprint,
                            engine="sampled", model=program.name)
                state, results, info = run_sampled_progressive(
                    program, machine, sampler_config(request), v2=v2,
                    on_round=on_round, should_stop=should_stop,
                    fault_key=fingerprint, device=self._scope_device(),
                )
                record = build_record(
                    request, machine, "sampled", fingerprint,
                    _sampled_namespace(state, results), results,
                )
        except Exception as e:
            return None, [], repr(e), None
        degraded: list[dict] = []
        prog = {
            "rounds": info["rounds"],
            "band_width": info["band_width"],
            "converged": info["converged"],
        }
        if info["stopped"] == "deadline":
            # NOT an engine downgrade: sampled answered, just at a
            # looser precision than a full schedule would have
            prog["partial_final"] = True
            self._count("partial_final")
            self._note_degrade(
                degraded, fingerprint, "sampled", "sampled",
                "precision:band={:.4g}@round={}".format(
                    info["band_width"], info["rounds"],
                ),
            )
        else:
            self._count("progressive_converged")
        if meta is not None:
            meta["progressive"] = prog
        return record, degraded, None, None

    def _run_chain(self, request, program, machine, fingerprint,
                   trace_id: str | None = None,
                   span_id: str | None = None,
                   meta: dict | None = None):
        """Walk the degradation chain under the request deadline.
        Returns (record|None, degraded events, error|None,
        replica_id|None — the replica that served the successful
        attempt). `meta` collects resilience bookkeeping (retries,
        hedged) for the outcome/ledger row.

        Per engine: the circuit breaker gates the attempt (open =
        skip down the chain for free), then up to 1 + max_retries
        attempts run under the per-attempt budget — the request
        deadline on non-final engines (the pre-resilience behavior),
        tightened everywhere by the opt-in attempt_timeout_s. Retry
        backoff is deterministic (runtime/faults.py::backoff_delay —
        seeded jitter keyed by (fingerprint, engine, attempt), so a
        chaos replay waits the same milliseconds). An attempt TIMEOUT
        never trips the breaker: the abandoned thread may still be
        computing a perfectly good answer; only raised failures
        count."""
        if progressive_requested(request):
            return self._run_progressive(
                request, program, machine, fingerprint,
                trace_id=trace_id, span_id=span_id, meta=meta,
            )
        chain = degrade_chain(request.engine)
        deadline = (
            None if request.deadline_s is None
            else time.perf_counter() + request.deadline_s
        )
        degraded: list[dict] = []
        last_error = None
        res = self._resilience
        for i, engine in enumerate(chain):
            is_last = i == len(chain) - 1
            remaining = (
                None if deadline is None
                else deadline - time.perf_counter()
            )
            if remaining is not None and remaining <= 0 and not is_last:
                # budget already spent: jump toward the cheapest
                # engine rather than starting one we would abandon
                self._note_degrade(
                    degraded, fingerprint, engine, chain[i + 1],
                    "deadline exhausted before attempt",
                )
                continue
            br = self._breaker(engine)
            if not br.allow():
                # fail fast past a repeatedly-failing engine: no
                # attempt budget burned, no side thread spawned
                self._count("breaker_open_skips")
                telemetry.event("service_breaker_open_skip",
                                engine=engine, fingerprint=fingerprint)
                reason = f"engine {engine!r} circuit breaker open"
                if is_last:
                    return None, degraded, last_error or reason, None
                self._note_degrade(
                    degraded, fingerprint, engine, chain[i + 1], reason
                )
                continue
            attempt = 0
            fail_reason = None
            while True:
                remaining = (
                    None if deadline is None
                    else deadline - time.perf_counter()
                )
                if (remaining is not None and remaining <= 0
                        and not is_last):
                    fail_reason = (
                        f"deadline {request.deadline_s}s overrun"
                    )
                    break
                budget = (
                    remaining
                    if remaining is not None and not is_last
                    else None
                )
                if res.attempt_timeout_s is not None:
                    budget = (
                        res.attempt_timeout_s if budget is None
                        else min(budget, res.attempt_timeout_s)
                    )
                # which bound would an overrun have hit? the request
                # deadline means degrade (retrying cannot help); the
                # attempt timeout means the attempt was slow and a
                # retry may land on a healthier replica
                deadline_limited = (
                    remaining is not None
                    and not is_last
                    and (budget is None or budget >= remaining)
                )
                try:
                    if budget is None:
                        record, rid, events = self._execute_routed(
                            lambda eng=engine: execute_request(
                                request, program, machine, eng,
                                fingerprint, self.runner,
                                trace_id=trace_id, span_id=span_id,
                            ),
                            trace_id=trace_id, meta=meta,
                        )
                    else:
                        hit = self._attempt_with_timeout(
                            request, program, machine, engine,
                            fingerprint, budget, trace_id=trace_id,
                            span_id=span_id, meta=meta,
                        )
                        if hit is None:
                            raise _AttemptTimeout()
                        record, rid, events = hit
                except _AttemptTimeout:
                    if deadline_limited:
                        fail_reason = (
                            f"deadline {request.deadline_s}s overrun"
                        )
                        break
                    last_error = fail_reason = (
                        f"attempt timeout {res.attempt_timeout_s}s "
                        f"overrun on {engine!r}"
                    )
                except Exception as e:
                    last_error = repr(e)
                    fail_reason = f"engine failed: {last_error[:200]}"
                    telemetry.count("service_exec_failed")
                    if br.failure():
                        self._count("breaker_opened")
                        telemetry.event(
                            "service_breaker_opened", engine=engine,
                            fingerprint=fingerprint,
                        )
                else:
                    if br.success():
                        self._count("breaker_reclosed")
                        telemetry.event(
                            "service_breaker_reclosed", engine=engine
                        )
                    self._absorb_replica_events(
                        degraded, events, fingerprint
                    )
                    return record, degraded, None, rid
                if attempt >= res.max_retries:
                    break
                delay = faults.backoff_delay(
                    attempt, res.backoff_base_s, res.backoff_max_s,
                    res.backoff_seed, fingerprint, engine,
                )
                if deadline is not None and (
                    deadline - time.perf_counter() - delay <= 0
                ):
                    break  # no budget left to retry into
                time.sleep(delay)
                attempt += 1
                self._count("retried")
                if meta is not None:
                    meta["retries"] = meta.get("retries", 0) + 1
            if is_last:
                return (
                    None, degraded,
                    last_error or fail_reason or "no engine attempted",
                    None,
                )
            self._note_degrade(
                degraded, fingerprint, engine, chain[i + 1],
                fail_reason or "engine failed",
            )
        return None, degraded, last_error or "no engine attempted", None

    def _attempt_with_timeout(self, request, program, machine, engine,
                              fingerprint, budget_s: float,
                              trace_id=None, span_id=None,
                              meta: dict | None = None):
        """Run one attempt in a side thread and wait at most budget_s.
        None = overrun (the attempt thread is abandoned; Python offers
        no preemption, so its work completes unobserved). On success
        returns (record, replica_id|None, re-route events)."""
        box: dict = {}

        def target():
            try:
                box["result"] = self._execute_routed(
                    lambda: execute_request(
                        request, program, machine, engine,
                        fingerprint, self.runner,
                        trace_id=trace_id, span_id=span_id,
                    ),
                    trace_id=trace_id, meta=meta,
                )
            except Exception as e:
                box["error"] = e

        t = threading.Thread(
            target=target, daemon=True,
            name=f"pluss-service-attempt-{engine}",
        )
        t.start()
        t.join(budget_s)
        if t.is_alive():
            self._count("deadline_abandoned")
            return None
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _note_degrade(self, degraded, fingerprint, from_engine,
                      to_engine, reason: str) -> None:
        info = {
            "from": from_engine,
            "to": to_engine,
            "reason": reason,
        }
        degraded.append(info)
        # counted per REQUEST at completion (in _process /
        # _solo_fallback), not per chain step, so all three counter
        # surfaces agree on what "degraded" means: requests that
        # completed degraded. The per-step detail stays in the event.
        telemetry.event(
            "service_degraded", fingerprint=fingerprint, **info
        )
