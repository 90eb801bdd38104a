"""Runtime configuration.

Replaces the reference's compile-time `-D` macros
(`-DTHREAD_NUM=4 -DCHUNK_SIZE=4 -DDS=8 -DCLS=64`, c_lib/test/Makefile:15)
and the per-module Rust consts (src/gemm_sampler.rs:27-30,
src/chunk_dispatcher.rs:18, src/utils.rs:10-11) with one runtime object.

`MachineConfig`, `SLOConfig` (the burn-rate sentinel's objectives,
runtime/obs/slo.py), and the service's `BatchConfig`, `ResilienceConfig`
and `FaultConfig` (with FAULT_SITES and FAULT_KINDS) are copies of the
JAX package's; `ReplicaConfig` is too, but for its docstring, which
names the port's devices. `SamplerConfig`
keeps the fields this port runs; knobs of engines it does not run yet
stay out until the slice that ports them.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MachineConfig:
    """Parameters of the *modeled* parallel machine.

    Attributes:
      thread_num: number of simulated OpenMP threads whose interleaving the
        sampler models (THREAD_NUM, c_lib/test/Makefile:15). These are
        modeled threads, not execution threads.
      chunk_size: static-scheduling chunk size in iterations of the
        parallel loop (CHUNK_SIZE, Makefile:15).
      ds: data size in bytes of one array element (DS, Makefile:15).
      cls: cache line size in bytes (CLS, Makefile:15).
      cache_kb: LRU cache capacity in KB used by the AET->MRC stage
        (POLYBENCH_CACHE_SIZE_KB 2560, c_lib/test/runtime/pluss.cpp:9-11;
        cache lines = cache_kb*1024/ds, pluss_utils.h:785).
    """

    thread_num: int = 4
    chunk_size: int = 4
    ds: int = 8
    cls: int = 64
    cache_kb: int = 2560

    @property
    def lines_per_element_block(self) -> int:
        """Array elements per cache line (CLS/DS = 8 by default)."""
        return self.cls // self.ds

    @property
    def cache_lines(self) -> int:
        """Cache capacity in units the AET loop uses (pluss_utils.h:785)."""
        return self.cache_kb * 1024 // self.ds

    def __post_init__(self) -> None:
        if self.cls % self.ds != 0:
            raise ValueError("cls must be a multiple of ds")
        if self.thread_num < 1 or self.chunk_size < 1:
            raise ValueError("thread_num and chunk_size must be >= 1")


KERNEL_BACKENDS = ("auto", "cuda", "torch", "native")


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Parameters of the random-start sampling variant.

    The reference bakes these into generated code
    (c_lib/test/sampler/gemm-t4-pluss-pro-model-rs-ri-opt-r10.cpp:132-133,
    156: "random start sampling with ratio 10%", `num_samples = 2098`).

    num_samples per reference follows ceil((ratio * trip)^depth) where
    depth is the loop depth of the reference: at N=128, ratio=0.1 this
    reproduces the generated constants 2098 = ceil(12.8^3) (3-deep refs,
    r10 :156) and 164 = ceil(12.8^2) (2-deep refs, r10 :1688).

    exclude_last_iteration replicates the generated sampling expression
    `rand()%(((128-0)/1-((128-0)%1==0)))` (r10 :159), which draws from
    [0, trip-1) — the final iteration of each loop is never sampled when
    step divides the range evenly. Kept (default True) for parity with the
    reference; set False for uniform coverage.
    """

    ratio: float = 0.1
    seed: int = 0
    exclude_last_iteration: bool = True
    # Draw sample keys on the device (sampler/draw.py: jax.random's
    # threefry streams, on kernel B3) instead of with numpy on the host.
    # None = auto, as in the JAX package: the device draw on a CUDA
    # device, the host draw on the CPU. True and False force one. Each
    # draw's sample sets are bit-identical to the JAX package's same
    # draw; the two draws give different (statistically equivalent)
    # sample sets, and the device draw's depend on the batch.
    device_draw: bool | None = None
    # Which kernels the sampled engines run: "cuda" (the hand-written
    # kernels: csrc/sampled_hist.cu for the classify of run_sampled, of
    # the progressive rounds and of the sharded engine's shards (its
    # raw-noshare form there), csrc/pow2_hist.cu for the sharded
    # engine's pow2 histogram of the gathered pairs,
    # csrc/threefry_draw.cu for the device draw's streams), "torch"
    # (plain tensor code: sampled_hist_plain, the sharded engine's plain
    # classify with exp_hist and fixed_k_unique as in the JAX package,
    # sampler/threefry.py's streams), "native" (the sampled engine's
    # CPU route: the plain classify reduced by the native library's C++
    # pass, native/; it raises off the CPU), or None/"auto": "cuda" on a
    # CUDA device, "torch" on the CPU. Every backend draws the same
    # sample sets and folds to bit-identical PRIStates/MRCs.
    kernel_backend: str | None = None
    # Cross-ref fused dispatch: refs sharing a kernel-signature bucket
    # (sampler/sampled.py::_kernel_sig) stack along a leading ref axis and
    # classify in one dispatch per span instead of one per ref. Results
    # are bit-identical to the per-ref runner (the pair reductions are
    # exact and the per-ref seeds unchanged), so this is a pure dispatch
    # knob; False keeps the serial per-ref runner as the parity oracle.
    # None = auto, as in the JAX package: on for a CUDA device, off on
    # the CPU.
    fuse_refs: bool | None = None
    # Depth bound of the dispatch pipeline: how many dispatches may be in
    # flight, their small outputs copying back, before the host drains
    # the oldest. Each in-flight dispatch keeps its residual and inputs
    # alive on the device. A forced drain counts as `pipeline_stalls`.
    pipeline_depth: int = 4
    # Progressive-precision knobs (sampler/sampled.py::
    # run_sampled_progressive + sampler/confidence.py). The engine
    # splits the FINAL ratio's per-ref sample stream into prefix
    # rounds; after every round a seeded bootstrap over the per-ref
    # round sub-histograms yields an MRC confidence band. tolerance:
    # stop early once the band's max width is <= this (None = run the
    # whole schedule). round_schedule: increasing fractions of the
    # final per-ref sample count, last entry 1.0 (None = geometric
    # doubling over max_rounds). max_rounds: schedule length when
    # round_schedule is None (None = DEFAULT_MAX_ROUNDS). Because the
    # rounds are prefix slices of the SAME seed-derived stream, a run
    # that completes its schedule folds to MRC bytes bit-identical to
    # the one-shot sampled run at cfg.ratio — so, like fuse_refs/
    # pipeline_depth, these knobs stay OUT of the checkpoint tag.
    tolerance: float | None = None
    max_rounds: int | None = None
    round_schedule: tuple | None = None

    def __post_init__(self) -> None:
        kb = self.kernel_backend
        if kb is not None and kb not in KERNEL_BACKENDS:
            raise ValueError(
                f"kernel_backend must be one of {KERNEL_BACKENDS}, "
                f"got {kb!r}"
            )

    def num_samples(self, trips) -> int:
        import math

        if isinstance(trips, int):
            trips = (trips,)
        prod = 1.0
        space = 1
        for t in trips:
            prod *= self.ratio * t
            space *= max(1, t - 1 if self.exclude_last_iteration else t)
        return max(1, min(int(math.ceil(prod)), space))


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Service-level objectives evaluated by the burn-rate sentinel
    (runtime/obs/slo.py) over the live metrics registry's rolling
    windows and the ledger tail.

    Burn-rate semantics (the SRE multi-window formulation): each
    objective defines a budget — the fraction of requests allowed to
    violate it. The observed violation fraction divided by the budget
    is the burn rate (1.0 = consuming budget exactly as fast as
    allowed); a breach fires only when the burn rate exceeds
    `burn_rate_threshold` in BOTH the short and the long window, so a
    single slow request can't page anyone but a sustained regression
    fires within one short window.

    Attributes:
      latency_p95_s: total-latency objective — at most
        `latency_budget` of requests may take longer than this.
        None disables the latency check.
      latency_budget: allowed slow fraction for the latency objective
        (0.05 makes `latency_p95_s` a true p95 bound).
      error_budget: allowed fraction of requests that fail or complete
        degraded.
      burn_rate_threshold: multi-window burn-rate trip point.
      min_batch_occupancy: breach when the ledger's batch occupancy
        p50 falls below this (None disables; only meaningful under a
        batched workload).
      windows: (short, long) rolling-window labels, matching the
        registry's ring windows.
    """

    latency_p95_s: float | None = None
    latency_budget: float = 0.05
    error_budget: float = 0.01
    burn_rate_threshold: float = 1.0
    min_batch_occupancy: float | None = None
    windows: tuple = ("30s", "5m")

    def __post_init__(self) -> None:
        if self.latency_p95_s is not None and self.latency_p95_s <= 0:
            raise ValueError("latency_p95_s must be > 0")
        if not (0 < self.latency_budget <= 1):
            raise ValueError("latency_budget must be in (0, 1]")
        if not (0 < self.error_budget <= 1):
            raise ValueError("error_budget must be in (0, 1]")
        if self.burn_rate_threshold <= 0:
            raise ValueError("burn_rate_threshold must be > 0")
        if len(self.windows) != 2:
            raise ValueError("windows must be (short, long)")


@dataclasses.dataclass(frozen=True)
class BatchConfig:
    """Admission-window parameters of the service's cross-request
    batching scheduler (service/executor.py::BatchScheduler).

    Pure scheduling knobs: batching changes WHICH dispatches run, never
    what any member computes — every member's MRC is bit-identical to
    its solo run (sampler/sampled.py::sampled_outputs_multi), so like
    fuse_refs/pipeline_depth these stay OUT of the request fingerprint.

    Attributes:
      window_ms: how long the first request of a forming batch may wait
        for compatible companions before the batch flushes. 0 still
        batches whatever arrived together but never waits.
      max_refs: flush early once the batch's summed tracked-ref count
        reaches this bound; a later overflow request starts the next
        batch (overflow splitting).
    """

    window_ms: float = 5.0
    max_refs: int = 64

    def __post_init__(self) -> None:
        if self.window_ms < 0:
            raise ValueError("window_ms must be >= 0")
        if self.max_refs < 1:
            raise ValueError("max_refs must be >= 1")


@dataclasses.dataclass(frozen=True)
class ReplicaConfig:
    """Device partitioning of the serving replica pool
    (service/replicas.py::ReplicaPool).

    The pool splits its devices (every visible card by default; a
    device may repeat, so ["cuda:0", "cuda:0"] makes two replicas on
    one card and ["cpu"] * 4 four on the CPU) into `count` disjoint
    device groups; each replica owns its group, a per-replica mesh
    (parallel/mesh.py::build_mesh over just those devices), and an
    execution slot. Like BatchConfig this is a pure scheduling knob:
    engine placement moves WHERE a request runs, never what it
    computes — the per-ref sample streams are seed-derived, so MRC
    bytes are bit-identical for any replica count (the invariant
    tests/test_replicas.py pins at counts 1/2/4) and `count` stays OUT
    of the request fingerprint.

    Attributes:
      count: number of replicas. None or 0 = auto, one replica per
        device. A count above the device count clamps down (a replica
        needs at least one device).
    """

    count: int | None = None

    def __post_init__(self) -> None:
        if self.count is not None and self.count < 0:
            raise ValueError("replica count must be >= 0 (0 = auto)")

    def resolve(self, n_devices: int) -> int:
        """Actual replica count for a machine with n_devices."""
        if n_devices < 1:
            raise ValueError("need at least one device")
        if not self.count:  # None or 0: one replica per device
            return n_devices
        return min(self.count, n_devices)


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Failure-handling policy of the request executor
    (service/executor.py) and the replica pool (service/replicas.py).

    Everything here is serving policy — retries, hedges, breakers, and
    admission control move WHEN and WHERE a request runs, never what
    it computes (retried/hedged results are seed-derived and therefore
    bit-identical to the first attempt; tools/check_chaos.py pins
    this) — so none of these knobs enter the request fingerprint.

    Attributes:
      attempt_timeout_s: per-attempt execution budget. An attempt that
        outlives it is abandoned (deadline_abandoned) and retried or
        degraded; None leaves only the request deadline in force.
      max_retries: bounded same-engine retries after a failed or
        timed-out attempt (0 = the pre-chaos behavior: fall straight
        down the degrade chain).
      backoff_base_s / backoff_max_s: exponential backoff bounds
        between retries. The jitter is SEEDED (runtime/faults.py::
        backoff_delay, a counter-hash construction), never wall-clock
        derived — tools/lint_determinism.py enforces this.
      backoff_seed: seed of that jitter stream.
      hedge_after_s: straggler bound — a routed execution still
        unresolved after this long is hedged onto a second replica;
        first result wins, the queued loser is cancelled. None
        disables hedging (and it is implicitly off without a pool of
        at least two replicas).
      breaker_failures: consecutive engine-attempt failures that open
        an engine's circuit breaker (service/breakers.py). Open
        breakers fail fast / degrade instead of burning an attempt.
      breaker_probation_s: how long a breaker stays open before
        half-open probation admits ONE probe; a probe failure re-opens
        with the probation escalated (x `breaker_escalation`, capped
        at `breaker_probation_max_s`). Also the replica pool's
        quarantine probation: a quarantined replica re-enters service
        through the same half-open probe cycle.
      breaker_escalation / breaker_probation_max_s: the escalation
        factor and cap above.
      queue_limit: admission bound on queued-not-yet-executing
        requests. None = unbounded (no admission control).
      shed_enabled: when a queue_limit is set, shed early at submit
        with a structured `shed` response instead of queueing past the
        limit. False keeps the limit visible in stats but never sheds
        (the chaos gate's collapse baseline).
    """

    attempt_timeout_s: float | None = None
    max_retries: int = 0
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    backoff_seed: int = 0
    hedge_after_s: float | None = None
    breaker_failures: int = 8
    breaker_probation_s: float = 30.0
    breaker_escalation: float = 2.0
    breaker_probation_max_s: float = 300.0
    queue_limit: int | None = None
    shed_enabled: bool = True

    def __post_init__(self) -> None:
        if (self.attempt_timeout_s is not None
                and self.attempt_timeout_s <= 0):
            raise ValueError("attempt_timeout_s must be > 0")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_base_s < 0 or self.backoff_max_s < 0:
            raise ValueError("backoff bounds must be >= 0")
        if self.hedge_after_s is not None and self.hedge_after_s <= 0:
            raise ValueError("hedge_after_s must be > 0")
        if self.breaker_failures < 1:
            raise ValueError("breaker_failures must be >= 1")
        if self.breaker_probation_s <= 0:
            raise ValueError("breaker_probation_s must be > 0")
        if self.breaker_escalation < 1:
            raise ValueError("breaker_escalation must be >= 1")
        if self.queue_limit is not None and self.queue_limit < 1:
            raise ValueError("queue_limit must be >= 1")


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """Connection-health policy of the multi-process serving fabric
    (service/fabric/): the router<->worker heartbeat cadence, the
    bounded reconnect schedule, and the drain budget.

    Everything here is transport policy — it moves WHEN a request
    frame travels and how quickly a dead worker is declared, never
    what any worker computes: re-dispatched requests are re-submitted
    byte-identically (the raw request line is what travels), so MRC
    bytes and fingerprints are bit-identical whatever these knobs say
    (tests/test_fabric.py pins 1-vs-N-worker identity).

    Attributes:
      hb_interval_s: how often the router pings each worker link (and
        the bound on how long a healthy link stays silent — pongs
        count as traffic).
      hb_timeout_s: a link with no received frame for this long is
        treated as failed and enters the reconnect schedule.
      reconnect_attempts: bounded reconnects after a link failure;
        exhausting them declares the worker DEAD and re-dispatches
        its in-flight requests to the ring successor.
      reconnect_delay_s: pause between reconnect attempts.
      connect_timeout_s: TCP connect/handshake budget per attempt.
      drain_timeout_s: graceful-shutdown bound — how long the router
        waits for in-flight responses (and workers for in-flight
        executions) before giving up the drain.
      ring_vnodes: virtual nodes per worker on the consistent-hash
        ring (service/fabric/ring.py).
      trace_enabled: attach trace blocks to request frames, measure
        per-request wire/worker spans, and append router-side ledger
        rows. Pure observability — toggling it never changes MRC
        bytes or fingerprints (pinned in tests/test_fabric.py).
      stats_interval_s: how often the router polls each worker's
        telemetry snapshot over a `stats` frame (feeds the merged
        fleet stats/metrics view and the fleet SLO sentinel).
    """

    hb_interval_s: float = 2.0
    hb_timeout_s: float = 10.0
    reconnect_attempts: int = 3
    reconnect_delay_s: float = 0.2
    connect_timeout_s: float = 10.0
    drain_timeout_s: float = 60.0
    ring_vnodes: int = 64
    trace_enabled: bool = True
    stats_interval_s: float = 5.0

    def __post_init__(self) -> None:
        if self.hb_interval_s <= 0:
            raise ValueError("hb_interval_s must be > 0")
        if self.hb_timeout_s < self.hb_interval_s:
            raise ValueError(
                "hb_timeout_s must be >= hb_interval_s (a healthy "
                "link is only guaranteed one frame per interval)"
            )
        if self.reconnect_attempts < 0:
            raise ValueError("reconnect_attempts must be >= 0")
        if self.reconnect_delay_s < 0:
            raise ValueError("reconnect_delay_s must be >= 0")
        if self.connect_timeout_s <= 0:
            raise ValueError("connect_timeout_s must be > 0")
        if self.drain_timeout_s <= 0:
            raise ValueError("drain_timeout_s must be > 0")
        if self.ring_vnodes < 1:
            raise ValueError("ring_vnodes must be >= 1")
        if self.stats_interval_s <= 0:
            raise ValueError("stats_interval_s must be > 0")


# Sites and kinds the fault injector (runtime/faults.py) understands.
# Declared here so FaultConfig can validate a spec without importing
# the runtime layer.
FAULT_SITES = ("engine_execute", "replica_dispatch", "cache_load",
               "cache_store", "serve_line", "worker_conn",
               "worker_exec", "round_exec")
FAULT_KINDS = ("raise", "latency", "hang", "corrupt", "compile_failure",
               "disconnect")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """A deterministic chaos scenario: (seed, rules) fully determine
    every injection decision (runtime/faults.py draws a counter-hash
    uniform per (site, key, occurrence) — a threefry-style counter
    construction — so a chaos run replays exactly from this object).

    Each rule is a mapping with:
      site: one of FAULT_SITES (where the fault fires)
      kind: one of FAULT_KINDS (what happens)
      p: firing probability per occurrence (default 1.0)
      max_fires: cap per (rule, key) — e.g. "fail only the first
        attempt of each request" (0 = unlimited)
      match: {ctx-field: value} equality filter on the site's context
        (e.g. {"engine": "sampled"})
      latency_s / hang_s: sleep durations for those kinds
      message: raise text override

    CLI: `--fault-spec FILE` loads a JSON document
    {"seed": N, "rules": [...]} (runtime/faults.py::load_spec).
    """

    seed: int = 0
    rules: tuple = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "rules", tuple(self.rules))
        for i, rule in enumerate(self.rules):
            if not isinstance(rule, dict):
                raise ValueError(f"rules[{i}] must be an object")
            site = rule.get("site")
            if site not in FAULT_SITES:
                raise ValueError(
                    f"rules[{i}].site {site!r} unknown "
                    f"(have {', '.join(FAULT_SITES)})"
                )
            kind = rule.get("kind")
            if kind not in FAULT_KINDS:
                raise ValueError(
                    f"rules[{i}].kind {kind!r} unknown "
                    f"(have {', '.join(FAULT_KINDS)})"
                )
            p = rule.get("p", 1.0)
            if not isinstance(p, (int, float)) or not 0 <= p <= 1:
                raise ValueError(f"rules[{i}].p must be in [0, 1]")
            mf = rule.get("max_fires", 0)
            if not isinstance(mf, int) or mf < 0:
                raise ValueError(
                    f"rules[{i}].max_fires must be an int >= 0"
                )
            match = rule.get("match", {})
            if not isinstance(match, dict):
                raise ValueError(f"rules[{i}].match must be an object")
