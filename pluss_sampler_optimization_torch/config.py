"""Runtime configuration.

Replaces the reference's compile-time `-D` macros
(`-DTHREAD_NUM=4 -DCHUNK_SIZE=4 -DDS=8 -DCLS=64`, c_lib/test/Makefile:15)
and the per-module Rust consts (src/gemm_sampler.rs:27-30,
src/chunk_dispatcher.rs:18, src/utils.rs:10-11) with one runtime object.

`MachineConfig` and `SLOConfig` (the burn-rate sentinel's objectives,
runtime/obs/slo.py) are copies of the JAX package's. `SamplerConfig`
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
