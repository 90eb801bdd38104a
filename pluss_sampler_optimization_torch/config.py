"""Runtime configuration.

Replaces the reference's compile-time `-D` macros
(`-DTHREAD_NUM=4 -DCHUNK_SIZE=4 -DDS=8 -DCLS=64`, c_lib/test/Makefile:15)
and the per-module Rust consts (src/gemm_sampler.rs:27-30,
src/chunk_dispatcher.rs:18, src/utils.rs:10-11) with one runtime object.

`MachineConfig` is a copy of the JAX package's. `SamplerConfig` keeps
the fields this port runs; knobs of engines it does not run yet stay out
until the slice that ports them.
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


KERNEL_BACKENDS = ("auto", "cuda", "torch")


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
    # Draw sample keys on the device instead of with numpy on the host.
    # None and False take the host numpy stream, whose sample sets are
    # bit-identical to the JAX package's host stream; True is not
    # ported yet and raises (ROADMAP A3).
    device_draw: bool | None = None
    # Which classify+histogram implementation the sampled engine's hot
    # loop runs: "cuda" (the hand-written kernel,
    # csrc/sampled_hist.cu), "torch" (its plain tensor version), or
    # None/"auto": "cuda" for tensors on a CUDA device, "torch" on the
    # CPU. Every backend folds to bit-identical PRIStates/MRCs.
    kernel_backend: str | None = None

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

