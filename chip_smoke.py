#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py            # GEMM N=2048, ratio 0.1, seed 0
    python3 chip_smoke.py --n 256 --tri-n 256   # quicker (no baselines)
    python3 chip_smoke.py --scaling-only   # the fused sharded form, 1..all cards
    python3 chip_smoke.py --exact-only     # the exact engines (phase 17)
    python3 chip_smoke.py --frontend-only  # the frontend (phase 18)
    python3 chip_smoke.py --obs-only       # observability (phase 19)
    python3 chip_smoke.py --serve-only     # the analysis service (phase 20)

SamplerConfig() resolves to the device draw on the card (threefry on
kernel B3), as the JAX package's auto does on an accelerator. Phases,
each printing its own lines; any failure exits non-zero:

1. card: the name and power limit nvidia-smi reports;
2. build: csrc/sampled_hist.cu (kernel B1, two parts), csrc/pow2_hist.cu
   (kernel B2) and csrc/threefry_draw.cu (kernel B3) for sm_90a, every
   nvcc started together, and csrc/sampled_hist_buf.cu (B1's buffer and
   per-row forms, three parts) beside them, left building until phase
   18 needs it; build seconds, and ptxas' registers, stack frame and spill
   bytes for every kernel instantiation (B1 has 12,
   sampled_hist_kernel<LV, NHMAX, TRI>: source-ref level 0-2 by most
   band-plan heads per sink group, 1 for at most one, 3 for up to
   three, by rectangular or triangular nest, each taking the launch flag
   of its raw-noshare form, 6 of the buffer form,
   sampled_hist_kernel_buf<LV, TRI>, and 12 of the per-row form,
   sampled_hist_kernel_rows<LV, NHMAX, TRI>, the buffer form's library
   built in three parts at once; B2 has 2, pow2_hist_kernel<BOOL_W> for
   bool and int64 weights; B3 has 16, randint_kernel<KIND, EDGE> by the
   span's remainder record (0 a power of two, 1 above 2^32, 2 below it),
   randint_rows_kernel<KIND, EDGE> (a span per row) and
   bits_kernel<EDGE, MASK>), with each B3 instantiation's SASS
   instructions per pipe (cuobjdump); B3 must have 0 B stack and spills;
2b. cold and warm: the first run of this process at GEMM --n (the CUDA
   context, module loads, first launches) beside a fresh process that
   calls sampler/sampled.py::warmup and then runs twice; then warmup for
   every program of the timed runs below;
3. B2 vs plain on made inputs: a numpy-seeded 2^20 input over all 64
   bins (0, negatives and 2^62-1 included) with bool and with int
   weights, the same as misaligned views (values[1:], weights[3:]),
   tiny inputs (1 and 17 elements), and a same-bin weight total of
   exactly 2^31; bit-equal;
4. B3 vs plain on made inputs: both entries on made keys, 1 and 3 rows
   of 1, 17, 1023, 1026, 2^14+3 and 2^20 elements (ragged rows and whole
   blocks), spans of every remainder kind (B3_MADE_SPANS: 1, 2, 3,
   2^32-1, 2^32, 2^32+1, 2^45-1, 2^46, primes, and the GEMM-2048 and
   syrk-tri N=1536 boxes), bits with and without a valid mask, a mask
   one byte off alignment, and columns cut into several launches (a
   small SEGMENT); bit-equal;
5. B1 vs plain: every dispatch of the main path (the engine's own
   plan_dispatches: its device-drawn keys, chosen masks and column
   spans) through the CUDA kernel and through its plain torch version
   on the card; residual, hist, cold and the sorted pair outputs must be
   equal; both are timed with CUDA events, and each dispatch's
   instantiation is printed. The draws of that run are recorded. Then
   the same for B1's raw-noshare form ("raw kernels:" lines): residual
   bit-equal to plain, histogram all zero, cold equal;
6. B3 vs plain on every draw of the main path (the engine's own keys,
   B, R and span, and its valid masks); bit-equal; timed per run,
   randint and bits apart, as torch.profiler device time (CUDA events
   where the trace records none) beside the plain version's CUDA-event
   time and the bound by bytes and by the operations the streams need
   per pipe (B3_BLOCK), the built code's SASS counts per pipe (the
   instantiation each call takes) beside it. The headline's and
   syrk-tri's draws (phases 8 and 13) are held and timed the same way;
6b. the draw span broken down: one draw of every bucket of GEMM --n
   (2048) and 2*--n (4096) through the engine (draw_bucket_keys_device)
   under torch.profiler, each step's device time from its profiler
   range in sampler/draw.py (draw.STEPS: B3 randint, the keys' sort,
   the neighbour compare, B3 bits, the priorities' sort, the threshold
   select, the host read), the draw checked equal to the same draw
   without the profiler;
7. main path, device draw: run_sampled -> cri_distribute -> aet_mrc on
   the card, once with kernel_backend "cuda" (B3 + B1) and once with
   "torch" (plain draw and classify), each with its host seconds per
   stage (cri and aet included). The "cuda" run must launch B1 once per
   dispatch of phase 5 and B3 as often as phase 5's draw, the "torch"
   run neither, neither launches B2; both folded PRIStates and MRC bytes
   must be equal, and the MRC's L1 error against
   baselines/gemm<N>.json.gz must be at most 0.01;
8. headline, device draw: one "cuda" run at GEMM N=2*--n (4096),
   with wall, spans, launches and the MRC L1 error against
   baselines/gemm4096.json.gz (at most 0.01); its B3 calls held
   against plain and timed as in phase 6;
8b. the dispatch pipeline at the headline: pipeline_depth 1 and 4, each
   with its spans, pipeline_stalls and the seconds in the device draw's
   host reads, and under torch.profiler the device's idle share inside
   the "dispatch" span; states and MRC bytes equal the headline's, MRC L1
   error printed; then the serial runner (fuse_refs=False) at --n, equal
   to the main path, B1 once per dispatch;
8c. the raw route (runtime v2, the r10 distribute) at --n with "cuda"
   and "torch": equal v2 PRIStates and --r10 lines, the v1 fold of the
   raw results equal to the main path's state, B1 once per raw dispatch
   of 5;
8d. checkpoints at --n in a temporary directory: a full run, a resume
   with the second member of the first two-member bucket de-checkpointed
   (that member alone dispatches), a fully checkpointed rerun (nothing
   dispatches); every state and MRC equal to the main path's;
9. host-draw path: the same two runs at GEMM N=--n/2 (1024) with
   device_draw=False: equal states and MRC bytes, L1 against
   baselines/gemm1024.json.gz at most 0.01;
10. sharded path, device draw, over build_mesh() (every visible card):
   sampled_outputs_sharded and fold_results at GEMM --n in the fused
   form (the default on CUDA), counted and recorded, then again under
   torch.profiler (spans, wall, the device's busy share). B1 (its raw
   form) must launch once per shard per bucket step, B2 once per member
   row of each mesh reduction (the histogram of the gathered noshare
   pairs, int64 weights), B3 as often as the main path's draw; one read
   back per reduction; the folded PRIState and MRC bytes must equal the
   main path's, and each ref's pow2 histogram the pow2 binning of its
   exact noshare pairs. Then the per-ref (scan) form (fuse_refs=False):
   one read back per ref plus regrows, equal state. Every B1 launch of
   both runs (each shard's keys, mask, column span and rx) is held
   bit-equal against the plain raw form on the card and timed beside its
   bound ("sharded kernels:" lines). Then the fused form at GEMM --n/2
   (1024) with "cuda" and "torch" (the JAX package's own route: plain
   classify, exp_hist, fixed_k_unique): equal per-ref results, dense
   histograms, states and MRC bytes;
11. B2 vs plain on the sharded path's own inputs (every launch's
   max(ri, 1) and int64 count weights, recorded during phase 10);
   bit-equal; how many bins each launch fills; kernel, plain version and
   the torch.searchsorted + torch.bincount yardstick timed per run, as
   device time from torch.profiler and as CUDA events around the calls
   (host-bound for the kernel: its wrapper's cost per call); the
   kernel's trace must hold no device operation but the kernel;
11b. the headline through the sharded engine's fused form, GEMM 2*--n
   (4096): state and MRC bytes equal phase 8's, MRC L1 error against
   baselines/gemm4096.json.gz at most 0.01; wall and spans;
11c. scaling: the fused form at GEMM --n and 2*--n over 1, 2, ... every
   visible card that divides the batch, a first run then the timed one,
   wall time beside the card count, states equal; with two or more cards
   every B1 launch of the widest --n run held against plain on its own
   card (`--scaling-only` runs just this, after the build);
12. two shards on one card: run_sampled_sharded over
   build_mesh(devices=["cuda:0", "cuda:0"]) at GEMM N=512 in both forms,
   with the host draw and with the device draw, must fold to
   run_sampled's PRIState and MRC bytes under the same draw, B1 and B2
   counted as in phase 10;
12b. progressive precision at GEMM --n/2 (1024), host draw: "cuda" and
   "torch" with max_rounds=4 fold to phase 9's state and MRC bytes (L1
   error against baselines/gemm1024.json.gz at most 0.01), with equal
   info and band widths per round, B1's raw form once per classified
   chunk; then tolerance=10.0, which must stop after round 1; each
   round's classify and bootstrap seconds;
13. B1's triangular walk vs plain: every dispatch of syrk-tri at
   --tri-n (1536) with the device draw (B3's triangular draw), as phase
   5, each dispatch's bound from its own data (band_hits, tri_issues);
14. triangular path: run_sampled of syrk-tri(--tri-n) with "cuda" and
   "torch", as phase 7: B1 once per dispatch of phase 13, equal states
   and MRC bytes, MRC L1 error against baselines/syrk-tri1536.json.gz
   at most 0.01;
15. the other triangular models at PolyBench LARGE, trmm(1000, 1200),
   trisolv(2000) and covariance(1200, 1400), with "cuda" and "torch":
   B1 and B3 launched, equal states and MRC bytes, every B3 call of the
   "cuda" run bit-equal to plain;
16. two shards on one card, as phase 12, on trmm(256);
17. the exact engines at full width, each run with its wall time, host
   spans and B1 launches (no B2 or B3 launch may occur): a. kernel B1's
   raw form on the analytic path's keys: of every B1 launch of 17c's
   run_exact runs, the first 16 and the 4 largest are held bit-equal
   (residual, histogram, cold) against the plain raw form on the card
   and timed against their bound ("exact kernels" lines); b. periodic:
   run_exact(gemm(4096)) and run_exact(gemm(1024)) must take the
   periodic engine and equal baselines/gemm<N>.json.gz, every key, count
   and the access total, MRC L1 error exactly 0, windows printed; c.
   analytic: run_exact(syrk(1024)) and run_exact(syrk-tri(1536)) must
   take the analytic engine, launch B1 and equal their baselines;
   syrk-tri(384) under kernel_backend "cuda" and "torch": equal states,
   B1 launched under "cuda" only; d. run_stream(gemm(1024)) equals its
   baseline; run_dense(gemm(256)) equals run_periodic(gemm(256));
   run_dense(gemm(1024)) routes past the card's free memory (its stderr
   line printed) and equals the baseline; a triangular nest with a step
   of 2 goes through run_exact to dense, and dense and stream equal
   run_numpy; e. two shards on one card: run_exact_sharded of
   gemm(1024) (periodic) and syrk(512) (analytic, B1 once per shard per
   chunk) equal the single-device runs (the B1 launches of both
   counted); f. the CLI `acc --engine exact --model syrk --n 128`
   prints the same lines on the card (B1 launched) and with --device
   cpu;
18. the frontend: a. the made nests past B1's old descriptor limits
   (tests/_torch_made.py: 64 refs of distinct maps on one array, a
   descriptor of 2,463 words in the buffer form; 9 and 17 refs of one
   map, sink groups cut into sub-groups of 8; a triangular nest of 9
   refs of one map) at N=256 through run_sampled with "cuda" and
   "torch": equal PRIStates and MRC bytes, every B1 launch recorded
   (descriptor length and form printed), held bit-equal against the
   plain version and timed, and each parameter-form launch relaunched in
   the buffer form (equal outputs) and timed in both forms; then
   run_exact of each at N=64 equal to run_serial_native (every key,
   count and total); b. 25 fuzz seeds (frontend/fuzz.py::run_seeds) on
   the card with kernel_backends ("torch",): the exact engine equal to
   the numpy oracle, the sampled drift within its bound, "cuda" (B1, B3)
   bit-identical to "torch", every mutant rejected; c. the
   verify_analytic twin on syrk, syrk-tri and trmm at N=256: every
   point of every period classified by B1's raw form and equal to the
   analytic engine's fits; d. the CLI `acc --program-json` of a dumped
   gemm N=128 prints what `acc --model gemm --n 128` prints and
   `--mrc-out` writes the same bytes; `analyze --model syrk-tri` exits
   0. The phase's B1 and B3 launches are counted in the kernels line;
19. observability (runtime/telemetry.py, runtime/obs/): a. GEMM --n and
   the headline 2*--n with telemetry off, on and device-synced (two
   interleaved runs each): wall times, equal states and MRC digests,
   the span tree's top level, counters and gauges, each document
   through the check_telemetry_schema and check_dispatch_stats
   (--require-fused) twins; the sharded fused form at --n/2 under
   telemetry with every B2 launch bit-equal to plain; b. the CLI in
   four concurrent subprocesses: `sample --model gemm --n 1024` and its
   `--engine
   sharded` with --telemetry-out, --trace-out, --metrics-out, --ledger
   and --profile-dir (trace spans equal the document's, Prometheus
   pluss_dispatches_total, the torch.profiler trace names
   sampled_hist_kernel, randint_kernel and, sharded, pow2_hist_kernel;
   their MRC digests equal the in-process run's), `acc --engine exact
   --model syrk-tri --n 384` and `speed --reps 3` with --ledger, then
   `stats` and the check_ledger twin (every row with compile_delta); c.
   drift_audit(gemm, 256) on the card and the check_drift twin, no
   breach; d. profile_stages at GEMM 2048: each stage's median, the B1
   and B3 launches, one device draw and one B1 dispatch of it bit-equal
   to plain; e. a flight-recorder bundle with the CUDA memory snapshot
   through the check_bundle twin, the check_profile (gemm(1024)) and
   check_slo twins. The in-process launches join the kernels line;
20. the analysis service (service/, the CLI's serve): a. solo requests
   through `serve --cache-dir --max-workers 1`: sampled GEMM 2*--n and
   --n (ratio 0.1, seed 0, device draw), syrk-tri --tri-n, exact GEMM
   --n/2; each digest equal to the direct run_sampled's (at the default
   --n phase 19's e2c857ab095f0fa1 and 8cdc22136a70d541), the exact one
   to baselines/gemm1024.json.gz; latency p50/p99 from the ledger rows
   and each request's service overhead over the direct run; then the
   same lines again, every answer from the store with no kernel
   launched, and the cache-hit latency; b. one batch window
   (--batch-window-ms) of 9 sampled requests (GEMM 1024/1536/2048 with
   two seeds, 2mm 1024, syrk 1024, trmm(1000, 1200) as an inline
   document): one batch, dispatches_batched counted, B1's and B3's
   per-row forms launched, every member's digest equal to its solo run,
   the window's wall beside the members' solo walls; every per-row B1
   launch held bit-equal against the same rows launched per program and
   against plain, every per-row B3 call against the rows' solo launches
   and plain, each form timed beside them with its bound; the members
   through run_sampled_multi at capacity 2 (regrows, equal digests); c.
   replicas 1 and 2 on one card and one per card where more are
   visible: equal digests; d. the check_chaos and check_precision twins
   at small size on the card. Every non-chaos run ends with no solo
   fallback, degrade, failure or open breaker. The launches join the
   kernels line, and its B1 and B3 entries carry the per-row forms'
   times (rows_ms) beside the per-program launches' and their bound.

Then one JSON line of kernel numbers (B1 timed over the dispatches of
phases 5 and 13, its launches those of phases 7, 8b's serial run, 8c,
10, 11b, 11c, 12, 12b, 14, 15, 16, 17, 18, 19 and 20; B2 timed on
phase 10's inputs, its launches those of phases 10-12, 16 and 19; B3
timed on the 8 calls of GEMM-2048's draw, its launches those of phases
7, 8, 8c, 10-12, 14-16, 18, 19 and 20), the nvidia-smi line,
and last the result line {"ok": true, "device": {...}}. Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

MRC_L1_LIMIT = 0.01
KERNEL_REPS, PLAIN_REPS = 10, 2  # timed calls per dispatch, after a warm-up
KERNEL_SHARDED_REPS = 3  # timed passes over a sharded run's B1 launches
MAIN_PATH_ORDER = ("cuda", "torch")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# Issue rate of 32-bit integer instructions on an H100 SXM: each SM's four
# schedulers issue one warp instruction (32 lanes) per clock, 128 lanes,
# x 132 SMs x 1.98 GHz = 33.45e12 lane-instructions/s. The integer work
# splits over two pipes of 64 lanes per SM each, the ALU pipe (adds,
# compares, logic, shifts) and the FMA pipe (IMAD), so 128 is reached
# only by a mix; a kernel on one pipe alone gets half (16.7e12). The
# assumption is this script's: the published table holds no integer
# rate. ops/sampled_hist.py::ops_per_sample counts 32-bit issues, so B1's
# operation bound is that count over this rate; the kernels line also
# prints it at the one-pipe rate.
INT32_ISSUES_PER_S = 128 * 132 * 1.98e9
INT32_PIPE_PER_S = INT32_ISSUES_PER_S / 2
# Bytes B1 needs on the main path: each lane's 1 B mask read and 8 B
# residual written, and the 8 B key of each chosen lane read (the kernel
# reads no mask and every key on the host draw's dispatches).
MASK_BYTES, KEY_BYTES, RESIDUAL_BYTES = 1, 8, 8
REPLACES = "pluss_sampler_optimization_tpu/ops/pallas_sampled.py:126"
SOURCE = "pluss_sampler_optimization_torch/csrc/sampled_hist.cu"
SPANS = ("draw", "stage", "dispatch", "decode", "fold", "cri", "aet")
# Kernel B3 (no Pallas original: the JAX package's XLA draw). Its bound
# is the larger of its bytes (8 B written per element, 1 B of mask read
# by bits) and the 32-bit operations the function needs per element,
# counted by hand from what the streams need, not from the built code
# (whose set-up and index work is the kernel's own cost). A count is
# (ALU pipe only: rotates, logic, compares; FMA pipe only: multiplies;
# either pipe: adds):
# - a threefry2x32 block (B3_BLOCK): 20 rotates and 20 xors; 20 round
#   adds and 12 key-injection adds;
# - a remainder by the span's record (ops/threefry_draw.py::
#   remainder_record; _b3_rem): a power of two one AND per word of the
#   result; otherwise the quotient (above 2^32 two 32 x 32 products,
#   below it the 64 x 64 multiply-high: 4 products and 3 adds), q * span
#   (2 products), the 64-bit subtract (2 adds), compare (2) and
#   conditional subtract (2 adds);
# - randint's multiply-add below 2^32 (hi % span * mult + lo % span):
#   one 32 x 32 + 64 product (B3_MULADD);
# - bits: the sign flip, one XOR; with a mask the byte's expansion and
#   an OR into each word, the flip merged into one of them (3 in all).
# The operations' time is the largest of the ALU-only count and of the
# FMA-only count at one pipe's rate (INT32_PIPE_PER_S) and of all of
# them at the issue rate (INT32_ISSUES_PER_S). The built code's SASS
# counts per pipe are printed at the same rates beside it, to show what
# the kernel issues beyond what the function needs.
B3_BLOCK, B3_MULADD = (40, 0, 32), (0, 1, 0)
B3_REPLACES = "pluss_sampler_optimization_tpu/sampler/draw.py:144"
B3_SOURCE = "pluss_sampler_optimization_torch/csrc/threefry_draw.cu"
B3_RUN_REPS = 5  # timed passes over all of a run's B3 calls
# Kernel B2: per element an 8 B value and a 1 B bool weight read (8 B
# for int weights), the (64,) int64 output written once; 32-bit issues
# per element: the weight test, the 64-bit zero test (2), the 64-bit clz
# (3), the bin (1) and the add (1).
B2_REPLACES = "pluss_sampler_optimization_tpu/ops/pallas_hist.py:39"
B2_SOURCE = "pluss_sampler_optimization_torch/csrc/pow2_hist.cu"
B2_OPS_PER_ELEMENT = 8
B2_RUN_REPS = 5  # timed passes over all of a run's B2 inputs
SHARDED_SPANS = ("draw", "shard_put", "dispatch_psum", "gather_fetch",
                 "merge")
TWO_SHARD_N = 512
# The serial-walk baselines the main paths must find (model, args).
BASELINES = (("gemm", (1024,)), ("gemm", (2048,)), ("gemm", (4096,)),
             ("syrk-tri", (1536,)))
# The triangular phase: syrk-tri at --tri-n (its baseline's 1536 by
# default) through the kernels, then these PolyBench LARGE sizes of the
# other triangular models, and trmm at a small size on two shards.
TRI_MODELS = (("trmm", (1000, 1200)), ("trisolv", (2000,)),
              ("covariance", (1200, 1400)))
TWO_SHARD_TRI = ("trmm", (256,))
# every remainder kind and the main paths' boxes: GEMM-2048's depth-3
# (8,577,357,823) and depth-2 (4,190,209), syrk-tri N=1536's
# (3,616,805,375 and 2,356,225); primes below 2^32 and 2^46
B3_MADE_SPANS = (1, 2, 3, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
                 (1 << 45) - 1, 8_577_357_823, 1 << 46, 4_190_209,
                 3_616_805_375, 2_356_225, 4_294_967_291,
                 70_368_744_177_643)
B3_MADE_B = (1, 17, 1023, 1026, (1 << 14) + 3, 1 << 20)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def _time_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls, after one
    warm-up call, from CUDA events around the whole run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# Profiler ranges of the engine (sampler/sampled.py::_span) and of the draw
# (sampler/draw.py::STEPS); a trace copies each onto the device timeline,
# where it is no device work.
RANGE_PREFIXES = ("sampled: ", "draw: ")


def _device_intervals(prof) -> list:
    """(start, end) microseconds of every device activity (kernel,
    memset, copy) a torch.profiler trace recorded, without the device-side
    copies of the profiler ranges."""
    from torch.autograd import DeviceType

    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type != DeviceType.CPU
            and not e.name.startswith(RANGE_PREFIXES)]


def _busy_us(intervals) -> float:
    """Device-busy microseconds: the length of the union of intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _device_ms(fn, reps: int):
    """(mean device milliseconds of fn() per call, names of the device
    activities) from a torch.profiler trace of reps calls, after a
    warm-up call: the summed durations of the device activities. The
    time is None where the trace records none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    iv = _device_intervals(prof)
    names = [e.name for e in prof.events() if e.device_type != DeviceType.CPU]
    if not iv:
        return None, names
    return sum(b - a for a, b in iv) / reps / 1e3, names


def _spans_text(spans: dict, names=SPANS) -> str:
    return ", ".join(f"{k} {spans.get(k, 0.0):.3f} s" for k in names)


def _reset_launches() -> None:
    import pluss_sampler_optimization_torch.ops.pow2_hist as p2
    import pluss_sampler_optimization_torch.ops.sampled_hist as sh
    import pluss_sampler_optimization_torch.ops.threefry_draw as td

    sh.LAUNCHES = p2.LAUNCHES = td.LAUNCHES = 0


def _launches() -> tuple[int, int, int]:
    """(B1, B2, B3 launches) since the last _reset_launches."""
    import pluss_sampler_optimization_torch.ops.pow2_hist as p2
    import pluss_sampler_optimization_torch.ops.sampled_hist as sh
    import pluss_sampler_optimization_torch.ops.threefry_draw as td

    return sh.LAUNCHES, p2.LAUNCHES, td.LAUNCHES


def _build_one(name: str):
    """(library path, ptxas log, seconds) of a forced build of csrc/<name>.cu."""
    from pluss_sampler_optimization_torch.ops import _build

    t0 = time.perf_counter()
    path, log = _build.build(name, force=True)
    return path, log, time.perf_counter() - t0


def _print_build(path: str, log: str, secs: float) -> None:
    from pluss_sampler_optimization_torch.ops import _build

    print(f"build: {os.path.relpath(path)} in {secs:.2f} s")
    for k in _build.ptxas_report(log):
        print(f"build: {k['name']}: {k.get('registers')} registers, "
              f"{k.get('stack')} B stack frame, {k.get('spill_stores')} "
              f"B spill stores, {k.get('spill_loads')} B spill loads")


# B1's buffer form (csrc/sampled_hist_buf.cu), built in the background
# from phase 2 on: only phase 18 launches it (joined there).
_BUFFER_BUILD = None


def _buffer_form_built() -> None:
    """Wait for the buffer form's build and print its lines (once)."""
    global _BUFFER_BUILD
    if _BUFFER_BUILD is None:
        return
    ex, fut = _BUFFER_BUILD
    _BUFFER_BUILD = None
    t0 = time.perf_counter()
    built = fut.result()
    ex.shutdown()
    _print_build(*built)
    print(f"build: waited {time.perf_counter() - t0:.2f} s for it")


def phase_build(buffer_form: bool = True) -> dict:
    """Build the sources together (B1's buffer form, with `buffer_form`,
    started beside them and left building: `_buffer_form_built`);
    returns B3's SASS counts per instantiation
    (ops/_build.py::sass_counts). Raises unless every B3 entry has 0 B
    stack and spills."""
    from concurrent.futures import ThreadPoolExecutor

    from pluss_sampler_optimization_torch.ops import _build

    global _BUFFER_BUILD
    if buffer_form:
        ex = ThreadPoolExecutor(1)
        _BUFFER_BUILD = ex, ex.submit(_build_one, "sampled_hist_buf")
    names = ("sampled_hist", "pow2_hist", "threefry_draw")
    with ThreadPoolExecutor(len(names)) as ex:
        built = list(ex.map(_build_one, names))
    for path, log, secs in built:
        _print_build(path, log, secs)
    path, log, _ = built[2]
    for k in _build.ptxas_report(log):
        if k.get("stack") or k.get("spill_stores") or k.get("spill_loads"):
            raise AssertionError(f"B3 {k['name']}: stack or spills")
    sass = _build.sass_counts(path)
    for name, c in sass.items():
        print(f"build: B3 SASS {name}: alu {c['alu']}, fma {c['fma']}, "
              f"uniform {c['uniform']}, other {c['other']}, total "
              f"{c['total']} instructions per thread")
    return sass


def _b2_compare(label: str, values, weights):
    """B2 and its plain version on one input: raises unless bit-equal;
    returns the kernel's histogram and the max abs error."""
    import torch

    from pluss_sampler_optimization_torch.ops.pow2_hist import (
        pow2_hist,
        pow2_hist_plain,
    )

    got, plain = pow2_hist(values, weights), pow2_hist_plain(values, weights)
    torch.cuda.synchronize()
    err = int((got - plain).abs().max())
    if not torch.equal(got, plain):
        raise AssertionError(
            f"B2 vs plain: {label} differs (max abs err {err})"
        )
    return got, err


def phase_b2_made(dev) -> int:
    """B2 vs plain on made inputs; returns the max abs error."""
    import torch

    rng = np.random.default_rng(7)
    n = 1 << 20
    e = rng.integers(0, 63, size=n).astype(np.int64)
    lo = np.left_shift(np.int64(1), e)
    vals = lo + rng.integers(0, 1 << 62, size=n) % lo  # bin e
    vals[rng.random(n) < 0.05] = 0
    neg = rng.random(n) < 0.05
    vals[neg] = -rng.integers(1, 1 << 62, size=int(neg.sum()))
    vals[:4] = [0, -(1 << 62), (1 << 62) - 1, -1]
    v = torch.from_numpy(vals).to(dev)
    wb = torch.from_numpy(rng.random(n) < 0.8).to(dev)
    wi = torch.from_numpy(rng.integers(-3, 1 << 20, size=n)).to(dev)
    hist, err = _b2_compare("2^20 made values, bool weights", v, wb)
    if int((hist > 0).sum()) != 64:
        raise AssertionError("B2: the made input does not fill 64 bins")
    err = max(err, _b2_compare("2^20 made values, int weights", v, wi)[1])
    # the JAX package's overflow boundary: two 2^30 weights in one bin
    vals = torch.full((1024,), 1 << 10, dtype=torch.int64, device=dev)
    w = torch.zeros(1024, dtype=torch.int64, device=dev)
    w[0] = w[128] = 1 << 30
    # misaligned views: values[1:] with weights[3:] (a scalar head that
    # aligns both) and weights[2:] (the other parity: scalar weight loads
    # in every tile)
    for wo in (3, 2):
        for name, wt in (("bool", wb), ("int", wi)):
            err = max(err, _b2_compare(
                f"values[1:], {name} weights[{wo}:]", v[1:n - 4],
                wt[wo:n - 5 + wo])[1])
    for k in (1, 17):
        err = max(err, _b2_compare(f"{k} elements", v[5:5 + k],
                                   wb[5:5 + k])[1])
    hist, e2 = _b2_compare("same-bin total 2^31", vals, w)
    hist = hist.cpu()
    if int(hist[10]) != 1 << 31 or int(hist.sum()) != 1 << 31:
        raise AssertionError(f"B2: same-bin total gave {hist.tolist()}")
    print("B2 vs plain: 2^20 made values over all 64 bins (bool and int "
          "weights), the misaligned views values[1:] with weights[3:] and "
          "[2:], 1 and 17 elements, and the 2^31 same-bin total: equal")
    return max(err, e2)


def _b3_run(call, plain: bool):
    """One recorded B3 call through the kernel or its plain version."""
    from pluss_sampler_optimization_torch.ops import threefry_draw as td

    kind, keys, B, arg, dev = call
    if kind == "randint":
        fn = td.threefry_randint_plain if plain else td.threefry_randint_cuda
        return fn(keys, B, arg, dev)
    fn = td.threefry_bits_plain if plain else td.threefry_bits_cuda
    return fn(keys, B, dev, arg)


def _b3_compare(label: str, call) -> None:
    """B3 and its plain version on one call: raises unless bit-equal."""
    import torch

    got, want = _b3_run(call, False), _b3_run(call, True)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(
            f"B3 vs plain: {label} differs in "
            f"{int((got != want).sum())} of {got.numel()} elements"
        )


def phase_b3_made(dev) -> int:
    """B3 vs plain on made keys and spans; returns the max abs error (0:
    a difference raises)."""
    import torch

    from pluss_sampler_optimization_torch.ops import threefry_draw as td

    rng = np.random.default_rng(11)
    n_calls = 0
    for R in (1, 3):
        keys = [tuple(int(x) for x in rng.integers(0, 1 << 32, size=2))
                for _ in range(R)]
        for B in B3_MADE_B:
            for span in B3_MADE_SPANS:
                _b3_compare(f"randint R={R} B={B} span={span}",
                            ("randint", keys, B, span, dev))
                n_calls += 1
            valid = torch.from_numpy(rng.random((R, B)) < 0.6).to(dev)
            flat = torch.from_numpy(rng.random(R * B + 1) < 0.6).to(dev)
            for v in (None, valid, flat[1:].view(R, B)):
                _b3_compare(f"bits R={R} B={B}", ("bits", keys, B, v, dev))
                n_calls += 1
    # columns in several launches: counters from each launch's low word
    segment, td.SEGMENT = td.SEGMENT, 1 << 12
    try:
        for call in (("randint", keys, 10_001, 8_577_357_823, dev),
                     ("randint", keys, 10_001, 4_190_209, dev),
                     ("bits", keys, 10_001, None, dev)):
            _b3_compare(f"{call[0]} in 3 launches of columns", call)
            n_calls += 1
    finally:
        td.SEGMENT = segment
    print(f"B3 vs plain: {n_calls} made calls (1 and 3 rows of "
          f"{', '.join(str(b) for b in B3_MADE_B)} elements; randint spans "
          f"{', '.join(str(x) for x in B3_MADE_SPANS)}; bits with and "
          "without a valid mask and with one a byte off alignment; 10,001 "
          "columns in 3 launches): equal")
    return 0


def _b3_recording(calls=None):
    """Wrap sampler/draw.py's two B3 entry points so that every call to
    the kernel (backend "auto" or "cuda") is appended to `calls` (a new
    list by default) as (kind, keys, B, span or a copy of the valid mask,
    device); returns (the list, a function restoring the originals)."""
    from pluss_sampler_optimization_torch.sampler import draw

    calls = [] if calls is None else calls
    randint, bits = draw.threefry_randint, draw.threefry_bits

    def rec_randint(keys, B, span, device, backend="auto"):
        if backend != "torch":
            calls.append(("randint", list(keys), B, span, device))
        return randint(keys, B, span, device, backend)

    def rec_bits(keys, B, device, valid=None, backend="auto"):
        if backend != "torch":
            calls.append(("bits", list(keys), B,
                          None if valid is None else valid.clone(), device))
        return bits(keys, B, device, valid, backend)

    draw.threefry_randint, draw.threefry_bits = rec_randint, rec_bits

    def restore():
        draw.threefry_randint, draw.threefry_bits = randint, bits

    return calls, restore


def phase_kernels(prog, cfg, dev, label="kernels", raw: bool = False) -> dict:
    """Kernel vs plain on every dispatch of a main path (the program
    `prog`); returns B1's totals over them (kernel and plain ms, bytes,
    32-bit issues, max abs error), the number of dispatches, and the
    run's B3 calls and launches. A triangular dispatch's issues depend on
    its data (ops/sampled_hist.py::band_hits, tri_issues). `raw` holds
    B1's raw-noshare form against the plain version's: its histogram
    must also be all zero."""
    import torch

    from pluss_sampler_optimization_torch.config import MachineConfig
    from pluss_sampler_optimization_torch.ops.histogram import (
        SENTINEL,
        sorted_k_unique,
    )
    from pluss_sampler_optimization_torch.ops.sampled_hist import (
        instantiation,
        sampled_hist_cuda,
        sampled_hist_plain,
    )
    from pluss_sampler_optimization_torch.sampler import sampled as S

    trace, rows = S._program_rows(prog, MachineConfig())
    spans: dict = {}
    tot = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0}
    max_err = n_dispatches = 0
    b3_calls, restore = _b3_recording()
    _reset_launches()
    try:
        dispatches = list(S.plan_dispatches(
            trace, rows, cfg, dev, S.default_batch(dev), "cuda", spans))
    finally:
        restore()
    b3_launches = _launches()[2]
    for d in dispatches:
        name_of = "{" + ",".join(d.nt.tables.ref_names[ri]
                                 for _, ri in d.members) + "}"
        keys, mask = d.keys_RB, d.mask_RB

        def kern():
            return sampled_hist_cuda(d.nt, d.ref_idx, keys, mask, d.highs,
                                     d.rx_R, d.desc, d.tri_base, raw)

        def plain():
            return sampled_hist_plain(d.nt, d.ref_idx, keys, mask, d.highs,
                                      d.rx_R, raw)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        if raw and bool(got[1].any()):
            raise AssertionError(f"{label}: the raw form binned samples")
        for name, a, b in zip(("residual", "hist", "cold"), got, want):
            err = int((a - b).abs().max()) if a.numel() else 0
            max_err = max(max_err, err)
            if not torch.equal(a, b):
                raise AssertionError(
                    f"{label}: kernel vs plain: {name_of} {name} differs "
                    f"(max abs err {err})"
                )
        for j in range(keys.shape[0]):
            pk = [sorted_k_unique(r[j], r[j] != SENTINEL, 1 << 12)
                  for r in (got[0], want[0])]
            for a, b in zip(*pk):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"{label}: kernel vs plain: {name_of} "
                        "sorted_k_unique differs"
                    )
        ms = _time_ms(kern, KERNEL_REPS)
        plain_ms = _time_ms(plain, PLAIN_REPS)
        # the classify's need: the chosen lanes (every lane without a mask)
        nbytes, ops, live = _b1_need(d.nt, d.desc, d.highs, d.ref_idx, keys,
                                     mask, *got[1:])
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["bytes"] += nbytes
        tot["ops"] += ops
        n_dispatches += 1
        lv, nhmax, tri = instantiation(d.desc)
        print(f"{label}: dispatch {n_dispatches} {name_of} R={keys.shape[0]} "
              f"B={keys.shape[1]} ({live} chosen lanes) "
              f"sampled_hist_kernel<{lv}, {nhmax}, {str(tri).lower()}> "
              f"equal; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"{ops // max(live, 1)} int32 issues/sample")
    del dispatches
    print(f"{label}: {n_dispatches} dispatches; host "
          f"{_spans_text(spans, ('draw', 'stage'))}; the draw made "
          f"{len(b3_calls)} B3 calls, {b3_launches} launches")
    return {**tot, "max_abs_err": max_err, "dispatches": n_dispatches,
            "b3_calls": b3_calls, "b3_launches": b3_launches}


def _b1_summary(label: str, tot: dict) -> None:
    """Print B1's totals over one path's dispatches against its bound."""
    bytes_ms = tot["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = tot["ops"] / INT32_ISSUES_PER_S * 1e3
    print(f"{label}: all {tot['dispatches']} dispatches: kernel "
          f"{tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, bound "
          f"{max(bytes_ms, ops_ms):.3f} ms by "
          f"{'bytes' if bytes_ms >= ops_ms else 'operations'} (bytes "
          f"{bytes_ms:.4f} ms, int32 issues {ops_ms:.4f} ms; at the "
          f"one-pipe rate {tot['ops'] / INT32_PIPE_PER_S * 1e3:.4f} ms)")


def _b1_entry(tots) -> dict:
    """B1's JSON entry (without launches) over the dispatches of every
    path in `tots`: times, bytes and issues summed."""
    t = {k: sum(x[k] for x in tots) for k in ("ms", "plain_ms", "bytes",
                                                 "ops")}
    bytes_ms = t["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = t["ops"] / INT32_ISSUES_PER_S * 1e3
    return {
        "name": "sampled_hist", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": None,
        "max_abs_err": max(x["max_abs_err"] for x in tots), "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def _b3_instantiation(call) -> tuple[str, bool]:
    """(the kernel instantiation a B3 call launches, whether it takes the
    bound-checked EDGE form): csrc/threefry_draw.cu::needs_edge for the
    rows the wrapper allocates (aligned, stride B) and a fresh mask."""
    from pluss_sampler_optimization_torch.ops import threefry_draw as td

    kind, _, B, arg, _ = call
    edge = B % (td.CPT * td.THREADS) != 0
    e = str(edge).lower()
    if kind == "randint":
        return f"randint_kernel<{td.remainder_record(arg).kind}, {e}>", edge
    return f"bits_kernel<{e}, {str(arg is not None).lower()}>", edge


def _b3_rem(span: int) -> tuple[int, int, int]:
    """A remainder by span's record: (ALU only, FMA only, either pipe)."""
    if span & (span - 1) == 0:
        return (1 if span <= 1 << 32 else 2, 0, 0)
    return (2, 4, 4) if span > 1 << 32 else (2, 6, 7)


def _b3_need(call) -> dict:
    """What one B3 call needs: bytes and operations by pipe (see
    B3_BLOCK), "total" all of them."""
    from pluss_sampler_optimization_torch.sampler.threefry import (
        randint_multiplier,
    )

    kind, keys, B, arg, _ = call
    n = len(keys) * B
    parts = [B3_BLOCK]
    if kind == "bits":
        parts.append((1 if arg is None else 3, 0, 0))
    elif randint_multiplier(arg):  # two blocks, three remainders
        parts += [B3_BLOCK, _b3_rem(arg), _b3_rem(arg), _b3_rem(arg),
                  B3_MULADD]
    else:
        parts.append(_b3_rem(arg))
    alu, fma, either = (sum(p[i] for p in parts) for i in range(3))
    return {"bytes": (8 + (kind == "bits" and arg is not None)) * n,
            "alu": alu * n, "fma": fma * n, "total": (alu + fma + either) * n}


def _b3_issued(call, sass: dict) -> dict:
    """The instructions one B3 call issues by pipe: its threads times the
    SASS count of its instantiation (the kernel has no loop, so a thread
    runs each instruction once)."""
    from pluss_sampler_optimization_torch.ops import threefry_draw as td

    _, keys, B, _, _ = call
    name, edge = _b3_instantiation(call)
    threads = len(keys) * -(-(B + edge) // (td.CPT * td.THREADS)) * td.THREADS
    return {k: threads * sass[name][k] for k in ("alu", "fma", "total")}


def _b3_ops_ms(count: dict) -> dict:
    """Milliseconds of a count: the ALU and FMA pipes at INT32_PIPE_PER_S,
    all of it at INT32_ISSUES_PER_S; "ops" the largest."""
    ms = {"alu": count["alu"] / INT32_PIPE_PER_S * 1e3,
          "fma": count["fma"] / INT32_PIPE_PER_S * 1e3,
          "issue": count["total"] / INT32_ISSUES_PER_S * 1e3}
    return {**ms, "ops": max(ms.values())}


def _b3_sum(counts) -> dict:
    total: dict = {}
    for c in counts:
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


def phase_b3_engine(label: str, calls, sass: dict, max_err: int) -> dict:
    """B3 vs plain on every call of one path's draws, timed per run (all
    of the run's calls, once each; randint and bits apart); returns B3's
    JSON entry (without launches) for these calls."""
    from pluss_sampler_optimization_torch.ops import threefry_draw as td

    for i, call in enumerate(calls):
        kind, keys, B, arg, _ = call
        _b3_compare(f"{label} call {i} ({kind}, R={len(keys)}, B={B})", call)
        print(f"B3 {label}: call {i} {kind} R={len(keys)} B={B}"
              + (f" span={arg}" if kind == "randint" else
                 f" valid={'yes' if arg is not None else 'no'}")
              + f" {_b3_instantiation(call)[0]} equal")

    def run(sub, plain=False):
        for call in sub:
            _b3_run(call, plain)

    def timed(sub):
        """(ms per run, CUDA-event ms, launches the trace recorded)."""
        events = _time_ms(lambda: run(sub), B3_RUN_REPS)
        dev_ms, names = _device_ms(lambda: run(sub), B3_RUN_REPS)
        if dev_ms is None:
            return events, events, None
        # a call is one kernel per launch; the trace may miss some, and
        # the time per run is then the recorded kernels' mean times the
        # launches
        want = B3_RUN_REPS * sum(
            len(list(td.launch_blocks(len(c[1]), c[2]))) for c in sub)
        if (any("randint_kernel" not in x and "bits_kernel" not in x
                for x in names) or len(names) > want):
            raise AssertionError(f"B3 trace: {want} launches ran other "
                                 f"device operations: {sorted(set(names))}")
        return dev_ms * want / len(names), events, len(names)

    for part in ("randint", "bits", "all"):
        sub = [c for c in calls if part in ("all", c[0])]
        ms, events, recorded = timed(sub)
        need = _b3_sum(_b3_need(c) for c in sub)
        bytes_ms = need["bytes"] / HBM_BYTES_PER_S * 1e3
        ops, built = _b3_ops_ms(need), _b3_ops_ms(
            _b3_sum(_b3_issued(c, sass) for c in sub))
        bound = max(bytes_ms, ops["ops"])
        print(f"B3 {label}: {part}: {len(sub)} calls, kernel {ms:.4f} ms "
              f"per run (profiler device time, "
              + ("not recorded" if recorded is None else
                 f"{recorded} launches recorded")
              + f"; CUDA events {events:.4f} ms); bound {bound:.4f} ms by "
              + ("bytes" if bytes_ms >= ops["ops"] else "operations")
              + f" (bytes {bytes_ms:.4f}; the function's operations: ALU "
              f"pipe {ops['alu']:.4f}, FMA pipe {ops['fma']:.4f}, issue "
              f"{ops['issue']:.4f} ms): {bound / ms:.1%} of it; the built "
              f"code's SASS at the same rates: ALU pipe {built['alu']:.4f}, "
              f"FMA pipe {built['fma']:.4f}, issue {built['issue']:.4f} ms")
    plain = _time_ms(lambda: run(calls, True), 2)
    print(f"B3 vs plain: all {len(calls)} {label} calls equal; per run "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} ms")
    return {
        "name": "threefry_draw", "route": "cuda", "source": B3_SOURCE,
        "replaces": B3_REPLACES, "launches": None, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain, "bound_ms": bound,
        "bound_by": "bytes" if bytes_ms >= ops["ops"] else "operations",
        "library_ms": None,
    }


def phase_draw_breakdown(n: int, cfg, dev, label: str) -> dict:
    """The device draw of GEMM N=n broken into its steps: one draw of
    every bucket through the engine (sampler/draw.py's
    draw_bucket_keys_device) under torch.profiler, each step's device
    time summed over the buckets from the step's profiler range
    (draw.STEPS; B3's kernels, launched through ctypes outside any torch
    operation, by their names), beside the engine's host seconds for the
    same draw without the profiler, and equal to it. Returns {step:
    device ms}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pluss_sampler_optimization_torch.config import MachineConfig
    from pluss_sampler_optimization_torch.models import gemm
    from pluss_sampler_optimization_torch.sampler import draw as D
    from pluss_sampler_optimization_torch.sampler import sampled as S

    trace, rows = S._program_rows(gemm(n), MachineConfig())
    batch = S.default_batch(dev)
    buckets = [(trace.nests[k], [ri for _, ri in m],
                [cfg.seed * 1000003 + idx for idx, _ in m])
               for (k, _), m in S._bucket_rows(trace, rows).items()]

    def draw():
        return [D.draw_bucket_keys_device(nt, ris, cfg, seeds, batch, dev)
                for nt, ris, seeds in buckets]

    draw()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = draw()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        got = draw()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    for a, b in zip(engine, got):
        if len(a) != len(b) or not all(
                torch.equal(x.keys, y.keys) and torch.equal(x.chosen, y.chosen)
                for x, y in zip(a, b)):
            raise AssertionError(f"draw breakdown: gemm({n}): the traced "
                                 "draw differs from the engine's")
    del engine, got
    # a step's device time: its range's device total (the torch ops'
    # kernels under it); B3's kernels by their names
    ms = dict.fromkeys(D.STEPS, 0.0)
    b3 = {"draw: B3 randint": "randint_kernel", "draw: B3 bits": "bits_kernel"}
    busy = []
    for e in prof.events():
        if e.device_type == DeviceType.CPU:
            if e.name in ms and e.name not in b3:
                ms[e.name] += e.device_time_total / 1e3
            continue
        if e.name in ms:  # the ranges' device-side copies
            continue
        busy.append((e.time_range.start, e.time_range.end))
        for step, kernel in b3.items():
            if kernel in e.name:
                ms[step] += (e.time_range.end - e.time_range.start) / 1e3
    total = sum(ms.values())
    busy_s = _busy_us(busy) / 1e6
    print(f"{label}: gemm({n}) draw, {len(buckets)} buckets: the engine's "
          f"draw {host_s:.4f} s host; traced {traced_s:.4f} s host, device "
          f"busy {busy_s:.4f} s (idle share {1 - busy_s / traced_s:.3f}); "
          "device ms by step: "
          + ", ".join(f"{k[6:]} {v:.4f} ({v / max(total, 1e-12):.1%})"
                      for k, v in ms.items())
          + f"; sum {total:.4f} ms")
    return ms


def _state_mrc(state, machine, spans: dict | None = None):
    """(PRIState JSON, MRC); `spans` gets the host seconds of
    cri_distribute ("cri") and aet_mrc ("aet")."""
    from pluss_sampler_optimization_torch.runtime.aet import aet_mrc
    from pluss_sampler_optimization_torch.runtime.baseline import (
        state_to_json,
    )
    from pluss_sampler_optimization_torch.runtime.cri import cri_distribute

    T = machine.thread_num
    t0 = time.perf_counter()
    rih = cri_distribute(state, T, T)
    t1 = time.perf_counter()
    mrc = aet_mrc(rih, machine)
    if spans is not None:
        spans["cri"] = t1 - t0
        spans["aet"] = time.perf_counter() - t1
    return state_to_json(state), mrc


def phase_main_path(label: str, n: int, cfg, backends, dispatches=None,
                    b3_launches=None, model: str = "gemm", args=None,
                    b3_calls: list | None = None):
    """run_sampled -> cri_distribute -> aet_mrc of `model` (the registry's
    constructor, called with `args`, by default (n,)) on the card once per
    kernel backend; returns the "cuda" run's (B1, B3) launches and the
    folded (PRIState JSON, MRC). Under "cuda" B1 must launch once per
    dispatch (`dispatches`) and B3 `b3_launches` times where given (at
    least once under the device draw, never under the host draw); under
    "torch" no kernel launches; B2 never does. Every run's state and MRC
    bytes must be equal; `b3_calls`, where given, gets the "cuda" run's
    B3 calls (_b3_recording). The MRC's L1 error against
    baselines/<model><n>.json.gz, where the file exists, at most
    MRC_L1_LIMIT (it must exist in BASELINES)."""
    import torch

    from pluss_sampler_optimization_torch.config import MachineConfig
    from pluss_sampler_optimization_torch.models import REGISTRY
    from pluss_sampler_optimization_torch.runtime.aet import (
        aet_mrc,
        mrc_l1_error,
    )
    from pluss_sampler_optimization_torch.runtime.baseline import (
        load_baseline,
    )
    from pluss_sampler_optimization_torch.runtime.cri import cri_distribute
    from pluss_sampler_optimization_torch.sampler.sampled import (
        _use_device_draw,
        run_sampled,
    )

    machine = MachineConfig()
    T = machine.thread_num
    args = (n,) if args is None else args
    what = f"{model}({', '.join(str(a) for a in args)})"
    dev_draw = _use_device_draw(cfg, "cuda")
    first = kernel_launches = None
    for i, backend in enumerate(backends, 1):
        c = dataclasses.replace(cfg, kernel_backend=backend)
        spans: dict = {}
        restore = None
        if b3_calls is not None and backend == "cuda":
            _, restore = _b3_recording(b3_calls)
        try:
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, results = run_sampled(REGISTRY[model](*args), machine, c,
                                         device="cuda", spans=spans)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            if restore is not None:
                restore()
        b1, b2, b3 = _launches()
        got = _state_mrc(state, machine, spans)
        samples = sum(r.n_samples for r in results)
        rest = wall - sum(v for k, v in spans.items()
                          if k not in ("cri", "aet"))
        print(f"{label}: run {i} kernel_backend={backend} {what} "
              f"{'device' if dev_draw else 'host'} draw {wall:.3f} s "
              f"({_spans_text(spans, SPANS[:5])}, rest {rest:.3f} s), then "
              f"cri {spans['cri']:.3f} s, aet {spans['aet']:.3f} s; "
              f"{samples} samples, {b1} B1, {b2} B2 and {b3} B3 launches, "
              f"MRC of {len(got[1])} points")
        if backend == "cuda":
            ok = (b1 > 0 if dispatches is None else b1 == dispatches) and (
                (b3 == 0) if not dev_draw else
                (b3 > 0 if b3_launches is None else b3 == b3_launches))
            kernel_launches = (b1, b3)
        else:
            ok = b1 == b3 == 0
        if not ok or b2 != 0:
            raise AssertionError(
                f"{label}: {b1} B1, {b2} B2 and {b3} B3 launches under "
                f"kernel_backend={backend} (expected B1 {dispatches}, B3 "
                f"{b3_launches if dev_draw else 0} under cuda, none under "
                "torch, never B2)")
        if first is None:
            first = got
        elif got[0] != first[0]:
            raise AssertionError(f"{label}: run {i}'s PRIState differs")
        elif got[1].tobytes() != first[1].tobytes():
            raise AssertionError(f"{label}: run {i}'s MRC bytes differ")
    if len(backends) > 1:
        print(f"{label}: all runs give equal PRIStates and MRC bytes")
    mrc = first[1]
    if not (np.isfinite(mrc).all() and mrc[0] == 1.0
            and (np.diff(mrc) <= 0).all()):
        raise AssertionError(f"{label}: MRC not finite, 1 at 0 and "
                             "non-increasing")
    base = load_baseline(model, n, machine) if args == (n,) else None
    if base is None:
        if (model, args) in BASELINES:
            raise AssertionError(f"{label}: baselines/{model}{n}.json.gz "
                                 "is missing")
        print(f"{label}: no baseline for {what}; MRC error not checked")
        return kernel_launches, first
    mrc_b = aet_mrc(cri_distribute(base["state"], T, T), machine)
    err = mrc_l1_error(mrc, mrc_b)
    print(f"{label}: MRC L1 error vs baselines/{model}{n}.json.gz: "
          f"{err!r}")
    if not err <= MRC_L1_LIMIT:
        raise AssertionError(
            f"{label}: MRC L1 error {err} above {MRC_L1_LIMIT}"
        )
    return kernel_launches, first


def _sharded_recording():
    """Wrap the sharded engine's mesh reductions and draws (host-side,
    no device work): each reduction's member rows R and steps per shard,
    and each device draw's (rows, buffer size B); returns (the record,
    a function restoring the originals)."""
    from pluss_sampler_optimization_torch.parallel import sharded

    rec = {"groups": [], "draws": []}
    run, per_ref, bucket = (sharded._Group.run,
                            sharded.draw_sample_keys_device,
                            sharded.draw_bucket_keys_device)

    def run_rec(self, *args, **kw):
        rec["groups"].append((next(iter(self.rx.values())).numel(),
                              [len(s) for s in self.steps.values()]))
        return run(self, *args, **kw)

    def per_ref_rec(*args, **kw):
        out = per_ref(*args, **kw)
        if out is not None:
            rec["draws"].append((1, int(out[0].shape[0])))
        return out

    def bucket_rec(*args, **kw):
        groups = bucket(*args, **kw)
        rec["draws"] += [(len(g.positions), int(g.keys.shape[1]))
                         for g in groups]
        return groups

    sharded._Group.run = run_rec
    sharded.draw_sample_keys_device = per_ref_rec
    sharded.draw_bucket_keys_device = bucket_rec

    def restore():
        sharded._Group.run = run
        sharded.draw_sample_keys_device = per_ref
        sharded.draw_bucket_keys_device = bucket

    return rec, restore


def _b1_recording():
    """Wrap B1's launch so that each launch's arguments and outputs are
    kept (copies, so column spans become whole rows); returns (the list,
    a function restoring the original)."""
    import pluss_sampler_optimization_torch.ops.sampled_hist as sh

    calls = []
    launch = sh.sampled_hist_cuda

    def recording(nt, ref_idx, keys, mask, highs, rx, desc=None,
                  tri_base=None, raw=False, desc_dev=None, form=None):
        out = launch(nt, ref_idx, keys, mask, highs, rx, desc, tri_base,
                     raw, desc_dev, form)
        calls.append(((nt, ref_idx, keys.clone(),
                       None if mask is None else mask.clone(), highs,
                       rx.clone(), desc, tri_base, raw, desc_dev, form),
                      tuple(o.clone() for o in out)))
        return out

    sh.sampled_hist_cuda = recording

    def restore():
        sh.sampled_hist_cuda = launch

    return calls, restore


def _b2_inputs_recording():
    """Wrap the sharded engine's histogram so that each launch's (values,
    weights) are kept (copies); returns (the list, a restore)."""
    from pluss_sampler_optimization_torch.parallel import sharded

    inputs = []
    hist_fn = sharded.pow2_hist_auto

    def recording(values, weights, backend):
        inputs.append((values.clone(), weights.clone()))
        return hist_fn(values, weights, backend)

    sharded.pow2_hist_auto = recording

    def restore():
        sharded.pow2_hist_auto = hist_fn

    return inputs, restore


def _sharded_run(prog, cfg, mesh, spans=None, counters=None, profiled=False,
                 record_b1=None, record_b2=None):
    """One sampled_outputs_sharded + fold_results on the card, with the
    launches reset before it and read after it: a dict of the results,
    the dense histograms, state and MRC, wall seconds, (B1, B2, B3)
    launches, the engine's reductions and draws (_sharded_recording) and,
    `profiled`, the device's busy seconds from a torch.profiler trace.
    `record_b1`/`record_b2`: lists that get B1's launches and B2's
    inputs (their copies are device work of their own)."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pluss_sampler_optimization_torch.config import MachineConfig
    from pluss_sampler_optimization_torch.parallel import sharded
    from pluss_sampler_optimization_torch.sampler import sampled as S

    machine = MachineConfig()
    rec, restore = _sharded_recording()
    restores = [restore]
    if record_b1 is not None:
        calls, r = _b1_recording()
        restores.append(r)
    if record_b2 is not None:
        inputs, r = _b2_inputs_recording()
        restores.append(r)
    prof = None
    try:
        _reset_launches()
        torch.cuda.synchronize()
        ctx = (profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
               if profiled else contextlib.nullcontext())
        with ctx as prof:
            t0 = time.perf_counter()
            results, dense = sharded.sampled_outputs_sharded(
                prog, machine, cfg, mesh=mesh, spans=spans,
                counters=counters)
            state = S.fold_results(results, machine.thread_num)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = _launches()
    finally:
        for r in restores:
            r()
    if record_b1 is not None:
        record_b1 += calls
    if record_b2 is not None:
        record_b2 += inputs
    busy = None
    if profiled:
        iv = _device_intervals(prof)
        busy = _busy_us(iv) / 1e6 if iv else None
    return {"results": results, "dense": dense,
            "state": _state_mrc(state, machine), "wall": wall,
            "launches": launches, "rec": rec, "busy": busy}


def _check_sharded(label: str, run: dict, mesh, batch: int, counters: dict,
                   want=None, kernel: bool = True) -> None:
    """The counts of one sharded run (see phase_sharded) and, where
    `want` is given, its state and MRC bytes against it; every ref's
    dense histogram must be the pow2 binning of its exact noshare pairs.
    """
    from pluss_sampler_optimization_torch.runtime.hist import pow2_floor

    b1, b2, b3 = run["launches"]
    groups, draws = run["rec"]["groups"], run["rec"]["draws"]
    steps = sum(sum(s) for _, s in groups)
    rows = sum(r for r, _ in groups)
    regrows = counters.get("capacity_regrows", 0)
    if counters["fetches"] != len(groups) or counters["dispatches"] != len(
            groups):
        raise AssertionError(f"{label}: {counters} for {len(groups)} mesh "
                             "reductions (one read back each)")
    if kernel:
        if b1 != steps or b2 != rows:
            raise AssertionError(
                f"{label}: {b1} B1 and {b2} B2 launches for {steps} shard "
                f"steps and {rows} member rows of {len(groups)} reductions")
        if draws and not regrows:
            # no rerun: one reduction per drawn group, B/batch steps on
            # every shard
            need = mesh.size * sum(B // batch for _, B in draws)
            if steps != need or len(groups) != len(draws):
                raise AssertionError(
                    f"{label}: {steps} shard steps over {len(groups)} "
                    f"reductions for draws {draws} (expected {need})")
    elif b1 or b2 or b3:
        raise AssertionError(f"{label}: kernels launched under torch")
    if want is not None and (run["state"][0] != want[0]
                             or run["state"][1].tobytes()
                             != want[1].tobytes()):
        raise AssertionError(f"{label}: PRIState or MRC bytes differ")
    for r, nh in zip(run["results"], run["dense"]):
        from_pairs: dict = {}
        for ri_val, cnt in r.noshare.items():
            k = pow2_floor(max(int(ri_val), 1))
            from_pairs[k] = from_pairs.get(k, 0) + int(cnt)
        if from_pairs != {1 << e: int(c) for e, c in enumerate(nh) if c}:
            raise AssertionError(
                f"{label}: ref {r.name}'s pow2 histogram is not the binning "
                "of its exact noshare pairs")


def _b1_need(d_nt, desc, highs, ref_idx, keys, mask, hist, cold):
    """(bytes, 32-bit issues) one B1 launch needs: each chosen lane's key
    read, every lane's residual written and mask byte read, hist and
    cold written; issues from ops_per_sample, or from tri_issues with the
    launch's own band hits on a triangular nest."""
    from pluss_sampler_optimization_torch.ops.sampled_hist import (
        band_hits,
        ops_per_sample,
        tri_issues,
    )

    live = keys.numel() if mask is None else int(mask.sum())
    if d_nt.tri:
        ops = sum(tri_issues(d_nt, desc, highs, live, band_hits(
            d_nt, ref_idx, keys[j], None if mask is None else mask[j],
            highs)) for j in range(keys.shape[0]))
    else:
        ops = ops_per_sample(desc, highs) * live
    nbytes = (KEY_BYTES * live + RESIDUAL_BYTES * keys.numel()
              + (0 if mask is None else MASK_BYTES * keys.numel())
              + 8 * hist.numel() + 8 * cold.numel())
    return nbytes, ops, live


def phase_b1_recorded(label: str, calls: list) -> dict:
    """B1 vs plain on recorded launches (_b1_recording): each launch's
    arguments through the plain version on the card, residual, hist and
    cold bit-equal to what the launch gave, that pass of the plain
    version timed with CUDA events; then the kernel over all of them,
    with CUDA events over KERNEL_SHARDED_REPS passes; returns the totals
    (as phase_kernels')."""
    import torch

    from pluss_sampler_optimization_torch.ops.sampled_hist import (
        sampled_hist_cuda,
        sampled_hist_plain,
    )

    tot = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0}
    max_err = lanes = live = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for i, (args, got) in enumerate(calls):
        nt, ref_idx, keys, mask, highs, rx, desc, tri, raw = args[:9]
        start.record()
        want = sampled_hist_plain(nt, ref_idx, keys, mask, highs, rx, raw)
        end.record()
        torch.cuda.synchronize()
        tot["plain_ms"] += start.elapsed_time(end)
        for name, a, b in zip(("residual", "hist", "cold"), got, want):
            err = int((a - b).abs().max()) if a.numel() else 0
            max_err = max(max_err, err)
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: launch {i} {name} differs "
                                     f"from plain (max abs err {err})")
        nbytes, ops, n_live = _b1_need(nt, desc, highs, ref_idx, keys, mask,
                                       *got[1:])
        tot["bytes"] += nbytes
        tot["ops"] += ops
        lanes += keys.numel()
        live += n_live

    def kern():
        for args, _ in calls:
            sampled_hist_cuda(*args)

    tot["ms"] = _time_ms(kern, KERNEL_SHARDED_REPS)
    tot.update(max_abs_err=max_err, dispatches=len(calls))
    print(f"{label}: all {len(calls)} B1 launches bit-equal to the plain "
          f"raw form ({lanes} lanes, {live} chosen)")
    _b1_summary(label, tot)
    return tot


def phase_sharded(n: int, cfg, main_path, b3_main: int, small_n: int):
    """Phase 10: the sharded engine over build_mesh() at GEMM N=n, device
    draw. Returns the launches of its counted runs (B1, B2, B3), B1's
    recorded launches' totals and B2's recorded inputs."""
    import torch

    from pluss_sampler_optimization_torch.models import gemm
    from pluss_sampler_optimization_torch.parallel import build_mesh
    from pluss_sampler_optimization_torch.sampler.sampled import (
        default_batch,
    )

    mesh = build_mesh()
    batch = default_batch(mesh.devices[0])
    totals = [0, 0, 0]
    b1_calls: list = []
    b2_inputs: list = []
    # the fused form (the default on CUDA): a counted, recorded run, then
    # a profiled run for the device's busy share (no copies in it)
    spans: dict = {}
    counters: dict = {}
    run = _sharded_run(gemm(n), cfg, mesh, spans, counters,
                       record_b1=b1_calls, record_b2=b2_inputs)
    _check_sharded("sharded path (fused)", run, mesh, batch, counters,
                   main_path)
    if run["launches"][2] != b3_main or "dispatches_fused" not in counters:
        raise AssertionError(
            f"sharded path (fused): {run['launches'][2]} B3 launches "
            f"(run_sampled's draw: {b3_main}), counters {counters}")
    for i in range(3):
        totals[i] += run["launches"][i]
    prof_spans: dict = {}
    prof = _sharded_run(gemm(n), cfg, mesh, prof_spans, {}, profiled=True)
    if prof["state"][1].tobytes() != main_path[1].tobytes():
        raise AssertionError("sharded path (fused, profiled): MRC differs")
    b1, b2, b3 = run["launches"]
    print(f"sharded path (fused): gemm({n}) device draw {run['wall']:.3f} s "
          f"({_spans_text(spans, SHARDED_SPANS)}, rest "
          f"{run['wall'] - sum(spans.values()):.3f} s, B1 and B2 launches "
          f"recorded); {sum(r.n_samples for r in run['results'])} samples, "
          f"draws (rows, B) {run['rec']['draws']}, {len(run['rec']['groups'])}"
          f" mesh reductions over {mesh.size} shard(s); {b1} B1 (one per "
          f"shard per step), {b2} B2 (one per member row per reduction) and "
          f"{b3} B3 launches (run_sampled's draw: {b3_main}); counters "
          f"{counters}")
    busy = prof["busy"]
    print(f"sharded path (fused): profiled run {prof['wall']:.3f} s "
          f"({_spans_text(prof_spans, SHARDED_SPANS)}); "
          + ("no device activity recorded; device busy time not measured"
             if busy is None else
             f"device busy {busy:.4f} s (idle share "
             f"{1 - busy / prof['wall']:.5f})"))
    print("sharded path (fused): PRIState and MRC bytes equal the main "
          "path's; every ref's pow2 histogram equals its binned exact pairs")
    b1_tot = phase_b1_recorded("sharded kernels (fused)", b1_calls)
    del b1_calls[:]
    # the per-ref (scan) form: one read back per ref plus regrows
    spans, counters = {}, {}
    run = _sharded_run(gemm(n), dataclasses.replace(cfg, fuse_refs=False),
                       mesh, spans, counters, record_b1=b1_calls)
    _check_sharded("sharded path (per-ref scan)", run, mesh, batch,
                   counters, main_path)
    n_refs = len(run["results"])
    regrows = counters.get("capacity_regrows", 0)
    if counters["fetches"] != n_refs + regrows:
        raise AssertionError(f"sharded path (per-ref scan): {counters} for "
                             f"{n_refs} refs")
    for i in range(3):
        totals[i] += run["launches"][i]
    b1, b2, b3 = run["launches"]
    print(f"sharded path (per-ref scan): gemm({n}) {run['wall']:.3f} s "
          f"({_spans_text(spans, SHARDED_SPANS)}); {counters['fetches']} "
          f"read backs for {n_refs} refs and {regrows} regrows; {b1} B1, "
          f"{b2} B2, {b3} B3 launches; PRIState and MRC bytes equal the "
          "main path's")
    scan_tot = phase_b1_recorded("sharded kernels (per-ref scan)", b1_calls)
    del b1_calls
    b1_tot = {k: b1_tot[k] + scan_tot[k] for k in ("ms", "plain_ms",
                                                  "bytes", "ops",
                                                  "dispatches")} | {
        "max_abs_err": max(b1_tot["max_abs_err"], scan_tot["max_abs_err"])}
    # the kernel route against the JAX package's own route ("torch": the
    # plain classify, exp_hist, fixed_k_unique) at a smaller size
    outs = {}
    for backend in MAIN_PATH_ORDER:
        spans, counters = {}, {}
        c = dataclasses.replace(cfg, kernel_backend=backend)
        run = _sharded_run(gemm(small_n), c, mesh, spans, counters)
        _check_sharded(f"sharded path ({backend})", run, mesh, batch,
                       counters, kernel=backend == "cuda")
        if backend == "cuda":
            for i in range(3):
                totals[i] += run["launches"][i]
        outs[backend] = ([dataclasses.asdict(r) for r in run["results"]],
                         [d.tolist() for d in run["dense"]], run["state"][0],
                         run["state"][1].tobytes())
        print(f"sharded path: gemm({small_n}) fused kernel_backend={backend} "
              f"{run['wall']:.3f} s ({_spans_text(spans, SHARDED_SPANS)}); "
              f"launches (B1, B2, B3) {run['launches']}")
    if outs["cuda"] != outs["torch"]:
        raise AssertionError(f"sharded path: gemm({small_n}) cuda and torch "
                             "differ")
    print(f"sharded path: gemm({small_n}) cuda and torch give equal per-ref "
          "results, dense histograms, PRIStates and MRC bytes")
    torch.cuda.synchronize()
    return tuple(totals), b1_tot, b2_inputs


def phase_sharded_headline(n: int, cfg, head) -> tuple:
    """The headline through the sharded engine's fused form over
    build_mesh(): GEMM N=n, state and MRC bytes equal run_sampled's
    (`head`), MRC L1 error against the baseline at most MRC_L1_LIMIT.
    Returns its (B1, B2, B3) launches."""
    from pluss_sampler_optimization_torch.config import MachineConfig
    from pluss_sampler_optimization_torch.models import gemm
    from pluss_sampler_optimization_torch.parallel import build_mesh
    from pluss_sampler_optimization_torch.runtime.aet import (
        aet_mrc,
        mrc_l1_error,
    )
    from pluss_sampler_optimization_torch.runtime.baseline import (
        load_baseline,
    )
    from pluss_sampler_optimization_torch.runtime.cri import cri_distribute
    from pluss_sampler_optimization_torch.sampler.sampled import (
        default_batch,
    )

    mesh = build_mesh()
    spans, counters = {}, {}
    run = _sharded_run(gemm(n), cfg, mesh, spans, counters)
    _check_sharded("sharded headline", run, mesh,
                   default_batch(mesh.devices[0]), counters, head)
    machine = MachineConfig()
    base = load_baseline("gemm", n, machine)
    err = None
    if base is not None:
        T = machine.thread_num
        err = mrc_l1_error(run["state"][1], aet_mrc(
            cri_distribute(base["state"], T, T), machine))
        if not err <= MRC_L1_LIMIT:
            raise AssertionError(f"sharded headline: MRC L1 error {err}")
    elif ("gemm", (n,)) in BASELINES:
        raise AssertionError(f"sharded headline: baselines/gemm{n}.json.gz "
                             "is missing")
    print(f"sharded headline: gemm({n}) fused over {mesh.size} card(s) "
          f"{run['wall']:.3f} s ({_spans_text(spans, SHARDED_SPANS)}, rest "
          f"{run['wall'] - sum(spans.values()):.3f} s); launches (B1, B2, "
          f"B3) {run['launches']}; PRIState and MRC bytes equal run_sampled's"
          + ("" if err is None else
             f"; MRC L1 error vs baselines/gemm{n}.json.gz: {err!r}"))
    return run["launches"]


def phase_scaling(sizes, cfg, wants) -> tuple:
    """The fused form over 1, 2, ... every visible card that divides the
    batch (the device draw's rule) at each GEMM size of `sizes`: a first
    run, which also meets each card's first use, then the timed run,
    wall time beside the card count; every state and MRC equal to `wants`
    (per size). With two or more cards, every B1 launch of the first
    size's widest first run, each on its shard's card, is held against
    the plain version. Returns the timed runs' (B1, B2, B3) launches."""
    import torch

    from pluss_sampler_optimization_torch.models import gemm
    from pluss_sampler_optimization_torch.parallel import build_mesh
    from pluss_sampler_optimization_torch.sampler.sampled import (
        default_batch,
    )

    n_cards = torch.cuda.device_count()
    batch = default_batch(torch.device("cuda"))
    counts = [k for k in range(1, n_cards + 1) if batch % k == 0]
    print(f"scaling: {n_cards} card(s) visible; meshes of {counts} cards "
          f"(the counts that divide the batch, {batch})")
    totals = [0, 0, 0]
    for n, want in zip(sizes, wants):
        for k in counts:
            calls = [] if k == counts[-1] > 1 and n == sizes[0] else None
            first = _sharded_run(gemm(n), cfg, build_mesh(k), None, {},
                                 record_b1=calls)
            spans, counters = {}, {}
            run = _sharded_run(gemm(n), cfg, build_mesh(k), spans, counters)
            for r in (first, run):
                if (r["state"][0] != want[0]
                        or r["state"][1].tobytes() != want[1].tobytes()):
                    raise AssertionError(f"scaling: gemm({n}) on {k} cards "
                                         "differs")
            if calls is not None:
                cards = sorted({str(c[0][2].device) for c in calls})
                phase_b1_recorded(f"scaling kernels ({', '.join(cards)})",
                                  calls)
            for i in range(3):
                totals[i] += run["launches"][i]
            print(f"scaling: gemm({n}) fused on {k} card(s): "
                  f"{run['wall']:.3f} s ({_spans_text(spans, SHARDED_SPANS)})"
                  f"; first run {first['wall']:.3f} s; launches (B1, B2, B3) "
                  f"{run['launches']}")
    return tuple(totals)


def phase_b2_engine(inputs, max_err: int) -> dict:
    """B2 vs plain on the sharded path's inputs, timed per run (all the
    inputs, once each); returns B2's JSON entry (without launches), its
    max abs error taken over these comparisons and max_err. Times are
    device time from torch.profiler where it records any, else CUDA
    events around the calls (which then include the host's launch
    overhead)."""
    import torch

    from pluss_sampler_optimization_torch.ops.pow2_hist import (
        pow2_hist,
        pow2_hist_plain,
    )

    pow2 = torch.tensor([1 << e for e in range(63)], dtype=torch.int64,
                        device=inputs[0][0].device)

    def library(v, w):
        # two calls, defined on values >= 1 only, which the engine passes
        return torch.bincount(torch.searchsorted(pow2, v, right=True) - 1,
                              w, minlength=64)

    nbytes = ops = 0
    filled: dict = {}
    for i, (v, w) in enumerate(inputs):
        got, err = _b2_compare(f"sharded path input {i}", v, w)
        max_err = max(max_err, err)
        if not torch.equal(library(v, w).to(torch.int64), got):
            raise AssertionError(f"B2 yardstick: input {i} differs")
        bins = int((got != 0).sum())
        filled[bins] = filled.get(bins, 0) + 1
        nbytes += v.numel() * (8 + w.element_size()) + 64 * 8
        ops += v.numel() * B2_OPS_PER_ELEMENT
    print("B2 inputs: launches by bins filled: "
          + ", ".join(f"{b} bins: {c}" for b, c in sorted(filled.items())))
    times = {}
    for name, fn in (("kernel", pow2_hist), ("plain", pow2_hist_plain),
                     ("library", library)):
        def run(fn=fn):
            for v, w in inputs:
                fn(v, w)

        call = _time_ms(run, B2_RUN_REPS)
        dev, names = _device_ms(run, B2_RUN_REPS)
        if name == "kernel" and names:
            # after each stream's first call, a call is the kernel alone:
            # no other device operation may show. The trace may miss a
            # few of the calls' kernels; the time per run is then the
            # recorded kernels' mean times the calls.
            calls = B2_RUN_REPS * len(inputs)
            if len(names) > calls or any("pow2_hist_kernel" not in x
                                         for x in names):
                raise AssertionError(
                    f"B2 trace: {calls} calls ran device operations other "
                    f"than the kernel: {sorted(set(names))}")
            print(f"B2 trace: {calls} calls, {len(names)} device "
                  "operations recorded, each the kernel")
            dev *= calls / len(names)
        times[name] = call if dev is None else dev
        print(f"B2 timing: {name} per run: CUDA events around the calls "
              f"{call:.4f} ms, profiler device time "
              + ("not recorded" if dev is None else f"{dev:.4f} ms"))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_ISSUES_PER_S * 1e3
    k = len(inputs)
    print(f"B2 vs plain: all {k} sharded-path inputs equal; per run kernel "
          f"{times['kernel']:.4f} ms ({times['kernel'] / k * 1e3:.2f} us "
          f"per launch), plain {times['plain']:.4f} ms, searchsorted + "
          f"bincount {times['library']:.4f} ms; bound {bytes_ms:.4f} ms by "
          f"bytes ({bytes_ms / k * 1e3:.3f} us per launch; int32 issues "
          f"{ops_ms:.4f} ms)")
    return {
        "name": "pow2_hist", "route": "cuda", "source": B2_SOURCE,
        "replaces": B2_REPLACES, "launches": None, "max_abs_err": max_err,
        "ms": times["kernel"], "plain_ms": times["plain"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": times["library"],
    }


def phase_two_shards(cfg, model: str = "gemm",
                     args: tuple = (TWO_SHARD_N,)) -> tuple:
    """Two shards on one card, in both sharded forms, fold to
    run_sampled's state and MRC, with the host draw and with the device
    draw; B1 once per shard step, B2 once per member row of each mesh
    reduction. Returns the runs' (B1, B2, B3) launches."""
    from pluss_sampler_optimization_torch.config import MachineConfig
    from pluss_sampler_optimization_torch.models import REGISTRY
    from pluss_sampler_optimization_torch.parallel import build_mesh
    from pluss_sampler_optimization_torch.sampler.sampled import (
        default_batch,
        run_sampled,
    )

    machine = MachineConfig()
    prog = REGISTRY[model](*args)
    what = f"{model}({', '.join(str(a) for a in args)})"
    mesh = build_mesh(devices=["cuda:0", "cuda:0"])
    totals = [0, 0, 0]
    for dev_draw in (False, True):
        draw = "device" if dev_draw else "host"
        c = dataclasses.replace(cfg, device_draw=dev_draw)
        want = _state_mrc(run_sampled(prog, machine, c)[0], machine)
        for fuse in (True, False):
            form = "fused" if fuse else "per-ref"
            counters: dict = {}
            run = _sharded_run(prog, dataclasses.replace(c, fuse_refs=fuse),
                               mesh, None, counters)
            _check_sharded(f"two shards: {what} {draw} draw {form}", run,
                           mesh, default_batch(mesh.devices[0]), counters,
                           want)
            if (run["launches"][2] > 0) != dev_draw:
                raise AssertionError(f"two shards: {draw} draw {form}: "
                                     f"{run['launches']} launches")
            for i in range(3):
                totals[i] += run["launches"][i]
            print(f"two shards on cuda:0: {what} {draw} draw, {form} form: "
                  f"PRIState and MRC bytes equal run_sampled's; launches "
                  f"(B1, B2, B3) {run['launches']} over "
                  f"{len(run['rec']['groups'])} mesh reductions")
    return tuple(totals)


def phase_progressive(n: int, cfg, want) -> int:
    """Progressive precision at GEMM N=n (host draw, as run_sampled's
    phase 9): "cuda" and "torch" with max_rounds=4 and no tolerance, each
    full schedule folding to `want` (run_sampled(device_draw=False)'s
    state and MRC), with the MRC L1 error against the baseline at most
    MRC_L1_LIMIT; both routes' info and every round's band width equal;
    B1 once per classified chunk under "cuda", never under "torch". Then
    tolerance=10.0, which must stop after round 1. Prints each round's
    seconds, classify and bootstrap apart. Returns the "cuda" runs' B1
    launches."""
    import torch

    from pluss_sampler_optimization_torch.config import MachineConfig
    from pluss_sampler_optimization_torch.models import gemm
    from pluss_sampler_optimization_torch.runtime.aet import (
        aet_mrc,
        mrc_l1_error,
    )
    from pluss_sampler_optimization_torch.runtime.baseline import (
        load_baseline,
    )
    from pluss_sampler_optimization_torch.runtime.cri import cri_distribute
    from pluss_sampler_optimization_torch.sampler.sampled import (
        run_sampled_progressive,
    )

    machine = MachineConfig()
    T = machine.thread_num
    host = dataclasses.replace(cfg, device_draw=False)
    b1_total = 0
    outs = {}
    for backend, knobs in (("cuda", {"max_rounds": 4}),
                           ("torch", {"max_rounds": 4}),
                           ("cuda", {"tolerance": 10.0})):
        c = dataclasses.replace(host, kernel_backend=backend, **knobs)
        spans: dict = {}
        counters: dict = {}
        rounds: list = []
        marks = [dict(spans)]

        def on_round(info, spans=spans, rounds=rounds, marks=marks):
            torch.cuda.synchronize()
            prev = marks[-1]
            rounds.append((info["round"], info["band_width"], {
                k: spans.get(k, 0.0) - prev.get(k, 0.0)
                for k in ("dispatch", "stage", "decode", "bootstrap")}))
            marks.append(dict(spans))

        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, results, info = run_sampled_progressive(
            gemm(n), machine, c, device="cuda", spans=spans,
            counters=counters, on_round=on_round)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        b1, b2, b3 = _launches()
        got = _state_mrc(state, machine)
        label = f"progressive: gemm({n}) kernel_backend={backend} {knobs}"
        if b2 or b3 or b1 != (counters["dispatches"] if backend == "cuda"
                              else 0):
            raise AssertionError(f"{label}: {b1} B1, {b2} B2, {b3} B3 "
                                 f"launches for {counters['dispatches']} "
                                 "chunks")
        if backend == "cuda":
            b1_total += b1
        per_round = "; ".join(
            f"round {r} band {w!r}: classify "
            f"{t['dispatch'] + t['stage'] + t['decode']:.3f} s, bootstrap "
            f"{t['bootstrap']:.3f} s" for r, w, t in rounds)
        print(f"{label}: {wall:.3f} s (draw {spans.get('draw', 0.0):.3f} s);"
              f" info {info}; {counters['dispatches']} chunks, {b1} B1 "
              f"launches; {per_round}")
        if "tolerance" in knobs:
            if info["rounds"] != 1 or info["stopped"] != "converged":
                raise AssertionError(f"{label}: did not stop after round 1")
            continue
        if got[0] != want[0] or got[1].tobytes() != want[1].tobytes():
            raise AssertionError(f"{label}: PRIState or MRC bytes differ "
                                 "from run_sampled's (host draw)")
        outs[backend] = (info, [(r, w) for r, w, _ in rounds])
    if outs["cuda"] != outs["torch"]:
        raise AssertionError("progressive: info or band widths differ "
                             "between cuda and torch")
    base = load_baseline("gemm", n, machine)
    if base is None:
        print(f"progressive: no baseline for gemm({n}); MRC error not "
              "checked")
    else:
        err = mrc_l1_error(want[1], aet_mrc(
            cri_distribute(base["state"], T, T), machine))
        print(f"progressive: MRC L1 error vs baselines/gemm{n}.json.gz: "
              f"{err!r}")
        if not err <= MRC_L1_LIMIT:
            raise AssertionError(f"progressive: MRC L1 error {err}")
    print("progressive: full schedules equal run_sampled's host-draw "
          "PRIState and MRC bytes under cuda and torch, with equal info "
          "and band widths; tolerance 10 stopped after round 1")
    return b1_total


def phase_cold_warm(n: int, cfg) -> None:
    """The first run of this process (GEMM N=n, "cuda"), which pays the
    CUDA context, each module's load and each kernel's first launch,
    beside a fresh process that calls warmup first (sampler/sampled.py)
    and then runs twice: after warmup the first run must not pay for
    them, so it is as fast as the second (printed, not checked: host
    times spread)."""
    import torch

    from pluss_sampler_optimization_torch.config import MachineConfig
    from pluss_sampler_optimization_torch.models import gemm
    from pluss_sampler_optimization_torch.sampler.sampled import run_sampled

    t0 = time.perf_counter()
    run_sampled(gemm(n), MachineConfig(), cfg, device="cuda")
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    code = (
        "import time, torch\n"
        "from pluss_sampler_optimization_torch import MachineConfig, "
        "SamplerConfig\n"
        "from pluss_sampler_optimization_torch.models import gemm\n"
        "from pluss_sampler_optimization_torch.sampler.sampled import "
        "run_sampled, warmup\n"
        f"prog, m = gemm({n}), MachineConfig()\n"
        f"cfg = SamplerConfig(ratio={cfg.ratio!r}, seed={cfg.seed!r})\n"
        "def segs():\n"
        "    stats = torch.cuda.memory_stats()\n"
        "    return stats.get('segment.all.allocated', 0)\n"
        "t, g = [time.perf_counter()], [0]\n"
        "warmup(prog, m, cfg)\n"
        "t.append(time.perf_counter()); g.append(segs())\n"
        "for _ in range(2):\n"
        "    run_sampled(prog, m, cfg); torch.cuda.synchronize()\n"
        "    t.append(time.perf_counter()); g.append(segs())\n"
        "print(*(b - a for a, b in zip(t, t[1:])), *(b - a for a, b in "
        "zip(g, g[1:])))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    if out.returncode != 0:
        raise AssertionError(f"cold/warm: the warmed process failed:\n"
                             f"{out.stderr[-4000:]}")
    wu, first, second, *segs = (float(x) for x in out.stdout.split())
    print(f"cold/warm: gemm({n}) device draw: this process's first run "
          f"(cold: context, module loads, first launches) {cold:.3f} s; a "
          f"fresh process: warmup {wu:.3f} s, then the run {first:.3f} s, "
          f"again {second:.3f} s; device memory segments the caching "
          f"allocator added in each: {', '.join(str(int(x)) for x in segs)}")


def phase_raw_route(n: int, cfg, dispatches: int, main_path) -> tuple:
    """The raw route (runtime v2 and the r10 distribute) of GEMM N=n with
    "cuda" and "torch": equal v2 PRIStates, equal `--r10` lines
    (cli.result_lines), and the v1 state folded from the raw route's
    results equal to the binned main path's (`main_path`); under "cuda"
    B1 launches once per dispatch (`dispatches`, phase_kernels' raw
    form), under "torch" never. Returns the "cuda" run's (B1, B3)
    launches."""
    import torch

    from pluss_sampler_optimization_torch.cli import result_lines
    from pluss_sampler_optimization_torch.config import MachineConfig
    from pluss_sampler_optimization_torch.models import gemm
    from pluss_sampler_optimization_torch.runtime.baseline import (
        state_to_json,
    )
    from pluss_sampler_optimization_torch.sampler.sampled import (
        fold_results,
        run_sampled,
    )

    machine = MachineConfig()
    first = kernel_launches = None
    for backend in MAIN_PATH_ORDER:
        c = dataclasses.replace(cfg, kernel_backend=backend)
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, per_ref = run_sampled(gemm(n), machine, c, v2=True,
                                     device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        b1, b2, b3 = _launches()
        got = (state_to_json(state),
               result_lines(fold_results(per_ref, machine.thread_num),
                            per_ref, machine, r10=True)[0],
               state_to_json(fold_results(per_ref, machine.thread_num)))
        keys = sum(len(r.noshare) for r in per_ref)
        print(f"raw route: gemm({n}) v2 kernel_backend={backend} "
              f"{wall:.3f} s; {keys} raw noshare keys over {len(per_ref)} "
              f"refs; {b1} B1, {b2} B2 and {b3} B3 launches; "
              f"{len(got[1])} --r10 lines")
        if backend == "cuda":
            if b1 != dispatches or b2 != 0 or b3 == 0:
                raise AssertionError(
                    f"raw route: {b1} B1, {b2} B2, {b3} B3 launches under "
                    f"cuda (expected B1 {dispatches}, B2 0, B3 > 0)")
            kernel_launches = (b1, b3)
        elif b1 or b2 or b3:
            raise AssertionError("raw route: kernels launched under torch")
        if first is None:
            first = got
        elif got[0] != first[0] or got[1] != first[1]:
            raise AssertionError("raw route: the v2 PRIState or the --r10 "
                                 "lines differ between cuda and torch")
    if first[2] != main_path[0]:
        raise AssertionError("raw route: the v1 fold of the raw results "
                             "differs from the binned route's state")
    print("raw route: v2 PRIStates and --r10 lines equal under cuda and "
          "torch; the v1 fold of the raw results equals the main path's")
    return kernel_launches


def _union(intervals) -> list:
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _busy_inside(host, device) -> float:
    """Microseconds of device activity (the union of `device`) inside the
    union of the `host` intervals."""
    dev = _union(device)
    total = 0.0
    for a, b in _union(host):
        for c, d in dev:
            total += max(0.0, min(b, d) - max(a, c))
    return total


def _host_read_timer():
    """Time the device draw's host read (sampler/draw.py::_host_counts,
    which waits for every launch before it on the stream); returns (the
    [seconds, calls] total, a function restoring the original)."""
    from pluss_sampler_optimization_torch.sampler import draw

    total = [0.0, 0]
    read = draw._host_counts

    def timed(*args):
        t0 = time.perf_counter()
        try:
            return read(*args)
        finally:
            total[0] += time.perf_counter() - t0
            total[1] += 1

    draw._host_counts = timed

    def restore():
        draw._host_counts = read

    return total, restore


def phase_pipeline(n: int, cfg, head, serial_n: int, main_path) -> int:
    """The dispatch pipeline at the headline, GEMM N=n: pipeline_depth 1
    and 4, each run once with its spans, counters and the seconds the
    host spends in the device draw's host reads, and once under
    torch.profiler for the device's idle share inside the "dispatch"
    span (the profiler ranges sampler/sampled.py::_span opens) and over
    the run. Both depths' states and MRC bytes must equal the headline
    run's (`head`), with its MRC L1 error against the baseline. Then the
    serial runner (fuse_refs=False) at GEMM N=serial_n: state and MRC
    bytes equal the main path's (`main_path`), B1 once per dispatch.
    Returns the serial run's B1 launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pluss_sampler_optimization_torch.config import MachineConfig
    from pluss_sampler_optimization_torch.models import gemm
    from pluss_sampler_optimization_torch.runtime.aet import mrc_l1_error
    from pluss_sampler_optimization_torch.runtime.baseline import (
        load_baseline,
    )
    from pluss_sampler_optimization_torch.sampler.sampled import run_sampled

    machine = MachineConfig()
    T = machine.thread_num
    base = load_baseline("gemm", n, machine)
    mrc_b = None
    if base is not None:
        from pluss_sampler_optimization_torch.runtime.aet import aet_mrc
        from pluss_sampler_optimization_torch.runtime.cri import (
            cri_distribute,
        )

        mrc_b = aet_mrc(cri_distribute(base["state"], T, T), machine)
    for depth in (1, 4):
        c = dataclasses.replace(cfg, pipeline_depth=depth)
        spans: dict = {}
        counters: dict = {}
        reads, restore = _host_read_timer()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = run_sampled(gemm(n), machine, c, device="cuda",
                                   spans=spans, counters=counters)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            restore()
        got = _state_mrc(state, machine)
        if got[0] != head[0] or got[1].tobytes() != head[1].tobytes():
            raise AssertionError(f"pipeline: depth {depth}: PRIState or MRC "
                                 "bytes differ from the headline run's")
        err = (None if mrc_b is None else mrc_l1_error(got[1], mrc_b))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_sampled(gemm(n), machine, c, device="cuda", spans={})
            torch.cuda.synchronize()
            traced = time.perf_counter() - t0
        host = [(e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == DeviceType.CPU
                and e.name == "sampled: dispatch"]
        dev = _device_intervals(prof)
        span_us = _busy_us(host)
        if dev and span_us:
            inside = _busy_inside(host, dev)
            busy = _busy_us(dev)
            idle = (f"device idle share inside dispatch "
                    f"{1 - inside / span_us:.4f} ({span_us / 1e6:.4f} s of "
                    f"dispatch spans, device busy {inside / 1e6:.4f} s in "
                    f"them); over the traced run {1 - busy / 1e6 / traced:.4f}"
                    f" ({traced:.3f} s)")
        else:
            idle = "no device activity recorded: idle share not measured"
        print(f"pipeline: gemm({n}) pipeline_depth={depth}: {wall:.3f} s "
              f"({_spans_text(spans, SPANS[:5])}); {counters['dispatches']} "
              f"dispatches, {counters.get('pipeline_stalls', 0)} "
              f"pipeline_stalls, {counters.get('capacity_regrows', 0)} "
              f"capacity_regrows, {counters['ref_buckets']} buckets, "
              f"{counters['refs_per_dispatch']:.3f} refs per dispatch; the "
              f"draw's host reads {reads[1]} calls, {reads[0]:.4f} s; "
              f"{idle}; MRC L1 error {err!r}")
    print(f"pipeline: depths 1 and 4 give the headline's PRIState and MRC "
          "bytes")
    c = dataclasses.replace(cfg, fuse_refs=False)
    spans, counters = {}, {}
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = run_sampled(gemm(serial_n), machine, c, device="cuda",
                           spans=spans, counters=counters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b1, _, b3 = _launches()
    got = _state_mrc(state, machine)
    if got[0] != main_path[0] or got[1].tobytes() != main_path[1].tobytes():
        raise AssertionError("pipeline: the serial runner's PRIState or MRC "
                             "bytes differ from the main path's")
    if b1 != counters["dispatches"] or counters["refs_per_dispatch"] != 1:
        raise AssertionError(f"pipeline: serial runner: {b1} B1 launches, "
                             f"{counters['dispatches']} dispatches")
    print(f"pipeline: gemm({serial_n}) fuse_refs=False (serial runner) "
          f"{wall:.3f} s ({_spans_text(spans, SPANS[:5])}); "
          f"{counters['dispatches']} dispatches of one ref, {b1} B1 and {b3} "
          f"B3 launches; PRIState and MRC bytes equal the main path's")
    return b1


def phase_checkpoints(n: int, cfg, main_path) -> None:
    """Checkpoints of GEMM N=n ("cuda") in a temporary directory: a full
    run; with the second member's file of the first two-member bucket
    deleted, a resume that dispatches that member alone and gives the
    same state and MRC bytes; a fully checkpointed rerun that draws and
    dispatches nothing."""
    import tempfile

    import torch

    from pluss_sampler_optimization_torch.config import MachineConfig
    from pluss_sampler_optimization_torch.models import gemm
    from pluss_sampler_optimization_torch.sampler import sampled as S

    machine = MachineConfig()
    trace, rows = S._program_rows(gemm(n), machine)
    pair = next(m for m in S._bucket_rows(trace, rows).values()
                if len(m) == 2)
    with tempfile.TemporaryDirectory() as ck:
        lines = []
        for label in ("full", "resume", "rerun"):
            if label == "resume":
                os.remove(S._checkpoint_path(ck, pair[1][0]))
            counters: dict = {}
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, results = S.run_sampled(gemm(n), machine, cfg,
                                           device="cuda", checkpoint_dir=ck,
                                           counters=counters)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            b1, _, b3 = _launches()
            got = _state_mrc(state, machine)
            if (got[0] != main_path[0]
                    or got[1].tobytes() != main_path[1].tobytes()):
                raise AssertionError(f"checkpoints: the {label} run's "
                                     "PRIState or MRC bytes differ")
            nd = counters.get("dispatches", 0)
            if label == "resume" and (
                    counters["ref_buckets"] != 1 or b1 != nd
                    or counters["refs_per_dispatch"] != 1):
                raise AssertionError(f"checkpoints: the resume ran {nd} "
                                     f"dispatches, {b1} B1 launches")
            if label == "rerun" and (nd or b1 or b3):
                raise AssertionError("checkpoints: a fully checkpointed "
                                     "rerun dispatched")
            lines.append(f"{label} {wall:.3f} s, {nd} dispatches, {b1} B1 "
                         f"and {b3} B3 launches")
    name = trace.nests[0].tables.ref_names[pair[1][1]]
    print(f"checkpoints: gemm({n}): " + "; ".join(lines) + f" (the resume "
          f"redid {name} alone); every state and MRC equals the main path's")


# Phase 17, the exact engines: the serial-walk baselines each exact run
# must reproduce to the last count (model, N), the sizes of the other
# runs, and how many of the analytic runs' B1 launches are held against
# the plain raw form on the card (the first ones and the largest ones).
EXACT_BASELINES = (("gemm", 4096), ("gemm", 1024), ("syrk", 1024),
                   ("syrk-tri", 1536))
EXACT_TRI = "syrk-tri"
EXACT_SMALL_TRI_N = 384
EXACT_DENSE_N = 256
EXACT_SHARDED = (("gemm", 1024, "periodic"), ("syrk", 512, "analytic"))
EXACT_CLI_ARGS = ("acc", "--engine", "exact", "--model", "syrk", "--n",
                  "128")
EXACT_B1_FIRST, EXACT_B1_LARGEST = 16, 4


def _b1_sample_recording():
    """Wrap B1's launch so that copies of the first EXACT_B1_FIRST
    launches and of the EXACT_B1_LARGEST largest later ones are kept
    (arguments and outputs, as _b1_recording); returns (a function
    giving the kept launches, a function restoring the original)."""
    import pluss_sampler_optimization_torch.ops.sampled_hist as sh

    first, largest = [], []
    launch = sh.sampled_hist_cuda

    def recording(nt, ref_idx, keys, mask, highs, rx, desc=None,
                  tri_base=None, raw=False, desc_dev=None, form=None):
        out = launch(nt, ref_idx, keys, mask, highs, rx, desc, tri_base,
                     raw, desc_dev, form)
        keep = len(first) < EXACT_B1_FIRST
        if not keep:
            largest.sort(key=lambda c: -c[0][2].numel())
            keep = (len(largest) < EXACT_B1_LARGEST
                    or keys.numel() > largest[-1][0][2].numel())
            if keep and len(largest) == EXACT_B1_LARGEST:
                largest.pop()
        if keep:
            call = ((nt, ref_idx, keys.clone(),
                     None if mask is None else mask.clone(), highs,
                     rx.clone(), desc, tri_base, raw, desc_dev, form),
                    tuple(o.clone() for o in out))
            (first if len(first) < EXACT_B1_FIRST else largest).append(call)
        return out

    sh.sampled_hist_cuda = recording

    def restore():
        sh.sampled_hist_cuda = launch

    return (lambda: first + largest), restore


def _same_state(a, b) -> bool:
    return (a.thread_num == b.thread_num and a.noshare == b.noshare
            and a.share == b.share)


def _exact_run(label: str, fn, *a, **kw):
    """One exact engine run on the card with its launches reset before
    and read after: (result, wall seconds, B1 launches, spans)."""
    import torch

    spans: dict = {}
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn(*a, spans=spans, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b1, b2, b3 = _launches()
    if b2 or b3:
        raise AssertionError(f"exact: {label}: {b2} B2 and {b3} B3 "
                             "launches (the exact engines draw and bin "
                             "nothing on them)")
    shown = ", ".join(f"{k} {v:.3f} s" if isinstance(v, float)
                      else f"{k} {v}" for k, v in sorted(spans.items()))
    print(f"exact: {label}: engine {getattr(res, 'engine', '-')}, "
          f"{res.total_accesses} accesses, wall {wall:.3f} s, "
          f"{b1} B1 launches; {shown}")
    return res, wall, b1, spans


def _exact_vs_baseline(label: str, model: str, n: int, res) -> None:
    """`res` equals baselines/<model><n>.json.gz's serial-walk state,
    every key and count, and total; MRC L1 error exactly 0."""
    from pluss_sampler_optimization_torch.config import MachineConfig
    from pluss_sampler_optimization_torch.runtime.aet import (
        aet_mrc,
        mrc_l1_error,
    )
    from pluss_sampler_optimization_torch.runtime.baseline import (
        load_baseline,
    )
    from pluss_sampler_optimization_torch.runtime.cri import cri_distribute

    machine = MachineConfig()
    T = machine.thread_num
    base = load_baseline(model, n, machine)
    if base is None:
        raise AssertionError(f"exact: baselines/{model}{n}.json.gz is "
                             "missing")
    if not _same_state(res.state, base["state"]):
        raise AssertionError(f"exact: {label}: PRIState differs from "
                             f"baselines/{model}{n}.json.gz")
    if res.total_accesses != base["total_accesses"]:
        raise AssertionError(
            f"exact: {label}: {res.total_accesses} accesses, the baseline "
            f"{base['total_accesses']}")
    t0 = time.perf_counter()
    mrc = aet_mrc(cri_distribute(res.state, T, T), machine)
    t1 = time.perf_counter()
    err = mrc_l1_error(mrc, aet_mrc(cri_distribute(base["state"], T, T),
                                    machine))
    if err != 0.0 or not np.isfinite(mrc).all():
        raise AssertionError(f"exact: {label}: MRC L1 error {err!r} vs "
                             f"baselines/{model}{n}.json.gz")
    print(f"exact: {label}: PRIState and {res.total_accesses} accesses "
          f"equal baselines/{model}{n}.json.gz, MRC L1 error {err!r} "
          f"(cri + aet {t1 - t0:.3f} s)")


def _tri_step2():
    """A triangular nest with a step of 2 (the closed form needs unit
    steps), built from the port's IR: only dense and stream run it."""
    from pluss_sampler_optimization_torch.ir import (
        Loop,
        ParallelNest,
        Program,
        Ref,
    )

    return Program(name="tri-step2", nests=(ParallelNest(
        loops=(Loop(8, step=2), Loop(trip=1, trip_coeff=1)),
        refs=(Ref("A0", "A", level=1, coeffs=(8, 1)),),
    ),))


def phase_exact() -> tuple:
    """Phase 17: the exact engines at full width on the card (see the
    module docstring). Returns (B1 launches of the phase, seconds)."""
    import contextlib
    import io

    import torch

    from pluss_sampler_optimization_torch.cli import main as cli_main
    from pluss_sampler_optimization_torch.config import MachineConfig
    from pluss_sampler_optimization_torch.models import REGISTRY
    from pluss_sampler_optimization_torch.oracle import run_numpy
    from pluss_sampler_optimization_torch.parallel import (
        build_mesh,
        run_exact_sharded,
    )
    from pluss_sampler_optimization_torch.sampler.analytic import (
        run_analytic,
    )
    from pluss_sampler_optimization_torch.sampler.dense import run_dense
    from pluss_sampler_optimization_torch.sampler.periodic import (
        run_exact,
        run_periodic,
    )
    from pluss_sampler_optimization_torch.sampler.stream import run_stream

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    machine = MachineConfig()
    b1_total = 0
    # b. periodic at the baselines' sizes
    for model, n in EXACT_BASELINES[:2]:
        res, _, b1, spans = _exact_run(f"run_exact({model}({n}))", run_exact,
                                       REGISTRY[model](n), machine)
        if res.engine != "periodic" or b1:
            raise AssertionError(f"exact: {model}({n}) took {res.engine} "
                                 f"with {b1} B1 launches, not periodic")
        _exact_vs_baseline(f"periodic {model}({n}), {spans['windows']} "
                           "windows", model, n, res)
        torch.cuda.empty_cache()
    # c (and a). analytic: every B1 launch of these runs counted, the
    # first and the largest held against the plain raw form
    kept, restore = _b1_sample_recording()
    try:
        for model, n in EXACT_BASELINES[2:]:
            res, wall, b1, spans = _exact_run(
                f"run_exact({model}({n}))", run_exact, REGISTRY[model](n),
                machine)
            b1_total += b1
            if res.engine != "analytic" or not b1:
                raise AssertionError(f"exact: {model}({n}) took "
                                     f"{res.engine} with {b1} B1 launches")
            _exact_vs_baseline(f"analytic {model}({n})", model, n, res)
        calls = kept()
    finally:
        restore()
    tot = phase_b1_recorded("exact kernels (analytic, first "
                            f"{EXACT_B1_FIRST} and largest "
                            f"{EXACT_B1_LARGEST})", calls)
    del calls
    # kernel_backend "cuda" against "torch" on a small triangular box set
    prog = REGISTRY[EXACT_TRI](EXACT_SMALL_TRI_N)
    got = {}
    for backend in ("cuda", "torch"):
        got[backend], _, b1, _ = _exact_run(
            f"run_analytic({EXACT_TRI}({EXACT_SMALL_TRI_N}), "
            f"kernel_backend={backend!r})", run_analytic, prog, machine,
            kernel_backend=backend)
        b1_total += b1
        if (b1 > 0) != (backend == "cuda"):
            raise AssertionError(f"exact: kernel_backend={backend!r}: {b1} "
                                 "B1 launches")
    if not _same_state(got["cuda"].state, got["torch"].state):
        raise AssertionError("exact: analytic states differ between "
                             "kernel_backend 'cuda' and 'torch'")
    print(f"exact: {EXACT_TRI}({EXACT_SMALL_TRI_N}): 'cuda' and 'torch' "
          "PRIStates equal")
    # d. stream and dense
    res, *_ = _exact_run("run_stream(gemm(1024))", run_stream,
                         REGISTRY["gemm"](1024), machine)
    _exact_vs_baseline("stream gemm(1024)", "gemm", 1024, res)
    torch.cuda.empty_cache()
    prog = REGISTRY["gemm"](EXACT_DENSE_N)
    dense, *_ = _exact_run(f"run_dense(gemm({EXACT_DENSE_N}))", run_dense,
                           prog, machine)
    per, *_ = _exact_run(f"run_periodic(gemm({EXACT_DENSE_N}))",
                         run_periodic, prog, machine)
    if not _same_state(dense.state, per.state):
        raise AssertionError("exact: dense and periodic states differ at "
                             f"gemm({EXACT_DENSE_N})")
    print(f"exact: dense gemm({EXACT_DENSE_N}) equals periodic")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        res, *_ = _exact_run("run_dense(gemm(1024))", run_dense,
                             REGISTRY["gemm"](1024), machine)
    line = err.getvalue().strip()
    print(f"exact: run_dense(gemm(1024)) stderr: {line}")
    if "routing to the periodic engine" not in line:
        raise AssertionError("exact: run_dense(gemm(1024)) did not route "
                             "past the card's memory")
    _exact_vs_baseline("dense gemm(1024), routed", "gemm", 1024, res)
    step2 = _tri_step2()
    want = run_numpy(step2, machine)
    res, *_ = _exact_run("run_exact(tri-step2)", run_exact, step2, machine)
    if res.engine != "dense":
        raise AssertionError(f"exact: tri-step2 took {res.engine}")
    for label, fn in (("dense", run_dense), ("stream", run_stream)):
        got_s = res if label == "dense" else _exact_run(
            "run_stream(tri-step2)", fn, step2, machine)[0]
        if not _same_state(got_s.state, want.state) or (
                got_s.total_accesses != want.total_accesses):
            raise AssertionError(f"exact: {label} tri-step2 differs from "
                                 "run_numpy")
    print("exact: tri-step2 routed to dense; dense and stream equal "
          "run_numpy")
    # e. two shards on one card
    mesh = build_mesh(devices=["cuda:0", "cuda:0"])
    for model, n, engine in EXACT_SHARDED:
        prog = REGISTRY[model](n)
        one, _, b1_one, _ = _exact_run(f"run_exact({model}({n}))",
                                       run_exact, prog, machine)
        two, _, b1, _ = _exact_run(f"run_exact_sharded({model}({n}), "
                                   "2 shards on cuda:0)", run_exact_sharded,
                                   prog, machine, mesh)
        b1_total += b1_one + b1
        if two.engine != engine or one.engine != engine:
            raise AssertionError(f"exact: {model}({n}) took {one.engine} / "
                                 f"{two.engine}, not {engine}")
        if engine == "analytic" and (b1 == 0 or b1 % 2):
            raise AssertionError(f"exact: sharded {model}({n}): {b1} B1 "
                                 "launches, not one per shard per chunk")
        if not _same_state(one.state, two.state):
            raise AssertionError(f"exact: sharded {model}({n}) differs from "
                                 "the single-device run")
        print(f"exact: two shards: {model}({n}) {engine} equals one device")
    # f. the CLI on the card and on the CPU
    outs = {}
    for device in ("cuda", "cpu"):
        buf = io.StringIO()
        _reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main([*EXACT_CLI_ARGS, "--device", device])
        b1 = _launches()[0]
        if device == "cuda":
            b1_total += b1
        outs[device] = buf.getvalue()
        print(f"exact: cli {' '.join(EXACT_CLI_ARGS)} --device {device}: "
              f"rc {rc}, {len(outs[device].splitlines())} lines, {b1} B1 "
              f"launches, {time.perf_counter() - t0:.3f} s")
        if rc != 0 or (b1 > 0) != (device == "cuda"):
            raise AssertionError(f"exact: cli on {device}: rc {rc}, {b1} "
                                 "B1 launches")
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError("exact: the CLI's lines differ between the "
                             "card and the CPU")
    print("exact: the CLI's lines are equal on the card and on the CPU")
    seconds = time.perf_counter() - t_phase
    print(f"exact: phase 17 took {seconds:.3f} s, {b1_total} B1 launches "
          f"(kernels over the held launches: {tot['ms']:.3f} ms)")
    return b1_total, seconds


# Phase 18, the frontend: the made nests past kernel B1's old descriptor
# limits (tests/_torch_made.py) at FRONTEND_N through run_sampled, their
# exact runs at FRONTEND_EXACT_N against the native serial walk; the
# fuzz seeds; the verify_analytic twin's models at its default size; the
# CLI's --program-json and --mrc-out beside --model.
FRONTEND_N, FRONTEND_EXACT_N = 256, 64
FRONTEND_SEEDS = 25
FRONTEND_AUDITS = (("syrk", 256), ("syrk-tri", 256), ("trmm", 256))
FRONTEND_CLI = ("acc", "--model", "gemm", "--n", "128")


def _made_nests(n: int) -> list:
    """The made nests past both old limits, built from the port's IR."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from _torch_made import past_limits_programs

    from pluss_sampler_optimization_torch.ir import (
        Loop,
        ParallelNest,
        Program,
        Ref,
    )

    return past_limits_programs(Loop, ParallelNest, Program, Ref, n)


def _same_exact(a, b) -> bool:
    return (_same_state(a.state, b.state)
            and a.total_accesses == b.total_accesses
            and a.per_tid_accesses == b.per_tid_accesses)


def phase_frontend() -> tuple:
    """Phase 18 (see the module docstring): returns (B1 launches, B3
    launches, the held B1 launches' totals, seconds)."""
    import contextlib
    import io
    import tempfile

    import torch

    import pluss_sampler_optimization_torch.ops.sampled_hist as sh
    from pluss_sampler_optimization_torch.cli import main as cli_main
    from pluss_sampler_optimization_torch.config import (
        MachineConfig,
        SamplerConfig,
    )
    from pluss_sampler_optimization_torch.frontend import fuzz
    from pluss_sampler_optimization_torch.native import run_serial_native
    from pluss_sampler_optimization_torch.sampler.periodic import run_exact
    from pluss_sampler_optimization_torch.sampler.sampled import (
        run_sampled,
        warmup,
    )
    from pluss_sampler_optimization_torch.tools import verify_analytic

    _buffer_form_built()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    machine = MachineConfig()
    cfg = SamplerConfig(ratio=0.1, seed=0)
    b1_total = b3_total = 0
    calls: list = []
    # a. the made nests through run_sampled, "cuda" (every B1 launch
    # recorded) against "torch"
    for prog in _made_nests(FRONTEND_N):
        warmup(prog, machine, cfg)
        got = {}
        for backend in ("cuda", "torch"):
            c = dataclasses.replace(cfg, kernel_backend=backend)
            rec, restore = (_b1_recording() if backend == "cuda"
                            else ([], lambda: None))
            try:
                _reset_launches()
                sh.BUFFER_LAUNCHES = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, results = run_sampled(prog, machine, c,
                                             device="cuda")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                restore()
            b1, b2, b3 = _launches()
            got[backend] = _state_mrc(state, machine)
            samples = sum(r.n_samples for r in results)
            forms = sorted({(len(a[6]), sh.desc_form(a[6])) for a, _ in rec})
            print(f"frontend: {prog.name} N={FRONTEND_N} "
                  f"kernel_backend={backend}: {wall:.3f} s, {samples} "
                  f"samples, {b1} B1 launches ({sh.BUFFER_LAUNCHES} in the "
                  f"buffer form), {b3} B3 launches"
                  + (f"; descriptors (words, form): {forms}"
                     if backend == "cuda" else ""))
            if backend == "cuda":
                if not b1 or not b3 or b2 or len(rec) != b1:
                    raise AssertionError(f"frontend: {prog.name}: {b1} B1, "
                                         f"{b2} B2, {b3} B3 launches")
                b1_total += b1
                b3_total += b3
                calls += rec
            elif b1 or b2 or b3:
                raise AssertionError(f"frontend: {prog.name} under torch "
                                     "launched a kernel")
        if (got["cuda"][0] != got["torch"][0]
                or got["cuda"][1].tobytes() != got["torch"][1].tobytes()):
            raise AssertionError(f"frontend: {prog.name}: 'cuda' and "
                                 "'torch' PRIStates or MRC bytes differ")
        print(f"frontend: {prog.name}: 'cuda' and 'torch' PRIStates and "
              "MRC bytes equal")
    if not any(sh.desc_form(a[6]) == "buffer" for a, _ in calls):
        raise AssertionError("frontend: no launch took the buffer form")
    tot = phase_b1_recorded("frontend kernels (made nests, "
                            f"N={FRONTEND_N})", calls)
    # the buffer form beside the parameter form on the same launches
    # (each descriptor uploaded once, before the timing): equal outputs,
    # then both timed
    param = [(args[:9], torch.as_tensor(args[6], device="cuda"), want)
             for args, want in calls if sh.desc_form(args[6]) == "param"]
    for args, desc_dev, want in param:
        out = sh.sampled_hist_cuda(*args, desc_dev, form="buffer")
        if not all(torch.equal(x, y) for x, y in zip(out, want)):
            raise AssertionError("frontend: the buffer form differs from "
                                 "the parameter form")
    for form in ("param", "buffer"):
        def run_form(form=form):
            for args, desc_dev, _ in param:
                sh.sampled_hist_cuda(*args, desc_dev, form=form)

        tot[f"{form}_ms"] = _time_ms(run_form, KERNEL_SHARDED_REPS)
    print(f"frontend kernels: the {len(param)} parameter-form launches in "
          f"the parameter form {tot['param_ms']:.3f} ms, in the buffer "
          f"form {tot['buffer_ms']:.3f} ms")
    del calls, param
    for prog in _made_nests(FRONTEND_EXACT_N):
        _reset_launches()
        t0 = time.perf_counter()
        res = run_exact(prog, machine, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = run_serial_native(prog, machine)
        t2 = time.perf_counter()
        b1 = _launches()[0]
        b1_total += b1
        print(f"frontend: run_exact({prog.name}, N={FRONTEND_EXACT_N}): "
              f"{res.engine}, {res.total_accesses} accesses, {t1 - t0:.3f} "
              f"s, {b1} B1 launches; run_serial_native {t2 - t1:.3f} s")
        if not _same_exact(res, want):
            raise AssertionError(f"frontend: run_exact({prog.name}) differs "
                                 "from run_serial_native")
    print("frontend: every run_exact equals run_serial_native (keys, "
          "counts, totals)")
    # b. the fuzz seeds on the card: B1 against plain, exact against numpy
    t0 = time.perf_counter()
    _reset_launches()
    summary = fuzz.run_seeds(FRONTEND_SEEDS, kernel_backends=("torch",),
                             device="cuda")
    b1, _, b3 = _launches()
    b1_total += b1
    b3_total += b3
    print(f"frontend: fuzz: {summary['passed']}/{FRONTEND_SEEDS} seeds "
          f"passed on the card (kernel_backends ('torch',), worst drift "
          f"{summary['worst_drift']} at seed {summary['worst_drift_seed']}), "
          f"{b1} B1 and {b3} B3 launches, "
          f"{time.perf_counter() - t0:.3f} s")
    if summary["failed"] or not b1 or not b3:
        raise AssertionError(f"frontend: fuzz failures "
                             f"{summary['failures']}")
    # c. the verify_analytic twin: every point of every period
    for model, n in FRONTEND_AUDITS:
        buf = io.StringIO()
        _reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = verify_analytic.main(["--model", model, "--n", str(n)])
        b1 = _launches()[0]
        b1_total += b1
        out = buf.getvalue().strip()
        print(f"frontend: verify_analytic {model} N={n}: rc {rc}, {b1} B1 "
              f"launches, {time.perf_counter() - t0:.3f} s: "
              f"{out.splitlines()[-1] if out else ''}")
        if rc != 0 or not out.startswith("PASS") or not b1:
            raise AssertionError(f"frontend: verify_analytic {model}: "
                                 f"{out}")
    # d. the CLI: a dumped document through --program-json, --mrc-out
    with tempfile.TemporaryDirectory() as tmp:
        doc = os.path.join(tmp, "gemm.json")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["--dump-ir", "gemm", "--n", FRONTEND_CLI[4]])
        with open(doc, "w") as f:
            f.write(buf.getvalue())
        outs = {}
        for label, argv in (("model", list(FRONTEND_CLI)),
                            ("program-json", ["acc", "--program-json",
                                              doc])):
            buf = io.StringIO()
            mrc_path = os.path.join(tmp, f"{label}.mrc")
            _reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli_main([*argv, "--mrc-out", mrc_path])
            b1 = _launches()[0]
            b1_total += b1
            with open(mrc_path, "rb") as f:
                outs[label] = (rc, buf.getvalue(), f.read())
            print(f"frontend: cli {' '.join(argv)} --mrc-out: rc {rc}, "
                  f"{len(outs[label][1].splitlines())} lines, MRC file "
                  f"{len(outs[label][2])} B, "
                  f"{time.perf_counter() - t0:.3f} s")
        if outs["model"][0] != 0 or outs["model"] != outs["program-json"]:
            raise AssertionError("frontend: --program-json's stdout or "
                                 "--mrc-out bytes differ from --model's")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["analyze", "--model", "syrk-tri"])
        print(f"frontend: cli analyze --model syrk-tri: rc {rc}: "
              f"{buf.getvalue().splitlines()[0]}")
        if rc != 0:
            raise AssertionError("frontend: analyze --model syrk-tri failed")
    print("frontend: the CLI's --program-json stdout and --mrc-out bytes "
          "equal --model's")
    seconds = time.perf_counter() - t_phase
    print(f"frontend: phase 18 took {seconds:.3f} s, {b1_total} B1 and "
          f"{b3_total} B3 launches")
    return b1_total, b3_total, tot, seconds

OBS_SAMPLE = ("sample", "--model", "gemm", "--n", "1024")
OBS_EXACT = ("acc", "--engine", "exact", "--model", "syrk-tri", "--n", "384")
OBS_SPEED = ("speed", "--reps", "3")
OBS_DRIFT = ("gemm", 256)
OBS_STAGES_N = 2048
# check_profile's engine arm: a run that waits on the card for most of its
# wall (at GEMM-256 the host's own work let the sampler thread take the
# GIL: +2.80% against the 3% budget)
OBS_PROFILE_N = 1024


def _top_spans(doc: dict) -> str:
    """The telemetry document's root spans and their children, summed by
    name: "engine 0.351 s (bucket x12 0.301 s, fetch x3 0.010 s, ...)"."""
    parts = []
    for root in doc["spans"]:
        agg: dict = {}
        for c in root["children"]:
            tot, n = agg.get(c["name"], (0.0, 0))
            agg[c["name"]] = (tot + c["wall_s"], n + 1)
        kids = ", ".join(f"{k} x{n} {t:.3f} s" for k, (t, n) in agg.items())
        parts.append(f"{root['name']} {root['wall_s']:.3f} s ({kids})")
    return "; ".join(parts)


def _span_names(doc: dict) -> set:
    out = set()
    stack = list(doc["spans"])
    while stack:
        sp = stack.pop()
        out.add(sp["name"])
        stack.extend(sp["children"])
    return out


def _tool(module: str, *argv) -> None:
    """One of the port's tool twins in this process (its main(argv));
    raises unless it exits 0."""
    import importlib

    rc = importlib.import_module(
        f"pluss_sampler_optimization_torch.tools.{module}").main(list(argv))
    if rc:
        raise AssertionError(f"obs: {module} {' '.join(argv)} exited {rc}")


def _digest(state, machine) -> str:
    from pluss_sampler_optimization_torch.runtime.obs.ledger import (
        mrc_digest,
    )

    return mrc_digest(_state_mrc(state, machine)[1])


def phase_obs(n: int, card: str) -> tuple:
    """Phase 19, telemetry and observability on the card; returns the
    phase's in-process (B1, B2, B3) launches.

    a. GEMM n and the headline 2n (ratio 0.1, seed 0, device draw)
       with telemetry disabled, enabled, and enabled with device_sync,
       interleaved twice: wall times, equal states and MRC digests, the
       span tree's top level and the counters; each exported document
       through the check_telemetry_schema and check_dispatch_stats
       (--require-fused) twins. The sharded engine's fused form at n/2
       under telemetry: every B2 launch held bit-equal to plain;
    b. the CLI in four concurrent subprocesses: `sample` and `sample
       --engine sharded`
       at GEMM 1024 with every observability flag, `acc --engine exact`
       on syrk-tri(384) and `speed --reps 3` with --ledger, then `stats`
       and the check_ledger twin; the Chrome traces' span names equal
       their documents', the Prometheus text counts dispatches, the
       torch.profiler traces name B1's, B2's and B3's kernels, the
       sample rows' digests equal the in-process run's;
    c. drift_audit on gemm(256) on the card and the check_drift twin;
    d. profile_stages at GEMM 2048: stage medians, B1 and B3 launches,
       one B1 dispatch and one device draw bit-equal to plain;
    e. a flight-recorder bundle with the CUDA memory snapshot through the
       check_bundle twin, the check_profile (GEMM 1024) and check_slo
       twins."""
    import shutil
    import tempfile

    import torch

    from pluss_sampler_optimization_torch.config import (
        MachineConfig,
        SamplerConfig,
    )
    from pluss_sampler_optimization_torch.models import gemm
    from pluss_sampler_optimization_torch.parallel import build_mesh
    from pluss_sampler_optimization_torch.runtime import telemetry
    from pluss_sampler_optimization_torch.runtime.obs import (
        drift,
        ledger,
        recorder,
    )
    from pluss_sampler_optimization_torch.runtime.obs.stage_profile import (
        profile_stages,
    )
    from pluss_sampler_optimization_torch.sampler.sampled import run_sampled

    t_phase = time.perf_counter()
    machine = MachineConfig()
    cfg = SamplerConfig(ratio=0.1, seed=0)
    b1 = b2 = b3 = 0
    tmp = tempfile.mkdtemp(prefix="obs_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    led = os.path.join(tmp, "ledger.jsonl")
    print(f"obs: card {card}")

    # a. telemetry off, on and device-synced
    modes = (("off", None), ("on", False), ("synced", True))
    for size in (n, 2 * n):
        walls: dict = {m: [] for m, _ in modes}
        seen: dict = {}
        for rep in range(2):
            for mode, sync in modes:
                tele = None if sync is None else telemetry.enable(
                    device_sync=sync)
                _reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, _ = run_sampled(gemm(size), machine, cfg)
                torch.cuda.synchronize()
                walls[mode].append(time.perf_counter() - t0)
                telemetry.disable()
                l1, _, l3 = _launches()
                b1, b3 = b1 + l1, b3 + l3
                got = (_state_mrc(state, machine)[0], _digest(state, machine))
                if seen and got != next(iter(seen.values())):
                    raise AssertionError(f"obs: gemm({size}) telemetry "
                                         f"{mode}: state or MRC digest "
                                         "differs from the run with it off")
                seen[mode] = got
                if tele is not None and rep == 1:
                    doc = tele.to_json()
                    path = os.path.join(tmp, f"tele_{size}_{mode}.json")
                    tele.write_json(path)
                    print(f"obs: gemm({size}) telemetry {mode}: "
                          f"{_top_spans(doc)}; counters "
                          f"{json.dumps(doc['counters'], sort_keys=True)}; "
                          f"gauges {json.dumps(doc['gauges'], sort_keys=True)}")
                    _tool("check_telemetry_schema", path)
                    _tool("check_dispatch_stats", "--require-fused", path)
        print(f"obs: gemm({size}) wall, telemetry off "
              f"{walls['off'][0]:.3f} / {walls['off'][1]:.3f} s, on "
              f"{walls['on'][0]:.3f} / {walls['on'][1]:.3f} s, synced "
              f"{walls['synced'][0]:.3f} / {walls['synced'][1]:.3f} s "
              f"(two interleaved runs each); MRC digest "
              f"{seen['off'][1]} in all six; {card}")
    # the sharded engine's fused form under telemetry: B2 vs plain
    inputs: list = []
    tele = telemetry.enable()
    try:
        run = _sharded_run(gemm(n // 2), cfg, build_mesh(), record_b2=inputs)
    finally:
        telemetry.disable()
    l1, l2, l3 = run["launches"]
    b1, b2, b3 = b1 + l1, b2 + l2, b3 + l3
    for i, (values, weights) in enumerate(inputs):
        _b2_compare(f"obs sharded launch {i}", values, weights)
    doc = tele.to_json()
    if not l2 or l2 != len(inputs):
        raise AssertionError(f"obs: sharded gemm({n // 2}): {l2} B2 launches, "
                             f"{len(inputs)} recorded")
    print(f"obs: sharded gemm({n // 2}) under telemetry: {l1} B1, {l2} B2, "
          f"{l3} B3 launches, every B2 launch bit-equal to plain; "
          f"{_top_spans(doc)}")

    # b. the CLI
    _reset_launches()
    want = _digest(run_sampled(gemm(1024), machine, cfg)[0], machine)
    l1, _, l3 = _launches()
    b1, b3 = b1 + l1, b3 + l3
    # the four CLI runs as concurrent processes on the card (each one's
    # start-up, about 8 s, overlaps the others'); their ledger rows carry
    # each engine's own latency
    runs = []
    for label, argv in (("sample", OBS_SAMPLE),
                        ("sharded", OBS_SAMPLE + ("--engine", "sharded")),
                        ("exact", OBS_EXACT), ("speed", OBS_SPEED)):
        flags = ["--ledger", led]
        files = {}
        if label in ("sample", "sharded"):
            files = {k: os.path.join(tmp, f"{label}_{k}") for k in
                     ("tele.json", "trace.json", "metrics.prom", "prof")}
            flags += ["--telemetry-out", files["tele.json"],
                      "--trace-out", files["trace.json"],
                      "--metrics-out", files["metrics.prom"],
                      "--profile-dir", files["prof"]]
        with open(os.path.join(tmp, f"{label}.err"), "w") as err:
            proc = subprocess.Popen(
                [sys.executable, "-m", "pluss_sampler_optimization_torch",
                 *argv, *flags], stdout=subprocess.DEVNULL, stderr=err)
        runs.append((label, argv, flags, files, proc))
    t0 = time.perf_counter()
    try:
        for label, argv, flags, files, proc in runs:
            proc.wait(timeout=300)
            if proc.returncode:
                with open(os.path.join(tmp, f"{label}.err")) as f:
                    err = f.read()
                raise AssertionError(f"obs: CLI {' '.join(argv)} exited "
                                     f"{proc.returncode}:\n{err[-3000:]}")
            print(f"obs: CLI {' '.join(argv)} with "
                  f"{', '.join(flags[::2])}: done "
                  f"{time.perf_counter() - t0:.2f} s after the four started")
    finally:
        for run in runs:
            if run[-1].poll() is None:
                run[-1].kill()
    for label, argv, flags, files, proc in runs:
        if not files:
            continue
        with open(files["tele.json"]) as f:
            doc = json.load(f)
        with open(files["trace.json"]) as f:
            trace = json.load(f)
        names = {e["name"] for e in trace["traceEvents"]
                 if e.get("ph") == "X"}
        if names != _span_names(doc):
            raise AssertionError(f"obs: {label}: Chrome trace spans "
                                 f"{sorted(names)} != the document's "
                                 f"{sorted(_span_names(doc))}")
        with open(files["metrics.prom"]) as f:
            prom = f.read()
        if "pluss_dispatches_total " not in prom:
            raise AssertionError(f"obs: {label}: no dispatches_total line")
        prof_text = ""
        for name in os.listdir(files["prof"]):
            with open(os.path.join(files["prof"], name)) as f:
                prof_text += f.read()
        kernels = ["sampled_hist_kernel", "randint_kernel"]
        if label == "sharded":
            kernels.append("pow2_hist_kernel")
        missing = [k for k in kernels if k not in prof_text]
        if missing:
            raise AssertionError(f"obs: {label}: profiler trace lacks "
                                 f"{missing}")
        _tool("check_telemetry_schema", files["tele.json"])
        print(f"obs: CLI {label}: trace spans {sorted(names)} equal the "
              f"document's; Prometheus pluss_dispatches_total "
              f"{doc['counters'].get('dispatches')}; profiler trace names "
              f"{', '.join(kernels)}; builds {doc['jax_monitoring']}")
    out = subprocess.run(
        [sys.executable, "-m", "pluss_sampler_optimization_torch", "stats",
         "--ledger", led], capture_output=True, text=True, timeout=120)
    if out.returncode:
        raise AssertionError(f"obs: stats exited {out.returncode}")
    for line in out.stdout.splitlines():
        print(f"obs: stats: {line}")
    _tool("check_ledger", led)
    rows = ledger.read_rows(led)
    for row in rows:
        if "compile_delta" not in row:
            raise AssertionError(f"obs: ledger row without compile_delta: "
                                 f"{row}")
        print(f"obs: ledger row {row['engine_requested']} "
              f"{row['model']}({row['n']}): engine {row['engine_used']}, "
              f"latency {row['latency_s']} s, MRC digest "
              f"{row['mrc_digest']}, compile_delta {row['compile_delta']}")
    digests = sorted(r["mrc_digest"] for r in rows
                     if r["engine_requested"] in ("sampled", "sharded"))
    if digests != [want, want]:
        raise AssertionError(f"obs: CLI sample/sharded digests {digests} "
                             f"!= the in-process run's {want}")
    print(f"obs: ledger {len(rows)} rows valid; sample and sharded MRC "
          f"digest {want} equal the in-process run's (telemetry off)")

    # c. the drift audit
    _reset_launches()
    row = drift.drift_audit(*OBS_DRIFT, device="cuda", ledger_path=led)
    l1, _, l3 = _launches()
    b1, b3 = b1 + l1, b3 + l3
    if row["breach"] or not (row["mrc_digest_exact"]
                             and row["mrc_digest_sampled"]):
        raise AssertionError(f"obs: drift row {row}")
    _tool("check_drift", "--models", OBS_DRIFT[0], "--n", str(OBS_DRIFT[1]),
          "--device", "cuda", "--ledger", led)
    print(f"obs: drift gemm({OBS_DRIFT[1]}) on the card: exact "
          f"{row['engine_exact']}, max_abs {row['max_abs_delta']}, mean_abs "
          f"{row['mean_abs_delta']}, digests {row['mrc_digest_exact']} / "
          f"{row['mrc_digest_sampled']}, {row['latency_s']:.3f} s, no breach "
          f"({l1} B1, {l3} B3 launches)")

    # d. the stage profile
    _reset_launches()
    res = profile_stages(n=OBS_STAGES_N, reps=5, device="cuda",
                         out=lambda *a: None)
    l1, _, l3 = _launches()
    b1, b3 = b1 + l1, b3 + l3
    for stage, ms in res["stage_ms"].items():
        note = {"device_draw": f" ({l3} B3 launches in the profile)",
                "scan_kernel": f" ({l1} B1 launches in the profile)",
                }.get(stage, "")
        print(f"obs: stage gemm({OBS_STAGES_N}) {stage}: {ms:.3f} ms{note}")
    b1 += _stage_kernels_vs_plain(OBS_STAGES_N)
    print(f"obs: stage profile: B1 dispatch and device draw (B3) bit-equal "
          f"to plain; {card}")

    # e. the recorder, check_profile and check_slo
    bdir = os.path.join(tmp, "bundles")
    rec = recorder.FlightRecorder(bdir, profile=True, ledger_path=led)
    path = rec.dump("dump_debug")
    with open(path) as f:
        bundle = json.load(f)
    if not bundle["profile"] or not os.path.exists(bundle["profile"]):
        raise AssertionError("obs: bundle without its CUDA memory snapshot")
    _tool("check_bundle", bdir)
    print(f"obs: bundle {os.path.basename(path)} with its CUDA memory "
          f"snapshot ({os.path.getsize(bundle['profile'])} B) passes "
          "check_bundle")
    _reset_launches()
    _tool("check_profile", "--device", "cuda", "--n", str(OBS_PROFILE_N))
    _tool("check_slo", led)
    l1, _, l3 = _launches()
    b1, b3 = b1 + l1, b3 + l3
    print(f"obs: check_profile (gemm({OBS_PROFILE_N}) on the card) and "
          f"check_slo passed")
    shutil.rmtree(tmp)
    print(f"obs: phase 19 took {time.perf_counter() - t_phase:.1f} s; "
          f"{b1} B1, {b2} B2, {b3} B3 launches in this process")
    return b1, b2, b3


def _stage_kernels_vs_plain(n: int) -> int:
    """profile_stages' two kernel stages once against plain: a device
    draw of GEMM n's ref 0 under "cuda" (B3) and "torch" (bit-equal keys
    and mask), then its buffer's dispatch through B1 and through the
    plain version (bit-equal outputs); returns the B1 launches."""
    import torch

    from pluss_sampler_optimization_torch.config import (
        MachineConfig,
        SamplerConfig,
    )
    from pluss_sampler_optimization_torch.core.trace import ProgramTrace
    from pluss_sampler_optimization_torch.models import gemm
    from pluss_sampler_optimization_torch.ops.sampled_hist import (
        build_descriptor,
        device_descriptor,
        tri_table,
    )
    from pluss_sampler_optimization_torch.sampler import sampled as S
    from pluss_sampler_optimization_torch.sampler.draw import (
        draw_sample_keys_device,
    )

    dev = torch.device("cuda")
    nt = ProgramTrace(gemm(n), MachineConfig()).nests[0]
    batch = S.default_batch(dev)
    draws = [draw_sample_keys_device(
        nt, 0, SamplerConfig(ratio=0.1, seed=0, device_draw=True,
                             kernel_backend=kb), 0, batch, dev)
             for kb in ("cuda", "torch")]
    (dk, dm, s, highs), plain = draws
    if not (torch.equal(dk, plain[0]) and torch.equal(dm, plain[1])):
        raise AssertionError("obs: stage profile's device draw: B3 differs "
                             "from plain")
    span = min(dk.shape[0], S._FUSED_HOST_CHUNKS * batch)
    desc = build_descriptor(nt, 0)
    rx = torch.tensor([0], dtype=torch.int64, device=dev)
    _reset_launches()
    outs = {}
    for backend in ("cuda", "torch"):
        outs[backend] = S.bucket_dispatch(
            nt, 0, dk[None, :span], dm[None, :span], S._pad_highs(highs), rx,
            64, backend, desc, tri_table(nt, dev),
            desc_dev=device_descriptor(desc, dev))[0]
    for a, b in zip(outs["cuda"], outs["torch"]):
        if not torch.equal(a, b):
            raise AssertionError("obs: stage profile's B1 dispatch differs "
                                 "from plain")
    return _launches()[0]


# Phase 20, the analysis service on the card (--serve-only: the build,
# then this phase). The solo requests at full size (GEMM 2n and n, the
# syrk-tri baseline's size, exact GEMM n/2), their digests as phase 19
# prints them for the default --n, and one batch window of mixed models
# and sizes (model, size, seed; trmm at PolyBench LARGE as an inline
# program document).
SERVE_DIGESTS = {4096: "e2c857ab095f0fa1", 2048: "8cdc22136a70d541"}
SERVE_BATCH = (("gemm", 1024, 0), ("gemm", 1024, 1), ("gemm", 1536, 0),
               ("gemm", 1536, 1), ("gemm", 2048, 0), ("gemm", 2048, 1),
               ("2mm", 1024, 0), ("syrk", 1024, 0),
               ("trmm", (1000, 1200), 0))
SERVE_BATCH_WINDOW_MS = 500
SERVE_REGROW_CAPACITY = 2  # a capacity every batched dispatch outgrows
SERVE_REPLICA_REQUESTS = (("gemm", 1024, 0), ("gemm", 1024, 1),
                          ("2mm", 1024, 0), ("syrk", 1024, 0))
SERVE_ROWS_REPS = 3  # timed passes over the recorded per-row launches


def _serve_request(model: str, size, seed: int, engine: str = "sampled",
                   rid: str | None = None) -> dict:
    """One request line's fields: a registry model at n, or (a tuple of
    sizes) an inline program document of the registry's builder."""
    from pluss_sampler_optimization_torch.frontend.schema import (
        program_to_json,
    )
    from pluss_sampler_optimization_torch.models import REGISTRY

    doc = {"id": rid or f"{model}{size}-s{seed}-{engine}", "engine": engine}
    if isinstance(size, tuple):
        doc["program"] = program_to_json(REGISTRY[model](*size))
    else:
        doc.update(model=model, n=size)
    if engine == "sampled":
        doc.update(ratio=0.1, seed=seed)
    return doc


def _serve_program(model: str, size):
    from pluss_sampler_optimization_torch.models import REGISTRY

    return REGISTRY[model](*(size if isinstance(size, tuple) else (size,)))


def _direct(prog, seed: int = 0):
    """(MRC digest, wall seconds) of run_sampled on the card, warmed: the
    better of two runs."""
    import torch

    from pluss_sampler_optimization_torch.config import (
        MachineConfig,
        SamplerConfig,
    )
    from pluss_sampler_optimization_torch.sampler.sampled import (
        run_sampled,
        warmup,
    )

    machine, cfg = MachineConfig(), SamplerConfig(ratio=0.1, seed=seed)
    warmup(prog, machine, cfg)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = run_sampled(prog, machine, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return _digest(state, machine), min(walls)


def _serve_cli(tmp: str, name: str, lines: list, store: str, led: str,
               *flags) -> list:
    """The CLI's serve mode in this process over `lines`: the response
    documents, in input order."""
    import contextlib
    import io

    from pluss_sampler_optimization_torch import cli

    reqs, resps = (os.path.join(tmp, f"{name}.{x}.jsonl")
                   for x in ("requests", "responses"))
    with open(reqs, "w") as f:
        f.writelines(json.dumps(d) + "\n" for d in lines)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["serve", "--cache-dir", store, "--ledger", led,
                       "--requests", reqs, "--responses", resps, *flags])
    if rc != 0:
        raise AssertionError(f"serve: {name}: exited {rc}: {err.getvalue()}")
    with open(resps) as f:
        return [json.loads(line) for line in f]


def _serve_rows_recording():
    """Wrap the per-row forms of B1 (sampled_hist_rows_cuda) and B3
    (threefry_randint_cuda with a span per row): each launch's arguments
    and outputs kept (references: the batch never writes them again);
    returns (B1 calls, B3 calls, a restore)."""
    import pluss_sampler_optimization_torch.ops.sampled_hist as sh
    import pluss_sampler_optimization_torch.ops.threefry_draw as td

    b1, b3 = [], []
    rows, randint = sh.sampled_hist_rows_cuda, td.threefry_randint_cuda

    def rows_rec(nts, ref_idxs, keys, mask, highs_rows, rx, descs=None,
                 descs_dev=None, tris=None, raw=False, hrs_dev=None):
        out = rows(nts, ref_idxs, keys, mask, highs_rows, rx, descs,
                   descs_dev, tris, raw, hrs_dev)
        b1.append(((list(nts), list(ref_idxs), keys, mask,
                    list(highs_rows), rx, raw), out))
        return out

    def randint_rec(keys, B, span, device):
        out = randint(keys, B, span, device)
        if not isinstance(span, (int, np.integer)):
            b3.append((list(keys), B, list(span), device, out))
        return out

    sh.sampled_hist_rows_cuda, td.threefry_randint_cuda = rows_rec, randint_rec

    def restore():
        sh.sampled_hist_rows_cuda, td.threefry_randint_cuda = rows, randint

    return b1, b3, restore


def _serve_b1_rows(calls: list) -> dict:
    """Every recorded per-row B1 launch held against the same rows
    launched per program (sampled_hist_cuda, each row's own descriptor
    in its parameter or buffer form) and against the per-row plain
    version, all bit-equal; the per-row form, the per-program launches
    and the plain version timed over all of them; the bound summed per
    row (_b1_need of each row's descriptor). Returns the totals."""
    import torch

    from pluss_sampler_optimization_torch.ops.sampled_hist import (
        build_descriptor,
        rows_instantiation,
        rows_matrix,
        sampled_hist_cuda,
        sampled_hist_rows_cuda,
        sampled_hist_rows_plain,
    )

    def per_program(args):
        nts, ris, keys, mask, highs, rx, raw = args
        outs = [sampled_hist_cuda(nts[r], ris[r], keys[r:r + 1],
                                  None if mask is None else mask[r:r + 1],
                                  highs[r], rx[r:r + 1], raw=raw)
                for r in range(len(nts))]
        return tuple(torch.cat([o[i] for o in outs]) for i in range(3))

    tot = {"bytes": 0, "ops": 0, "rows": 0, "max_abs_err": 0}
    for i, (args, got) in enumerate(calls):
        nts, ris, keys, mask, highs, rx, raw = args
        for label, want in (("per-program launches", per_program(args)),
                            ("plain", sampled_hist_rows_plain(
                                nts, ris, keys, mask, highs, rx, raw))):
            for name, a, b in zip(("residual", "hist", "cold"), got, want):
                err = int((a - b).abs().max()) if a.numel() else 0
                tot["max_abs_err"] = max(tot["max_abs_err"], err)
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"serve: per-row B1 launch {i} {name} differs from "
                        f"its {label} (max abs err {err})")
        descs = [build_descriptor(nt, ri) for nt, ri in zip(nts, ris)]
        lv, nh, tri = rows_instantiation(rows_matrix(descs))
        for r in range(len(nts)):
            nbytes, ops, _ = _b1_need(
                nts[r], descs[r], highs[r], ris[r], keys[r:r + 1],
                None if mask is None else mask[r:r + 1], got[1][r:r + 1],
                got[2][r:r + 1])
            tot["bytes"] += nbytes
            tot["ops"] += ops
        tot["rows"] += len(nts)
        print(f"serve: per-row B1 launch {i}: {len(nts)} rows of "
              f"{keys.shape[1]} lanes, sampled_hist_kernel_rows<{lv}, {nh}, "
              f"{str(tri).lower()}>, equal to its per-program launches and "
              "to plain")

    def rows_form():
        for (nts, ris, keys, mask, highs, rx, raw), _ in calls:
            sampled_hist_rows_cuda(nts, ris, keys, mask, highs, rx, raw=raw)

    def programs():
        for args, _ in calls:
            per_program(args)

    def plain():
        for (nts, ris, keys, mask, highs, rx, raw), _ in calls:
            sampled_hist_rows_plain(nts, ris, keys, mask, highs, rx, raw)

    tot["ms"] = _time_ms(rows_form, SERVE_ROWS_REPS)
    tot["per_program_ms"] = _time_ms(programs, SERVE_ROWS_REPS)
    tot["plain_ms"] = _time_ms(plain, 1)
    tot["dispatches"] = len(calls)
    _b1_summary(f"serve: per-row B1 ({tot['rows']} rows in {len(calls)} "
                f"launches; the same rows per program "
                f"{tot['per_program_ms']:.3f} ms)", tot)
    return tot


def _serve_b3_rows(calls: list) -> dict:
    """Every recorded B3 randint call with a span per row held against
    each row's solo launch (one span) and against the plain version,
    bit-equal; both timed; the bound by bytes and by the operations the
    rows' streams need (_b3_need per row). Returns the totals."""
    import torch

    from pluss_sampler_optimization_torch.ops import threefry_draw as td

    need = []
    for i, (keys, B, spans, dev, got) in enumerate(calls):
        solo = torch.cat([td.threefry_randint_cuda([k], B, sp, dev)
                          for k, sp in zip(keys, spans)])
        plain = td.threefry_randint_plain(keys, B, spans, dev)
        for label, want in (("solo launches", solo), ("plain", plain)):
            if not torch.equal(got, want):
                raise AssertionError(
                    f"serve: per-row B3 call {i} differs from its {label} "
                    f"in {int((got != want).sum())} of {got.numel()}")
        kinds = sorted({td.remainder_record(sp).kind for sp in spans})
        print(f"serve: per-row B3 call {i}: {len(keys)} rows of {B}, spans "
              f"{spans}, remainder kinds {kinds}: equal to the rows' solo "
              "launches and to plain")
        need += [_b3_need(("randint", [k], B, sp, dev))
                 for k, sp in zip(keys, spans)]

    def rows_form():
        for keys, B, spans, dev, _ in calls:
            td.threefry_randint_cuda(keys, B, spans, dev)

    def solos():
        for keys, B, spans, dev, _ in calls:
            for k, sp in zip(keys, spans):
                td.threefry_randint_cuda([k], B, sp, dev)

    def plain():
        for keys, B, spans, dev, _ in calls:
            td.threefry_randint_plain(keys, B, spans, dev)

    n = _b3_sum(need)
    bytes_ms = n["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = _b3_ops_ms(n)["ops"]
    tot = {"ms": _time_ms(rows_form, SERVE_ROWS_REPS),
           "solo_ms": _time_ms(solos, SERVE_ROWS_REPS),
           "plain_ms": _time_ms(plain, 1), "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    print(f"serve: per-row B3 ({len(calls)} calls): kernel {tot['ms']:.4f} "
          f"ms, the rows' solo launches {tot['solo_ms']:.4f} ms, plain "
          f"{tot['plain_ms']:.3f} ms, bound {tot['bound_ms']:.4f} ms by "
          f"{tot['bound_by']} (bytes {bytes_ms:.4f} ms, operations "
          f"{ops_ms:.4f} ms)")
    return tot


def _serve_clean(label: str, stats: dict) -> None:
    """A non-chaos run's executor stats: no solo fallback, degrade,
    failure or open breaker."""
    bad = {k: stats.get(k, 0) for k in ("batch_fallback_solo", "degraded",
                                          "failed") if stats.get(k, 0)}
    bad.update({f"breaker {e}": b["state"]
                for e, b in (stats.get("breakers") or {}).items()
                if b.get("state") != "closed"})
    reps = (stats.get("replicas") or {}).get("replicas") or []
    bad.update({f"replica {r['replica_id']}": r["breaker"] for r in reps
                if r["breaker"] != "closed"})
    if bad:
        raise AssertionError(f"serve: {label}: {bad}")


def phase_serve(n: int, tri_n: int) -> tuple:
    """Phase 20, the analysis service on the card.

    a. solo requests through the CLI's serve with --cache-dir and
       --max-workers 1: sampled GEMM 2n and n (ratio 0.1, seed 0, the
       device draw), syrk-tri --tri-n, exact GEMM n/2; each digest
       equal to the direct run_sampled's (and, at the default --n, to
       phase 19's), the exact one to its baseline; then the same lines
       again: every answer from the store, no kernel launched;
    b. one batch window (--batch-window-ms) of SERVE_BATCH: one batch,
       dispatches_batched counted, B1's and B3's per-row forms launched,
       each member's digest equal to its solo run; every per-row B1
       launch held against the same rows launched per program and
       against plain, every per-row B3 call against the rows' solo
       launches and plain, each form timed beside them; then the
       members through run_sampled_multi at capacity 2: regrows, equal
       digests;
    c. replicas 1 and 2 on one card (and one per card where more are
       visible): equal digests, the requests spread over the replicas;
    d. the check_chaos and check_precision twins at small size on the
       card.
    Every non-chaos run: no solo fallback, degrade, failure or open
    breaker. Returns (B1 launches, B3 launches, the per-row B1 totals,
    the per-row B3 totals)."""
    import shutil
    import tempfile

    import torch

    import pluss_sampler_optimization_torch.ops.sampled_hist as sh
    import pluss_sampler_optimization_torch.ops.threefry_draw as td
    from pluss_sampler_optimization_torch.config import (
        MachineConfig,
        ReplicaConfig,
        SamplerConfig,
    )
    from pluss_sampler_optimization_torch.runtime import telemetry
    from pluss_sampler_optimization_torch.runtime.aet import aet_mrc
    from pluss_sampler_optimization_torch.runtime.baseline import (
        load_baseline,
    )
    from pluss_sampler_optimization_torch.runtime.cri import cri_distribute
    from pluss_sampler_optimization_torch.runtime.obs import ledger
    from pluss_sampler_optimization_torch.sampler.sampled import (
        run_sampled_multi,
    )
    from pluss_sampler_optimization_torch.service import (
        AnalysisRequest,
        AnalysisService,
    )

    t_phase = time.perf_counter()
    machine = MachineConfig()
    b1 = b3 = 0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        # a. solo requests through serve, then again from the store
        solo = [("gemm", 2 * n), ("gemm", n), ("syrk-tri", tri_n)]
        direct = {size: _direct(_serve_program(m, size)) for m, size in solo}
        for m, size in solo:
            want = SERVE_DIGESTS.get(size) if m == "gemm" else None
            if want is not None and direct[size][0] != want:
                raise AssertionError(
                    f"serve: direct {m}({size}) digest {direct[size][0]}, "
                    f"phase 19's {want}")
        base = load_baseline("gemm", n // 2, machine)
        if base is None:
            raise AssertionError(f"serve: baselines/gemm{n // 2}.json.gz "
                                 "is missing")
        T = machine.thread_num
        base_digest = ledger.mrc_digest(
            aet_mrc(cri_distribute(base["state"], T, T), machine))
        lines = [_serve_request(m, size, 0) for m, size in solo]
        lines.append(_serve_request("gemm", n // 2, 0, "exact"))
        store, led = os.path.join(tmp, "store"), os.path.join(tmp, "l.jsonl")
        _reset_launches()
        first = _serve_cli(tmp, "solo", lines, store, led, "--max-workers",
                           "1")
        l1, _, l3 = _launches()
        if not (l1 and l3):
            raise AssertionError(f"serve: solo requests launched B1 {l1}, "
                                 f"B3 {l3} times")
        b1, b3 = b1 + l1, b3 + l3
        rows = [r for r in ledger.read_rows(led) if r.get("kind") == "request"]
        for doc, row, (m, size) in zip(first, rows, solo + [("exact", 0)]):
            want = base_digest if m == "exact" else direct[size][0]
            if not doc.get("ok") or doc.get("degraded") or (
                    doc.get("mrc_digest") != want):
                raise AssertionError(f"serve: {doc.get('id')}: {doc}")
            if m != "exact":
                # the request's own time: its latency less its wait for
                # the requests ahead of it (--max-workers 1)
                own = row["latency_s"] - row["queue_s"]
                print(f"serve: {doc['id']}: digest {want} equal to the "
                      f"direct run_sampled's; served in {own:.3f} s: "
                      f"executed in {row['execute_s']:.3f} s (run_sampled "
                      "and the record: cri, aet, the dump lines), then "
                      "the store's write and the ledger row "
                      f"{own - row['execute_s']:.3f} s; beside the direct "
                      f"run_sampled's {direct[size][1]:.3f} s: service "
                      f"overhead {own - direct[size][1]:.3f} s")
        if first[-1]["total_accesses"] != base["total_accesses"]:
            raise AssertionError("serve: the exact request's accesses differ "
                                 f"from baselines/gemm{n // 2}.json.gz")
        print(f"serve: exact gemm({n // 2}): engine "
              f"{first[-1]['engine_used']}, digest {base_digest} and "
              f"{base['total_accesses']} accesses equal "
              f"baselines/gemm{n // 2}.json.gz")
        lat = sorted(r["latency_s"] for r in rows)
        own = sorted(r["latency_s"] - r["queue_s"] for r in rows)
        print(f"serve: {len(rows)} solo requests, B1 {l1} and B3 {l3} "
              f"launches; latency p50 {ledger._percentile(lat, 0.5):.3f} s, "
              f"p99 {ledger._percentile(lat, 0.99):.3f} s (queued behind "
              f"one another); without the queue p50 "
              f"{ledger._percentile(own, 0.5):.3f} s, p99 "
              f"{ledger._percentile(own, 0.99):.3f} s")
        _reset_launches()
        again = _serve_cli(tmp, "again", lines, store, led)
        hit = _launches()
        rows = [r for r in ledger.read_rows(led)
                if r.get("kind") == "request"][len(lines):]
        if any(hit) or any(d.get("cache") != "disk" or d.get("mrc_digest")
                           != f.get("mrc_digest") for d, f in
                           zip(again, first)):
            raise AssertionError(f"serve: repeated requests launched {hit} "
                                 f"or were not answered from the store: "
                                 f"{[d.get('cache') for d in again]}")
        own = sorted(r["latency_s"] - (r.get("queue_s") or 0.0)
                     for r in rows)
        print(f"serve: the same {len(again)} requests again: every answer "
              "from the store (cache disk), no kernel launched; cache-hit "
              f"latency without the queue p50 "
              f"{ledger._percentile(own, 0.5) * 1e3:.2f} ms, p99 "
              f"{ledger._percentile(own, 0.99) * 1e3:.2f} ms (each reads and "
              "validates a record whose MRC holds "
              f"{first[0]['mrc_len']} points for GEMM {2 * n})")

        # b. one batch window of mixed models and sizes
        members = [_serve_request(m, size, seed)
                   for m, size, seed in SERVE_BATCH]
        solo_runs = [_direct(_serve_program(m, size), seed)
                     for m, size, seed in SERVE_BATCH]
        reqs = [AnalysisRequest(**{**d, "model": d.get("model", "custom")})
                for d in members]
        rec_b1, rec_b3, restore = _serve_rows_recording()
        rows0 = sh.ROWS_LAUNCHES, td.ROWS_LAUNCHES
        _reset_launches()
        tele = telemetry.enable()
        try:
            with AnalysisService(batch_window_ms=SERVE_BATCH_WINDOW_MS,
                                 batch_max_refs=1024) as svc:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tickets = [svc.submit(r) for r in reqs]
                resps = [svc.result(t) for t in tickets]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                stats = svc.executor.stats()
        finally:
            telemetry.disable()
            restore()
        l1, _, l3 = _launches()
        b1, b3 = b1 + l1, b3 + l3
        rows_b1, rows_b3 = (sh.ROWS_LAUNCHES - rows0[0],
                            td.ROWS_LAUNCHES - rows0[1])
        _serve_clean("batch window", stats)
        batched = tele.counters.get("dispatches_batched", 0)
        if not (stats.get("batches_formed") and batched and rows_b1
                and rows_b3) or stats.get("batch_members") != len(reqs):
            raise AssertionError(
                f"serve: batch window: {stats.get('batches_formed')} "
                f"batches of {stats.get('batch_members')} members, "
                f"{batched} batched dispatches, per-row B1 {rows_b1} and "
                f"B3 {rows_b3} launches")
        for r, (want, _), spec in zip(resps, solo_runs, SERVE_BATCH):
            if not r.ok or r.mrc_digest != want or r.degraded:
                raise AssertionError(f"serve: batch member {spec}: ok {r.ok}"
                                     f", digest {r.mrc_digest} vs solo "
                                     f"{want}, error {r.error}")
        print(f"serve: batch window: {len(reqs)} members in "
              f"{stats['batches_formed']} batch(es), {batched:g} batched "
              f"dispatches, per-row B1 {rows_b1} and B3 {rows_b3} launches "
              f"(B1 {l1}, B3 {l3} in all); every member's digest equal to "
              f"its solo run; the batched engine run (run_sampled_multi) "
              f"{resps[0].execute_s:.3f} s beside the members' solo "
              f"run_sampled walls {sum(w for _, w in solo_runs):.3f} s "
              f"({', '.join(f'{w:.3f}' for _, w in solo_runs)}); the "
              f"window's wall {wall:.3f} s (the {SERVE_BATCH_WINDOW_MS} ms "
              "window and each member's record: cri, aet)")
        rows_b1_tot = _serve_b1_rows(rec_b1)
        rows_b3_tot = _serve_b3_rows(rec_b3)
        del rec_b1, rec_b3
        jobs = [(_serve_program(m, size), machine,
                 SamplerConfig(ratio=0.1, seed=seed), False)
                for m, size, seed in SERVE_BATCH]
        counters: dict = {}
        _reset_launches()
        outs = run_sampled_multi(jobs, capacity=SERVE_REGROW_CAPACITY,
                                 counters=counters)
        l1, _, l3 = _launches()
        b1, b3 = b1 + l1, b3 + l3
        if not (l1 and l3):
            raise AssertionError(f"serve: run_sampled_multi launched B1 "
                                 f"{l1} and B3 {l3} times")
        got = [_digest(state, machine) for state, _ in outs]
        if got != [d for d, _ in solo_runs] or not counters.get(
                "capacity_regrows"):
            raise AssertionError(f"serve: run_sampled_multi at capacity "
                                 f"{SERVE_REGROW_CAPACITY}: {counters}")
        print(f"serve: run_sampled_multi at capacity "
              f"{SERVE_REGROW_CAPACITY}: {counters['capacity_regrows']} "
              f"regrows over {counters['dispatches_batched']} batched "
              "dispatches, every member's digest equal to its solo run")

        # c. replicas on one card (and one per card)
        want = [d for (m, size, seed), (d, _) in zip(SERVE_BATCH, solo_runs)
                if (m, size, seed) in SERVE_REPLICA_REQUESTS]
        layouts = [("1 replica", 1, ["cuda:0"]),
                   ("2 replicas on cuda:0", 2, ["cuda:0", "cuda:0"])]
        if torch.cuda.device_count() > 1:
            layouts.append((f"{torch.cuda.device_count()} replicas, one "
                            "per card", 0, None))
        for label, count, devices in layouts:
            _reset_launches()
            with AnalysisService(replicas=ReplicaConfig(count=count),
                                 device=devices) as svc:
                tickets = [svc.submit(AnalysisRequest(**_serve_request(
                    m, size, seed))) for m, size, seed in
                    SERVE_REPLICA_REQUESTS]
                resps = [svc.result(t) for t in tickets]
                stats = svc.executor.stats()
            l1, _, l3 = _launches()
            b1, b3 = b1 + l1, b3 + l3
            if not (l1 and l3):
                raise AssertionError(f"serve: {label}: B1 {l1} and B3 {l3} "
                                     "launches")
            _serve_clean(label, stats)
            if [r.mrc_digest for r in resps] != want or not all(
                    r.ok for r in resps):
                raise AssertionError(f"serve: {label}: digests "
                                     f"{[r.mrc_digest for r in resps]}")
            print(f"serve: {label}: {len(resps)} requests on replicas "
                  f"{[r.replica_id for r in resps]}, B1 {l1} and B3 {l3} "
                  "launches, digests equal to the solo runs")

        # d. the chaos and precision twins on the card
        t0 = time.perf_counter()
        _reset_launches()
        _tool("check_chaos", "--seeds", "1", "--device", "cuda")
        _tool("check_precision", "--seeds", "0", "--models", "gemm",
              "--device", "cuda")
        l1, _, l3 = _launches()
        b1, b3 = b1 + l1, b3 + l3
        if not l1:  # the progressive rounds classify on B1's raw form
            raise AssertionError("serve: the twins launched no B1")
        print(f"serve: check_chaos (seed 0) and check_precision (gemm, "
              f"seed 0) twins on the card: 0 problems, B1 {l1} and B3 {l3} "
              f"launches, {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"serve: phase 20 took {time.perf_counter() - t_phase:.1f} s, "
          f"B1 {b1} and B3 {b3} launches")
    return b1, b3, rows_b1_tot, rows_b3_tot


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2048,
                    help="GEMM size of the main and sharded paths; the "
                    "headline runs at 2n and the host draw at n/2")
    ap.add_argument("--tri-n", type=int, default=1536,
                    help="syrk-tri size of the triangular path (the "
                    "size of its serial-walk baseline by default)")
    ap.add_argument("--exact-only", action="store_true",
                    help="build, then only the exact engines' phase 17; "
                    "no result line")
    ap.add_argument("--frontend-only", action="store_true",
                    help="build, then only the frontend's phase 18; no "
                    "result line")
    ap.add_argument("--obs-only", action="store_true",
                    help="build, then only the observability phase 19 "
                    "(telemetry off/on/synced, the CLI's observability "
                    "flags, the drift audit, the stage profile, the "
                    "recorder and the tool twins); no result line")
    ap.add_argument("--serve-only", action="store_true",
                    help="build, then only the analysis service's phase "
                    "20 (serve with its store, a batch window on the "
                    "per-row forms of B1 and B3, replicas, the chaos and "
                    "precision twins); no result line")
    ap.add_argument("--scaling-only", action="store_true",
                    help="build, then only the sharded engine's fused "
                    "form over 1, 2, ... every visible card at GEMM n and "
                    "2n (the multi-card measurement); no result line")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from pluss_sampler_optimization_torch.config import SamplerConfig

    dev = torch.device("cuda")
    card = _card_line()
    print(f"card: {card}")
    sass = phase_build(buffer_form=not (args.scaling_only
                                        or args.exact_only
                                        or args.obs_only))
    cfg = SamplerConfig(ratio=0.1, seed=0)  # auto: the device draw here
    from pluss_sampler_optimization_torch.config import MachineConfig
    from pluss_sampler_optimization_torch.models import (
        REGISTRY,
        gemm,
        syrk_tri,
    )
    from pluss_sampler_optimization_torch.sampler.sampled import (
        run_sampled,
        warmup,
    )

    if args.scaling_only:
        wants = []
        for n in (args.n, 2 * args.n):
            warmup(gemm(n), MachineConfig(), cfg)
            wants.append(_state_mrc(run_sampled(gemm(n), MachineConfig(),
                                                cfg)[0], MachineConfig()))
        phase_scaling((args.n, 2 * args.n), cfg, wants)
        print(card)
        return 0
    if args.exact_only:
        phase_exact()
        print(card)
        return 0
    if args.frontend_only:
        phase_frontend()
        print(card)
        return 0
    if args.obs_only:
        for prog in (gemm(args.n), gemm(2 * args.n), gemm(args.n // 2),
                     gemm(1024), gemm(OBS_STAGES_N)):
            warmup(prog, MachineConfig(), cfg)
        phase_obs(args.n, card)
        print(card)
        return 0
    if args.serve_only:
        _buffer_form_built()
        phase_serve(args.n, args.tri_n)
        print(card)
        return 0
    phase_cold_warm(args.n, cfg)
    # every kernel the timed runs launch, built, loaded and launched once
    t0 = time.perf_counter()
    host_cfg = dataclasses.replace(cfg, device_draw=False)
    for prog, c in ((gemm(args.n), cfg), (gemm(2 * args.n), cfg),
                    (gemm(args.n // 2), host_cfg),
                    (syrk_tri(args.tri_n), cfg),
                    *((REGISTRY[m](*a), cfg) for m, a in TRI_MODELS)):
        warmup(prog, MachineConfig(), c)
    print(f"warmup: {time.perf_counter() - t0:.3f} s for the timed runs' "
          "programs")
    b2_err = phase_b2_made(dev)
    b3_err = phase_b3_made(dev)

    k = phase_kernels(gemm(args.n), cfg, dev)
    _b1_summary("kernels", k)
    kr = phase_kernels(gemm(args.n), cfg, dev, "raw kernels", raw=True)
    _b1_summary("raw kernels", kr)
    del kr["b3_calls"]
    b3 = phase_b3_engine(f"gemm({args.n})", k.pop("b3_calls"), sass,
                         b3_err)
    for n in (args.n, 2 * args.n):
        phase_draw_breakdown(n, cfg, dev, "draw breakdown")
    (b1_launches, b3["launches"]), main_path = phase_main_path(
        "main path", args.n, cfg, MAIN_PATH_ORDER, k["dispatches"],
        k["b3_launches"])
    head_calls: list = []
    (_, head_b3), head = phase_main_path("headline", 2 * args.n, cfg,
                                         ("cuda",), b3_calls=head_calls)
    b3["launches"] += head_b3
    phase_b3_engine(f"gemm({2 * args.n})", head_calls, sass, b3_err)
    del head_calls
    b1_launches += phase_pipeline(2 * args.n, cfg, head, args.n, main_path)
    raw_b1, raw_b3 = phase_raw_route(args.n, cfg, kr["dispatches"],
                                     main_path)
    b1_launches += raw_b1
    b3["launches"] += raw_b3
    phase_checkpoints(args.n, cfg, main_path)
    _, host_path = phase_main_path(
        "host draw", args.n // 2, dataclasses.replace(cfg, device_draw=False),
        MAIN_PATH_ORDER)
    launches, b1_sharded, inputs = phase_sharded(
        args.n, cfg, main_path, k["b3_launches"], args.n // 2)
    b2 = phase_b2_engine(inputs, b2_err)
    del inputs
    runs = [launches, phase_sharded_headline(2 * args.n, cfg, head),
            phase_scaling((args.n, 2 * args.n), cfg, (main_path, head)),
            phase_two_shards(cfg)]
    b1_launches += phase_progressive(args.n // 2, cfg, host_path)
    # the triangular path: syrk-tri through B3's tri draw and B1's
    # triangular walk, its dispatches held against the plain version
    kt = phase_kernels(syrk_tri(args.tri_n), cfg, dev, "tri kernels")
    _b1_summary("tri kernels", kt)
    phase_b3_engine(f"syrk-tri({args.tri_n})", kt.pop("b3_calls"), sass,
                    b3_err)
    tri_calls: list = []
    (tri_b1, tri_b3), _ = phase_main_path(
        "tri path", args.tri_n, cfg, MAIN_PATH_ORDER, kt["dispatches"],
        kt["b3_launches"], model="syrk-tri", b3_calls=tri_calls)
    b1_launches += tri_b1
    b3["launches"] += tri_b3
    for model, margs in TRI_MODELS:
        (tri_b1, tri_b3), _ = phase_main_path(
            "tri path", margs[0], cfg, MAIN_PATH_ORDER, model=model,
            args=margs, b3_calls=tri_calls)
        b1_launches += tri_b1
        b3["launches"] += tri_b3
    for i, call in enumerate(tri_calls):
        _b3_compare(f"tri path call {i}", call)
    print(f"B3 vs plain: all {len(tri_calls)} B3 calls of the triangular "
          "runs (syrk-tri, trmm, trisolv, covariance) equal")
    del tri_calls
    runs.append(phase_two_shards(cfg, *TWO_SHARD_TRI))
    b1_launches += phase_exact()[0]
    fe_b1, fe_b3, _, _ = phase_frontend()
    b1_launches += fe_b1
    b3["launches"] += fe_b3
    obs_b1, obs_b2, obs_b3 = phase_obs(args.n, card)
    b1_launches += obs_b1
    b3["launches"] += obs_b3
    serve_b1, serve_b3, rows_b1, rows_b3 = phase_serve(args.n, args.tri_n)
    b1_launches += serve_b1
    b3["launches"] += serve_b3
    b1_launches += sum(r[0] for r in runs)
    b2["launches"] = sum(r[1] for r in runs) + obs_b2
    b3["launches"] += sum(r[2] for r in runs)
    _b1_summary("sharded kernels (phase 10, all)", b1_sharded)
    b1 = _b1_entry([k, kt])
    b1["launches"] = b1_launches
    # the per-row forms (phase 20), beside their per-program launches
    bytes_ms = rows_b1["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = rows_b1["ops"] / INT32_ISSUES_PER_S * 1e3
    b1.update(rows_ms=rows_b1["ms"],
              rows_per_program_ms=rows_b1["per_program_ms"],
              rows_bound_ms=max(bytes_ms, ops_ms))
    b3.update(rows_ms=rows_b3["ms"], rows_solo_ms=rows_b3["solo_ms"],
              rows_bound_ms=rows_b3["bound_ms"])
    print(json.dumps({"kernels": [b1, b2, b3]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
