"""Command line of the port: the `acc`, `speed`, `sample`, `trace`, `analyze`, `stats`, `serve`, `serve-worker` and `serve-router` modes.

    python -m pluss_sampler_optimization_torch acc --model gemm --n 128
    python -m pluss_sampler_optimization_torch acc --engine exact --shard
    python -m pluss_sampler_optimization_torch acc --diff-against oracle
    python -m pluss_sampler_optimization_torch speed --engine periodic
    python -m pluss_sampler_optimization_torch trace --tid 0 --limit 20
    python -m pluss_sampler_optimization_torch sample --model gemm --n 128
    python -m pluss_sampler_optimization_torch sample --engine sharded
    python -m pluss_sampler_optimization_torch sample --runtime v2 --r10
    python -m pluss_sampler_optimization_torch sample --max-rounds 3
    python -m pluss_sampler_optimization_torch acc --engine native
    python -m pluss_sampler_optimization_torch analyze --model syrk-tri
    python -m pluss_sampler_optimization_torch --list-models
    python -m pluss_sampler_optimization_torch --dump-ir gemm --n 64 > g.json
    python -m pluss_sampler_optimization_torch acc --program-json g.json
    python -m pluss_sampler_optimization_torch sample --telemetry-out t.json \
        --trace-out c.json --metrics-out m.prom --ledger l.jsonl
    python -m pluss_sampler_optimization_torch stats --ledger l.jsonl
    python -m pluss_sampler_optimization_torch serve-router --workers 2 \
        --cache-dir st --requests r.jsonl

The modes of the JAX package's CLI, with its lines in its order:

- `acc`: one run of `--engine` (default dense), then the reference's
  accuracy dumps — the noshare and share private-reuse histograms, the
  distributed reuse-time dump, the miss-ratio curve and the
  max-iteration count (...ri-omp-seq.cpp:334-362). Engines: `oracle`
  (the serial walk; `--schedule dynamic` and `--runtime v2` apply to it
  alone), `numpy`, `native` and `native-par` (the C++ serial walk of
  native/ and its one-thread-per-simulated-thread form, built with make
  at first use), `dense`, `stream`, `periodic`, `analytic`, `exact`
  (the router: periodic, then analytic, then dense), `sampled`,
  `sharded`. `--shard` runs periodic, analytic and exact mesh-sharded
  over every visible card (one CPU device with `--device cpu`).
  `--diff-against ENGINE` runs a second engine and fails unless its
  dumps are byte-identical;
- `speed`: `--reps` timed runs of the engine after a cache flush each,
  then the best and mean and the flush's own cost;
- `sample`: the sampled engines, one line per tracked ref, the dumps,
  the per-ref r10 histograms under `--r10`, and the sample count.
  `--engine sharded` runs the mesh-sharded engine over every visible
  card, in its fused form where `--fuse-refs` resolves on (by default on
  CUDA); its lines equal `--engine sampled`'s. `--tolerance`,
  `--max-rounds` and `--round-schedule` run the sampled engine
  progressively (always on the host draw) and print `progressive:
  rounds a/b, band w, converged c` on stderr. `--device-draw` picks the
  draw (default auto: the device draw on CUDA, the host draw on the
  CPU). `--runtime v2` keeps noshare reuse raw in the state, `--r10`
  distributes with the r10 generated code's per-ref quirk copies; both
  take the sampled engine's raw route. `--fuse-refs`,
  `--pipeline-depth` and `--checkpoint-dir` change no printed line;
- `trace`: thread `--tid`'s access stream and its reuse pairs of at
  least `--min-reuse`, `--limit` rows each (the reference's -DDEBUG
  logs, runtime/debug.py);
- `analyze`: the static preflight passes (analysis/): well-formedness
  diagnostics, the dependence and race verdict and the locality bounds,
  as a summary or, with `--analysis-json`, the whole report; no engine
  runs. Exit 0 when the program can be simulated;
- `stats`: the run ledger at `--ledger` aggregated per engine (latency
  percentiles, cache hit rates, degradations, drift status), the JAX
  CLI's lines; no engine runs;
- `serve`: a JSONL request batch through the analysis service;
  `serve-worker` the same service behind the serving fabric's wire
  listener (`--listen`), `serve-router` the fabric's router over
  `--worker HOST:PORT` workers or `--workers N` supervised
  `serve-worker` processes (service/fabric/). A worker's
  `--worker-devices D` is D devices of its `--device`: the first D
  cards under `--device cuda`, else D replicas' worth of the one named
  device.

Observability (runtime/telemetry.py, runtime/obs/), in acc, speed,
sample and trace: `--telemetry-out PATH` records the run's spans,
counters, gauges, kernel builds and device/host metrics as the JAX
package's telemetry JSON and prints its summary on stderr;
`--trace-out PATH` writes the span tree as Chrome trace_event JSON and
`--metrics-out PATH` the counters and gauges as Prometheus text;
`--profile-dir PATH` wraps the run in torch.profiler (CPU and CUDA
activities) and writes its Chrome trace into PATH; `--ledger PATH`
appends one row per acc/speed/sample execution to a JSONL run ledger
(runtime/obs/ledger.py), with the JAX package's request fingerprint
for the engines its service runs.

`--program-json PATH` takes the program from a frontend document
(frontend/) instead of `--model`/`--n`/`--tsteps` in acc, speed, sample
and analyze, its machine knobs over `--threads`/`--chunk`; a rejected
document exits with the frontend's diagnostics. `--list-models` prints
the registry, `--dump-ir MODEL` its frontend document and
`--dump-ir-dir DIR` every model's, each without a mode. `--mrc-out PATH`
also writes the run's MRC there.

The engines run on CUDA unless `--device cpu` is given, and fail where
CUDA is absent; the oracle, numpy and native engines, `trace` and
`analyze` are host code.
"""

from __future__ import annotations

import argparse
import sys
import types

from .config import KERNEL_BACKENDS, MachineConfig, SamplerConfig

_SERVE_FAMILY = ("serve", "serve-worker", "serve-router")
ENGINES = ("oracle", "numpy", "native", "native-par", "dense", "stream",
           "periodic", "analytic", "exact", "sampled", "sharded")
_SHARDED_EXACT = ("periodic", "analytic", "exact")


def _parser() -> argparse.ArgumentParser:
    from .models import REGISTRY

    ap = argparse.ArgumentParser(prog="pluss_sampler_optimization_torch")
    ap.add_argument("mode", nargs="?",
                    choices=["acc", "speed", "sample", "trace", "serve",
                             "serve-worker", "serve-router", "analyze",
                             "stats"])
    ap.add_argument("--list-models", action="store_true",
                    help="print the model registry (nest/ref geometry "
                    "+ exact-router analytic audit status, from "
                    "sampler/analytic.py::AUDITED_FAMILIES) and exit")
    ap.add_argument("--model", default="gemm", choices=sorted(REGISTRY))
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--tsteps", type=int, default=1,
                    help="time steps (jacobi-2d, fdtd-2d, heat-3d, adi)")
    ap.add_argument("--dump-ir", default=None, metavar="MODEL",
                    help="print MODEL's canonical IR as a frontend "
                    "JSON document (at --n/--tsteps) and exit; the "
                    "dump round-trips through --program-json")
    ap.add_argument("--dump-ir-dir", default=None, metavar="DIR",
                    help="write every registry model's frontend JSON "
                    "to DIR/<model>.json (at --n) and exit")
    ap.add_argument("--program-json", default=None, metavar="PATH",
                    help="load the program from a frontend JSON "
                    "document instead of the model registry "
                    "(acc|speed|sample|analyze; overrides --model/"
                    "--n/--tsteps; document machine knobs override "
                    "--threads/--chunk). Rejections print the "
                    "frontend's machine-readable diagnostics")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--schedule", choices=["static", "dynamic"],
                    default="static",
                    help="chunk ownership: static round-robin (the "
                    "reference's live path) or the FIFO dynamic "
                    "dispatcher arm (oracle engine only)")
    ap.add_argument("--ratio", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default=None, choices=ENGINES,
                    help="default: dense (acc, speed), sampled (sample); "
                    "'exact' picks the fastest applicable exact engine: "
                    "periodic when its preconditions hold, then analytic "
                    "(closed-form next-use per period on kernel B1's raw "
                    "form — triangular nests and mixed parallel "
                    "coefficients), else dense with its memory route")
    ap.add_argument("--shard", action="store_true",
                    help="run the exact engines (periodic|analytic|exact) "
                    "mesh-sharded over every visible card (one CPU "
                    "device with --device cpu); results are the "
                    "single-device run's (the sampled engine's mesh path "
                    "is --engine sharded)")
    ap.add_argument("--device-draw", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="draw sample keys on the device with the threefry "
                    "PRNG (kernel B3 on the card) instead of numpy on the "
                    "host (default: auto, on for a CUDA device and off on "
                    "the CPU, as the JAX package's auto per backend)")
    ap.add_argument("--fuse-refs", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="sampled engine: stack refs sharing a "
                    "kernel-signature bucket into one dispatch per span "
                    "(default: auto, on for a CUDA device and off on the "
                    "CPU; results are bit-identical either way; "
                    "--no-fuse-refs keeps the per-ref serial runner as "
                    "the parity oracle)")
    ap.add_argument("--kernel-backend", default=None, choices=KERNEL_BACKENDS,
                    help="kernel implementation of the sampled engines and "
                    "the analytic engine (default auto: the CUDA kernels "
                    "on the card, plain torch on the CPU; native: the "
                    "sampled engine's CPU route through the native "
                    "library)")
    ap.add_argument("--pipeline-depth", type=int, default=None,
                    help="sampled engine: max in-flight dispatches "
                    "awaiting their device->host copy before the oldest "
                    "is drained (config default: 4; forced drains count "
                    "as pipeline_stalls)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="sample mode: persist finished per-ref results "
                    "here and resume an interrupted run")
    ap.add_argument("--runtime", choices=["v1", "v2"], default="v1",
                    help="histogram runtime semantics: v1 pow2-bins "
                    "noshare on insertion (pluss_utils.h:924-927), v2 "
                    "keeps raw keys (pluss_utils_v2.h:915-918); the "
                    "oracle and sampled engines")
    ap.add_argument("--r10", action="store_true",
                    help="distribute with the r10 generated-code quirk "
                    "copies per reference (...rs-ri-opt-r10.cpp:42-131) "
                    "instead of the runtime-v1 CRI model")
    ap.add_argument("--tolerance", type=float, default=None,
                    help="sampled engine: run progressively — rounds "
                    "of increasing sample-stream prefixes — and stop "
                    "early once the bootstrap MRC confidence band is "
                    "narrower than this width (0 disables early stop "
                    "but still streams per-round bands; a full "
                    "schedule is bit-identical to the one-shot run)")
    ap.add_argument("--max-rounds", type=int, default=None,
                    help="progressive sampled engine: schedule length "
                    "when --round-schedule is not given (geometric "
                    "doubling 1/2^(R-1)..1; default 4)")
    ap.add_argument("--round-schedule", default=None,
                    help="progressive sampled engine: explicit "
                    "comma-separated increasing fractions of the "
                    "final sample count, ending at 1.0 — e.g. "
                    "0.25,0.5,1.0")
    ap.add_argument("--reps", type=int, default=10,
                    help="speed mode: timed runs")
    ap.add_argument("--tid", type=int, default=0, help="trace mode thread")
    ap.add_argument("--min-reuse", type=int, default=512,
                    help="trace mode reuse-pair threshold (DEBUG >= 512)")
    ap.add_argument("--limit", type=int, default=50,
                    help="trace mode row limit")
    ap.add_argument("--mrc-out", default=None,
                    help="also write the MRC to this file")
    ap.add_argument("--analysis-json", action="store_true",
                    help="analyze mode: emit the full machine-"
                    "readable analysis report (diagnostics, "
                    "classified dependences, bounds) as JSON instead "
                    "of the summary table")
    ap.add_argument("--diff-against", default=None, metavar="ENGINE",
                    help="run a second engine and fail unless its dumps "
                    "are byte-identical (the reference's output.txt diff "
                    "protocol; compare full-traversal engines with each "
                    "other, or sampled with sharded)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; serve and --cache-dir "
                    "also take a device such as cuda:0, on which "
                    "--replicas K serves K replicas")
    ap.add_argument("--telemetry-out", default=None, metavar="PATH",
                    help="record engine-stage spans, dispatch/fetch "
                    "counters, kernel builds, and device/host metrics for "
                    "this run and write them as structured JSON to PATH "
                    "(the JAX package's schema; validate with the "
                    "check_telemetry_schema tool). A compact summary "
                    "prints to stderr")
    ap.add_argument("--profile-dir", default=None, metavar="PATH",
                    help="wrap the run in torch.profiler (CPU and CUDA "
                    "activities) and write its Chrome trace into PATH "
                    "(open at ui.perfetto.dev). Independent of "
                    "--telemetry-out")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export this run's telemetry span tree as Chrome "
                    "trace_event JSON at PATH (Perfetto, chrome://tracing)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="export this run's telemetry counters/gauges as "
                    "Prometheus text exposition at PATH (counters as "
                    "*_total, plus the run duration)")
    ap.add_argument("--ledger", default=None, metavar="PATH",
                    help="append one row per acc/speed/sample execution to "
                    "this JSONL run ledger (fingerprint, engine, latency, "
                    "kernel-build deltas, MRC digest); `stats` mode "
                    "aggregates a ledger and the check_ledger tool "
                    "validates it")
    ap.add_argument(
        "--cache-dir",
        default=None,
        metavar="DIR",
        help="serve results through the analysis service's "
        "content-addressed store rooted at DIR (serve mode, and "
        "acc/speed/sample for the plain request pipeline): a repeated "
        "request returns the stored bit-identical result with zero "
        "engine work. See README \"Serving\".",
    )
    ap.add_argument(
        "--deadline-s",
        type=float,
        default=None,
        metavar="SECONDS",
        help="per-request deadline for service-routed runs "
        "(--cache-dir / serve mode): an engine overrunning it "
        "degrades down the chain (exact -> sampled, ...), recorded "
        "in the response and as a telemetry event",
    )
    ap.add_argument(
        "--requests",
        default="-",
        metavar="PATH",
        help="serve mode: JSONL request batch to process ('-' = "
        "stdin; one JSON request object per line, README \"Serving\")",
    )
    ap.add_argument(
        "--responses",
        default="-",
        metavar="PATH",
        help="serve mode: where to write the JSONL responses "
        "('-' = stdout)",
    )
    ap.add_argument(
        "--max-workers",
        type=int,
        default=4,
        metavar="N",
        help="serve mode: concurrent request executions (bounded "
        "pool; identical in-flight requests coalesce regardless)",
    )
    ap.add_argument(
        "--batch-window-ms",
        type=float,
        default=None,
        metavar="MS",
        help="service-routed runs (--cache-dir / serve mode): hold "
        "compatible concurrent sampled requests in an admission "
        "window up to MS milliseconds and run each flushed window as "
        "ONE batched engine execution over the union of their kernel "
        "buckets. Every member's MRC stays bit-identical to its solo "
        "run, so this is a pure latency-for-throughput knob (default: "
        "off). See README \"Cross-request batching\".",
    )
    ap.add_argument(
        "--batch-max-refs",
        type=int,
        default=64,
        metavar="N",
        help="with --batch-window-ms: flush a forming batch early "
        "once its summed tracked-ref count reaches N; overflow "
        "requests start the next batch (default: 64)",
    )
    ap.add_argument(
        "--replicas",
        type=int,
        default=None,
        metavar="K",
        help="service-routed runs (--cache-dir / serve mode): "
        "partition the devices into K independent replica executors "
        "(each with its own device group, mesh, and queue) and route "
        "every execution to the least-loaded one, with work stealing "
        "and failure quarantine. 0 = auto (one replica per device: "
        "every visible card under the default --device cuda; a named "
        "--device such as cuda:0 or cpu serves K replicas on it). "
        "Pure scheduling: MRC bytes are bit-identical for any K. "
        "Default: no pool (the single-device-set path). See README "
        "\"Replica serving\".",
    )
    ap.add_argument(
        "--fault-spec",
        default=None,
        metavar="FILE",
        help="serve mode: arm deterministic fault injection from a "
        "JSON spec ({\"seed\": S, \"rules\": [{\"site\": ..., "
        "\"kind\": ..., \"p\": ..., ...}]}). Sites: engine_execute, "
        "replica_dispatch, cache_load, cache_store, serve_line; "
        "kinds: raise, latency, hang, corrupt, compile_failure. "
        "Decisions come from a seeded counter hash, so a chaos run "
        "replays exactly from (seed, spec). See README \"Overload, "
        "retries & chaos testing\".",
    )
    ap.add_argument(
        "--attempt-timeout-s",
        type=float,
        default=None,
        metavar="SECONDS",
        help="service-routed runs (--cache-dir / serve mode): bound "
        "every engine attempt to SECONDS (tighter of this and the "
        "request deadline); an overrun attempt is abandoned and — "
        "with --max-retries — retried with seeded exponential "
        "backoff. Default: attempts are bounded by the request "
        "deadline only.",
    )
    ap.add_argument(
        "--max-retries",
        type=int,
        default=None,
        metavar="N",
        help="service-routed runs: retry a failed or timed-out "
        "engine attempt up to N times (deterministic seeded backoff "
        "jitter — replays exactly) before degrading down the chain "
        "(default: 0, no retries)",
    )
    ap.add_argument(
        "--hedge-after-s",
        type=float,
        default=None,
        metavar="SECONDS",
        help="service-routed runs with >= 2 replicas: duplicate a "
        "dispatch still unresolved after SECONDS onto a second "
        "replica; first result wins, the queued loser is cancelled. "
        "Results are bit-identical either way (tail-latency "
        "insurance only). Default: no hedging.",
    )
    ap.add_argument(
        "--queue-limit",
        type=int,
        default=None,
        metavar="N",
        help="service-routed runs: admission control — shed a "
        "submission (structured `shed: true` response in "
        "microseconds) when the executor queue is already N deep "
        "for its priority class (low sheds at 50%% of N, normal at "
        "75%%, high at 100%%). Default: unbounded queue, no "
        "shedding.",
    )
    ap.add_argument(
        "--no-shed",
        action="store_true",
        help="with --queue-limit: disable the shedding gate (keep "
        "the limit configured but admit everything) — the overload "
        "baseline tools/check_chaos.py and bench.py compare against",
    )
    ap.add_argument(
        "--breaker-failures",
        type=int,
        default=None,
        metavar="N",
        help="service-routed runs: consecutive failures that OPEN a "
        "per-engine/per-replica circuit breaker (default: 8)",
    )
    ap.add_argument(
        "--breaker-probation-s",
        type=float,
        default=None,
        metavar="SECONDS",
        help="service-routed runs: how long an open breaker fails "
        "fast before admitting one half-open probe; a failed probe "
        "re-opens with the probation escalated (default: 30)",
    )
    ap.add_argument(
        "--warmup-from-ledger",
        type=int,
        default=None,
        metavar="N",
        help="serve mode, with --ledger: before processing requests, "
        "pre-compile the sampled kernel signatures of the N most "
        "frequent fingerprints in the ledger — the first real request "
        "after a restart skips cold jit (its ledger row records "
        "near-zero compile deltas)",
    )
    ap.add_argument(
        "--metrics-port",
        type=int,
        default=None,
        metavar="PORT",
        help="serve mode: expose the live metrics registry on "
        "http://127.0.0.1:PORT/metrics in Prometheus text format "
        "(counters with rolling 30s/5m windows, gauges, per-stage "
        "request latency histograms with trace-id exemplars). 0 "
        "binds an ephemeral port, printed to stderr. The registry "
        "itself is always on in serve mode; this flag only adds the "
        "scrape endpoint. See README \"Live metrics & SLOs\".",
    )
    ap.add_argument(
        "--profile-hz",
        type=float,
        default=None,
        metavar="HZ",
        help="serve mode: run the sampling wall-clock profiler — a "
        "background thread samples every live thread's Python stack "
        "HZ times a second, tags each sample with the thread's "
        "current telemetry span path (draw/dispatch/fetch/merge/"
        "queue/... or 'unattributed'), and folds them into bounded "
        "collapsed-stack counts. Scrape the live snapshot at "
        "GET /debug/profile (with --metrics-port); anomaly "
        "post-mortem bundles carry it too. Default: off. See README "
        "\"Continuous profiling & utilization\".",
    )
    ap.add_argument(
        "--profile-out",
        default=None,
        metavar="PATH",
        help="with --profile-hz: at serve exit, write the collected "
        "profile as speedscope-compatible JSON to PATH (drop it on "
        "https://www.speedscope.app) and the collapsed-stack text "
        "to PATH + '.collapsed'",
    )
    ap.add_argument(
        "--slo-latency-p95-s",
        type=float,
        default=None,
        metavar="SECONDS",
        help="serve mode: run the SLO sentinel with a total-latency "
        "objective — at most 5%% of requests may exceed SECONDS; a "
        "multi-window burn rate above --slo-burn-threshold in BOTH "
        "rolling windows emits slo_breach telemetry",
    )
    ap.add_argument(
        "--slo-error-budget",
        type=float,
        default=None,
        metavar="FRACTION",
        help="serve mode: run the SLO sentinel with an error "
        "objective — at most FRACTION of requests may fail or "
        "complete degraded (burn-rate semantics as above)",
    )
    ap.add_argument(
        "--slo-burn-threshold",
        type=float,
        default=1.0,
        metavar="X",
        help="SLO sentinel burn-rate trip point (default 1.0 = "
        "budget consumed exactly as fast as the objective allows)",
    )
    ap.add_argument(
        "--slo-interval-s",
        type=float,
        default=10.0,
        metavar="SECONDS",
        help="SLO sentinel evaluation period (default 10); a final "
        "evaluation always runs when the serve batch completes",
    )
    ap.add_argument(
        "--debug-bundle-dir",
        default=None,
        metavar="DIR",
        help="serve mode: run the flight recorder — a bounded ring "
        "of per-request records with tail-based retention (errors, "
        "degradations, drift breaches, latency outliers kept) that "
        "writes an atomic schema-versioned post-mortem bundle under "
        "DIR on SLO breach, request failure, replica quarantine, "
        "drift breach, perf regression, an explicit dump_debug "
        "request, or SIGUSR2. See README \"Flight recorder & "
        "post-mortems\".",
    )
    ap.add_argument(
        "--regress-bench",
        default=None,
        metavar="GLOB",
        help="serve mode: additionally feed BENCH_r*.json evidence "
        "files matching GLOB into the SLO sentinel's perf-regression "
        "leg (the ledger tail is always evaluated when --ledger is "
        "set); a breach counts perf_regression and triggers a "
        "post-mortem bundle",
    )
    ap.add_argument(
        "--ledger-gc-interval-s",
        type=float,
        default=None,
        metavar="SECONDS",
        help="serve mode: compact the run ledger in the background "
        "every SECONDS (atomic rewrite dropping invalid lines and "
        "rows beyond --ledger-max-rows), so soak runs don't grow it "
        "unbounded; GC passes are counted in the live registry "
        "(ledger_gc_runs / ledger_gc_dropped). Needs --ledger.",
    )
    ap.add_argument(
        "--ledger-max-rows",
        type=int,
        default=0,
        metavar="N",
        help="with --ledger-gc-interval-s: keep only the newest N "
        "rows at each GC pass (0 = drop only invalid lines)",
    )
    ap.add_argument(
        "--stats-interval-s",
        type=float,
        default=None,
        metavar="SECONDS",
        help="serve-router: fleet telemetry poll period — how often "
        "the router pulls each worker's stats/metrics/slo_inputs "
        "snapshot over the wire (default 5)",
    )
    ap.add_argument(
        "--listen",
        default=None,
        metavar="HOST:PORT",
        help="serve-worker: bind the fabric wire listener here "
        "(default 127.0.0.1:0 = ephemeral; the bound address prints "
        "as a 'fabric-worker ready' line on stdout). serve-router: "
        "additionally accept plain JSONL TCP clients here (loadgen "
        "--connect drives it); without it the router serves the "
        "--requests batch only.",
    )
    ap.add_argument(
        "--worker",
        action="append",
        default=None,
        metavar="HOST:PORT",
        help="serve-router: a fabric worker's wire address "
        "(repeatable — one per externally-launched serve-worker "
        "process). Mutually exclusive with --workers.",
    )
    ap.add_argument(
        "--workers",
        type=int,
        default=None,
        metavar="N",
        help="serve-router: supervise N serve-worker subprocesses "
        "(ephemeral ports, worker ids 0..N-1), forwarding the "
        "service flags and --device (--cache-dir is the SHARED disk "
        "tier, --ledger the shared run ledger) and reaping every "
        "child on exit — zero orphans. Mutually exclusive with "
        "--worker.",
    )
    ap.add_argument(
        "--worker-id",
        type=int,
        default=0,
        metavar="K",
        help="serve-worker: this worker's id — its position in the "
        "router's consistent-hash ring and the worker_id stamped on "
        "its ledger rows (default 0; the --workers supervisor "
        "assigns 0..N-1)",
    )
    ap.add_argument(
        "--worker-devices",
        type=int,
        default=None,
        metavar="D",
        help="serve-worker: serve on D devices of --device: the "
        "first D cards under --device cuda (refused past the visible "
        "count), else D replicas' worth of the one named device "
        "(cpu, cuda:K). With --workers the supervisor forwards it to "
        "every child.",
    )
    ap.add_argument(
        "--hb-interval-s",
        type=float,
        default=None,
        metavar="SECONDS",
        help="fabric heartbeat period: the router pings every link "
        "this often (default 2)",
    )
    ap.add_argument(
        "--hb-timeout-s",
        type=float,
        default=None,
        metavar="SECONDS",
        help="fabric liveness bound: a link silent this long is "
        "declared failed and reconnected (default 10)",
    )
    ap.add_argument(
        "--reconnect-attempts",
        type=int,
        default=None,
        metavar="N",
        help="fabric: consecutive failed reconnects before a worker "
        "is declared DEAD and its in-flight requests re-dispatch to "
        "each fingerprint's ring successor (default 3)",
    )
    ap.add_argument(
        "--reconnect-delay-s",
        type=float,
        default=None,
        metavar="SECONDS",
        help="fabric: pause between reconnect attempts (default 0.2)",
    )
    ap.add_argument(
        "--no-fabric-trace",
        action="store_true",
        help="serve-router: disable distributed tracing (no trace "
        "blocks on wire frames, no router ledger rows). MRC bytes "
        "are bit-identical either way — tracing is pure serving "
        "metadata",
    )
    return ap


def _parse_round_schedule(spec: str) -> tuple:
    """"0.25,0.5,1.0" -> (0.25, 0.5, 1.0); validation happens where
    the schedule is resolved (sampler/confidence.py)."""
    try:
        return tuple(float(f) for f in spec.split(",") if f.strip())
    except ValueError:
        raise SystemExit(
            f"--round-schedule wants comma-separated floats, got "
            f"{spec!r}"
        )


def _sampler_config(args) -> SamplerConfig:
    kw = {}
    if args.pipeline_depth is not None:  # None = keep the config default
        kw["pipeline_depth"] = args.pipeline_depth
    if args.round_schedule is not None:
        kw["round_schedule"] = _parse_round_schedule(args.round_schedule)
    return SamplerConfig(
        ratio=args.ratio, seed=args.seed, device_draw=args.device_draw,
        kernel_backend=args.kernel_backend, fuse_refs=args.fuse_refs,
        tolerance=args.tolerance, max_rounds=args.max_rounds, **kw,
    )


def _run_sampled(program, machine, args, engine: str):
    """(PRIState, per-ref results) of a sampled engine; the raw route
    under --runtime v2 or --r10 (the sharded engine's results always
    keep raw keys)."""
    cfg = _sampler_config(args)
    v2 = args.runtime == "v2"
    progressive = any(
        v is not None for v in (args.tolerance, args.max_rounds,
                                args.round_schedule)
    )
    if engine == "sharded":
        from .parallel import run_sampled_sharded

        return run_sampled_sharded(program, machine, cfg,
                                   device=args.device, v2=v2)
    if progressive:
        from .sampler.sampled import run_sampled_progressive

        state, per_ref, info = run_sampled_progressive(
            program, machine, cfg, v2=v2, device=args.device,
        )
        print(
            f"progressive: rounds "
            f"{info['rounds']}/{info['rounds_total']}, band "
            f"{info['band_width']:.6f}, converged "
            f"{info['converged']}",
            file=sys.stderr,
        )
        return state, per_ref
    from .sampler.sampled import run_sampled

    return run_sampled(program, machine, cfg, v2=v2, device=args.device,
                       raw_noshare=v2 or args.r10,
                       checkpoint_dir=args.checkpoint_dir)


def _run_engine(engine: str, program, machine, args):
    """One run -> (OracleResult-like, per-ref sampled results or None)."""
    if engine == "oracle":
        from .oracle.serial import run_serial

        return run_serial(
            program, machine, v2=args.runtime == "v2",
            schedule=args.schedule,
        ), None
    if args.schedule == "dynamic":
        raise SystemExit(
            "--schedule dynamic is modeled by the oracle engine only "
            "(the reference's dynamic dispatcher arm is dead code with "
            "no live sampler; use --engine oracle)"
        )
    if engine == "numpy":
        from .oracle.numpy_ref import run_numpy

        return run_numpy(program, machine), None
    if engine in ("native", "native-par"):
        from . import native
        from .ops import _build

        _build.ensure_native()
        run = (native.run_serial_native if engine == "native"
               else native.run_parallel_native)
        return run(program, machine), None
    if engine in _SHARDED_EXACT and args.shard:
        from .parallel.sharded import (
            _resolve_mesh,
            run_analytic_sharded,
            run_exact_sharded,
            run_periodic_sharded,
        )

        mesh = _resolve_mesh(None, args.device)
        if engine == "analytic":
            return run_analytic_sharded(
                program, machine, mesh,
                kernel_backend=args.kernel_backend or "auto"), None
        fn = {"periodic": run_periodic_sharded,
              "exact": run_exact_sharded}[engine]
        return fn(program, machine, mesh), None
    if engine == "dense":
        from .sampler.dense import run_dense

        return run_dense(program, machine, device=args.device), None
    if engine == "stream":
        from .sampler.stream import run_stream

        return run_stream(program, machine, device=args.device), None
    if engine == "periodic":
        from .sampler.periodic import run_periodic

        return run_periodic(program, machine, device=args.device), None
    if engine == "exact":
        from .sampler.periodic import run_exact

        return run_exact(program, machine, device=args.device), None
    if engine == "analytic":
        from .sampler.analytic import run_analytic

        return run_analytic(
            program, machine, device=args.device,
            kernel_backend=args.kernel_backend or "auto"), None
    state, per_ref = _run_sampled(program, machine, args, engine)
    # sampled engines track samples, not accesses
    return types.SimpleNamespace(
        state=state, total_accesses=sum(r.n_samples for r in per_ref),
    ), per_ref


def result_lines(state, per_ref, machine, r10: bool = False,
                 total: int | None = None,
                 ref_lines: bool = True) -> tuple[list[str], object]:
    """(the dump lines, the MRC) of one run's folded state. The lines:
    the per-ref lines of a sampled run (`ref_lines`, sample mode), the
    noshare and share dumps, the per-ref r10 histograms under `r10`
    (results of the raw route), the distributed reuse-time dump, the
    MRC, and the max-iteration count (`total`, default the runs'
    samples; "samples" for a sampled run, "accesses" for an exact one,
    per_ref None)."""
    from .runtime import report
    from .runtime.aet import aet_mrc
    from .runtime.cri import cri_distribute, r10_distribute

    lines = []
    if ref_lines and per_ref is not None:
        lines += [
            f"ref {r.name}: {r.n_samples} samples, cold {r.cold:g}"
            for r in per_ref
        ]
    lines += report.noshare_dump(state)
    lines += report.share_dump(state)
    if r10:
        if per_ref is None:
            raise SystemExit("--r10 needs a sampled engine (sample mode)")
        rih, per_ref_hists = r10_distribute(per_ref, machine.thread_num)
        for name, h in per_ref_hists.items():
            lines += report.histogram_lines(name, h)
    else:
        rih = cri_distribute(state, machine.thread_num, machine.thread_num)
    lines += report.rih_dump(rih)
    mrc = aet_mrc(rih, machine)
    lines += report.mrc_lines(mrc)
    if total is None:
        total = sum(r.n_samples for r in per_ref)
    label = "samples" if per_ref is not None else "accesses"
    lines.append(f"max iteration count: {total} {label}")
    return lines, mrc


def _check_args(args, engine: str) -> None:
    """The JAX CLI's refusals of flags that do not apply."""
    if args.checkpoint_dir is not None and engine != "sampled":
        raise SystemExit(
            "--checkpoint-dir is supported by the sampled engine only"
        )
    if args.mode == "sample" and engine not in ("sampled", "sharded"):
        raise SystemExit("sample mode needs --engine sampled|sharded")
    if args.shard and engine not in _SHARDED_EXACT:
        raise SystemExit(
            "--shard applies to the exact engines "
            "(periodic|analytic|exact); the sampled engine's mesh "
            "path is --engine sharded"
        )
    if args.device_draw is not None and engine not in (
        "sampled", "sharded"
    ):
        raise SystemExit(
            "--device-draw applies to the sampled/sharded engines "
            "only (the exact engines do not sample)"
        )
    if args.kernel_backend is not None and engine not in (
        "sampled", "sharded", "analytic"
    ):
        raise SystemExit(
            "--kernel-backend applies to the sampled, sharded and "
            "analytic engines only"
        )
    if args.diff_against:
        if args.mode not in ("acc", "sample"):
            raise SystemExit(
                "--diff-against compares acc/sample dumps; it has no "
                "meaning in speed or trace mode"
            )
        if args.diff_against not in ENGINES:
            raise SystemExit(
                f"unknown --diff-against engine {args.diff_against!r} "
                f"(have {', '.join(ENGINES)})"
            )
    if args.ledger and args.mode == "trace":
        raise SystemExit(
            "--ledger records engine/service executions (acc|speed|"
            "sample|serve|stats); trace mode has none"
        )
    if args.cache_dir:
        if args.mode == "trace":
            raise SystemExit(
                "--cache-dir serves analysis results (acc|speed|"
                "sample|serve); trace mode has none"
            )
        from .service.executor import SERVICE_ENGINES

        if engine not in SERVICE_ENGINES:
            raise SystemExit(
                f"--cache-dir serves the request pipeline engines "
                f"({', '.join(SERVICE_ENGINES)}); {engine!r} is not "
                "one of them"
            )
        blocked = [
            flag for flag, on in (
                ("--r10", args.r10),
                ("--diff-against", args.diff_against),
                ("--checkpoint-dir", args.checkpoint_dir),
                ("--shard", args.shard),
            ) if on
        ]
        if blocked:
            raise SystemExit(
                f"--cache-dir serves the plain request pipeline; it "
                f"does not compose with {', '.join(blocked)}"
            )
    elif args.deadline_s is not None:
        raise SystemExit(
            "--deadline-s bounds service-routed requests; it needs "
            "--cache-dir (or serve mode, where each request line "
            "carries its own deadline_s)"
        )
    if args.batch_window_ms is not None and not args.cache_dir:
        raise SystemExit(
            "--batch-window-ms batches service-routed requests; it "
            "needs --cache-dir (or serve mode)"
        )
    if args.replicas is not None and not args.cache_dir:
        raise SystemExit(
            "--replicas partitions the service's devices into "
            "replica executors; it needs --cache-dir (or serve mode)"
        )
    _res_flags = [
        flag for flag, on in (
            ("--attempt-timeout-s", args.attempt_timeout_s is not None),
            ("--max-retries", args.max_retries is not None),
            ("--hedge-after-s", args.hedge_after_s is not None),
            ("--queue-limit", args.queue_limit is not None),
            ("--breaker-failures", args.breaker_failures is not None),
            ("--breaker-probation-s",
             args.breaker_probation_s is not None),
        ) if on
    ]
    if _res_flags and not args.cache_dir:
        raise SystemExit(
            f"{', '.join(_res_flags)} configure(s) service-routed "
            "execution; they need --cache-dir (or serve mode)"
        )



def _check_serve_args(args) -> None:
    """The JAX CLI's checks of the serving and fabric flags; past them,
    a worker's --worker-devices D under --device cuda must not exceed
    the visible cards."""
    _fabric_flags = [
        flag for flag, on in (
            ("--listen", args.listen is not None),
            ("--worker", args.worker is not None),
            ("--workers", args.workers is not None),
            ("--worker-id", args.worker_id != 0),
            ("--worker-devices", args.worker_devices is not None),
            ("--hb-interval-s", args.hb_interval_s is not None),
            ("--hb-timeout-s", args.hb_timeout_s is not None),
            ("--reconnect-attempts",
             args.reconnect_attempts is not None),
            ("--reconnect-delay-s",
             args.reconnect_delay_s is not None),
            ("--stats-interval-s",
             args.stats_interval_s is not None),
            ("--no-fabric-trace", args.no_fabric_trace),
        ) if on
    ]
    if _fabric_flags and args.mode not in ("serve-worker",
                                           "serve-router"):
        raise SystemExit(
            f"{', '.join(_fabric_flags)} configure(s) the serving "
            "fabric; they apply to serve-worker/serve-router only"
        )
    if args.mode == "serve-router":
        if (args.worker is None) == (args.workers is None):
            raise SystemExit(
                "serve-router needs exactly one of --worker "
                "HOST:PORT (repeatable, external workers) or "
                "--workers N (supervised subprocesses)"
            )
        if args.workers is not None and args.workers < 1:
            raise SystemExit("--workers must be >= 1")
        # --slo-latency-p95-s/--slo-error-budget are fleet-level on
        # the router: the sentinel evaluates over the workers' merged
        # slo_inputs (runtime/obs/fleet.FleetView), not local engine
        # counters
        _worker_side = [
            flag for flag, on in (
                ("--profile-hz", args.profile_hz is not None),
                ("--regress-bench", args.regress_bench is not None),
                ("--ledger-gc-interval-s",
                 args.ledger_gc_interval_s is not None),
            ) if on
        ]
        if _worker_side:
            raise SystemExit(
                f"{', '.join(_worker_side)} observe engine "
                "execution; run them on the serve-worker processes "
                "(the router executes no engine work)"
            )
    if args.mode == "serve-worker":
        if args.worker is not None or args.workers is not None:
            raise SystemExit(
                "--worker/--workers describe the router's worker "
                "set; serve-worker takes --listen/--worker-id"
            )
        if args.worker_id < 0:
            raise SystemExit("--worker-id must be >= 0")
        if args.worker_devices is not None and args.worker_devices < 1:
            raise SystemExit("--worker-devices must be >= 1")
    if args.worker_devices is not None and args.device == "cuda":
        import torch

        have = torch.cuda.device_count()
        if args.worker_devices > have:
            raise SystemExit(
                f"--worker-devices {args.worker_devices} takes the "
                f"first {args.worker_devices} cards of --device cuda; "
                f"{have} visible (name one device, --device cpu or "
                "cuda:K, to serve replicas of it)"
            )
    if args.mode not in _SERVE_FAMILY:
        if args.warmup_from_ledger is not None:
            raise SystemExit(
                "--warmup-from-ledger pre-compiles serving kernels at "
                "startup; it applies to serve mode only"
            )
        if args.metrics_port is not None:
            raise SystemExit(
                "--metrics-port exposes the live serving registry; "
                "it applies to serve mode only"
            )
        if args.profile_hz is not None or args.profile_out is not None:
            raise SystemExit(
                "--profile-hz/--profile-out run the serving "
                "sampling profiler; they apply to serve mode only "
                "(offline stage profiles come from "
                "tools/profile_stages.py)"
            )
        if (args.slo_latency_p95_s is not None
                or args.slo_error_budget is not None):
            raise SystemExit(
                "--slo-* flags run the serving SLO sentinel; they "
                "apply to serve mode only (offline ledgers are gated "
                "by tools/check_slo.py)"
            )
        if args.debug_bundle_dir is not None:
            raise SystemExit(
                "--debug-bundle-dir runs the serving flight "
                "recorder; it applies to serve mode only"
            )
        if args.regress_bench is not None:
            raise SystemExit(
                "--regress-bench feeds the serving perf-regression "
                "sentinel; it applies to serve mode only (offline "
                "history is gated by tools/check_regression.py)"
            )
        if args.ledger_gc_interval_s is not None:
            raise SystemExit(
                "--ledger-gc-interval-s runs background ledger "
                "compaction for serve mode only (offline ledgers are "
                "compacted by tools/check_ledger.py --gc)"
            )
        if args.fault_spec is not None:
            raise SystemExit(
                "--fault-spec arms deterministic fault injection on "
                "the serving hot paths; it applies to serve mode only"
            )
    if args.ledger_gc_interval_s is not None and not args.ledger:
        raise SystemExit(
            "--ledger-gc-interval-s compacts the run ledger; it "
            "needs --ledger PATH"
        )

    if args.profile_hz is not None and args.profile_hz <= 0:
        raise SystemExit("--profile-hz must be > 0 (samples per "
                         "second; omit the flag to keep the profiler "
                         "off)")
    if args.profile_out is not None and args.profile_hz is None:
        raise SystemExit("--profile-out exports the collected "
                         "profile; it needs --profile-hz")
    if args.replicas is not None and args.replicas < 0:
        raise SystemExit("--replicas must be >= 0 (0 = auto, one "
                         "replica per device)")
    if args.queue_limit is not None and args.queue_limit < 1:
        raise SystemExit("--queue-limit must be >= 1")
    if args.no_shed and args.queue_limit is None:
        raise SystemExit(
            "--no-shed disables the admission gate configured by "
            "--queue-limit; it needs --queue-limit N"
        )
    if args.max_retries is not None and args.max_retries < 0:
        raise SystemExit("--max-retries must be >= 0")
    if args.attempt_timeout_s is not None and args.attempt_timeout_s <= 0:
        raise SystemExit("--attempt-timeout-s must be > 0")
    if args.hedge_after_s is not None and args.hedge_after_s <= 0:
        raise SystemExit("--hedge-after-s must be > 0")
    if args.breaker_failures is not None and args.breaker_failures < 1:
        raise SystemExit("--breaker-failures must be >= 1")
    if args.breaker_probation_s is not None and args.breaker_probation_s <= 0:
        raise SystemExit("--breaker-probation-s must be > 0")
    if args.warmup_from_ledger is not None and not args.ledger:
        raise SystemExit(
            "--warmup-from-ledger reads kernel signatures from the "
            "run ledger; it needs --ledger PATH"
        )


def _trace(args, program, machine) -> int:
    """The reference's -DDEBUG access and reuse logs (runtime/debug.py)."""
    from .core.trace import ProgramTrace
    from .runtime.debug import access_trace, format_reuse_pairs, reuse_pairs

    trace = ProgramTrace(program, machine)
    print(f"access trace, tid {args.tid}:")
    for row in access_trace(program, machine, args.tid, args.limit,
                            trace=trace):
        print("  pos %d  %s line %d  %s" % row)
    pairs = reuse_pairs(
        program, machine, args.tid, args.min_reuse, args.limit,
        trace=trace,
    )
    print(f"reuse pairs >= {args.min_reuse}, tid {args.tid}:")
    for line in format_reuse_pairs(pairs):
        print("  " + line)
    return 0


def _speed(args, program, machine, engine: str) -> int:
    """Makefile:34-37 / main.rs:31-33: repeated timed runs after a cache
    flush (pluss_timer_start flushes 2.5MB, pluss.cpp:86-94); the flush
    is timed apart from each run. With --ledger, one row for the runs
    (their median latency)."""
    from .runtime import telemetry
    from .runtime.timing import timed

    compiles0 = telemetry.compile_counters_snapshot()
    times, last, flushes = timed(
        lambda: _run_engine(engine, program, machine, args),
        reps=args.reps,
        flush_kb=machine.cache_kb,
    )
    if args.ledger:
        _cli_ledger_row(
            args, program, engine,
            getattr(last[0], "engine", None) or engine,
            sorted(times)[len(times) // 2],
            compiles0=compiles0, reps=args.reps,
        )
    for rep, dt in enumerate(times):
        print(f"{engine} {program.name} run {rep}: {dt:.6f} s")
    print(
        f"{engine} {program.name}: best {min(times):.6f} s, "
        f"mean {sum(times) / len(times):.6f} s over {len(times)} runs"
    )
    # flush cost is measured OUTSIDE the per-rep seconds (timed's
    # contract); surface it so slow-flush hosts are auditable
    telemetry.gauge(
        "cache_flush_s_per_rep",
        round(sum(flushes) / len(flushes), 6),
    )
    print(
        f"{engine} {program.name}: cache-flush overhead "
        f"{sum(flushes) / len(flushes):.6f} s/rep "
        "(excluded from the timings above)"
    )
    return 0


def _build_model(name: str, n: int, tsteps: int):
    from .models import build

    try:
        return build(name, n, tsteps)
    except (KeyError, ValueError) as e:
        raise SystemExit(str(e.args[0] if e.args else e))


def _dump_ir(args) -> int:
    """`--dump-ir MODEL` / `--dump-ir-dir DIR`: registry models as
    frontend JSON documents, which parse back to the registry's
    programs (templates for custom nests)."""
    import json
    import os

    from .frontend.schema import program_to_json
    from .models import REGISTRY

    if args.dump_ir:
        prog = _build_model(args.dump_ir, args.n, args.tsteps)
        print(json.dumps(program_to_json(prog), indent=2))
        return 0
    os.makedirs(args.dump_ir_dir, exist_ok=True)
    for name in sorted(REGISTRY):
        try:
            prog = _build_model(name, args.n, args.tsteps)
        except SystemExit:
            # models without a time axis reject --tsteps != 1; dump
            # them at their only valid tsteps instead of skipping
            prog = _build_model(name, args.n, 1)
        path = os.path.join(args.dump_ir_dir, f"{name}.json")
        with open(path, "w") as f:
            json.dump(program_to_json(prog), f, indent=2)
            f.write("\n")
        print(f"{name:<12} -> {path}")
    return 0


def _load_program_json(args, machine):
    """A frontend document for --program-json, strictly parsed:
    (program, the machine with the document's knobs). A rejection exits
    with the frontend's diagnostics."""
    import json

    from .frontend.parse import parse_program_doc
    from .frontend.schema import machine_from_doc

    try:
        with open(args.program_json) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise SystemExit(
            f"cannot read program JSON {args.program_json!r}: {e}"
        )
    res = parse_program_doc(doc)
    if not res.ok:
        lines = [f"{args.program_json}: frontend rejected program"]
        lines += [
            f"  [{d.severity}] {d.code} at {d.path or '/'}: "
            f"{d.message}"
            for d in res.errors()
        ]
        raise SystemExit("\n".join(lines))
    args.model = "custom"
    args._program_doc = doc
    return res.program, machine_from_doc(doc, machine)


def _list_models() -> int:
    """The 18-model registry with each family's exact-router audit
    status (sampler/analytic.py::AUDITED_FAMILIES)."""
    from .models import REGISTRY, build
    from .sampler.analytic import audited_family

    rows = []
    for name in sorted(REGISTRY):
        prog = build(name, 8)
        rows.append((
            name,
            len(prog.nests),
            sum(len(nest.refs) for nest in prog.nests),
            max(nest.depth for nest in prog.nests),
            any(nest.is_triangular for nest in prog.nests),
            audited_family(prog.name),
        ))
    print(f"{'model':<12} {'nests':>5} {'refs':>4} {'depth':>5} "
          f"{'triangular':>10} {'analytic-audit':>14}")
    for name, nests, refs, depth, tri, audited in rows:
        print(f"{name:<12} {nests:>5} {refs:>4} {depth:>5} "
              f"{'yes' if tri else 'no':>10} "
              f"{'audited' if audited else 'probe-backed':>14}")
    print(
        f"{len(rows)} models; 'audited' = exact-router analytic "
        "exactness proven by tests/test_analytic.py or recorded "
        "tools/verify_analytic.py audits (README \"Exactness "
        "coverage\")"
    )
    return 0


def _analyze(args, program, machine) -> int:
    """`analyze` mode: the static preflight passes (analysis/) —
    well-formedness diagnostics, the dependence and race verdict, and
    the locality bounds — with no engine run. `--analysis-json` prints
    the whole report instead of the summary. Exit 0 when the IR can be
    simulated (verdict ok or race: a race is a property of the modeled
    OpenMP program, not an input error), 1 when invalid."""
    import json

    from . import analysis

    report = analysis.analyze_program(program, machine)
    if args.analysis_json:
        print(json.dumps(report.to_dict(), indent=2, sort_keys=True))
        return 0 if report.ok else 1
    print(f"{program.name}: verdict {report.verdict} "
          f"({report.wall_s * 1e3:.1f} ms)")
    for d in report.diagnostics:
        print(f"  [{d.severity}] {d.code} at {d.path}: {d.message}")
    if report.bounds is not None:
        b = report.bounds
        print(f"  accesses {b.total_accesses}, compulsory-miss lower "
              f"bound {b.compulsory_lower} lines, "
              + (f"cold footprint {b.cold_model} lines (exact), "
                 f"MRC asymptote {b.asymptote:.6g}"
                 if b.exact else
                 "footprint bounded by interval analysis "
                 "(domain too large for exact enumeration)"))
        carried = sum(
            1 for dep in report.dependences
            if dep.kind == analysis.DEP_CARRIED
        )
        print(f"  dependences: {len(report.dependences)} classified "
              f"pairs, {carried} carried, {len(report.races)} "
              "race-flagged")
    return 0 if report.ok else 1


def _cli_ledger_row(args, program, engine, engine_used, latency_s,
                    mrc=None, compiles0=None, reps=None) -> None:
    """One execution -> run-ledger row, the JAX CLI's row field for
    field. An engine the JAX package's service runs (SERVICE_ENGINES)
    gets that service's content address, so CLI rows of both packages
    join on one fingerprint. `compile_delta` holds the kernel builds
    since `compiles0` (runtime/telemetry.py::compile_counters_snapshot),
    only the nonzero ones."""
    from .runtime import telemetry
    from .runtime.obs import ledger as obs_ledger
    from .service.executor import SERVICE_ENGINES

    fp = None
    if engine in SERVICE_ENGINES:
        try:
            fp = _request_from_args(args, engine).fingerprint(program)
        except Exception:
            pass
    row = {
        "kind": "request",
        "source": "cli",
        "ok": True,
        "fingerprint": fp,
        "engine_requested": engine,
        "engine_used": engine_used,
        "model": args.model,
        "n": args.n,
        "latency_s": round(latency_s, 6),
        "cache": None,
        "degraded": [],
        "mrc_digest": (
            obs_ledger.mrc_digest(mrc) if mrc is not None else None
        ),
    }
    if compiles0 is not None:
        now = telemetry.compile_counters_snapshot()
        row["compile_delta"] = {
            k: round(v - compiles0.get(k, 0), 4)
            if isinstance(v, float) else v - compiles0.get(k, 0)
            for k, v in now.items() if v - compiles0.get(k, 0)
        }
    if reps is not None:
        row["reps"] = reps
    obs_ledger.append(args.ledger, row)


def _service_device(args):
    """The analysis service's device from --device: the default "cuda"
    under --replicas is every visible card (None), any other one device
    (a replica pool serves --replicas replicas on it). A serve-worker's
    --worker-devices D is a list of D devices: the first D cards under
    "cuda", else the named device D times."""
    if args.mode == "serve-worker" and args.worker_devices:
        if args.device == "cuda":
            return [f"cuda:{i}" for i in range(args.worker_devices)]
        return [args.device] * args.worker_devices
    if args.device == "cuda" and args.replicas is not None:
        return None
    return args.device


def _request_from_args(args, engine):
    from .service import AnalysisRequest

    return AnalysisRequest(
        model=args.model, n=args.n, tsteps=args.tsteps, engine=engine,
        runtime=args.runtime, threads=args.threads, chunk=args.chunk,
        ratio=args.ratio, seed=args.seed, device_draw=args.device_draw,
        fuse_refs=args.fuse_refs, pipeline_depth=args.pipeline_depth,
        kernel_backend=args.kernel_backend,
        program=getattr(args, "_program_doc", None),
        deadline_s=args.deadline_s,
        tolerance=args.tolerance, max_rounds=args.max_rounds,
        round_schedule=(
            _parse_round_schedule(args.round_schedule)
            if args.round_schedule is not None else None
        ),
    )


def _resilience_from_args(args):
    """ResilienceConfig from the CLI flags, or None when every flag is
    at its default (the executor then runs the stock config — retries
    off, no admission gate, breakers at their defaults)."""
    if all(
        v is None for v in (
            args.attempt_timeout_s, args.max_retries,
            args.hedge_after_s, args.queue_limit,
            args.breaker_failures, args.breaker_probation_s,
        )
    ):
        return None
    from .config import ResilienceConfig

    kw = {}
    if args.attempt_timeout_s is not None:
        kw["attempt_timeout_s"] = args.attempt_timeout_s
    if args.max_retries is not None:
        kw["max_retries"] = args.max_retries
    if args.hedge_after_s is not None:
        kw["hedge_after_s"] = args.hedge_after_s
    if args.queue_limit is not None:
        kw["queue_limit"] = args.queue_limit
        kw["shed_enabled"] = not args.no_shed
    if args.breaker_failures is not None:
        kw["breaker_failures"] = args.breaker_failures
    if args.breaker_probation_s is not None:
        kw["breaker_probation_s"] = args.breaker_probation_s
    return ResilienceConfig(**kw)


def _fabric_from_args(args):
    """FabricConfig from the CLI timing flags (defaults where unset)."""
    from .config import FabricConfig

    kw = {}
    for attr in ("hb_interval_s", "hb_timeout_s",
                 "reconnect_attempts", "reconnect_delay_s",
                 "stats_interval_s"):
        v = getattr(args, attr)
        if v is not None:
            kw[attr] = v
    if args.no_fabric_trace:
        kw["trace_enabled"] = False
    return FabricConfig(**kw)


# The kernel libraries a worker loads before it reports ready: B1's
# parameter form, its buffer and per-row forms, B3, and B2 (the sharded
# engine's).
_WORKER_LIBRARIES = ("sampled_hist", "sampled_hist_buf", "threefry_draw",
                     "pow2_hist")


def _worker_warm(device) -> float | None:
    """Make a serve-worker able to serve before its ready line: on CUDA,
    each device's context and the kernel libraries, so neither the first
    request pays for them nor a library load holds the GIL while the
    router's heartbeats wait. A library not yet built is built here,
    under ops/_build.py's lock across processes. Returns the seconds it
    took; None (nothing done) on the CPU."""
    import time

    import torch

    t0 = time.perf_counter()
    devices = device if isinstance(device, (list, tuple)) else [device]
    cuda = [torch.device("cuda" if d is None else d) for d in devices]
    cuda = [d for d in cuda if d.type == "cuda"]
    if not cuda:
        return None
    from .ops import _build

    for d in dict.fromkeys(cuda):
        torch.empty(1, device=d)
    for name in _WORKER_LIBRARIES:
        _build.load(name)
    return time.perf_counter() - t0


def _run_worker_front(args, svc) -> int:
    """The serve-worker serving front: a fabric WorkerServer over the
    already-wired AnalysisService. Blocks until the router drains this
    worker (`shutdown` frame -> bye) or SIGTERM/SIGINT lands; either
    way the service enters graceful drain so _serve's shutdown
    reporting (and final flight-recorder bundle) fires."""
    from .service import GracefulShutdown
    from .service.fabric import WorkerServer, parse_hostport

    warm_s = _worker_warm(_service_device(args))
    if warm_s is not None:
        print(f"serve-worker: worker {args.worker_id}: CUDA context and "
              f"kernel libraries loaded in {warm_s:.3f}s", file=sys.stderr)
    host, port = ("127.0.0.1", 0)
    if args.listen:
        host, port = parse_hostport(args.listen)
    ws = WorkerServer(
        svc, worker_id=args.worker_id, host=host, port=port,
        fabric=_fabric_from_args(args),
    )
    host, port = ws.start()
    # the supervisor (serve-router --workers N) parses this exact
    # stdout line to learn the ephemeral port — keep it first + flushed
    print(f"fabric-worker ready {args.worker_id} {host}:{port}",
          flush=True)
    print(
        f"serve-worker: worker {args.worker_id} speaking the fabric "
        f"wire protocol on {host}:{port}",
        file=sys.stderr,
    )
    try:
        while not ws.join_drained(timeout=0.5):
            pass
        svc.begin_shutdown()
    except GracefulShutdown:
        svc.begin_shutdown()
        ws.drain_local()
    finally:
        ws.close()
    return 0


def _spawn_workers(args, children) -> list:
    """serve-router --workers N: launch N serve-worker subprocesses
    on ephemeral ports (worker ids 0..N-1), forwarding the service
    flags and --device (in the place of the JAX CLI's --platform and
    --compilation-cache-dir) — ONE shared --cache-dir disk tier and
    ONE shared O_APPEND --ledger across the fleet — and return their
    wire addresses. Children are appended to `children` as they spawn
    so the caller's cleanup reaps every process even when a later one
    fails to come up (the zero-orphans guarantee the check_fabric tool
    pins)."""
    import subprocess
    import threading
    import time

    from .service.fabric import parse_hostport

    forwarded = []
    for flag, value in (
        ("--cache-dir", args.cache_dir),
        ("--ledger", args.ledger),
        ("--max-workers", args.max_workers),
        ("--batch-window-ms", args.batch_window_ms),
        ("--batch-max-refs", args.batch_max_refs),
        ("--replicas", args.replicas),
        ("--worker-devices", args.worker_devices),
        ("--device", args.device),
        ("--warmup-from-ledger", args.warmup_from_ledger),
        ("--fault-spec", args.fault_spec),
        ("--attempt-timeout-s", args.attempt_timeout_s),
        ("--max-retries", args.max_retries),
        ("--hedge-after-s", args.hedge_after_s),
        ("--queue-limit", args.queue_limit),
        ("--breaker-failures", args.breaker_failures),
        ("--breaker-probation-s", args.breaker_probation_s),
        ("--hb-interval-s", args.hb_interval_s),
        ("--hb-timeout-s", args.hb_timeout_s),
        ("--reconnect-attempts", args.reconnect_attempts),
        ("--reconnect-delay-s", args.reconnect_delay_s),
    ):
        if value is not None and flag != "--batch-max-refs":
            forwarded += [flag, str(value)]
        elif flag == "--batch-max-refs" and args.batch_window_ms:
            forwarded += [flag, str(value)]
    if args.no_shed:
        forwarded.append("--no-shed")
    addrs = []
    spawned = []
    for i in range(args.workers):
        spawned.append(time.perf_counter())
        cmd = [
            sys.executable, "-m", "pluss_sampler_optimization_torch.cli",
            "serve-worker", "--listen", "127.0.0.1:0",
            "--worker-id", str(i),
        ] + forwarded
        if args.debug_bundle_dir is not None:
            import os

            cmd += ["--debug-bundle-dir",
                    os.path.join(args.debug_bundle_dir, f"worker{i}")]
        children.append(subprocess.Popen(
            cmd, stdout=subprocess.PIPE, text=True, bufsize=1,
        ))
    # each child's ready line is read as it comes, one thread a child,
    # so a worker's seconds from spawn to ready are its own
    ready: list = [("", 0.0)] * len(children)

    def _read_ready(i, proc):
        ready[i] = (proc.stdout.readline().strip(), time.perf_counter())

    readers = [threading.Thread(target=_read_ready, args=(i, proc),
                                daemon=True)
               for i, proc in enumerate(children)]
    for th in readers:
        th.start()
    for i, proc in enumerate(children):
        readers[i].join()
        line, t_ready = ready[i]
        parts = line.split()
        if (len(parts) != 4 or parts[:2] != ["fabric-worker", "ready"]
                or parts[2] != str(i)):
            raise SystemExit(
                f"serve-router: worker {i} failed to start "
                f"(got {line!r} instead of its ready line)"
            )
        addrs.append(parse_hostport(parts[3]))
        print(f"serve-router: worker {i} up at {parts[3]} "
              f"(pid {proc.pid})", file=sys.stderr)
        print(f"serve-router: worker {i} ready "
              f"{t_ready - spawned[i]:.3f}s after spawn", file=sys.stderr)
    return addrs


def _serve_router(args) -> int:
    """`serve-router` mode: the fabric's dispatch plane — consistent-
    hash request fingerprints over N engine workers (supervised
    subprocesses via --workers, or externally-launched via --worker),
    serving the JSONL protocol from --requests/stdin and, with
    --listen, from TCP clients. SIGTERM/SIGINT drain the WHOLE
    fabric: the router stops accepting, in-flight entries resolve,
    every worker gets a `shutdown` frame and drains (each dumping its
    own final flight-recorder bundle when armed), and supervised
    children are reaped — zero orphans."""
    import signal

    from .runtime import faults
    from .runtime.obs import metrics as obs_metrics
    from .runtime.obs import profiler as obs_profiler
    from .runtime.obs import recorder as obs_recorder
    from .runtime.obs import slo as obs_slo
    from .service import GracefulShutdown
    from .service.fabric import Router, parse_hostport

    fabric = _fabric_from_args(args)
    fin = sys.stdin if args.requests == "-" else open(args.requests)
    fout = (
        sys.stdout if args.responses == "-"
        else open(args.responses, "w")
    )
    registry = obs_metrics.enable()
    injector = None
    recorder = None
    router = None
    server = None
    children: list = []
    prev_sigs = {}
    failures = 0
    graceful = False
    if args.fault_spec:
        # the router arms its own injector for the worker_conn site;
        # supervised workers get --fault-spec forwarded and draw from
        # their own (identically-seeded) streams
        injector = faults.install_from_file(args.fault_spec)
        print(
            f"serve-router: fault injection armed from "
            f"{args.fault_spec} (seed {injector.config.seed}, "
            f"{len(injector.config.rules)} rule(s))",
            file=sys.stderr,
        )
    if args.debug_bundle_dir is not None:
        recorder = obs_recorder.enable(
            args.debug_bundle_dir,
            ledger_path=args.ledger,
            config={
                k: getattr(args, k)
                for k in (
                    "cache_dir", "ledger", "workers", "worker",
                    "listen", "hb_interval_s", "hb_timeout_s",
                    "reconnect_attempts", "reconnect_delay_s",
                    "stats_interval_s", "no_fabric_trace",
                    "fault_spec", "debug_bundle_dir",
                )
            },
        )
        print(
            "serve-router: flight recorder on, post-mortem bundles "
            f"under {args.debug_bundle_dir}",
            file=sys.stderr,
        )
    try:
        def _graceful_sig(signum, frame):
            raise GracefulShutdown(f"signal {signum}")

        for _name in ("SIGTERM", "SIGINT"):
            _num = getattr(signal, _name, None)
            if _num is None:
                continue
            try:
                prev_sigs[_num] = signal.signal(_num, _graceful_sig)
            except ValueError:
                pass
        if args.workers is not None:
            addrs = _spawn_workers(args, children)
        else:
            addrs = [parse_hostport(spec) for spec in args.worker]
        # the router shares the workers' O_APPEND ledger: its rows
        # (source fabric.router, per-request span splits) join the
        # worker rows on trace_id — tools/assemble_trace.py
        router = Router(addrs, fabric=fabric,
                        ledger_path=args.ledger)
        if (args.slo_latency_p95_s is not None
                or args.slo_error_budget is not None):
            from .config import SLOConfig
            from .runtime.obs import fleet as obs_fleet

            kw = {"burn_rate_threshold": args.slo_burn_threshold}
            if args.slo_latency_p95_s is not None:
                kw["latency_p95_s"] = args.slo_latency_p95_s
            if args.slo_error_budget is not None:
                kw["error_budget"] = args.slo_error_budget
            slo_config = SLOConfig(**kw)
            # workers pre-digest their windows against this threshold
            # (fabric/worker.py _slo_inputs); the sentinel then reads
            # the fleet as one registry through FleetView. No ledger
            # leg here — the shared ledger holds router rows too, and
            # the workers' own sentinels already watch their tails
            router.slo_params = {
                "threshold": args.slo_latency_p95_s,
                "windows": list(slo_config.windows),
            }
            sentinel = obs_slo.SLOSentinel(
                slo_config, registry=obs_fleet.FleetView(router),
                interval_s=args.slo_interval_s,
            )
            router.slo_sentinel = sentinel
        router.start()
        if router.slo_sentinel is not None:
            router.slo_sentinel.start()
            print(
                "serve-router: fleet SLO sentinel on (burn rates "
                "over the merged worker windows, every "
                f"{args.slo_interval_s:g}s)",
                file=sys.stderr,
            )
        if recorder is not None:
            recorder.state_provider = lambda: {
                "healthz": router.healthz(),
                "stats": router.stats(),
            }
        if args.metrics_port is not None:
            server = obs_metrics.MetricsServer(
                registry, port=args.metrics_port,
                healthz=router.healthz,
                # cached snapshots (refreshed every stats_interval_s
                # by the poll loop) — a scrape never blocks on N
                # worker round-trips
                stats=(lambda: router.fleet_stats(refresh=False)),
                prometheus=router.fleet_prometheus_text,
                bundles=(
                    (lambda: {
                        "bundle_dir": recorder.bundle_dir,
                        "recorder": recorder.stats(),
                        "bundles": recorder.bundle_index(),
                    }) if recorder is not None else None
                ),
                profile=obs_profiler.snapshot,
            )
            print(
                f"serve-router: live metrics on "
                f"http://{server.host}:{server.port}/metrics",
                file=sys.stderr,
            )
        if args.listen is not None:
            th, tp = parse_hostport(args.listen)
            bh, bp = router.serve_tcp(th, tp)
            print(f"serve-router: JSONL TCP front on {bh}:{bp}",
                  file=sys.stderr)
        if args.requests != "-" or args.listen is None:
            failures = router.serve_stream(fin, fout)
        if args.listen is not None:
            # TCP daemon: serve until a shutdown signal lands
            import threading as _threading

            _forever = _threading.Event()
            while not _forever.wait(0.5):
                pass
    except GracefulShutdown:
        graceful = True
        print(
            "serve-router: graceful shutdown — stopped accepting, "
            "draining the fabric",
            file=sys.stderr,
        )
    finally:
        if router is not None and router.slo_sentinel is not None:
            try:
                # final fleet evaluation so short batches (finished
                # inside one interval) still report, matching _serve
                router.slo_sentinel.evaluate_once()
                for line in obs_slo.format_report(
                    router.slo_sentinel.last_report
                ):
                    print(f"serve-router: {line}", file=sys.stderr)
            except Exception:
                pass
            router.slo_sentinel.close()
        if router is not None:
            router.close(graceful=True)
        for proc in children:
            try:
                proc.wait(timeout=fabric.drain_timeout_s)
            except Exception:
                proc.kill()
                proc.wait()
            if proc.stdout is not None:
                proc.stdout.close()
        if graceful and recorder is not None:
            recorder.dump(
                "shutdown", trigger={"reason": "graceful_shutdown"}
            )
        if injector is not None:
            if injector.total_fired():
                print(
                    f"serve-router: faults fired "
                    f"{injector.total_fired()} time(s): "
                    f"{injector.stats()}",
                    file=sys.stderr,
                )
            faults.uninstall()
        if prev_sigs:
            for _num, _prev in prev_sigs.items():
                try:
                    signal.signal(_num, _prev)
                except ValueError:
                    pass
        if server is not None:
            server.close()
        if recorder is not None:
            obs_recorder.disable()
        obs_metrics.disable()
        if fin is not sys.stdin:
            fin.close()
        if fout is not sys.stdout:
            fout.close()
    if graceful and children:
        print(
            f"serve-router: graceful shutdown complete — "
            f"{len(children)} worker(s) drained and reaped",
            file=sys.stderr,
        )
    if failures:
        print(
            f"serve-router: {failures} request(s) failed (per-line "
            "status is in the responses)",
            file=sys.stderr,
        )
    return 0


def _serve(args) -> int:
    """`serve` mode: process a JSONL request batch end to end, on
    `--device` (_service_device), under
    the live metrics registry (always on here — the `metrics` request
    type and the optional --metrics-port scrape read it), the
    optional SLO sentinel, the optional flight recorder
    (--debug-bundle-dir), the optional background ledger GC, and —
    when armed — deterministic fault injection (--fault-spec).
    SIGTERM/SIGINT trigger a graceful drain: in-flight work finishes,
    queued work is shed with structured responses, and the ledger
    (plus a final flight-recorder bundle) is flushed before exit. The
    JAX CLI's serve, line for line.

    `serve-worker` mode runs HERE too — the identical stack and
    wiring, with the serving front swapped: instead of a JSONL batch
    from --requests, the service answers framed request lines from a
    fabric router (service/fabric/worker.py) until the router drains
    it or a signal lands. Same per-line semantics, same responses,
    same observability — which is what makes fabric results
    bit-identical to single-process serve."""
    from .runtime import faults
    from .runtime.obs import ledger as obs_ledger
    from .runtime.obs import metrics as obs_metrics
    from .runtime.obs import profiler as obs_profiler
    from .runtime.obs import recorder as obs_recorder
    from .service import AnalysisService, GracefulShutdown, serve_jsonl

    worker_mode = args.mode == "serve-worker"
    fin = sys.stdin if args.requests == "-" else open(args.requests)
    fout = (
        sys.stdout if args.responses == "-"
        else open(args.responses, "w")
    )
    registry = obs_metrics.enable()
    profiler = None
    if args.profile_hz is not None:
        profiler = obs_profiler.enable(hz=args.profile_hz)
        print(
            f"serve: sampling profiler on at {args.profile_hz:g} Hz "
            "(snapshot at GET /debug/profile)",
            file=sys.stderr,
        )
    server = None
    sentinel = None
    recorder = None
    gc = None
    prev_usr2 = None
    prev_sigs = {}
    injector = None
    failures = 0
    if args.fault_spec:
        injector = faults.install_from_file(args.fault_spec)
        print(
            f"serve: fault injection armed from {args.fault_spec} "
            f"(seed {injector.config.seed}, "
            f"{len(injector.config.rules)} rule(s))",
            file=sys.stderr,
        )
    if args.debug_bundle_dir is not None:
        recorder = obs_recorder.enable(
            args.debug_bundle_dir,
            ledger_path=args.ledger,
            # the resolved serving config rides every bundle, so a
            # post-mortem reader knows exactly what was running
            config={
                k: getattr(args, k)
                for k in (
                    "cache_dir", "ledger", "max_workers", "replicas",
                    "batch_window_ms", "batch_max_refs",
                    "slo_latency_p95_s", "slo_error_budget",
                    "slo_burn_threshold", "slo_interval_s",
                    "debug_bundle_dir", "regress_bench",
                    "ledger_gc_interval_s", "ledger_max_rows",
                    "fault_spec", "attempt_timeout_s", "max_retries",
                    "hedge_after_s", "queue_limit", "no_shed",
                    "breaker_failures", "breaker_probation_s",
                    "profile_hz", "profile_out",
                )
            },
        )
        print(
            "serve: flight recorder on, post-mortem bundles under "
            f"{args.debug_bundle_dir}",
            file=sys.stderr,
        )
        # SIGUSR2 = dump a bundle NOW, the kill(1)-reachable twin of
        # the dump_debug request type. Registration only works on the
        # main thread — embedders calling main() elsewhere just lose
        # the signal hook, never the recorder.
        import signal

        if hasattr(signal, "SIGUSR2"):
            try:
                prev_usr2 = signal.signal(
                    signal.SIGUSR2,
                    lambda signum, frame: recorder.dump(
                        "signal", trigger={"signal": "SIGUSR2"}
                    ),
                )
            except ValueError:
                prev_usr2 = None
    try:
        # SIGTERM/SIGINT = drain, don't drop: the handler raises
        # GracefulShutdown (a BaseException, so serve_jsonl's per-line
        # `except Exception` guards can't swallow it) on the main
        # thread; serve_jsonl catches it, stops admission, finishes
        # in-flight work, and sheds the rest with structured
        # responses. Same main-thread-only caveat as SIGUSR2 above.
        import signal

        def _graceful(signum, frame):
            raise GracefulShutdown(f"signal {signum}")

        for _name in ("SIGTERM", "SIGINT"):
            _num = getattr(signal, _name, None)
            if _num is None:
                continue
            try:
                prev_sigs[_num] = signal.signal(_num, _graceful)
            except ValueError:
                pass
        with AnalysisService(
            cache_dir=args.cache_dir, max_workers=args.max_workers,
            ledger_path=args.ledger,
            batch_window_ms=args.batch_window_ms,
            batch_max_refs=args.batch_max_refs,
            replicas=args.replicas,
            resilience=_resilience_from_args(args),
            device=_service_device(args),
            worker_id=(args.worker_id if worker_mode else None),
        ) as svc:
            if recorder is not None:
                # live serving state for bundles: replica/mesh view +
                # executor counters at dump time
                recorder.state_provider = lambda: {
                    "healthz": svc.healthz(),
                    "executor": svc.executor.stats(),
                }
            if args.metrics_port is not None:
                server = obs_metrics.MetricsServer(
                    registry, port=args.metrics_port,
                    healthz=svc.healthz, stats=svc.stats,
                    bundles=(
                        (lambda: {
                            "bundle_dir": recorder.bundle_dir,
                            "recorder": recorder.stats(),
                            "bundles": recorder.bundle_index(),
                        }) if recorder is not None else None
                    ),
                    # always wired: the route answers a structured
                    # 404 JSON body when the profiler is off, so
                    # pollers never see a bare HTML error page
                    profile=obs_profiler.snapshot,
                )
                print(
                    f"serve: live metrics on "
                    f"http://{server.host}:{server.port}/metrics",
                    file=sys.stderr,
                )
            if args.warmup_from_ledger:
                warmed = svc.warm_from_ledger(args.warmup_from_ledger)
                print(
                    f"serve: warmed {warmed} kernel signature(s) "
                    "from the ledger",
                    file=sys.stderr,
                )
            if args.ledger_gc_interval_s is not None:
                gc = obs_ledger.LedgerGC(
                    args.ledger,
                    interval_s=args.ledger_gc_interval_s,
                    max_rows=args.ledger_max_rows,
                ).start()
            if (args.slo_latency_p95_s is not None
                    or args.slo_error_budget is not None):
                from .config import SLOConfig
                from .runtime.obs import slo as obs_slo

                kw = {"burn_rate_threshold": args.slo_burn_threshold}
                if args.slo_latency_p95_s is not None:
                    kw["latency_p95_s"] = args.slo_latency_p95_s
                if args.slo_error_budget is not None:
                    kw["error_budget"] = args.slo_error_budget
                import glob as glob_mod

                bench_paths = (
                    sorted(glob_mod.glob(args.regress_bench))
                    if args.regress_bench else None
                )
                sentinel = obs_slo.SLOSentinel(
                    SLOConfig(**kw), registry=registry,
                    ledger_path=args.ledger,
                    interval_s=args.slo_interval_s,
                    regress_bench=bench_paths,
                ).start()
                svc.slo_sentinel = sentinel
            if worker_mode:
                failures = _run_worker_front(args, svc)
            else:
                failures = serve_jsonl(svc, fin, fout)
            if svc.executor.draining:
                st = svc.executor.stats()
                print(
                    "serve: graceful shutdown — in-flight work "
                    f"drained, {st.get('shed', 0)} request(s) shed",
                    file=sys.stderr,
                )
                if recorder is not None:
                    recorder.dump(
                        "shutdown",
                        trigger={"reason": "graceful_shutdown"},
                    )
            if injector is not None and injector.total_fired():
                print(
                    f"serve: faults fired {injector.total_fired()} "
                    f"time(s): {injector.stats()}",
                    file=sys.stderr,
                )
            if sentinel is not None:
                # short batches finish inside one interval; the final
                # evaluation guarantees every serve run gets (at
                # least) one report and any breach events
                report = sentinel.evaluate_once()
                if not report["ok"]:
                    from .runtime.obs import slo as obs_slo

                    for line in obs_slo.format_report(report):
                        print(f"serve: {line}", file=sys.stderr)
            if gc is not None:
                # final compaction so the bound holds for whoever
                # reads the ledger after this process exits
                try:
                    gc.run_once()
                except Exception:
                    pass
    except GracefulShutdown:
        # signal landed outside serve_jsonl (startup/teardown window)
        # — still a clean exit, nothing was being served
        print("serve: shutdown signal received outside the serving "
              "loop; exiting", file=sys.stderr)
    finally:
        if injector is not None:
            faults.uninstall()
        if prev_sigs:
            import signal

            for _num, _prev in prev_sigs.items():
                try:
                    signal.signal(_num, _prev)
                except ValueError:
                    pass
        if gc is not None:
            gc.close()
        if sentinel is not None:
            sentinel.close()
        if server is not None:
            server.close()
        if recorder is not None:
            obs_recorder.disable()
            if prev_usr2 is not None:
                import signal

                try:
                    signal.signal(signal.SIGUSR2, prev_usr2)
                except ValueError:
                    pass
        if profiler is not None:
            obs_profiler.disable()
            if args.profile_out:
                try:
                    profiler.write_speedscope(args.profile_out)
                    profiler.write_collapsed(
                        args.profile_out + ".collapsed"
                    )
                    snap = profiler.snapshot()
                    print(
                        "serve: profile written to "
                        f"{args.profile_out} ({snap['samples']} "
                        "samples, attribution completeness "
                        f"{snap['attribution_completeness']})",
                        file=sys.stderr,
                    )
                except Exception as e:
                    print(f"serve: profile export failed: {e!r}",
                          file=sys.stderr)
        obs_metrics.disable()
        if fin is not sys.stdin:
            fin.close()
        if fout is not sys.stdout:
            fout.close()
    if failures:
        print(f"serve: {failures} request(s) failed (per-line "
              "status is in the responses)", file=sys.stderr)
    return 0


def _execute_via_service(args, machine, program, engine) -> int:
    """acc/speed/sample through the analysis service (--cache-dir):
    identical dumps to the direct path, served from the
    content-addressed store when warm."""
    import time

    from .runtime import report
    from .service import AnalysisService

    request = _request_from_args(args, engine)
    with AnalysisService(
        cache_dir=args.cache_dir, ledger_path=args.ledger,
        batch_window_ms=args.batch_window_ms,
        batch_max_refs=args.batch_max_refs,
        replicas=args.replicas,
        resilience=_resilience_from_args(args),
        device=_service_device(args),
    ) as svc:
        if args.mode == "speed":
            times = []
            for rep in range(args.reps):
                t0 = time.perf_counter()
                resp = svc.analyze(request)
                dt = time.perf_counter() - t0
                if not resp.ok:
                    raise SystemExit(
                        f"service request failed: {resp.error}"
                    )
                times.append(dt)
                print(f"{engine} {program.name} run {rep}: "
                      f"{dt:.6f} s (cache {resp.cache})")
            print(
                f"{engine} {program.name}: best {min(times):.6f} s, "
                f"mean {sum(times) / len(times):.6f} s over "
                f"{len(times)} runs"
            )
            return 0
        resp = svc.analyze(request)
        if not resp.ok:
            raise SystemExit(f"service request failed: {resp.error}")
        if resp.degraded:
            print(f"service degraded: {resp.degraded}",
                  file=sys.stderr)
        lines = []
        if args.mode == "sample" and resp.per_ref_lines:
            lines += resp.per_ref_lines
        lines += resp.dump_lines
        report.emit(lines)
        if args.mrc_out:
            report.write_mrc_to_file(resp.mrc, args.mrc_out)
    return 0


def _observed(args, fn) -> int:
    """Run fn() under the observability flags (--telemetry-out /
    --trace-out / --metrics-out / --profile-dir). The exporters read the
    same stopped run, so the Chrome trace's span tree is exactly
    `Telemetry.to_json`'s."""
    tele = None
    if args.telemetry_out or args.trace_out or args.metrics_out:
        from .runtime import telemetry

        tele = telemetry.enable()
    try:
        if args.profile_dir:
            return _profiled(args.profile_dir, fn)
        return fn()
    finally:
        if tele is not None:
            from .runtime import telemetry
            from .runtime.obs import exporters

            telemetry.disable()
            if args.telemetry_out:
                tele.print_summary()
                tele.write_json(args.telemetry_out)
            if args.trace_out or args.metrics_out:
                doc = tele.to_json()
                if args.trace_out:
                    exporters.write_chrome_trace(args.trace_out, doc)
                if args.metrics_out:
                    exporters.write_prometheus(args.metrics_out, doc)


def _profiled(profile_dir: str, fn) -> int:
    """fn() under torch.profiler with the CPU activity and, where torch
    sees a card, the CUDA one; the Chrome trace goes to
    PROFILE_DIR/pluss_torch_<UTC time>_<pid>.pt.trace.json."""
    import os
    import time

    from torch.profiler import ProfilerActivity, profile

    import torch

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        rc = fn()
    path = os.path.join(profile_dir, "pluss_torch_%s_%d.pt.trace.json" % (
        time.strftime("%Y%m%dT%H%M%SZ", time.gmtime()), os.getpid()))
    prof.export_chrome_trace(path)
    return rc


def _stats(args) -> int:
    """`stats` mode: aggregate a run ledger into the per-engine serving
    picture (p50/p95 latency, cache hit rates, degradation counts,
    drift status) — the JAX CLI's lines."""
    from .runtime.obs import ledger as obs_ledger

    if not args.ledger:
        raise SystemExit("stats mode needs --ledger PATH")
    try:
        entries = list(obs_ledger.iter_rows(args.ledger))
    except OSError as e:
        raise SystemExit(f"cannot read ledger: {e}")
    rows = [row for _ln, row, _err in entries if row is not None]
    bad = [(ln, err) for ln, row, err in entries if row is None]
    for line in obs_ledger.format_stats(obs_ledger.aggregate(rows)):
        print(line)
    if bad:
        print(
            f"warning: {len(bad)} invalid line(s) skipped (run "
            "tools/check_ledger.py for details)",
            file=sys.stderr,
        )
    return 0


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.list_models:
        return _list_models()
    if args.dump_ir or args.dump_ir_dir:
        return _dump_ir(args)
    if args.mode is None:
        ap.error("mode is required (acc|speed|sample|trace|serve|"
                 "analyze|stats)")
    if args.program_json and args.mode in ("trace", "stats",
                                           *_SERVE_FAMILY):
        raise SystemExit(
            "--program-json loads an inline frontend document for "
            "acc|speed|sample|analyze; serve modes take a 'program' "
            "field per request line instead"
        )
    if args.mode == "stats":
        return _stats(args)
    machine = MachineConfig(thread_num=args.threads, chunk_size=args.chunk)
    if args.program_json:
        program, machine = _load_program_json(args, machine)
    else:
        program = _build_model(args.model, args.n, args.tsteps)
    if args.mode == "analyze":
        return _analyze(args, program, machine)
    _check_serve_args(args)
    if args.mode in ("serve", "serve-worker"):
        return _observed(args, lambda: _serve(args))
    if args.mode == "serve-router":
        return _observed(args, lambda: _serve_router(args))
    engine = args.engine or ("sampled" if args.mode == "sample" else "dense")
    _check_args(args, engine)
    return _observed(args, lambda: _execute(args, machine, program, engine))


def _execute(args, machine, program, engine: str) -> int:
    """Run the selected mode (spans and counters land in the active
    telemetry run, if any: main's _observed owns enable and export)."""
    import time

    from .runtime import report

    if args.mode == "trace":
        return _trace(args, program, machine)
    if args.cache_dir and args.mode in ("acc", "speed", "sample"):
        return _execute_via_service(args, machine, program, engine)
    if args.mode == "speed":
        return _speed(args, program, machine, engine)

    def lines_of(eng: str) -> tuple[list[str], object]:
        from .runtime import telemetry

        t0 = time.perf_counter()
        compiles0 = telemetry.compile_counters_snapshot()
        res, per_ref = _run_engine(eng, program, machine, args)
        lines, mrc = result_lines(res.state, per_ref, machine, args.r10,
                                  total=res.total_accesses,
                                  ref_lines=args.mode == "sample")
        if args.ledger:
            # one row per engine execution: the --diff-against second
            # engine gets its own row too
            _cli_ledger_row(
                args, program, eng,
                getattr(res, "engine", None) or eng,
                time.perf_counter() - t0, mrc=mrc, compiles0=compiles0,
            )
        return lines, mrc

    lines, mrc = lines_of(engine)
    report.emit(lines)
    if args.mrc_out:
        report.write_mrc_to_file(mrc, args.mrc_out)
    if args.diff_against:
        # the reference's acc protocol appends each implementation's
        # dumps to output.txt for manual inspection (run.sh:3-12,
        # README.md:10-12); this automates the comparison
        other_lines, _ = lines_of(args.diff_against)
        if lines != other_lines:
            import difflib

            sys.stdout.writelines(
                difflib.unified_diff(
                    [l + "\n" for l in other_lines],
                    [l + "\n" for l in lines],
                    fromfile=args.diff_against,
                    tofile=engine,
                )
            )
            print(f"acc dumps DIFFER: {engine} vs {args.diff_against}")
            return 1
        print(f"acc dumps identical: {engine} vs {args.diff_against}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
