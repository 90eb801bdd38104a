"""Command line of the port: the `acc`, `speed`, `sample`, `trace`, `analyze` and `stats` modes.

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
  CLI's lines; no engine runs.

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

ENGINES = ("oracle", "numpy", "native", "native-par", "dense", "stream",
           "periodic", "analytic", "exact", "sampled", "sharded")
_SHARDED_EXACT = ("periodic", "analytic", "exact")


def _parser() -> argparse.ArgumentParser:
    from .models import REGISTRY

    ap = argparse.ArgumentParser(prog="pluss_sampler_optimization_torch")
    ap.add_argument("mode", nargs="?",
                    choices=["acc", "speed", "sample", "trace", "analyze",
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
                    help="cuda (default) or cpu")
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
            args, program, machine, engine,
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


def _request_fingerprint(args, program, machine, engine: str):
    """The JAX package's service fingerprint of these flags
    (service/api.py::AnalysisRequest(...).fingerprint(program)): the
    program, the machine (for --program-json the document's merged
    one), the engine and AnalysisRequest.params()'s result-shaping
    knobs — runtime for oracle and sampled, ratio, seed and the
    requested draw for sampled."""
    from .service.fingerprint import request_fingerprint

    params: dict = {}
    if engine in ("oracle", "sampled"):
        params["runtime"] = args.runtime
    if engine == "sampled":
        params["ratio"] = args.ratio
        params["seed"] = args.seed
        params["device_draw"] = args.device_draw
    return request_fingerprint(program, machine, engine, params)


def _cli_ledger_row(args, program, machine, engine, engine_used, latency_s,
                    mrc=None, compiles0=None, reps=None) -> None:
    """One execution -> run-ledger row, the JAX CLI's row field for
    field. An engine the JAX package's service runs (SERVICE_ENGINES)
    gets that service's content address, so CLI rows of both packages
    join on one fingerprint. `compile_delta` holds the kernel builds
    since `compiles0` (runtime/telemetry.py::compile_counters_snapshot),
    only the nonzero ones."""
    from .runtime import telemetry
    from .runtime.obs import ledger as obs_ledger
    from .service import SERVICE_ENGINES

    fp = None
    if engine in SERVICE_ENGINES:
        fp = _request_fingerprint(args, program, machine, engine)
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
        ap.error("mode is required (acc|speed|sample|trace|analyze|stats)")
    if args.program_json and args.mode in ("trace", "stats"):
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
                args, program, machine, eng,
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
