"""Command line of the port: the `acc`, `speed`, `sample` and `trace` modes.

    python -m pluss_sampler_optimization_torch acc --model gemm --n 128
    python -m pluss_sampler_optimization_torch acc --engine exact --shard
    python -m pluss_sampler_optimization_torch acc --diff-against oracle
    python -m pluss_sampler_optimization_torch speed --engine periodic
    python -m pluss_sampler_optimization_torch trace --tid 0 --limit 20
    python -m pluss_sampler_optimization_torch sample --model gemm --n 128
    python -m pluss_sampler_optimization_torch sample --engine sharded
    python -m pluss_sampler_optimization_torch sample --runtime v2 --r10
    python -m pluss_sampler_optimization_torch sample --max-rounds 3

The modes of the JAX package's CLI, with its lines in its order:

- `acc`: one run of `--engine` (default dense), then the reference's
  accuracy dumps — the noshare and share private-reuse histograms, the
  distributed reuse-time dump, the miss-ratio curve and the
  max-iteration count (...ri-omp-seq.cpp:334-362). Engines: `oracle`
  (the serial walk; `--schedule dynamic` and `--runtime v2` apply to it
  alone), `numpy`, `dense`, `stream`, `periodic`, `analytic`, `exact`
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
  logs, runtime/debug.py).

The engines run on CUDA unless `--device cpu` is given, and fail where
CUDA is absent; the oracle and numpy engines and `trace` are host code.
`native` and `native-par` are not ported yet.
"""

from __future__ import annotations

import argparse
import sys
import types

from .config import KERNEL_BACKENDS, MachineConfig, SamplerConfig

ENGINES = ("oracle", "numpy", "native", "native-par", "dense", "stream",
           "periodic", "analytic", "exact", "sampled", "sharded")
_DIFF_ENGINES = tuple(e for e in ENGINES
                      if e not in ("native", "native-par"))
_SHARDED_EXACT = ("periodic", "analytic", "exact")


def _parser() -> argparse.ArgumentParser:
    from .models import REGISTRY

    ap = argparse.ArgumentParser(prog="pluss_sampler_optimization_torch")
    ap.add_argument("mode", choices=["acc", "speed", "sample", "trace"])
    ap.add_argument("--model", default="gemm", choices=sorted(REGISTRY))
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--tsteps", type=int, default=1,
                    help="time steps (jacobi-2d, fdtd-2d, heat-3d, adi)")
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
                    "on the card, plain torch on the CPU)")
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
    ap.add_argument("--diff-against", default=None, metavar="ENGINE",
                    help="run a second engine and fail unless its dumps "
                    "are byte-identical (the reference's output.txt diff "
                    "protocol; compare full-traversal engines with each "
                    "other, or sampled with sharded)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
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
    from .sampler.sampled import fold_results, sampled_outputs

    per_ref = sampled_outputs(program, machine, cfg, device=args.device,
                              raw_noshare=v2 or args.r10,
                              checkpoint_dir=args.checkpoint_dir)
    return fold_results(per_ref, machine.thread_num, v2), per_ref


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
        raise NotImplementedError(
            f"--engine {engine}: the native CPU path (native/) is not "
            "ported yet (ROADMAP.md A6, 'The native CPU path')"
        )
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
                 ref_lines: bool = True) -> list[str]:
    """The dump lines of one run's folded state: the per-ref lines of a
    sampled run (`ref_lines`, sample mode), the noshare and share
    dumps, the per-ref r10 histograms under `r10` (results of the raw
    route), the distributed reuse-time dump, the MRC, and the
    max-iteration count (`total`, default the runs' samples; "samples"
    for a sampled run, "accesses" for an exact one, per_ref None)."""
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
    lines += report.mrc_lines(aet_mrc(rih, machine))
    if total is None:
        total = sum(r.n_samples for r in per_ref)
    label = "samples" if per_ref is not None else "accesses"
    lines.append(f"max iteration count: {total} {label}")
    return lines


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
        if args.diff_against not in _DIFF_ENGINES:
            raise SystemExit(
                f"unknown --diff-against engine {args.diff_against!r} "
                f"(have {', '.join(_DIFF_ENGINES)})"
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
    is timed apart from each run."""
    from .runtime.timing import timed

    times, _last, flushes = timed(
        lambda: _run_engine(engine, program, machine, args),
        reps=args.reps,
        flush_kb=machine.cache_kb,
    )
    for rep, dt in enumerate(times):
        print(f"{engine} {program.name} run {rep}: {dt:.6f} s")
    print(
        f"{engine} {program.name}: best {min(times):.6f} s, "
        f"mean {sum(times) / len(times):.6f} s over {len(times)} runs"
    )
    print(
        f"{engine} {program.name}: cache-flush overhead "
        f"{sum(flushes) / len(flushes):.6f} s/rep "
        "(excluded from the timings above)"
    )
    return 0


def main(argv=None) -> int:
    from .models import build
    from .runtime import report

    args = _parser().parse_args(argv)
    machine = MachineConfig(thread_num=args.threads, chunk_size=args.chunk)
    try:
        program = build(args.model, args.n, args.tsteps)
    except (KeyError, ValueError) as e:
        raise SystemExit(str(e.args[0] if e.args else e))
    engine = args.engine or ("sampled" if args.mode == "sample" else "dense")
    _check_args(args, engine)
    if args.mode == "trace":
        return _trace(args, program, machine)
    if args.mode == "speed":
        return _speed(args, program, machine, engine)

    def lines_of(eng: str) -> list[str]:
        res, per_ref = _run_engine(eng, program, machine, args)
        return result_lines(res.state, per_ref, machine, args.r10,
                            total=res.total_accesses,
                            ref_lines=args.mode == "sample")

    lines = lines_of(engine)
    report.emit(lines)
    if args.diff_against:
        # the reference's acc protocol appends each implementation's
        # dumps to output.txt for manual inspection (run.sh:3-12,
        # README.md:10-12); this automates the comparison
        other_lines = lines_of(args.diff_against)
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
