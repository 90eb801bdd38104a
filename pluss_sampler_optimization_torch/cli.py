"""Command line of the port: the sampled engines' `sample` mode.

    python -m pluss_sampler_optimization_torch sample --model gemm --n 128
    python -m pluss_sampler_optimization_torch sample --n 16 --device cpu
    python -m pluss_sampler_optimization_torch sample --engine sharded
    python -m pluss_sampler_optimization_torch sample --runtime v2 --r10
    python -m pluss_sampler_optimization_torch sample --max-rounds 3

`--engine sharded` runs the mesh-sharded engine over every visible card
(one CPU device with `--device cpu`), in its fused form where
`--fuse-refs` resolves on (by default on CUDA) and its per-ref form
otherwise; its lines equal `--engine sampled`'s. `--tolerance`,
`--max-rounds` and `--round-schedule` run `--engine sampled`
progressively (sampler/sampled.py::run_sampled_progressive, always on
the host draw) and print `progressive: rounds a/b, band w, converged c`
on stderr; a full schedule prints the lines of the one-shot run on the
host draw. `--device-draw/--no-device-draw` picks the draw (default
auto: the device draw on CUDA, the host draw on the CPU), as the JAX
CLI's flag does for its sampled and sharded engines. `--runtime v2`
keeps noshare reuse raw in the state, `--r10` distributes with the r10
generated code's per-ref quirk copies and prints each per-ref
histogram; both take the sampled engine's raw route. `--fuse-refs`,
`--pipeline-depth` and `--checkpoint-dir` are the engines' runner,
pipeline and resume knobs; none changes a printed line.

Prints the lines the JAX package's `sample` mode prints, in its order:
one line per tracked ref, the noshare and share private-reuse dumps, the
per-ref r10 histograms under `--r10`, the distributed reuse-time dump,
the miss-ratio curve and the sample count. Runs on CUDA unless
`--device cpu` is given, and fails where CUDA is absent.
"""

from __future__ import annotations

import argparse
import sys

from .config import KERNEL_BACKENDS, MachineConfig, SamplerConfig


def _parser() -> argparse.ArgumentParser:
    from .models import REGISTRY

    ap = argparse.ArgumentParser(prog="pluss_sampler_optimization_torch")
    ap.add_argument("mode", choices=["sample"])
    ap.add_argument("--model", default="gemm", choices=sorted(REGISTRY))
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--ratio", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="sampled",
                    choices=["sampled", "sharded"],
                    help="sampled (default) or sharded (the mesh-sharded "
                    "engine over every visible card)")
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
                    help="kernel implementation (default auto: the CUDA "
                    "kernels on the card, plain torch on the CPU)")
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
                    "keeps raw keys (pluss_utils_v2.h:915-918)")
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


def _run(program, machine, cfg, device, engine: str, v2: bool, raw: bool,
         checkpoint_dir: str | None):
    """(PRIState, per-ref results) of one engine run; `raw` takes the
    sampled engine's raw-noshare route (the sharded engine's results
    always keep raw keys)."""
    if engine == "sharded":
        from .parallel import run_sampled_sharded

        return run_sampled_sharded(program, machine, cfg, device=device,
                                   v2=v2)
    from .sampler.sampled import fold_results, sampled_outputs

    per_ref = sampled_outputs(program, machine, cfg, device=device,
                              raw_noshare=raw,
                              checkpoint_dir=checkpoint_dir)
    return fold_results(per_ref, machine.thread_num, v2), per_ref


def sample_lines(program, machine, cfg, device, engine: str = "sampled",
                 runtime: str = "v1", r10: bool = False,
                 checkpoint_dir: str | None = None) -> list[str]:
    """The sample mode's output lines."""
    v2 = runtime == "v2"
    state, per_ref = _run(program, machine, cfg, device, engine, v2,
                          v2 or r10, checkpoint_dir)
    return result_lines(state, per_ref, machine, r10)


def result_lines(state, per_ref, machine, r10: bool = False) -> list[str]:
    """The sample mode's lines of one run's folded state and per-ref
    results (under `r10`, results of the raw route)."""
    from .runtime import report
    from .runtime.aet import aet_mrc
    from .runtime.cri import cri_distribute, r10_distribute

    lines = [
        f"ref {r.name}: {r.n_samples} samples, cold {r.cold:g}"
        for r in per_ref
    ]
    lines += report.noshare_dump(state)
    lines += report.share_dump(state)
    if r10:
        rih, per_ref_hists = r10_distribute(per_ref, machine.thread_num)
        for name, h in per_ref_hists.items():
            lines += report.histogram_lines(name, h)
    else:
        rih = cri_distribute(state, machine.thread_num, machine.thread_num)
    lines += report.rih_dump(rih)
    lines += report.mrc_lines(aet_mrc(rih, machine))
    total = sum(r.n_samples for r in per_ref)
    lines.append(f"max iteration count: {total} samples")
    return lines


def main(argv=None) -> int:
    from .models import build
    from .runtime import report

    args = _parser().parse_args(argv)
    machine = MachineConfig(thread_num=args.threads, chunk_size=args.chunk)
    program = build(args.model, args.n)
    kw = {}
    if args.pipeline_depth is not None:  # None = keep the config default
        kw["pipeline_depth"] = args.pipeline_depth
    progressive = any(
        v is not None for v in (args.tolerance, args.max_rounds,
                                args.round_schedule)
    )
    if args.round_schedule is not None:
        kw["round_schedule"] = _parse_round_schedule(args.round_schedule)
    cfg = SamplerConfig(
        ratio=args.ratio, seed=args.seed, device_draw=args.device_draw,
        kernel_backend=args.kernel_backend, fuse_refs=args.fuse_refs,
        tolerance=args.tolerance, max_rounds=args.max_rounds, **kw,
    )
    if args.engine == "sampled" and progressive:
        from .sampler.sampled import run_sampled_progressive

        state, per_ref, info = run_sampled_progressive(
            program, machine, cfg, v2=args.runtime == "v2",
            device=args.device,
        )
        print(
            f"progressive: rounds "
            f"{info['rounds']}/{info['rounds_total']}, band "
            f"{info['band_width']:.6f}, converged "
            f"{info['converged']}",
            file=sys.stderr,
        )
        report.emit(result_lines(state, per_ref, machine, args.r10))
        return 0
    report.emit(sample_lines(program, machine, cfg, args.device,
                             args.engine, args.runtime, args.r10,
                             args.checkpoint_dir))
    return 0
