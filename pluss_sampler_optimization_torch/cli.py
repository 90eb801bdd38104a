"""Command line of the port: the sampled engines' `sample` mode.

    python -m pluss_sampler_optimization_torch sample --model gemm --n 128
    python -m pluss_sampler_optimization_torch sample --n 16 --device cpu
    python -m pluss_sampler_optimization_torch sample --engine sharded

`--engine sharded` runs the mesh-sharded engine over every visible card
(one CPU device with `--device cpu`); its lines equal `--engine
sampled`'s. `--device-draw/--no-device-draw` picks the draw (default
auto: the device draw on CUDA, the host draw on the CPU), as the JAX
CLI's flag does for its sampled and sharded engines.

Prints the lines the JAX package's `sample` mode prints, in its order:
one line per tracked ref, the noshare and share private-reuse dumps, the
distributed reuse-time dump, the miss-ratio curve and the sample count.
Runs on CUDA unless `--device cpu` is given, and fails where CUDA is
absent.
"""

from __future__ import annotations

import argparse

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
    ap.add_argument("--kernel-backend", default=None, choices=KERNEL_BACKENDS,
                    help="kernel implementation (default auto: the CUDA "
                    "kernels on the card, plain torch on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def sample_lines(program, machine, cfg, device,
                 engine: str = "sampled") -> list[str]:
    """The sample mode's output lines."""
    from .runtime import report
    from .runtime.aet import aet_mrc
    from .runtime.cri import cri_distribute

    if engine == "sharded":
        from .parallel import run_sampled_sharded as run
    else:
        from .sampler.sampled import run_sampled as run
    state, per_ref = run(program, machine, cfg, device=device)
    lines = [
        f"ref {r.name}: {r.n_samples} samples, cold {r.cold:g}"
        for r in per_ref
    ]
    lines += report.noshare_dump(state)
    lines += report.share_dump(state)
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
    cfg = SamplerConfig(
        ratio=args.ratio, seed=args.seed, device_draw=args.device_draw,
        kernel_backend=args.kernel_backend,
    )
    report.emit(sample_lines(program, machine, cfg, args.device,
                             args.engine))
    return 0
