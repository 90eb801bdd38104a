"""Command line of the port: the sampled engine's `sample` mode.

    python -m pluss_sampler_optimization_torch sample --model gemm --n 128
    python -m pluss_sampler_optimization_torch sample --n 16 --device cpu

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
    ap.add_argument("--kernel-backend", default=None, choices=KERNEL_BACKENDS,
                    help="classify+histogram implementation (default auto: "
                    "the CUDA kernel on the card, plain torch on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def sample_lines(program, machine, cfg, device) -> list[str]:
    """The sample mode's output lines."""
    from .runtime import report
    from .runtime.aet import aet_mrc
    from .runtime.cri import cri_distribute
    from .sampler.sampled import run_sampled

    state, per_ref = run_sampled(program, machine, cfg, device=device)
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
        ratio=args.ratio, seed=args.seed, kernel_backend=args.kernel_backend
    )
    report.emit(sample_lines(program, machine, cfg, args.device))
    return 0
