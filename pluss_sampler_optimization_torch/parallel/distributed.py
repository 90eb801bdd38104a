"""Multi-process execution setup over torch.distributed.

The same mesh that scales across cards in one process scales across
processes: `initialize_distributed` joins this process to a process
group (NCCL for CUDA, gloo for the CPU), one device per rank, and
`build_global_mesh` lays the sample axis over every rank's device in
rank order.

Typical launch (the same program in every process):

    from pluss_sampler_optimization_torch.parallel import (
        initialize_distributed, build_global_mesh, run_sampled_sharded,
    )

    initialize_distributed("localhost:29500", num_processes, process_id)
    mesh = build_global_mesh()
    state, results = run_sampled_sharded(prog, machine, cfg, mesh)

Every rank draws the same deterministic sample batch and classifies
only the rows its own shard holds; the dense histograms are summed by
all_reduce and the exact (reuse, count) pairs all_gathered, so every
rank decodes identical results.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import SAMPLE_AXIS, Mesh, build_mesh

_init_args: Optional[tuple] = None


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> None:
    """Join this process to a multi-process run.

    `coordinator_address` is rank 0's "host:port" (a "scheme://" URL is
    passed through); with no arguments the launcher's environment
    (MASTER_ADDR, WORLD_SIZE, RANK) is read. The process group is NCCL
    on CUDA and gloo when `device="cpu"`; a CUDA rank takes the card
    LOCAL_RANK names, else its rank modulo the visible cards. A
    degenerate single-process run needs no call at all. Idempotent for
    a REPEATED identical call; a re-call with a different topology
    raises instead of silently keeping the first one.
    """
    from ..sampler.sampled import resolve_device

    global _init_args
    args = (coordinator_address, num_processes, process_id)
    if dist.is_initialized():
        if _init_args == args or args == (None, None, None):
            return
        raise ValueError(
            f"torch.distributed already initialized "
            f"({'with ' + repr(_init_args) if _init_args else 'externally'}); "
            f"conflicting re-initialization {args}"
        )
    dev = resolve_device(device)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
    )
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()
        )))
    _init_args = args


def _local_device() -> torch.device:
    """This rank's device: its current card under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def build_global_mesh(axis: str = SAMPLE_AXIS) -> Mesh:
    """1-D mesh over every rank's device, in rank order (one device per
    rank). Without a process group it is build_mesh()."""
    if not dist.is_initialized():
        return build_mesh(axis=axis)
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, str(_local_device()))
    return Mesh(tuple(names), axis)
