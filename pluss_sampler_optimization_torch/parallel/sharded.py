"""Mesh-sharded sampled engine.

Port of the JAX package's parallel/sharded.py in its per-ref form with
the host draw (the form that package runs on the CPU, for
`fuse_refs=False` and in every multi-process run). For every tracked
reference, the host-drawn sample keys go to the mesh in padded chunks;
shard i of a chunk takes rows [i*local_b, (i+1)*local_b) on its own
device and, there:

- decodes and classifies them with the plain torch classify
  (sampler/sampled.py::classify_samples; the JAX package runs it in
  XLA here, not through its fused kernel);
- bins its noshare samples into the dense 64-bin pow2 histogram with
  `pow2_hist_auto` — kernel B2 (csrc/pow2_hist.cu) on CUDA tensors;
- counts its cold samples and reduces its found samples to exact
  (packed key, count) pairs with `fixed_k_unique`.

The mesh reduction is the JAX package's psum and all_gather: the
histograms and cold counts are summed and the pairs stacked in shard
order — on the mesh's first device in one process, by torch.distributed
all_reduce/all_gather across processes (one mesh device per rank), so
every rank decodes identical results. The pairs keep raw reuse values,
so the per-ref results fold to run_sampled's PRIState exactly (and to
the runtime-v2 state with v2=True); the psum'd pow2 histogram comes
back beside them, for observability.

Not ported yet: triangular nests (ROADMAP A1) and the device draw with
the scan form (ROADMAP A3) raise NotImplementedError; the fused
sharded form, the sharded exact engines and replica placement are
listed in ROADMAP.md.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..config import MachineConfig, SamplerConfig
from ..ir import Program
from ..ops.histogram import N_EXP_BINS, fixed_k_unique
from ..ops.pow2_hist import pow2_hist_auto
from ..ops.sampled_hist import torch_vals
from ..runtime.hist import PRIState
from ..sampler.sampled import (
    DEFAULT_CAPACITY,
    SampledRefResult,
    _pad_highs,
    _program_rows,
    _span,
    check_packed_ratios,
    classify_samples,
    decode_pairs,
    decode_sample_keys,
    default_batch,
    draw_sample_keys,
    fold_results,
    pad_keys,
    resolve_device,
)
from .mesh import Mesh, build_mesh


def _resolve_mesh(mesh: Mesh | None, device) -> Mesh:
    """The run's mesh: the given one, or every visible card (CUDA, the
    default) or a one-device mesh on the device the caller names."""
    if mesh is None:
        dev = resolve_device(device)
        if dev == torch.device("cuda"):
            return build_mesh()
        return build_mesh(devices=[dev])
    if device is not None and torch.device(device).type != (
        mesh.devices[0].type
    ):
        raise ValueError(
            f"device={device!r} disagrees with the mesh's devices "
            f"{mesh.devices}"
        )
    return mesh


def _process_grid(mesh: Mesh) -> tuple[int, int]:
    """(process count, this process's index). A multi-process run needs
    one mesh device per rank (build_global_mesh)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return 1, 0
    n_proc = dist.get_world_size()
    if mesh.size != n_proc:
        raise ValueError(
            f"a {n_proc}-process run needs one mesh device per rank "
            f"(build_global_mesh()), got a mesh of {mesh.size}"
        )
    return n_proc, dist.get_rank()


def _classify(tnt, ref_idx: int, keys, base: int, n_valid: int, highs,
              backend: str):
    """One shard's rows -> (pow2 noshare histogram and cold count as one
    (65,) int64 tensor, packed keys, their validity), on the shard's
    device. `base` is the shard's first row in the chunk: rows at or
    past n_valid are padding and weigh nothing."""
    w = base + torch.arange(len(keys), device=keys.device) < n_valid
    samples = decode_sample_keys(keys, highs)
    packed, ri, is_share, found = classify_samples(
        tnt, ref_idx, samples, ref_idx
    )
    nosh = pow2_hist_auto(torch.clamp(ri, min=1), found & ~is_share & w,
                          backend)
    cold = (~found & w).sum().reshape(1)
    return torch.cat([nosh, cold]), packed, found & w


def _pairs(packed, valid, cap: int):
    """fixed_k_unique's (keys, counts, n_unique) as one (2*cap+1,)
    int64 tensor, so one all_gather carries them."""
    keys, counts, n_unique = fixed_k_unique(packed, valid, cap)
    return torch.cat([keys, counts, n_unique.reshape(1)])


def _psum(xs: list, mesh: Mesh, n_proc: int):
    """The shards' tensors summed: on mesh.devices[0] in one process,
    by all_reduce across processes (xs is then this rank's one)."""
    if n_proc == 1:
        out = xs[0].to(mesh.devices[0])
        for x in xs[1:]:
            out = out + x.to(mesh.devices[0])
        return out
    (out,) = xs
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def _all_gather(xs: list, mesh: Mesh, n_proc: int):
    """The shards' tensors stacked in shard order (rank order across
    processes): (n_dev, ...)."""
    if n_proc == 1:
        return torch.stack([x.to(mesh.devices[0]) for x in xs])
    (x,) = xs
    out = [torch.empty_like(x) for _ in range(n_proc)]
    dist.all_gather(out, x)
    return torch.stack(out)


def sampled_outputs_sharded(
    program: Program,
    machine: MachineConfig,
    cfg: SamplerConfig | None = None,
    mesh: Mesh | None = None,
    batch: int | None = None,
    capacity: int = DEFAULT_CAPACITY,
    device=None,
    spans: dict | None = None,
):
    """Sharded sampled engine -> per-ref SampledRefResult (exact) plus
    the psum'd dense noshare histograms (per ref, for observability).

    Runs on `mesh`, by default every visible card, or one CPU device
    with device="cpu". `spans`, when given, gathers host seconds per
    stage: "draw", "shard_put" (padding and the copy to the shards),
    "dispatch_psum" (classify, histogram, pairs and the reductions as
    enqueued), "gather_fetch" (the copy back) and "merge" (into the
    host dicts)."""
    cfg = cfg or SamplerConfig()
    if cfg.device_draw:
        raise NotImplementedError(
            "the device draw and the sharded engine's scan form are not "
            "ported yet (ROADMAP A3); device_draw=None/False takes the "
            "host numpy draw"
        )
    mesh = _resolve_mesh(mesh, device)
    backend = cfg.kernel_backend or "auto"  # validated by SamplerConfig
    if batch is None:
        batch = default_batch(mesh.devices[0])
    n_dev = mesh.size
    n_proc, pid = _process_grid(mesh)
    shards = list(range(n_dev)) if n_proc == 1 else [pid]
    trace, rows = _program_rows(program, machine)
    for nt in trace.nests:
        check_packed_ratios(nt)
    step = max(n_dev, (batch // n_dev) * n_dev)
    results = []
    dense_noshare = []
    for idx, (k, ri, _sig) in enumerate(rows):
        nt = trace.nests[k]
        tnts = {d: nt.with_vals(torch_vals(nt.vals, d))
                for d in {mesh.devices[i] for i in shards}}
        with _span(spans, "draw"):
            keys_all, highs = draw_sample_keys(
                nt, ri, cfg, seed=cfg.seed * 1000003 + idx
            )
        n_samples = len(keys_all)
        noshare: dict[int, float] = {}
        share: dict[int, dict[int, float]] = {}
        cold = 0.0
        dense = np.zeros(N_EXP_BINS, dtype=np.int64)
        cap = capacity  # regrows 4x, sticky for the ref's later chunks
        ph = _pad_highs(highs)
        for s0 in range(0, n_samples, step):
            with _span(spans, "shard_put"):
                chunk, n_valid = pad_keys(
                    keys_all[s0 : s0 + step], n_dev,
                    total=step if n_samples > step else None,
                )
                local_b = len(chunk) // n_dev
                parts = {
                    i: torch.from_numpy(
                        chunk[i * local_b : (i + 1) * local_b]
                    ).to(mesh.devices[i])
                    for i in shards
                }
            with _span(spans, "dispatch_psum"):
                outs = [
                    _classify(tnts[mesh.devices[i]], ri, parts[i],
                              i * local_b, n_valid, ph, backend)
                    for i in shards
                ]
                nh_cold = _psum([o[0] for o in outs], mesh, n_proc)
            while True:
                with _span(spans, "dispatch_psum"):
                    pairs = _all_gather(
                        [_pairs(o[1], o[2], cap) for o in outs], mesh, n_proc
                    )
                with _span(spans, "gather_fetch"):
                    pairs = pairs.cpu().numpy()
                n_unique = pairs[:, -1]
                if int(n_unique.max()) <= cap:
                    break
                # rare: some shard saw more distinct (reuse, class)
                # pairs than slots — regrow and reduce again
                cap = max(cap * 4, int(n_unique.max()))
            with _span(spans, "gather_fetch"):
                nh_cold = nh_cold.cpu().numpy()
            dense += nh_cold[:N_EXP_BINS]
            cold += float(nh_cold[N_EXP_BINS])
            with _span(spans, "merge"):
                for d in range(n_dev):
                    decode_pairs(pairs[d, :cap], pairs[d, cap:2 * cap],
                                 noshare, share)
        results.append(
            SampledRefResult(
                name=nt.tables.ref_names[ri], noshare=noshare, share=share,
                cold=cold, n_samples=n_samples,
            )
        )
        dense_noshare.append(dense)
    return results, dense_noshare


def run_sampled_sharded(
    program: Program,
    machine: MachineConfig,
    cfg: SamplerConfig | None = None,
    mesh: Mesh | None = None,
    v2: bool = False,
    **kw,
) -> tuple[PRIState, list[SampledRefResult]]:
    """Sharded engine -> (PRIState, per-ref results); bit-identical to
    run_sampled at any mesh size (same host draw stream, exact merges).
    The per-ref results keep raw reuse values, so v2=True folds the
    runtime-v2 state. Keyword arguments go to sampled_outputs_sharded
    (device, batch, capacity, spans)."""
    cfg = cfg or SamplerConfig()
    results, _ = sampled_outputs_sharded(program, machine, cfg, mesh, **kw)
    return fold_results(results, machine.thread_num, v2), results
