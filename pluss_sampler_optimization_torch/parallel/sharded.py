"""Mesh-sharded sampled engine.

Port of the JAX package's parallel/sharded.py in its per-ref form (the
form that package runs for `fuse_refs=False` and in every multi-process
run), with both of its draws, chosen by SamplerConfig.device_draw as in
run_sampled (None: the device draw on CUDA, the host draw on the CPU):

- the device draw (sampler/draw.py): each ref's drawn (B,) buffer and
  its `chosen` mask are cut into `batch`-row steps. Across processes,
  every rank replays the identical draw on its own device and keeps
  only its rows, so no draw traffic crosses ranks. The draw needs a mesh
  size dividing the batch: an explicit device_draw=True raises
  otherwise, and the auto default falls back to the host draw with a
  warning, as in the JAX package;
- the host draw: the host-drawn keys go to the mesh in padded
  `batch`-row chunks.

Shard i of a step or chunk takes rows [i*local_b, (i+1)*local_b) on its
own device and, there:

- decodes and classifies them with the plain torch classify
  (sampler/sampled.py::classify_samples; the JAX package runs it in
  XLA here, not through its fused kernel);
- bins its noshare samples into the dense 64-bin pow2 histogram with
  `pow2_hist_auto` — kernel B2 (csrc/pow2_hist.cu) on CUDA tensors —
  weighted by the rows' mask (the chosen lanes, or the chunk's valid
  prefix);
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

Triangular nests run as in run_sampled (the plain classify takes the
triangular solver); one with a non-unit step raises NotImplementedError
at `_program_rows`, the JAX package's unit-step gate. Not ported yet:
the fused sharded form, the scan form's on-device pair merges
(merge_pair_sets), the sharded exact engines and replica placement are
listed in ROADMAP.md (A5, A6).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.distributed as dist

from ..config import MachineConfig, SamplerConfig
from ..ir import Program
from ..ops.histogram import N_EXP_BINS, fixed_k_unique
from ..ops.pow2_hist import pow2_hist_auto
from ..ops.sampled_hist import torch_vals
from ..runtime.hist import PRIState
from ..sampler.draw import draw_sample_keys_device
from ..sampler.sampled import (
    DEFAULT_CAPACITY,
    SampledRefResult,
    _pad_highs,
    _program_rows,
    _span,
    _use_device_draw,
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


def _classify(tnt, ref_idx: int, keys, w, highs, backend: str):
    """One shard's rows -> (pow2 noshare histogram and cold count as one
    (65,) int64 tensor, packed keys, their validity), on the shard's
    device. Rows where the bool weights `w` are False weigh nothing
    (padding, or lanes the device draw did not choose) and are decoded
    as key 0."""
    samples = decode_sample_keys(torch.where(w, keys, 0), highs)
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


def _device_draw_on_mesh(cfg: SamplerConfig, mesh: Mesh, batch: int) -> bool:
    """Whether the run takes the device draw: _use_device_draw on the
    mesh's devices, and a mesh size dividing the batch (the JAX
    package's rule: explicit True raises otherwise, auto falls back to
    the host stream with a warning)."""
    use = _use_device_draw(cfg, mesh.devices[0])
    n_dev = mesh.size
    if use and batch % n_dev != 0:
        if cfg.device_draw:
            raise ValueError(
                f"device_draw=True needs a mesh size dividing the "
                f"batch ({batch} % {n_dev} != 0): the device buffer "
                "cannot reshard evenly, and falling back would sample "
                "a different stream than run_sampled. Use a dividing "
                "mesh size or device_draw=None/False."
            )
        warnings.warn(
            f"device_draw auto-default downgrades to the host draw "
            f"stream: mesh size {n_dev} does not divide the batch "
            f"({batch}); results are statistically equivalent to "
            "run_sampled's device stream but not bit-identical. Pass "
            "a dividing mesh size (or device_draw=False on both "
            "engines) for bit-identity.",
            stacklevel=3,
        )
        use = False
    return use


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
    stage: "draw" (the device draw ends in its host read of its
    counts), "shard_put" (padding and the copy to the shards),
    "dispatch_psum" (classify, histogram, pairs and the reductions as
    enqueued), "gather_fetch" (the copy back) and "merge" (into the
    host dicts)."""
    cfg = cfg or SamplerConfig()
    mesh = _resolve_mesh(mesh, device)
    backend = cfg.kernel_backend or "auto"  # validated by SamplerConfig
    if batch is None:
        batch = default_batch(mesh.devices[0])
    n_dev = mesh.size
    n_proc, pid = _process_grid(mesh)
    shards = list(range(n_dev)) if n_proc == 1 else [pid]
    use_dev_draw = _device_draw_on_mesh(cfg, mesh, batch)
    # every process draws on a device of its own (the same draw)
    draw_dev = mesh.devices[shards[0]]
    trace, rows = _program_rows(program, machine)
    for nt in trace.nests:
        check_packed_ratios(nt)
    results = []
    dense_noshare = []
    for idx, (k, ri, _sig) in enumerate(rows):
        nt = trace.nests[k]
        tnts = {d: nt.with_vals(torch_vals(nt.vals, d))
                for d in {mesh.devices[i] for i in shards}}
        seed = cfg.seed * 1000003 + idx
        drawn = None
        if use_dev_draw:
            with _span(spans, "draw"):
                drawn = draw_sample_keys_device(nt, ri, cfg, seed, batch,
                                                draw_dev)
        if drawn is None:
            with _span(spans, "draw"):
                keys_all, highs = draw_sample_keys(nt, ri, cfg, seed=seed)
            n_samples = len(keys_all)
            steps = _host_steps(keys_all, n_dev, batch, shards, mesh, spans)
        else:
            keys_all, mask_all, n_samples, highs = drawn
            steps = _device_steps(keys_all, mask_all, n_dev, batch, shards,
                                  mesh, spans)
        noshare: dict[int, float] = {}
        share: dict[int, dict[int, float]] = {}
        cold = 0.0
        dense = np.zeros(N_EXP_BINS, dtype=np.int64)
        cap = capacity  # regrows 4x, sticky for the ref's later steps
        ph = _pad_highs(highs)
        for parts in steps:
            with _span(spans, "dispatch_psum"):
                outs = [
                    _classify(tnts[mesh.devices[i]], ri, *parts[i], ph,
                              backend)
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


def _host_steps(keys_all, n_dev, batch, shards, mesh, spans):
    """The host draw's chunks: for each, {shard: (keys, weights)} on the
    shards' devices. A chunk is `step` keys padded so that it splits
    evenly (every chunk of a ref longer than one is padded to `step`);
    the weights mark the unpadded prefix."""
    step = max(n_dev, (batch // n_dev) * n_dev)
    n_samples = len(keys_all)
    for s0 in range(0, n_samples, step):
        with _span(spans, "shard_put"):
            chunk, n_valid = pad_keys(
                keys_all[s0 : s0 + step], n_dev,
                total=step if n_samples > step else None,
            )
            local_b = len(chunk) // n_dev
            parts = {}
            for i in shards:
                dev = mesh.devices[i]
                keys = torch.from_numpy(
                    chunk[i * local_b : (i + 1) * local_b]).to(dev)
                base = i * local_b
                parts[i] = (keys, base + torch.arange(local_b, device=dev)
                            < n_valid)
        yield parts


def _device_steps(keys_all, mask_all, n_dev, batch, shards, mesh, spans):
    """The device draw's steps: each `batch` rows of the drawn buffer
    (B is a multiple of batch), split over the shards in contiguous
    rows, with the chosen mask as the weights: {shard: (keys, mask)}."""
    local_b = batch // n_dev
    for s0 in range(0, keys_all.shape[0], batch):
        with _span(spans, "shard_put"):
            parts = {}
            for i in shards:
                lo = s0 + i * local_b
                dev = mesh.devices[i]
                parts[i] = (keys_all[lo:lo + local_b].to(dev),
                            mask_all[lo:lo + local_b].to(dev))
        yield parts


def run_sampled_sharded(
    program: Program,
    machine: MachineConfig,
    cfg: SamplerConfig | None = None,
    mesh: Mesh | None = None,
    v2: bool = False,
    **kw,
) -> tuple[PRIState, list[SampledRefResult]]:
    """Sharded engine -> (PRIState, per-ref results); bit-identical to
    run_sampled at any mesh size under the same draw and batch (the same
    sample sets, exact merges).
    The per-ref results keep raw reuse values, so v2=True folds the
    runtime-v2 state. Keyword arguments go to sampled_outputs_sharded
    (device, batch, capacity, spans)."""
    cfg = cfg or SamplerConfig()
    results, _ = sampled_outputs_sharded(program, machine, cfg, mesh, **kw)
    return fold_results(results, machine.thread_num, v2), results
