"""Mesh-sharded sampled engine.

Port of the JAX package's parallel/sharded.py, in its two forms and with
its routing between them (`_use_fused(cfg, device) and n_proc == 1`
takes the fused form; by default that means a mesh of CUDA devices, and
fuse_refs=True takes it on the CPU):

- the fused form (`_sampled_outputs_sharded_fused`, the JAX package's
  function of that name): refs are grouped into run_sampled's
  kernel-signature buckets; each bucket's stacked [R, B] keys and masks
  (its device-drawn rows, grouped by buffer size, or its host-drawn
  keys padded with each row's first key and masked) are split over the
  shards along the sample axis, and each shard scans its [R, B/n_dev]
  columns in `batch/n_dev`-column steps. One mesh reduction and one
  read back per group, with its own capacity regrow;
- the per-ref form (fuse_refs=False, and every multi-process run): under
  the device draw each ref's drawn (B,) buffer and `chosen` mask are
  split into n_dev contiguous blocks, and each shard scans its block in
  `batch/n_dev`-row steps, as the JAX package's scan form; one mesh
  reduction and one read back per ref. Across processes every rank
  replays the identical draw on its own device and keeps only its block,
  so no draw traffic crosses ranks. Under the host draw the keys go to
  the mesh in padded `batch`-row chunks, one reduction and read back per
  chunk.

A shard's step is, on its own device:

- on the kernel route (kernel_backend "cuda", or "auto" on CUDA
  devices): kernel B1's raw-noshare form (csrc/sampled_hist.cu, through
  sampler/sampled.py::bucket_dispatch(raw=True)) on the step's column
  span, every chosen lane coming back as an exact (packed key, count)
  pair with its raw reuse value, `cold` counting the rest;
- on the plain route (kernel_backend "torch", or a mesh of CPU
  devices): the JAX package's own body, the plain classify
  (sampler/sampled.py::classify_samples), `exp_hist` of max(ri, 1) over
  the noshare lanes and `fixed_k_unique` of the found lanes.

The step's pairs merge into the shard's running pair set
(`merge_pair_sets`), and its cold count (and the plain route's
histogram) add up there, with no host read between steps. `max_nu`
tracks every step's and every merge's distinct count: above the
capacity some set was cut, so the whole group reruns at
max(4 * capacity, max_nu), which then sticks, and a cut set is never
folded.

The mesh reduction is the JAX package's psum and all_gather: cold
counts (and histograms) summed and the pair sets stacked in shard order,
on the mesh's first device in one process, by torch.distributed
all_reduce/all_gather across processes (one mesh device per rank), so
every rank decodes identical results and takes the same regrow. The
pairs keep raw reuse values, so the per-ref results fold to
run_sampled's PRIState exactly (and to the runtime-v2 state with
v2=True). Each ref's dense pow2 noshare histogram comes back beside
them, for observability: the plain route's psum'd `exp_hist`, and on the
kernel route the binning of the gathered noshare pairs, max(ri, 1)
weighted by the count, through kernel B2 (csrc/pow2_hist.cu) — equal
bin for bin.

Triangular nests run as in run_sampled; one with a non-unit step raises
NotImplementedError at `_program_rows`, the JAX package's unit-step
gate. The exact engines' sharded forms (run_periodic_sharded,
run_analytic_sharded, run_dense_sharded, run_exact_sharded) are at the
end of this module. Not ported yet: replica placement (ROADMAP.md, A6).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.distributed as dist

from ..config import MachineConfig, SamplerConfig
from ..ir import Program
from ..ops.histogram import (
    N_EXP_BINS,
    exp_hist,
    fixed_k_unique,
    merge_pair_sets,
)
from ..ops.pow2_hist import pow2_hist_auto
from ..ops.sampled_hist import (
    build_descriptor,
    device_descriptor,
    torch_vals,
    tri_table,
)
from ..runtime import telemetry
from ..runtime.hist import PRIState
from ..sampler.draw import draw_bucket_keys_device, draw_sample_keys_device
from ..sampler.sampled import (
    _NOSHARE_SLOT,
    _RATIO_SLOTS,
    DEFAULT_CAPACITY,
    SampledRefResult,
    _bucket_rows,
    _count,
    _gauge,
    _host_fuse_plan,
    _pad_highs,
    _program_rows,
    _sample_highs,
    _span,
    _use_device_draw,
    _use_fused,
    bucket_dispatch,
    check_packed_ratios,
    check_native,
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


def _kernel_route(backend: str, mesh: Mesh) -> bool:
    """Whether the shards run kernel B1's raw form: backend "cuda", or
    "auto" on a mesh of CUDA devices ("cuda" on CPU devices raises at
    the launch)."""
    return backend == "cuda" or (
        backend == "auto" and mesh.devices[0].type == "cuda"
    )


class _Body:
    """One shard step of a bucket (or of one ref, R = 1) on each of the
    run's devices: kernel B1's raw form or the plain body (see the
    module docstring). The descriptor is made once; its buffer-form copy
    (a descriptor past the parameter form's words), the triangular base
    table and the value overlay once per device."""

    def __init__(self, nt, ref_idx: int, highs, devices, backend: str,
                 kernel: bool):
        self.nt, self.ref_idx, self.backend = nt, ref_idx, backend
        self.kernel = kernel
        self.ph = _pad_highs(highs)
        if kernel:
            self.desc = build_descriptor(nt, ref_idx)
            self.tri = {d: tri_table(nt, d) for d in devices}
            self.desc_dev = {d: device_descriptor(self.desc, d)
                             for d in devices}
        else:
            self.tnt = {d: nt.with_vals(torch_vals(nt.vals, d))
                        for d in devices}

    def step(self, keys, mask, rx, cap: int):
        """keys/mask [R, b] on one device (rows of contiguous lanes, a
        fixed stride apart), rx [R] there -> (histogram [R, 64] or None
        on the kernel route, cold [R], pair keys [R, cap], pair counts
        [R, cap], distinct counts [R])."""
        dev = keys.device
        if self.kernel:
            (pk, pc, nu, cold, _hist), _ = bucket_dispatch(
                self.nt, self.ref_idx, keys, mask, self.ph, rx, cap,
                self.backend, self.desc, self.tri[dev], raw=True,
                desc_dev=self.desc_dev[dev],
            )
            return None, cold, pk, pc, nu
        tnt = self.tnt[dev]
        rows = []
        for r in range(keys.shape[0]):
            w = mask[r]
            samples = decode_sample_keys(torch.where(w, keys[r], 0),
                                         self.ph)
            packed, ri, is_share, found = classify_samples(
                tnt, self.ref_idx, samples, rx[r]
            )
            rows.append((
                exp_hist(torch.clamp(ri, min=1), found & ~is_share & w),
                (~found & w).sum(),
                *fixed_k_unique(packed, found & w, cap),
            ))
        return tuple(torch.stack([x[i] for x in rows]) for i in range(5))


def _merge(acc, out, cap: int):
    """Fold one step's outputs into a shard's running (histogram or
    None, cold, pair keys, pair counts, max_nu), all [R, ...]; the
    first step is the running set as it is."""
    nh, cold, pk, pc, nu = out
    if acc is None:
        return nh, cold, pk, pc, nu
    anh, acold, ak, ac, max_nu = acc
    merged = [merge_pair_sets(ak[j], ac[j], pk[j], pc[j], cap)
              for j in range(pk.shape[0])]
    mk, mc, mnu = (torch.stack([m[i] for m in merged]) for i in range(3))
    return (
        None if nh is None else anh + nh, acold + cold, mk, mc,
        torch.maximum(max_nu, torch.maximum(nu, mnu)),
    )


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


def dense_from_pairs(keys, counts, backend: str = "auto"):
    """The pow2 noshare histogram of pair sets: every noshare pair (slot
    15 of its packed key) binned at max(reuse, 1), weighted by its count,
    through pow2_hist_auto (kernel B2 on CUDA tensors, with int64
    weights). keys/counts [..., R, cap] -> [R, 64]; one launch per row R.
    It equals `exp_hist(max(ri, 1), found & ~is_share & w)` over the
    samples the pairs count (a reuse below 1 lands in bin 0)."""
    R = keys.shape[-2]
    keys = keys.transpose(0, -2).reshape(R, -1)
    counts = counts.transpose(0, -2).reshape(R, -1)
    values = torch.clamp(torch.div(keys, _RATIO_SLOTS, rounding_mode="floor"),
                         min=1)
    weights = torch.where(keys % _RATIO_SLOTS == _NOSHARE_SLOT, counts, 0)
    return torch.stack([pow2_hist_auto(values[j], weights[j], backend)
                        for j in range(R)])


class _Group:
    """One mesh reduction: every shard's steps, given as {shard: [(keys
    [R, b], mask [R, b]), ...]} on the shards' devices, with the members'
    rx per device. `fused` marks a bucket's group of the fused form (its
    telemetry spans carry the JAX package's fused attributes)."""

    def __init__(self, body: _Body, steps: dict, rx: dict,
                 fused: bool = False):
        self.body, self.steps, self.rx = body, steps, rx
        self.fused = fused

    def run(self, cap, mesh, n_proc, spans, counters):
        """Enqueue every step, merge on the shards, reduce over the mesh
        and read back once: (histograms [R, 64], cold [R], pair keys and
        counts [n_dev, R, cap], max_nu), numpy."""
        body = self.body
        R = next(iter(self.rx.values())).shape[0]
        _count(counters, "dispatches")
        with _span(spans, "dispatch_psum",
                   **({"form": "fused", "refs": R} if self.fused else {})):
            accs = []
            for i, steps in self.steps.items():
                acc = None
                for keys, mask in steps:
                    acc = _merge(acc, body.step(keys, mask,
                                                self.rx[keys.device], cap),
                                 cap)
                accs.append(acc)
            R = accs[0][1].shape[0]
            summed = _psum(
                [a[1][:, None] if a[0] is None
                 else torch.cat([a[0], a[1][:, None]], 1) for a in accs],
                mesh, n_proc)
            pairs = _all_gather(
                [torch.cat([a[2], a[3], a[4][:, None]], 1) for a in accs],
                mesh, n_proc)
            parts = [summed.reshape(-1), pairs.reshape(-1)]
            if body.kernel:
                parts.append(dense_from_pairs(
                    pairs[:, :, :cap], pairs[:, :, cap:2 * cap],
                    body.backend).reshape(-1))
            flat = torch.cat(parts)
        with _span(spans, "gather_fetch",
                   **({"fused": True} if self.fused else {})):
            _count(counters, "fetches", tele=False)
            flat = telemetry.record_fetch(flat.cpu().numpy())
        a, b = summed.numel(), summed.numel() + pairs.numel()
        host_sum = flat[:a].reshape(R, -1)
        host_pairs = flat[a:b].reshape(pairs.shape)
        dense = (flat[b:].reshape(R, N_EXP_BINS) if body.kernel
                 else host_sum[:, :N_EXP_BINS])
        return (dense, host_sum[:, -1], host_pairs[:, :, :cap],
                host_pairs[:, :, cap:2 * cap],
                int(host_pairs[:, :, -1].max()))


def _run_group(group: _Group, cap_box: list, mesh, n_proc, spans,
               counters):
    """A group's reduction with its capacity regrow: rerun the whole
    group at max(4 * capacity, max_nu) until no set was cut; the grown
    capacity sticks for later groups (cap_box)."""
    while True:
        out = group.run(cap_box[0], mesh, n_proc, spans, counters)
        if out[-1] <= cap_box[0]:
            return out
        # rare: some shard saw (or merged) more distinct (reuse, class)
        # pairs than slots — every rank sees the same gathered max_nu
        _count(counters, "capacity_regrows")
        cap_box[0] = max(cap_box[0] * 4, out[-1])


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


def _column_steps(keys, mask, shards, mesh, n_chunks: int, spans):
    """Split [R, W] keys and mask along the sample axis: shard i takes
    columns [i*W/n_dev, (i+1)*W/n_dev) on its own device (a view where
    the device is the buffers'), scanned in n_chunks column spans (views):
    {shard: [(keys, mask), ...]}."""
    n_dev = mesh.size
    w = keys.shape[1] // n_dev
    b = w // n_chunks
    out = {}
    with _span(spans, "shard_put", rows=int(keys.numel())):
        for i in shards:
            dev = mesh.devices[i]
            k = keys[:, i * w:(i + 1) * w].to(dev)
            m = mask[:, i * w:(i + 1) * w].to(dev)
            out[i] = [(k[:, s * b:(s + 1) * b], m[:, s * b:(s + 1) * b])
                      for s in range(n_chunks)]
    return out


def _rx_on(members_ri, devices) -> dict:
    """The members' ref indices as an int64 tensor on each device."""
    return {d: torch.tensor(members_ri, dtype=torch.int64, device=d)
            for d in devices}


def _devices(mesh: Mesh, shards) -> set:
    """The shards' devices as their tensors report them ("cuda" becomes
    "cuda:<current>"), the keys of _Body's and _rx_on's tables."""
    return {torch.empty(0, device=mesh.devices[i]).device for i in shards}


def sampled_outputs_sharded(
    program: Program,
    machine: MachineConfig,
    cfg: SamplerConfig | None = None,
    mesh: Mesh | None = None,
    batch: int | None = None,
    capacity: int = DEFAULT_CAPACITY,
    device=None,
    spans: dict | None = None,
    counters: dict | None = None,
):
    """Sharded sampled engine -> per-ref SampledRefResult (exact) plus
    the dense pow2 noshare histograms (per ref, for observability).

    Runs on `mesh`, by default every visible card, or one CPU device
    with device="cpu"; in the fused form where `_use_fused` holds on the
    mesh's devices in one process, else in the per-ref form (module
    docstring). `spans`, when given, gathers host seconds per stage:
    "draw" (the device draw ends in its host read of its counts),
    "shard_put" (padding and the copies to the shards), "dispatch_psum"
    (the shards' steps and merges and the mesh reduction, as enqueued),
    "gather_fetch" (the one copy back per reduction) and "merge" (into
    the host dicts). `counters`, when given, counts "dispatches" (mesh
    reductions, reruns included), "fetches" (read backs),
    "capacity_regrows", and in the fused form "dispatches_fused" and
    "ref_buckets", and sets "fuse_refs", "expected_chunks" and
    "refs_per_dispatch" (the JAX package's telemetry names)."""
    cfg = cfg or SamplerConfig()
    mesh = _resolve_mesh(mesh, device)
    backend = cfg.kernel_backend or "auto"  # validated by SamplerConfig
    for d in mesh.devices:
        check_native(backend, d)
    if backend == "native":  # the CPU's plain body, as the JAX
        backend = "torch"    # package's sharded engine ignores it
    if batch is None:
        batch = default_batch(mesh.devices[0])
    n_proc, pid = _process_grid(mesh)
    use_dev_draw = _device_draw_on_mesh(cfg, mesh, batch)
    trace, rows = _program_rows(program, machine)
    for nt in trace.nests:
        check_packed_ratios(nt)
    kernel = _kernel_route(backend, mesh)
    if _use_fused(cfg, mesh.devices[0]) and n_proc == 1:
        return _sampled_outputs_sharded_fused(
            trace, rows, cfg, mesh, batch, capacity, use_dev_draw, backend,
            kernel, spans, counters)
    n_dev = mesh.size
    shards = list(range(n_dev)) if n_proc == 1 else [pid]
    devices = _devices(mesh, shards)
    # every process draws on a device of its own (the same draw)
    draw_dev = mesh.devices[shards[0]]
    cap_box = [capacity]
    results = []
    dense_noshare = []
    for idx, (k, ri, _sig) in enumerate(rows):
        nt = trace.nests[k]
        seed = cfg.seed * 1000003 + idx
        ref_span = telemetry.span("ref", engine="sharded",
                                  ref=nt.tables.ref_names[ri])
        ref_span.__enter__()
        drawn = None
        if use_dev_draw:
            with _span(spans, "draw", where="device"):
                drawn = draw_sample_keys_device(nt, ri, cfg, seed, batch,
                                                draw_dev)
        if drawn is None:
            with _span(spans, "draw", where="host"):
                keys_all, highs = draw_sample_keys(nt, ri, cfg, seed=seed)
            n_samples = len(keys_all)
        else:
            keys_all, mask_all, n_samples, highs = drawn
        body = _Body(nt, ri, highs, devices, backend, kernel)
        rx = _rx_on([ri], devices)
        if drawn is None:
            groups = (_Group(body, steps, rx) for steps in
                      _host_chunks(keys_all, n_dev, batch, shards, mesh,
                                   spans))
        else:
            groups = [_Group(body, _column_steps(
                keys_all[None], mask_all[None], shards, mesh,
                keys_all.shape[0] // batch, spans), rx)]
        noshare: dict[int, float] = {}
        share: dict[int, dict[int, float]] = {}
        cold = 0.0
        dense = np.zeros(N_EXP_BINS, dtype=np.int64)
        for group in groups:
            nh, c, pk, pc, _ = _run_group(group, cap_box, mesh, n_proc,
                                          spans, counters)
            dense += nh[0]
            cold += float(c[0])
            with _span(spans, "merge"):
                for d in range(n_dev):
                    decode_pairs(pk[d, 0], pc[d, 0], noshare, share)
        ref_span.__exit__(None, None, None)
        results.append(
            SampledRefResult(
                name=nt.tables.ref_names[ri], noshare=noshare, share=share,
                cold=cold, n_samples=n_samples,
            )
        )
        dense_noshare.append(dense)
    return results, dense_noshare


def _host_chunks(keys_all, n_dev, batch, shards, mesh, spans):
    """The host draw's chunks: for each, {shard: [(keys [1, b], mask [1,
    b])]} on the shards' devices. A chunk is `step` keys padded so that
    it splits evenly (every chunk of a ref longer than one is padded to
    `step`); the mask marks the unpadded prefix."""
    step = max(n_dev, (batch // n_dev) * n_dev)
    n_samples = len(keys_all)
    for s0 in range(0, n_samples, step):
        # the padded chunk's length (pad_keys'), the JAX package's rows
        rows = (step if n_samples > step
                else max(16, -(-n_samples // n_dev)) * n_dev)
        with _span(spans, "shard_put", rows=rows):
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
                mask = base + torch.arange(local_b, device=dev) < n_valid
                parts[i] = [(keys[None], mask[None])]
        yield parts


def _sampled_outputs_sharded_fused(trace, rows, cfg, mesh, batch, capacity,
                                   use_dev_draw, backend, kernel, spans,
                                   counters):
    """Cross-ref fused form of sampled_outputs_sharded (one process):
    refs grouped into run_sampled's kernel-signature buckets, each
    group's stacked [R, B] buffers split over the shards along the sample
    axis, one mesh reduction and one read back per group, the capacity
    regrow per group (sticky for later groups). Same draw streams, same
    exact merges: results equal to the per-ref form's and run_sampled's.
    """
    n_dev = mesh.size
    shards = list(range(n_dev))
    devices = _devices(mesh, shards)
    noshare = [{} for _ in rows]
    share = [{} for _ in rows]
    cold = [0.0] * len(rows)
    dense = [np.zeros(N_EXP_BINS, dtype=np.int64) for _ in rows]
    n_samples_of = [0] * len(rows)
    cap_box = [capacity]
    n_buckets = max_bucket_dispatches = n_fused = n_refs_fused = 0

    def run(group, mem):
        nonlocal n_fused, n_refs_fused
        nh, c, pk, pc, _ = _run_group(group, cap_box, mesh, 1, spans,
                                      counters)
        _count(counters, "dispatches_fused")
        n_fused += 1
        n_refs_fused += len(mem)
        with _span(spans, "merge"):
            for j, idx in enumerate(mem):
                dense[idx] += nh[j]
                cold[idx] += float(c[j])
                for d in range(n_dev):
                    decode_pairs(pk[d, j], pc[d, j], noshare[idx],
                                 share[idx])

    step = max(n_dev, (batch // n_dev) * n_dev)
    for (k, _sig), members in _bucket_rows(trace, rows).items():
        nt = trace.nests[k]
        ri0 = members[0][1]
        highs, s = _sample_highs(nt, ri0, cfg)
        if s == 0:  # no drawable points (degenerate triangular ref)
            continue
        n_buckets += 1
        _count(counters, "ref_buckets", tele=False)
        bucket_dispatches = 0
        bspan = telemetry.span(
            "bucket", engine="sharded", nest=k,
            refs=",".join(nt.tables.ref_names[ri] for _, ri in members),
        )
        bspan.__enter__()
        body = _Body(nt, ri0, highs, devices, backend, kernel)
        host_members = members
        if use_dev_draw:
            with _span(spans, "draw", where="device"):
                drawn = draw_bucket_keys_device(
                    nt, [ri for _, ri in members], cfg,
                    [cfg.seed * 1000003 + idx for idx, _ in members],
                    batch, mesh.devices[0],
                )
            taken = {p for g in drawn for p in g.positions}
            host_members = [m for p, m in enumerate(members)
                            if p not in taken]
            # each group is one buffer size B: a run of the bucket's
            # [R, B] draw, or one member whose retry grew its buffer
            for g in drawn:
                mem = [members[p] for p in g.positions]
                for idx, _ri in mem:
                    n_samples_of[idx] = g.s
                steps = _column_steps(g.keys, g.chosen, shards, mesh,
                                      g.keys.shape[1] // batch, spans)
                run(_Group(body, steps, _rx_on([ri for _, ri in mem],
                                               devices), fused=True),
                    [idx for idx, _ in mem])
                bucket_dispatches += 1
            del drawn
        if host_members:
            with _span(spans, "draw", where="host"):
                keys_list = []
                for idx, ri in host_members:
                    ka, _hi = draw_sample_keys(
                        nt, ri, cfg, seed=cfg.seed * 1000003 + idx)
                    n_samples_of[idx] = len(ka)
                    keys_list.append(ka)
            g, n_groups = _host_fuse_plan(len(keys_list[0]), step)
            span_len = g * step
            rx = _rx_on([ri for _, ri in host_members], devices)
            mem = [idx for idx, _ in host_members]
            for gi in range(n_groups):
                lo = gi * span_len
                with _span(spans, "shard_put",
                           rows=len(keys_list) * span_len):
                    buf = np.empty((len(keys_list), span_len),
                                   dtype=np.int64)
                    msk = np.zeros((len(keys_list), span_len), dtype=bool)
                    for j, ka in enumerate(keys_list):
                        seg = ka[lo:lo + span_len]
                        buf[j, :len(seg)] = seg
                        buf[j, len(seg):] = ka[0]  # decodable padding
                        msk[j, :len(seg)] = True
                steps = _column_steps(torch.from_numpy(buf),
                                      torch.from_numpy(msk), shards, mesh,
                                      g, spans)
                run(_Group(body, steps, rx, fused=True), mem)
                bucket_dispatches += 1
        bspan.__exit__(None, None, None)
        max_bucket_dispatches = max(max_bucket_dispatches,
                                    bucket_dispatches)
    _gauge(counters, "fuse_refs", 1)
    telemetry.gauge("ref_buckets", n_buckets)
    _gauge(counters, "expected_chunks", max_bucket_dispatches)
    if n_fused:
        _gauge(counters, "refs_per_dispatch", n_refs_fused / n_fused)
    results = [
        SampledRefResult(
            name=trace.nests[k].tables.ref_names[ri], noshare=noshare[idx],
            share=share[idx], cold=cold[idx], n_samples=n_samples_of[idx],
        )
        for idx, (k, ri, _sig) in enumerate(rows)
    ]
    return results, dense


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
    sample sets, exact merges), in either form (cfg.fuse_refs).
    The per-ref results keep raw reuse values, so v2=True folds the
    runtime-v2 state. Keyword arguments go to sampled_outputs_sharded
    (device, batch, capacity, spans, counters)."""
    cfg = cfg or SamplerConfig()
    results, _ = sampled_outputs_sharded(program, machine, cfg, mesh, **kw)
    return fold_results(results, machine.thread_num, v2), results


def run_periodic_sharded(
    program: Program,
    machine: MachineConfig,
    mesh: Mesh | None = None,
    max_share: int = 64,
    device=None,
    spans: dict | None = None,
):
    """Periodic exact engine with each nest's merged windows split over
    the mesh: the windows of one kind (pair or final) are padded with
    repeats of the last one to a multiple of the shard count, shard i
    evaluates its contiguous block on its own device, and the padding's
    outputs are dropped. Outputs come back per window (the per-tid
    multiplicity scaling happens on the host, as in run_periodic), so
    there is no cross-device reduction and the result is the
    single-device engine's: every window is the same integer
    computation on whichever device runs it."""
    from ..sampler.periodic import _compiled_nest, run_periodic

    mesh = _resolve_mesh(mesh, device)
    n_dev = mesh.size

    def window_eval(prog, nest_index, nt, merged):
        _, kernels = _compiled_nest(prog, nest_index, machine, max_share)
        outs: dict = {}
        for pair in (True, False):
            items = [
                (key, v0) for key, v0 in merged.items()
                if (key[0] is not None) == pair
            ]
            if not items:
                continue
            padded = items + [items[-1]] * ((-len(items)) % n_dev)
            per = len(padded) // n_dev
            launched = []
            for i, dev in enumerate(mesh.devices):
                for key, v0 in padded[i * per:(i + 1) * per]:
                    v0b = v0 + (key[0] or 0)
                    launched.append(kernels[pair](v0, v0b, dev))
            with _span(spans, "gather_fetch"):
                got = [tuple(o.cpu().numpy() for o in out)
                       for out in launched]
            for (key, _v0), out in zip(items, got):
                outs[key] = out
        return outs

    return run_periodic(program, machine, max_share,
                        window_eval=window_eval, spans=spans)


def run_analytic_sharded(
    program: Program,
    machine: MachineConfig,
    mesh: Mesh | None = None,
    batch: int | None = None,
    seed: int = 0,
    host_cutoff: int | None = None,
    device=None,
    **kw,
):
    """Analytic exact engine with every classify chunk's keys split over
    the mesh (sampler/analytic.py::_classify_keys): equal slices, one
    launch per shard on its own device (kernel B1's raw form on CUDA),
    reassembled by position. Each key's closed-form solve is
    independent, so the fits, the folds and the state are the
    single-device engine's. Nests under the host-fold cutoff stay on
    the host lexsort (no device work exists to shard there); pass
    host_cutoff=0 to force the sharded path. Keyword arguments go to
    run_analytic (kernel_backend, spans, counters)."""
    from ..sampler.analytic import run_analytic

    mesh = _resolve_mesh(mesh, device)
    return run_analytic(program, machine, batch=batch, seed=seed,
                        mesh=mesh, host_cutoff=host_cutoff, **kw)


def run_exact_sharded(
    program: Program,
    machine: MachineConfig,
    mesh: Mesh | None = None,
    max_share: int = 64,
    device=None,
    spans: dict | None = None,
):
    """The exact router (periodic -> analytic -> dense) with whichever
    engine it picks running mesh-sharded; `res.engine` records the
    choice, the contract of sampler/periodic.py::run_exact."""
    from ..sampler.periodic import run_exact

    mesh = _resolve_mesh(mesh, device)
    return run_exact(program, machine, max_share, mesh=mesh, spans=spans)


def run_dense_sharded(
    program: Program,
    machine: MachineConfig,
    mesh: Mesh | None = None,
    max_share: int = 64,
    device=None,
    spans: dict | None = None,
):
    """Dense engine with the simulated threads split over the mesh:
    shard i sorts threads [i * P/n, (i+1) * P/n) on its own device.
    Requires thread_num % mesh size == 0 (each shard owns an equal
    slice of the threads). Returns sampler/dense.py::run_dense's
    OracleResult; the memory route does not apply."""
    from ..sampler.dense import run_dense

    mesh = _resolve_mesh(mesh, device)
    n_dev = mesh.size
    if machine.thread_num % n_dev != 0:
        raise ValueError(
            f"thread_num {machine.thread_num} not divisible by mesh size "
            f"{n_dev}; use build_mesh(n_devices=...) with a divisor"
        )
    per = machine.thread_num // n_dev
    tid_devices = [mesh.devices[tid // per]
                   for tid in range(machine.thread_num)]
    return run_dense(program, machine, max_share, tid_devices=tid_devices,
                     spans=spans)
