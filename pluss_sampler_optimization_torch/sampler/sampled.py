"""Random-start sampled engine — the r10 equivalent — on PyTorch.

Port of the JAX package's sampler/sampled.py along its fused
classify+histogram route (kernel_backend="pallas" with the host numpy
draw there): every tracked reference draws a dedup'd uniform sample
set with numpy (bit-identical to the JAX package's host stream), refs
sharing a kernel signature stack into one bucket dispatch, and each
dispatch runs the fused decode + classify + pow2 histogram
(ops/sampled_hist.py: the CUDA kernel on the card, its plain torch
version on the CPU). Share samples and sub-1 noshare samples come back
as exact (packed key, count) pairs through sorted_k_unique; the pow2
bins fold as {2^e: count}, which hist_update's binning leaves unchanged,
so the folded PRIState is bit-identical to every route of the JAX
package.

Each sample's reuse interval is the forward distance, in its simulated
thread's private access clock, to the next same-array touch of its
cache line, solved in closed form (sampler/nextuse.py); samples whose
line is never touched again flush as -1 (cold); share samples are
classified at the sink reference's carried threshold.

Not in this slice (each raises NotImplementedError naming its ROADMAP
item): triangular nests, runtime-v2 raw-noshare states, and the device
draw.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from ..config import MachineConfig, SamplerConfig
from ..core.trace import NestTrace, ProgramTrace
from ..ir import Program
from ..ops.histogram import SENTINEL, sorted_k_unique
from ..runtime.hist import PRIState
from .nextuse import INF

_RATIO_SLOTS = 16  # packed key = reuse * 16 + (ratio | noshare-slot 15)
_NOSHARE_SLOT = _RATIO_SLOTS - 1

# Samples per dispatch chunk on a CUDA device and on the CPU; a bucket
# dispatch stacks up to _FUSED_HOST_CHUNKS chunks per member ref.
DEFAULT_BATCH = 1 << 20
CPU_BATCH = 1 << 17
# Share-pair slots per dispatch; a dispatch that sees more distinct
# (reuse, class) pairs regrows the capacity 4x and reduces again.
DEFAULT_CAPACITY = 64
_FUSED_HOST_CHUNKS = 8


def resolve_device(device=None) -> torch.device:
    """The device a run uses: CUDA unless the caller asks for the CPU.
    Raises where CUDA is asked for (or implied) but absent — the port
    never carries on on the CPU by itself."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def default_batch(device: torch.device) -> int:
    return DEFAULT_BATCH if device.type == "cuda" else CPU_BATCH


@dataclasses.dataclass
class SampledRefResult:
    """Exact per-tracked-ref sampled histograms (host form)."""

    name: str
    noshare: dict  # raw reuse -> count (bin on insertion for v1 parity)
    share: dict  # ratio -> {raw reuse -> count}
    cold: float  # samples with no further touch (-1 multiplicity)
    n_samples: int


def _sample_plan(nest_trace: NestTrace, ref_idx: int, cfg: SamplerConfig):
    """(bounding-box highs, target sample count, |valid space|) for one
    tracked ref — the single source of truth for both draw paths.

    Triangular nests draw from the rectangular bounding box and reject
    points outside the per-v0 bounds (draw_sample_keys / draw.py); the
    target count generalizes the generated-code expression to
    ceil(ratio^depth * |valid drawable space|) — the same density over
    the space that actually exists (rectangular nests keep the exact
    `ceil(prod(ratio*trip))` form via cfg.num_samples, and their valid
    space IS the box).
    """
    lv = int(nest_trace.tables.ref_levels[ref_idx])
    excl = 1 if cfg.exclude_last_iteration else 0
    if nest_trace.tri and lv >= 1:
        import math

        lp0 = nest_trace.nest.loops[0]
        n0_hi = max(1, lp0.trip - excl)
        highs = [n0_hi] + [
            max(1, nest_trace.max_trips[l] - excl)
            for l in range(1, lv + 1)
        ]
        v0 = lp0.start + np.arange(n0_hi, dtype=np.int64) * lp0.step
        cnt = np.ones(len(v0), dtype=np.int64)
        for l in range(1, lv + 1):
            cnt *= np.maximum(
                0, nest_trace.nest.loops[l].trip_at(v0) - excl
            )
        space = int(cnt.sum())
        if space == 0:
            return highs, 0, 0
        s = max(1, min(
            int(math.ceil((cfg.ratio ** (lv + 1)) * space)), space
        ))
        return highs, s, space
    trips = [nest_trace.nest.loops[l].trip for l in range(lv + 1)]
    highs = [
        max(1, t - 1 if cfg.exclude_last_iteration else t) for t in trips
    ]
    space = 1
    for h in highs:
        space *= h
    return highs, cfg.num_samples(tuple(trips)), space


def _sample_highs(nest_trace: NestTrace, ref_idx: int, cfg: SamplerConfig):
    """(bounding-box highs, target sample count); see _sample_plan."""
    highs, s, _ = _sample_plan(nest_trace, ref_idx, cfg)
    return highs, s


def _tri_valid_keys(nest_trace: NestTrace, ref_idx: int, keys, highs, excl):
    """Filter bounding-box keys down to points inside the triangular
    bounds (n_l < trip_l(v0) - excl for every inner level)."""
    lv = int(nest_trace.tables.ref_levels[ref_idx])
    cols = decode_sample_keys(keys, highs)
    v0 = nest_trace.nest.loops[0].start + cols[:, 0] * (
        nest_trace.nest.loops[0].step
    )
    ok = np.ones(len(keys), dtype=bool)
    for l in range(1, lv + 1):
        ok &= cols[:, l] < (
            nest_trace.nest.loops[l].trip_at(v0) - excl
        )
    return keys[ok]


def draw_sample_keys(
    nest_trace: NestTrace, ref_idx: int, cfg: SamplerConfig, seed: int
):
    """Dedup'd uniform samples as mixed-radix keys, shape (S,) int64.

    A copy of the JAX package's host draw: the same numpy generator
    calls in the same order, so a seed gives the same sample set in
    both packages.
    """
    highs, s = _sample_highs(nest_trace, ref_idx, cfg)
    rng = np.random.default_rng(seed)
    tri = nest_trace.tri and int(nest_trace.tables.ref_levels[ref_idx]) >= 1
    excl = 1 if cfg.exclude_last_iteration else 0
    # Draw-until-s-unique, matching the reference's one-at-a-time
    # redraw loop's sample *set* semantics (r10 :159-185): accumulate
    # uniques, then thin to exactly s with an unbiased random subset.
    # Keys are drawn directly in the flat mixed-radix space — one
    # int64 uniform over prod(highs) IS the per-level composition.
    space = 1
    for h in highs:
        space *= h
    if space >= 1 << 63:
        raise NotImplementedError(
            f"ref {nest_trace.tables.ref_names[ref_idx]}: sample space "
            f"prod(highs)={space:.3e} exceeds int64 flat keys (2^63); "
            "the flat-space drawing needs a per-level fallback for "
            "nests this deep/wide"
        )
    uniq = np.empty(0, dtype=np.int64)
    while len(uniq) < s:
        need = s - len(uniq)
        batch_keys = rng.integers(0, space, size=max(64, need + need // 8))
        if tri:
            batch_keys = _tri_valid_keys(
                nest_trace, ref_idx, batch_keys, highs, excl
            )
        uniq = (
            np.unique(batch_keys) if len(uniq) == 0
            else np.union1d(uniq, batch_keys)
        )
    if len(uniq) > s:
        # thin by dropping a uniform (len-s)-subset: cheaper than a
        # permutation of the whole unique set near the target margin
        drop = rng.choice(len(uniq), size=len(uniq) - s, replace=False)
        keep = np.ones(len(uniq), dtype=bool)
        keep[drop] = False
        uniq = uniq[keep]
    return uniq, highs


def decode_sample_keys(keys, highs):
    """Mixed-radix keys -> normalized iteration tuples (len(keys), depth).

    Works on numpy arrays (host) and int64 tensors alike; highs may be
    padded with 1s (ops' _pad_highs), whose columns decode to 0."""
    cols = []
    for h in reversed([int(x) for x in highs]):
        keys, col = keys // h, keys % h
        cols.append(col)
    if isinstance(keys, torch.Tensor):
        return torch.stack(cols[::-1], dim=1).to(torch.int64)
    return np.stack(cols[::-1], axis=1).astype(np.int64)


def check_packed_ratios(nt: NestTrace) -> None:
    """Every share ratio must fit the packed-key radix."""
    t = nt.tables
    for j in range(t.n_refs):
        if int(t.ref_share_ratios[j]) >= _NOSHARE_SLOT:
            raise NotImplementedError(
                f"ref {t.ref_names[j]}: share ratio "
                f"{int(t.ref_share_ratios[j])} collides with the packed "
                f"noshare slot (must be < {_NOSHARE_SLOT})"
            )


def _sample_geometry(nt: NestTrace, ref_idx: int, samples, rx=None):
    """Sample tuples -> (tid, p0, line, m) in the thread-local trace.

    `rx` (default ref_idx) indexes the value overlay, so refs that
    differ only in offsets/affine constants (the read/write halves of
    `C[i][j] +=`) share one dispatch; ref_idx supplies the static
    structure (level, slot layout)."""
    if nt.tri:
        raise NotImplementedError(
            "triangular nests are not ported yet (ROADMAP A1)"
        )
    t = nt.tables
    sched = nt.schedule
    rx = ref_idx if rx is None else rx
    lv = int(t.ref_levels[ref_idx])
    n = [samples[:, l] for l in range(lv + 1)]
    tid = sched.owner_tid(n[0])
    m = sched.local_index(n[0])
    v0 = sched.value(n[0])
    vals = [v0] + [
        nt.start_at(l, v0) + n[l] * nt.nest.loops[l].step
        for l in range(1, lv + 1)
    ]
    p0 = nt.access_position(
        ref_idx, m, n[1] if lv >= 1 else 0, n[2] if lv >= 2 else 0,
        rx=rx,
    )
    flat = torch.zeros_like(p0) + nt.vals["const"][rx]
    for l in range(lv + 1):
        flat = flat + vals[l] * nt.vals["coeff"][rx][l]
    line = flat * nt.machine.ds // nt.machine.cls
    return tid, p0, line, m


def _sink_groups(nt: NestTrace, ref_idx: int) -> list:
    """Same-array sink refs partitioned by identical flat map
    ((level, coeffs, const) equality), in first-seen order.

    Single source of truth for _best_sink, _kernel_sig and the kernel
    descriptor (ops/sampled_hist.py::build_descriptor)."""
    t = nt.tables
    groups: dict[tuple, list[int]] = {}
    for j in range(t.n_refs):
        if t.ref_arrays[j] != t.ref_arrays[ref_idx]:
            continue
        key = (
            int(t.ref_levels[j]),
            tuple(int(c) for c in t.ref_coeffs[j]),
            int(t.ref_consts[j]),
        )
        groups.setdefault(key, []).append(j)
    return list(groups.values())


def _best_sink(nt: NestTrace, ref_idx: int, tid, p0, line):
    """Min next-use position over same-array sink refs + argmin sink.

    Sinks sharing one flat map are solved as a group: the band
    candidates and level specs are built once, each member pays only
    its own position reduction."""
    from .nextuse import next_use_candidates_group

    best = torch.full_like(p0, INF)
    best_sink = torch.zeros_like(p0)
    for sinks in _sink_groups(nt, ref_idx):
        bests = next_use_candidates_group(nt, tuple(sinks), tid, p0, line)
        for j in sinks:
            pj = bests[j]
            take = pj < best
            best = torch.where(take, pj, best)
            best_sink = torch.where(take, j, best_sink)
    return best, best_sink


def classify_samples(nt: NestTrace, ref_idx: int, samples, rx=None):
    """Per-sample reuse classification on int64 tensors.

    Returns (packed, ri, is_share, found): the packed
    reuse*_RATIO_SLOTS+slot key, the raw reuse interval, the share
    classification at the sink's carried threshold
    (...ri-omp-seq.cpp:203-207) and the found mask (False = the line is
    never touched again, the -1 flush case, r10 :671). `nt.vals` must
    hold tensors on the samples' device (ops/sampled_hist.torch_vals).
    """
    t = nt.tables
    tid, p0, line, _ = _sample_geometry(nt, ref_idx, samples, rx)
    best, best_sink = _best_sink(nt, ref_idx, tid, p0, line)
    found = best < INF
    ri = torch.where(found, best - p0, 0)
    thr = nt.vals["thr"][best_sink]
    ratio = torch.as_tensor(
        np.asarray(t.ref_share_ratios, dtype=np.int64), device=p0.device
    )[best_sink]
    is_share = found & (thr > 0) & (ri.abs() > (ri - thr).abs())
    slot = torch.where(is_share, ratio, _NOSHARE_SLOT)
    packed = ri * _RATIO_SLOTS + slot
    return packed, ri, is_share, found


def per_sample_ri(
    program: Program, machine: MachineConfig, nest_idx: int, ref_idx: int,
    samples: np.ndarray, device=None,
):
    """Debug/tracing surface: per-sample (position, reuse, sink, found,
    tid, line), as numpy arrays; reuse is -1 where not found."""
    from ..ops.sampled_hist import torch_vals

    dev = resolve_device(device)
    trace = ProgramTrace(program, machine)
    nt = trace.nests[nest_idx]
    nt = nt.with_vals(torch_vals(nt.vals, dev))
    samples = torch.as_tensor(np.asarray(samples, dtype=np.int64),
                              device=dev)
    tid, p0, line, _ = _sample_geometry(nt, ref_idx, samples)
    best, best_sink = _best_sink(nt, ref_idx, tid, p0, line)
    found = best < INF
    return (
        p0.cpu().numpy(),
        torch.where(found, best - p0, -1).cpu().numpy(),
        best_sink.cpu().numpy(),
        found.cpu().numpy(),
        tid.cpu().numpy(),
        line.cpu().numpy(),
    )


def decode_pairs(keys, counts, noshare: dict, share: dict) -> None:
    """Fold device (packed key, count) pairs into host sparse hists."""
    for key, cnt in zip(keys.tolist(), counts.tolist()):
        if cnt <= 0:
            continue
        ri_val, slot = divmod(int(key), _RATIO_SLOTS)
        if slot == _NOSHARE_SLOT:
            noshare[ri_val] = noshare.get(ri_val, 0.0) + cnt
        else:
            h = share.setdefault(slot, {})
            h[ri_val] = h.get(ri_val, 0.0) + cnt


def _pad_highs(highs) -> np.ndarray:
    """Mixed-radix highs padded to MAX_DEPTH with 1s: the padded
    divmods are no-ops (col 0), so one decode serves every ref depth."""
    from ..ir import MAX_DEPTH

    out = np.ones(MAX_DEPTH, dtype=np.int64)
    out[: len(highs)] = list(highs)
    return out


def _kernel_sig(nt: NestTrace, ref_idx: int) -> tuple:
    """Everything the classify reads as STRUCTURE, as a hashable key.
    Two (nest, ref) pairs with equal signatures share one bucket
    dispatch — their numeric differences (offsets, consts, thresholds)
    ride in per member through the value index rx. The same tuple as
    the JAX package's, so bucket digests agree between the packages.
    """
    from .nextuse import band_plan

    t = nt.tables
    m = nt.machine
    sched = nt.schedule
    W = m.lines_per_element_block
    plans = tuple(
        (tuple(sinks), band_plan(nt, sinks[0], W))
        for sinks in _sink_groups(nt, ref_idx)
    )
    return (
        (
            int(t.ref_levels[ref_idx]),
            int(t.ref_arrays[ref_idx]),
            ref_idx if nt.tri else None,
        ),
        nt.tri,
        int(t.depth),
        nt.npre,
        nt.npost,
        tuple(int(x) for x in t.ref_levels),
        tuple(int(x) for x in t.ref_arrays),
        tuple(int(x) for x in t.ref_share_ratios),
        tuple(r.slot for r in nt.nest.refs),
        tuple(int(x) for x in t.steps),
        tuple(int(x) for x in t.starts),
        tuple(int(x) for x in t.trip_coeffs),
        tuple(int(x) for x in t.start_coeffs),
        (m.thread_num, m.chunk_size, m.ds, m.cls),
        (sched.chunk, sched.threads, sched.start, sched.step),
        nt.tri_base.shape if nt.tri else None,
        plans,
    )


def _ref_sig_digest(nt: NestTrace, ref_idx: int) -> str:
    """Canonical digest of the ref's kernel signature — the cross-ref
    bucket id (refs of one nest sharing a digest stack into one
    dispatch)."""
    from ..service.fingerprint import structure_digest

    return structure_digest(_kernel_sig(nt, ref_idx))


def _program_rows(program: Program, machine: MachineConfig):
    """(trace, [(nest index, ref index, signature digest), ...])."""
    trace = ProgramTrace(program, machine)
    rows = []
    for k, nt in enumerate(trace.nests):
        if nt.tri:
            raise NotImplementedError(
                f"{program.name}: triangular nests are not ported yet "
                "(ROADMAP A1)"
            )
        for ri in range(nt.tables.n_refs):
            rows.append((k, ri, _ref_sig_digest(nt, ri)))
    return trace, rows


def _bucket_rows(trace: ProgramTrace, rows) -> "collections.OrderedDict":
    """Group rows into cross-ref buckets: (nest index, signature digest)
    -> [(row index, ref index), ...], ordered by first appearance.
    Per-ref seeds (cfg.seed * 1000003 + row index) and the result order
    are those of a per-ref loop."""
    buckets: "collections.OrderedDict" = collections.OrderedDict()
    for idx, (k, ri, sig) in enumerate(rows):
        buckets.setdefault((k, sig), []).append((idx, ri))
    return buckets


def _host_fuse_plan(s: int, batch: int) -> tuple[int, int]:
    """(chunks per bucket dispatch, dispatch count) for a ref with s
    drawn samples: the chunk group grows geometrically (1, 2, 4, ...,
    capped at _FUSED_HOST_CHUNKS)."""
    n_chunks = -(-s // batch)
    g = 1
    while g < n_chunks and g < _FUSED_HOST_CHUNKS:
        g *= 2
    return g, -(-n_chunks // g)


def bucket_dispatch(nt, ref_idx, keys_RB, mask_RB, highs, rx_R,
                    capacity: int, backend: str = "auto", desc=None):
    """One bucket dispatch: the fused kernel, then the exact pair
    reduction of its residual stream per member. Returns
    (share_keys[R,cap], share_counts[R,cap], n_unique[R], cold[R],
    noshare_hist[R,64]) and a `reduce(capacity)` that redoes only the
    pair reduction (the kernel's outputs do not depend on capacity).
    `mask_RB` None means every lane is live. `desc` is the kernel's
    descriptor tensor, built once per bucket."""
    from ..ops.sampled_hist import sampled_hist

    residual, hist, cold = sampled_hist(
        nt, ref_idx, keys_RB, mask_RB, highs, rx_R, backend, desc
    )

    def reduce(cap):
        outs = [
            sorted_k_unique(residual[j], residual[j] != SENTINEL, cap)
            for j in range(residual.shape[0])
        ]
        return tuple(torch.stack([o[i] for o in outs]) for i in range(3))

    return (*reduce(capacity), cold, hist), reduce


@contextlib.contextmanager
def _span(spans: dict | None, name: str):
    """Add the host seconds of the block to spans[name] (no-op on None)."""
    if spans is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0


class Dispatch(NamedTuple):
    """One fused bucket dispatch of a run, as sampled_outputs launches it."""

    nt: NestTrace
    ref_idx: int  # the bucket's first member; all share its signature
    members: list  # [(row index, ref index), ...]
    n_samples: list  # samples drawn per member
    keys_RB: torch.Tensor  # int64 [R, B] on the run's device
    highs: np.ndarray  # padded to MAX_DEPTH
    rx_R: torch.Tensor  # int64 [R]: each member's ref index
    desc: torch.Tensor | None  # the kernel's descriptor (kernel routes)


def plan_dispatches(trace: ProgramTrace, rows, cfg: SamplerConfig,
                    dev: torch.device, batch: int, backend: str,
                    spans: dict | None = None):
    """Yield every bucket dispatch of a run, in order. Each bucket's
    members draw their whole streams (seeds cfg.seed * 1000003 + row
    index) before its first dispatch; a dispatch stacks one chunk group
    of every member along a leading ref axis. The last group is cut
    short, never padded, so every lane of a dispatch is live. `spans`
    gathers the host seconds of the draw ("draw") and of stacking and
    copying keys to the device ("stage")."""
    from ..ops.sampled_hist import descriptor_tensor

    for (k, _sig), members in _bucket_rows(trace, rows).items():
        nt = trace.nests[k]
        ri0 = members[0][1]
        highs, _ = _sample_highs(nt, ri0, cfg)
        with _span(spans, "draw"):
            keys_list = [
                draw_sample_keys(nt, ri, cfg, seed=cfg.seed * 1000003 + idx)[0]
                for idx, ri in members
            ]
        n_samples = [len(ka) for ka in keys_list]
        g, n_groups = _host_fuse_plan(n_samples[0], batch)
        span_len = g * batch
        ph = _pad_highs(highs)
        rx_R = torch.tensor([ri for _, ri in members], dtype=torch.int64,
                            device=dev)
        desc = None
        if dev.type == "cuda" and backend != "torch":
            desc = descriptor_tensor(nt, ri0, dev)
        for gi in range(n_groups):
            lo = gi * span_len
            with _span(spans, "stage"):
                keys_RB = torch.from_numpy(
                    np.stack([ka[lo:lo + span_len] for ka in keys_list])
                ).to(dev)
            yield Dispatch(nt, ri0, members, n_samples, keys_RB, ph, rx_R,
                           desc)


def sampled_outputs(
    program: Program,
    machine: MachineConfig,
    cfg: SamplerConfig,
    device=None,
    batch: int | None = None,
    capacity: int = DEFAULT_CAPACITY,
    raw_noshare: bool = False,
    spans: dict | None = None,
) -> list[SampledRefResult]:
    """Run the sampled engine; one SampledRefResult per reference.

    Refs sharing a kernel-signature bucket classify together, one fused
    dispatch per chunk group (plan_dispatches). Each dispatch is drained
    before the next: a member that saw more distinct (reuse, class)
    pairs than `capacity` regrows it 4x for the whole bucket (sticky for
    later dispatches) and reduces again. `spans`, when given, gathers
    host seconds per stage: "draw", "stage", "dispatch" (kernel, pair
    reduction and the copy back) and "decode" (into the host dicts)."""
    if raw_noshare:
        raise NotImplementedError(
            "runtime-v2 raw-noshare states are not ported yet (ROADMAP A2)"
        )
    if cfg.device_draw:
        raise NotImplementedError(
            "the device draw is not ported yet (ROADMAP A3); "
            "device_draw=None/False takes the host numpy draw"
        )
    dev = resolve_device(device)
    backend = cfg.kernel_backend or "auto"  # validated by SamplerConfig
    if batch is None:
        batch = default_batch(dev)
    trace, rows = _program_rows(program, machine)
    results = [
        SampledRefResult(name=trace.nests[k].tables.ref_names[ri],
                         noshare={}, share={}, cold=0.0, n_samples=0)
        for k, ri, _sig in rows
    ]
    cap = capacity
    for d in plan_dispatches(trace, rows, cfg, dev, batch, backend, spans):
        with _span(spans, "dispatch"):
            out, reduce = bucket_dispatch(
                d.nt, d.ref_idx, d.keys_RB, None, d.highs, d.rx_R, cap,
                backend, d.desc,
            )
            mk, mc, max_nu, cold, nh = (x.cpu().numpy() for x in out)
            dispatch_cap = cap
            while int(max_nu.max()) > dispatch_cap:
                # rare: some member saw more distinct (reuse, class)
                # pairs than slots — regrow once for the whole bucket
                dispatch_cap = max(dispatch_cap * 4, int(max_nu.max()))
                cap = max(cap, dispatch_cap)
                mk, mc, max_nu = (x.cpu().numpy()
                                  for x in reduce(dispatch_cap))
        with _span(spans, "decode"):
            for j, ((idx, _ri), n) in enumerate(zip(d.members, d.n_samples)):
                res = results[idx]
                res.n_samples = n
                res.cold += float(cold[j])
                decode_pairs(mk[j], mc[j], res.noshare, res.share)
                # {2^e: count}: hist_update's pow2_floor(2^e) is 2^e,
                # so the fold is bit-identical to raw keys
                ns = res.noshare
                for e in np.nonzero(nh[j])[0]:
                    key = 1 << int(e)
                    ns[key] = ns.get(key, 0.0) + float(nh[j][e])
    return results


def fold_results(
    results: list[SampledRefResult], thread_num: int, v2: bool = False
) -> PRIState:
    """Per-ref sampled results -> PRIState in runtime-v1 form (noshare
    pow2-binned on insertion, share raw), all counts attributed to
    simulated thread 0 — the distribute/print stages only ever consume
    thread-merged histograms (pluss_utils.h:1013-1022, :1042-1058).
    v2=True keeps noshare keys raw (pluss_utils_v2.h:915-918)."""
    from ..runtime.hist import hist_update

    state = PRIState(thread_num, bin_noshare=not v2)
    for r in results:
        for ri_val, cnt in r.noshare.items():
            state.update_noshare(0, ri_val, cnt)
        if r.cold:
            hist_update(state.noshare[0], -1, r.cold, in_log_format=False)
        for ratio, h in r.share.items():
            for ri_val, cnt in h.items():
                state.update_share(0, int(ratio), ri_val, cnt)
    return state


def run_sampled(
    program: Program,
    machine: MachineConfig,
    cfg: SamplerConfig | None = None,
    v2: bool = False,
    device=None,
    spans: dict | None = None,
    **kw,
) -> tuple[PRIState, list[SampledRefResult]]:
    """Sampled engine -> (PRIState, per-ref results). Runs on CUDA
    unless `device="cpu"`; raises where CUDA is absent and the CPU was
    not asked for. `spans` gathers host seconds per stage
    (sampled_outputs' stages and "fold")."""
    cfg = cfg or SamplerConfig()
    results = sampled_outputs(
        program, machine, cfg, device=device, raw_noshare=v2, spans=spans,
        **kw
    )
    with _span(spans, "fold"):
        state = fold_results(results, machine.thread_num, v2)
    return state, results
