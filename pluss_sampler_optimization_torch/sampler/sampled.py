"""Random-start sampled engine — the r10 equivalent — on PyTorch.

Port of the JAX package's sampler/sampled.py along its fused
classify+histogram route (kernel_backend="pallas" there): every tracked
reference draws a dedup'd uniform sample set, refs sharing a kernel
signature stack into one bucket dispatch, and each dispatch runs the
fused decode + classify + pow2 histogram (ops/sampled_hist.py: the CUDA
kernel on the card, its plain torch version on the CPU).

The draw is the JAX package's, chosen as there by
SamplerConfig.device_draw (None: auto, the device draw on a CUDA device
and the host draw on the CPU, as the JAX package's auto picks the device
draw on every backend but the CPU):

- the device draw (sampler/draw.py, threefry on kernel B3): a bucket's
  members draw one [R, B] buffer of sorted candidate keys and the
  `chosen` mask of exactly s of them, on the device; the bucket
  dispatches it in column spans of at most _FUSED_HOST_CHUNKS batches
  (views of the buffer and the mask). A member the device draw declines
  (a box past 2^46 or a buffer past 2^28 slots) joins the host stream;
- the host draw (`draw_sample_keys`, numpy, bit-identical to the JAX
  package's host stream): keys copied to the device in chunk groups,
  every lane live.

Share samples and sub-1 noshare samples come back
as exact (packed key, count) pairs through sorted_k_unique; the pow2
bins fold as {2^e: count}, which hist_update's binning leaves unchanged,
so the folded PRIState is bit-identical to every route of the JAX
package. The raw route (raw_noshare=True: runtime v2 and the r10
distribute) runs the kernel's raw-noshare form, which bins nothing, so
every noshare reuse comes back as an exact pair too: its per-ref results
are the JAX package's xla results.

Two runners share one drain (sampled_outputs): the bucket runner
(cfg.fuse_refs, auto on CUDA) and the serial per-ref runner (auto on the
CPU), with depth-bounded pipelining of the copies back
(cfg.pipeline_depth) and per-ref checkpoints (checkpoint_dir).
`kernel_backend="native"` (the CPU only) takes the JAX package's native
route: the serial per-ref runner, each chunk classified by the plain
raw-noshare form and reduced by the native library's one C++ pass
(native/classify_reduce). run_sampled_progressive classifies the host
draw's sample sets in rounds of growing prefixes through the
raw-noshare form, with a bootstrap MRC band between rounds
(sampler/confidence.py) and an early stop at cfg.tolerance.

Every runner writes the JAX package's spans, counters and gauges into
the active telemetry run (runtime/telemetry.py), at its call sites, with
its names and attributes: "engine" > "ref" (serial) or "bucket" (fused)
> "draw", "dispatch", "fetch", "merge"; the callers' `spans=` and
`counters=` dicts are filled by the same blocks (_span, _count,
_gauge).

Each sample's reuse interval is the forward distance, in its simulated
thread's private access clock, to the next same-array touch of its
cache line, solved in closed form (sampler/nextuse.py); samples whose
line is never touched again flush as -1 (cold); share samples are
classified at the sink reference's carried threshold.

Triangular nests (inner bounds affine in the parallel value) take the
per-thread base table for positions (core/trace.py::tri_position) and
nextuse.py's triangular solver; the closed form needs unit steps there,
and a triangular nest with another step raises NotImplementedError, as
in the JAX package (the dense and stream engines run it).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ..config import MachineConfig, SamplerConfig
from ..core.trace import NestTrace, ProgramTrace
from ..ir import Program
from ..ops.histogram import SENTINEL, sorted_k_unique
from ..runtime import telemetry
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


def _use_device_draw(cfg: SamplerConfig, device) -> bool:
    """Resolve cfg.device_draw (None = auto): the device draw on a CUDA
    device, the host numpy draw on the CPU — the JAX package's auto,
    which picks the device draw on every backend but the CPU."""
    if cfg.device_draw is None:
        return torch.device(device).type == "cuda"
    return bool(cfg.device_draw)


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
    if nt.tri:
        base = nt.vals["tri_base"][tid, m]
        p0 = nt.tri_position(
            ref_idx, v0, base, n[1] if lv >= 1 else 0,
            n[2] if lv >= 2 else 0,
        )
    else:
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


def _best_sink(nt: NestTrace, ref_idx: int, tid, p0, line, m0):
    """Min next-use position over same-array sink refs + argmin sink.

    Sinks sharing one flat map are solved as a group: the band
    candidates and level specs are built once, each member pays only
    its own position reduction. `m0` (each sample's thread-local
    parallel index) is read by the triangular solver only."""
    from .nextuse import (
        next_use_candidates_group,
        next_use_candidates_tri_group,
    )

    best = torch.full_like(p0, INF)
    best_sink = torch.zeros_like(p0)
    for sinks in _sink_groups(nt, ref_idx):
        if nt.tri:
            bests = next_use_candidates_tri_group(
                nt, tuple(sinks), tid, p0, line, m0
            )
        else:
            bests = next_use_candidates_group(
                nt, tuple(sinks), tid, p0, line
            )
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
    tid, p0, line, m0 = _sample_geometry(nt, ref_idx, samples, rx)
    best, best_sink = _best_sink(nt, ref_idx, tid, p0, line, m0)
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
    tid, p0, line, m0 = _sample_geometry(nt, ref_idx, samples)
    best, best_sink = _best_sink(nt, ref_idx, tid, p0, line, m0)
    found = best < INF
    return (
        p0.cpu().numpy(),
        torch.where(found, best - p0, -1).cpu().numpy(),
        best_sink.cpu().numpy(),
        found.cpu().numpy(),
        tid.cpu().numpy(),
        line.cpu().numpy(),
    )


def pad_keys(
    keys: np.ndarray, n_dev: int, min_per_dev: int = 16,
    total: int | None = None,
):
    """Pad sample keys with repeats of key 0 so each of n_dev equal
    shards gets at least min_per_dev entries (or exactly total/n_dev
    when `total` is given, to keep one compiled shape across batch
    chunks). Returns (padded keys, valid count); the kernels
    reconstruct the padding weight mask from the count on device."""
    s = len(keys)
    if s == 0:
        raise ValueError("pad_keys needs at least one sample key")
    if total is None:
        per_dev = max(min_per_dev, -(-s // n_dev))
        total = per_dev * n_dev
    assert total % n_dev == 0 and total >= s
    out = np.full(total, keys[0], dtype=np.int64)
    out[:s] = keys
    return out, s


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
    """(trace, [(nest index, ref index, signature digest), ...]).
    Raises NotImplementedError for a triangular nest with a non-unit
    step, which the closed-form next-use does not cover (the JAX
    package's gate)."""
    trace = ProgramTrace(program, machine)
    rows = []
    for k, nt in enumerate(trace.nests):
        if nt.tri and any(lp.step != 1 for lp in nt.nest.loops):
            raise NotImplementedError(
                f"{program.name}: the closed-form next-use supports "
                "triangular nests with unit steps only; use the dense "
                "or stream engine"
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
                    capacity: int, backend: str = "auto", desc=None,
                    tri_base=None, raw: bool = False, desc_dev=None):
    """One bucket dispatch: the fused kernel, then the exact pair
    reduction of its residual stream per member. Returns
    (share_keys[R,cap], share_counts[R,cap], n_unique[R], cold[R],
    noshare_hist[R,64]) and a `reduce(capacity)` that redoes only the
    pair reduction (the kernel's outputs do not depend on capacity).
    `mask_RB` None means every lane is live. `desc` is the kernel's
    descriptor (ops/sampled_hist.py::build_descriptor), `desc_dev` its
    buffer-form copy on the device (`device_descriptor`, None where the
    parameter form carries it) and `tri_base` a triangular nest's base
    table on the device (`tri_table`), all made once per bucket. `raw`
    takes the kernel's raw-noshare form: every found sample comes back
    as a pair and the histogram is empty."""
    from ..ops.sampled_hist import sampled_hist

    residual, hist, cold = sampled_hist(
        nt, ref_idx, keys_RB, mask_RB, highs, rx_R, backend, desc, tri_base,
        raw, desc_dev,
    )

    def reduce(cap):
        outs = [
            sorted_k_unique(residual[j], residual[j] != SENTINEL, cap)
            for j in range(residual.shape[0])
        ]
        return tuple(torch.stack([o[i] for o in outs]) for i in range(3))

    return (*reduce(capacity), cold, hist), reduce


_SAME = object()


@contextlib.contextmanager
def _span(spans: dict | None, name: str, tele=_SAME, **attrs):
    """One block, timed into both views: the active telemetry run's span
    `tele` (default `name`; None opens none) with `attrs`, the JAX
    package's name and attributes at this site, and the host seconds
    into spans[name] (no-op on None). With spans given, the block is
    also a profiler range "sampled: <name>", so a trace can lay the
    spans beside the device's work. Yields the telemetry span (its
    `block(value)` records device-sync time under device_sync)."""
    tname = name if tele is _SAME else tele
    tspan = (telemetry.span(tname, **attrs) if tname is not None
             else telemetry._NULL_SPAN)
    with tspan as tsp:
        if spans is None:
            yield tsp
            return
        t0 = time.perf_counter()
        try:
            with record_function(f"sampled: {name}"):
                yield tsp
        finally:
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0


def _count(counters: dict | None, name: str, n=1, tele: bool = True) -> None:
    """Add n to counters[name] (no-op on None) and, with `tele`, to the
    active telemetry run's counter of that name."""
    if counters is not None:
        counters[name] = counters.get(name, 0) + n
    if tele:
        telemetry.count(name, n)


def _gauge(counters: dict | None, name: str, value, tele: bool = True) -> None:
    """Set counters[name] (no-op on None) and, with `tele`, the active
    telemetry run's gauge of that name."""
    if counters is not None:
        counters[name] = value
    if tele:
        telemetry.gauge(name, value)


class Dispatch(NamedTuple):
    """One fused bucket dispatch of a run, as sampled_outputs launches it."""

    nt: NestTrace
    ref_idx: int  # the bucket's first member; all share its signature
    members: list  # [(row index, ref index), ...]
    n_samples: list  # samples drawn per member
    keys_RB: torch.Tensor  # int64 [R, B] on the run's device
    # bool [R, B]: the device draw's chosen lanes (keys_RB and mask_RB
    # are then column spans of the drawn buffers); None: every lane live
    mask_RB: torch.Tensor | None
    highs: np.ndarray  # padded to MAX_DEPTH
    rx_R: torch.Tensor  # int64 [R]: each member's ref index
    desc: np.ndarray | None  # the kernel's descriptor (kernel routes)
    # a triangular nest's base table on the device (kernel routes)
    tri_base: torch.Tensor | None = None
    final: bool = True  # the members' last dispatch
    # the descriptor's buffer-form copy on the device (kernel routes with
    # a descriptor past the parameter form's words)
    desc_dev: torch.Tensor | None = None


class _PinnedStage:
    """Host-drawn keys to the device through reused pinned buffers. A
    buffer is refilled only once the event recorded behind its last
    copy has passed, so the copy is asynchronous and the host's next
    numpy draw overlaps the device's work. On the CPU the keys are
    simply stacked."""

    def __init__(self, dev: torch.device, n_buffers: int):
        self.dev, self.n = dev, n_buffers
        self.slots: list = []  # [(pinned flat buffer, event)]
        self.i = 0

    def __call__(self, rows: list) -> torch.Tensor:
        if self.dev.type != "cuda":
            return torch.from_numpy(np.stack(rows))
        shape = (len(rows), len(rows[0]))
        n = shape[0] * shape[1]
        k, self.i = self.i % self.n, self.i + 1
        buf = None
        if k < len(self.slots):
            buf, ev = self.slots[k]
            ev.synchronize()
            if buf.numel() < n:
                buf = None
        if buf is None:
            buf = torch.empty(n, dtype=torch.int64, pin_memory=True)
        host = buf[:n].view(shape)
        np.stack(rows, out=host.numpy())
        out = torch.empty(shape, dtype=torch.int64, device=self.dev)
        out.copy_(host, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.dev))
        if k < len(self.slots):
            self.slots[k] = (buf, ev)
        else:
            self.slots.append((buf, ev))
        return out


def plan_dispatches(trace: ProgramTrace, rows, cfg: SamplerConfig,
                    dev: torch.device, batch: int, backend: str,
                    spans: dict | None = None, buckets=None,
                    skip=frozenset(), counters: dict | None = None,
                    serial: bool = False):
    """Yield every bucket dispatch of a run, in order. Each bucket's
    members draw their whole sample sets (seeds cfg.seed * 1000003 + row
    index) before its first dispatch; a dispatch stacks one span of
    every member along a leading ref axis.

    `buckets` (default `_bucket_rows`: the kernel-signature buckets) maps
    a key (nest index first) to its members [(row index, ref index)];
    the serial runner passes one bucket per row. Rows in `skip` (already
    checkpointed) are masked out of their bucket before it draws: every
    member's drawn row equals its per-ref draw, so the others' sample
    sets do not change.

    Device-drawn members (see the module docstring) come in groups of
    one buffer size B (draw.BucketDraw: consecutive members of the
    bucket's [R, B] draw, or one member whose retry grew its buffer),
    and each group dispatches its buffer in column spans of at most
    _FUSED_HOST_CHUNKS * batch lanes with the chosen mask. Host-drawn
    members dispatch chunk groups of their key streams, staged through
    cfg.pipeline_depth + 1 pinned buffers (_PinnedStage); the last group
    is cut short, never padded, so every lane is live. A dispatch's
    `final` marks its members' last. `spans` gathers the host seconds of
    the draw ("draw", which ends in the device draw's host read of its
    counts) and of stacking and copying host keys to the device
    ("stage"); `counters` counts "ref_buckets", the buckets that draw,
    and sets "expected_chunks", the most dispatches any bucket planned.

    Each bucket's draws and dispatches, and what the consumer does
    before it asks for the next bucket's first, lie inside the bucket's
    telemetry span: "bucket" (engine, nest, refs), or with `serial` (one
    bucket per row) the JAX serial runner's "ref" (engine, ref)."""
    if buckets is None:
        buckets = _bucket_rows(trace, rows)
    stage = _PinnedStage(dev, max(1, cfg.pipeline_depth) + 1)
    use_dev = _use_device_draw(cfg, dev)
    most = 0
    for key, members_all in buckets.items():
        members = [m for m in members_all if m[0] not in skip]
        if not members:
            continue
        nt = trace.nests[key[0]]
        ri0 = members[0][1]
        highs, s = _sample_highs(nt, ri0, cfg)
        if s == 0:  # no drawable points (degenerate triangular ref)
            continue
        _count(counters, "ref_buckets", tele=False)
        names = [nt.tables.ref_names[ri] for _, ri in members]
        span = (telemetry.span("ref", engine="sampled", ref=names[0])
                if serial else
                telemetry.span("bucket", engine="sampled", nest=key[0],
                               refs=",".join(names)))
        with span:
            n = yield from _bucket_dispatches(
                nt, ri0, members, highs, cfg, dev, batch, backend, spans,
                stage, use_dev)
        most = max(most, n)
        _gauge(counters, "expected_chunks", most, tele=False)


def _bucket_dispatches(nt, ri0, members, highs, cfg, dev, batch, backend,
                       spans, stage, use_dev):
    """plan_dispatches' body for one bucket: yields its dispatches and
    returns their count."""
    from ..ops.sampled_hist import (
        build_descriptor,
        device_descriptor,
        tri_table,
    )
    from .draw import draw_bucket_keys_device

    n = 0
    ph = _pad_highs(highs)
    desc = tri = desc_dev = None
    if dev.type == "cuda" and backend != "torch":
        desc, tri = build_descriptor(nt, ri0), tri_table(nt, dev)
        desc_dev = device_descriptor(desc, dev)

    def rx(mem):
        return torch.tensor([ri for _, ri in mem], dtype=torch.int64,
                            device=dev)

    host_members = members
    if use_dev:
        with _span(spans, "draw", where="device"):
            groups = draw_bucket_keys_device(
                nt, [ri for _, ri in members], cfg,
                [cfg.seed * 1000003 + idx for idx, _ in members],
                batch, dev,
            )
        drawn = {p for g in groups for p in g.positions}
        host_members = [m for p, m in enumerate(members)
                        if p not in drawn]
        # each group is one buffer size B: a run of the bucket's
        # [R, B] draw, or one member whose retry grew its buffer
        for g in groups:
            mem = [members[p] for p in g.positions]
            B = g.keys.shape[1]
            span_len = min(B, _FUSED_HOST_CHUNKS * batch)
            rx_R = rx(mem)
            for lo in range(0, B, span_len):
                n += 1
                yield Dispatch(nt, ri0, mem, [g.s] * len(mem),
                               g.keys[:, lo:lo + span_len],
                               g.chosen[:, lo:lo + span_len], ph, rx_R,
                               desc, tri, lo + span_len >= B, desc_dev)
    if not host_members:
        return n
    with _span(spans, "draw", where="host"):
        keys_list = [
            draw_sample_keys(nt, ri, cfg, seed=cfg.seed * 1000003 + idx)[0]
            for idx, ri in host_members
        ]
    n_samples = [len(ka) for ka in keys_list]
    g, n_groups = _host_fuse_plan(n_samples[0], batch)
    span_len = g * batch
    rx_R = rx(host_members)
    for gi in range(n_groups):
        lo = gi * span_len
        with _span(spans, "stage", tele=None):
            keys_RB = stage([ka[lo:lo + span_len] for ka in keys_list])
        n += 1
        yield Dispatch(nt, ri0, host_members, n_samples, keys_RB, None,
                       ph, rx_R, desc, tri, gi == n_groups - 1, desc_dev)
    return n


def _use_fused(cfg: SamplerConfig, device) -> bool:
    """Resolve cfg.fuse_refs (None = auto, as the JAX package's
    _use_fused): the bucket runner on a CUDA device, where every dispatch
    pays a launch and a copy back worth amortizing; the serial per-ref
    runner on the CPU."""
    if cfg.fuse_refs is None:
        return torch.device(device).type == "cuda"
    return bool(cfg.fuse_refs)


# Bump whenever the engine's RESULT semantics change (packing, share
# thresholds, histogram encoding, seeded sample stream, ...): the
# version is folded into every checkpoint tag, so stale files from an
# older engine are recomputed instead of silently reused — the tag
# otherwise only captures inputs. The JAX package's schema, and its
# history: v3 flat-space key drawing, v4 the device draw, v5 the 2^46
# device-draw bias cap, v6 geometric draw-buffer bucketing.
_CHECKPOINT_SCHEMA = 6


def _checkpoint_tagger(program, machine, cfg, batch, device,
                       raw: bool = False):
    """(idx, name) -> checkpoint tag; the program-structure hash (loops,
    refs, thresholds) is computed once per run. The device draw's sample
    stream depends on the buffer bucketing, so the batch joins the tag on
    that path; the host numpy stream is batch-independent.

    A default run's tag is the JAX package's byte for byte, so a
    checkpoint directory the JAX package wrote resumes here. A raw run
    (`raw`: runtime v2 or the r10 distribute) gets a "|raw" suffix. The
    binned route keeps noshare reuse >= 1 as pow2 bins {2^e: count} in
    its per-ref results, the raw route keeps it exact; both fold to the
    same v1 state, but a v2 state and the r10 distribute read the raw
    keys, so a raw run must never load a binned file, and a binned run
    never loads a raw one (the JAX package needs no such rule: its
    default route keeps raw keys)."""
    import hashlib

    struct = hashlib.sha256(repr(program).encode()).hexdigest()[:16]
    dev = _use_device_draw(cfg, device)
    prefix = (
        f"v{_CHECKPOINT_SCHEMA}|{program.name}/{struct}|{machine.thread_num},"
        f"{machine.chunk_size},{machine.ds},{machine.cls}|{cfg.ratio},"
        f"{cfg.seed},{cfg.exclude_last_iteration},{dev}"
        + (f",b{batch}" if dev else "")
    )
    suffix = "|raw" if raw else ""
    return lambda idx, name: f"{prefix}|{idx}|{name}{suffix}"


def _checkpoint_path(checkpoint_dir: str, idx: int) -> str:
    import os

    return os.path.join(checkpoint_dir, f"ref_{idx:03d}.json")


def _checkpoint_load(path: str, tag: str):
    import json
    import os

    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            d = json.load(f)
        if d.get("tag") != tag:
            return None
        return SampledRefResult(
            name=d["name"],
            noshare={int(k): v for k, v in d["noshare"].items()},
            share={
                int(r): {int(k): v for k, v in h.items()}
                for r, h in d["share"].items()
            },
            cold=d["cold"],
            n_samples=d["n_samples"],
        )
    except Exception:
        return None  # unreadable/foreign/odd-shaped file: recompute


def _checkpoint_store(path: str, tag: str, r: SampledRefResult) -> None:
    import json
    import os

    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({
            "tag": tag, "name": r.name, "noshare": r.noshare,
            "share": r.share, "cold": r.cold, "n_samples": r.n_samples,
        }, f)
    os.replace(tmp, path)


def sampled_outputs(
    program: Program,
    machine: MachineConfig,
    cfg: SamplerConfig,
    device=None,
    batch: int | None = None,
    capacity: int = DEFAULT_CAPACITY,
    raw_noshare: bool = False,
    spans: dict | None = None,
    checkpoint_dir: str | None = None,
    counters: dict | None = None,
) -> list[SampledRefResult]:
    """Run the sampled engine; one SampledRefResult per reference.

    cfg.fuse_refs (auto: on for CUDA) routes through the bucket runner:
    refs sharing a kernel-signature bucket classify together, one fused
    dispatch per span (plan_dispatches). Off, the serial runner takes
    one ref at a time in row order, with its per-ref draw, R = 1. Both
    give equal results, field for field, and share one drain: each
    dispatch's small outputs start copying to the host as it is
    launched, and the host decodes the oldest, in dispatch order, only
    when cfg.pipeline_depth dispatches are in flight or at the end. A
    member that saw more distinct (reuse, class) pairs than `capacity`
    regrows it 4x for the whole dispatch (sticky for later launches)
    and reduces again.

    `raw_noshare` (runtime v2, the r10 distribute) launches the
    kernel's raw-noshare form: every noshare reuse comes back as an
    exact key, as the JAX package's xla kernels give it. On a CUDA
    device it runs through kernel B1 and raises where B1 cannot launch.

    `checkpoint_dir` persists each finished ref's result (atomic JSON
    per ref, tagged by program, machine and sampler config,
    _checkpoint_tagger) and resumes a run by skipping refs whose file
    matches; in the bucket runner they are masked out of their bucket.

    `spans`, when given, gathers host seconds per stage: "draw",
    "stage", "dispatch" (launching the kernel and the pair reduction,
    and waiting for a drained dispatch's copy back) and "decode" (into
    the host dicts). `counters`, when given, counts "dispatches",
    "pipeline_stalls", "capacity_regrows", "ref_buckets", and sets
    "pipeline_depth" and "refs_per_dispatch" (the JAX package's
    telemetry names)."""
    import os

    dev = resolve_device(device)
    backend = _sampled_backend(cfg, dev, raw_noshare)
    telemetry.event("kernel_backend", backend=backend if backend != "auto"
                    else "cuda" if dev.type == "cuda" else "torch")
    if batch is None:
        batch = default_batch(dev)
    trace, rows = _program_rows(program, machine)
    tag_of = None
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
        tag_of = _checkpoint_tagger(program, machine, cfg, batch, dev,
                                    raw_noshare)
    if backend == "native":
        return _sampled_outputs_native(trace, rows, cfg, dev, batch,
                                       capacity, checkpoint_dir, tag_of,
                                       spans, counters)
    buckets = None
    if not _use_fused(cfg, dev):
        buckets = collections.OrderedDict(
            ((k, idx), [(idx, ri)]) for idx, (k, ri, _sig) in enumerate(rows)
        )
    return _run_dispatches(trace, rows, cfg, dev, batch, capacity, backend,
                           raw_noshare, buckets, checkpoint_dir, tag_of,
                           spans, counters)


def check_native(backend: str, dev: torch.device) -> None:
    """kernel_backend "native" is the CPU's route: raise elsewhere (no
    route of the port takes another backend in its place on a card)."""
    if backend == "native" and dev.type != "cpu":
        raise ValueError(
            "kernel_backend='native' is the sampled engine's CPU route "
            "(the native library's classify_reduce): run it with "
            f"device=\"cpu\" (--device cpu), not on {dev}"
        )


def _sampled_backend(cfg: SamplerConfig, dev: torch.device,
                     raw_noshare: bool) -> str:
    """cfg.kernel_backend of a sampled_outputs run (None: "auto"), as
    the JAX package's _resolve_kernel_backend: "native" raises off the
    CPU (check_native) and, like the JAX package's hist backends, gives
    way to the raw route's plain classify under `raw_noshare` (runtime
    v2, the r10 distribute read raw noshare keys) with a warning."""
    backend = cfg.kernel_backend or "auto"  # validated by SamplerConfig
    check_native(backend, dev)
    if backend == "native" and raw_noshare:
        warnings.warn(
            "kernel_backend='native' ignored: v2 raw-noshare runs "
            "require the raw classify (the native pass pow2-bins "
            "noshare)", stacklevel=3)
        return "torch"
    return backend


def _sampled_outputs_native(trace, rows, cfg, dev, batch, capacity,
                            checkpoint_dir, tag_of, spans, counters):
    """The JAX package's _sampled_outputs_serial(native=True) on the
    CPU: per ref in row order its draw (the host stream, or the device
    draw where cfg.device_draw forces it), in chunks of `batch` keys
    each classified by the plain raw-noshare form, then reduced by one
    C++ pass (native.classify_reduce): pow2 bins and cold into a flat
    per-ref array, share and sub-1 noshare samples as exact pairs.
    Counts "dispatches", "dispatches_native", "native_chunk_plan" (the
    planned chunks per ref) and "capacity_regrows"; spans "draw",
    "dispatch" (the classify) and "decode" (the native pass). The
    results equal the serial runner's field for field."""
    from .. import native as native_mod
    from ..ops import _build
    from ..ops.sampled_hist import sampled_hist_plain
    from .draw import draw_sample_keys_device

    _build.ensure_native()
    results = []
    cap = capacity
    for idx, (k, ri, _sig) in enumerate(rows):
        nt = trace.nests[k]
        name = nt.tables.ref_names[ri]
        if checkpoint_dir is not None:
            prior = _checkpoint_load(_checkpoint_path(checkpoint_dir, idx),
                                     tag_of(idx, name))
            if prior is not None:
                results.append(prior)
                continue
        seed = cfg.seed * 1000003 + idx
        ref_span = telemetry.span("ref", engine="sampled", ref=name)
        ref_span.__enter__()
        drawn = None
        if _use_device_draw(cfg, dev):
            with _span(spans, "draw", where="device"):
                drawn = draw_sample_keys_device(nt, ri, cfg, seed, batch,
                                                dev)
        if drawn is None:
            with _span(spans, "draw", where="host"):
                keys_all, highs = draw_sample_keys(nt, ri, cfg, seed=seed)
            n_samples = len(keys_all)
            keys_all = torch.from_numpy(keys_all)
            mask_all = None
        else:
            keys_all, mask_all, n_samples, highs = drawn
        ph = _pad_highs(highs)
        rx = torch.tensor([ri], dtype=torch.int64, device=dev)
        bins = np.zeros(native_mod._NOSHARE_SLOTS, dtype=np.int64)
        noshare: dict = {}
        share: dict = {}
        n_keys = int(keys_all.shape[0])
        n_chunks = -(-n_keys // batch)
        _count(counters, "native_chunk_plan", n_chunks)
        for lo in range(0, n_keys, batch):
            ck = keys_all[lo:lo + batch]
            cm = None if mask_all is None else mask_all[lo:lo + batch]
            _count(counters, "dispatches")
            _count(counters, "dispatches_native")
            with _span(spans, "dispatch", form="native"):
                residual, _hist, _cold = sampled_hist_plain(
                    nt, ri, ck[None], None if cm is None else cm[None], ph,
                    rx, raw=True)
            with _span(spans, "dispatch", "fetch"):
                packed, cm = telemetry.record_fetch(
                    (residual[0].numpy(), None if cm is None else cm.numpy()))
            with _span(spans, "decode", "merge", where="native"):
                pk, pc, cap, regrows = native_mod.classify_reduce(
                    packed, packed != SENTINEL, bins, mask=cm,
                    share_cap=cap)
                if regrows:
                    _count(counters, "capacity_regrows", regrows)
                decode_pairs(pk, pc, noshare, share)
        # pow2 bins -> {2^e: count}, as the serial runner's histogram
        for e in np.nonzero(bins[:native_mod.N_NOSHARE_BINS])[0]:
            key = 1 << int(e)
            noshare[key] = noshare.get(key, 0.0) + float(bins[e])
        ref_span.__exit__(None, None, None)
        r = SampledRefResult(
            name=name, noshare=noshare, share=share,
            cold=float(bins[native_mod.N_NOSHARE_BINS]),
            n_samples=int(n_samples))
        if checkpoint_dir is not None:
            _checkpoint_store(_checkpoint_path(checkpoint_dir, idx),
                              tag_of(idx, name), r)
        results.append(r)
    return results


def _run_dispatches(trace, rows, cfg, dev, batch, capacity, backend, raw,
                    buckets, checkpoint_dir, tag_of, spans, counters):
    """Both runners' body: plan_dispatches over `buckets` (None: the
    signature buckets) through the depth-bounded drain. The serial
    runner (`buckets` given, one per row) drains a ref's dispatches
    before the next ref draws, as the JAX package's serial runner does;
    the bucket runner keeps its dispatches in flight across buckets and
    sets the JAX package's bucket-plan gauges (fuse_refs, pipeline_depth,
    ref_buckets, expected_chunks, pipeline_overlap_s, refs_per_dispatch)
    in the telemetry run."""
    serial = buckets is not None
    depth = max(1, cfg.pipeline_depth)
    names = [trace.nests[k].tables.ref_names[ri] for k, ri, _sig in rows]
    results: dict = {}
    if checkpoint_dir is not None:
        for idx, name in enumerate(names):
            prior = _checkpoint_load(_checkpoint_path(checkpoint_dir, idx),
                                     tag_of(idx, name))
            if prior is not None:
                results[idx] = prior
    skip = frozenset(results)
    accs = {idx: SampledRefResult(name=name, noshare={}, share={}, cold=0.0,
                                  n_samples=0)
            for idx, name in enumerate(names) if idx not in skip}
    cap = capacity
    pending: collections.deque = collections.deque()
    n_dispatches = n_refs = 0
    overlap_s = 0.0
    # the plan's counts (ref_buckets, expected_chunks), also where the
    # caller passed no counters
    plan = counters if counters is not None else {}
    attrs = {"fused": True} if not serial else {}

    def finalize(idx):
        r = accs.pop(idx)
        if checkpoint_dir is not None:
            _checkpoint_store(_checkpoint_path(checkpoint_dir, idx),
                              tag_of(idx, r.name), r)
        results[idx] = r

    def drain(entry):
        nonlocal cap, overlap_s
        (members, n_samples, final, host, event, reduce, dispatch_cap,
         t0) = entry
        # time this dispatch spent in flight while the host worked on
        # other dispatches — the overlap the pipeline exists to buy
        overlap_s += max(0.0, time.perf_counter() - t0)
        with _span(spans, "dispatch", "fetch", **attrs):
            if event is not None:
                event.synchronize()
            mk, mc, max_nu, cold, nh = telemetry.record_fetch(
                tuple(x.numpy() for x in host))
        while int(max_nu.max()) > dispatch_cap:
            # rare: some member saw more distinct (reuse, class) pairs
            # than slots — regrow once for the whole dispatch; its
            # residual stayed alive for this
            dispatch_cap = max(dispatch_cap * 4, int(max_nu.max()))
            cap = max(cap, dispatch_cap)
            _count(counters, "capacity_regrows")
            with _span(spans, "dispatch", "fetch", regrow=True, **attrs):
                mk, mc, max_nu = telemetry.record_fetch(
                    tuple(x.cpu().numpy() for x in reduce(dispatch_cap)))
        with _span(spans, "decode", "merge"):
            for j, ((idx, _ri), n) in enumerate(zip(members, n_samples)):
                res = accs[idx]
                res.n_samples = n
                res.cold += float(cold[j])
                decode_pairs(mk[j], mc[j], res.noshare, res.share)
                # {2^e: count}: hist_update's pow2_floor(2^e) is 2^e,
                # so the fold is bit-identical to raw keys
                ns = res.noshare
                for e in np.nonzero(nh[j])[0]:
                    key = 1 << int(e)
                    ns[key] = ns.get(key, 0.0) + float(nh[j][e])
                if final:
                    finalize(idx)

    for d in plan_dispatches(trace, rows, cfg, dev, batch, backend, spans,
                             buckets, skip, plan, serial):
        # the JAX package's forms: a host-drawn chunk ("chunk") or a
        # device-drawn buffer ("scan") of one ref, or a bucket ("fused")
        form = ({"form": "chunk" if d.mask_RB is None else "scan"} if serial
                else {"form": "fused", "refs": len(d.members)})
        _count(counters, "dispatches")
        if not serial:
            _count(counters, "dispatches_fused")
        with _span(spans, "dispatch", **form):
            out, reduce = bucket_dispatch(
                d.nt, d.ref_idx, d.keys_RB, d.mask_RB, d.highs, d.rx_R, cap,
                backend, d.desc, d.tri_base, raw, d.desc_dev,
            )
            host, event = _fetch_async(out, dev)
        n_dispatches += 1
        n_refs += len(d.members)
        # in flight: the dispatch's residual (for a regrow) and its copies
        pending.append((d.members, d.n_samples, d.final, host, event,
                        reduce, cap, time.perf_counter()))
        final = d.final
        del d, out, reduce
        while len(pending) >= depth:
            # the depth bound: drain the oldest dispatch in flight
            _count(counters, "pipeline_stalls")
            drain(pending.popleft())
        if serial and final:
            # the ref's last dispatch: drain it inside its "ref" span
            while pending:
                drain(pending.popleft())
    while pending:
        drain(pending.popleft())
    for idx in list(accs):  # refs with no drawable point
        finalize(idx)
    _gauge(counters, "pipeline_depth", depth, tele=not serial)
    if n_dispatches:
        _gauge(counters, "refs_per_dispatch", n_refs / n_dispatches,
               tele=not serial)
    if not serial:
        telemetry.gauge("fuse_refs", 1)
        telemetry.gauge("ref_buckets", plan.get("ref_buckets", 0))
        telemetry.gauge("expected_chunks", plan.get("expected_chunks", 0))
        telemetry.gauge("pipeline_overlap_s", overlap_s)
    return [results[idx] for idx in range(len(rows))]


def _fetch_async(out, dev: torch.device):
    """Start copying a dispatch's outputs to the host: (host tensors,
    the event behind the copies). On a CUDA device the copies go to
    fresh pinned buffers (torch caches pinned blocks) with
    non_blocking=True on the current stream, which the kernels and the
    pair reduction ran on; the CPU's outputs are already on the host."""
    if dev.type != "cuda":
        return out, None
    host = []
    for x in out:
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x, non_blocking=True)
        host.append(h)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(dev))
    return host, event


# Lanes per member of warmup's dispatches: a whole number of B3's blocks
# (so its main instantiations), and above torch.sort's in-place limit
# (4096), so the sorts take the kernels the runs' long rows take.
_WARMUP_LANES = 1 << 16


def warmup(
    program: Program,
    machine: MachineConfig,
    cfg: SamplerConfig | None = None,
    batch: int | None = None,
    capacity: int = DEFAULT_CAPACITY,
    device=None,
) -> None:
    """Build and load the kernels a later sampled_outputs run of
    `program` will use, and launch each once on small inputs: per
    bucket, under the device draw, the draw's own body (B3's randint at
    the bucket's span and its bits, the sorts, the threshold and the
    host read) on _WARMUP_LANES lanes per member, then one dispatch of
    those lanes in each form of B1's launch flag (the bucket's kernel
    instantiation, the pair reduction and the copy back). A timed run
    after it pays no nvcc build, module load or first launch of these
    (the caching allocator's first allocations at the run's sizes
    remain). On the CPU (device="cpu") it does nothing; without a card
    it raises unless the CPU is asked for, as the runs do."""
    from ..ops import _build
    from ..ops.sampled_hist import (
        build_descriptor,
        device_descriptor,
        tri_table,
    )
    from . import threefry
    from .draw import (
        _draw_base_key,
        _host_counts,
        _rect_draw_body,
        _tri_draw_body,
        plan_draw,
    )

    dev = resolve_device(device)
    if dev.type != "cuda":
        return
    cfg = cfg or SamplerConfig()
    if batch is None:
        batch = default_batch(dev)
    backend = cfg.kernel_backend or "auto"
    check_native(backend, dev)
    if backend != "torch":
        for name in ("sampled_hist", "threefry_draw"):
            _build.load(name)
    n = _WARMUP_LANES
    key = threefry.fold_in(_draw_base_key(cfg.seed), 0)
    trace, rows = _program_rows(program, machine)
    for (k, _sig), members in _bucket_rows(trace, rows).items():
        nt = trace.nests[k]
        ri0 = members[0][1]
        highs, s = _sample_highs(nt, ri0, cfg)
        if s == 0:
            continue
        R = len(members)
        keys = torch.zeros((R, n), dtype=torch.int64, device=dev)
        mask = None
        plan = (plan_draw(nt, ri0, cfg, batch)
                if _use_device_draw(cfg, dev) else None)
        if plan is not None:
            _B, tri, _s, highs_t, excl, space_box = plan
            if tri:
                keys, mask, U, n_chosen = _tri_draw_body(
                    nt, ri0, highs_t, excl, key, n // 4, n, dev, backend)
            else:
                keys, mask, U, n_chosen = _rect_draw_body(
                    [key] * R, space_box, n // 4, n, dev, backend)
            _host_counts(U, n_chosen)
        desc = tri_base = None
        if backend != "torch":
            desc, tri_base = build_descriptor(nt, ri0), tri_table(nt, dev)
        desc_dev = device_descriptor(desc, dev)
        rx_R = torch.tensor([ri for _, ri in members], dtype=torch.int64,
                            device=dev)
        for raw in (False, True):
            out, _ = bucket_dispatch(nt, ri0, keys, mask, _pad_highs(highs),
                                     rx_R, capacity, backend, desc, tri_base,
                                     raw, desc_dev)
            _fetch_async(out, dev)[1].synchronize()
    torch.cuda.synchronize(dev)


def results_from_samples(
    program: Program,
    machine: MachineConfig,
    samples_by_ref: dict,
    device=None,
) -> list[SampledRefResult]:
    """Explicit-sample surface: classify caller-provided sample tuples.

    `samples_by_ref` maps tracked reference name -> (S, depth) array of
    normalized iteration tuples; each provided ref is classified with the
    plain classify (classify_samples) on `device` (CUDA unless the CPU
    is asked for) and folded into a SampledRefResult with raw noshare
    keys. Refs not present in the mapping are skipped; tracked ref names
    must be unique across nests. The JAX package's results_from_samples,
    which anchors the model against the reference binary on identical
    sample sets."""
    from ..ops.sampled_hist import torch_vals

    dev = resolve_device(device)
    trace, rows = _program_rows(program, machine)
    seen: set[str] = set()
    results = []
    for k, ri, _sig in rows:
        nt = trace.nests[k]
        name = nt.tables.ref_names[ri]
        if name not in samples_by_ref:
            continue
        if name in seen:
            raise ValueError(
                f"tracked ref name {name!r} is not unique across nests; "
                "explicit sample routing would be ambiguous"
            )
        seen.add(name)
        tnt = nt.with_vals(torch_vals(nt.vals, dev))
        samples = torch.as_tensor(
            np.asarray(samples_by_ref[name], np.int64), device=dev)
        packed, _, _, found = classify_samples(tnt, ri, samples)
        packed, found = packed.cpu().numpy(), found.cpu().numpy()
        keys, counts = np.unique(packed[found], return_counts=True)
        noshare: dict[int, float] = {}
        share: dict[int, dict[int, float]] = {}
        decode_pairs(keys, counts, noshare, share)
        results.append(SampledRefResult(
            name=name, noshare=noshare, share=share,
            cold=float((~found).sum()), n_samples=len(samples),
        ))
    missing = set(samples_by_ref) - seen
    if missing:
        raise ValueError(f"unknown tracked refs: {sorted(missing)}")
    return results


def fold_results(
    results: list[SampledRefResult], thread_num: int, v2: bool = False
) -> PRIState:
    """Per-ref sampled results -> PRIState in runtime-v1 form (noshare
    pow2-binned on insertion, share raw), all counts attributed to
    simulated thread 0 — the distribute/print stages only ever consume
    thread-merged histograms (pluss_utils.h:1013-1022, :1042-1058).
    v2=True keeps noshare keys raw (pluss_utils_v2.h:915-918); it needs
    results of the raw route (raw_noshare=True), whose noshare keys are
    exact."""
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
    raw_noshare: bool | None = None,
    **kw,
) -> tuple[PRIState, list[SampledRefResult]]:
    """Sampled engine -> (PRIState, per-ref results). Runs on CUDA
    unless `device="cpu"`; raises where CUDA is absent and the CPU was
    not asked for. v2 takes the raw route (raw noshare keys) and keeps
    them raw in the state; `raw_noshare` (default: v2) takes the raw
    route alone (the r10 distribute reads the per-ref results' raw keys
    beside a v1 state). `spans` gathers host seconds per stage
    (sampled_outputs' stages and "fold"); **kw goes to sampled_outputs
    (batch, capacity, checkpoint_dir, counters)."""
    cfg = cfg or SamplerConfig()
    with telemetry.span("engine", engine="sampled"):
        results = sampled_outputs(
            program, machine, cfg, device=device,
            raw_noshare=v2 if raw_noshare is None else raw_noshare,
            spans=spans, **kw
        )
        with _span(spans, "fold", "merge", stage="fold_results"):
            state = fold_results(results, machine.thread_num, v2)
    return state, results


def _stream_order(keys: np.ndarray, seed: int) -> np.ndarray:
    """Deterministic uniform round-assignment order for one ref's
    drawn key set: argsort by a splitmix64 hash of (key, seed).

    draw_sample_keys returns the sample SET sorted by key (np.unique),
    so a plain prefix would be the smallest iteration points — a
    biased subsample no confidence band could speak for. Hashing makes
    every prefix of the reordered stream an (exchangeable) uniform
    subset of the full set, while the UNION over all rounds is the set
    itself — which is all the final-round bit-identity needs (every
    consumer of the folded histograms iterates in sorted-key order,
    and integer-count float accumulation is exact, so processing
    order never reaches the MRC bytes). Pure integer arithmetic:
    replays exactly from (keys, seed) on every platform."""
    x = keys.astype(np.uint64) + np.uint64(seed & ((1 << 64) - 1))
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    # lexsort's final key (the hash) is primary; ties (hash collisions)
    # break on the raw key so the order is total and deterministic
    return np.lexsort((keys, x))


def _classify_slice(ref: dict, keys: np.ndarray, batch: int, cap_box: list,
                    dev: torch.device, backend: str, spans: dict | None,
                    counters: dict | None):
    """Classify one contiguous slice of a ref's (reordered) key stream
    in `batch`-key chunks, each one dispatch of kernel B1's raw-noshare
    form (the plain raw route on the CPU or under "torch") with every
    lane live and one read back, into a fresh sub-histogram block; the
    JAX package's chunk/fetch/regrow loop over its plain per-ref kernel,
    whose pairs keep raw noshare values too. `cap_box` is the run-wide
    mutable [capacity] so a regrow sticks for later slices. Returns
    (noshare, share, cold)."""
    noshare: dict[int, float] = {}
    share: dict[int, dict[int, float]] = {}
    cold = 0.0
    for s0 in range(0, len(keys), batch):
        with _span(spans, "stage", tele=None):
            chunk = torch.from_numpy(keys[s0:s0 + batch]).to(dev)[None]
        _count(counters, "dispatches")
        with _span(spans, "dispatch", form="progressive"):
            out, reduce = bucket_dispatch(
                ref["nt"], ref["ri"], chunk, None, ref["ph"], ref["rx"],
                cap_box[0], backend, ref["desc"], ref["tri"], raw=True,
                desc_dev=ref["desc_dev"],
            )
        with _span(spans, "dispatch", "fetch"):
            pk, pc, nu, c, _hist = telemetry.record_fetch(
                tuple(x.cpu().numpy() for x in out))
        while int(nu[0]) > cap_box[0]:
            cap_box[0] = max(cap_box[0] * 4, int(nu[0]))
            _count(counters, "capacity_regrows")
            with _span(spans, "dispatch", "fetch", regrow=True):
                pk, pc, nu = telemetry.record_fetch(
                    tuple(x.cpu().numpy() for x in reduce(cap_box[0])))
        cold += float(c[0])
        with _span(spans, "decode", "merge"):
            decode_pairs(pk[0], pc[0], noshare, share)
    return noshare, share, cold


def _sum_blocks(blocks) -> tuple:
    """Union of sub-histogram blocks (sorted-key accumulation; counts
    are integers, so the float sums are exact and order-free)."""
    noshare: dict[int, float] = {}
    share: dict[int, dict[int, float]] = {}
    cold = 0.0
    for ns, sh, c in blocks:
        for k in sorted(ns):
            noshare[k] = noshare.get(k, 0.0) + ns[k]
        for ratio in sorted(sh):
            d = share.setdefault(ratio, {})
            h = sh[ratio]
            for k in sorted(h):
                d[k] = d.get(k, 0.0) + h[k]
        cold += c
    return noshare, share, cold


def run_sampled_progressive(
    program: Program,
    machine: MachineConfig,
    cfg: SamplerConfig | None = None,
    v2: bool = False,
    *,
    batch: int | None = None,
    capacity: int = DEFAULT_CAPACITY,
    on_round=None,
    should_stop=None,
    device=None,
    spans: dict | None = None,
    counters: dict | None = None,
) -> tuple[PRIState, list[SampledRefResult], dict]:
    """Round-based sampled engine with confidence-banded early exit.

    Each ref draws its FULL final-ratio sample stream once, with the
    one-shot host-draw convention (numpy PCG, seed = cfg.seed *
    1000003 + row index) — so the stream IS the one-shot sample set —
    then classifies it across rounds of increasing prefixes of a
    seeded reorder (_stream_order) of that stream. Per round, each
    ref's new slice lands in SUB_BLOCKS_PER_ROUND independent
    sub-histogram blocks (_classify_slice: kernel B1's raw-noshare form
    on CUDA); sampler/confidence.py bootstraps an MRC band over them
    between rounds. The run stops early when the band width drops under
    cfg.tolerance, or at a round boundary when `should_stop()` returns
    True; either way the cumulative union state is returned. A run that
    completes the whole schedule folds the exact one-shot sample set,
    so its PRIState/MRC is bit-identical to run_sampled at the same
    (ratio, seed) on the host draw, and its per-ref results equal
    sampled_outputs(raw_noshare=True) there.

    `on_round(info)` fires after every completed round with the round
    index, cumulative (state, results), interim MRC, and the
    monotone-clamped band width. Runs on CUDA unless `device="cpu"`;
    `spans` gathers host seconds per stage ("draw", "stage",
    "dispatch", "decode", "fold", "bootstrap") and `counters` counts
    "progressive_rounds", "dispatches" and "capacity_regrows". The JAX
    package's `fault_key` (the service's `round_exec` chaos site) waits
    for the service.

    Returns (state, results, info) with info = {"rounds" completed,
    "rounds_total", "band_width", "converged", "stopped"
    (None | "converged" | "deadline")}.
    """
    from ..ops.sampled_hist import (
        build_descriptor,
        device_descriptor,
        tri_table,
    )
    from . import confidence

    cfg = cfg or SamplerConfig()
    dev = resolve_device(device)
    backend = cfg.kernel_backend or "auto"  # validated by SamplerConfig
    check_native(backend, dev)
    if backend == "native":  # the CPU's plain classify, as the JAX
        backend = "torch"    # package's progressive rounds ignore it
    kernel = backend != "torch" and dev.type == "cuda"
    if batch is None:
        batch = default_batch(dev)
    if _use_device_draw(cfg, dev):
        # the progressive stream is the HOST draw stream: prefix
        # extension needs the whole set materialized host-side, and
        # the bit-identity anchor is the host-path one-shot run
        message = ("progressive sampling always draws on the host; "
                   "device_draw ignored for this run")
        telemetry.event("warning", key="progressive_host_draw",
                        message=message)
        warnings.warn(message, stacklevel=2)
    schedule = confidence.resolve_schedule(cfg)
    n_rounds = len(schedule)
    tol = getattr(cfg, "tolerance", None)
    trace, rows = _program_rows(program, machine)
    for nt in trace.nests:
        check_packed_ratios(nt)
    cap_box = [capacity]
    with telemetry.span("engine", engine="sampled"):
        refs = []
        for idx, (k, ri, _sig) in enumerate(rows):
            nt = trace.nests[k]
            with _span(spans, "draw", where="host"):
                keys_all, highs = draw_sample_keys(
                    nt, ri, cfg, seed=cfg.seed * 1000003 + idx
                )
                order = _stream_order(keys_all, cfg.seed * 1000003 + idx)
            desc = build_descriptor(nt, ri) if kernel else None
            refs.append({
                "nt": nt,
                "ri": ri,
                "name": nt.tables.ref_names[ri],
                "keys": keys_all[order],
                "ph": _pad_highs(highs),
                "rx": torch.tensor([ri], dtype=torch.int64, device=dev),
                "desc": desc,
                "desc_dev": device_descriptor(desc, dev),
                "tri": tri_table(nt, dev) if kernel else None,
                "counts": confidence.round_counts(len(keys_all), schedule),
            })
        blocks: list[list] = [[] for _ in refs]
        state = None
        results: list[SampledRefResult] = []
        band_width = None
        stopped = None
        done = 0
        for r in range(n_rounds):
            if r > 0 and should_stop is not None and should_stop():
                stopped = "deadline"
                break
            _count(counters, "progressive_rounds")
            for ref, ref_blocks in zip(refs, blocks):
                lo = 0 if r == 0 else ref["counts"][r - 1]
                hi = ref["counts"][r]
                for a, b in confidence.block_bounds(lo, hi):
                    ref_blocks.append(_classify_slice(
                        ref, ref["keys"][a:b], batch, cap_box, dev, backend,
                        spans, counters,
                    ))
            done = r + 1
            results = [
                SampledRefResult(
                    name=ref["name"], noshare=ns, share=sh, cold=cold,
                    n_samples=ref["counts"][r],
                )
                for ref, (ns, sh, cold) in zip(
                    refs, (_sum_blocks(rb) for rb in blocks)
                )
            ]
            with _span(spans, "fold", "merge", stage="fold_results"):
                state = fold_results(results, machine.thread_num, v2)
            with _span(spans, "bootstrap", tele=None):
                raw = confidence.bootstrap_band(
                    blocks, machine, seed=cfg.seed, round_idx=r, v2=v2,
                )
            # monotone non-widening by construction: more samples
            # never REPORT more uncertainty than an earlier round did
            band_width = (
                raw if band_width is None else min(band_width, raw)
            )
            early = (
                tol is not None and band_width < tol
                and r < n_rounds - 1
            )
            if on_round is not None:
                on_round({
                    "round": done,
                    "rounds_total": n_rounds,
                    "band_width": band_width,
                    "converged": early or done == n_rounds,
                    "state": state,
                    "results": results,
                    "mrc": confidence.mrc_from_state(state, machine),
                })
            if early:
                stopped = "converged"
                break
    converged = stopped == "converged" or done == n_rounds
    telemetry.gauge("progressive_band_width",
                    band_width if band_width is not None else -1.0)
    if state is None:
        # should_stop before any round completed — nothing to return;
        # the caller treats this like any engine failure
        raise RuntimeError(
            "progressive run stopped before its first round completed"
        )
    return state, results, {
        "rounds": done,
        "rounds_total": n_rounds,
        "band_width": band_width,
        "converged": converged,
        "stopped": stopped,
    }
