"""Device-side sample drawing for the random-start sampled engine.

Port of the JAX package's sampler/draw.py. A tracked reference's
exactly-s distinct uniform sample keys are drawn, deduplicated and
thinned on the run's device, with the JAX package's threefry streams, so
a seed gives the JAX package's device sample sets bit for bit:

- candidates: `randint` over the flat mixed-radix space [0, space) of
  the ref's bounding box, B of them (kernel B3 on the card,
  ops/threefry_draw.py; its plain torch version on the CPU);
- dedup: one sort and a neighbour compare (torch.sort);
- thinning to exactly s: every candidate slot gets an independent uint64
  priority (`bits`, B3 again), and the s smallest priorities among the
  unique representatives win. A tie at the threshold chooses more than
  s and takes a retry, as in the JAX package;
- triangular refs draw from the bounding box and reject out-of-bounds
  points (replaced by the sentinel `_SENT`) before the dedup.

The one host read per draw is U (the unique count) and n_chosen, which
certify the draw; a shortfall retries with a fresh fold and a larger
buffer. The buffer size B = bucket_size(m, batch) depends on the batch,
and with it the sample set: the CUDA default batch (2^20) is the JAX
package's accelerator batch.

The key schedule (seed -> base key -> fold_in(attempt) -> split) runs on
the host (sampler/threefry.py). The constants and the plan below are
copied from the JAX package verbatim: they are semantics, and a change
changes the sample sets. draw_bucket_keys_device_multi draws the rows of
a cross-request bucket (the service's batches): rows of different
programs, each with its own space and s, through B3's randint with a
span per row.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ..ops.threefry_draw import threefry_bits, threefry_randint
from . import threefry

# Above this many int64 buffer slots the draw falls back to the host
# path (the JAX package's device-memory budget; a semantic limit here).
DEVICE_DRAW_MAX_SLOTS = 1 << 28

# The draw's steps, each a profiler range (record_function) that a trace
# of a draw breaks its time down by; without a profiler a range is two
# host calls.
STEPS = ("draw: B3 randint", "draw: sort keys", "draw: neighbour compare",
         "draw: B3 bits", "draw: sort priorities", "draw: threshold select",
         "draw: host read")

# Rejection sentinel: strictly greater than every valid flat key.
_SENT = np.iinfo(np.int64).max

# randint's modulo bias stays below 2^-18 under this box size; larger
# boxes take the host draw. It is also the span the plain randint takes.
_DEVICE_DRAW_MAX_SPACE = threefry.MAX_SPAN


def bucket_size(m: int, batch: int) -> int:
    """Round the candidate count up to batch * 2^k with at least one
    batch."""
    n_chunks = 1
    while n_chunks * batch < m:
        n_chunks *= 2
    return n_chunks * batch


def plan_draw(nt, ref_idx: int, cfg, batch: int):
    """The device-draw plan for one ref: (B, tri?, s, highs, excl,
    space_box), or None when the ref cannot take the device path
    (s == 0, empty tri space, a buffer beyond DEVICE_DRAW_MAX_SLOTS,
    or a box beyond _DEVICE_DRAW_MAX_SPACE)."""
    from .sampled import _sample_plan

    highs, s, space_valid = _sample_plan(nt, ref_idx, cfg)
    if s == 0 or space_valid == 0:
        return None
    tri = nt.tri and int(nt.tables.ref_levels[ref_idx]) >= 1
    excl = 1 if cfg.exclude_last_iteration else 0
    space_box = 1
    for h in highs:
        space_box *= h
    if space_box >= _DEVICE_DRAW_MAX_SPACE:
        return None
    if tri:
        # margin scales by the box/valid ratio the rejection will eat
        m = (s + s // 8 + 64) * space_box // space_valid + 64
    else:
        m = s + s // 8 + 64
    B = bucket_size(m, batch)
    if B > DEVICE_DRAW_MAX_SLOTS:
        return None
    return B, tri, s, tuple(highs), excl, space_box


def _backend(cfg) -> str:
    """The draw's backend: the run's (validated by SamplerConfig), the
    plain streams under "native" (the sampled engine's CPU route)."""
    kb = cfg.kernel_backend or "auto"
    return "torch" if kb == "native" else kb


def _first_of_runs(sk):
    """[R, B] sorted rows -> the mask of each run's first element."""
    first = torch.ones_like(sk, dtype=torch.bool)
    first[:, 1:] = sk[:, 1:] != sk[:, :-1]
    return first


def _select_exact(sk, valid_first, s: int, pri_keys, backend: str):
    """Uniform s-subset of the unique representatives of each sorted row.

    `valid_first` (bool [R, B]) marks the first occurrence of each
    non-sentinel key; `pri_keys` are the rows' priority keys; `s` is one
    count for every row or a sequence of one per row. Returns
    (chosen [R, B], U [R], n_chosen [R]): priorities are independent
    uint64 draws (compared as their int64 images), the s smallest among
    representatives win, and a tie at the threshold chooses more."""
    R, B = sk.shape
    with record_function("draw: neighbour compare"):
        U = valid_first.sum(dim=1)
    with record_function("draw: B3 bits"):
        pri = threefry_bits(pri_keys, B, sk.device, valid_first, backend)
    with record_function("draw: sort priorities"):
        spri = torch.sort(pri, dim=1).values
    with record_function("draw: threshold select"):
        if isinstance(s, (int, np.integer)):
            thr = spri[:, min(max(s - 1, 0), B - 1)]
        else:
            col = torch.tensor([min(max(int(x) - 1, 0), B - 1) for x in s],
                               dtype=torch.int64, device=spri.device)
            thr = spri.gather(1, col[:, None])[:, 0]
        del spri
        chosen = valid_first & (pri <= thr[:, None])
        n_chosen = chosen.sum(dim=1)
    return chosen, U, n_chosen


def _rect_draw_body(rng_keys, space, s, B: int, device,
                    backend: str = "auto"):
    """One rectangular draw + dedup + thin per key of `rng_keys`, as
    [R, B] rows (the JAX package's per-ref body, vmapped over R keys:
    threefry streams are counter-based per key, so a row is its key's
    per-ref draw). `space` and `s` are one value for every row, or one
    per row (the JAX package's _rect_draw_kernel_batch_multi: the rows'
    own operands, B3's randint with a span per row). Returns (sorted
    keys, chosen, U, n_chosen)."""
    subs = [threefry.split(k) for k in rng_keys]
    with record_function("draw: B3 randint"):
        keys = threefry_randint([k1 for k1, _ in subs], B, space, device,
                                backend)
    with record_function("draw: sort keys"):
        sk = torch.sort(keys, dim=1).values
    del keys
    with record_function("draw: neighbour compare"):
        first = _first_of_runs(sk)
    chosen, U, n_chosen = _select_exact(
        sk, first, s, [k2 for _, k2 in subs], backend)
    return sk, chosen, U, n_chosen


def _tri_draw_body(nt, ref_idx: int, highs: tuple, excl: int, rng_key,
                   s: int, B: int, device, backend: str = "auto"):
    """Box draw + rejection for one triangular ref (the JAX package's
    _build_tri_draw_kernel body), as one [1, B] row."""
    from .sampled import decode_sample_keys

    lv = int(nt.tables.ref_levels[ref_idx])
    space_box = 1
    for h in highs:
        space_box *= h
    k1, k2 = threefry.split(rng_key)
    with record_function("draw: B3 randint"):
        keys = threefry_randint([k1], B, space_box, device, backend)[0]
    cols = decode_sample_keys(keys, highs)
    v0 = nt.nest.loops[0].start + cols[:, 0] * nt.nest.loops[0].step
    ok = torch.ones(B, dtype=torch.bool, device=keys.device)
    for l in range(1, lv + 1):
        ok &= cols[:, l] < (nt.nest.loops[l].trip_at(v0) - excl)
    with record_function("draw: sort keys"):
        sk = torch.sort(torch.where(ok, keys, _SENT)).values[None]
    with record_function("draw: neighbour compare"):
        first = _first_of_runs(sk) & (sk < _SENT)
    chosen, U, n_chosen = _select_exact(sk, first, s, [k2], backend)
    return sk, chosen, U, n_chosen


def _draw_base_key(seed: int) -> tuple[int, int]:
    """The per-ref threefry base key, as the JAX package derives it:
    jr.fold_in(jr.key(uint32(seed)), uint32(seed >> 32))."""
    base = threefry.seed_key(seed & threefry.M32)
    return threefry.fold_in(base, (seed >> 32) & threefry.M32)


def _host_counts(U, n_chosen) -> list[tuple[int, int]]:
    """(U, n_chosen) per row, in one device-to-host read."""
    with record_function("draw: host read"):
        return [tuple(x) for x in torch.stack([U, n_chosen], 1).tolist()]


def draw_sample_keys_device(nt, ref_idx: int, cfg, seed: int, batch: int,
                            device=None):
    """Exactly-s distinct uniform sample keys, drawn and thinned on
    `device` (CUDA unless the caller asks for the CPU; raises where CUDA
    is absent, as sampled.resolve_device does).

    Returns (keys (B,) int64, chosen (B,) bool with exactly s True
    entries, s, highs), both tensors on `device`, or None when plan_draw
    declines the ref (the caller takes the host draw). Deterministic in
    the seed: the JAX package's device draw gives the same keys, mask
    and B. Raises after 8 attempts short of s unique samples."""
    from .sampled import resolve_device

    device = resolve_device(device)
    plan = plan_draw(nt, ref_idx, cfg, batch)
    if plan is None:
        return None
    B, tri, s, highs, excl, space_box = plan
    backend = _backend(cfg)
    base = _draw_base_key(seed)
    for attempt in range(8):
        rng_key = threefry.fold_in(base, attempt)
        if tri:
            sk, chosen, U, n_chosen = _tri_draw_body(
                nt, ref_idx, highs, excl, rng_key, s, B, device, backend)
        else:
            sk, chosen, U, n_chosen = _rect_draw_body(
                [rng_key], space_box, s, B, device, backend)
        ((u, n),) = _host_counts(U, n_chosen)
        if u >= s and n == s:
            return sk[0], chosen[0], s, highs
        # shortfall (not enough uniques in the buffer) or a priority
        # tie: grow the buffer and redraw from a fresh fold
        B = bucket_size(B + B // 2, batch)
        if B > DEVICE_DRAW_MAX_SLOTS:
            return None
    raise RuntimeError(
        f"device draw failed to reach {s} unique samples in 8 attempts "
        f"(ref {nt.tables.ref_names[ref_idx]}; last buffer {B})"
    )


class BucketDraw(NamedTuple):
    """Drawn rows of a bucket that share one buffer size B."""

    positions: list  # the rows' indices into the bucket's ref_indices
    keys: torch.Tensor  # int64 [r, B]: each row's sorted keys
    chosen: torch.Tensor  # bool [r, B]: each row's exactly-s mask
    s: int
    highs: tuple


def draw_bucket_keys_device(nt, ref_indices, cfg, seeds, batch: int,
                            device=None) -> list:
    """Device draw for a whole kernel-signature bucket: one [R, B] draw
    (one B3 launch per stream) over its R members, on `device` (as
    draw_sample_keys_device).

    `ref_indices` share one kernel signature, hence one draw plan;
    `seeds` are their per-ref seeds in the same order. Returns a list of
    BucketDraw: each run of consecutive members the first attempt
    certifies is a slice of the bucket's [R, B] buffers, and a member it
    does not certify replays its own retry loop (from attempt 0,
    deterministic) into a group of its own with its grown B. A member in
    no group cannot take the device path (the caller routes it to the
    host draw). Triangular buckets (singletons) and singletons take the
    per-ref draw. Each member's row equals its per-ref draw."""
    from .sampled import resolve_device

    device = resolve_device(device)
    plan = plan_draw(nt, ref_indices[0], cfg, batch)
    if plan is None:
        return []
    B, tri, s, highs, excl, space_box = plan
    if tri or len(ref_indices) == 1:
        certified = [False] * len(ref_indices)
    else:
        bases = [threefry.fold_in(_draw_base_key(sd), 0) for sd in seeds]
        sk, chosen, U, n_chosen = _rect_draw_body(
            bases, space_box, s, B, device, _backend(cfg))
        certified = [u >= s and n == s for u, n in _host_counts(U, n_chosen)]
    groups = []
    for ok, run in itertools.groupby(range(len(ref_indices)),
                                     key=certified.__getitem__):
        run = list(run)
        if ok:
            lo, hi = run[0], run[-1] + 1
            groups.append(BucketDraw(run, sk[lo:hi], chosen[lo:hi], s,
                                     highs))
            continue
        for j in run:
            d = draw_sample_keys_device(nt, ref_indices[j], cfg,
                                        seed=seeds[j], batch=batch,
                                        device=device)
            if d is not None:
                groups.append(BucketDraw([j], d[0][None], d[1][None],
                                         *d[2:]))
    return groups


def draw_bucket_keys_device_multi(entries, batch: int, device=None) -> list:
    """Device draw for one cross-request union bucket, on `device` (as
    draw_sample_keys_device).

    `entries` is [(nt, ref_idx, cfg, seed)]: members of one signature
    bucket that may span several programs and sampler configs, so they
    do not share a draw plan: each member plans with its own nest and
    config, and the members whose plans land on one buffer size B draw
    as the rows of one [R, B] draw, each with its own base key, space
    and s (B3's randint with a span per row). Triangular members and
    the single member of a B take the per-ref draw; a row the first
    attempt does not certify replays its member's per-ref retry loop.

    Returns a list parallel to entries of (keys (B,), chosen (B,), s,
    highs), or None for a member off the device path (the caller draws
    it on the host). Each member's row equals its
    draw_sample_keys_device: its group is keyed by its own planned B,
    and threefry streams are counter-based per key."""
    from .sampled import resolve_device

    device = resolve_device(device)
    out: list = [None] * len(entries)
    rect: dict = {}
    for i, (nt, ri, cfg, sd) in enumerate(entries):
        plan = plan_draw(nt, ri, cfg, batch)
        if plan is None:
            continue
        B, tri, s, highs, excl, space_box = plan
        if tri:
            out[i] = draw_sample_keys_device(nt, ri, cfg, seed=sd,
                                             batch=batch, device=device)
            continue
        rect.setdefault(B, []).append((i, s, highs, space_box, sd))
    for B, grp in rect.items():
        if len(grp) == 1:
            i = grp[0][0]
            nt, ri, cfg, sd = entries[i]
            out[i] = draw_sample_keys_device(nt, ri, cfg, seed=sd,
                                             batch=batch, device=device)
            continue
        bases = [threefry.fold_in(_draw_base_key(sd), 0)
                 for _i, _s, _h, _sp, sd in grp]
        backends = {_backend(entries[i][2]) for i, *_ in grp}
        # rows of one draw share one backend: "torch" where any member
        # asks for the plain streams, which draw the same bits
        backend = "torch" if "torch" in backends else backends.pop()
        sk, chosen, U, n_chosen = _rect_draw_body(
            bases, [sp for _i, _s, _h, sp, _sd in grp],
            [s for _i, s, _h, _sp, _sd in grp], B, device, backend)
        counts = _host_counts(U, n_chosen)
        for j, (i, s, highs, _sp, sd) in enumerate(grp):
            u, n = counts[j]
            if u >= s and n == s:
                out[i] = (sk[j], chosen[j], s, highs)
            else:
                nt, ri, cfg, _sd = entries[i]
                out[i] = draw_sample_keys_device(nt, ri, cfg, seed=sd,
                                                 batch=batch, device=device)
    return out
