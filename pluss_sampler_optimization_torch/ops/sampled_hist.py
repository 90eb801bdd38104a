"""Fused decode + classify + pow2 histogram of the sampled engine.

The counterpart of the JAX package's Pallas kernel
(ops/pallas_sampled.py::_one_ref). For one kernel-signature bucket —
R member refs of one nest, each with its own value index rx and its own
buffer of B mixed-radix sample keys — it returns

    residual[R, B]  packed key ri*16+slot of every share sample and
                    every noshare sample with ri < 1, 2^62 elsewhere;
    hist[R, 64]     pow2 histogram of noshare samples with ri >= 1
                    (bin floor(log2 ri); bin 63 is always empty);
    cold[R]         masked-in samples whose line is never touched again.

Under `raw=True` (the raw-noshare form, for runtime-v2 states and the
r10 distribute, which read raw noshare reuse) no sample is binned: every
found sample's packed key goes to the residual, noshare ones with slot
15, and hist stays zero; cold is unchanged.

`mask_RB` (bool [R, B]) switches lanes off: the engine passes the
device draw's `chosen` mask. None means every lane is live, which is
what the host draw's dispatches pass (they are never padded), so the
kernel then reads no mask at all. A masked-off lane is never classified;
the plain version decodes it as key 0, so a triangular buffer's sentinel
(int64 max) cannot reach an index.

`sampled_hist` picks the implementation: the hand-written CUDA kernel
(csrc/sampled_hist.cu) for CUDA tensors, the plain torch version for
tensors on the CPU or under an explicit backend="torch". There is no
fallback: a CUDA tensor under "auto"/"cuda" launches the kernel or
raises, and "cuda" on CPU tensors raises.

The kernel takes the classify's structure as a packed int64 descriptor
(`build_descriptor`), so one build serves every signature;
every divisor the classify uses travels in it as a division record
(`div_record`), and the key's radices as three more records passed at
launch. The descriptor travels from the host as a kernel parameter (the
card's constant bank), so the kernel keeps none of it in registers, up
to MAX_DESC words (the parameter form); a longer one (many refs of
distinct maps, or many modeled threads) takes the buffer form, a device
copy made once per bucket (`device_descriptor`) that each block stages
in shared memory (csrc/sampled_hist_buf.cu, a library of its own). A
sink group of more than MAX_MEMBERS refs travels as consecutive
sub-groups (`descriptor_groups`). The build holds one instantiation of
the kernel per source-ref level (`desc[D_LV]`: 0, 1 or 2), per head-count class (groups of at most
one band-plan head, or up to three) and per nest kind (rectangular or
triangular, `desc[D_TRI]`); the launch picks the one of its descriptor.
A triangular nest's per-thread base table (core/trace.py::tri_base)
goes to the kernel as a device tensor of its own (`tri_table`).

The per-row form (`sampled_hist_rows`) serves the service's
cross-request batches: R rows from different programs whose refs share
one kernel signature, each with its own nest, source ref, radices and
value index. On the card it is one launch of the buffer form's library
(csrc/sampled_hist.cu's sampled_hist_launch_rows1 and _rows3, by the
rows' most band-plan heads): each row's descriptor
(`rows_matrix`), radix records and triangular base table (`tri_rows`)
in device buffers at a row stride, staged per block. Its plain version
(`sampled_hist_rows_plain`) is sampled_hist_plain row by row.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ir import MAX_DEPTH
from .histogram import SENTINEL

N_BINS = 64
# Kernel launches of sampled_hist_cuda; read by callers that must show
# a run went through the kernel.
LAUNCHES = 0

# Descriptor layout; csrc/sampled_hist.cu #defines the same offsets.
D_LV, D_DEPTH, D_NREFS, D_THREADS, D_CHUNK = 0, 1, 2, 3, 4
D_S_START, D_S_STEP, D_DS, D_CLS, D_W = 5, 6, 7, 8, 9
D_NPRE0, D_NPRE1, D_NGROUPS = 10, 11, 12
D_ACC, D_TRIPS, D_STARTB, D_SC, D_LSTART, D_LSTEP = 13, 16, 19, 22, 25, 28
D_OFF_LC, D_OFF_REFS, D_OFF_GROUPS = 31, 32, 33
# triangular nests: the flag, per level the trip coefficient and npre+npost,
# the base table's last column, the offset of the per-ref post-slot flags
D_TRI, D_TC, D_BODYC, D_LMAX, D_OFF_POST = 34, 35, 38, 41, 42
# division records, D_DIV_CHUNK up to D_HEADER: chunk, threads, cls,
# acc[0..2] and each level's step, then the triangular walk's, a2 and per
# inner level |tc|, |sc| and |tc+sc| (records of 1 when rectangular)
D_DIV_CHUNK, D_DIV_THREADS, D_DIV_CLS, D_DIV_ACC, D_DIV_STEP = 43, 46, 49, 52, 61
D_DIV_A2, D_DIV_HS = 70, 73
D_HEADER = 91
DIV_SIZE, DIV_NEG = 3, 64  # divisor, multiplier, shift | DIV_NEG
R_SIZE = 8  # off, coeff[3], const, thr, ratio, level
H_SIZE = 4 + DIV_SIZE  # level, n_u, cv's division record, rmin, rmax
G_FIXED = 7 + MAX_DEPTH * H_SIZE  # nmem, level, nheads, term, tlevel, tw, const, heads
TERM_CHECK, TERM_INTERVAL, TERM_WINDOW = 0, 1, 2
# the parameter form's most words (csrc/sampled_hist.cu's MAX_DESC), and
# the most members of a sink group in the descriptor (MAX_MEMBERS)
MAX_DESC = 2048
MAX_MEMBERS = 8
# Launches of the buffer form and of the per-row form (parts of LAUNCHES).
BUFFER_LAUNCHES = 0
ROWS_LAUNCHES = 0


def div_record(d: int) -> list[int]:
    """The kernel's division record of divisor d != 0 (see the note at
    DIV_D in csrc/sampled_hist.cu): [d, multiplier, shift | DIV_NEG if
    d < 0], the multiplier as the int64 of its 64 bits. A power of two
    |d| = 2^s is the shift s; any other |d|, with l = ceil(log2 |d|), is
    the round-up multiplier ceil(2^(63+l) / |d|) < 2^64 and shift l - 1.
    With it the kernel's floor division and modulo equal Python's // and
    % for every int64 numerator (INT64_MIN by -1, whose quotient does
    not fit, aside), so no numerator range needs asserting."""
    d = int(d)
    e = abs(d)
    if e == 0 or e >= 1 << 63:
        raise ValueError(f"no division record for divisor {d}")
    if e & (e - 1) == 0:
        mul, shift = 0, e.bit_length() - 1
    else:
        ell = e.bit_length()  # ceil(log2 e), e not a power of two
        mul, shift = -(-(1 << (63 + ell)) // e), ell - 1
        assert mul < 1 << 64
    if mul >= 1 << 63:
        mul -= 1 << 64
    return [d, mul, shift | (DIV_NEG if d < 0 else 0)]


def radix_records(highs) -> np.ndarray:
    """The division records of the key's MAX_DEPTH radices (padded
    highs), as the launch passes them: int64 [MAX_DEPTH * DIV_SIZE]."""
    h = [int(x) for x in highs]
    if len(h) != MAX_DEPTH or min(h) < 1:
        raise ValueError(f"highs must be {MAX_DEPTH} positive ints: {h}")
    return np.asarray(sum((div_record(x) for x in h), []), dtype=np.int64)


def _tri_header(nt, d: list) -> None:
    """The triangular fields of the descriptor's header (D_TRI on);
    raises for a non-unit step, which the closed form does not cover."""
    nest = nt.nest
    depth = nest.depth
    if any(lp.step != 1 for lp in nest.loops):
        raise NotImplementedError(
            "the closed-form next-use supports triangular nests with unit "
            "steps only"
        )
    d[D_TRI] = 1
    for l in range(MAX_DEPTH):
        d[D_TC + l] = int(nt.tables.trip_coeffs[l])
        d[D_BODYC + l] = nt.npre[l] + nt.npost[l] if l < depth else 0
    d[D_LMAX] = int(nt.tri_base.shape[1]) - 1
    a2 = nt.npre[2] + nt.npost[2] if depth > 2 else 1
    if a2 < 1:
        raise NotImplementedError("the CUDA classify needs a2 >= 1")
    d[D_DIV_A2:D_DIV_A2 + DIV_SIZE] = div_record(a2)
    for l in (1, 2):
        lp = nest.loops[l] if l < depth else None
        tc, sc = (lp.trip_coeff, lp.start_coeff) if lp else (0, 0)
        for k, a in enumerate((tc, sc, tc + sc)):
            at = D_DIV_HS + (3 * (l - 1) + k) * DIV_SIZE
            d[at:at + DIV_SIZE] = div_record(abs(a) or 1)


def _tri_ref_offset(nest, r) -> int:
    """A triangular nest's ref offset without its v0-dependent part
    (core/trace.py::ref_offset_at less the subloop before a post ref)."""
    pre = nest.refs_at(r.level, "pre")
    if r.slot == "pre":
        return pre.index(r)
    return len(pre) + nest.refs_at(r.level, "post").index(r)


def descriptor_groups(nt, ref_idx: int) -> list[tuple[int, list[int]]]:
    """The sink groups of source ref `ref_idx` as the descriptor holds
    them: (the group's first member, whose band plan serves it, and at
    most MAX_MEMBERS members). A longer group of
    sampler/sampled.py::_sink_groups is cut into consecutive sub-groups
    in member order, each repeating the group's heads; since the kernel
    takes a member only at a position strictly below the best so far,
    groups and members in order, the first of equal positions wins as in
    _best_sink's unsplit group."""
    from ..sampler.sampled import _sink_groups

    return [(sinks[0], sinks[i:i + MAX_MEMBERS])
            for sinks in _sink_groups(nt, ref_idx)
            for i in range(0, len(sinks), MAX_MEMBERS)]


def build_descriptor(nt, ref_idx: int) -> np.ndarray:
    """The classify of source ref `ref_idx` as the kernel's int64
    descriptor: schedule and machine fields, loop tables, the division
    records of every divisor, the per-ref value tables (indexed by rx and
    by sink), and every sink group's band plan
    (sampler/nextuse.py::band_plan) with its per-head coefficient (as a
    division record) and residual span precomputed from the value
    overlay, the groups as `descriptor_groups` cuts them. A triangular
    nest adds its header fields (`_tri_header`), each ref's offset
    without its v0-dependent part and the post-slot flags; its base table
    travels apart (`tri_table`). Any length: one above MAX_DESC takes the
    kernel's buffer form (`desc_form`). Raises where the
    kernel's arithmetic does not hold: a non-positive schedule or machine
    divisor or body size (the level-2 reduction relies on acc[2] > 0, the
    triangular one on a2 > 0), or a triangular nest with a non-unit
    step."""
    from ..sampler.nextuse import _ref_vars_static, band_plan
    from ..sampler.sampled import check_packed_ratios

    check_packed_ratios(nt)
    t, mach, sched, v = nt.tables, nt.machine, nt.schedule, nt.vals
    depth = nt.nest.depth
    W = mach.lines_per_element_block
    d = [0] * D_HEADER
    d[D_LV] = int(t.ref_levels[ref_idx])
    d[D_DEPTH] = depth
    d[D_NREFS] = t.n_refs
    d[D_THREADS], d[D_CHUNK] = sched.threads, sched.chunk
    d[D_S_START], d[D_S_STEP] = sched.start, sched.step
    d[D_DS], d[D_CLS], d[D_W] = mach.ds, mach.cls, W
    d[D_NPRE0] = nt.npre[0]
    d[D_NPRE1] = nt.npre[1] if depth > 1 else 0
    for name, x in (("chunk", sched.chunk), ("threads", sched.threads),
                    ("cls", mach.cls)):
        if int(x) < 1:
            raise NotImplementedError(f"the CUDA classify needs {name} >= 1")
    d[D_DIV_CHUNK:D_DIV_CHUNK + DIV_SIZE] = div_record(sched.chunk)
    d[D_DIV_THREADS:D_DIV_THREADS + DIV_SIZE] = div_record(sched.threads)
    d[D_DIV_CLS:D_DIV_CLS + DIV_SIZE] = div_record(mach.cls)
    d[D_DIV_A2:D_HEADER] = div_record(1) * ((D_HEADER - D_DIV_A2) // DIV_SIZE)
    if nt.tri:
        _tri_header(nt, d)
    for l in range(MAX_DEPTH):
        # a triangular nest's body sizes depend on v0 (acc is -1)
        d[D_ACC + l] = 1 if nt.tri else int(v["acc"][l])
        d[D_TRIPS + l] = int(v["trips"][l])
        d[D_STARTB + l] = int(v["startb"][l])
        d[D_SC + l] = int(t.start_coeffs[l])
        d[D_LSTART + l] = nt.nest.loops[l].start if l < depth else 0
        d[D_LSTEP + l] = nt.nest.loops[l].step if l < depth else 1
        if l < depth and d[D_ACC + l] < 1:
            raise NotImplementedError(
                f"the CUDA classify needs positive body sizes, level {l} "
                f"has {d[D_ACC + l]}"
            )
        # levels below the nest's depth are never divided by
        acc_l, step_l = (d[D_ACC + l], d[D_LSTEP + l]) if l < depth else (1, 1)
        a, s = D_DIV_ACC + l * DIV_SIZE, D_DIV_STEP + l * DIV_SIZE
        d[a:a + DIV_SIZE] = div_record(acc_l)
        d[s:s + DIV_SIZE] = div_record(step_l)
    d[D_OFF_LC] = len(d)
    d += [int(x) for x in v["lc"]]
    d[D_OFF_REFS] = len(d)
    for j in range(t.n_refs):
        off = (_tri_ref_offset(nt.nest, nt.nest.refs[j]) if nt.tri
               else int(v["off"][j]))
        d += [off, *(int(c) for c in v["coeff"][j]),
              int(v["const"][j]), int(v["thr"][j]),
              int(t.ref_share_ratios[j]), int(t.ref_levels[j])]
    if nt.tri:
        d[D_OFF_POST] = len(d)
        d += [int(r.slot == "post") for r in nt.nest.refs]
    d[D_OFF_GROUPS] = len(d)
    groups = descriptor_groups(nt, ref_idx)
    d[D_NGROUPS] = len(groups)
    for s0, sinks in groups:
        nz = _ref_vars_static(nt, s0)
        coeff = [int(c) for c in v["coeff"][s0]]
        node = band_plan(nt, s0, W)
        heads = []
        while node[0] == "head":
            _, l, n_u, child = node
            rest = nz[len(heads) + 1:]
            heads.append([
                l, n_u, *div_record(coeff[l]),
                sum(coeff[lr] * int(v["vlo"][lr]) for lr, _ in rest),
                sum(coeff[lr] * int(v["vhi"][lr]) for lr, _ in rest),
            ])
            node = child
        if node[0] == "check":
            term, tlevel, tw = TERM_CHECK, 0, 0
        elif node[0] == "interval":
            term, tlevel, tw = TERM_INTERVAL, node[1], 0
        else:
            term, tlevel, tw = TERM_WINDOW, node[1], node[2]
        rec = [len(sinks), int(t.ref_levels[s0]), len(heads), term, tlevel,
               tw, int(v["const"][s0])]
        for k in range(MAX_DEPTH):
            rec += heads[k] if k < len(heads) else [0, 0, *div_record(1), 0, 0]
        d += rec + list(sinks)
    return np.asarray(d, dtype=np.int64)


def desc_form(desc: np.ndarray) -> str:
    """The launch form that carries this descriptor: "param" (a kernel
    parameter) up to MAX_DESC words, else "buffer" (a device buffer,
    `device_descriptor`)."""
    return "param" if len(desc) <= MAX_DESC else "buffer"


def device_descriptor(desc, device) -> torch.Tensor | None:
    """The buffer form's copy of `desc` on `device` (a CUDA device), made
    once per bucket or shard body beside the descriptor; None where the
    parameter form carries it or the device is not a card."""
    if desc is None or torch.device(device).type != "cuda" or (
            desc_form(desc) == "param"):
        return None
    return torch.as_tensor(desc, device=device)


def max_heads(desc: np.ndarray) -> int:
    """The most band-plan heads of any sink group of the descriptor."""
    nh, g = 0, int(desc[D_OFF_GROUPS])
    for _ in range(int(desc[D_NGROUPS])):
        nh = max(nh, int(desc[g + 2]))
        g += G_FIXED + int(desc[g])
    return nh


def instantiation(desc: np.ndarray) -> tuple[int, int, bool]:
    """(LV, NHMAX, TRI) of the kernel instantiation that serves this
    descriptor, as csrc/sampled_hist.cu's launch picks it: the source
    ref's level, 1 where no group has more than one head, else 3, and
    whether the nest is triangular."""
    return (int(desc[D_LV]), 1 if max_heads(desc) <= 1 else 3,
            bool(desc[D_TRI]))


def rows_matrix(descs) -> np.ndarray:
    """The per-row form's descriptors: int64 [R, W], row r descs[r]
    zero-padded to W, the longest row's words."""
    W = max(len(d) for d in descs)
    out = np.zeros((len(descs), W), dtype=np.int64)
    for r, d in enumerate(descs):
        out[r, :len(d)] = d
    return out


def rows_instantiation(descs) -> tuple[int, int, bool]:
    """(LV, NHMAX, TRI) of the one instantiation a per-row launch over
    these descriptors takes: the rows' common source-ref level and nest
    kind, NHMAX the most over the rows. Raises ValueError where the
    rows' levels or nest kinds differ (rows of one kernel signature
    never do)."""
    insts = {(int(d[D_LV]), bool(d[D_TRI])) for d in descs}
    if len(insts) != 1:
        raise ValueError(f"per-row form: rows of different levels or nest "
                         f"kinds {sorted(insts)} share no instantiation")
    (lv, tri), = insts
    return lv, 1 if max(max_heads(d) for d in descs) <= 1 else 3, tri


def tri_rows(nts, device) -> torch.Tensor | None:
    """The per-row form's base tables: int64 [R, W] on `device`, row r
    nts[r]'s tri_table flattened and zero-padded to the longest; None
    for rectangular rows."""
    if not nts[0].tri:
        return None
    flat = [np.ascontiguousarray(nt.tri_base, np.int64).ravel()
            for nt in nts]
    return torch.as_tensor(rows_matrix(flat), device=device)


def tri_table(nt, device) -> torch.Tensor | None:
    """A triangular nest's base table as the kernel reads it: int64
    [threads, lmax + 1], contiguous, on `device`; None for a rectangular
    nest."""
    if not nt.tri:
        return None
    return torch.as_tensor(np.ascontiguousarray(nt.tri_base, np.int64),
                           device=device)


# ops_per_sample's cost model, in 32-bit integer instruction issues: an
# add, subtract, compare, min, max, select, logical op or shift costs one
# per 32-bit word of its operands (_words); a multiply or multiply-add of
# 32-bit factors costs one, also into a 64-bit sum (IMAD, IMAD.WIDE);
# a multiply-high of 64-bit operands four (its 32x32 partial products).
# Per level kind of a band candidate's box (nextuse.py::_LevelSpec):
_MIN_GE = {"fixed": 3, "interval": 3, "free": 2}  # smallest element >= x
_HAS = {"fixed": 2, "interval": 2, "free": 1}  # x in the box
_MIN_VAL = {"fixed": 1, "interval": 2, "free": 0}  # smallest element


def _words(lo: int, hi: int) -> int:
    """32-bit words a value in [lo, hi] needs: 1 or 2."""
    return 1 if -(1 << 31) <= lo and hi < 1 << 31 else 2


def _div(d: int, w: int, signed: bool) -> int:
    """Issues of floor(a / d) for an a of w words and a divisor d fixed
    per launch (the division record's arithmetic): nothing for |d| = 1, a
    shift for a power of two (an arithmetic shift is the floor for either
    sign), else a multiply-high and a shift, plus the sign fold in and out
    where a may be negative; a negative d adds the negation (and the
    remainder test and correction of -ceil where |d| is no power of
    two)."""
    e = abs(int(d))
    if e == 1:
        ops = 0
    elif e & (e - 1) == 0:
        ops = w
    else:
        ops = (1 if w == 1 else 4) + w + (3 * w if signed else 0)
    if d < 0:
        ops += w if e & (e - 1) == 0 else 3 * w
    return ops


def _ranges(d: np.ndarray) -> tuple[int, int, bool]:
    """(words of a position, words of a byte address, whether an address
    may be negative) over the descriptor's loop bounds and refs."""
    depth = int(d[D_DEPTH])
    acc0 = int(d[D_ACC])
    lc = d[int(d[D_OFF_LC]):int(d[D_OFF_LC]) + int(d[D_THREADS])]
    pos_hi = (int(lc.max()) + 1) * acc0
    vals = []
    for l in range(depth):
        a = int(d[D_LSTART + l])
        b = a + (int(d[D_TRIPS + l]) - 1) * int(d[D_LSTEP + l])
        vals.append((min(a, b), max(a, b)))
    lo = hi = 0
    refs = d[int(d[D_OFF_REFS]):int(d[D_OFF_GROUPS])].reshape(-1, R_SIZE)
    for r in refs:
        rl = rh = int(r[4])
        for l in range(int(r[7]) + 1):
            c = int(r[1 + l])
            rl += min(c * vals[l][0], c * vals[l][1])
            rh += max(c * vals[l][0], c * vals[l][1])
        lo, hi = min(lo, rl), max(hi, rh)
    ds = int(d[D_DS])
    return _words(0, pos_hi), _words(lo * ds, hi * ds), lo < 0


def _split_free(d: np.ndarray, lv: int) -> bool:
    """Whether min_position_after's split of p0 (m0, r0, j0, rr0) follows
    from the sample's own indices for every ref of level lv: m0 is its
    parallel index and j0 its level-1 index (at lv >= 1) when its offset
    keeps r0 in [0, acc0) and rr0 in [0, acc1); at lv 0, j0 and rr0 are
    constants of the ref. Then no division is needed."""
    acc = [int(x) for x in d[D_ACC:D_ACC + MAX_DEPTH]]
    trips = [int(x) for x in d[D_TRIPS:D_TRIPS + MAX_DEPTH]]
    npre = [int(d[D_NPRE0]), int(d[D_NPRE1])]
    refs = d[int(d[D_OFF_REFS]):int(d[D_OFF_GROUPS])].reshape(-1, R_SIZE)
    for r in refs:
        if int(r[7]) != lv:
            continue
        rr_lo = int(r[0]) + (npre[1] if lv >= 2 else 0)
        rr_hi = rr_lo + ((trips[2] - 1) * acc[2] if lv >= 2 else 0)
        if lv >= 1 and not 0 <= rr_lo <= rr_hi < acc[1]:
            return False
        r0_lo = rr_lo + (npre[0] if lv >= 1 else 0)
        r0_hi = rr_hi + (npre[0] + (trips[1] - 1) * acc[1] if lv >= 1 else 0)
        if not 0 <= r0_lo <= r0_hi < acc[0]:
            return False
    return True


def ops_per_sample(desc: np.ndarray, highs) -> int:
    """32-bit integer instruction issues that the classify of one
    masked-in sample of this descriptor and these (padded) radices needs,
    as a lower bound for kernel B1 (the cost model above). Every value is
    taken at the narrowest width it needs: positions, ri and a key above
    2^31 are 64-bit where their range says so (`_ranges`); loop indices
    and values, box bounds, head values and band starts are 32-bit.
    Constants of the launch or of a ref (coefficient products with ds,
    offsets plus npre) are folded on the host and cost nothing.

    Per sample: the unsigned decode (keys lie in [0, prod(highs)), so the
    outermost digit is the last quotient), the schedule's owner and local
    index, the loop values, the line, p0 and its split (no division where
    `_split_free`). Per sink group: the band start, each head's bounds
    (two signed divisions) and values; per band candidate its level box
    and the member-free parts of strategies A, B and C; per member the
    end of the walk; last the share test, the packed key and the bin.
    The per-member level-2 step of strategy C runs only where the
    sample's own position lies in the candidate's box, which depends on
    the data, so it is not counted, nor are loop control, loads and the
    histogram's atomics. GEMM's four signatures at N=2048, ratio 0.1
    (radices 2047) count 441 ({C0,C1}), 245 ({A0}), 227 ({B0}) and 452
    ({C2,C3}) issues. A triangular descriptor's count depends on the
    data: `tri_issues`."""
    d = desc
    if int(d[D_TRI]):
        raise ValueError("a triangular descriptor's issues: tri_issues")
    lv = int(d[D_LV])
    h = [int(x) for x in highs]
    P, aw, aneg = _ranges(d)
    chunk, threads = int(d[D_DIV_CHUNK]), int(d[D_DIV_THREADS])
    sched = _div(chunk, 1, False) + _div(threads, 1, False) + 3
    span = h[0] * h[1] * h[2]
    ops = 0
    for k in (2, 1):  # the quotient and the digit
        if h[k] > 1:
            ops += _div(h[k], _words(0, span - 1), False) + 1
        span //= h[k]
    ops += sched + 2 * (1 + lv)  # owner, local, loop values, flat index
    ops += _div(int(d[D_DIV_CLS]), aw, aneg)  # the line
    ops += 1 + lv  # p0
    if _split_free(d, lv):
        ops += lv  # r0, rr0 as index sums
    else:
        ops += (_div(int(d[D_ACC]), P, False) + 1 + 1
                + _div(int(d[D_ACC + 1]), 1, True) + 1)
    g = int(d[D_OFF_GROUPS])
    groups = []
    for _ in range(int(d[D_NGROUPS])):
        groups.append(g)
        g += G_FIXED + int(d[g])
    inner = any(int(d[g + 1]) >= 1 for g in groups)
    ops += 1 + P + (1 + P if inner else 0)  # m0 + 1, p0 - r0; j0 + 1, p0 - rr0
    for g in groups:
        nm, sl, nh, term, tl, tw = (int(x) for x in d[g:g + 6])
        heads = [g + G_FIXED - MAX_DEPTH * H_SIZE + k * H_SIZE
                 for k in range(nh)]
        kinds = ["free"] * (sl + 1)
        for hd in heads:
            kinds[int(d[hd])] = "fixed"
        if term == TERM_WINDOW:
            kinds[tl] = "fixed"
        elif term == TERM_INTERVAL:
            kinds[tl] = "interval"
        ops += 1  # the band start
        n_emit = 1
        for hd in heads:  # bounds, then per value: u, lo, the in-band test
            ops += n_emit * (2 * _div(int(d[hd + 2]), 1, True) + 3)
            n_emit *= int(d[hd + 1])
            ops += n_emit * 4
        if term == TERM_WINDOW:
            n_emit *= tw
        cand = {TERM_CHECK: 3, TERM_WINDOW: 1}.get(term, 0)
        for l, kind in enumerate(kinds):
            if kind == "fixed":  # normalize, on the grid, in range
                step = int(d[D_LSTEP + l])
                cand += 1 + _div(step, 1, True) + 2 + (abs(step) > 1) * 3
                if l == 0:  # the owner is the sample's thread
                    cand += sched + 2
            elif kind == "interval":
                cand += 5
        cand += _MIN_GE[kinds[0]] + _HAS[kinds[0]]  # mA, mB
        if sl == 0:
            cand += (2 + P) + P + 1  # A's position, its minimum, C exists
        else:
            cand += (_MIN_VAL[kinds[2]] if sl == 2 else 0) + _MIN_VAL[kinds[1]]
            cand += 3 * sl + 2 + P  # A's position
            cand += _MIN_GE[kinds[1]] + 3 * sl - 1 + 2 * P  # B's, if mB
            cand += 2 * P  # the two minima
            cand += _HAS[kinds[1]] + 1 + (sl == 1)  # C exists
        ops += n_emit * cand + nm * (6 * P + 3)
    return ops + 9 * P + 11 + (3 if P == 2 else 1)


# A division by a divisor that varies per sample (the triangular walk's
# level-1 body size): the least a 64-bit numerator by a 32-bit divisor
# takes, a reciprocal estimate, a multiply-high, the multiply back and two
# corrections, in 32-bit issues (the compiler's routine issues more).
_VAR_DIV = 20


def band_hits(nt, ref_idx: int, keys, mask, highs) -> list[tuple[int, int]]:
    """Per descriptor group (`descriptor_groups`) of a triangular source
    ref, over the chosen lanes
    of `keys` (every lane where `mask` is None): (band candidates in the
    band, iterations the walk visits without a later search), the two
    counts of the triangular walk that depend on the data
    (`tri_issues`). A candidate whose level 0 is fixed visits its
    iteration only where the sample's thread owns it; one with a free
    level 0 visits the sample's own iteration and searches a later one
    (the later visit is not counted: it depends on the search)."""
    from ..sampler.nextuse import _band_candidates
    from ..sampler.sampled import _sample_geometry, decode_sample_keys

    tnt = nt.with_vals(torch_vals(nt.vals, keys.device))
    if mask is not None:
        keys = keys[mask]
    tid, _, line, _ = _sample_geometry(tnt, ref_idx,
                                       decode_sample_keys(keys, highs))
    sched, W = nt.schedule, nt.machine.lines_per_element_block
    start0, trip0 = nt.nest.loops[0].start, nt.nest.loops[0].trip
    out = []
    for s0, _members in descriptor_groups(nt, ref_idx):
        n = [0, 0]

        def emit(fixed_vals, ok):
            n[0] += int(ok.sum())
            if 0 in fixed_vals:
                n0 = fixed_vals[0][1] - start0
                ok = ok & (n0 >= 0) & (n0 < trip0) & (
                    sched.owner_tid(n0) == tid)
            n[1] += int(ok.sum())

        _band_candidates(tnt, s0, line * W, W,
                         torch.ones_like(tid, dtype=torch.bool), emit)
        out.append((n[0], n[1]))
    return out


def tri_issues(nt, desc: np.ndarray, highs, n_samples: int,
               hits: list[tuple[int, int]]) -> int:
    """32-bit integer issues that the triangular walk of `n_samples`
    samples needs, in ops_per_sample's cost model, with the parts that
    depend on the data from `band_hits`: per sample the decode, schedule,
    values and line, the level-1 body, offset and position in its
    iteration, that position's split (a division by the body,
    `_VAR_DIV`), the share test and bin; per group the band enumeration
    (as ops_per_sample), every candidate's in-band test and the members'
    best; per in-band candidate its domains and either the owner test
    (level 0 fixed) or the later-iteration search (halfspaces,
    count_below, local_to_value); per visited iteration the split (but in
    the sample's own), the domain bounds and each member's position. The
    visit of the later iteration a search finds is not counted."""
    d = desc
    lv, depth = int(d[D_LV]), int(d[D_DEPTH])
    h = [int(x) for x in highs]
    P = _words(0, int(nt.tri_base.max()) + nt.max_body0)
    chunk, threads = int(d[D_DIV_CHUNK]), int(d[D_DIV_THREADS])
    sched = _div(chunk, 1, False) + _div(threads, 1, False) + 3
    span = h[0] * h[1] * h[2]
    ops = 0
    for k in (2, 1):  # the unsigned decode, as ops_per_sample
        if h[k] > 1:
            ops += _div(h[k], _words(0, span - 1), False) + 1
        span //= h[k]
    ops += sched + 2 * (1 + lv) + _div(int(d[D_DIV_CLS]), 2, True)
    post = d[int(d[D_OFF_POST]):int(d[D_OFF_POST]) + int(d[D_NREFS])]
    ops += ((3 if depth > 2 else 0) + 1 + 3 * int(post.any())  # body, offset
            + P + 2 * lv)  # p0
    split = _VAR_DIV + 2 * P if depth > 1 else 0
    ops += split + 9 * P + 11 + (3 if P == 2 else 1)  # share test, key, bin
    total = n_samples * ops
    g = int(d[D_OFF_GROUPS])
    for inband, visits in hits:
        nm, sl, nh, term, tl, tw = (int(x) for x in d[g:g + 6])
        heads = [g + G_FIXED - MAX_DEPTH * H_SIZE + k * H_SIZE
                 for k in range(nh)]
        fixed0 = (any(int(d[hd]) == 0 for hd in heads)
                  or (term == TERM_WINDOW and tl == 0))
        enum, n_emit = 1, 1
        for hd in heads:
            enum += n_emit * (2 * _div(int(d[hd + 2]), 1, True) + 3)
            n_emit *= int(d[hd + 1])
            enum += n_emit * 4
        if term == TERM_WINDOW:
            n_emit *= tw
        enum += n_emit + nm * 2 * P  # in-band tests, the members' best
        cand = sl + 1 + (4 + sched if fixed0 else 9 * sl + 25)
        member = ((3 * P + 2) if sl == 0 else (2 * P + 6) if sl == 1
                  else (4 * P + 12 + _div(int(d[D_DIV_A2]), 1, True)))
        visit = 4 * sl + nm * member
        own = 0 if fixed0 else inband  # visits of the sample's iteration
        total += (n_samples * enum + inband * cand + visits * visit
                  + (visits - own) * (split if sl else 0))
        g += G_FIXED + nm
    return total


def torch_vals(vals: dict, device) -> dict:
    """The value overlay of a NestTrace as int64 tensors on `device`."""
    return {
        k: torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)
        for k, x in vals.items()
    }


def exp2_floor(x):
    """floor(log2 x) of int64 x >= 1, exact (a 6-step binary search on
    shifts; a float log2 is inexact above 2^53)."""
    e = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        y = x >> s
        big = y > 0
        e += big.to(torch.int64) * s
        x = torch.where(big, y, x)
    return e


def sampled_hist_plain(nt, ref_idx: int, keys_RB, mask_RB, highs, rx_R,
                       raw: bool = False):
    """Plain torch version: the tensor classify
    (sampler/sampled.py::classify_samples), then the same
    residual/histogram/cold split as the kernel (`raw`: the raw-noshare
    form, nothing binned)."""
    from ..sampler.sampled import classify_samples, decode_sample_keys

    dev = keys_RB.device
    tnt = nt.with_vals(torch_vals(nt.vals, dev))
    R = keys_RB.shape[0]
    residual = torch.empty_like(keys_RB)
    hist = torch.zeros((R, N_BINS), dtype=torch.int64, device=dev)
    cold = torch.zeros(R, dtype=torch.int64, device=dev)
    for r in range(R):
        keys = keys_RB[r]
        lanes = None
        if mask_RB is not None:
            # classify the chosen lanes only: an unchosen lane's
            # residual is SENTINEL and it counts in neither hist nor cold
            lanes = mask_RB[r].nonzero().squeeze(1)
            residual[r] = SENTINEL
            if lanes.numel() == 0:
                continue
            keys = keys[lanes]
        samples = decode_sample_keys(keys, highs)
        packed, ri, is_share, found = classify_samples(
            tnt, ref_idx, samples, rx_R[r]
        )
        nosh = found & ~is_share & (ri >= 1) & (not raw)
        res = torch.where(found & ~nosh, packed, SENTINEL)
        if lanes is None:
            residual[r] = res
        else:
            residual[r, lanes] = res
        hist[r] = torch.bincount(exp2_floor(ri[nosh]), minlength=N_BINS)
        cold[r] = (~found).sum()
    return residual, hist, cold


def sampled_hist_rows_plain(nts, ref_idxs, keys_RB, mask_RB, highs_rows,
                            rx_R, raw: bool = False):
    """Plain version of the per-row form: row r is sampled_hist_plain of
    its own nest nts[r], source ref ref_idxs[r], radices highs_rows[r] and
    value index rx_R[r]."""
    R = keys_RB.shape[0]
    outs = [
        sampled_hist_plain(
            nts[r], ref_idxs[r], keys_RB[r:r + 1],
            None if mask_RB is None else mask_RB[r:r + 1], highs_rows[r],
            rx_R[r:r + 1], raw)
        for r in range(R)
    ]
    return tuple(torch.cat([o[i] for o in outs]) for i in range(3))


_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 4
)


def _check(name, x, dtype, shape, dev, ld=None):
    """Raise unless x is `dtype` of `shape` on `dev`, contiguous, or with
    `ld` given, rows of contiguous lanes `ld` elements apart."""
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)}, got {x.dtype} "
            f"{tuple(x.shape)}"
        )
    if x.device != dev:
        raise ValueError(f"{name}: must be on {dev}, got {x.device}")
    if ld is None:
        if not x.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    elif x.shape[1] > 1 and x.stride(1) != 1 or (
            x.shape[0] > 1 and x.stride(0) != ld):
        raise ValueError(f"{name}: rows must be contiguous and {ld} "
                         f"elements apart, got strides {x.stride()}")


_ARGTYPES_BUF = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 4
)


def sampled_hist_cuda(nt, ref_idx: int, keys_RB, mask_RB, highs, rx_R,
                      desc=None, tri_base=None, raw: bool = False,
                      desc_dev=None, form: str | None = None):
    """Launch csrc/sampled_hist.cu on the current stream; raises on any
    argument the kernel does not take or a launch error. keys_RB (and
    mask_RB, with the same strides) may be a column span of a wider
    [R, B'] buffer: rows of contiguous lanes, a fixed stride apart. `desc` is
    build_descriptor's output, a host int64 array (built here when None).
    `form` (None: `desc_form`'s) picks the launch: "param" passes the
    descriptor by value and launches the instantiation of its source-ref
    level desc[D_LV], most heads per group and nest kind; "buffer" reads
    it from `desc_dev`, its `device_descriptor` copy (uploaded here when
    None), through the instantiation of its level and nest kind with up
    to three heads. `tri_base` is a triangular nest's `tri_table` on the
    keys' device (made here when None). `raw` launches the raw-noshare
    form."""
    global LAUNCHES, BUFFER_LAUNCHES
    from . import _build

    dev = keys_RB.device
    if dev.type != "cuda":
        raise ValueError(f"sampled_hist_cuda needs CUDA tensors, got {dev}")
    R, B = keys_RB.shape
    # rows may be a column span of a wider buffer (the device draw's)
    ld = keys_RB.stride(0) if R > 1 else B
    _check("keys", keys_RB, torch.int64, (R, B), dev, ld)
    if mask_RB is not None:
        _check("mask", mask_RB, torch.bool, (R, B), dev, ld)
    _check("rx", rx_R, torch.int64, (R,), dev)
    hrec = radix_records(highs)
    if desc is None:
        desc = build_descriptor(nt, ref_idx)
    if not (isinstance(desc, np.ndarray) and desc.dtype == np.int64
            and desc.ndim == 1 and desc.flags.c_contiguous):
        raise ValueError("desc: expected build_descriptor's int64 array")
    form = form or desc_form(desc)
    if form == "param" and len(desc) > MAX_DESC:
        raise ValueError(f"desc: {len(desc)} words exceed the parameter "
                         f"form's {MAX_DESC}")
    if form == "buffer":
        if desc_dev is None:
            desc_dev = torch.as_tensor(desc, device=dev)
        _check("desc_dev", desc_dev, torch.int64, desc.shape, dev)
    elif form != "param":
        raise ValueError(f"unknown form {form!r}")
    if nt.tri:
        if tri_base is None:
            tri_base = tri_table(nt, dev)
        _check("tri_base", tri_base, torch.int64, nt.tri_base.shape, dev)
    elif tri_base is not None:
        raise ValueError("tri_base: a rectangular nest has none")
    if form == "param":
        fn = _build.load("sampled_hist").sampled_hist_launch
        fn.argtypes = _ARGTYPES
    else:
        fn = _build.load("sampled_hist_buf").sampled_hist_launch_buf
        fn.argtypes = _ARGTYPES_BUF
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        residual = torch.empty_like(keys_RB)
        hist = torch.zeros((R, N_BINS), dtype=torch.int64, device=dev)
        cold = torch.zeros(R, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        mask_ptr = None if mask_RB is None else mask_RB.data_ptr()
        tri_ptr = None if tri_base is None else tri_base.data_ptr()
        head = (keys_RB.data_ptr(), mask_ptr, R, B, ld, desc.ctypes.data,
                desc.shape[0])
        if form == "buffer":
            head += (desc_dev.data_ptr(),)
        rc = fn(*head, hrec.ctypes.data, rx_R.data_ptr(), tri_ptr, int(raw),
                residual.data_ptr(), hist.data_ptr(), cold.data_ptr(),
                stream)
        if rc != 0:
            raise RuntimeError(f"sampled_hist_launch ({form} form) failed: "
                               f"CUDA error {rc}")
        LAUNCHES += 1
        BUFFER_LAUNCHES += form == "buffer"
    return residual, hist, cold


_ARGTYPES_ROWS = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
    + [ctypes.c_void_p] * 4
)


def rows_radix_records(highs_rows) -> np.ndarray:
    """The per-row form's radix records: int64 [R, MAX_DEPTH * DIV_SIZE],
    row r radix_records(highs_rows[r])."""
    return np.stack([radix_records(h) for h in highs_rows])


def sampled_hist_rows_cuda(nts, ref_idxs, keys_RB, mask_RB, highs_rows,
                           rx_R, descs=None, descs_dev=None, tris=None,
                           raw: bool = False, hrs_dev=None):
    """Launch the per-row form (csrc/sampled_hist.cu's
    sampled_hist_launch_rows1 or _rows3) on the current stream: row r
    with its own descriptor, radix records and base table. keys_RB and
    mask_RB as in sampled_hist_cuda. `descs` is the rows' rows_matrix
    (built here from build_descriptor(nts[r], ref_idxs[r]) when None),
    `descs_dev` its copy on the keys' device, `tris` the rows' tri_rows,
    `hrs_dev` their rows_radix_records on the device (each made here
    when None; a caller launching the same rows again makes them once).
    Raises on a mismatch of the rows' instantiations, any argument the
    kernel does not take, or a launch error."""
    global LAUNCHES, ROWS_LAUNCHES
    from . import _build

    dev = keys_RB.device
    if dev.type != "cuda":
        raise ValueError(f"sampled_hist_rows_cuda needs CUDA tensors, got "
                         f"{dev}")
    R, B = keys_RB.shape
    if not len(nts) == len(ref_idxs) == len(highs_rows) == R:
        raise ValueError("per-row form: one nest, ref and radices per row")
    ld = keys_RB.stride(0) if R > 1 else B
    _check("keys", keys_RB, torch.int64, (R, B), dev, ld)
    if mask_RB is not None:
        _check("mask", mask_RB, torch.bool, (R, B), dev, ld)
    _check("rx", rx_R, torch.int64, (R,), dev)
    if descs is None:
        descs = rows_matrix([build_descriptor(nt, ri)
                             for nt, ri in zip(nts, ref_idxs)])
    if not (isinstance(descs, np.ndarray) and descs.dtype == np.int64
            and descs.ndim == 2 and descs.shape[0] == R
            and descs.flags.c_contiguous):
        raise ValueError("descs: expected rows_matrix's int64 [R, W] array")
    _lv, nh, tri = rows_instantiation(descs)
    if descs_dev is None:
        descs_dev = torch.as_tensor(descs, device=dev)
    _check("descs_dev", descs_dev, torch.int64, descs.shape, dev)
    if hrs_dev is None:
        hrs_dev = torch.as_tensor(rows_radix_records(highs_rows), device=dev)
    _check("hrs_dev", hrs_dev, torch.int64, (R, MAX_DEPTH * DIV_SIZE), dev)
    if tri:
        if tris is None:
            tris = tri_rows(nts, dev)
        W = max(nt.tri_base.size for nt in nts)
        _check("tris", tris, torch.int64, (R, W), dev)
    elif tris is not None:
        raise ValueError("tris: rectangular rows have none")
    # the library's part of the rows' head-count class
    fn = getattr(_build.load("sampled_hist_buf"),
                 f"sampled_hist_launch_rows{nh}")
    fn.argtypes = _ARGTYPES_ROWS
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        residual = torch.empty((R, B), dtype=torch.int64, device=dev)
        hist = torch.zeros((R, N_BINS), dtype=torch.int64, device=dev)
        cold = torch.zeros(R, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(keys_RB.data_ptr(),
                None if mask_RB is None else mask_RB.data_ptr(), R, B, ld,
                descs.ctypes.data, descs.shape[1], descs_dev.data_ptr(),
                hrs_dev.data_ptr(), rx_R.data_ptr(),
                None if tris is None else tris.data_ptr(),
                0 if tris is None else tris.shape[1], int(raw),
                residual.data_ptr(), hist.data_ptr(), cold.data_ptr(),
                stream)
        if rc != 0:
            raise RuntimeError(f"sampled_hist_launch_rows failed: CUDA "
                               f"error {rc}")
        LAUNCHES += 1
        ROWS_LAUNCHES += 1
    return residual, hist, cold


def sampled_hist_rows(nts, ref_idxs, keys_RB, mask_RB, highs_rows, rx_R,
                      backend: str = "auto", descs=None, descs_dev=None,
                      tris=None, raw: bool = False, hrs_dev=None):
    """(residual[R,B], hist[R,64], cold[R]) of the per-row form, as
    sampled_hist picks: the plain version for CPU tensors under "auto"
    and under "torch", else the kernel (which raises on CPU tensors)."""
    if backend == "torch" or (
        backend == "auto" and keys_RB.device.type == "cpu"
    ):
        return sampled_hist_rows_plain(nts, ref_idxs, keys_RB, mask_RB,
                                       highs_rows, rx_R, raw)
    if backend not in ("auto", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    return sampled_hist_rows_cuda(nts, ref_idxs, keys_RB, mask_RB,
                                  highs_rows, rx_R, descs, descs_dev, tris,
                                  raw, hrs_dev)


def sampled_hist(nt, ref_idx: int, keys_RB, mask_RB, highs, rx_R,
                 backend: str = "auto", desc=None, tri_base=None,
                 raw: bool = False, desc_dev=None):
    """(residual[R,B], hist[R,64], cold[R]) for one bucket dispatch
    (`raw`: the raw-noshare form; `desc_dev`: the buffer form's device
    copy of `desc`, see sampled_hist_cuda).

    backend "torch" takes the plain version; "auto" takes it for tensors
    on the CPU and launches the kernel for CUDA tensors; "cuda" always
    launches the kernel (and so raises on CPU tensors)."""
    if backend == "torch" or (
        backend == "auto" and keys_RB.device.type == "cpu"
    ):
        return sampled_hist_plain(nt, ref_idx, keys_RB, mask_RB, highs, rx_R,
                                  raw)
    if backend not in ("auto", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    return sampled_hist_cuda(nt, ref_idx, keys_RB, mask_RB, highs, rx_R,
                             desc, tri_base, raw, desc_dev)
