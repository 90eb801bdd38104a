"""Closed-form next-use solver on tensors (rectangular nests).

Port of the JAX package's sampler/nextuse.py, rectangular solver only.
A sample's reuse is

    RI(sample) = min over same-array refs r' of
                 (first position p' > p0 in the sample thread's own
                  stream where r' touches the sample's cache line)
                 - p0

and for affine references in row-major arrays that first position has a
closed form: a tiny static set of band candidates (`band_plan`), each
reduced by mixed-radix successor arithmetic over a (fixed / interval /
free)^levels box (`min_position_after`). Every function here is
elementwise int64 tensor math over all samples at once; torch's `//`
and `%` floor like jnp's, which `_cdiv` and the schedule maps rely on.

The same walk, driven by a packed descriptor instead of Python
structure, is the CUDA kernel in csrc/sampled_hist.cu.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.trace import NestTrace

INF = 2**62


def _cdiv(a, b):
    """Ceil division for int arrays, exact for negative numerators."""
    return -((-a) // b)


@dataclasses.dataclass(frozen=True)
class _LevelSpec:
    """Domain of one loop level in a candidate: fixed to a value (with a
    validity mask), an interval [lo, hi) of normalized indices, or free
    over [0, bound)."""

    fixed: bool
    value: object = None  # int64 tensor when fixed
    valid: object = None  # bool tensor when fixed
    bound: object = None  # int64 tensor upper bound when free
    lo: object = None  # int64 tensor when interval
    hi: object = None  # int64 tensor when interval (empty if hi<=lo)

    @staticmethod
    def free(bound):
        return _LevelSpec(fixed=False, bound=bound)

    @staticmethod
    def fix(value, valid):
        return _LevelSpec(fixed=True, value=value, valid=valid)

    @staticmethod
    def interval(lo, hi):
        return _LevelSpec(fixed=False, lo=lo, hi=hi)

    def min_val(self, like):
        """Smallest element, INF-marked when empty/invalid."""
        if self.fixed:
            return torch.where(self.valid, self.value, INF)
        if self.lo is not None:
            return torch.where(self.lo < self.hi, self.lo, INF)
        return torch.zeros_like(like)

    def min_gt(self, x):
        """Smallest element > x, INF when none."""
        if self.fixed:
            ok = self.valid & (self.value > x)
            return torch.where(ok, self.value, INF)
        if self.lo is not None:
            nxt = torch.maximum(self.lo, x + 1)
            return torch.where(nxt < self.hi, nxt, INF)
        nxt = (x + 1).clamp(min=0)
        return torch.where(nxt < self.bound, nxt, INF)

    def eq(self, x):
        """x if x is in the domain, else INF."""
        if self.fixed:
            ok = self.valid & (self.value == x)
            return torch.where(ok, x, INF)
        if self.lo is not None:
            return torch.where((x >= self.lo) & (x < self.hi), x, INF)
        return torch.where((x >= 0) & (x < self.bound), x, INF)

    def min_scaled_gt(self, scale, x):
        """Smallest element v with v*scale > x, INF when none (scale>0)."""
        if self.fixed:
            ok = self.valid & (self.value * scale > x)
            return torch.where(ok, self.value, INF)
        if self.lo is not None:
            nxt = torch.maximum(self.lo, x // scale + 1)
            return torch.where(nxt < self.hi, nxt, INF)
        nxt = (x // scale + 1).clamp(min=0)
        return torch.where(nxt < self.bound, nxt, INF)


def min_position_after(nt: NestTrace, ref_idx: int, p0, specs):
    """Minimal position of `ref_idx` strictly after p0 over a level box.

    `specs`: list of _LevelSpec, one per level 0..ref.level. Positions
    follow core/trace.py::access_position. Returns INF where empty.
    """
    t = nt.tables
    lv = int(t.ref_levels[ref_idx])
    off = nt.vals["off"][ref_idx]
    a0 = nt.vals["acc"][0]
    np0, np1 = nt.npre[0], (nt.npre[1] if nt.nest.depth > 1 else 0)

    m0 = p0 // a0
    r0 = p0 - m0 * a0

    def pos(m, n1=None, n2=None):
        p = m * a0 + off
        if lv >= 1:
            p = p + np0 + n1 * nt.vals["acc"][1]
        if lv >= 2:
            p = p + np1 + n2 * nt.vals["acc"][2]
        return p

    def guard(p, *parts):
        bad = torch.zeros_like(p, dtype=torch.bool)
        for q in parts:
            bad = bad | (q >= INF)
        return torch.where(bad, INF, p)

    cands = []
    if lv == 0:
        # strategy A: bump m; strategy B: same m, later body offset
        mA = specs[0].min_gt(m0)
        cands.append(guard(pos(mA), mA))
        mB = specs[0].eq(m0)
        pB = guard(pos(mB), mB)
        cands.append(torch.where(pB > p0, pB, INF))
        return torch.minimum(*cands)

    a1 = nt.vals["acc"][1]
    j0 = (r0 - np0) // a1
    rr0 = r0 - np0 - j0 * a1

    if lv == 1:
        mA = specs[0].min_gt(m0)
        n1A = specs[1].min_val(p0)
        cands.append(guard(pos(mA, n1A), mA, n1A))
        mB = specs[0].eq(m0)
        n1B = specs[1].min_gt(j0)
        cands.append(guard(pos(mB, n1B), mB, n1B))
        mC = specs[0].eq(m0)
        n1C = specs[1].eq(j0)
        pC = guard(pos(mC, n1C), mC, n1C)
        cands.append(torch.where(pC > p0, pC, INF))
    else:
        a2 = nt.vals["acc"][2]
        mA = specs[0].min_gt(m0)
        n1A = specs[1].min_val(p0)
        n2A = specs[2].min_val(p0)
        cands.append(guard(pos(mA, n1A, n2A), mA, n1A, n2A))
        mB = specs[0].eq(m0)
        n1B = specs[1].min_gt(j0)
        n2B = specs[2].min_val(p0)
        cands.append(guard(pos(mB, n1B, n2B), mB, n1B, n2B))
        mC = specs[0].eq(m0)
        n1C = specs[1].eq(j0)
        # need np1 + n2*a2 + off > rr0
        n2C = specs[2].min_scaled_gt(a2, rr0 - np1 - off)
        pC = guard(pos(mC, n1C, n2C), mC, n1C, n2C)
        cands.append(torch.where(pC > p0, pC, INF))

    out = cands[0]
    for c in cands[1:]:
        out = torch.minimum(out, c)
    return out


# Per-level candidate cap for _band_candidates. Well-separated strides
# (the whole PolyBench family: n^2, n, 1, ...) give n_u <= W/c + 3, i.e.
# single digits at the default W=8; anything past this cap means the
# head coefficient does not dominate and the enumeration is not O(1).
_MAX_BAND_CANDIDATES = 128


def _ref_vars_static(nt: NestTrace, ref_idx: int):
    """Nonzero (level, concrete coeff) terms of a ref's flat map, coeff
    descending — the STRUCTURE of the band enumeration (the tensor
    math reads the coefficient values from nt.vals).

    The row-major PolyBench family always yields positive coefficients
    (strides n^2, n, 1 ...); negative strides have no closed-form band
    enumeration here and raise.
    """
    t = nt.tables
    lv = int(t.ref_levels[ref_idx])
    nz = [(l, int(t.ref_coeffs[ref_idx][l])) for l in range(lv + 1)
          if int(t.ref_coeffs[ref_idx][l]) != 0]
    for _, c in nz:
        if c <= 0:
            raise NotImplementedError(
                f"ref {t.ref_names[ref_idx]}: negative stride unsupported"
            )
    nz.sort(key=lambda p: -p[1])
    return nz


def band_plan(nt: NestTrace, sink_idx: int, W: int) -> tuple:
    """The static shape of one ref's band enumeration, from CONCRETE
    trace values: a nested tuple of nodes

      ("head", level, n_u, child)   enumerate n_u head-variable values
      ("interval", level)           unit-stride terminal, one interval
      ("window", level, W)          unit-stride terminal, W fixed values
      ("check",)                    constant-terminal band check

    _band_candidates follows this plan with tensor math; the kernel
    descriptor (ops/sampled_hist.py::build_descriptor) packs the same
    plan for the CUDA walk. It is the band component of the kernel
    signature (sampler/sampled.py::_kernel_sig).
    """
    nz = _ref_vars_static(nt, sink_idx)

    def node(vars_left):
        if not vars_left:
            return ("check",)
        if len(vars_left) == 1 and vars_left[0][1] == 1:
            l, _ = vars_left[0]
            if l != 0 and nt.nest.loops[l].step == 1:
                return ("interval", l)
            return ("window", l, W)
        (l, c), rest = vars_left[0], vars_left[1:]
        r_min = sum(cr * nt.level_value_range(lr)[0] for lr, cr in rest)
        r_max = sum(cr * nt.level_value_range(lr)[1] for lr, cr in rest)
        n_u = (W - 1 + (r_max - r_min)) // c + 2  # static bound
        if n_u > _MAX_BAND_CANDIDATES:
            # O(1) only holds when the head coefficient dominates the
            # residual span (true for row-major affine maps, strides
            # n^2 > n > 1); two comparable coefficients (flat = i + j)
            # would make n_u O(trip)
            raise NotImplementedError(
                f"ref {nt.tables.ref_names[sink_idx]}: head stride {c} "
                f"does not dominate the residual span "
                f"[{r_min}, {r_max}] ({n_u} band candidates > cap "
                f"{_MAX_BAND_CANDIDATES}); no O(1) closed-form band "
                "enumeration for this flat map"
            )
        return ("head", l, n_u, node(rest))

    return node(nz)


def _band_candidates(nt: NestTrace, sink_idx: int, lo, W: int, true_, emit):
    """Enumerate level-value assignments whose flat map lands in the
    band [lo, lo+W), following band_plan's static structure: each head
    value divides the residual band, the innermost unit-stride variable
    takes an exact W-wide window (one value-space interval where the
    level permits, W per-value candidates otherwise), and a trailing
    band check covers every other terminal. All numeric inputs (coeffs,
    const, value spans) come from nt.vals. `emit(fixed_vals, ok)`
    receives value-space encodings {level: ("fixval", u) |
    ("interval", va, vb)}.
    """
    plan = band_plan(nt, sink_idx, W)
    nz = _ref_vars_static(nt, sink_idx)
    coeff_v = {l: nt.vals["coeff"][sink_idx][l] for l, _ in nz}
    lo = lo - nt.vals["const"][sink_idx]
    vlo_v, vhi_v = nt.vals["vlo"], nt.vals["vhi"]

    def follow(pnode, vars_left, lo_cur, ok, fixed_vals):
        kind = pnode[0]
        if kind == "check":
            # remaining contribution is 0: valid iff 0 in [lo_cur, lo_cur+W)
            emit(fixed_vals, ok & (lo_cur <= 0) & (lo_cur > -W))
            return
        if kind == "interval":
            l = pnode[1]
            # one contiguous interval replaces W per-value candidates
            # (band membership by construction); level 0 is excluded
            # because thread ownership chops its range
            emit({**fixed_vals, l: ("interval", lo_cur, lo_cur + W)}, ok)
            return
        if kind == "window":
            l = pnode[1]
            for k in range(pnode[2]):  # exact window
                emit({**fixed_vals, l: ("fixval", lo_cur + k)}, ok)
            return
        _, l, n_u, child = pnode
        cv = coeff_v[l]
        rest = vars_left[1:]
        r_min = sum(coeff_v[lr] * vlo_v[lr] for lr, _ in rest)
        r_max = sum(coeff_v[lr] * vhi_v[lr] for lr, _ in rest)
        u_min = _cdiv(lo_cur - r_max, cv)
        u_max = (lo_cur + W - 1 - r_min) // cv
        for iu in range(n_u):
            u = u_min + iu
            follow(child, rest, lo_cur - cv * u, ok & (u <= u_max),
                   {**fixed_vals, l: ("fixval", u)})

    follow(plan, nz, lo, true_, {})


def next_use_candidates_group(
    nt: NestTrace, sinks: tuple, tid, p0, line
):
    """Min positions > p0 where each sink in `sinks` touches `line` on
    thread tid, for sinks sharing one flat map (level, coeffs, const) —
    only their body offsets differ, so the band candidates and level
    specs are built once and each sink pays only its own
    min_position_after reduction. Returns {sink_idx: positions}.

    Vectorized over samples (tid, p0, line are tensors). Band candidates
    come from _band_candidates; each is reduced with
    min_position_after over a (fixed/interval/free)^levels box.
    """
    sink_idx = sinks[0]
    t = nt.tables
    machine = nt.machine
    sched = nt.schedule
    lv = int(t.ref_levels[sink_idx])
    W = machine.lines_per_element_block

    # per-sample local-count bound for free level 0
    l_bound = nt.vals["lc"][tid]
    trips_v = nt.vals["trips"]

    def level_bound(l):
        return l_bound if l == 0 else trips_v[l]

    def spec_from_value(l, value, extra_valid):
        """Fix level l to loop *value* `value` (normalize + validate)."""
        lp = nt.nest.loops[l]
        n = (value - lp.start) // lp.step
        ok = extra_valid & ((value - lp.start) % lp.step == 0)
        ok = ok & (n >= 0) & (n < trips_v[l])
        if l == 0:
            ok = ok & (sched.owner_tid(n) == tid)
            return _LevelSpec.fix(sched.local_index(n), ok)
        return _LevelSpec.fix(n, ok)

    def assemble(fixed_vals, ok):
        """fixed_vals: value-space encodings; `ok` ANDs into each."""
        specs = []
        for l in range(lv + 1):
            if l in fixed_vals:
                kind = fixed_vals[l][0]
                if kind == "interval":
                    lp = nt.nest.loops[l]
                    _, va, vb = fixed_vals[l]
                    n_lo = (va - lp.start).clamp(min=0)
                    n_hi = torch.minimum(vb - lp.start, trips_v[l])
                    specs.append(_LevelSpec.interval(
                        n_lo, torch.where(ok, n_hi, n_lo)
                    ))
                else:
                    specs.append(spec_from_value(l, fixed_vals[l][1], ok))
            else:
                specs.append(_LevelSpec.free(level_bound(l)))
        return specs

    bests = {j: torch.full_like(p0, INF) for j in sinks}
    true_ = torch.ones_like(p0, dtype=torch.bool)

    def emit(fixed_vals, ok):
        specs = assemble(fixed_vals, ok)
        for j in sinks:
            p = min_position_after(nt, j, p0, specs)
            if not fixed_vals:  # constant ref: no spec carries validity
                p = torch.where(ok, p, INF)
            bests[j] = torch.minimum(bests[j], p)

    _band_candidates(nt, sink_idx, line * W, W, true_, emit)
    return bests
