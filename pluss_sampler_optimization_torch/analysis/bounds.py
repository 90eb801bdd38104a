"""Pass 3: static locality bounds (footprints, compulsory misses,
the MRC asymptote) and the runtime cross-checks against engine MRCs.

Two fidelity modes, chosen by total access count:

* **exact** (small domains): enumerate every flat index per ref with
  numpy, replicate the oracle's per-(nest, thread, array) last-access
  tables as distinct-line sets. `cold_model` then equals the engine's
  cold count *exactly* (oracle/serial.py flushes each surviving LAT
  line as one reuse==-1 event per nest), so `asymptote =
  cold_model / total_accesses` matches the MRC tail bit-for-bit
  (runtime/aet.py::_build_p seeds its accumulator with hist[-1]).
* **interval** (large domains, the preflight default above
  `exact_limit` accesses): per-ref line-footprint brackets from the
  affine form — an O(1) arithmetic-progression count along each axis
  gives a certified lower bound (a single-axis walk is a subset of the
  touched set), the span/iteration-count minimum an upper bound.

Either way `compulsory_lower` (per-array distinct lines over the whole
program) is a true lower bound on the engine's cold misses: every
distinct line must miss at least once, and the per-nest LAT flush only
ever *adds* cold misses beyond it.

`check_static_bounds(report, mrc)` turns these into violations a test
or the drift monitor can assert on; `drift_priors(report)` is the
compact per-model prior row fed alongside drift audits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..config import MachineConfig
from ..ir import Program
from .deps import AffineForm, normalized_form

# Above this many modeled accesses the exact numpy enumeration is
# skipped in favor of interval bounds (preflight must stay negligible
# next to engine time; 2^21 int64 grids are ~16 MB and low ms).
DEFAULT_EXACT_LIMIT = 1 << 21


@dataclasses.dataclass(frozen=True)
class RefBounds:
    """Static facts for one reference."""

    nest: int
    name: str
    array: str
    accesses: int  # exact modeled access count (trip product over domain)
    lines_lower: int  # certified lower bound on distinct cache lines
    lines_upper: int  # certified upper bound
    lines_exact: Optional[int]  # present in exact mode only

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class BoundsReport:
    """Program-wide locality bounds."""

    total_accesses: int
    exact: bool  # True when the numpy enumeration ran
    refs: tuple[RefBounds, ...]
    array_lines: dict  # array -> distinct lines (exact) or [lo, hi]
    compulsory_lower: int  # lower bound on engine cold misses
    cold_model: Optional[int]  # exact per-(nest,tid,array) cold count
    asymptote: Optional[float]  # cold_model / total_accesses

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["refs"] = [r.to_dict() for r in self.refs]
        return d


def _nest_access_counts(program: Program, nest_index: int) -> list[int]:
    """Exact per-ref access counts (handles triangular trips)."""
    nest = program.nests[nest_index]
    l0 = nest.loops[0]
    v0 = l0.start + l0.step * np.arange(l0.trip, dtype=np.int64)
    counts = []
    for r in nest.refs:
        prod = np.ones_like(v0)
        for k in range(1, r.level + 1):
            lp = nest.loops[k]
            prod = prod * np.maximum(0, lp.trip + lp.trip_coeff * v0)
        counts.append(int(prod.sum()))
    return counts


def _progression_lines(const: int, stride: int, count: int,
                       machine: MachineConfig) -> int:
    """Distinct lines of {(const + stride*u) * ds // cls : 0 <= u < count}
    in O(1): monotone progressions either advance a full line per step
    or sweep every line in their span."""
    if count <= 0:
        return 0
    ds, cls = machine.ds, machine.cls
    if stride == 0:
        return 1
    if abs(stride) * ds >= cls:
        return count
    first = const * ds // cls
    last = (const + stride * (count - 1)) * ds // cls
    return abs(last - first) + 1


def _axis_lower_bound(form: AffineForm, nest, machine: MachineConfig) -> int:
    """Certified lower bound on a ref's distinct lines: the best
    single-axis walk (every other counter pinned to a value where the
    axis is known non-empty) touches a subset of the ref's line set."""
    nvars = len(form.hull)
    l0 = nest.loops[0]

    def inner_trips(u0: int) -> list[int]:
        v0 = l0.start + l0.step * u0
        return [nest.loops[m].trip + nest.loops[m].trip_coeff * v0
                for m in range(1, nvars)]

    best = 0
    # u0 walk, inner counters at 0: a consecutive run of parallel
    # values whose every (triangular) inner level still executes
    for end in (0, l0.trip - 1):
        if all(t >= 1 for t in inner_trips(end)):
            run = _live_u0_run(nest, nvars, end)
            stride = form.coeffs[0] if end == 0 else -form.coeffs[0]
            base = form.const + form.coeffs[0] * end
            best = max(best, _progression_lines(base, stride, run, machine))
    # inner-axis walks at a parallel endpoint where all levels execute
    for u0 in (0, l0.trip - 1):
        trips = inner_trips(u0)
        if any(t < 1 for t in trips):
            continue
        base = form.const + form.coeffs[0] * u0
        for k in range(1, nvars):
            best = max(best, _progression_lines(
                base, form.coeffs[k], trips[k - 1], machine))
    return best


def _live_u0_run(nest, nvars: int, end: int) -> int:
    """Length of the consecutive run of u0 values, starting from the
    given end (0 or trip-1), where every inner triangular level has
    trip >= 1 (so the all-zero inner counter vector is in-domain)."""
    l0 = nest.loops[0]
    run = 0
    rng = range(l0.trip) if end == 0 else range(l0.trip - 1, -1, -1)
    for u0 in rng:
        v0 = l0.start + l0.step * u0
        if all(nest.loops[m].trip + nest.loops[m].trip_coeff * v0 >= 1
               for m in range(1, nvars)):
            run += 1
        else:
            break
    return run


def _span_upper_bound(form: AffineForm, accesses: int,
                      machine: MachineConfig) -> int:
    if accesses == 0:
        return 0
    lo = form.const + sum(min(0, c) * (u - 1)
                          for c, u in zip(form.coeffs, form.hull))
    hi = form.const + sum(max(0, c) * (u - 1)
                          for c, u in zip(form.coeffs, form.hull))
    span = hi * machine.ds // machine.cls - lo * machine.ds // machine.cls + 1
    return min(accesses, span)


def _enumerate_nest_lines(program: Program, nest_index: int,
                          machine: MachineConfig):
    """Exact per-ref line arrays plus per-(tid, array) distinct sets for
    one nest, mirroring oracle/serial.py's schedule and LAT keying."""
    nest = program.nests[nest_index]
    l0 = nest.loops[0]
    u0 = np.arange(l0.trip, dtype=np.int64)
    v0 = l0.start + l0.step * u0
    tid_of = (u0 // machine.chunk_size) % machine.thread_num
    ref_lines: list[np.ndarray] = []
    per_tid_array: dict[tuple[int, str], list[np.ndarray]] = {}
    for r in nest.refs:
        form = normalized_form(nest, r)
        shape = [l0.trip] + [max(1, u) for u in form.hull[1:]]
        flat = np.full(tuple(shape), form.const, dtype=np.int64)
        mask = np.ones(tuple(shape), dtype=bool)
        for k, c in enumerate(form.coeffs):
            uk = np.arange(shape[k], dtype=np.int64)
            sh = [1] * len(shape)
            sh[k] = shape[k]
            flat += c * uk.reshape(sh)
            if k >= 1:
                lp = nest.loops[k]
                trips = np.maximum(0, lp.trip + lp.trip_coeff * v0)
                sh0 = [1] * len(shape)
                sh0[0] = shape[0]
                mask &= uk.reshape(sh) < trips.reshape(sh0)
        lines = np.floor_divide(flat * machine.ds, machine.cls)
        ref_lines.append(lines[mask])
        for t in range(machine.thread_num):
            sel = tid_of == t
            if not sel.any():
                continue
            tl = lines[sel][mask[sel]]
            if tl.size:
                per_tid_array.setdefault((t, r.array), []).append(
                    np.unique(tl))
    return ref_lines, per_tid_array


def compute_bounds(program: Program, machine: MachineConfig,
                   exact_limit: int = DEFAULT_EXACT_LIMIT) -> BoundsReport:
    per_nest_counts = [_nest_access_counts(program, ni)
                       for ni in range(len(program.nests))]
    total = sum(sum(c) for c in per_nest_counts)
    exact = 0 < total <= exact_limit

    refs: list[RefBounds] = []
    array_sets: dict[str, list[np.ndarray]] = {}
    array_brackets: dict[str, list[int]] = {}
    cold_model: Optional[int] = 0 if exact else None

    for ni, nest in enumerate(program.nests):
        if exact:
            ref_lines, per_tid_array = _enumerate_nest_lines(
                program, ni, machine)
            for (t, a), chunks in per_tid_array.items():
                cold_model += int(np.unique(np.concatenate(chunks)).size)
        for ri, r in enumerate(nest.refs):
            form = normalized_form(nest, r)
            acc = per_nest_counts[ni][ri]
            if exact:
                uniq = np.unique(ref_lines[ri])
                n_lines = int(uniq.size)
                lo = hi = n_lines
                if uniq.size:
                    array_sets.setdefault(r.array, []).append(uniq)
            else:
                n_lines = None
                lo = _axis_lower_bound(form, nest, machine)
                hi = _span_upper_bound(form, acc, machine)
                lo = min(lo, hi)
            refs.append(RefBounds(
                nest=ni, name=r.name, array=r.array, accesses=acc,
                lines_lower=lo, lines_upper=hi, lines_exact=n_lines))
            if not exact:
                br = array_brackets.setdefault(r.array, [0, 0])
                br[0] = max(br[0], lo)
                br[1] += hi

    array_lines: dict = {}
    if exact:
        for a, chunks in array_sets.items():
            array_lines[a] = int(np.unique(np.concatenate(chunks)).size)
        for nest in program.nests:  # arrays with zero surviving accesses
            for r in nest.refs:
                array_lines.setdefault(r.array, 0)
        compulsory = sum(array_lines.values())
    else:
        for a, (lo, hi) in array_brackets.items():
            array_lines[a] = [lo, hi]
        compulsory = sum(lo for lo, _ in array_brackets.values())

    return BoundsReport(
        total_accesses=total,
        exact=exact,
        refs=tuple(refs),
        array_lines=array_lines,
        compulsory_lower=compulsory,
        cold_model=cold_model,
        asymptote=(cold_model / total if exact and total else None),
    )


def check_static_bounds(report, mrc: np.ndarray,
                        machine: Optional[MachineConfig] = None,
                        atol: float = 1e-9) -> list[str]:
    """Cross-check an engine MRC against a report's static bounds.

    Accepts an AnalysisReport (with .bounds and .machine) or a bare
    BoundsReport plus an explicit machine. Returns violation strings
    (empty == every bound holds).
    """
    bounds = getattr(report, "bounds", report)
    machine = machine or getattr(report, "machine", None)
    if bounds is None:
        return ["no bounds report (validation failed before pass 3)"]
    out: list[str] = []
    mrc = np.asarray(mrc, dtype=np.float64)
    if mrc.size == 0 or bounds.total_accesses <= 0:
        return ["empty MRC or zero modeled accesses"]
    tail = float(mrc[-1])
    lower_frac = bounds.compulsory_lower / bounds.total_accesses
    if lower_frac > tail + atol:
        out.append(
            f"compulsory-miss bound violated: static lower "
            f"{bounds.compulsory_lower}/{bounds.total_accesses}"
            f"={lower_frac:.6g} > MRC tail {tail:.6g}")
    # The tail approaches the cold fraction only when the curve was not
    # truncated at the cache capacity (runtime/aet.py caps the domain
    # at machine.cache_lines). Even untruncated, AET's last point sits
    # a hair ABOVE the asymptote: the eviction-time solve at cache size
    # min(max_rt, cache_lines) lands just short of the largest reuse
    # times, so mrc[-1] >= cold/total with a small one-sided overshoot
    # (empirically <1% of the tail across the registry). The check is
    # therefore one-sided-exact below, banded above.
    truncated = machine is not None and mrc.size >= machine.cache_lines + 1
    if bounds.exact and not truncated:
        if bounds.asymptote > tail + atol:
            out.append(
                f"footprint asymptote exceeds MRC tail: static cold "
                f"{bounds.cold_model}/{bounds.total_accesses}"
                f"={bounds.asymptote:.12g} > MRC tail {tail:.12g}")
        elif tail - bounds.asymptote > 0.05 * max(tail, atol) + atol:
            out.append(
                f"footprint asymptote mismatch: static cold "
                f"{bounds.cold_model}/{bounds.total_accesses}"
                f"={bounds.asymptote:.12g} vs MRC tail {tail:.12g}")
    return out


def drift_priors(report) -> dict:
    """Compact static-prior row for the drift monitor: the facts a
    drift audit can sanity-check a measured MRC against."""
    bounds = getattr(report, "bounds", report)
    if bounds is None:
        return {}
    d = {
        "total_accesses": bounds.total_accesses,
        "compulsory_lower": bounds.compulsory_lower,
        "bounds_exact": bounds.exact,
    }
    if bounds.exact:
        d["cold_model"] = bounds.cold_model
        d["asymptote"] = bounds.asymptote
    return d
