"""Pass 2: affine dependence analysis / race detection.

For every pair of references sharing an array within one parallel nest
(the per-nest LAT flush makes nests independent, and each nest is its
own `#pragma pluss parallel` region with an implicit barrier), classify
the dependence by testing integer feasibility of the flat-index
equality over the iteration domain:

    flat_a(u_a) = flat_b(u_b)       (element granularity — false
                                     sharing is locality, not a race)

in *normalized* iteration space u_k in [0, trip_k): triangular bounds
fold their start_coeff contribution into the affine form exactly and
their trip bound is relaxed to the rectangular hull (sound: the hull
only ever widens the domain, so "no dependence" verdicts stay proofs).

Three independence tests, cheapest first (the classic GCD + Banerjee
pair plus a modular-interval refinement):

  gcd       gcd of the equation's coefficients does not divide the rhs.
  interval  rhs outside the [min, max] of the LHS over the box
            (Banerjee bounds).
  modular   for a modulus M drawn from the coefficients, the terms not
            divisible by M can never be congruent to the rhs (mod M)
            within their interval — this is what proves adi's
            column-major writes (stride-1 on the parallel variable,
            stride-n inner) independent where plain Banerjee cannot.

A dependence not proven absent is classified *loop-independent* when a
cross-parallel-iteration solution (u_b0 = u_a0 + d, |d| >= 1) is
refuted by the same tests, else *carried* by the parallel loop.

Write modeling: the IR has no read/write bit. The generated-sampler
convention (models/gemm.py: "RHS operands in source order before the
write") makes every store a read-modify-write *pair* of refs with the
identical affine map, so >= 2 refs in one nest with the same (array,
coeffs, const) mark that map — and its array — write-involved. A
carried dependence touching a write-involved map is flagged as a
**race**: still simulable (the machine models the interleaving), but
the modeled OpenMP program is racy. The tests are conservative: a
race flag means "not provably race-free" (covariance's triangular
symmetric write-back is a known may-alias the hull cannot refute).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

from ..ir import ParallelNest, Program

DEP_NONE = "none"
DEP_INDEPENDENT = "independent"
DEP_CARRIED = "carried"


@dataclasses.dataclass(frozen=True)
class AffineForm:
    """flat(u) = const + sum(coeffs[k] * u_k) over normalized iteration
    counters u_k in [0, hull[k]); hull is the rectangular relaxation of
    (possibly triangular) trip counts."""

    const: int
    coeffs: tuple[int, ...]
    hull: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Dependence:
    """One classified ref pair (unordered, nest-local; a == b is a ref
    against its own other iterations)."""

    nest: int
    array: str
    ref_a: str
    ref_b: str
    kind: str  # DEP_NONE | DEP_INDEPENDENT | DEP_CARRIED
    race: bool
    write_involved: bool
    reason: str  # deciding test ("gcd"/"interval"/"modular"/"feasible"/...)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def normalized_form(nest: ParallelNest, ref: Any) -> AffineForm:
    """Exact affine form of a ref's flat index over normalized counters.

    v0 = start0 + step0*u0;  i_k = start_k + start_coeff_k*v0 + step_k*u_k.
    Triangular start_coeff contributions land on u0's coefficient, so
    the *map* stays exact — only the trip bound is hulled.
    """
    loops = nest.loops
    l0 = loops[0]
    lv = ref.level
    const = ref.const + ref.coeffs[0] * l0.start
    c0 = ref.coeffs[0] * l0.step
    coeffs = [0] * (lv + 1)
    for k in range(1, lv + 1):
        lp, c = loops[k], ref.coeffs[k]
        const += c * (lp.start + lp.start_coeff * l0.start)
        c0 += c * lp.start_coeff * l0.step
        coeffs[k] = c * lp.step
    coeffs[0] = c0
    v0_ends = (l0.start, l0.start + (l0.trip - 1) * l0.step)
    hull = [l0.trip]
    for k in range(1, lv + 1):
        lp = loops[k]
        hull.append(max(0, *(lp.trip + lp.trip_coeff * v0 for v0 in v0_ends)))
    return AffineForm(const=const, coeffs=tuple(coeffs), hull=tuple(hull))


def _interval(coeffs: list[int], ranges: list[tuple[int, int]]):
    lo = hi = 0
    for c, (a, b) in zip(coeffs, ranges):
        if c >= 0:
            lo += c * a
            hi += c * b
        else:
            lo += c * b
            hi += c * a
    return lo, hi


def _congruent_in(lo: int, hi: int, rhs: int, mod: int) -> bool:
    """Is there y in [lo, hi] with y == rhs (mod mod)?"""
    first = rhs + math.ceil((lo - rhs) / mod) * mod
    return first <= hi


def eq_feasible(coeffs: list[int], ranges: list[tuple[int, int]],
                rhs: int) -> tuple[bool, str]:
    """May `sum(c_i * x_i) == rhs` have an integer solution with each
    x_i in its inclusive range? Returns (feasible, deciding_test);
    False is a proof, True is conservative ("feasible")."""
    for a, b in ranges:
        if a > b:
            return False, "empty"
    live = [(c, r) for c, r in zip(coeffs, ranges) if c != 0]
    if not live:
        return (rhs == 0), ("feasible" if rhs == 0 else "gcd")
    cs = [c for c, _ in live]
    rs = [r for _, r in live]
    g = 0
    for c in cs:
        g = math.gcd(g, c)
    if rhs % g != 0:
        return False, "gcd"
    lo, hi = _interval(cs, rs)
    if rhs < lo or rhs > hi:
        return False, "interval"
    # modular-interval: modulus M from the coefficient magnitudes; the
    # M-divisible terms vanish (mod M), the rest must reach a value
    # congruent to rhs (mod M) inside their own interval
    for mod in sorted({abs(c) for c in cs if abs(c) > 1}):
        rem = [(c, r) for c, r in live if c % mod != 0]
        if len(rem) == len(live):
            continue
        rlo, rhi = _interval([c for c, _ in rem], [r for _, r in rem])
        if not _congruent_in(rlo, rhi, rhs, mod):
            return False, "modular"
    return True, "feasible"


def _base_equation(fa: AffineForm, fb: AffineForm):
    coeffs = list(fa.coeffs) + [-c for c in fb.coeffs]
    ranges = ([(0, u - 1) for u in fa.hull]
              + [(0, u - 1) for u in fb.hull])
    return coeffs, ranges, fb.const - fa.const


def _cross_feasible(fa: AffineForm, fb: AffineForm, trip0: int
                    ) -> tuple[bool, str]:
    """Feasibility of flat_a(u_a) = flat_b(u_b) with u_b0 = u_a0 + d,
    |d| >= 1 (a solution on two distinct parallel iterations, hence
    potentially two distinct simulated threads)."""
    # vars: u_a0, u_a1.., u_b1.., d
    coeffs = ([fa.coeffs[0] - fb.coeffs[0]] + list(fa.coeffs[1:])
              + [-c for c in fb.coeffs[1:]] + [-fb.coeffs[0]])
    base = ([(0, trip0 - 1)] + [(0, u - 1) for u in fa.hull[1:]]
            + [(0, u - 1) for u in fb.hull[1:]])
    rhs = fb.const - fa.const
    reasons = []
    for dlo, dhi in ((1, trip0 - 1), (-(trip0 - 1), -1)):
        ok, why = eq_feasible(coeffs, base + [(dlo, dhi)], rhs)
        if ok:
            return True, why
        reasons.append(why)
    return False, "/".join(reasons)


def write_involved_maps(nest: ParallelNest) -> set[tuple]:
    """Affine maps that are stores.

    An explicit `Ref.write=True` marks the map directly. Refs with
    `write=None` fall under the read-modify-write pair convention: >= 2
    unmarked refs of one nest sharing an (array, coeffs, const) map
    mean a load+store pair. `write=False` refs never contribute."""
    explicit: set[tuple] = set()
    counts: dict[tuple, int] = {}
    for r in nest.refs:
        key = (r.array, tuple(r.coeffs), r.const)
        w = getattr(r, "write", None)
        if w is True:
            explicit.add(key)
        elif w is None:
            counts[key] = counts.get(key, 0) + 1
    return explicit | {k for k, n in counts.items() if n >= 2}


def analyze_nest(program: Program, nest_index: int) -> list[Dependence]:
    nest = program.nests[nest_index]
    refs = nest.refs
    forms = [normalized_form(nest, r) for r in refs]
    writes = write_involved_maps(nest)
    is_write = [(r.array, tuple(r.coeffs), r.const) in writes for r in refs]
    trip0 = nest.loops[0].trip
    out: list[Dependence] = []
    for i in range(len(refs)):
        for j in range(i, len(refs)):
            a, b = refs[i], refs[j]
            if a.array != b.array:
                continue
            wr = is_write[i] or is_write[j]
            coeffs, ranges, rhs = _base_equation(forms[i], forms[j])
            ok, why = eq_feasible(coeffs, ranges, rhs)
            if not ok:
                kind, race = DEP_NONE, False
            else:
                ok, why = _cross_feasible(forms[i], forms[j], trip0)
                kind = DEP_CARRIED if ok else DEP_INDEPENDENT
                race = ok and wr
            out.append(Dependence(
                nest=nest_index, array=a.array, ref_a=a.name, ref_b=b.name,
                kind=kind, race=race, write_involved=wr, reason=why))
    return out


def analyze_dependences(program: Program) -> list[Dependence]:
    """All classified ref pairs, program order."""
    out: list[Dependence] = []
    for ni in range(len(program.nests)):
        out.extend(analyze_nest(program, ni))
    return out


def races(dependences: list[Dependence]) -> list[Dependence]:
    return [d for d in dependences if d.race]
