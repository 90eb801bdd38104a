"""Pass 1: structural well-formedness validation + canonical signatures.

The engines assume every `Program` handed to them satisfies the IR
invariants that `ir.py`'s `__post_init__` hooks enforce at
construction — but ROADMAP item 4 (loop nests as untrusted request
payloads) means programs will arrive as *data*, built by frontends that
bypass those constructors, and an invariant violation today surfaces as
an engine-side IndexError/ValueError deep inside a jit trace. This
pass re-checks every invariant duck-typed (no isinstance on the ir
classes), returns machine-readable diagnostics instead of raising, and
adds the domain checks the constructors cannot see (empty iteration
domains, triangular levels that never execute).

Also home to the *structural signature*: a size-invariant canonical
summary of a program's shape (loop classes, affine coefficient sign
classes, share markers) used by `sampler/analytic.py` to derive the
audited-family verdict from program structure instead of a hardcoded
name list.
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import Any, Iterable, Optional

from ..ir import MAX_DEPTH, Loop, ParallelNest, Program, Ref

# Diagnostic codes (the glossary lives in README "Static analysis &
# preflight"). V_* are errors: the program cannot be simulated. W_* are
# warnings: simulable, but the modeled OpenMP program is suspect.
V_NO_NESTS = "V_NO_NESTS"  # program has no (sequence of) nests
V_DEPTH = "V_DEPTH"  # nest depth outside 1..MAX_DEPTH
V_PARALLEL_TRIANGULAR = "V_PARALLEL_TRIANGULAR"  # loops[0] not rectangular
V_STEP_ZERO = "V_STEP_ZERO"  # loop step == 0
V_EMPTY_DOMAIN = "V_EMPTY_DOMAIN"  # a level never executes any iteration
V_COEFF_SHAPE = "V_COEFF_SHAPE"  # non-integer / wrongly-shaped affine data
V_REF_LEVEL = "V_REF_LEVEL"  # ref level outside the nest's depth
V_SLOT = "V_SLOT"  # bad slot, or post at the deepest level
V_SHARE = "V_SHARE"  # share_threshold/share_ratio not a positive int
W_RACE = "W_RACE"  # write-involved dependence carried by the parallel loop

ERROR_CODES = frozenset({
    V_NO_NESTS, V_DEPTH, V_PARALLEL_TRIANGULAR, V_STEP_ZERO,
    V_EMPTY_DOMAIN, V_COEFF_SHAPE, V_REF_LEVEL, V_SLOT, V_SHARE,
})


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One machine-readable finding: code + IR path + human message."""

    code: str
    path: str  # e.g. "nests[2].loops[1]", "nests[0].refs[3](B0)"
    message: str
    severity: str = "error"  # "error" | "warning"

    def to_dict(self) -> dict:
        return {
            "code": self.code,
            "path": self.path,
            "message": self.message,
            "severity": self.severity,
        }


def _is_int(v: Any) -> bool:
    return isinstance(v, numbers.Integral) and not isinstance(v, bool)


def _ref_path(ni: int, ri: int, ref: Any) -> str:
    name = getattr(ref, "name", None)
    tag = f"({name})" if isinstance(name, str) else ""
    return f"nests[{ni}].refs[{ri}]{tag}"


def _validate_loop(lp: Any, path: str, parallel: bool,
                   parallel_loop: Any) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    fields = ("trip", "start", "step", "trip_coeff", "start_coeff")
    vals = {f: getattr(lp, f, None) for f in fields}
    bad = [f for f, v in vals.items() if not _is_int(v)]
    if bad:
        return [Diagnostic(V_COEFF_SHAPE, path,
                           f"loop fields must be integers: {bad}")]
    if vals["step"] == 0:
        diags.append(Diagnostic(V_STEP_ZERO, path, "loop step is zero"))
    triangular = vals["trip_coeff"] != 0 or vals["start_coeff"] != 0
    if parallel:
        if triangular:
            diags.append(Diagnostic(
                V_PARALLEL_TRIANGULAR, path,
                "the parallel level (loops[0]) must be rectangular "
                f"(trip_coeff={vals['trip_coeff']}, "
                f"start_coeff={vals['start_coeff']})"))
        elif vals["trip"] < 1:
            diags.append(Diagnostic(
                V_EMPTY_DOMAIN, path,
                f"parallel trip {vals['trip']} < 1: no iterations"))
        return diags
    if not triangular:
        if vals["trip"] < 1:
            diags.append(Diagnostic(
                V_EMPTY_DOMAIN, path,
                f"trip {vals['trip']} < 1: the level never executes"))
        return diags
    # triangular inner level: empty only if trip_at(v0) < 1 for EVERY
    # parallel value (trisolv's j-loop is legitimately empty at i=0)
    if parallel_loop is not None and vals["step"] != 0:
        p_trip = getattr(parallel_loop, "trip", None)
        p_start = getattr(parallel_loop, "start", None)
        p_step = getattr(parallel_loop, "step", None)
        if all(_is_int(v) for v in (p_trip, p_start, p_step)) and p_trip >= 1:
            ends = (p_start, p_start + (p_trip - 1) * p_step)
            max_trip = max(vals["trip"] + vals["trip_coeff"] * v0
                           for v0 in ends)
            if max_trip < 1:
                diags.append(Diagnostic(
                    V_EMPTY_DOMAIN, path,
                    f"triangular trip {vals['trip']}"
                    f"{vals['trip_coeff']:+d}*v0 < 1 for every parallel "
                    "value: the level never executes"))
    return diags


def _validate_ref(ref: Any, path: str, depth: int) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    name = getattr(ref, "name", None)
    array = getattr(ref, "array", None)
    if not isinstance(name, str) or not isinstance(array, str):
        diags.append(Diagnostic(V_COEFF_SHAPE, path,
                                "ref name/array must be strings"))
    level = getattr(ref, "level", None)
    if not _is_int(level):
        return diags + [Diagnostic(V_COEFF_SHAPE, path,
                                   "ref level must be an integer")]
    if level < 0 or level >= MAX_DEPTH or (depth > 0 and level >= depth):
        hi = min(MAX_DEPTH, depth) if depth > 0 else MAX_DEPTH
        diags.append(Diagnostic(
            V_REF_LEVEL, path,
            f"ref level {level} outside [0,{hi}) for this nest"))
        return diags
    coeffs = getattr(ref, "coeffs", None)
    if (not isinstance(coeffs, (tuple, list))
            or len(coeffs) != level + 1
            or not all(_is_int(c) for c in coeffs)):
        diags.append(Diagnostic(
            V_COEFF_SHAPE, path,
            f"coeffs must be {level + 1} integers (level+1); got "
            f"{coeffs!r}"))
    if not _is_int(getattr(ref, "const", 0)):
        diags.append(Diagnostic(V_COEFF_SHAPE, path,
                                "ref const must be an integer"))
    slot = getattr(ref, "slot", "pre")
    if slot not in ("pre", "post"):
        diags.append(Diagnostic(V_SLOT, path,
                                f"slot must be 'pre' or 'post', got {slot!r}"))
    elif depth > 0 and level == depth - 1 and slot == "post":
        diags.append(Diagnostic(
            V_SLOT, path,
            "deepest level has no subloop; use slot='pre'"))
    for f in ("share_threshold", "share_ratio"):
        v = getattr(ref, f, None)
        if v is not None and (not _is_int(v) or v < 1):
            diags.append(Diagnostic(
                V_SHARE, path, f"{f} must be a positive integer, got {v!r}"))
    w = getattr(ref, "write", None)
    if w is not None and not isinstance(w, bool):
        diags.append(Diagnostic(
            V_COEFF_SHAPE, path, f"write must be True/False/None, got {w!r}"))
    return diags


def validate_program(program: Any) -> list[Diagnostic]:
    """All structural diagnostics for a (possibly duck-typed) program.

    Never raises: malformed shapes come back as V_COEFF_SHAPE /
    V_NO_NESTS diagnostics so the service can reject with a structured
    error instead of a traceback.
    """
    nests = getattr(program, "nests", None)
    if not isinstance(nests, (tuple, list)) or len(nests) == 0:
        return [Diagnostic(V_NO_NESTS, "program",
                           "program needs at least one parallel nest")]
    diags: list[Diagnostic] = []
    for ni, nest in enumerate(nests):
        npath = f"nests[{ni}]"
        loops = getattr(nest, "loops", None)
        refs = getattr(nest, "refs", None)
        if not isinstance(loops, (tuple, list)) or not isinstance(
                refs, (tuple, list)):
            diags.append(Diagnostic(
                V_COEFF_SHAPE, npath,
                "nest must carry loops and refs sequences"))
            continue
        if not 1 <= len(loops) <= MAX_DEPTH:
            diags.append(Diagnostic(
                V_DEPTH, npath,
                f"nest depth {len(loops)} outside 1..{MAX_DEPTH}"))
            continue
        parallel_loop = loops[0]
        for li, lp in enumerate(loops):
            diags.extend(_validate_loop(
                lp, f"{npath}.loops[{li}]", parallel=(li == 0),
                parallel_loop=parallel_loop))
        for ri, ref in enumerate(refs):
            diags.extend(_validate_ref(
                ref, _ref_path(ni, ri, ref), depth=len(loops)))
    return diags


def canonicalize(program: Any) -> Program:
    """Rebuild a validated duck-typed program as real ir dataclasses
    (coercing numpy ints etc. to python ints). Raises ValueError with
    the first diagnostic when the program is invalid."""
    diags = [d for d in validate_program(program) if d.severity == "error"]
    if diags:
        d = diags[0]
        raise ValueError(f"{d.code} at {d.path}: {d.message}")
    nests = []
    for nest in program.nests:
        loops = tuple(
            Loop(trip=int(lp.trip), start=int(lp.start), step=int(lp.step),
                 trip_coeff=int(lp.trip_coeff),
                 start_coeff=int(lp.start_coeff))
            for lp in nest.loops)
        refs = tuple(
            Ref(name=str(r.name), array=str(r.array), level=int(r.level),
                coeffs=tuple(int(c) for c in r.coeffs),
                const=int(getattr(r, "const", 0)),
                slot=str(getattr(r, "slot", "pre")),
                share_threshold=(None if getattr(r, "share_threshold", None)
                                 is None else int(r.share_threshold)),
                share_ratio=(None if getattr(r, "share_ratio", None) is None
                             else int(r.share_ratio)),
                write=(None if getattr(r, "write", None) is None
                       else bool(r.write)))
            for r in nest.refs)
        nests.append(ParallelNest(loops=loops, refs=refs))
    return Program(name=str(program.name), nests=tuple(nests))


# ---------------------------------------------------------------------------
# Structural signatures (size-invariant program shape).
# ---------------------------------------------------------------------------


def _coeff_class(v: int) -> object:
    """{0, 1, -1, "+", "-"}: literal unit strides stay distinguishable
    from size-derived strides (n, n*n, ...) at any practical size."""
    if v in (0, 1, -1):
        return v
    return "+" if v > 0 else "-"


def _sign_class(v: int) -> object:
    return 0 if v == 0 else ("+" if v > 0 else "-")


def _loop_signature(lp: Loop) -> tuple:
    step = lp.step if lp.step in (1, -1) else ("+" if lp.step > 0 else "-")
    return (step, _sign_class(lp.start), _sign_class(lp.trip_coeff),
            _sign_class(lp.start_coeff))


def _ref_signature(ref: Ref, array_ids: dict[str, int]) -> tuple:
    return (
        array_ids[ref.array],
        ref.level,
        tuple(_coeff_class(c) for c in ref.coeffs),
        _coeff_class(ref.const),
        ref.slot,
        ref.share_threshold is not None,
    )


def structural_signature(program: Program) -> tuple:
    """Size- and tsteps-invariant shape of a program.

    Nest signatures are deduplicated in first-seen order so time-model
    unrollings ((nest_b, nest_a) * tsteps) collapse to one period; array
    identity is program-wide first-occurrence order so multi-nest
    producer/consumer structure (2mm vs gemm) stays distinguishable.
    """
    array_ids: dict[str, int] = {}
    for nest in program.nests:
        for r in nest.refs:
            array_ids.setdefault(r.array, len(array_ids))
    seen: dict[tuple, None] = {}
    for nest in program.nests:
        sig = (
            len(nest.loops),
            tuple(_loop_signature(lp) for lp in nest.loops),
            tuple(_ref_signature(r, array_ids) for r in nest.refs),
        )
        seen.setdefault(sig, None)
    return tuple(seen)


# ---------------------------------------------------------------------------
# Malformed fixtures (shared by tests and tools/check_ir.py --fixtures).
# ---------------------------------------------------------------------------


class _Bag:
    """Attribute bag standing in for ir dataclasses: lets fixtures
    express invariant violations the real constructors would reject."""

    def __init__(self, **kw: Any) -> None:
        self.__dict__.update(kw)


def _bag_loop(trip: int = 4, start: int = 0, step: int = 1,
              trip_coeff: int = 0, start_coeff: int = 0) -> _Bag:
    return _Bag(trip=trip, start=start, step=step, trip_coeff=trip_coeff,
                start_coeff=start_coeff)


def _bag_ref(name: str = "R0", array: str = "A", level: int = 0,
             coeffs: Any = (1,), const: Any = 0, slot: str = "pre",
             share_threshold: Optional[int] = None,
             share_ratio: Optional[int] = None) -> _Bag:
    return _Bag(name=name, array=array, level=level, coeffs=coeffs,
                const=const, slot=slot, share_threshold=share_threshold,
                share_ratio=share_ratio)


def _bag_nest(loops: Iterable[Any], refs: Iterable[Any]) -> _Bag:
    return _Bag(loops=tuple(loops), refs=tuple(refs))


def malformed_fixtures() -> dict[str, tuple[Any, str]]:
    """name -> (program-like object, expected diagnostic code)."""
    return {
        "depth_overflow": (
            _Bag(name="bad-depth", nests=(_bag_nest(
                [_bag_loop()] * (MAX_DEPTH + 1),
                [_bag_ref()]),)),
            V_DEPTH),
        "parallel_triangular": (
            _Bag(name="bad-par", nests=(_bag_nest(
                [_bag_loop(trip_coeff=1), _bag_loop()],
                [_bag_ref(level=1, coeffs=(4, 1))]),)),
            V_PARALLEL_TRIANGULAR),
        "empty_domain": (
            _Bag(name="bad-empty", nests=(_bag_nest(
                [_bag_loop(trip=0)], [_bag_ref()]),)),
            V_EMPTY_DOMAIN),
        "empty_triangular": (
            _Bag(name="bad-empty-tri", nests=(_bag_nest(
                [_bag_loop(trip=4), _bag_loop(trip=0, trip_coeff=-1)],
                [_bag_ref(level=1, coeffs=(4, 1))]),)),
            V_EMPTY_DOMAIN),
        "coeff_shape": (
            _Bag(name="bad-coeffs", nests=(_bag_nest(
                [_bag_loop(), _bag_loop()],
                [_bag_ref(level=1, coeffs=(1.5, 2.0))]),)),
            V_COEFF_SHAPE),
        "coeff_length": (
            _Bag(name="bad-coeff-len", nests=(_bag_nest(
                [_bag_loop(), _bag_loop()],
                [_bag_ref(level=1, coeffs=(4, 1, 1))]),)),
            V_COEFF_SHAPE),
        "step_zero": (
            _Bag(name="bad-step", nests=(_bag_nest(
                [_bag_loop(step=0)], [_bag_ref()]),)),
            V_STEP_ZERO),
        "ref_too_deep": (
            _Bag(name="bad-level", nests=(_bag_nest(
                [_bag_loop()],
                [_bag_ref(level=2, coeffs=(4, 1, 1))]),)),
            V_REF_LEVEL),
        "bad_slot": (
            _Bag(name="bad-slot", nests=(_bag_nest(
                [_bag_loop()], [_bag_ref(slot="mid")]),)),
            V_SLOT),
        "bad_share": (
            _Bag(name="bad-share", nests=(_bag_nest(
                [_bag_loop()], [_bag_ref(share_threshold=0)]),)),
            V_SHARE),
        "no_nests": (_Bag(name="bad-empty-prog", nests=()), V_NO_NESTS),
    }
