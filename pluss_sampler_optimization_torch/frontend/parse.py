"""Strict deserialization of frontend JSON into `ir.Program`.

Two diagnostic families, one rejection discipline:

- **F_*** codes (this module) cover the JSON layer — wrong types,
  unknown/missing fields, unsupported versions, hostile payloads
  (out-of-range integers, over-deep documents, bounds products whose
  simulated access count would OOM an engine). Paths are JSON
  pointers into the document ("/nests/0/loops/1/trip").
- **V_*** codes (analysis/validate.py) cover the IR semantics — the
  SAME validator the service preflight runs on registry models, so a
  custom nest with a zero step rejects with exactly the V_STEP_ZERO
  diagnostic a malformed registry model would produce. Paths are IR
  paths ("nests[0].loops[1]").

`parse_program_doc` never raises on malformed input: it returns a
`ParsedProgram` whose diagnostics carry code / path / message
(`analysis.validate.Diagnostic`), mirroring the preflight contract.
`parse_program` is the raising form the service uses: its
`FrontendError` subclasses `analysis.PreflightError`, so serve_jsonl
surfaces the diagnostics on the structured error response through
the existing code path, with no frontend-specific handling.

The access cap is the preflight-side OOM guard: a document whose loop
bounds multiply out past `MAX_TOTAL_ACCESSES` is rejected before any
engine (or even the bounds pass) sees it — a hostile
`{"trip": 2**40}**3` product costs this module a few integer
multiplies, not an allocation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from ..analysis import PreflightError
from ..analysis.validate import Diagnostic, canonicalize, validate_program
from ..config import MachineConfig
from ..ir import Program
from .schema import (
    IR_SCHEMA_VERSION,
    LOOP_FIELDS,
    LOOP_REQUIRED,
    MACHINE_FIELDS,
    REF_FIELDS,
    REF_REQUIRED,
)

# Frontend diagnostic codes (JSON layer; the V_* glossary lives in
# analysis/validate.py and README "Static analysis & preflight").
F_TYPE = "F_TYPE"  # wrong JSON type for a document node
F_FIELD = "F_FIELD"  # unknown or missing field
F_VERSION = "F_VERSION"  # missing/unsupported ir_version
F_RANGE = "F_RANGE"  # integer outside the safe magnitude range
F_LIMIT = "F_LIMIT"  # document size/depth/cardinality limit
F_MACHINE = "F_MACHINE"  # machine knob rejected by MachineConfig
F_ACCESSES = "F_ACCESSES"  # simulated access count above the cap

FRONTEND_CODES = frozenset({
    F_TYPE, F_FIELD, F_VERSION, F_RANGE, F_LIMIT, F_MACHINE, F_ACCESSES,
})

# Document limits. INT_ABS_LIMIT bounds every integer in the document
# (JSON bignums would otherwise reach numpy int64 conversions);
# MAX_TOTAL_ACCESSES bounds the simulated access count an accepted
# program can demand from an engine (the largest registry scenario,
# gemm at n=4096, is ~2.7e11 — the cap clears it with headroom while
# rejecting products that could only end in an OOM or a dead service
# worker). TRI_PARALLEL_TRIP_LIMIT bounds the parallel extent of
# triangular nests, whose access count needs a per-v0 evaluation.
MAX_DOC_DEPTH = 24
MAX_NESTS = 16
MAX_REFS_PER_NEST = 64
MAX_NAME_LEN = 120
INT_ABS_LIMIT = 1 << 40
MAX_TOTAL_ACCESSES = 1 << 40
TRI_PARALLEL_TRIP_LIMIT = 1 << 21


class FrontendError(PreflightError):
    """A program document rejected by the frontend. Subclasses
    `analysis.PreflightError` so every consumer of preflight
    rejections (serve_jsonl's structured errors, tools) handles
    frontend rejections identically; `diagnostics` holds dicts
    (Diagnostic.to_dict form), ready for a JSON response."""


class _Bag:
    """Attribute bag: the duck-typed program handed to the shared
    validator (analysis/validate.py checks duck-typed, not isinstance,
    precisely for frontends like this one)."""

    def __init__(self, **kw: Any) -> None:
        self.__dict__.update(kw)


@dataclasses.dataclass
class ParsedProgram:
    """Outcome of one document parse. `program` is None iff any error
    diagnostic was produced; `machine` echoes the document's machine
    section (already vetted against MachineConfig) or None; warnings
    (W_RACE never appears here — races are the analyzer's business)
    ride `diagnostics` alongside any errors."""

    program: Optional[Program]
    machine: Optional[dict]
    diagnostics: list
    total_accesses: Optional[int] = None

    @property
    def ok(self) -> bool:
        return self.program is not None

    def errors(self) -> list:
        return [d for d in self.diagnostics if d.severity == "error"]


def _is_int(v: Any) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _doc_depth(obj: Any) -> int:
    """Nesting depth of a parsed JSON value, iteratively (a 1000-deep
    document must not recurse this module into its own crash)."""
    depth = 0
    stack = [(obj, 1)]
    while stack:
        node, d = stack.pop()
        depth = max(depth, d)
        if d > MAX_DOC_DEPTH:
            return d  # deep enough to reject; stop walking
        if isinstance(node, dict):
            stack.extend((v, d + 1) for v in node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend((v, d + 1) for v in node)
    return depth


def _range_check(d: dict, keys, path: str, diags: list) -> None:
    """F_RANGE for any integer field beyond INT_ABS_LIMIT (non-ints
    fall through to the shared validator's V_COEFF_SHAPE)."""
    for k in keys:
        v = d.get(k)
        vals = v if isinstance(v, list) else [v]
        for i, x in enumerate(vals):
            if _is_int(x) and abs(x) > INT_ABS_LIMIT:
                p = f"{path}/{k}/{i}" if isinstance(v, list) else f"{path}/{k}"
                diags.append(Diagnostic(
                    F_RANGE, p,
                    f"integer magnitude {x} exceeds 2^40"))


def _check_keys(d: dict, allowed, required, path: str,
                diags: list) -> bool:
    """Unknown/missing field diagnostics; False when required fields
    are absent (the node cannot be built)."""
    unknown = sorted(set(d) - set(allowed))
    for k in unknown:
        diags.append(Diagnostic(
            F_FIELD, f"{path}/{k}",
            f"unknown field {k!r} (have {', '.join(allowed)})"))
    missing = sorted(set(required) - set(d))
    for k in missing:
        diags.append(Diagnostic(
            F_FIELD, f"{path}/{k}", f"missing required field {k!r}"))
    return not missing


def _parse_machine(doc: dict, diags: list) -> Optional[dict]:
    machine = doc.get("machine")
    if machine is None:
        return None
    if not isinstance(machine, dict):
        diags.append(Diagnostic(F_TYPE, "/machine",
                                "machine must be a JSON object"))
        return None
    _check_keys(machine, MACHINE_FIELDS, (), "/machine", diags)
    bad = False
    for k in MACHINE_FIELDS:
        if k in machine and (not _is_int(machine[k])
                             or not 1 <= machine[k] <= INT_ABS_LIMIT):
            diags.append(Diagnostic(
                F_MACHINE, f"/machine/{k}",
                f"{k} must be a positive integer, got {machine[k]!r}"))
            bad = True
    if bad or set(machine) - set(MACHINE_FIELDS):
        return None
    try:
        kw = dataclasses.asdict(MachineConfig())
        kw.update({k: machine[k] for k in MACHINE_FIELDS if k in machine})
        MachineConfig(**kw)
    except ValueError as e:
        diags.append(Diagnostic(F_MACHINE, "/machine", str(e)))
        return None
    return {k: machine[k] for k in MACHINE_FIELDS if k in machine}


def _total_accesses(program: Program) -> "int | Diagnostic":
    """Exact (rectangular) or float-certified (triangular) simulated
    access count, in Python/np.float64 arithmetic that cannot
    overflow whatever the document's bounds multiply out to."""
    total = 0
    for ni, nest in enumerate(program.nests):
        l0 = nest.loops[0]
        if not any(lp.is_triangular for lp in nest.loops[1:]):
            for r in nest.refs:
                c = l0.trip
                for k in range(1, r.level + 1):
                    c *= nest.loops[k].trip
                total += c
            continue
        if l0.trip > TRI_PARALLEL_TRIP_LIMIT:
            return Diagnostic(
                F_LIMIT, f"/nests/{ni}/loops/0/trip",
                f"triangular nest parallel trip {l0.trip} exceeds the "
                f"frontend limit {TRI_PARALLEL_TRIP_LIMIT}")
        v0 = l0.start + l0.step * np.arange(l0.trip, dtype=np.float64)
        for r in nest.refs:
            prod = np.ones_like(v0)
            for k in range(1, r.level + 1):
                lp = nest.loops[k]
                prod = prod * np.clip(
                    lp.trip + lp.trip_coeff * v0, 0.0, None)
            total += int(min(float(prod.sum()), 2.0 ** 63))
    return total


def parse_program_doc(
    doc: Any, max_total_accesses: int = MAX_TOTAL_ACCESSES
) -> ParsedProgram:
    """Parse one document; never raises on malformed input.

    Order of gates: JSON shape (F_*), then the shared IR validator
    (V_*, identical to the service preflight on registry models),
    then canonicalization into real ir dataclasses, then the access
    cap (F_ACCESSES). The first failing gate's diagnostics come back;
    `program` is set only when every gate passes."""
    if not isinstance(doc, dict):
        return ParsedProgram(None, None, [Diagnostic(
            F_TYPE, "", "program document must be a JSON object")])
    if _doc_depth(doc) > MAX_DOC_DEPTH:
        return ParsedProgram(None, None, [Diagnostic(
            F_LIMIT, "",
            f"document nesting exceeds {MAX_DOC_DEPTH} levels")])

    diags: list = []
    _check_keys(doc, ("ir_version", "name", "nests", "machine"),
                ("nests",), "", diags)

    version = doc.get("ir_version")
    if version is None:
        diags.append(Diagnostic(
            F_VERSION, "/ir_version",
            f"missing ir_version (current: {IR_SCHEMA_VERSION})"))
    elif not _is_int(version) or version != IR_SCHEMA_VERSION:
        diags.append(Diagnostic(
            F_VERSION, "/ir_version",
            f"unsupported ir_version {version!r} "
            f"(this build reads {IR_SCHEMA_VERSION})"))

    name = doc.get("name", "custom")
    if not isinstance(name, str):
        diags.append(Diagnostic(F_TYPE, "/name", "name must be a string"))
        name = "custom"
    elif len(name) > MAX_NAME_LEN:
        diags.append(Diagnostic(
            F_LIMIT, "/name",
            f"name length {len(name)} exceeds {MAX_NAME_LEN}"))

    machine = _parse_machine(doc, diags)

    nests = doc.get("nests")
    nest_bags: list = []
    if nests is not None and not isinstance(nests, list):
        diags.append(Diagnostic(F_TYPE, "/nests",
                                "nests must be a JSON array"))
        nests = None
    if isinstance(nests, list) and len(nests) > MAX_NESTS:
        diags.append(Diagnostic(
            F_LIMIT, "/nests",
            f"{len(nests)} nests exceed the limit {MAX_NESTS}"))
        nests = None
    for ni, nd in enumerate(nests or []):
        npath = f"/nests/{ni}"
        if not isinstance(nd, dict):
            diags.append(Diagnostic(F_TYPE, npath,
                                    "nest must be a JSON object"))
            continue
        if not _check_keys(nd, ("loops", "refs"), ("loops", "refs"),
                           npath, diags):
            continue
        loops, refs = nd.get("loops"), nd.get("refs")
        if not isinstance(loops, list) or not isinstance(refs, list):
            diags.append(Diagnostic(
                F_TYPE, npath, "loops and refs must be JSON arrays"))
            continue
        if len(refs) > MAX_REFS_PER_NEST:
            diags.append(Diagnostic(
                F_LIMIT, f"{npath}/refs",
                f"{len(refs)} refs exceed the limit "
                f"{MAX_REFS_PER_NEST}"))
            continue
        loop_bags, ref_bags, bad = [], [], False
        for li, ld in enumerate(loops):
            lpath = f"{npath}/loops/{li}"
            if not isinstance(ld, dict):
                diags.append(Diagnostic(F_TYPE, lpath,
                                        "loop must be a JSON object"))
                bad = True
                continue
            if not _check_keys(ld, LOOP_FIELDS, LOOP_REQUIRED, lpath,
                               diags):
                bad = True
                continue
            _range_check(ld, LOOP_FIELDS, lpath, diags)
            loop_bags.append(_Bag(
                trip=ld.get("trip"), start=ld.get("start", 0),
                step=ld.get("step", 1),
                trip_coeff=ld.get("trip_coeff", 0),
                start_coeff=ld.get("start_coeff", 0)))
        for ri, rd in enumerate(refs):
            rpath = f"{npath}/refs/{ri}"
            if not isinstance(rd, dict):
                diags.append(Diagnostic(F_TYPE, rpath,
                                        "ref must be a JSON object"))
                bad = True
                continue
            if not _check_keys(rd, REF_FIELDS, REF_REQUIRED, rpath,
                               diags):
                bad = True
                continue
            _range_check(
                rd,
                ("level", "coeffs", "const", "share_threshold",
                 "share_ratio"),
                rpath, diags)
            coeffs = rd.get("coeffs")
            ref_bags.append(_Bag(
                name=rd.get("name"), array=rd.get("array"),
                level=rd.get("level"),
                coeffs=tuple(coeffs) if isinstance(coeffs, list)
                else coeffs,
                const=rd.get("const", 0), slot=rd.get("slot", "pre"),
                share_threshold=rd.get("share_threshold"),
                share_ratio=rd.get("share_ratio"),
                write=rd.get("write")))
        if not bad:
            nest_bags.append(_Bag(loops=tuple(loop_bags),
                                  refs=tuple(ref_bags)))

    if any(d.severity == "error" for d in diags):
        return ParsedProgram(None, machine, diags)

    bag = _Bag(name=name, nests=tuple(nest_bags))
    vdiags = validate_program(bag)
    if any(d.severity == "error" for d in vdiags):
        return ParsedProgram(None, machine, vdiags)
    program = canonicalize(bag)

    total = _total_accesses(program)
    if isinstance(total, Diagnostic):
        return ParsedProgram(None, machine, [total])
    if total > max_total_accesses:
        return ParsedProgram(None, machine, [Diagnostic(
            F_ACCESSES, "/nests",
            f"program demands {total} simulated accesses, above the "
            f"frontend cap {max_total_accesses}")],
            total_accesses=total)
    return ParsedProgram(program, machine, vdiags,
                         total_accesses=total)


def parse_program(doc: Any,
                  max_total_accesses: int = MAX_TOTAL_ACCESSES
                  ) -> Program:
    """The raising form: the canonical Program, or `FrontendError`
    with the full diagnostic list (as dicts) attached."""
    res = parse_program_doc(doc, max_total_accesses=max_total_accesses)
    if res.program is not None:
        return res.program
    errors = res.errors()
    first = errors[0]
    msg = (f"frontend rejected program: {first.code} at "
           f"{first.path or '/'}: {first.message}")
    if len(errors) > 1:
        msg += f" (+{len(errors) - 1} more)"
    raise FrontendError(msg, diagnostics=[d.to_dict() for d in errors])


# ---------------------------------------------------------------------------
# Malformed document fixtures (tests/test_frontend.py and
# tools/check_ir.py --fixtures run both this set and the IR-level
# analysis.malformed_fixtures set).
# ---------------------------------------------------------------------------


def _fixture_doc(**over: Any) -> dict:
    """A minimal valid document to mutate."""
    doc = {
        "ir_version": IR_SCHEMA_VERSION,
        "name": "fixture",
        "nests": [{
            "loops": [{"trip": 4}, {"trip": 4}],
            "refs": [{"name": "R0", "array": "A", "level": 1,
                      "coeffs": [4, 1]}],
        }],
    }
    doc.update(over)
    return doc


def malformed_doc_fixtures() -> dict:
    """name -> (document, expected diagnostic code). Spans both
    families: F_* for JSON-layer defects, V_* for semantic ones the
    shared validator flags (proving the no-drift property: the
    frontend rejects a bad nest with the SAME code the service
    preflight gives a malformed registry model)."""
    deep = [1]
    for _ in range(MAX_DOC_DEPTH + 2):
        deep = [deep]
    huge = {"loops": [{"trip": 1 << 12}, {"trip": 1 << 12},
                      {"trip": 1 << 12}],
            "refs": [{"name": "R0", "array": "A", "level": 2,
                      "coeffs": [1 << 24, 1 << 12, 1]},
                     {"name": "R1", "array": "A", "level": 2,
                      "coeffs": [1 << 24, 1 << 12, 1]}]}
    return {
        "not_an_object": ([1, 2, 3], F_TYPE),
        "missing_version": (
            {"name": "x", "nests": _fixture_doc()["nests"]}, F_VERSION),
        "future_version": (_fixture_doc(ir_version=99), F_VERSION),
        "unknown_top_field": (_fixture_doc(engine="dense"), F_FIELD),
        "missing_nests": (
            {"ir_version": IR_SCHEMA_VERSION, "name": "x"}, F_FIELD),
        "unknown_ref_field": (_fixture_doc(nests=[{
            "loops": [{"trip": 4}],
            "refs": [{"name": "R0", "array": "A", "level": 0,
                      "coeffs": [1], "stride": 2}]}]), F_FIELD),
        "missing_trip": (_fixture_doc(nests=[{
            "loops": [{"start": 0}],
            "refs": [{"name": "R0", "array": "A", "level": 0,
                      "coeffs": [1]}]}]), F_FIELD),
        "deep_document": (_fixture_doc(nests=[{
            "loops": [{"trip": 4}],
            "refs": [{"name": "R0", "array": "A", "level": 0,
                      "coeffs": deep}]}]), F_LIMIT),
        "huge_integer": (_fixture_doc(nests=[{
            "loops": [{"trip": 1 << 50}],
            "refs": [{"name": "R0", "array": "A", "level": 0,
                      "coeffs": [1]}]}]), F_RANGE),
        "hostile_bounds_product": (
            _fixture_doc(nests=[huge] * 16), F_ACCESSES),
        "bad_machine": (
            _fixture_doc(machine={"ds": 0}), F_MACHINE),
        "non_numeric_trip": (_fixture_doc(nests=[{
            "loops": [{"trip": "16"}],
            "refs": [{"name": "R0", "array": "A", "level": 0,
                      "coeffs": [1]}]}]), "V_COEFF_SHAPE"),
        "step_zero": (_fixture_doc(nests=[{
            "loops": [{"trip": 4, "step": 0}],
            "refs": [{"name": "R0", "array": "A", "level": 0,
                      "coeffs": [1]}]}]), "V_STEP_ZERO"),
        "parallel_triangular": (_fixture_doc(nests=[{
            "loops": [{"trip": 4, "trip_coeff": 1}, {"trip": 4}],
            "refs": [{"name": "R0", "array": "A", "level": 1,
                      "coeffs": [4, 1]}]}]), "V_PARALLEL_TRIANGULAR"),
        "coeff_length": (_fixture_doc(nests=[{
            "loops": [{"trip": 4}, {"trip": 4}],
            "refs": [{"name": "R0", "array": "A", "level": 1,
                      "coeffs": [4, 1, 1]}]}]), "V_COEFF_SHAPE"),
        "bad_slot": (_fixture_doc(nests=[{
            "loops": [{"trip": 4}],
            "refs": [{"name": "R0", "array": "A", "level": 0,
                      "coeffs": [1], "slot": "mid"}]}]), "V_SLOT"),
        "no_nests": (_fixture_doc(nests=[]), "V_NO_NESTS"),
    }
