"""Static IR analysis: validation, dependence/race detection, bounds.

Three passes over `ir.Program` (pure numpy + stdlib — importable
without jax, so the CLI `analyze` mode and tools/check_ir.py stay
instant):

1. `validate` — structural well-formedness diagnostics (V_* codes).
2. `deps` — affine dependence classification and race flags (W_RACE).
3. `bounds` — cache-line footprints, compulsory-miss lower bound, and
   the MRC asymptote cross-checks.

`analyze_program` runs all three and folds them into one
`AnalysisReport`; `preflight` is the service-facing gate: it raises
`PreflightError` (diagnostics attached) for invalid IR and returns the
report — verdict "ok" or "race" — for everything simulable.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

from ..config import MachineConfig
from .bounds import (  # noqa: F401  (re-exported API)
    DEFAULT_EXACT_LIMIT,
    BoundsReport,
    check_static_bounds,
    compute_bounds,
    drift_priors,
)
from .deps import (  # noqa: F401
    DEP_CARRIED,
    DEP_INDEPENDENT,
    DEP_NONE,
    Dependence,
    analyze_dependences,
)
from .validate import (  # noqa: F401
    ERROR_CODES,
    W_RACE,
    Diagnostic,
    canonicalize,
    malformed_fixtures,
    structural_signature,
    validate_program,
)

VERDICT_OK = "ok"
VERDICT_RACE = "race"  # simulable, but the modeled OpenMP program races
VERDICT_INVALID = "invalid"


@dataclasses.dataclass
class AnalysisReport:
    """Everything the three passes learned about one program."""

    program_name: str
    verdict: str  # VERDICT_OK | VERDICT_RACE | VERDICT_INVALID
    diagnostics: list  # [Diagnostic] — errors first, then W_RACE warnings
    dependences: list  # [Dependence] — empty when invalid
    races: list  # [Dependence] subset with race=True
    signature: Optional[tuple]  # structural signature (None when invalid)
    bounds: Optional[BoundsReport]  # None when invalid
    machine: Optional[MachineConfig]
    wall_s: float

    @property
    def ok(self) -> bool:
        return self.verdict != VERDICT_INVALID

    def summary(self) -> dict:
        """The compact dict that rides responses and ledger rows."""
        d: dict = {"verdict": self.verdict}
        if self.races:
            d["races"] = len(self.races)
        errors = [x for x in self.diagnostics if x.severity == "error"]
        if errors:
            d["diagnostics"] = [x.to_dict() for x in errors]
        return d

    def to_dict(self) -> dict:
        return {
            "program": self.program_name,
            "verdict": self.verdict,
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "dependences": [d.to_dict() for d in self.dependences],
            "races": [d.to_dict() for d in self.races],
            "bounds": self.bounds.to_dict() if self.bounds else None,
            "wall_s": self.wall_s,
        }


class PreflightError(ValueError):
    """Invalid IR rejected before fingerprint/cache/engines. Carries
    the machine-readable diagnostics for structured error responses."""

    def __init__(self, message: str, diagnostics: list):
        super().__init__(message)
        self.diagnostics = diagnostics


def analyze_program(program: Any,
                    machine: Optional[MachineConfig] = None,
                    exact_limit: int = DEFAULT_EXACT_LIMIT
                    ) -> AnalysisReport:
    """Run all three passes. Never raises on malformed input: an
    invalid program yields verdict "invalid" with the diagnostics."""
    t0 = time.perf_counter()
    machine = machine if machine is not None else MachineConfig()
    name = str(getattr(program, "name", "<unnamed>"))
    diagnostics = validate_program(program)
    errors = [d for d in diagnostics if d.severity == "error"]
    if errors:
        return AnalysisReport(
            program_name=name, verdict=VERDICT_INVALID,
            diagnostics=diagnostics, dependences=[], races=[],
            signature=None, bounds=None, machine=machine,
            wall_s=time.perf_counter() - t0)
    prog = canonicalize(program)
    deps = analyze_dependences(prog)
    race_list = [d for d in deps if d.race]
    for r in race_list:
        diagnostics.append(Diagnostic(
            code=W_RACE, severity="warning",
            path=f"nests[{r.nest}]",
            message=(f"write-involved dependence on {r.array!r} between "
                     f"{r.ref_a} and {r.ref_b} may be carried by the "
                     "parallel loop: the modeled OpenMP program races "
                     "(simulation is still well-defined)")))
    report = AnalysisReport(
        program_name=prog.name,
        verdict=VERDICT_RACE if race_list else VERDICT_OK,
        diagnostics=diagnostics,
        dependences=deps,
        races=race_list,
        signature=structural_signature(prog),
        bounds=compute_bounds(prog, machine, exact_limit=exact_limit),
        machine=machine,
        wall_s=0.0)
    report.wall_s = time.perf_counter() - t0
    return report


def preflight(program: Any,
              machine: Optional[MachineConfig] = None,
              exact_limit: int = DEFAULT_EXACT_LIMIT) -> AnalysisReport:
    """Service gate: analyze and raise `PreflightError` when invalid."""
    report = analyze_program(program, machine, exact_limit=exact_limit)
    if not report.ok:
        errors = [d for d in report.diagnostics if d.severity == "error"]
        first = errors[0]
        raise PreflightError(
            f"ir preflight rejected {report.program_name!r}: "
            f"{first.code} at {first.path}: {first.message}"
            + (f" (+{len(errors) - 1} more)" if len(errors) > 1 else ""),
            diagnostics=errors)
    return report
