"""Static IR gate: analyzer verdicts for the model registry.

The port's twin of the JAX package's tools/check_ir.py, on the port's
copies of analysis/ and frontend/ (the same code, so the same lines).
Runs the three analysis passes (analysis/) over every registry model —
or one model with --model — and prints the verdict table:
well-formedness diagnostics, the dependence/race classification, and
the locality bounds. Host code only: no engine runs.

    python -m pluss_sampler_optimization_torch.tools.check_ir
        [--model NAME] [--n N] [--tsteps T] [--json] [--fixtures]
        [--ir-json FILE ...]

Exit code: nonzero when any program is INVALID (verdict "invalid") —
a race verdict is a property of the modeled OpenMP program, not an
input error, and exits 0. `--fixtures` instead runs the analyzer over
the malformed-IR fixture set (analysis/validate.py::malformed_fixtures)
AND the frontend's malformed-document set
(frontend/parse.py::malformed_doc_fixtures) and fails unless every
fixture produces exactly its expected diagnostic code (the error-path
self-test).

`--ir-json FILE ...` validates user-authored frontend documents
(frontend/schema.py; write them with the CLI's `--dump-ir`) offline
through the same parse + analyze code path as the CLI's
`--program-json`.
"""

from __future__ import annotations

import argparse
import json
import sys


def verdict_rows(models, n: int, tsteps: int):
    """[(name, report)] for the requested registry models."""
    from pluss_sampler_optimization_torch import analysis
    from pluss_sampler_optimization_torch.config import MachineConfig
    from pluss_sampler_optimization_torch.models import build

    machine = MachineConfig()
    rows = []
    for name in models:
        program = build(name, n, tsteps)
        rows.append((name, analysis.analyze_program(program, machine)))
    return rows


def check_fixtures() -> list[str]:
    """Run every malformed fixture through the analyzer; returns the
    mismatches (empty = every fixture yields its expected code)."""
    from pluss_sampler_optimization_torch import analysis

    problems = []
    for key, (program, want_code) in sorted(
        analysis.malformed_fixtures().items()
    ):
        report = analysis.analyze_program(program)
        if report.verdict != analysis.VERDICT_INVALID:
            problems.append(
                f"{key}: expected verdict 'invalid', got "
                f"{report.verdict!r}"
            )
            continue
        codes = [d.code for d in report.diagnostics
                 if d.severity == "error"]
        if want_code not in codes:
            problems.append(
                f"{key}: expected diagnostic {want_code}, got {codes}"
            )
    return problems


def check_doc_fixtures() -> list[str]:
    """The frontend's malformed-document set through the strict
    parser; returns mismatches (empty = every document is rejected
    with its expected code)."""
    from pluss_sampler_optimization_torch.frontend.parse import (
        malformed_doc_fixtures,
        parse_program_doc,
    )

    problems = []
    for key, (doc, want_code) in sorted(
        malformed_doc_fixtures().items()
    ):
        res = parse_program_doc(doc)
        if res.program is not None:
            problems.append(f"doc:{key}: accepted, expected "
                            f"{want_code}")
            continue
        codes = [d.code for d in res.errors()]
        if want_code not in codes:
            problems.append(
                f"doc:{key}: expected diagnostic {want_code}, "
                f"got {codes}"
            )
    return problems


def check_ir_files(paths, as_json: bool) -> int:
    """Validate frontend documents offline; one verdict line (or JSON
    object) per file, nonzero when any file is rejected."""
    from pluss_sampler_optimization_torch import analysis
    from pluss_sampler_optimization_torch.config import MachineConfig
    from pluss_sampler_optimization_torch.frontend.parse import (
        parse_program_doc,
    )
    from pluss_sampler_optimization_torch.frontend.schema import (
        machine_from_doc,
    )

    invalid = 0
    for path in paths:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            invalid += 1
            if as_json:
                print(json.dumps({"file": path, "verdict": "invalid",
                                  "error": str(e)}, sort_keys=True))
            else:
                print(f"{path}: INVALID ({e})")
            continue
        res = parse_program_doc(doc)
        if res.program is None:
            invalid += 1
            diags = [d.to_dict() for d in res.errors()]
            if as_json:
                print(json.dumps(
                    {"file": path, "verdict": "invalid",
                     "diagnostics": diags}, sort_keys=True))
            else:
                print(f"{path}: INVALID")
                for d in res.errors():
                    print(f"  [{d.severity}] {d.code} at "
                          f"{d.path or '/'}: {d.message}")
            continue
        machine = machine_from_doc(doc, MachineConfig())
        report = analysis.analyze_program(res.program, machine)
        if as_json:
            print(json.dumps(
                {"file": path, "program": res.program.name,
                 "accesses": res.total_accesses, **report.summary(),
                 "wall_ms": round(report.wall_s * 1e3, 3)},
                sort_keys=True))
        else:
            print(f"{path}: {report.verdict} "
                  f"({res.program.name}, {res.total_accesses} "
                  f"accesses, {len(report.races)} race pairs)")
        invalid += 0 if report.ok else 1
    return 1 if invalid else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="static IR analyzer gate over the model registry"
    )
    ap.add_argument("--model", default=None,
                    help="one registry model (default: all)")
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--tsteps", type=int, default=1)
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON object per model instead of "
                    "the table")
    ap.add_argument("--fixtures", action="store_true",
                    help="check the malformed-IR and malformed-"
                    "document fixture sets instead of the registry "
                    "(error-path self-test)")
    ap.add_argument("--ir-json", nargs="+", default=None,
                    metavar="FILE",
                    help="validate frontend JSON documents offline "
                    "(same parse+analyze path as the serve 'program' "
                    "field; nonzero exit on any invalid file)")
    args = ap.parse_args(argv)

    if args.fixtures:
        problems = check_fixtures() + check_doc_fixtures()
        for p in problems:
            print(f"FIXTURE MISMATCH: {p}", file=sys.stderr)
        from pluss_sampler_optimization_torch import analysis
        from pluss_sampler_optimization_torch.frontend.parse import (
            malformed_doc_fixtures,
        )

        n = (len(analysis.malformed_fixtures())
             + len(malformed_doc_fixtures()))
        print(f"fixtures: {n - len(problems)}/{n} produced their "
              "expected diagnostic code")
        return 1 if problems else 0

    if args.ir_json:
        return check_ir_files(args.ir_json, args.json)

    from pluss_sampler_optimization_torch.models import REGISTRY

    models = [args.model] if args.model else sorted(REGISTRY)
    rows = verdict_rows(models, args.n, args.tsteps)
    invalid = 0
    if args.json:
        for name, report in rows:
            doc = {"model": name, **report.summary(),
                   "wall_ms": round(report.wall_s * 1e3, 3)}
            if report.races:
                doc["race_pairs"] = [
                    (r.ref_a, r.ref_b) for r in report.races
                ]
            print(json.dumps(doc, sort_keys=True))
            invalid += 0 if report.ok else 1
        return 1 if invalid else 0
    print(f"{'model':<12} {'verdict':>8} {'races':>5} {'deps':>5} "
          f"{'carried':>7} {'compulsory':>10} {'ms':>7}")
    for name, report in rows:
        from pluss_sampler_optimization_torch import analysis

        if not report.ok:
            invalid += 1
            first = next(d for d in report.diagnostics
                         if d.severity == "error")
            print(f"{name:<12} {'INVALID':>8}  {first.code} at "
                  f"{first.path}: {first.message}")
            continue
        carried = sum(1 for d in report.dependences
                      if d.kind == analysis.DEP_CARRIED)
        print(f"{name:<12} {report.verdict:>8} "
              f"{len(report.races):>5} {len(report.dependences):>5} "
              f"{carried:>7} {report.bounds.compulsory_lower:>10} "
              f"{report.wall_s * 1e3:>7.1f}")
    print(f"{len(rows)} models, {invalid} invalid")
    return 1 if invalid else 0


if __name__ == "__main__":
    sys.exit(main())
