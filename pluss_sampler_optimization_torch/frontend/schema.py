"""Versioned JSON schema for frontend programs.

One document describes one `ir.Program` plus optional machine knobs:

    {
      "ir_version": 1,
      "name": "gemm-16x16x16",
      "nests": [
        {
          "loops": [
            {"trip": 16, "start": 0, "step": 1,
             "trip_coeff": 0, "start_coeff": 0},
            ...
          ],
          "refs": [
            {"name": "C0", "array": "C", "level": 1,
             "coeffs": [16, 1], "const": 0, "slot": "pre",
             "share_threshold": null, "share_ratio": null,
             "write": null},
            ...
          ]
        }
      ],
      "machine": {"thread_num": 4, "chunk_size": 4,
                  "ds": 8, "cls": 64, "cache_kb": 2560}   // optional
    }

Loop fields beyond `trip` and ref fields beyond name/array/level/
coeffs are optional with the ir.py defaults, so hand-written nests
stay short; `program_to_json` always emits every field explicitly so
dumps are self-documenting copy-paste templates. Triangular inner
bounds ride `trip_coeff`/`start_coeff` (affine in the parallel value
v0, ir.Loop), non-unit strides ride `step`, imperfect nests ride
`level`/`slot`, and the race detector's write tri-state rides
`write` (true/false/null = derive from duplicated maps).

The `name` participates in the canonical IR and therefore in the
request fingerprint (service/fingerprint.py hashes the Program
including its name, because dumps are labeled by it): a custom nest
that should share the cache slot of a registry model must carry the
registry program's name — which is exactly what `--dump-ir` emits.

`machine` knobs, when present, override the request-level machine
fields for service submissions (AnalysisRequest.machine), so a
document is a complete scenario description on its own.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..config import MachineConfig
from ..ir import Program

# Bump on ANY change to the document shape; parse.py rejects other
# versions with F_VERSION so future readers never misinterpret v1
# documents.
IR_SCHEMA_VERSION = 1

MACHINE_FIELDS = ("thread_num", "chunk_size", "ds", "cls", "cache_kb")

LOOP_FIELDS = ("trip", "start", "step", "trip_coeff", "start_coeff")
LOOP_REQUIRED = ("trip",)
REF_FIELDS = ("name", "array", "level", "coeffs", "const", "slot",
              "share_threshold", "share_ratio", "write")
REF_REQUIRED = ("name", "array", "level", "coeffs")


def program_to_json(program: Program,
                    machine: Optional[MachineConfig] = None) -> dict:
    """The canonical JSON document for a Program (all fields
    explicit). With `machine`, the knobs are embedded so the document
    is a full scenario template."""
    doc: dict = {
        "ir_version": IR_SCHEMA_VERSION,
        "name": program.name,
        "nests": [
            {
                "loops": [dataclasses.asdict(lp) for lp in nest.loops],
                "refs": [
                    {
                        "name": r.name,
                        "array": r.array,
                        "level": r.level,
                        "coeffs": list(r.coeffs),
                        "const": r.const,
                        "slot": r.slot,
                        "share_threshold": r.share_threshold,
                        "share_ratio": r.share_ratio,
                        "write": r.write,
                    }
                    for r in nest.refs
                ],
            }
            for nest in program.nests
        ],
    }
    if machine is not None:
        doc["machine"] = dataclasses.asdict(machine)
    return doc


def program_from_json(doc: dict) -> Program:
    """Strict round-tripper: parse, validate, canonicalize. Raises
    `parse.FrontendError` (diagnostics attached) on any defect —
    `parse.parse_program_doc` is the non-raising form."""
    from .parse import parse_program

    return parse_program(doc)


def machine_from_doc(doc, defaults: MachineConfig) -> MachineConfig:
    """The document's machine knobs over `defaults`. Documents without
    a machine section (or non-dict input) return `defaults` unchanged.
    Raises ValueError for knob values MachineConfig rejects — callers
    on the service path see only documents parse.py already vetted."""
    machine = doc.get("machine") if isinstance(doc, dict) else None
    if not isinstance(machine, dict):
        return defaults
    kw = dataclasses.asdict(defaults)
    kw.update({k: machine[k] for k in MACHINE_FIELDS if k in machine})
    return MachineConfig(**kw)
