"""Program frontend: arbitrary affine loop nests as request payloads.

"MRC-as-a-service" (ROADMAP item 4): the Program IR is fully general,
but until this package every servable scenario was one of the 18
hand-ported registry models. The frontend closes the gap with a
versioned JSON description of a parallel loop-nest program
(`schema.py`), a strict deserializer with machine-readable
diagnostics that shares the static-analysis code path with the
service preflight (`parse.py`), and a seeded generative fuzzer that
cross-checks the production engines against the numpy oracle on
random valid nests and asserts every invalid mutant is rejected with
a diagnostic (`fuzz.py`, driven by tools/fuzz_ir.py).

Pure numpy + stdlib at import time (no jax): the CLI `analyze` mode,
`--dump-ir`, and tools/check_ir.py stay instant; `fuzz.check_seed`
lazy-imports the engines it exercises.
"""

from .parse import (
    F_ACCESSES,
    F_FIELD,
    F_LIMIT,
    F_MACHINE,
    F_RANGE,
    F_TYPE,
    F_VERSION,
    MAX_TOTAL_ACCESSES,
    FrontendError,
    ParsedProgram,
    malformed_doc_fixtures,
    parse_program,
    parse_program_doc,
)
from .schema import (
    IR_SCHEMA_VERSION,
    machine_from_doc,
    program_from_json,
    program_to_json,
)

__all__ = [
    "F_ACCESSES",
    "F_FIELD",
    "F_LIMIT",
    "F_MACHINE",
    "F_RANGE",
    "F_TYPE",
    "F_VERSION",
    "MAX_TOTAL_ACCESSES",
    "FrontendError",
    "ParsedProgram",
    "malformed_doc_fixtures",
    "parse_program",
    "parse_program_doc",
    "IR_SCHEMA_VERSION",
    "machine_from_doc",
    "program_from_json",
    "program_to_json",
]
