"""Canonical content fingerprints for analysis requests.

The service's whole caching story rests on one invariant: the
fingerprint is a pure function of everything that determines the
analysis RESULT and of nothing else. Two requests with equal
fingerprints produce bit-identical MRCs (every engine in the exact
family is pinned bit-identical, and the sampled engine is
deterministic in its seed/ratio/draw path), so a fingerprint match is
a correctness-preserving reuse — the compile-once/serve-many
discipline the mesh kernels already apply to executables, applied to
results.

What goes into the hash:

- the **Program IR itself** (loops, refs, affine maps — via
  `dataclasses.asdict`), NOT the model name: two registry entries that
  build the same IR share one cache slot, and a model whose builder
  changes invalidates naturally;
- the **MachineConfig** (every field — thread_num/chunk_size/ds/cls
  shape the interleaving, cache_kb bounds the MRC support);
- the **engine** and its parameters (runtime v1/v2 semantics, and for
  the sampled family: ratio, seed, and the draw-path selector, since
  the two deterministic draw paths produce different sample SETS —
  see SamplerConfig.device_draw);
- a **FINGERPRINT_VERSION** sentinel, bumped whenever the canonical
  payload shape or the result-record schema changes, so stale stores
  are never misread as current.

`structure_digest` is the same canonicalization applied to the kernel
caches' structural signature tuples (sampler/sampled.py::_kernel_sig
and friends): a short stable digest replaces the ad-hoc raw-tuple key,
so every cache in the repo — compiled-kernel and result alike — keys
on one hashing discipline.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

from ..config import MachineConfig
from ..ir import Program

# Bump on ANY change to the canonical payload below OR to the service
# result-record schema (service/cache.py::STORE_VERSION documents the
# record side); old on-disk entries then miss cleanly instead of being
# misinterpreted.
FINGERPRINT_VERSION = 2  # v2: ir.Ref grew the `write` marker field


def _canonical(obj):
    """Recursively convert a payload to canonical JSON-serializable
    form: tuples/lists -> lists, dicts keyed by str with sorted keys
    at dump time, dataclasses -> dicts. Rejects types whose repr is
    identity-dependent rather than value-dependent."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _canonical(dataclasses.asdict(obj))
    if isinstance(obj, dict):
        return {str(k): _canonical(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_canonical(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    raise TypeError(
        f"fingerprint payload contains non-canonical type "
        f"{type(obj).__name__}: {obj!r}"
    )


def canonical_json(obj) -> str:
    """Deterministic JSON: sorted keys, no whitespace variance."""
    return json.dumps(
        _canonical(obj), sort_keys=True, separators=(",", ":")
    )


def content_digest(obj) -> str:
    """sha256 hex of the canonical JSON form (full 64 hex chars)."""
    return hashlib.sha256(canonical_json(obj).encode()).hexdigest()


def structure_digest(obj) -> str:
    """Short (16-hex) digest for in-memory structural cache keys.

    Used where a hashable-but-ad-hoc tuple key served before (the
    jitted-kernel signature caches): structurally equal signatures map
    to equal digests, distinct ones to distinct digests (collision
    odds at 64 bits are negligible against cache sizes of tens of
    entries). Falls back to repr for values canonical JSON rejects —
    signature tuples are ints/strs/bools/None/tuples, all covered."""
    try:
        s = canonical_json(obj)
    except TypeError:
        s = repr(obj)
    return hashlib.sha256(s.encode()).hexdigest()[:16]


def program_payload(program: Program) -> dict:
    """The Program IR as a canonical dict (name included: it labels
    dumps, and byte-equal dumps are part of the cached record)."""
    return _canonical(program)


def machine_payload(machine: MachineConfig) -> dict:
    return _canonical(machine)


def request_fingerprint(
    program: Program,
    machine: MachineConfig,
    engine: str,
    params: dict | None = None,
) -> str:
    """The content address of one analysis result.

    `params` carries the engine-family knobs that change the result
    (runtime semantics, and ratio/seed/device_draw for the sampled
    family); callers pass only the knobs their engine consumes, so an
    exact request's fingerprint is invariant to sampling parameters.
    """
    return content_digest({
        "fingerprint_version": FINGERPRINT_VERSION,
        "program": program_payload(program),
        "machine": machine_payload(machine),
        "engine": engine,
        "params": params or {},
    })
