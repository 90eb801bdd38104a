"""Canonical digests of structural signature tuples.

The part of the JAX package's service/fingerprint.py that the sampled
engine needs: `structure_digest` keys the kernel-signature buckets
(sampler/sampled.py::_ref_sig_digest). The request fingerprints of the
analysis service come with the service's own slice.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json


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


def structure_digest(obj) -> str:
    """Short (16-hex) digest for in-memory structural cache keys.

    Structurally equal signatures map to equal digests, distinct ones
    to distinct digests (collision odds at 64 bits are negligible
    against tens of entries). Falls back to repr for values canonical
    JSON rejects — signature tuples are ints/strs/bools/None/tuples,
    all covered."""
    try:
        s = canonical_json(obj)
    except TypeError:
        s = repr(obj)
    return hashlib.sha256(s.encode()).hexdigest()[:16]
