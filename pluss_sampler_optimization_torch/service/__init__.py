"""Service layer of the port: so far only the structural digests the
sampled engine keys its kernel-signature buckets on."""

from .fingerprint import canonical_json, structure_digest

__all__ = ["canonical_json", "structure_digest"]
