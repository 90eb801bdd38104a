"""Service layer of the port: so far the content fingerprints
(fingerprint.py, a copy of the JAX package's: the request fingerprint
the CLI's ledger rows carry, and the structural digests the sampled
engine keys its kernel-signature buckets on) and the fabric's hash ring.
The executor and the serving fronts come with the service's own slice."""

from .fingerprint import canonical_json, request_fingerprint, structure_digest

# The engines the JAX package's analysis service executes (its
# service/executor.py::SERVICE_ENGINES): a CLI ledger row of one of them
# carries the request fingerprint the service would give the same flags.
SERVICE_ENGINES = (
    "oracle", "numpy", "dense", "stream", "periodic", "analytic",
    "exact", "sampled",
)

__all__ = ["SERVICE_ENGINES", "canonical_json", "request_fingerprint",
           "structure_digest"]
