"""Request-level analysis service of the port, the JAX package's on
the card.

Turns the engines into an on-demand system: content-addressed result
caching (two-tier, versioned, corruption-tolerant — service/cache.py, a
copy of the JAX package's, so each package's store answers the other),
canonical request fingerprints (service/fingerprint.py, a copy),
singleflight request execution with deadlines and engine degradation
(service/executor.py), cross-request batching on the per-row forms of
kernels B1 and B3 (sampler/sampled.py::run_sampled_multi),
replica-pool device partitioning with load-aware routing, work
stealing, and breaker-gated recovery (service/replicas.py), per-attempt
timeouts with seeded-backoff retries, hedged dispatch, circuit breakers
with half-open probation (service/breakers.py, a copy), admission-
controlled load shedding, and the submit/result + JSONL serving API
with graceful drain (service/api.py). CLI entry points: `serve` mode,
`--cache-dir`, `--replicas`, `--fault-spec`, and the resilience flags
(cli.py); store audits: tools/check_service_store.py; the seeded chaos
gate: tools/check_chaos.py.
"""

from .api import (
    AnalysisRequest,
    AnalysisResponse,
    AnalysisService,
    AnalysisTicket,
    GracefulShutdown,
    parse_request_line,
    serve_jsonl,
)
from .breakers import CircuitBreaker
from .cache import STORE_VERSION, ResultCache, validate_record
from .executor import (
    DEGRADE_CHAINS,
    PRIORITY_CLASSES,
    SERVICE_ENGINES,
    RequestExecutor,
    default_runner,
    execute_request,
)
from .fingerprint import (
    FINGERPRINT_VERSION,
    canonical_json,
    content_digest,
    request_fingerprint,
    structure_digest,
)
from .replicas import Replica, ReplicaPool, current_replica_id

__all__ = [
    "AnalysisRequest",
    "AnalysisResponse",
    "AnalysisService",
    "AnalysisTicket",
    "GracefulShutdown",
    "CircuitBreaker",
    "PRIORITY_CLASSES",
    "parse_request_line",
    "serve_jsonl",
    "STORE_VERSION",
    "ResultCache",
    "validate_record",
    "DEGRADE_CHAINS",
    "SERVICE_ENGINES",
    "RequestExecutor",
    "default_runner",
    "execute_request",
    "FINGERPRINT_VERSION",
    "canonical_json",
    "content_digest",
    "request_fingerprint",
    "structure_digest",
    "Replica",
    "ReplicaPool",
    "current_replica_id",
]
