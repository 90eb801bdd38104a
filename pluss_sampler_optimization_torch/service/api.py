"""AnalysisService: the request-level serving API.

`AnalysisService` owns one two-tier result cache and one request
executor; `submit()` returns a ticket immediately and `result()`
blocks for the response (`analyze()` is both). Identical concurrent
submissions coalesce to one engine execution; warm repeats are served
from the content-addressed store with zero engine work and a
bit-identical MRC (the acceptance invariants, pinned by
tests/test_service.py through telemetry counters).

`serve_jsonl` is the CLI `serve` mode's engine: it reads one JSON
request per line, submits the whole batch up front (so duplicate
requests inside a batch coalesce), then emits one JSON response per
request in input order. Request schema (README "Serving"):

    {"id": "r1", "model": "gemm", "n": 128, "engine": "exact",
     "threads": 4, "chunk": 4, "ratio": 0.1, "seed": 0,
     "deadline_s": 30.0}

Every field except `model` has a default; a malformed line — invalid
JSON, unknown fields, a bad model — is a structured error response
for that line (with the request `id` echoed whenever the line parsed
far enough to carry one), never a crash of the batch. Instead of a
registry `model`, a line may carry an inline `program` document
(frontend/schema.py — README "Custom loop nests"); oversize lines,
over-deep JSON, and hostile bounds products are refused with the
same structured errors plus a `frontend_rejected` counter.

Three introspection request types ride the same protocol:

    {"id": "h1", "type": "healthz"}   -> liveness + engine roster
    {"id": "s1", "type": "stats"}     -> executor queue depth /
        in-flight / coalesce counters, cache tier stats, ledger tail
    {"id": "m1", "type": "metrics"}   -> live metrics registry
        snapshot (rolling-window counters, gauges, per-stage request
        histograms, Prometheus text, latest SLO report)

All answer from the service's instance-local counters / the live
registry (no telemetry run required) with the snapshot taken at the
moment the line is READ — a mid-batch `stats` line observes the
requests submitted before it.

The engines run on the service's `device` (config: CUDA when None,
which raises without a card; "cpu" for the CPU), or on each replica's
device under a replica pool. A request's `kernel_backend` takes the
port's values (auto, cuda, torch, native); the JAX package's xla and
pallas are refused with a message naming the port's.
"""

from __future__ import annotations

import dataclasses
import json
import re
import threading
import time
from concurrent.futures import CancelledError
from typing import IO

import numpy as np

from ..config import MachineConfig
from ..ir import Program
from ..models import build as build_model
from ..runtime import faults
from .cache import ResultCache
from .executor import (
    PRIORITY_CLASSES,
    SERVICE_ENGINES,
    RequestExecutor,
    default_runner,
    progressive_requested,
)
from .fingerprint import request_fingerprint


class GracefulShutdown(BaseException):
    """Raised by the CLI's SIGTERM/SIGINT handlers to unwind
    serve_jsonl. A BaseException on purpose: the serve loop's
    per-line `except Exception` robustness handlers must NOT swallow
    a shutdown into a structured error response — only the dedicated
    handlers in serve_jsonl may catch it."""

# The reserved model name for inline-program requests. Not a registry
# entry: a request carries EITHER a registry model name (model/n/
# tsteps address the builder) OR an inline frontend document
# (`program`), in which case the model field is forced to this
# sentinel so ledger rows, stats, and caches have a uniform label.
CUSTOM_MODEL = "custom"

# The JAX package's kernel backends and the port's that computes the
# same: "xla" the plain tensor code, "pallas" the hand-written kernels.
_JAX_BACKENDS = {"xla": "torch", "pallas": "cuda"}

# Hard per-line budget for the serve protocol. A frontend document
# for any sane nest is a few KB; a line this long is hostile or a
# client bug, and is refused BEFORE json.loads sees it.
MAX_REQUEST_LINE_BYTES = 1 << 20


@dataclasses.dataclass(frozen=True)
class AnalysisRequest:
    """One analysis request. `id`, `deadline_s`, and `trace_id` are
    serving metadata — they identify/bound the request but do not
    change the result, so they stay OUT of the fingerprint and the
    stored record. A caller-supplied `trace_id` propagates through
    singleflight coalescing and batching into the execution span and
    the ledger row; when absent the executor mints one at submit."""

    model: str
    n: int = 128
    tsteps: int = 1
    engine: str = "exact"
    runtime: str = "v1"
    threads: int = 4
    chunk: int = 4
    ds: int = 8
    cls: int = 64
    cache_kb: int = 2560
    ratio: float = 0.1
    seed: int = 0
    device_draw: bool | None = None
    # Dispatch-shape knobs for the sampled engine (None = config
    # default). Pure performance: fused results are bit-identical to
    # the per-ref path, so — unlike device_draw — these MUST NOT
    # enter params()/the fingerprint; a cached result answers both
    # settings.
    fuse_refs: bool | None = None
    pipeline_depth: int | None = None
    # kernel_backend rides with them: all backends fold bit-identical
    # PRIStates (the kernels are held against their plain versions), so
    # it too must stay out of the fingerprint
    kernel_backend: str | None = None
    # Progressive-precision knobs (sampled engine; any one set opts
    # into the round-based driver): stop early once the bootstrap MRC
    # band is narrower than `tolerance`; `max_rounds`/`round_schedule`
    # shape the round ladder (sampler/confidence.py). Like fuse_refs
    # these stay OUT of params()/the fingerprint: a converged
    # progressive run is bit-identical to the one-shot sampled result
    # at the final ratio (and a deadline-truncated partial_final is
    # degraded, hence never cached), so the cached record answers
    # every knob setting.
    tolerance: float | None = None
    max_rounds: int | None = None
    round_schedule: list | None = None
    # Inline frontend document (frontend/schema.py) — the
    # "MRC-as-a-service" path. Mutually exclusive with addressing a
    # registry model: when set, `model` is the CUSTOM_MODEL sentinel
    # and n/tsteps are ignored (the document IS the program). The
    # fingerprint is taken over the canonical parsed IR, so two users
    # submitting structurally identical nests coalesce/cache-hit
    # exactly like repeat registry requests.
    program: dict | None = None
    deadline_s: float | None = None
    # Admission priority class (executor.py::PRIORITY_CLASSES): under
    # overload, low-priority work is shed first and high-priority
    # last. Pure serving policy — never in the fingerprint
    priority: str = "normal"
    id: str | None = None
    trace_id: str | None = None

    def __post_init__(self) -> None:
        if self.engine not in SERVICE_ENGINES:
            raise ValueError(
                f"unknown service engine {self.engine!r} "
                f"(have {', '.join(SERVICE_ENGINES)})"
            )
        if self.priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"unknown priority {self.priority!r} "
                f"(have {', '.join(PRIORITY_CLASSES)})"
            )
        if self.runtime not in ("v1", "v2"):
            raise ValueError("runtime must be 'v1' or 'v2'")
        if self.kernel_backend in _JAX_BACKENDS:
            raise ValueError(
                f"kernel_backend {self.kernel_backend!r} is the JAX "
                f"package's; use {_JAX_BACKENDS[self.kernel_backend]!r} "
                "(have auto, cuda, torch, native)"
            )
        if self.kernel_backend not in (
            None, "auto", "cuda", "torch", "native"
        ):
            raise ValueError(
                f"unknown kernel_backend {self.kernel_backend!r} "
                "(have auto, cuda, torch, native)"
            )
        if self.tolerance is not None and (
            not isinstance(self.tolerance, (int, float))
            or isinstance(self.tolerance, bool)
            or self.tolerance < 0
        ):
            raise ValueError("tolerance must be a non-negative number")
        if self.max_rounds is not None and (
            not isinstance(self.max_rounds, int)
            or isinstance(self.max_rounds, bool)
            or self.max_rounds < 1
        ):
            raise ValueError("max_rounds must be a positive integer")
        if self.round_schedule is not None:
            sched = self.round_schedule
            ok = (
                isinstance(sched, (list, tuple)) and len(sched) > 0
                and all(
                    isinstance(f, (int, float))
                    and not isinstance(f, bool) for f in sched
                )
            )
            if ok:
                fr = [float(f) for f in sched]
                ok = (
                    fr[0] > 0.0 and fr[-1] == 1.0
                    and all(b > a for a, b in zip(fr, fr[1:]))
                )
            if not ok:
                raise ValueError(
                    "round_schedule must be a strictly increasing "
                    "list of fractions in (0, 1] ending at 1.0"
                )
        if self.program is not None:
            if not isinstance(self.program, dict):
                raise ValueError("'program' must be a JSON object")
            if self.model != CUSTOM_MODEL:
                raise ValueError(
                    "inline 'program' requests use model "
                    f"{CUSTOM_MODEL!r}, not {self.model!r}"
                )
        elif self.model == CUSTOM_MODEL:
            raise ValueError(
                f"model {CUSTOM_MODEL!r} requires an inline 'program'"
            )

    def build_program(self) -> Program:
        if self.program is not None:
            from ..frontend.parse import parse_program

            return parse_program(self.program)
        return build_model(self.model, self.n, self.tsteps)

    def machine(self) -> MachineConfig:
        base = MachineConfig(
            thread_num=self.threads, chunk_size=self.chunk,
            ds=self.ds, cls=self.cls, cache_kb=self.cache_kb,
        )
        if self.program is not None:
            # document machine knobs override the request-level
            # fields — a frontend document is a complete scenario on
            # its own (the merged config is what gets fingerprinted)
            from ..frontend.schema import machine_from_doc

            return machine_from_doc(self.program, base)
        return base

    def params(self) -> dict:
        """Engine parameters that shape the RESULT, and only those: an
        exact request's fingerprint must not vary with sampling knobs
        it never reads."""
        p: dict = {}
        if self.engine in ("oracle", "sampled"):
            p["runtime"] = self.runtime
        if self.engine == "sampled":
            p["ratio"] = self.ratio
            p["seed"] = self.seed
            # the requested selector (None = per-backend auto); the
            # two draw paths yield different deterministic sample
            # sets, so an explicit choice must split the address.
            # fuse_refs / pipeline_depth stay OUT: fused dispatch is
            # pinned bit-identical, so they cannot shape the result
            p["device_draw"] = self.device_draw
        return p

    def payload(self) -> dict:
        """The request as stored in the result record (no serving
        metadata)."""
        d = dataclasses.asdict(self)
        d.pop("id")
        d.pop("deadline_s")
        d.pop("trace_id")
        d.pop("priority")
        if d.get("program") is None:
            # registry records keep their pre-frontend shape exactly
            # (store bytes pinned); custom records embed the document
            # so warm_from_ledger can replay them
            d.pop("program")
        for k in ("tolerance", "max_rounds", "round_schedule"):
            # unset progressive knobs are dropped the same way, so
            # every pre-progressive request keeps its exact payload
            # (and stored-record) bytes
            if d.get(k) is None:
                d.pop(k)
        return d

    def fingerprint(self, program: Program | None = None) -> str:
        return request_fingerprint(
            program if program is not None else self.build_program(),
            self.machine(),
            self.engine,
            self.params(),
        )


@dataclasses.dataclass
class AnalysisTicket:
    request: AnalysisRequest
    fingerprint: str
    future: object  # concurrent.futures.Future resolving to a dict


@dataclasses.dataclass
class AnalysisResponse:
    id: str | None
    ok: bool
    fingerprint: str | None
    engine_requested: str | None
    engine_used: str | None
    cache: str | None  # "mem" | "disk" | "miss"
    degraded: list
    latency_s: float | None
    total_accesses: int | None
    access_label: str | None
    mrc: "np.ndarray | None"
    mrc_digest: str | None  # 16-hex digest of the MRC (ledger key)
    rih: dict | None  # int key -> count
    dump_lines: list | None
    per_ref_lines: list | None
    error: str | None
    # trace context: trace_id identifies the request end to end;
    # span_id the (possibly shared — batching/singleflight) engine
    # execution that produced the result. Both null for pure cache
    # hits with no execution.
    trace_id: str | None = None
    span_id: str | None = None
    # the replica whose device group executed the request (None:
    # cache hit, no pool, or failure before execution). Serving
    # metadata only — MRC bytes are identical whichever replica ran
    replica_id: int | None = None
    # ir-preflight summary ({"verdict": "ok"|"race", "races": N}) from
    # the static-analysis gate; None when preflight is disabled.
    # Serving metadata: the verdict never shapes the MRC bytes
    preflight: dict | None = None
    # resilience outcomes (serving metadata): shed = refused at the
    # admission gate (ok is False but nothing failed — the service
    # declined the work); retries/hedged report what the executor
    # spent getting the (bit-identical) result
    shed: bool = False
    retries: int = 0
    hedged: bool = False
    # worker-side stage timings (serving metadata, monotonic deltas on
    # the executing process's clock). Over a fabric these let a client
    # split end-to-end latency into worker time vs routing + wire
    # overhead without any clock agreement (tools/loadgen.py --connect
    # reports exactly that)
    queue_s: float | None = None
    execute_s: float | None = None
    # progressive-precision outcome (serving metadata): rounds the
    # driver completed, the tightest confidence-band width reached,
    # and whether the run converged (band under tolerance / full
    # schedule). partial_final marks a deadline-truncated answer —
    # served at the band above, recorded as a precision:* degrade
    # hop, never cached.
    rounds: int | None = None
    band_width: float | None = None
    converged: bool | None = None
    partial_final: bool = False

    def to_jsonl_dict(self) -> dict:
        """The wire form `serve` emits: compact — the MRC ships in the
        reference's run-length print form (runtime/report.py), not as
        the dense curve (cache_lines can reach 327k entries)."""
        from ..runtime import report

        d: dict = {
            "id": self.id,
            "ok": self.ok,
            "fingerprint": self.fingerprint,
            "engine_requested": self.engine_requested,
            "engine_used": self.engine_used,
            "cache": self.cache,
            "degraded": self.degraded,
            "latency_s": self.latency_s,
            "total_accesses": self.total_accesses,
            "access_label": self.access_label,
        }
        if self.trace_id is not None:
            d["trace_id"] = self.trace_id
        if self.span_id is not None:
            d["span_id"] = self.span_id
        if self.replica_id is not None:
            d["replica_id"] = self.replica_id
        if self.preflight is not None:
            d["preflight"] = self.preflight
        if self.shed:
            d["shed"] = True
        if self.retries:
            d["retries"] = self.retries
        if self.hedged:
            d["hedged"] = True
        if self.queue_s is not None:
            d["queue_s"] = self.queue_s
        if self.execute_s is not None:
            d["execute_s"] = self.execute_s
        if self.rounds is not None:
            d["rounds"] = self.rounds
        if self.band_width is not None:
            d["band_width"] = self.band_width
        if self.converged is not None:
            d["converged"] = self.converged
        if self.partial_final:
            d["partial_final"] = True
        if self.mrc is not None:
            d["mrc_len"] = int(len(self.mrc))
            d["mrc_lines"] = report.mrc_lines(self.mrc, header=False)
        if self.mrc_digest is not None:
            # ties the wire response to its ledger row: a degraded
            # response's digest is attributable after the fact
            d["mrc_digest"] = self.mrc_digest
        if self.error is not None:
            d["error"] = self.error
        return d


def _response_from_outcome(request: AnalysisRequest, fingerprint: str,
                           outcome: dict) -> AnalysisResponse:
    record = outcome.get("record")
    if record is None:
        return AnalysisResponse(
            id=request.id, ok=False, fingerprint=fingerprint,
            engine_requested=request.engine, engine_used=None,
            cache=outcome.get("cache"),
            degraded=outcome.get("degraded") or [],
            latency_s=outcome.get("latency_s"),
            total_accesses=None, access_label=None, mrc=None,
            mrc_digest=None, rih=None, dump_lines=None,
            per_ref_lines=None,
            error=outcome.get("error") or "execution failed",
            trace_id=outcome.get("trace_id"),
            span_id=outcome.get("span_id"),
            replica_id=outcome.get("replica_id"),
            preflight=outcome.get("preflight"),
            shed=bool(outcome.get("shed")),
            retries=int(outcome.get("retries") or 0),
            hedged=bool(outcome.get("hedged")),
            queue_s=outcome.get("queue_s"),
            execute_s=outcome.get("execute_s"),
            rounds=outcome.get("rounds"),
            band_width=outcome.get("band_width"),
            converged=outcome.get("converged"),
            partial_final=bool(outcome.get("partial_final")),
        )
    return AnalysisResponse(
        id=request.id,
        ok=True,
        fingerprint=fingerprint,
        engine_requested=request.engine,
        engine_used=record["engine_used"],
        cache=outcome.get("cache"),
        degraded=outcome.get("degraded") or [],
        latency_s=outcome.get("latency_s"),
        total_accesses=record["total_accesses"],
        access_label=record["access_label"],
        mrc=np.asarray(record["mrc"], dtype=np.float64),
        mrc_digest=outcome.get("mrc_digest"),
        rih={int(k): v for k, v in record["rih"].items()},
        dump_lines=list(record["dump_lines"]),
        per_ref_lines=list(record.get("per_ref_lines", [])) or None,
        error=None,
        trace_id=outcome.get("trace_id"),
        span_id=outcome.get("span_id"),
        replica_id=outcome.get("replica_id"),
        preflight=outcome.get("preflight"),
        retries=int(outcome.get("retries") or 0),
        hedged=bool(outcome.get("hedged")),
        queue_s=outcome.get("queue_s"),
        execute_s=outcome.get("execute_s"),
        rounds=outcome.get("rounds"),
        band_width=outcome.get("band_width"),
        converged=outcome.get("converged"),
        partial_final=bool(outcome.get("partial_final")),
    )


class AnalysisService:
    """submit()/result() over the cache + executor pair, plus the
    healthz/stats introspection the serve protocol exposes."""

    def __init__(self, cache_dir: str | None = None,
                 max_workers: int = 4, mem_entries: int = 128,
                 runner=default_runner,
                 ledger_path: str | None = None,
                 batch_window_ms: float | None = None,
                 batch_max_refs: int = 64,
                 replicas=None,
                 preflight: bool = True,
                 resilience=None,
                 worker_id: int | None = None,
                 device=None):
        from ..config import BatchConfig

        self.cache = ResultCache(cache_dir, mem_entries=mem_entries)
        self.ledger_path = ledger_path
        # static-analysis gate (analysis/__init__.py): validates the
        # IR before fingerprint/cache and attaches the verdict to
        # responses/ledger rows. Off is a debugging escape hatch —
        # MRC bytes are bit-identical either way (the analyzer never
        # touches the engines; pinned by tests/test_analysis.py)
        self.preflight = preflight
        self._preflight_memo: dict = {}
        # optional runtime/obs/slo.py sentinel, attached by the CLI
        # serve mode so the `metrics` request can report the latest
        # SLO evaluation alongside the registry snapshot
        self.slo_sentinel = None
        self.executor = RequestExecutor(
            self.cache, max_workers=max_workers, runner=runner,
            ledger_path=ledger_path,
            batching=(
                BatchConfig(window_ms=batch_window_ms,
                            max_refs=batch_max_refs)
                if batch_window_ms is not None else None
            ),
            # int | ReplicaConfig | None (None = no pool, the PR 9
            # single-device-set behavior)
            replicas=replicas,
            # ResilienceConfig | None (None = every layer off/neutral:
            # no retries, no hedging, no admission limit — the
            # pre-resilience behavior, bit for bit)
            resilience=resilience,
            # fabric attribution: set when this service is one worker
            # of a multi-process fabric (cli serve-worker); ledger
            # rows carry it so a shared ledger shards by worker
            worker_id=worker_id,
            # the engines' device: None (CUDA; every visible card for a
            # replica pool), one device, or a replica pool's devices
            device=device,
        )

    def begin_shutdown(self) -> None:
        """Enter graceful drain: later submits shed at the admission
        gate, queued-but-unstarted work cancels (its waiters get
        structured shed responses from serve_jsonl), executions
        already running finish and are answered normally. Idempotent;
        `close()` still performs the final teardown."""
        self.executor.drain()

    def warm_from_ledger(self, top_n: int) -> int:
        """Ledger-driven warm start: pre-compile the sampled kernel
        signatures of the `top_n` most frequent fingerprints in the
        ledger tail, so the first real request after a restart skips
        cold jit (its ledger row then records near-zero compile
        deltas — the property tests/test_replicas.py pins). Rows
        written before the ledger carried request payloads, and
        non-sampled rows (their engines have no warmup entry point),
        are skipped. Returns the number of warmup executions run."""
        import collections as _collections

        from ..runtime.obs import ledger as obs_ledger
        from .executor import sampler_config

        if not self.ledger_path or top_n <= 0:
            return 0
        try:
            rows = obs_ledger.read_rows(self.ledger_path)
        except Exception:
            return 0
        by_fp: dict = {}
        freq: _collections.Counter = _collections.Counter()
        for row in rows:
            if row.get("kind") != "request":
                continue
            payload = row.get("request")
            if not isinstance(payload, dict):
                continue
            if payload.get("engine") != "sampled":
                continue
            fp = row.get("fingerprint")
            if not fp:
                continue
            freq[fp] += 1 + int(row.get("coalesced") or 0)
            by_fp[fp] = payload
        jobs = []
        for fp, _ in freq.most_common(top_n):
            try:
                req = AnalysisRequest(**by_fp[fp])
                jobs.append((
                    req.build_program(), req.machine(),
                    sampler_config(req),
                ))
            except Exception:
                continue
        return self.executor.warm_structures(jobs)

    def healthz(self) -> dict:
        """Liveness + capability roster (the `healthz` request type).
        """
        from .executor import SERVICE_ENGINES
        from .cache import STORE_VERSION

        ex = self.executor.stats()
        reps = ex.get("replicas") or {}
        return {
            "status": "ok",
            "engines": list(SERVICE_ENGINES),
            "store_version": STORE_VERSION,
            "in_flight": ex["in_flight"],
            "queue_depth": ex["queue_depth"],
            "batch_queue_depth": ex["batch_queue_depth"],
            "replicas": reps.get("count", 0),
            "replicas_quarantined": reps.get("quarantined", 0),
            "ledger": self.ledger_path,
        }

    def stats(self, ledger_tail: int = 5) -> dict:
        """Full introspection snapshot (the `stats` request type):
        executor queue/coalesce/degradation counters incl. batch
        occupancy and batched-vs-solo latency, cache tier stats, the
        ledger tail, and — when a ledger is configured — the ledger's
        cross-run batching aggregate (joined on batch_id rows)."""
        from ..runtime.obs import ledger as obs_ledger

        out = {
            "executor": self.executor.stats(),
            "cache": self.cache.stats(),
            "ledger": self.ledger_path,
            "ledger_tail": (
                obs_ledger.tail(self.ledger_path, ledger_tail)
                if self.ledger_path else []
            ),
        }
        if self.ledger_path:
            try:
                agg = obs_ledger.aggregate(
                    obs_ledger.read_rows(self.ledger_path)
                )
                out["batching"] = agg.get("batching")
            except Exception:
                out["batching"] = None
        return out

    def metrics(self) -> dict:
        """Live-registry snapshot (the `metrics` request type):
        counters with rolling windows, gauges, per-stage request
        histograms, the Prometheus exposition text, and — when a
        sentinel is attached — the latest SLO report. `enabled: false`
        when no registry is installed (metrics.enable() not called)."""
        from ..runtime.obs import metrics as obs_metrics

        reg = obs_metrics.get()
        if reg is None:
            return {"enabled": False}
        out = {"enabled": True}
        out.update(reg.snapshot())
        out["prometheus"] = reg.prometheus_text()
        if self.slo_sentinel is not None:
            out["slo"] = self.slo_sentinel.last_report
        return out

    def dump_debug(self) -> dict:
        """Explicit post-mortem dump (the `dump_debug` request type):
        ask the flight recorder (runtime/obs/recorder.py) to write one
        bundle NOW, bypassing the trigger rate limit, and return its
        path plus the recorder's state and bundle index. `enabled:
        false` when no recorder is installed (serve mode without
        --debug-bundle-dir)."""
        from ..runtime.obs import recorder as obs_recorder

        rec = obs_recorder.get()
        if rec is None:
            return {"enabled": False}
        path = rec.dump("dump_debug")
        return {
            "enabled": True,
            "bundle": path,
            "bundle_dir": rec.bundle_dir,
            "recorder": rec.stats(),
            "bundles": rec.bundle_index(),
        }

    def _run_preflight(self, request: AnalysisRequest,
                       program: Program) -> dict:
        """The static-analysis gate, run before fingerprint/cache.

        Returns the compact preflight summary that rides the outcome/
        response/ledger row; raises `analysis.PreflightError` (with
        machine-readable diagnostics attached) for invalid IR —
        nothing is fingerprinted, cached, or executed for a rejected
        request, and the rejection leaves its own ledger row.

        The verdict is a pure function of (IR, machine), so it is
        memoized per (model, n, tsteps, machine): repeat submissions
        of a warm request skip the analyzer entirely. The per-request
        preflight latency (memo hits included) lands in the
        `request_preflight_s` stage histogram."""
        from .. import analysis
        from ..runtime import telemetry
        from ..runtime.obs import metrics as obs_metrics

        t0 = time.perf_counter()
        if request.program is not None:
            # custom requests have no (model, n) address — memoize on
            # the canonical IR content instead, so identical documents
            # (whatever their JSON spelling) share one verdict
            from .fingerprint import content_digest, program_payload

            key = (CUSTOM_MODEL,
                   content_digest(program_payload(program)),
                   dataclasses.astuple(request.machine()))
        else:
            key = (request.model, request.n, request.tsteps,
                   dataclasses.astuple(request.machine()))
        summary = self._preflight_memo.get(key)
        if summary is None:
            with telemetry.span("ir_preflight", model=request.model,
                                program=program.name,
                                trace_id=request.trace_id):
                report = analysis.analyze_program(
                    program, request.machine()
                )
            summary = report.summary()
            if request.program is not None:
                # the structural signature (16-hex digest form) rides
                # the summary into the outcome and the ledger row, so
                # model:"custom" rows stay attributable to a nest
                # shape without replaying the document
                from .fingerprint import structure_digest

                summary = dict(summary)
                summary["signature"] = structure_digest(
                    report.signature)
            if len(self._preflight_memo) >= 256:
                self._preflight_memo.clear()
            self._preflight_memo[key] = summary
        obs_metrics.observe("request_preflight_s",
                            time.perf_counter() - t0,
                            exemplar=request.trace_id)
        if summary["verdict"] == analysis.VERDICT_INVALID:
            diags = summary.get("diagnostics") or []
            first = diags[0]
            msg = (f"ir preflight rejected {program.name!r}: "
                   f"{first['code']} at {first['path']}: "
                   f"{first['message']}")
            if len(diags) > 1:
                msg += f" (+{len(diags) - 1} more)"
            self.executor._count("preflight_rejected")
            self._ledger_rejection(request, msg)
            raise analysis.PreflightError(msg, diagnostics=diags)
        if summary.get("races"):
            self.executor._count("race_warnings", summary["races"])
        return summary

    def _ledger_rejection(self, request: AnalysisRequest,
                          msg: str) -> None:
        """One `preflight: invalid` request row per rejection — the
        ledger's view of the `ir_preflight_failures` counter
        (check_ledger --stats aggregates it). Never sinks the
        rejection response."""
        if not self.ledger_path:
            return
        from ..runtime.obs import ledger as obs_ledger

        row = {
            "kind": "request", "source": "service", "ok": False,
            "fingerprint": None,
            "engine_requested": request.engine, "engine_used": None,
            "model": request.model, "n": request.n,
            "latency_s": None, "cache": None, "degraded": [],
            "mrc_digest": None,
            "preflight": "invalid",
            "error": msg[:300],
        }
        if request.trace_id is not None:
            row["trace_id"] = request.trace_id
        try:
            obs_ledger.append(self.ledger_path, row)
            self.executor._count("ledger_rows")
        except Exception:
            self.executor._count("ledger_write_failed")

    def submit(self, request: AnalysisRequest,
               on_partial=None) -> AnalysisTicket:
        """Validate, preflight, fingerprint, and schedule (or join) a
        request. Raises ValueError/KeyError for malformed requests
        (PreflightError for invalid IR) — `serve` turns those into
        per-line error responses.

        `on_partial` (progressive-precision requests only) receives
        one interim-round doc per completed round of the (possibly
        shared) execution; see RequestExecutor.submit."""
        if request.program is not None:
            from ..frontend.parse import FrontendError

            try:
                program = request.build_program()
            except FrontendError as e:
                # the frontend's own gate (JSON shape / limits /
                # hostile bounds): counted separately from IR
                # preflight so operators can tell bad documents from
                # bad nests, but ledgered the same way
                self.executor._count("frontend_rejected")
                self._ledger_rejection(request, str(e))
                raise
        else:
            program = request.build_program()
        preflight = (
            self._run_preflight(request, program)
            if self.preflight else None
        )
        fp = request.fingerprint(program)
        fut = self.executor.submit(
            request, program, request.machine(), fp,
            preflight=preflight, on_partial=on_partial,
        )
        return AnalysisTicket(request=request, fingerprint=fp,
                              future=fut)

    def result(self, ticket: AnalysisTicket,
               timeout: float | None = None) -> AnalysisResponse:
        outcome = ticket.future.result(timeout=timeout)
        return _response_from_outcome(
            ticket.request, ticket.fingerprint, outcome
        )

    def analyze(self, request: AnalysisRequest,
                timeout: float | None = None) -> AnalysisResponse:
        return self.result(self.submit(request), timeout=timeout)

    def close(self) -> None:
        self.executor.shutdown()

    def __enter__(self) -> "AnalysisService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


CONTROL_TYPES = ("healthz", "stats", "metrics", "dump_debug")

# Control types answered in the RESPONSE pass (after every request
# line above them has been awaited) instead of as the line is read:
# `metrics` so its live-histogram snapshot is deterministic within a
# batch, `dump_debug` so the bundle's ring records include every
# request the batch completed before the dump line.
_DEFERRED_CONTROL_TYPES = ("metrics", "dump_debug")


def parse_request_line(line: str) -> AnalysisRequest:
    doc = json.loads(line)
    if not isinstance(doc, dict):
        raise ValueError("request line must be a JSON object")
    fields = {f.name for f in dataclasses.fields(AnalysisRequest)}
    unknown = set(doc) - fields
    if unknown:
        raise ValueError(
            f"unknown request fields: {', '.join(sorted(unknown))}"
        )
    if "program" in doc:
        # an inline document IS the scenario; a model/n/tsteps
        # address alongside it would be ambiguous
        clash = sorted({"model", "n", "tsteps"} & set(doc))
        if clash:
            raise ValueError(
                "'program' is mutually exclusive with "
                f"{', '.join(repr(c) for c in clash)}"
            )
        doc = dict(doc)
        doc["model"] = CUSTOM_MODEL
    elif "model" not in doc:
        raise ValueError(
            "request needs a 'model' (or an inline 'program')"
        )
    return AnalysisRequest(**doc)


def _error_msg(e: Exception) -> str:
    # KeyError's str() wraps the message in repr quotes; prefer the
    # raw message for every single-arg exception
    return str(e.args[0]) if len(e.args) == 1 else str(e)


def serve_jsonl(service: AnalysisService | None, in_stream: IO,
                out_stream: IO, device=None) -> int:
    """Process one JSONL request batch; returns the failure count.

    `service` None serves the batch with an AnalysisService of its own
    on `device` (CUDA when None), closed at the end; a given service
    serves on its own device, and `device`, where given, must be it.

    All parseable requests are submitted BEFORE any result is awaited,
    so duplicates inside the batch coalesce onto one execution, and
    responses come out in input order regardless of completion order.

    Robustness contract: NOTHING on a request line aborts the stream.
    Invalid JSON, a non-object line, unknown fields, a bad model, or
    an execution blow-up each yield one structured error response
    (`ok: false`, `line`, `error`) with the request `id` echoed
    whenever the line parsed far enough to carry one. `healthz` /
    `stats` lines (CONTROL_TYPES) answer inline from the service's
    introspection snapshot taken as the line is read; `metrics` and
    `dump_debug` lines evaluate at response time instead, after every
    request line above them has been awaited, so the live histograms
    (and the post-mortem bundle's ring records) they report are
    deterministic within a batch.

    Graceful shutdown: a GracefulShutdown raised into either pass
    (the CLI's SIGTERM/SIGINT handlers) stops reading, drains
    in-flight work to completion, and answers everything already
    submitted — finished results normally, queued-then-cancelled work
    with structured `shed: true` responses. Every submitted request
    resolves exactly once either way.

    Progressive-precision requests (tolerance / max_rounds /
    round_schedule set) additionally STREAM one `"partial": true` doc
    per completed round — `{"id", "partial": true, "round",
    "rounds_total", "band_width", "converged", "mrc_digest",
    "mrc_lines", ...}` — interleaved ahead of the in-order final
    responses (all writes share one lock, so lines never tear). The
    final response for such a request carries `rounds`/`band_width`/
    `converged`, plus `partial_final: true` with a `precision:*`
    degrade hop when its deadline expired mid-schedule.
    """
    if service is None:
        with AnalysisService(device=device) as own:
            return serve_jsonl(own, in_stream, out_stream)
    if device is not None and device != service.executor.device:
        raise ValueError(
            f"serve_jsonl: device {device!r} is not the service's "
            f"{service.executor.device!r}"
        )
    # each entry: {"line", "id", and one of "ticket"+"request" |
    # "control" | "error"}
    entries: list[dict] = []
    # partial frames are written from executor threads while this
    # thread is still reading/awaiting: one lock serializes every
    # out_stream write
    wlock = threading.Lock()

    def _write(doc: dict) -> None:
        with wlock:
            out_stream.write(json.dumps(doc) + "\n")
            out_stream.flush()

    def _partial_writer(req_id):
        def cb(doc: dict) -> None:
            msg = dict(doc)
            msg["id"] = req_id
            _write(msg)
        return cb
    try:
        for line_no, line in enumerate(in_stream, start=1):
            line = line.strip()
            if not line:
                continue
            entry: dict = {"line": line_no, "id": None}
            entries.append(entry)
            if len(line) > MAX_REQUEST_LINE_BYTES:
                # refused before json.loads: the size cap is the OOM
                # guard, so the oversize payload is never materialized
                # as objects. Best-effort id echo from the head only.
                m = re.search(r'"id"\s*:\s*"([^"\\]{1,120})"',
                              line[:4096])
                if m:
                    entry["id"] = m.group(1)
                entry["error"] = (
                    f"request line of {len(line)} bytes exceeds the "
                    f"{MAX_REQUEST_LINE_BYTES}-byte limit"
                )
                service.executor._count("frontend_rejected")
                continue
            try:
                # chaos site: a raise-kind fault on this line is one
                # structured error response, never a stream abort —
                # the same robustness contract malformed JSON gets
                faults.fire("serve_line", key=line_no)
                doc = json.loads(line)
            except faults.FaultInjected as e:
                entry["error"] = f"fault injected: {e}"
                continue
            except RecursionError:
                # hostile nesting deep enough to blow the json
                # parser's stack — same refusal as any bad document
                m = re.search(r'"id"\s*:\s*"([^"\\]{1,120})"',
                              line[:4096])
                if m:
                    entry["id"] = m.group(1)
                entry["error"] = "invalid JSON: nesting too deep"
                service.executor._count("frontend_rejected")
                continue
            except ValueError as e:
                entry["error"] = f"invalid JSON: {e}"
                continue
            if isinstance(doc, dict):
                # echo the id on EVERY response for this line, even
                # when the rest of the request is malformed
                entry["id"] = doc.get("id")
            if isinstance(doc, dict) and doc.get("type") is not None:
                kind = doc.get("type")
                if kind not in CONTROL_TYPES:
                    entry["error"] = (
                        f"unknown request type {kind!r} "
                        f"(have {', '.join(CONTROL_TYPES)})"
                    )
                    continue
                if kind in _DEFERRED_CONTROL_TYPES:
                    # deferred to the response pass: every request
                    # line ABOVE this one has been awaited by then,
                    # so a metrics snapshot deterministically includes
                    # their stage histograms and a dump_debug bundle
                    # includes their ring records (read-time
                    # evaluation would race with worker completion)
                    entry["control"] = {"type": kind, "payload": None}
                    continue
                try:
                    payload = (
                        service.healthz() if kind == "healthz"
                        else service.stats()
                    )
                    entry["control"] = {"type": kind,
                                        "payload": payload}
                except Exception as e:
                    entry["error"] = f"introspection failed: {e!r}"
                continue
            try:
                request = parse_request_line(line)
                cb = None
                if progressive_requested(request):
                    cb = _partial_writer(request.id)
                entry["ticket"] = service.submit(request, on_partial=cb)
                entry["request"] = request
            except Exception as e:
                entry["error"] = _error_msg(e)
                # preflight rejections carry machine-readable
                # diagnostics (code / nest-ref path / message) —
                # surface them on the structured error response
                diags = getattr(e, "diagnostics", None)
                if diags:
                    entry["diagnostics"] = diags
    except GracefulShutdown:
        # stop READING and start draining; every line read so far
        # still gets its response below (in-flight work finishes,
        # queued work sheds). If the interrupted line never produced
        # an entry beyond the placeholder, answer it as shed too.
        service.begin_shutdown()
        if entries and not any(
            k in entries[-1] for k in ("ticket", "control", "error")
        ):
            entries[-1]["error"] = (
                "shed: service shutting down (line not processed)"
            )
            entries[-1]["shed"] = True
    failures = 0
    for entry in entries:
        if "control" in entry:
            payload = entry["control"]["payload"]
            kind = entry["control"]["type"]
            if kind in _DEFERRED_CONTROL_TYPES:
                try:
                    payload = (
                        service.metrics() if kind == "metrics"
                        else service.dump_debug()
                    )
                except Exception as e:
                    payload = {"enabled": False,
                               "error": f"introspection failed: {e!r}"}
            doc = {
                "id": entry["id"],
                "ok": True,
                "type": entry["control"]["type"],
                entry["control"]["type"]: payload,
            }
        elif "ticket" in entry:
            while True:
                try:
                    response = service.result(entry["ticket"])
                    doc = response.to_jsonl_dict()
                except GracefulShutdown:
                    # the signal landed while awaiting a result:
                    # enter the drain and keep answering — every
                    # submitted entry still gets exactly one response
                    service.begin_shutdown()
                    continue
                except CancelledError:
                    # this entry's queued work was cancelled by the
                    # drain before it started executing
                    doc = {
                        "id": entry["request"].id,
                        "ok": False,
                        "line": entry["line"],
                        "shed": True,
                        "error": ("shed: service shutting down "
                                  "(queued request cancelled)"),
                    }
                except Exception as e:
                    # a result()/serialization blow-up is THIS
                    # request's error, never the batch's
                    doc = {
                        "id": entry["request"].id,
                        "ok": False,
                        "line": entry["line"],
                        "error": f"execution failed: {e!r}",
                    }
                break
            if not doc.get("ok"):
                failures += 1
        else:
            failures += 1
            doc = {
                "id": entry["id"],
                "ok": False,
                "line": entry["line"],
                "error": entry["error"],
            }
            if entry.get("diagnostics"):
                doc["diagnostics"] = entry["diagnostics"]
            if entry.get("shed"):
                doc["shed"] = True
        _write(doc)
    return failures
