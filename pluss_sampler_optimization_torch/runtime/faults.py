"""Deterministic seeded fault injection for chaos-hardened serving.

Every hot path of the serving stack carries a NAMED injection site:

    engine_execute    service/executor.py — one engine attempt
    replica_dispatch  service/replicas.py — a replica worker picking
                      up one work item
    cache_load        service/cache.py — a disk-tier record read
    cache_store       service/cache.py — a disk-tier record write
    serve_line        service/api.py — one serve_jsonl request line
    worker_conn       service/fabric/router.py — one frame send on a
                      router->worker link
    worker_exec       service/fabric/worker.py — one request frame
                      received by a worker
    round_exec        sampler/sampled.py::run_sampled_progressive —
                      one progressive-precision round about to
                      execute (latency/hang here overruns a request
                      deadline mid-run, forcing the deterministic
                      partial_final path tools/check_chaos.py pins)

With no injector installed (the default), every site is a two-opcode
no-op — `fire()` returns on a single module-global None check, so the
fault layer is compiled in at zero cost (tier-1 pins MRC bytes
bit-identical with the layer present but disabled).

With an injector installed (config.FaultConfig via `install()` /
`install_from_file()`, CLI `--fault-spec FILE`), each occurrence of a
site draws a uniform from a COUNTER-HASH stream — a threefry-style
construction: u = mix(seed, site, rule, key, occurrence#) — so a
chaos run is exactly reproducible from (seed, spec) regardless of
thread interleaving: the per-(site, key) occurrence counters make a
request's fault decisions a function of its own attempt history, not
of what other threads did in between. Fault kinds:

    raise            the site raises FaultInjected
    compile_failure  the site raises CompileFault (an XLA-build-like
                     failure: retried/degraded like any engine error)
    latency          the site sleeps `latency_s` (default 50 ms)
    hang             the site sleeps `hang_s` (default 2 s) — sized to
                     exceed a per-attempt timeout, this is the replica
                     -hang scenario that drives hedged dispatch
    corrupt          cache_load only (`mangle()`): the parsed record
                     is replaced with one that fails validation, so
                     the loader's quarantine path fires
    disconnect       fabric sites: the site raises DisconnectFault —
                     the router treats it as a link failure (bounded
                     reconnect, then re-dispatch to the ring
                     successor), a worker abruptly drops its router
                     connection (the partition-blip scenario
                     tools/check_chaos.py pins)

The same module hosts the SEEDED retry jitter (`backoff_delay`):
deterministic exponential backoff whose jitter comes from the same
counter-hash stream, never from wall clock or `random` —
tools/lint_determinism.py lints `_mix`/`counter_u01`/`backoff_delay`
with the wallclock rules extended to perf_counter/monotonic, so a
wall-clock-jitter regression is caught while the seeded form passes.
"""

from __future__ import annotations

import collections
import json
import threading
import time

from ..config import FaultConfig
from . import lockwitness, telemetry


class FaultInjected(RuntimeError):
    """An injected fault (kind "raise"/"corrupt" at a raise site)."""


class CompileFault(FaultInjected):
    """An injected compile failure (kind "compile_failure")."""


class DisconnectFault(FaultInjected):
    """An injected connection drop (kind "disconnect" at the fabric
    sites): the catcher severs the affected socket instead of
    answering, exercising the reconnect/re-dispatch path."""


_MASK = (1 << 64) - 1


def _mix(x: int) -> int:
    """64-bit splitmix finalizer: the avalanche step of the counter
    hash. Pure integer arithmetic — platform- and hash-seed-free."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return (x ^ (x >> 31)) & _MASK


def counter_u01(seed: int, *path) -> float:
    """Uniform in [0, 1) from (seed, path) — a keyed counter hash in
    the threefry spirit: the value is a pure function of the inputs,
    so any consumer replays exactly from them."""
    x = _mix(seed & _MASK)
    for part in path:
        if isinstance(part, str):
            for b in part.encode("utf-8"):
                x = _mix(x ^ b)
        else:
            x = _mix(x ^ (int(part) & _MASK))
    return _mix(x) / float(1 << 64)


def backoff_delay(attempt: int, base_s: float, max_s: float,
                  seed: int, *key) -> float:
    """Deterministic exponential backoff with seeded jitter.

    bound = min(max_s, base_s * 2^attempt); the returned delay is
    uniform in [bound/2, bound) drawn from the counter-hash stream
    keyed on (seed, "backoff", attempt, key) — same (seed, request,
    attempt) => same delay, every run."""
    bound = min(float(max_s), float(base_s) * (2.0 ** attempt))
    u = counter_u01(seed, "backoff", attempt, *key)
    return bound * (0.5 + 0.5 * u)


class FaultInjector:
    """Rule matcher + deterministic occurrence counters for one
    installed FaultConfig."""

    def __init__(self, config: FaultConfig):
        self.config = config
        self._lock = lockwitness.make_lock("FaultInjector._lock")
        # occurrences per (site, key): the counter component of the
        # (seed, site, rule, key, occurrence) draw
        self._occurrences: collections.Counter = collections.Counter()
        # fires per (rule index, key): enforces per-key max_fires
        self._fired: collections.Counter = collections.Counter()
        self._fired_by_kind: collections.Counter = collections.Counter()

    def stats(self) -> dict:
        with self._lock:
            by_kind = dict(self._fired_by_kind)
        return {
            "seed": self.config.seed,
            "rules": len(self.config.rules),
            "fired": sum(by_kind.values()),
            "fired_by_kind": by_kind,
        }

    def total_fired(self) -> int:
        with self._lock:
            return sum(self._fired_by_kind.values())

    def match(self, site: str, key, kinds=None, **ctx):
        """The rule that fires for this occurrence of `site`, or None.

        ONE occurrence counter tick per call (whether or not anything
        fires), so the decision stream is stable under retries and
        hedges: attempt k of request `key` at `site` always sees
        occurrence number k."""
        with self._lock:
            self._occurrences[(site, key)] += 1
            occurrence = self._occurrences[(site, key)]
        for idx, rule in enumerate(self.config.rules):
            if rule.get("site") != site:
                continue
            kind = rule.get("kind")
            if kinds is not None and kind not in kinds:
                continue
            match = rule.get("match") or {}
            if any(ctx.get(k) != v for k, v in match.items()):
                continue
            u = counter_u01(
                self.config.seed, site, idx, str(key), occurrence
            )
            if u >= rule.get("p", 1.0):
                continue
            max_fires = rule.get("max_fires", 0)
            with self._lock:
                if max_fires and self._fired[(idx, key)] >= max_fires:
                    continue
                self._fired[(idx, key)] += 1
                self._fired_by_kind[kind] += 1
            telemetry.count("faults_injected")
            telemetry.count(f"fault_{site}_{kind}")
            telemetry.event(
                "fault_injected", site=site, kind=kind, rule=idx,
                key=str(key), occurrence=occurrence,
            )
            return rule
        return None


_INSTALL_LOCK = lockwitness.make_lock("faults._INSTALL_LOCK")
_INJECTOR: FaultInjector | None = None


def install(config: FaultConfig) -> FaultInjector:
    """Install (replacing any previous) the process-global injector."""
    global _INJECTOR
    with _INSTALL_LOCK:
        _INJECTOR = FaultInjector(config)
        return _INJECTOR


def load_spec(path: str) -> FaultConfig:
    """Parse a `--fault-spec` JSON document into a FaultConfig."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError("fault spec must be a JSON object")
    unknown = set(doc) - {"seed", "rules"}
    if unknown:
        raise ValueError(
            f"unknown fault-spec fields: {', '.join(sorted(unknown))}"
        )
    return FaultConfig(seed=int(doc.get("seed", 0)),
                       rules=tuple(doc.get("rules", ())))


def install_from_file(path: str) -> FaultInjector:
    return install(load_spec(path))


def uninstall() -> None:
    global _INJECTOR
    with _INSTALL_LOCK:
        _INJECTOR = None


def get() -> FaultInjector | None:
    return _INJECTOR


def fire(site: str, key=None, **ctx) -> None:
    """Maybe inject at `site`. THE hot-path entry point: with no
    injector installed this is one global load + None check."""
    inj = _INJECTOR
    if inj is None:
        return
    rule = inj.match(
        site, key, kinds=("raise", "latency", "hang",
                          "compile_failure", "disconnect"), **ctx
    )
    if rule is None:
        return
    kind = rule["kind"]
    if kind == "latency":
        time.sleep(float(rule.get("latency_s", 0.05)))
        return
    if kind == "hang":
        # a hang is just a long sleep; the executor's per-attempt
        # timeout (and hedged dispatch) are what bound it
        time.sleep(float(rule.get("hang_s", 2.0)))
        return
    message = rule.get("message") or (
        f"injected {kind} fault at {site}"
    )
    if kind == "compile_failure":
        raise CompileFault(message)
    if kind == "disconnect":
        raise DisconnectFault(message)
    raise FaultInjected(message)


def mangle(site: str, record, key=None, **ctx):
    """Maybe corrupt a just-parsed cache record (kind "corrupt" at
    `site`); returns the record unchanged when nothing fires. The
    corrupted stand-in fails service/cache.py::validate_record, so
    the loader's corruption path (count + quarantine + recompute)
    fires exactly as it would for real on-disk damage."""
    inj = _INJECTOR
    if inj is None:
        return record
    rule = inj.match(site, key, kinds=("corrupt",), **ctx)
    if rule is None:
        return record
    if isinstance(record, dict):
        return dict(record, mrc="corrupted-by-fault-injection")
    return "corrupted-by-fault-injection"
