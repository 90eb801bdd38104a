"""Replica pool: partition the device set into independent executors.

Before this layer every service execution — solo, singleflighted, or
batched by the admission window — ran on the one implicit default
device set, so a machine with 8 chips served concurrent independent
requests at the throughput of 1. The pool splits its devices (every
visible card by default, or the list it is given, where a device may
repeat: ["cuda:0", "cuda:0"] gives two replicas on one card, ["cpu"] * 4
four on the CPU) into K disjoint device groups (config.py::
ReplicaConfig; CLI `--replicas`), each owning:

- its own 1-D sample mesh over just its devices
  (parallel/mesh.py::build_mesh),
- a work queue and one worker thread (the execution slot),
- a structure-keyed warmup set (service/fingerprint.py::
  structure_digest), so ledger-driven warm start builds and loads each
  kernel signature's kernels once per replica (sampler/sampled.py::
  warmup on the replica's device), not once per request.

Scheduling: `submit` routes each work item (a solo request or a whole
flushed batch window) to the least-loaded replica — shortest queue
(executing counts as one), round-robin among ties. An idle replica
whose own queue is empty STEALS the oldest stealable item from the
longest peer queue (`windows_stolen`), so one slow request cannot
strand queued work behind it.

Failure breakers: a replica whose execution raises has its per-
replica circuit breaker OPENED (the service/breakers.py state
machine, embedded here under the pool's condition lock) — removed
from routing for a probation window, its queue drained onto healthy
peers — and the failing item is re-routed ONCE to the least-loaded
healthy replica, recorded as a degradation event (`{"from":
"replica:K", ...}` in the request's degrade chain, a
`replica_quarantined` telemetry event, and the completion counted
`service_degraded` — so PR 9's live registry windows and the SLO
sentinel's error-budget objective both see it). A re-routed item
that fails AGAIN is attributed to the work, not the replica: the
second replica is NOT opened and the exception propagates to the
executor's normal engine-degradation handling.

Unlike PR 10's one-shot quarantine, an open replica RECOVERS: once
its probation elapses the router hands it exactly one work item as a
half-open probe. Probe success re-closes the breaker
(`replica_breaker_reclosed` — the replica rejoins routing with full
standing); probe failure re-opens it with the probation escalated.
When every replica is open, routing falls back to the full set — a
degraded pool still serves best-effort rather than going dark.

Chaos: each worker pickup passes the `replica_dispatch` injection
site (runtime/faults.py), so tools/check_chaos.py can drive the
open/probe/re-close cycle deterministically.

Placement is pure routing (parallel/placement.py): the per-ref sample
streams are seed-derived, never device-derived, so MRC bytes are
bit-identical for any replica count and for any re-route
(tests/test_replicas.py pins both).
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future

from ..config import ReplicaConfig, ResilienceConfig, SamplerConfig
from ..runtime import faults, lockwitness, telemetry


def current_replica_id():
    """Replica id executing on this thread, or None (fault-injection
    tests and runners key on it)."""
    from ..parallel import placement

    return placement.active_replica_id()


class Replica:
    """One device group + queue + counters + breaker state. All
    mutable state is guarded by the owning pool's condition lock."""

    __slots__ = (
        "rid", "devices", "mesh", "queue", "busy", "state",
        "reopen_at", "probation_s", "reclosed",
        "quarantine_reason", "routed", "served", "stolen", "completed",
        "failed", "warmed",
    )

    def __init__(self, rid: int, devices, mesh):
        self.rid = rid
        self.devices = list(devices)
        self.mesh = mesh
        self.queue: collections.deque = collections.deque()
        self.busy = False
        # per-replica breaker: "closed" | "open" | "half_open"
        # (service/breakers.py semantics, embedded under the pool
        # lock so routing and transitions are one atomic step)
        self.state = "closed"
        self.reopen_at = 0.0  # monotonic instant probation ends
        self.probation_s = 0.0  # current (possibly escalated) window
        self.reclosed = 0  # successful half-open probes
        self.quarantine_reason: str | None = None
        self.routed = 0  # work items routed here at submit
        self.served = 0  # requests whose execution completed here
        self.stolen = 0  # work items this replica stole from peers
        self.completed = 0  # work items finished OK here
        self.failed = 0  # work items that raised here
        self.warmed: set = set()  # structure digests warmed here

    @property
    def quarantined(self) -> bool:
        """Out of normal routing (breaker open or probing)."""
        return self.state != "closed"


class _Work:
    """One queued execution: a thunk plus its routing bookkeeping."""

    __slots__ = ("fn", "future", "trace_id", "members", "pinned",
                 "attempts", "events")

    def __init__(self, fn, future, trace_id, members, pinned):
        self.fn = fn
        self.future = future
        self.trace_id = trace_id
        self.members = members  # requests this item carries (window)
        self.pinned = pinned  # pinned items are never stolen/re-routed
        self.attempts = 0
        self.events: list[dict] = []


class ReplicaPool:
    """K independent device-group executors with load-aware routing,
    work stealing, and failure quarantine."""

    def __init__(self, config: ReplicaConfig | None = None,
                 devices=None,
                 resilience: ResilienceConfig | None = None):
        import torch

        from ..parallel.mesh import build_mesh

        if devices is not None:
            devs = [torch.device(d) for d in devices]
        elif torch.cuda.is_available():
            devs = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        else:
            # no CPU fallback: the CPU serves only when it is asked for
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu'] "
                "(one replica per entry) to serve on the CPU"
            )
        cfg = config or ReplicaConfig()
        res = resilience or ResilienceConfig()
        self._probation_s = res.breaker_probation_s
        self._escalation = res.breaker_escalation
        self._probation_max_s = res.breaker_probation_max_s
        k = cfg.resolve(len(devs))
        # contiguous near-equal groups: the first (len % k) replicas
        # take one extra device
        base, rem = divmod(len(devs), k)
        self.replicas: list[Replica] = []
        lo = 0
        for rid in range(k):
            hi = lo + base + (1 if rid < rem else 0)
            group = devs[lo:hi]
            lo = hi
            self.replicas.append(
                Replica(rid, group, build_mesh(devices=group))
            )
        self._cv = lockwitness.make_condition("ReplicaPool._cv")
        self._closed = False
        self._rr = 0  # round-robin cursor for routing ties
        self._workers = [
            threading.Thread(
                target=self._worker, args=(r,), daemon=True,
                name=f"pluss-replica-{r.rid}",
            )
            for r in self.replicas
        ]
        for t in self._workers:
            t.start()
        telemetry.gauge("replica_count", k)

    # -- public -------------------------------------------------------

    def __len__(self) -> int:
        return len(self.replicas)

    def submit(self, fn, trace_id: str | None = None,
               members: int = 1, replica_id: int | None = None,
               pinned: bool = False) -> Future:
        """Route one execution; the future resolves to
        (fn's result, executing replica id, re-route events)."""
        fut: Future = Future()
        fut.set_running_or_notify_cancel()
        work = _Work(fn, fut, trace_id, members,
                     pinned or replica_id is not None)
        promoted: list[int] = []
        with self._cv:
            if self._closed:
                raise RuntimeError("replica pool is closed")
            if replica_id is not None:
                target = self.replicas[replica_id]
            else:
                target = self._route_locked(promoted)
            target.queue.append(work)
            target.routed += work.members
            gauges = self._gauges_snapshot_locked()
            self._cv.notify_all()
        # telemetry outside the condition lock (C_SINK_UNDER_LOCK):
        # sinks take their own locks and the recorder leg does work
        self._emit_promotions(promoted)
        self._emit_gauges(gauges)
        telemetry.count("requests_routed", work.members)
        return fut

    def run(self, fn, trace_id: str | None = None, members: int = 1):
        """submit() and wait: (result, replica_id, events). Raises
        what fn raised when no re-route could absorb the failure."""
        return self.submit(fn, trace_id=trace_id,
                           members=members).result()

    def warmup(self, program, machine,
               cfg: SamplerConfig | None = None) -> int:
        """Structure-keyed kernel warmup on every live replica: each
        compiles the program's sampled kernel signatures on ITS
        devices, once per structure digest (repeat calls for the same
        structure are free). Returns the number of (replica,
        structure) compilations performed."""
        from .fingerprint import program_payload, structure_digest

        key = (structure_digest(program_payload(program)),
               machine.thread_num,
               machine.chunk_size,
               None if cfg is None else (cfg.ratio, cfg.device_draw))
        futs = []
        with self._cv:
            todo = [r for r in self.replicas
                    if not r.quarantined and key not in r.warmed]
            for r in todo:
                r.warmed.add(key)
        for r in todo:
            futs.append(self.submit(
                self._warmup_thunk(program, machine, cfg, r.devices[0]),
                replica_id=r.rid, pinned=True,
            ))
        for f in futs:
            f.result()
        return len(futs)

    @staticmethod
    def _warmup_thunk(program, machine, cfg, device):
        def thunk():
            from ..sampler.sampled import warmup as sampled_warmup

            sampled_warmup(program, machine, cfg, device=device)

        return thunk

    def snapshot(self) -> dict:
        """Per-replica occupancy for serve `stats` (the instance-local
        view; `/metrics` and the ledger aggregate report the same
        counts under requests_routed_r*/replica_id)."""
        now = time.monotonic()
        with self._cv:
            reps = [
                {
                    "replica_id": r.rid,
                    "devices": len(r.devices),
                    "queue_depth": len(r.queue),
                    "executing": int(r.busy),
                    "routed": r.routed,
                    "served": r.served,
                    "stolen": r.stolen,
                    "completed": r.completed,
                    "failed": r.failed,
                    "quarantined": r.quarantined,
                    "breaker": r.state,
                    "breaker_reclosed": r.reclosed,
                    **(
                        {"quarantine_reason": r.quarantine_reason}
                        if r.quarantined else {}
                    ),
                    **(
                        {"reopen_in_s": round(
                            max(0.0, r.reopen_at - now), 3)}
                        if r.state == "open" else {}
                    ),
                }
                for r in self.replicas
            ]
        return {
            "count": len(reps),
            "quarantined": sum(1 for r in reps if r["quarantined"]),
            "replicas": reps,
        }

    def close(self) -> None:
        """Stop the workers; queued-but-unstarted work fails with
        RuntimeError (the executor drains its own pool first, so in
        the normal shutdown order nothing is pending here)."""
        with self._cv:
            self._closed = True
            pending = [w for r in self.replicas for w in r.queue]
            for r in self.replicas:
                r.queue.clear()
            self._cv.notify_all()
        for w in pending:
            w.future.set_exception(
                RuntimeError("replica pool closed")
            )
        for t in self._workers:
            t.join(timeout=5.0)

    # -- routing ------------------------------------------------------

    def _route_locked(self, promoted: list | None = None) -> Replica:
        """Least-loaded live replica (queue + executing), round-robin
        among ties. An OPEN replica whose probation has elapsed is
        promoted to half_open and takes this one work item as its
        probe (success re-closes it in _execute; failure re-opens
        escalated in _handle_failure). All-open pools route across
        the full set: best-effort beats going dark.

        Promotions are appended to `promoted` (replica ids) for the
        caller to emit via _emit_promotions AFTER releasing `_cv` —
        never from inside the critical section."""
        now = time.monotonic()
        for r in self.replicas:
            if r.state == "open" and now >= r.reopen_at:
                r.state = "half_open"
                if promoted is not None:
                    promoted.append(r.rid)
                return r
        live = [r for r in self.replicas if r.state == "closed"]
        if not live:
            live = self.replicas
        load = lambda r: len(r.queue) + (1 if r.busy else 0)
        best = min(load(r) for r in live)
        ties = [r for r in live if load(r) == best]
        self._rr += 1
        return ties[self._rr % len(ties)]

    def try_cancel(self, future) -> bool:
        """Remove a still-QUEUED work item by its future (the hedging
        loser: the executor submits a duplicate to a second replica
        and cancels whichever copy has not started when the first
        result lands). True when the item was found and removed; False
        means it is executing (or done) and will resolve normally."""
        gauges = None
        with self._cv:
            for r in self.replicas:
                for w in r.queue:
                    if w.future is future:
                        r.queue.remove(w)
                        gauges = self._gauges_snapshot_locked()
                        break
                if gauges is not None:
                    break
        if gauges is None:
            return False
        self._emit_gauges(gauges)
        telemetry.count("replica_work_cancelled")
        return True

    def _gauges_snapshot_locked(self) -> list:
        """(name, value) pairs computed under `_cv`; the caller emits
        them with _emit_gauges after release (C_SINK_UNDER_LOCK)."""
        busy = sum(1 for r in self.replicas if r.busy)
        queued = sum(len(r.queue) for r in self.replicas)
        pairs = [
            ("replica_utilization",
             round(busy / len(self.replicas), 4)),
            ("replica_queue_depth", queued),
        ]
        for r in self.replicas:
            pairs.append(
                (f"replica_queue_depth_r{r.rid}", len(r.queue))
            )
        return pairs

    @staticmethod
    def _emit_gauges(pairs: list) -> None:
        for name, value in pairs:
            telemetry.gauge(name, value)

    @staticmethod
    def _emit_promotions(promoted: list) -> None:
        for rid in promoted:
            telemetry.count("replica_breaker_half_open")
            telemetry.event("replica_breaker_half_open", replica=rid)

    # -- worker -------------------------------------------------------

    def _worker(self, replica: Replica) -> None:
        while True:
            work = None
            stolen_members = 0
            with self._cv:
                while work is None:
                    if self._closed:
                        return
                    if replica.queue:
                        work = replica.queue.popleft()
                    elif not replica.quarantined:
                        work = self._steal_locked(replica)
                        if work is not None:
                            stolen_members = work.members
                    if work is None:
                        self._cv.wait()
                replica.busy = True
                gauges = self._gauges_snapshot_locked()
            if stolen_members:
                telemetry.count("windows_stolen", stolen_members)
            self._emit_gauges(gauges)
            self._execute(replica, work)
            with self._cv:
                replica.busy = False
                gauges = self._gauges_snapshot_locked()
                self._cv.notify_all()
            self._emit_gauges(gauges)

    def _steal_locked(self, thief: Replica):
        """Oldest stealable item from the longest peer queue. The
        caller counts windows_stolen after releasing `_cv`."""
        victims = sorted(
            (r for r in self.replicas
             if r is not thief and r.queue),
            key=lambda r: -len(r.queue),
        )
        for victim in victims:
            for work in victim.queue:
                if not work.pinned:
                    victim.queue.remove(work)
                    thief.stolen += 1
                    return work
        return None

    def _execute(self, replica: Replica, work: _Work) -> None:
        from ..parallel import placement
        from ..runtime.obs import metrics as obs_metrics

        t0 = time.perf_counter()
        try:
            faults.fire("replica_dispatch", key=work.trace_id,
                        replica=replica.rid)
            with placement.device_scope(
                replica.devices, mesh=replica.mesh,
                replica_id=replica.rid,
            ):
                result = work.fn()
        except Exception as exc:
            self._handle_failure(replica, work, exc)
            return
        dt = time.perf_counter() - t0
        reclosed = False
        with self._cv:
            replica.completed += 1
            replica.served += work.members
            if replica.state != "closed":
                # successful half-open probe (or a pinned/stolen item
                # that completed here): the breaker re-closes and the
                # replica rejoins routing with full standing
                replica.state = "closed"
                replica.quarantine_reason = None
                replica.probation_s = self._probation_s
                replica.reclosed += 1
                reclosed = True
                self._cv.notify_all()
        if reclosed:
            telemetry.count("replica_breaker_reclosed")
            telemetry.event("replica_breaker_reclosed",
                            replica=replica.rid)
        telemetry.count(f"requests_routed_r{replica.rid}",
                        work.members)
        if obs_metrics.get() is not None:
            obs_metrics.observe(
                f"request_execute_s_r{replica.rid}", dt,
                exemplar=work.trace_id,
            )
        work.future.set_result((result, replica.rid, work.events))

    def _handle_failure(self, replica: Replica, work: _Work,
                        exc: Exception) -> None:
        """Open the replica's breaker (or re-open it escalated after
        a failed half-open probe) and re-route the item once; a
        second failure (or nowhere to go) propagates to the caller."""
        reason = repr(exc)[:200]
        drained: list[_Work] = []
        target = None
        probe_failed = False
        promoted: list[int] = []
        gauges: list = []
        with self._cv:
            replica.failed += 1
            if (work.attempts == 0 and not work.pinned
                    and not self._closed):
                peers = [r for r in self.replicas
                         if r is not replica
                         and r.state == "closed"]
                if peers:
                    if replica.state == "half_open":
                        # failed probe: back to open, probation
                        # escalated (capped) — a flapping replica
                        # gets probed less and less often
                        probe_failed = True
                        replica.probation_s = min(
                            replica.probation_s * self._escalation,
                            self._probation_max_s,
                        )
                    elif replica.state == "closed":
                        replica.probation_s = self._probation_s
                    if replica.state != "open":
                        replica.state = "open"
                        replica.reopen_at = (
                            time.monotonic() + replica.probation_s
                        )
                        replica.quarantine_reason = reason
                        # strand nothing behind an opened replica:
                        # its queued, unpinned items re-route too
                        drained = [w for w in replica.queue
                                   if not w.pinned]
                        for w in drained:
                            replica.queue.remove(w)
                    work.attempts += 1
                    load = lambda r: len(r.queue) + (1 if r.busy else 0)
                    target = min(peers, key=load)
                    work.events.append({
                        "from": f"replica:{replica.rid}",
                        "to": f"replica:{target.rid}",
                        "reason": f"replica quarantined: {reason}",
                    })
                    target.queue.append(work)
                    for w in drained:
                        self._route_locked(promoted).queue.append(w)
                    gauges = self._gauges_snapshot_locked()
                    self._cv.notify_all()
        if target is None:
            work.future.set_exception(exc)
            return
        self._emit_promotions(promoted)
        self._emit_gauges(gauges)
        telemetry.count("replica_quarantined")
        telemetry.event(
            "replica_quarantined", replica=replica.rid,
            rerouted_to=target.rid, drained=len(drained),
            reason=reason, probe_failed=probe_failed,
            probation_s=round(replica.probation_s, 3),
        )
