"""Circuit breakers with half-open probation.

One `CircuitBreaker` guards one failure domain — the executor keeps
one per ENGINE (an engine whose attempts keep failing is skipped
cheaply down the degrade chain instead of burning an attempt budget
per request), and the replica pool embeds the same state machine per
REPLICA (service/replicas.py), replacing the one-shot quarantine of
PR 10 with recover-after-probe.

State machine:

    closed      normal service; `failures` CONSECUTIVE failures open
    open        fail fast for `probation_s`; no attempts pass
    half_open   probation elapsed: exactly ONE probe is admitted.
                Probe success -> closed (probation resets); probe
                failure -> open again with probation escalated
                (x escalation, capped at probation_max_s)

All transitions are reported back to the caller (`failure()` returns
True when it OPENED the breaker, `success()` returns True when it
RE-CLOSED it) so the owner can count breaker_opened /
breaker_reclosed on its own counter surfaces without the breaker
knowing about telemetry. The clock is injectable for tests.
"""

from __future__ import annotations

import threading
import time

from ..runtime import lockwitness


class CircuitBreaker:
    """Thread-safe closed/open/half-open breaker."""

    def __init__(self, failures: int = 8, probation_s: float = 30.0,
                 escalation: float = 2.0,
                 probation_max_s: float = 300.0,
                 clock=time.monotonic):
        self.failures = max(1, int(failures))
        self.base_probation_s = float(probation_s)
        self.escalation = float(escalation)
        self.probation_max_s = float(probation_max_s)
        self._clock = clock
        self._lock = lockwitness.make_lock("CircuitBreaker._lock")
        self._state = "closed"
        self._consecutive = 0
        self._probation_s = self.base_probation_s
        self._reopen_at = 0.0
        self._opened = 0
        self._reclosed = 0

    # -- introspection ------------------------------------------------

    def state(self) -> str:
        """Current state; an open breaker past its probation reports
        half_open (the next allow() admits the probe)."""
        with self._lock:
            if (self._state == "open"
                    and self._clock() >= self._reopen_at):
                return "half_open"
            return self._state

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "state": self._state,
                "consecutive_failures": self._consecutive,
                "opened": self._opened,
                "reclosed": self._reclosed,
            }
            if self._state == "open":
                out["reopen_in_s"] = round(
                    max(0.0, self._reopen_at - self._clock()), 3
                )
            return out

    # -- the gate -----------------------------------------------------

    def allow(self) -> bool:
        """May one attempt proceed now? Closed: always. Open: only
        once probation has elapsed, and then exactly one caller wins
        the half-open probe slot until success()/failure() resolves
        it."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "half_open":
                return False  # a probe is already in flight
            if self._clock() >= self._reopen_at:
                self._state = "half_open"
                return True
            return False

    def success(self) -> bool:
        """Record a success; True when this re-closed an open/half-
        open breaker (the probe succeeded)."""
        with self._lock:
            reclosed = self._state != "closed"
            self._state = "closed"
            self._consecutive = 0
            self._probation_s = self.base_probation_s
            if reclosed:
                self._reclosed += 1
            return reclosed

    def failure(self) -> bool:
        """Record a failure; True when this opened (or re-opened) the
        breaker."""
        with self._lock:
            if self._state == "half_open":
                # failed probe: back to open, probation escalated
                self._probation_s = min(
                    self._probation_s * self.escalation,
                    self.probation_max_s,
                )
                self._state = "open"
                self._reopen_at = self._clock() + self._probation_s
                self._opened += 1
                return True
            if self._state == "open":
                return False
            self._consecutive += 1
            if self._consecutive >= self.failures:
                self._state = "open"
                self._reopen_at = self._clock() + self._probation_s
                self._opened += 1
                return True
            return False
