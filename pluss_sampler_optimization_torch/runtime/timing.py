"""Timing runtime — the reference's timer + cache-flush protocol.

Mirrors c_lib/test/runtime/pluss.cpp:

- wall timer: `gettimeofday` delta in seconds (rtclock, pluss.cpp:45-54;
  start/stop/print :86-124) -> time.perf_counter here;
- optional cycle-accurate counter (`PLUSS_CYCLE_ACCURATE_TIMER`, RDTSC,
  pluss.cpp:57-69) -> time.perf_counter_ns;
- `_polybench_flush_cache` before timing: sum over a 2.5 MB calloc'd
  buffer to evict the LLC (pluss.cpp:71-81, POLYBENCH_CACHE_SIZE_KB
  2560 :9-11). Meaningful for the native CPU baseline; on TPU the
  equivalent staleness guard is executing with fresh device buffers,
  so flush() is a host-side no-op cost there.
"""

from __future__ import annotations

import time

import numpy as np

_CACHE_SIZE_KB = 2560  # POLYBENCH_CACHE_SIZE_KB, pluss.cpp:9-11


def flush_cache(cache_kb: int = _CACHE_SIZE_KB) -> float:
    """`_polybench_flush_cache` (pluss.cpp:71-81): walk a buffer larger
    than the LLC; returns the sum so the work cannot be elided."""
    cs = cache_kb * 1024 // 8
    # np.empty + fill dirties distinct physical pages; calloc-backed
    # np.zeros would alias every read onto the shared zero page and
    # leave the LLC warm.
    buf = np.empty(cs, dtype=np.float64)
    buf.fill(0.0)
    s = float(buf.sum())
    assert s <= 10.0  # polybench's own guard (pluss.cpp:79)
    return s


class Timer:
    """pluss_timer_start/stop/print (pluss.cpp:86-124).

    The cache flush runs BEFORE the timed region and its cost is
    recorded separately (`flush_s`, reset at every start): on hosts
    where the 2.5 MB walk is slow it must never pollute the measured
    per-rep seconds, and recording it makes the overhead auditable
    (`timed` returns the per-rep flush costs alongside the rep times).
    """

    def __init__(self, cycle_accurate: bool = False, flush: bool = True,
                 flush_kb: int = _CACHE_SIZE_KB) -> None:
        self.cycle_accurate = cycle_accurate
        self.flush = flush
        self.flush_kb = flush_kb
        self.elapsed = 0.0
        self.cycles = 0
        self.flush_s = 0.0
        self._t0 = 0.0
        self._c0 = 0

    def start(self) -> None:
        if self.flush:
            t0 = time.perf_counter()
            flush_cache(self.flush_kb)
            self.flush_s = time.perf_counter() - t0
        else:
            self.flush_s = 0.0
        if self.cycle_accurate:
            self._c0 = time.perf_counter_ns()
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        self.elapsed = time.perf_counter() - self._t0
        if self.cycle_accurate:
            self.cycles = time.perf_counter_ns() - self._c0
        return self.elapsed

    def print(self) -> None:
        # pluss_timer_print emits the bare seconds value (pluss.cpp:120-124)
        if self.cycle_accurate:
            print(f"{self.elapsed:.6f} ({self.cycles} ns)")
        else:
            print(f"{self.elapsed:.6f}")


def timed(fn, reps: int = 1, cycle_accurate: bool = False,
          flush: bool = True, flush_kb: int = _CACHE_SIZE_KB):
    """Run fn() `reps` times; returns (per-rep seconds, last result,
    per-rep cache-flush seconds). The flush cost is measured outside
    the timed region — per-rep seconds contain only fn() — and
    returned so callers can audit the flush overhead instead of it
    silently disappearing (or, worse, leaking into the reps on hosts
    where the flush walk is slow)."""
    t = Timer(cycle_accurate=cycle_accurate, flush=flush,
              flush_kb=flush_kb)
    times = []
    flushes = []
    result = None
    for _ in range(reps):
        t.start()
        result = fn()
        times.append(t.stop())
        flushes.append(t.flush_s)
    return times, result, flushes
