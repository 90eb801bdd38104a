"""The port's sampling profiler (runtime/obs/profiler.py) against the JAX
package's, on the CPU.

The port names a source file once (a dict from co_filename to the file
part of its labels) where the JAX module calls os.path.relpath for every
frame of every sample; every label, snapshot and export stays the JAX
module's byte for byte. Threads parked at known stacks (frames of
files under either package and frames outside both) sample to the same
stacks through both profilers, and a sample of two 16-deep package
threads costs at most half of what it costs with the unmemoized name
function, in the same process (a ratio, not a clock limit). The sampler
kinds of tools/profile_cost.py fold samples as named and restore the
profiler.
"""

import os
import threading
import time

import pytest
from _torch_threads import one_torch_thread  # noqa: F401

from pluss_sampler_optimization_torch.runtime.obs import profiler as TP
from pluss_sampler_optimization_torch.tools import profile_cost
from pluss_sampler_optimization_torch.tools.check_profile import (
    FIXED_SAMPLES,
)
from pluss_sampler_optimization_tpu.runtime.obs import profiler as JP


def _folded(mod, log):
    prof = mod.SamplingProfiler(hz=100.0)
    for path, frames, count in log:
        prof.ingest(path, frames, count)
    prof._duration_s = 1.0  # pin wall time out of the snapshot
    return prof


def _exports(prof, tmp_path, tag):
    ss, cl = tmp_path / f"{tag}.json", tmp_path / f"{tag}.collapsed"
    prof.write_speedscope(str(ss))
    prof.write_collapsed(str(cl))
    return ss.read_bytes(), cl.read_bytes()


@pytest.mark.parametrize("order", ["forward", "reversed"])
def test_fixed_sample_log_snapshot_and_exports_equal_the_jax_profilers(
        tmp_path, order):
    log = FIXED_SAMPLES if order == "forward" else FIXED_SAMPLES[::-1]
    t, j = _folded(TP, log), _folded(JP, log)
    assert t.snapshot() == j.snapshot()
    assert TP.validate_snapshot(t.snapshot()) == []
    assert _exports(t, tmp_path, "t") == _exports(j, tmp_path, "j")
    assert t.collapsed_text() == j.collapsed_text()


_PARKED = (
    "def parked(n, stop):\n"
    "    if n == 0:\n"
    "        stop.wait()\n"
    "        return\n"
    "    return parked(n - 1, stop)\n"
)


def _package_function(root, rel):
    """`parked` compiled as if it lived in root/rel: its frames are
    package frames to a profiler rooted there."""
    ns: dict = {}
    exec(compile(_PARKED, os.path.join(root, rel), "exec"), ns)
    return ns["parked"]


def _outside(fn, n, stop):
    # a frame of this file (outside both packages) under the parked ones
    return fn(n, stop)


class _Parked:
    """Threads parked `depth` frames deep in `parked` under one frame of
    this file, one per function given, until closed."""

    def __init__(self, fns, depth):
        self.stop = threading.Event()
        self.threads = [
            threading.Thread(target=_outside, args=(fn, depth, self.stop),
                             daemon=True) for fn in fns
        ]
        for th in self.threads:
            th.start()
        time.sleep(0.2)  # let each reach its wait

    def close(self):
        self.stop.set()
        for th in self.threads:
            th.join(5.0)


def test_frame_name_equals_the_jax_one_inside_and_outside_the_package():
    # a file under each package: relative to it, and a basename to the
    # other package's profiler
    rel = os.path.join("runtime", "obs", "ledger.py")
    t_in = _package_function(TP._PKG_ROOT, rel).__code__
    j_in = _package_function(JP._PKG_ROOT, rel).__code__
    assert TP._frame_name(t_in) == JP._frame_name(j_in) == \
        "runtime/obs/ledger.py:parked:1"
    assert TP._frame_name(j_in) == JP._frame_name(t_in) == \
        "ledger.py:parked:1"
    # outside both packages: the basename
    for code in (os.path.join.__code__, threading.Thread.run.__code__,
                 _outside.__code__):
        assert TP._frame_name(code) == JP._frame_name(code)
        assert "/" not in TP._frame_name(code).split(":")[0]
    # the per-file memo gives the names' file parts, and whether each
    # file is package code
    for code, inside in ((t_in, True), (j_in, False),
                         (os.path.join.__code__, False)):
        fn = code.co_filename
        assert TP._file_of(fn) == (TP._frame_name(code).split(":")[0],
                                   inside)
        assert TP._file_of(fn) is TP._FILES[fn]


def _parked_stacks(snap):
    return sorted(
        (s["span"], tuple(s["frames"]), s["count"])
        for s in snap["stacks"]
        if any(":parked:" in f for f in s["frames"])
    )


def test_sample_once_over_parked_threads_equals_the_jax_profiler():
    rel = os.path.join("service", "fabric", "router.py")
    parked = _Parked([_package_function(TP._PKG_ROOT, rel),
                      _package_function(JP._PKG_ROOT, rel)], depth=6)
    try:
        t, j = TP.SamplingProfiler(), JP.SamplingProfiler()
        assert t.sample_once() == j.sample_once()
    finally:
        parked.close()
    ts, js = t.snapshot(), j.snapshot()
    got = _parked_stacks(ts)
    assert got == _parked_stacks(js)
    # one thread reads as package code to each profiler, the other as
    # outside it: the same two stacks either way
    for _span, frames, _count in got:
        first = min(i for i, f in enumerate(frames) if ":parked:" in f)
        assert frames[first - 1].startswith(
            "test_torch_profiler.py:_outside:")
        assert len({f for f in frames if ":parked:" in f}) == 1
    assert sorted(next(f for f in s[1] if ":parked:" in f)
                  for s in got) == ["router.py:parked:1",
                                    "service/fabric/router.py:parked:1"]


def _unmemoized(fn):
    # the JAX module's work per frame, rooted at the port's package
    if fn.startswith(TP._PKG_ROOT):
        return os.path.relpath(fn, TP._PKG_ROOT), True
    return os.path.basename(fn), False


def test_sample_once_costs_at_most_half_the_unmemoized_names(monkeypatch):
    fn = _package_function(TP._PKG_ROOT, os.path.join("service", "api.py"))
    parked = _Parked([fn, fn], depth=16)
    try:
        prof = TP.SamplingProfiler()

        def per_sample(reps=5, k=40):
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                for _ in range(k):
                    prof.sample_once()
                best = min(best, (time.perf_counter() - t0) / k)
            return best

        memo = per_sample()
        with monkeypatch.context() as m:
            m.setattr(TP, "_file_of", _unmemoized)
            plain = per_sample()
        memo = min(memo, per_sample())
    finally:
        parked.close()
    assert memo <= 0.5 * plain, (memo, plain)


@pytest.mark.parametrize("kind", profile_cost.KINDS)
def test_profile_cost_kinds_sample_as_named_and_restore(kind):
    """tools/profile_cost.py's sampler kinds: the in-thread ones that walk
    fold samples, "no walk" and the
    ticker process fold none, and every kind leaves the profiler module,
    this thread's CPUs and no ticker process behind."""
    cls = TP.SamplingProfiler
    saved = (TP._file_of, cls._loop, cls.start, cls.stop)
    cpus = os.sched_getaffinity(0)
    with profile_cost.sampler(kind):
        prof = TP.enable(hz=400.0)
        try:
            deadline = time.monotonic() + 5.0
            while (kind in ("port", "jax names", "co-located")
                   and prof._samples_locked == 0
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            ticker = getattr(prof, "_ticker", None)
        finally:
            TP.disable()
    walked = kind in ("port", "jax names", "co-located")
    snap = prof.snapshot()
    assert (snap["samples"] > 0) == walked, snap["samples"]
    assert (TP._file_of, cls._loop, cls.start, cls.stop) == saved
    assert os.sched_getaffinity(0) == cpus
    if kind == "ticker process":
        assert ticker is not None and ticker.poll() is not None
