"""What the sampling profiler costs the sampled engine, and where it goes.

    python3 -m pluss_sampler_optimization_torch.tools.profile_cost
        [--n 1024] [--rounds 3] [--device cuda|cpu] [--kinds port,...]

runtime/obs/profiler.py samples every thread from a thread of its own,
so each sample takes the GIL from a main thread that drops it around
every torch op and kernel launch, then names every frame of every
thread. tools/check_profile.py reads the sum at 8x the 99 Hz rate
against a 3% budget. This tool splits it: first sample_once's
microseconds with the port's frame names and with the JAX module's
(os.path.relpath per frame), each from a thread while this one runs
run_sampled(gemm(n)); then check_profile --n N --json ROUNDS times with
each kind of sampler in turns (KINDS):

- "port": the profiler as it ships;
- "jax names": its samples name each frame as the JAX module does;
- "no walk": a sample takes the GIL and returns, naming nothing;
- "ticker process": no sampler thread; a separate process wakes at the
  same dithered rate, so the host sees the wake-ups but the GIL does not;
- "co-located": the port's sampler, with this thread and the sampler
  pinned to one CPU (os.sched_setaffinity on these two threads only).

Each in-thread kind runs the profiler's own loop, timed: the wait's
lateness (from the end of its timeout to its return, the GIL's wait
included) and the sample's hold of the GIL (from that return to the end
of the sample). Prints one line per check_profile run and a summary per
kind, then the card line.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import random
import statistics
import subprocess
import sys
import threading
import time

KINDS = ("port", "jax names", "no walk", "ticker process", "co-located")

# the ticker process: wakes at the rate in argv[1], dithered as the
# profiler's loop is, until killed
TICKER = ("import random, sys, time\n"
          "print('ready', flush=True)\n"
          "rng = random.Random()\n"
          "while True:\n"
          "    time.sleep((0.5 + rng.random()) / float(sys.argv[1]))\n")


class Waits:
    """The timed loop's record: each wait's lateness and each sample's
    hold, in seconds."""

    def __init__(self):
        self.late: list = []
        self.hold: list = []

    def clear(self) -> None:
        self.late.clear()
        self.hold.clear()


WAITS = Waits()


def _timed_loop(self, walk: bool) -> None:
    """SamplingProfiler._loop with each wait and sample timed into WAITS;
    `walk` False takes the GIL at each tick and samples nothing."""
    interval = 1.0 / self.hz
    rng = random.Random()
    while True:
        d = interval * (0.5 + rng.random())
        t0 = time.perf_counter()
        if self._stop_evt.wait(d):
            break
        t1 = time.perf_counter()
        WAITS.late.append(t1 - t0 - d)
        if walk:
            try:
                self.sample_once()
            except Exception:
                pass
            WAITS.hold.append(time.perf_counter() - t1)


def _jax_file_part(fn: str) -> tuple:
    """The JAX module's frame naming: os.path.relpath per frame."""
    from pluss_sampler_optimization_torch.runtime.obs import profiler

    root = profiler._PKG_ROOT
    if fn.startswith(root):
        return os.path.relpath(fn, root), True
    return os.path.basename(fn), False


@contextlib.contextmanager
def sampler(kind: str):
    """The profiler as `kind` (KINDS) asks, for every profiler.enable()
    inside the block; restores the module and this thread's CPUs."""
    from pluss_sampler_optimization_torch.runtime.obs import profiler

    cls = profiler.SamplingProfiler
    saved = (profiler._file_of, cls._loop, cls.start, cls.stop)
    cpus = os.sched_getaffinity(0)
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; one of {KINDS}")
    if kind == "jax names":
        profiler._file_of = _jax_file_part
    if kind == "no walk":
        cls._loop = lambda self: _timed_loop(self, walk=False)
    elif kind == "ticker process":
        def start(self):
            self._ticker = subprocess.Popen(
                [sys.executable, "-c", TICKER, str(self.hz)],
                stdout=subprocess.PIPE, text=True)
            self._ticker.stdout.readline()
            return saved[2](self)

        def stop(self):
            out = saved[3](self)
            ticker = getattr(self, "_ticker", None)
            if ticker is not None:
                ticker.kill()
                ticker.wait()
                self._ticker = None
            return out

        cls.start, cls.stop = start, stop
        cls._loop = lambda self: self._stop_evt.wait()
    elif kind == "co-located":
        one = {min(cpus)}
        os.sched_setaffinity(0, one)

        def colocated(self):
            os.sched_setaffinity(0, one)
            _timed_loop(self, walk=True)

        cls._loop = colocated
    else:
        cls._loop = lambda self: _timed_loop(self, walk=True)
    try:
        yield
    finally:
        profiler._file_of, cls._loop, cls.start, cls.stop = saved
        os.sched_setaffinity(0, cpus)


def sample_once_us(n: int, device: str, runs: int = 4) -> dict:
    """Microseconds per sample_once call (median, mean, calls), the port's
    names and the JAX module's in turns, each from a thread sampling
    every millisecond while this thread runs run_sampled(gemm(n)) `runs`
    times."""
    from pluss_sampler_optimization_torch.config import (
        MachineConfig,
        SamplerConfig,
    )
    from pluss_sampler_optimization_torch.models import gemm
    from pluss_sampler_optimization_torch.runtime.obs import profiler
    from pluss_sampler_optimization_torch.sampler.sampled import run_sampled

    out: dict = {"port": [], "jax names": []}
    for kind in ("port", "jax names", "port", "jax names"):
        prof = profiler.SamplingProfiler(hz=99.0)
        times: list = []
        stop = threading.Event()

        def loop():
            while not stop.is_set():
                t0 = time.perf_counter()
                prof.sample_once()
                times.append(time.perf_counter() - t0)
                time.sleep(0.001)

        th = threading.Thread(target=loop, daemon=True)
        with sampler(kind):
            th.start()
            try:
                for _ in range(runs):
                    run_sampled(gemm(n), MachineConfig(),
                                SamplerConfig(ratio=0.1, seed=0),
                                device=device)
            finally:
                stop.set()
                th.join()
        out[kind] += times
    return {k: (statistics.median(v) * 1e6, statistics.fmean(v) * 1e6,
                len(v)) for k, v in out.items()}


def check_profile_run(kind: str, n: int, device: str) -> dict:
    """check_profile --device D --n N --json with the sampler `kind`: its
    engine section, with rc and the timed loop's record."""
    from pluss_sampler_optimization_torch.tools import check_profile

    WAITS.clear()
    out = io.StringIO()
    with contextlib.redirect_stdout(out), sampler(kind):
        rc = check_profile.main(["--device", device, "--n", str(n),
                                 "--json"])
    eng = json.loads(out.getvalue())["engine"]
    eng["rc"] = rc
    eng["late"] = sorted(WAITS.late)
    eng["hold"] = sorted(WAITS.hold)
    return eng


def _quantiles(xs: list) -> str:
    if not xs:
        return "none"
    k = len(xs)
    return (f"median {xs[k // 2] * 1e6:.0f} us, p90 "
            f"{xs[int(k * 0.9)] * 1e6:.0f} us ({k})")


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1024,
                    help="GEMM size of the runs (phase 19's check_profile)")
    ap.add_argument("--rounds", type=int, default=3,
                    help="check_profile runs of each kind, in turns")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--kinds", default=",".join(KINDS),
                    help=f"comma-separated, of {', '.join(KINDS)}")
    args = ap.parse_args(argv)
    kinds = [k.strip() for k in args.kinds.split(",") if k.strip()]
    for k in kinds:
        if k not in KINDS:
            ap.error(f"unknown kind {k!r}")

    from pluss_sampler_optimization_torch.config import (
        MachineConfig,
        SamplerConfig,
    )
    from pluss_sampler_optimization_torch.models import gemm
    from pluss_sampler_optimization_torch.sampler.sampled import warmup

    card = card_line() if args.device != "cpu" else "cpu"
    warmup(gemm(args.n), MachineConfig(), SamplerConfig(ratio=0.1, seed=0),
           device=args.device)
    cost = sample_once_us(args.n, args.device)
    (p_med, p_mean, p_k), (j_med, j_mean, j_k) = (cost["port"],
                                                   cost["jax names"])
    print(f"profile cost: sample_once over gemm({args.n}) runs: the port's "
          f"names median {p_med:.1f} us (mean {p_mean:.1f}, {p_k} calls), "
          f"the JAX module's median {j_med:.1f} us (mean {j_mean:.1f}, "
          f"{j_k} calls): {j_med / p_med:.2f}x; {card}", flush=True)
    readings: dict = {k: [] for k in kinds}
    for i in range(args.rounds):
        for kind in kinds:
            eng = check_profile_run(kind, args.n, args.device)
            readings[kind].append(eng["overhead_pct"])
            print(f"profile cost: check_profile run {i + 1}, {kind}: "
                  f"overhead {eng['overhead_pct']:+.2f}% (budget "
                  f"{eng['overhead_budget_pct']:g}%, off "
                  f"{eng['disabled_s']} s, on {eng['enabled_s']} s, rc "
                  f"{eng['rc']}); wait late {_quantiles(eng['late'])}; "
                  f"hold {_quantiles(eng['hold'])}", flush=True)
    for kind, v in readings.items():
        print(f"profile cost: {kind}: "
              f"{', '.join(f'{x:+.2f}%' for x in v)}, mean "
              f"{statistics.fmean(v):+.2f}%; {card}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
