"""Seeded bad-pattern fixtures: the analyzer's own regression suite.

Each fixture is a small synthetic module exhibiting exactly one bug
class; `tools/check_concurrency.py --fixtures` (and tier-1 through
tests/test_concurrency_lint.py) asserts every fixture still trips its
expected C_* code. A refactor that silently blinds a rule fails here
before it can let a real deadlock through.

FIXTURES maps name -> (source, expected_rule) in the shared
`lint_common.check_fixtures` convention.
"""

from __future__ import annotations

import textwrap


def _f(src: str) -> str:
    return textwrap.dedent(src).lstrip("\n")


FIXTURES: dict = {
    # two code paths take the same two locks in opposite orders
    "inversion_pair": (_f("""
        import threading

        class Pair:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def forward(self):
                with self._a:
                    with self._b:
                        pass

            def backward(self):
                with self._b:
                    with self._a:
                        pass
    """), "C_LOCK_CYCLE"),

    # Future.result() inside a critical section (the PR 3 bug class)
    "result_under_lock": (_f("""
        import threading

        class Exec:
            def __init__(self):
                self._lock = threading.Lock()
                self._pending = {}

            def submit(self, key, fut):
                with self._lock:
                    prior = self._pending.get(key)
                    if prior is not None:
                        return prior.result()
                    self._pending[key] = fut
                return fut
    """), "C_BLOCKING_UNDER_LOCK"),

    # time.sleep while holding a lock
    "sleep_under_lock": (_f("""
        import threading
        import time

        class Poller:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0

            def poll(self):
                with self._lock:
                    time.sleep(0.1)
                    self.n += 1
    """), "C_BLOCKING_UNDER_LOCK"),

    # file I/O inside a critical section
    "io_under_lock": (_f("""
        import threading

        class Store:
            def __init__(self):
                self._lock = threading.Lock()

            def save(self, path, data):
                with self._lock:
                    with open(path, "w") as fh:
                        fh.write(data)
    """), "C_BLOCKING_UNDER_LOCK"),

    # waiting on one condition while holding an unrelated lock
    "foreign_wait": (_f("""
        import threading

        class Handoff:
            def __init__(self):
                self._lock = threading.Lock()
                self._cv = threading.Condition()

            def take(self):
                with self._lock:
                    with self._cv:
                        self._cv.wait()
    """), "C_BLOCKING_UNDER_LOCK"),

    # non-reentrant lock reacquired on the same path
    "relock": (_f("""
        import threading

        class Nested:
            def __init__(self):
                self._lock = threading.Lock()

            def outer(self):
                with self._lock:
                    with self._lock:
                        pass
    """), "C_RELOCK"),

    # telemetry sink call under a held lock
    "sink_under_lock": (_f("""
        import threading
        from ..runtime import telemetry

        class Counter:
            def __init__(self):
                self._lock = threading.Lock()
                self.hits = 0

            def hit(self):
                with self._lock:
                    self.hits += 1
                    telemetry.count("hits")
    """), "C_SINK_UNDER_LOCK"),

    # instance counter written with and without the lock
    "unguarded_counter": (_f("""
        import threading

        class Stats:
            def __init__(self):
                self._lock = threading.Lock()
                self.served = 0

            def record(self):
                with self._lock:
                    self.served += 1

            def record_fast(self):
                self.served += 1
    """), "C_UNGUARDED_STATE"),

    # signal handler that takes a lock and does I/O
    "unsafe_signal": (_f("""
        import signal
        import threading

        _lock = threading.Lock()

        def _on_term(signum, frame):
            with _lock:
                with open("/tmp/state", "w") as fh:
                    fh.write("bye")

        def install():
            signal.signal(signal.SIGTERM, _on_term)
    """), "C_SIGNAL_UNSAFE"),

    # joining a worker thread while holding the lock it needs
    "join_under_lock": (_f("""
        import threading

        class Pool:
            def __init__(self):
                self._lock = threading.Lock()
                self._threads = []

            def close(self):
                with self._lock:
                    for t in self._threads:
                        t.join()
    """), "C_BLOCKING_UNDER_LOCK"),

    # inversion only visible through the call graph: helper takes B
    # then calls into A-then-B order established elsewhere
    "interprocedural_inversion": (_f("""
        import threading

        class Split:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def _grab_b(self):
                with self._b:
                    pass

            def forward(self):
                with self._a:
                    self._grab_b()

            def _grab_a(self):
                with self._a:
                    pass

            def backward(self):
                with self._b:
                    self._grab_a()
    """), "C_LOCK_CYCLE"),

    # blocking call hidden two frames deep under a held lock
    "blocking_transitive": (_f("""
        import threading
        import time

        class Deep:
            def __init__(self):
                self._lock = threading.Lock()

            def _nap(self):
                time.sleep(0.5)

            def _work(self):
                self._nap()

            def serve(self):
                with self._lock:
                    self._work()
    """), "C_BLOCKING_UNDER_LOCK"),
}
