"""Build the port's native library once across test processes.

native/ builds libplussnative.so with make at first use, writing it in
place; two test workers that reach it together could load a library the
other is still writing. `native_built()` runs the build under an
exclusive file lock beside the source, so every later use finds it
whole."""

import fcntl
import os

from pluss_sampler_optimization_torch import native


def native_built() -> None:
    lock = os.path.join(os.path.dirname(native.__file__), ".build.lock")
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            native.ensure_built()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
