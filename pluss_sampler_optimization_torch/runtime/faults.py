"""The keyed counter hash of the JAX package's runtime/faults.py.

Only what sampler/confidence.py reads: `counter_u01`, a uniform in
[0, 1) that is a pure function of (seed, path), with its splitmix
finalizer. The rest of that module (the fault injector of the serving
stack) waits for the service; it imports telemetry and the lock
witness, which the port does not have yet.
"""

from __future__ import annotations

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
