"""Consistent-hash ring: fingerprint -> worker assignment.

The router hashes every request fingerprint onto a ring of virtual
nodes (`vnodes` sha256 points per worker id), so:

- **Affinity**: a fingerprint always lands on the same worker, making
  that worker's in-memory LRU and structure-keyed jit caches hit
  naturally (the disk store stays the shared tier behind everyone).
- **Stability**: the ring is a pure function of the worker ID SET —
  not of addresses, connection order, or time — so assignment is
  identical across router restarts (tools/check_fabric.py pins it)
  and adding worker K+1 moves only ~1/(K+1) of the space.
- **Bounded failover**: when a worker dies, its fingerprints fall to
  their ring successor among the survivors; everyone else's
  assignment is untouched. The `preference` order makes the failover
  target auditable offline: a ledger row's worker_id must be one of
  the first few entries of preference(fingerprint)
  (tools/check_ledger.py --stats validates exactly that).

Pure stdlib (hashlib + bisect) — jax-free, deterministic everywhere.
"""

from __future__ import annotations

import bisect
import hashlib


def _point(label: str) -> int:
    """64-bit ring coordinate of a label (sha256 prefix)."""
    return int(hashlib.sha256(label.encode("utf-8")).hexdigest()[:16],
               16)


class HashRing:
    """Consistent hashing over integer worker ids."""

    def __init__(self, worker_ids, vnodes: int = 64):
        ids = sorted(set(int(w) for w in worker_ids))
        if not ids:
            raise ValueError("ring needs at least one worker id")
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.worker_ids = tuple(ids)
        self.vnodes = vnodes
        points = []
        for wid in ids:
            for v in range(vnodes):
                points.append((_point(f"worker:{wid}#{v}"), wid))
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [w for _, w in points]

    def preference(self, fingerprint: str, k: int | None = None
                   ) -> list[int]:
        """The first k DISTINCT worker ids in ring order from the
        fingerprint's position: preference[0] is the primary
        assignment, preference[1] the re-dispatch successor when the
        primary dies, and so on."""
        if k is None:
            k = len(self.worker_ids)
        k = min(k, len(self.worker_ids))
        start = bisect.bisect_right(
            self._points, _point(f"fp:{fingerprint}")
        )
        out: list[int] = []
        n = len(self._owners)
        for i in range(n):
            wid = self._owners[(start + i) % n]
            if wid not in out:
                out.append(wid)
                if len(out) >= k:
                    break
        return out

    def assign(self, fingerprint: str, alive=None) -> int:
        """The owner of `fingerprint`: the first preference entry, or
        — when an `alive` id set is given — the first LIVE one (the
        ring successor rule the router's re-dispatch follows). Raises
        LookupError when no candidate is alive."""
        for wid in self.preference(fingerprint):
            if alive is None or wid in alive:
                return wid
        raise LookupError("no live worker for fingerprint")
