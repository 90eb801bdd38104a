"""The serving fabric's consistent-hash ring (ring.py, a copy of the JAX
package's): `tools/check_ledger.py --stats` assigns ledger fingerprints
to workers with it. The router and workers come with the fabric."""

from .ring import HashRing

__all__ = ["HashRing"]
