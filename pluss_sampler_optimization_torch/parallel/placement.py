"""Replica device placement: a thread-local device scope the engines
consult when they pick a device.

The replica pool (service/replicas.py) partitions its devices into
disjoint groups; each replica worker thread enters `device_scope(its
devices)` around every engine execution. Inside the scope:

- the engines' `resolve_device(None)` (sampler/sampled.py) takes the
  scope's primary device before its CUDA default, and `place(x)` puts a
  host buffer there (`torch.as_tensor(x, device=...)`; outside a scope,
  plain `torch.as_tensor(x)`);
- for a CUDA device, `torch.cuda.device` is entered, so tensors and
  streams the engines make without naming a device land on the same
  card;
- `active_mesh()` exposes the replica's own 1-D sample mesh
  (parallel/mesh.py::build_mesh over just its devices), which the
  sharded entry points pick up when no mesh and no device is passed.

Devices may repeat, as in parallel/mesh.py: ["cuda:0", "cuda:0"] makes
two replicas on one card, ["cpu"] * 4 four on the CPU.

Placement is pure routing: the per-ref sample streams are derived
from seeds alone (numpy PCG on the host path, threefry counters on
the device path), never from device identity, so results are
bit-identical whichever replica — or how many replicas — served them.
"""

from __future__ import annotations

import contextlib
import threading

_tls = threading.local()


def active_devices():
    """The device group of the enclosing `device_scope`, or None."""
    return getattr(_tls, "devices", None)


def active_device():
    """Primary device of the enclosing scope, or None."""
    devs = active_devices()
    return devs[0] if devs else None


def active_mesh():
    """The enclosing scope's per-replica mesh, or None."""
    return getattr(_tls, "mesh", None)


def active_replica_id():
    """Replica id of the enclosing scope, or None (set by the replica
    pool's workers; fault-injection tests key on it)."""
    return getattr(_tls, "replica_id", None)


@contextlib.contextmanager
def device_scope(devices, mesh=None, replica_id=None):
    """Pin this thread's engine work to `devices` (a non-empty
    sequence of torch devices or their names): the engines resolve to
    devices[0], and a CUDA devices[0] is also torch's current card for
    the scope. Scopes nest; the innermost wins."""
    import torch

    prev = (
        getattr(_tls, "devices", None),
        getattr(_tls, "mesh", None),
        getattr(_tls, "replica_id", None),
    )
    _tls.devices = [torch.device(d) for d in devices]
    _tls.mesh = mesh
    _tls.replica_id = replica_id
    try:
        dev = _tls.devices[0]
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            yield _tls.devices
    finally:
        _tls.devices, _tls.mesh, _tls.replica_id = prev


def place(x):
    """One host buffer on the active scope's primary device; outside
    any scope, plain `torch.as_tensor(x)` (the CPU)."""
    import torch

    dev = active_device()
    if dev is None:
        return torch.as_tensor(x)
    return torch.as_tensor(x, device=dev)
