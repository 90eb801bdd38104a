"""Device meshes of the port.

One flat axis ("samples") is the scale axis: the sharded sampled engine
splits each chunk of samples over it and sums histograms across it. A
mesh is an ordered list of torch devices, one per shard. A device may
repeat: `build_mesh(devices=["cpu"] * 8)` runs eight shards on the CPU,
and `["cuda:0", "cuda:0"]` two shards on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

SAMPLE_AXIS = "samples"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Shard i runs on devices[i]; all devices are CUDA or all CPU."""

    devices: tuple
    axis_name: str = SAMPLE_AXIS

    def __post_init__(self) -> None:
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        types = {d.type for d in devs}
        if len(types) != 1 or not types <= {"cuda", "cpu"}:
            raise ValueError(
                f"mesh devices must be all CUDA or all CPU, got {devs}"
            )
        if "cuda" in types and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; build the mesh over CPU "
                "devices (devices=['cpu']) to run on the CPU"
            )
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)


def local_device_count() -> int:
    """CUDA devices visible to this process."""
    return torch.cuda.device_count()


def build_mesh(
    n_devices: Optional[int] = None,
    axis: str = SAMPLE_AXIS,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A 1-D mesh over the first `n_devices` of `devices` (default: every
    visible CUDA device; raises where there is none)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu'] to "
                "build a CPU mesh"
            )
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = list(devices)
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, have {len(devs)}"
            )
        devs = devs[:n_devices]
    return Mesh(tuple(devs), axis)
