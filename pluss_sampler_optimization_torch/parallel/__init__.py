"""Multi-device execution of the port.

The sampled engine shards the sample axis of each bucket's (or ref's)
drawn buffer over a mesh of torch devices (`mesh.py`); the JAX
package's psum and all_gather become a sum and a stack on the mesh's
first device in one process, and torch.distributed all_reduce/
all_gather across processes (`distributed.py`: NCCL on CUDA, gloo on
the CPU). The sharded results are bit-identical to the single-device
engine's in both forms, fused and per-ref (`sharded.py`). The exact
engines' sharded forms split their independent work over the shards:
periodic windows, analytic classify chunks, dense threads.
"""

from .distributed import build_global_mesh, initialize_distributed
from .mesh import SAMPLE_AXIS, Mesh, build_mesh, local_device_count
from .sharded import (
    run_analytic_sharded,
    run_dense_sharded,
    run_exact_sharded,
    run_periodic_sharded,
    run_sampled_sharded,
    sampled_outputs_sharded,
)

__all__ = [
    "SAMPLE_AXIS",
    "Mesh",
    "build_mesh",
    "build_global_mesh",
    "initialize_distributed",
    "local_device_count",
    "run_analytic_sharded",
    "run_dense_sharded",
    "run_exact_sharded",
    "run_periodic_sharded",
    "run_sampled_sharded",
    "sampled_outputs_sharded",
]
