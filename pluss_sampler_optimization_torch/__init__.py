"""PLUSS on PyTorch and CUDA: the port of pluss_sampler_optimization_tpu.

Parallel Locality analysis Using Static Sampling (reference
implementation: sauceeeeage/PLUSS_Sampler_Optimization) simulates the
interleaved execution of THREAD_NUM OpenMP threads over a parallel loop
nest, measures reuse intervals per simulated thread, spreads them with
the concurrent-reuse-interval model and integrates the result into an
LRU miss-ratio curve.

This package is the PyTorch port of the JAX package beside it, which
stays the reference: every ported piece gives that package's exact
answer on the same inputs. It imports neither JAX nor the JAX package.
So far it runs the sampled engine (sampler/sampled.py, with its
progressive-precision rounds) through the hand-written CUDA kernel
csrc/sampled_hist.cu on an NVIDIA Hopper card, and the mesh-sharded
sampled engine (parallel/sharded.py, its fused and per-ref forms)
through the same kernel's raw-noshare form and csrc/pow2_hist.cu; both
draw their samples on the card by default (sampler/draw.py,
jax.random's threefry streams on the kernel csrc/threefry_draw.cu),
with plain torch versions of every kernel on the CPU. The exact engines
(sampler/dense.py, stream.py, periodic.py, analytic.py and the router
sampler/periodic.py::run_exact) give exact MRCs with no sampling, the
analytic one classifying through the same kernel's raw form, and the
serial and numpy oracles (oracle/) are the JAX package's own code.
Entry points run on CUDA unless the caller asks for the CPU
(device="cpu", --device cpu), and raise where CUDA is absent.
"""

from .config import MachineConfig, SamplerConfig
from .sampler.sampled import run_sampled

__all__ = ["MachineConfig", "SamplerConfig", "run_sampled"]
