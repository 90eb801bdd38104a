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
So far it runs the sampled engine (sampler/sampled.py) through the
hand-written CUDA kernel csrc/sampled_hist.cu on an NVIDIA Hopper card,
with a plain torch version on the CPU. Entry points run on CUDA unless
the caller asks for the CPU (device="cpu", --device cpu), and raise
where CUDA is absent.
"""

from .config import MachineConfig, SamplerConfig
from .sampler.sampled import run_sampled

__all__ = ["MachineConfig", "SamplerConfig", "run_sampled"]
