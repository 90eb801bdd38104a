"""The sampled engine on PyTorch (sampler/sampled.py)."""

from .sampled import run_sampled, sampled_outputs

__all__ = ["run_sampled", "sampled_outputs"]
