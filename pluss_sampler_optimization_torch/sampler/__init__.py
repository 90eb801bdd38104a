"""The sampled engine on PyTorch (sampler/sampled.py) and its device draw
(sampler/draw.py, on the threefry streams of sampler/threefry.py); the
exact engines (dense.py, stream.py, periodic.py with the run_exact
router, analytic.py)."""

from .draw import draw_sample_keys_device
from .sampled import run_sampled, run_sampled_progressive, sampled_outputs

__all__ = ["draw_sample_keys_device", "run_sampled",
           "run_sampled_progressive", "sampled_outputs"]
