from .hist import Hist, PRIState, hist_update, pow2_floor
from .cri import cri_distribute, nbd_spread
from .aet import aet_mrc
from . import report

__all__ = [
    "Hist",
    "PRIState",
    "hist_update",
    "pow2_floor",
    "cri_distribute",
    "nbd_spread",
    "aet_mrc",
    "report",
]
