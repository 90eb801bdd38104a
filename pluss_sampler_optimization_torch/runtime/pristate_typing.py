"""Structural typing for PRI-state consumers (avoids import cycles)."""

from __future__ import annotations

from typing import Protocol

from .hist import Hist


class PRIStateLike(Protocol):
    def merged_noshare(self) -> Hist: ...

    def merged_share(self): ...
