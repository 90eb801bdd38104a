"""Exact sparse (key, count) reduction on tensors.

Port of the JAX package's ops/histogram.py::sorted_k_unique. It runs
outside the fused classify kernel there too (ops/pallas_sampled.py
reduces the kernel's residual stream with it), so plain torch — one
sort plus a segmented sum — is the whole implementation here.
"""

from __future__ import annotations

import torch

SENTINEL = 1 << 62


def sorted_k_unique(values, valid, k: int, weights=None):
    """Exact sparse histogram with capacity k over masked int64 values,
    via one full sort + segmented reduction.

    `weights=None` counts occurrences; an int64 tensor sums weights per
    key instead (the merge form: folding (key, count) pair sets into
    one). Returns (keys[k], counts[k], n_unique). Invalid entries are
    pushed to the end via the 2^62 sentinel; entries beyond capacity
    are dropped (detect via n_unique > k on host), while n_unique
    stays the true distinct count.
    """
    dev = values.device
    v = torch.where(valid, values, SENTINEL)
    if weights is None:
        v = torch.sort(v).values
        w = None
    else:
        order = torch.argsort(v, stable=True)
        v = v[order]
        w = weights[order]
    is_valid = v != SENTINEL
    first = torch.ones_like(is_valid)
    first[1:] = v[1:] != v[:-1]
    first &= is_valid
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    n_unique = (
        seg[-1] + 1 if v.shape[0]
        else torch.zeros((), dtype=torch.int64, device=dev)
    )
    # overflow and invalid entries land in slot k, which is cut off
    # (JAX's scatter drops out-of-range indices; clamping to k is the
    # same for a slot that is discarded)
    seg_c = torch.where(is_valid, seg, k).clamp(max=k)
    keys = torch.full((k + 1,), -1, dtype=torch.int64, device=dev)
    keys.scatter_(0, torch.where(first, seg_c, k), v)
    add = is_valid.to(torch.int64) if w is None else torch.where(
        is_valid, w, 0
    )
    counts = torch.zeros(k + 1, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, seg_c, add)
    return keys[:k], counts[:k], n_unique
