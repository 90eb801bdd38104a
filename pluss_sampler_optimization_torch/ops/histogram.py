"""Histogram primitives on tensors: pow2 bins and exact sparse pairs.

Port of the JAX package's ops/histogram.py:

- `exp_bin`/`exp_hist`: the dense 64-bin pow2 histogram, binned by exact
  integer comparison (a float log2 is inexact above 2^53);
- `sorted_k_unique`: the exact (key, count) reduction; it runs outside
  the fused classify kernel there too (ops/pallas_sampled.py reduces
  the kernel's residual stream with it), so plain torch — one sort plus
  a segmented sum — is the whole implementation here;
- `fixed_k_unique`: the same three outputs under the name the sharded
  engine uses (see its docstring), counting occurrences or summing
  weights;
- `merge_pair_sets`: two (key, count) pair sets folded into one, the
  sharded scan and fused forms' merge between steps.
"""

from __future__ import annotations

import torch

SENTINEL = 1 << 62
N_EXP_BINS = 64
_POW2 = [1 << e for e in range(63)]


def exp_bin(x):
    """63 - clz(x) of int64 x, as the JAX package's exp_bin: floor(log2 x)
    for x > 0, -1 for x == 0 and 63 for x < 0 (its bit pattern read as
    unsigned is at least 2^63). Exact: a search over the 63 int64 powers
    of two, no float log2."""
    pow2 = torch.tensor(_POW2, dtype=torch.int64, device=x.device)
    e = torch.searchsorted(pow2, x, right=True) - 1
    return torch.where(x < 0, 63, e)


def exp_hist(values, weights):
    """Add weights into the 64 pow2 exponent bins. values must be > 0
    where weights are nonzero (masked entries: pass weight 0, value 1)."""
    e = exp_bin(torch.clamp(values.to(torch.int64), min=1))
    return torch.zeros(N_EXP_BINS, dtype=torch.int64, device=values.device
                       ).index_add_(0, e, weights.to(torch.int64))


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


def fixed_k_unique(values, valid, k: int, weights=None):
    """Exact sparse histogram with capacity k over masked int64 values:
    (keys[k] ascending, counts[k], n_unique), empty slots -1/0, entries
    beyond capacity dropped while n_unique stays the true distinct
    count. `weights=None` counts occurrences; an int64 tensor sums
    weights per key instead (weights >= 0, a valid entry's > 0: the
    merge form). The JAX package reaches these outputs by scatter-max
    hash rounds, a TPU device for avoiding a sort, with the sorted
    reduction as its fallback; they are the sorted reduction's outputs,
    so the port sorts. Empty slots are identified by count 0."""
    return sorted_k_unique(values, valid, k, weights)


def merge_pair_sets(ck, cc, k2, c2, capacity: int):
    """Fold two fixed-capacity (key, count) pair sets into one: the
    weighted unique over the concatenated pairs, with the JAX package's
    rule that empty slots are those with count 0 (validity is
    `counts > 0`). Returns (keys[capacity], counts[capacity], n_unique);
    n_unique above capacity means the merged set was cut."""
    counts = torch.cat([cc, c2])
    return fixed_k_unique(torch.cat([ck, k2]), counts > 0, capacity,
                          weights=counts)
