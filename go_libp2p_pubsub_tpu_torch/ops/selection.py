"""Masked selection primitives for the batched router (port of
ops/selection.py).

The reference's three formulations (ranks, sort, iter) give identical
results; the port keeps one, the comparison-count rank, which states the
shared tie-break directly: among equal keys the LOWER slot ranks first
(selection.py:102-137).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import rng

NEG_INF = float(np.float32(-1e30))


def ranks_desc(keys: torch.Tensor) -> torch.Tensor:
    """Rank (0 = largest) of each element along the last axis; ties break
    toward the lower index."""
    k = keys.shape[-1]
    ki = keys[..., :, None]
    kj = keys[..., None, :]
    idx = torch.arange(k, device=keys.device)
    lower = idx[None, :] < idx[:, None]                 # j < i
    beats = (kj > ki) | ((kj == ki) & lower)
    return beats.sum(-1)


def _select_by_keys(keys, mask, count):
    """Top-``count`` by key per row, masked."""
    return (ranks_desc(keys) < count[..., None]) & mask


def select_random(mask: torch.Tensor, count, key: torch.Tensor) -> torch.Tensor:
    """Uniformly choose up to ``count`` True positions per row of ``mask``,
    by the reference's jax uniform noise (the rank formulation needs no
    static bound on ``count``)."""
    noise = rng.uniform(key, tuple(mask.shape))
    keys = torch.where(mask, noise, torch.full_like(noise, NEG_INF))
    return _select_by_keys(keys, mask, torch.as_tensor(count,
                                                       device=mask.device))


def select_top(score: torch.Tensor, mask: torch.Tensor, count) -> torch.Tensor:
    """Choose up to ``count`` highest-score True positions per row; ties
    break toward the lower slot."""
    k = mask.shape[-1]
    tiebreak = -torch.arange(k, dtype=torch.float32, device=mask.device) * 1e-9
    sk = score + tiebreak
    keys = torch.where(mask, sk, torch.full_like(sk, NEG_INF))
    return _select_by_keys(keys, mask, torch.as_tensor(count,
                                                       device=mask.device))


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of masked values along the last axis (gossipsub.go:1527-1542):
    the element at index n//2 of the ascending sorted masked values; rows
    with an empty mask return 1e30 (no graft)."""
    padded = torch.where(mask, values, torch.full_like(values, 1e30))
    srt = torch.sort(padded, dim=-1).values
    n = mask.sum(-1)
    idx = torch.clamp(n // 2, 0, values.shape[-1] - 1)
    return torch.gather(srt, -1, idx[..., None])[..., 0]
