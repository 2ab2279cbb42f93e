"""Masked selection primitives for the batched router (port of
ops/selection.py).

The reference's peer-selection idioms (random shuffles + "pick first D",
score-ordered keeps) become masked top-``count`` selections over the K
slot axis, in one of the reference's three formulations, all with the same
tie-break (among equal keys the LOWER slot wins, selection.py:102-137):

- ``"ranks"``: the comparison-count rank of each key, O(K^2);
- ``"sort"``: a sort of each row by (key, slot) and a per-row threshold;
- ``"iter"``: ``max_count`` passes of a first-occurrence argmax. It needs
  the static bound ``max_count`` on ``count`` and truncates a larger
  count, as the reference does; :data:`CHECK_COUNT_BOUND` makes that a
  loud failure.

``"auto"`` resolves through ops/dispatch.py (:func:`resolve_selection_mode`).
"""

from __future__ import annotations

import numpy as np
import torch

from . import rng
from . import kc

NEG_INF = float(np.float32(-1e30))

# Guard for the count <= max_count precondition of the iterative
# formulation: set it to make a silent truncation raise AssertionError.
# Under the flag every iterative selection reads its counts on the host;
# off (the default) it reads nothing. A debugging switch: the captured
# executables of parallel/compile_plan.py refuse to build under it.
CHECK_COUNT_BOUND = False


def _check_count_bound(count: torch.Tensor, max_count: int) -> None:
    if CHECK_COUNT_BOUND and bool((count > max_count).any()):
        raise AssertionError(
            f"selection count exceeds the static max_count={max_count} "
            "bound; the iterative formulation would silently truncate")


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


def resolve_selection_mode(mode: str, k: int,
                           max_count: int | None = None) -> str:
    """Every selection runs as ranks here, whatever the configuration
    asks for: the formulations select the same slots."""
    return "ranks"


def _select_iter(keys: torch.Tensor, mask: torch.Tensor, count: torch.Tensor,
                 max_count: int) -> torch.Tensor:
    """O(max_count * K): sequential first-occurrence maxima
    (selection.py:82-99)."""
    k = keys.shape[-1]
    slots = torch.arange(k, device=keys.device)
    sel = torch.zeros_like(mask)
    rem = keys
    neg = torch.full_like(keys, NEG_INF)
    for i in range(max_count):
        idx = torch.argmax(rem, dim=-1)
        take = (i < count) & torch.gather(mask, -1, idx[..., None])[..., 0]
        onehot = (slots == idx[..., None]) & take[..., None]
        sel = sel | onehot
        rem = torch.where(onehot, neg, rem)
    return sel


def _select_sort(keys: torch.Tensor, mask: torch.Tensor,
                 count: torch.Tensor) -> torch.Tensor:
    """Sort each row by (key descending, slot ascending), select by the
    count-th pair as a threshold (selection.py:118-133): the keys' float
    bits map to an order-preserving unsigned word ``p`` (ascending = best
    first), and a stable sort of ``p`` keeps equal keys in slot order."""
    k = keys.shape[-1]
    u = keys.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(keys < 0, u ^ 0xFFFFFFFF, u | 0x80000000)
    p = u ^ 0xFFFFFFFF                                   # ascending = best
    slot = torch.arange(k, device=keys.device).expand(keys.shape)
    sp, ss = torch.sort(p, dim=-1, stable=True)
    idx = torch.clamp(count[..., None] - 1, 0, k - 1).long()
    p_thr = torch.gather(sp, -1, idx)
    s_thr = torch.gather(ss, -1, idx)
    sel = (p < p_thr) | ((p == p_thr) & (slot <= s_thr))
    return mask & sel & (count[..., None] > 0)


def _select_by_keys(keys: torch.Tensor, mask: torch.Tensor,
                    count: torch.Tensor, *, max_count: int | None = None,
                    mode: str = "auto") -> torch.Tensor:
    """Top-``count`` by key per row, masked, in the formulation ``mode``
    resolves to (identical results)."""
    k = keys.shape[-1]
    if isinstance(count, torch.Tensor):
        count = count.expand(mask.shape[:-1])
    else:
        # a static count is filled on the device: no host-to-device copy
        count = torch.full(mask.shape[:-1], int(count), dtype=torch.int64,
                           device=mask.device)
    mode = resolve_selection_mode(mode, k, max_count)
    if mode == "iter":
        _check_count_bound(count, max_count)
        return _select_iter(keys, mask, count, max_count)
    if mode == "sort":
        return _select_sort(keys, mask, count)
    return (ranks_desc(keys) < count[..., None]) & mask


def select_random(mask: torch.Tensor, count, key: torch.Tensor, *,
                  max_count: int | None = None, mode: str = "auto",
                  noise: torch.Tensor | None = None) -> torch.Tensor:
    """Uniformly choose up to ``count`` True positions per row of ``mask``
    by the reference's jax uniform noise (selection.py:140-165); ``count``
    broadcasts against ``mask.shape[:-1]``. ``noise`` substitutes uniform
    [0, 1) noise of ``mask.shape`` for the draw (``key`` is then unused).

    PRECONDITION: ``count <= max_count`` elementwise when a bound is given:
    ``"iter"`` runs exactly ``max_count`` passes and truncates a larger
    count (set :data:`CHECK_COUNT_BOUND` to make that raise)."""
    if noise is None:
        # a peer group draws its own rows of the [N, ...] draw
        noise = rng.uniform(key, tuple(mask.shape), row0=kc.row0())
    keys = torch.where(mask, noise, torch.full_like(noise, NEG_INF))
    return _select_by_keys(keys, mask, count, max_count=max_count, mode=mode)


def select_top(score: torch.Tensor, mask: torch.Tensor, count, *,
               max_count: int | None = None,
               mode: str = "auto") -> torch.Tensor:
    """Choose up to ``count`` highest-score True positions per row; ties
    break toward the lower slot (selection.py:168-182). Same precondition
    as :func:`select_random`."""
    k = mask.shape[-1]
    tiebreak = -torch.arange(k, dtype=torch.float32, device=mask.device) * 1e-9
    sk = score + tiebreak
    keys = torch.where(mask, sk, torch.full_like(sk, NEG_INF))
    return _select_by_keys(keys, mask, count, max_count=max_count, mode=mode)


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of masked values along the last axis (gossipsub.go:1527-1542):
    the element at index n//2 of the ascending sorted masked values; rows
    with an empty mask return 1e30 (no graft)."""
    padded = torch.where(mask, values, torch.full_like(values, 1e30))
    srt = torch.sort(padded, dim=-1).values
    n = mask.sum(-1)
    idx = torch.clamp(n // 2, 0, values.shape[-1] - 1)
    return torch.gather(srt, -1, idx[..., None])[..., 0]
