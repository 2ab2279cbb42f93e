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

On CUDA tensors a ``"ranks"`` selection, and every :func:`masked_median`,
runs as one launch of ``csrc/select_rows.cu`` (a warp per row, the
threefry draw and the ranks in registers); the ``*_plain`` functions are
the same selections in torch, which the CPU takes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import rng
from ..parallel import kernel_context as kc
from . import cudalib

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
    """The selection formulation (selection.py:58-79): ``"auto"`` takes
    ops/dispatch.py's first candidate that can run; ``"iter"`` without a
    bound below K falls back to ``"ranks"``, the reference's fallback on
    every backend but its CPU (where it takes ``"sort"``, which selects the
    same slots)."""
    from .dispatch import OPS, choose
    if mode != "auto" and mode not in OPS["selection"]:
        raise ValueError(f"unknown selection mode {mode!r}")
    if mode == "auto":
        for cand in choose("selection", k=k, max_count=max_count):
            if cand == "iter" and (max_count is None or max_count >= k):
                continue
            return cand
        mode = "sort"
    if mode == "iter" and (max_count is None or max_count >= k):
        return "ranks"
    return mode


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


def select_random_plain(mask: torch.Tensor, count, key: torch.Tensor, *,
                        max_count: int | None = None, mode: str = "auto",
                        noise: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`select_random`."""
    if noise is None:
        # a peer group draws its own rows of the [N, ...] draw
        noise = rng.uniform(key, tuple(mask.shape), row0=kc.row0())
    keys = torch.where(mask, noise, torch.full_like(noise, NEG_INF))
    return _select_by_keys(keys, mask, count, max_count=max_count, mode=mode)


def select_top_plain(score: torch.Tensor, mask: torch.Tensor, count, *,
                     max_count: int | None = None,
                     mode: str = "auto") -> torch.Tensor:
    """Plain PyTorch version of :func:`select_top`."""
    k = mask.shape[-1]
    tiebreak = -torch.arange(k, dtype=torch.float32, device=mask.device) * 1e-9
    sk = score + tiebreak
    keys = torch.where(mask, sk, torch.full_like(sk, NEG_INF))
    return _select_by_keys(keys, mask, count, max_count=max_count, mode=mode)


def masked_median_plain(values: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`masked_median`."""
    padded = torch.where(mask, values, torch.full_like(values, 1e30))
    srt = torch.sort(padded, dim=-1).values
    n = mask.sum(-1)
    idx = torch.clamp(n // 2, 0, values.shape[-1] - 1)
    return torch.gather(srt, -1, idx[..., None])[..., 0]


# --- the kernel route (csrc/select_rows.cu) ---------------------------------

KERNEL_MODES = {"random": 0, "noise": 1, "top": 2, "median": 3}
MAX_KERNEL_K = 1024                  # 32 lanes x 32 slots a lane


def _on_kernel(mode: str, max_count, mask: torch.Tensor, count,
               other: torch.Tensor) -> bool:
    """A ``"ranks"`` selection of CUDA tensors takes the kernel; the other
    formulations, and every CPU selection, take the plain code."""
    if resolve_selection_mode(mode, mask.shape[-1], max_count) != "ranks":
        return False
    counts = [count] if isinstance(count, torch.Tensor) else []
    return cudalib.use_kernel("select_rows", mask, other, *counts)


def _rows_plane(values: torch.Tensor, shape: tuple):
    """``values`` broadcast to ``shape`` as ``(plane, rep)``: a contiguous
    float32 [R / rep, K] table whose row ``r // rep`` is row ``r`` of the
    broadcast. A plane expanded over the topic axis (stride 0 there, as the
    heartbeat's ``sb``) is read as its [.., K] rows, not copied T times."""
    values = values.expand(shape)
    if len(shape) >= 2 and shape[-2] > 1 and values.stride(-2) == 0:
        return values.select(-2, 0).contiguous(), shape[-2]
    return values.contiguous(), 1


def _i32(x: int) -> int:
    """A uint32 value as the C int that carries its bits."""
    return x - (1 << 32) if x >= 1 << 31 else x


def select_rows(kind: str, mask: torch.Tensor, count=None, *,
                key: torch.Tensor | None = None,
                values: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of the ``select_rows`` kernel over ``mask``'s rows (all
    leading axes flattened; CUDA tensors only). ``kind``: ``"random"``
    (the uniform draw of ``key``, at this rank's rows of a peer group),
    ``"noise"`` (``values`` as the noise), ``"top"`` (``values`` as the
    score) select the top ``count`` (a Python int or a tensor broadcast
    against ``mask.shape[:-1]``) by key as the ``"ranks"`` formulation
    does; ``"median"`` returns :func:`masked_median` of ``values``."""
    shape = tuple(mask.shape)
    k = shape[-1]
    rows = math.prod(shape[:-1])
    if not 1 <= k <= MAX_KERNEL_K or rows >= 1 << 31:
        raise ValueError(f"select_rows: K={k} outside 1..{MAX_KERNEL_K} or "
                         f"{rows} rows over the kernel's int range")
    dev = mask.device
    m8 = mask.contiguous().view(torch.uint8)
    specs = [("mask", m8, torch.uint8, shape)]
    cnt = key_c = plane = None
    rep, base = 1, 0
    if kind != "median":
        if isinstance(count, torch.Tensor):
            cnt = count.to(torch.int64).expand(shape[:-1]).contiguous()
        else:
            # a static count is filled on the device: no host-to-device copy
            cnt = torch.full(shape[:-1], int(count), dtype=torch.int64,
                             device=dev)
        specs.append(("count", cnt, torch.int64, shape[:-1]))
    if kind == "random":
        key_c = key.contiguous()
        specs.append(("key", key_c, torch.int64, (2,)))
        # a peer group draws its own rows of the [N, ...] draw (rng._counts)
        r0 = kc.row0()
        base = r0 * math.prod(shape[1:]) if r0 else 0
    else:
        plane, rep = _rows_plane(values, shape)
        specs.append(("values", plane, torch.float32, tuple(plane.shape)))
    cudalib.check_args("select_rows", specs)
    if kind == "median":
        out = torch.empty(shape[:-1], dtype=torch.float32, device=dev)
    else:
        out = torch.empty(shape, dtype=torch.bool, device=dev)
    cudalib.launch("select_rows", m8, 0 if cnt is None else cnt,
                   0 if key_c is None else key_c,
                   0 if plane is None else plane, out, rows, k, rep,
                   _i32((base >> 32) & 0xFFFFFFFF), _i32(base & 0xFFFFFFFF),
                   KERNEL_MODES[kind])
    return out


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
    if _on_kernel(mode, max_count, mask, count,
                  key if noise is None else noise):
        if noise is None:
            return select_rows("random", mask, count, key=key)
        return select_rows("noise", mask, count, values=noise)
    return select_random_plain(mask, count, key, max_count=max_count,
                               mode=mode, noise=noise)


def select_top(score: torch.Tensor, mask: torch.Tensor, count, *,
               max_count: int | None = None,
               mode: str = "auto") -> torch.Tensor:
    """Choose up to ``count`` highest-score True positions per row; ties
    break toward the lower slot (selection.py:168-182). Same precondition
    as :func:`select_random`."""
    if _on_kernel(mode, max_count, mask, count, score):
        return select_rows("top", mask, count, values=score)
    return select_top_plain(score, mask, count, max_count=max_count,
                            mode=mode)


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of masked values along the last axis (gossipsub.go:1527-1542):
    the element at index n//2 of the ascending sorted masked values; rows
    with an empty mask return 1e30 (no graft)."""
    if cudalib.use_kernel("select_rows", values, mask):
        return select_rows("median", mask, values=values)
    return masked_median_plain(values, mask)
