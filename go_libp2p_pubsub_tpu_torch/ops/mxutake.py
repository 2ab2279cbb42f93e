"""The flat take behind ``edge_gather_mode="mxu"`` (port of ops/mxutake.py).

:func:`take_words` computes ``out[w, r] = x_w[w, idx[r]]``, the contract of
the reference's ``take_words_twolevel``: the plain PyTorch version for CPU
tensors, the CUDA kernel csrc/take_words.cu for CUDA tensors; anything else
raises.

On the TPU that contract is a one-hot bf16 matrix product: the table split
into u8 chunk planes, a [block_g, NB] one-hot block select on the MXU and a
128-lane select, because Mosaic lowers no table lookup wider than one
vector register. ``_prep_table``, ``_select_block``, ``pad_lanes``, the
bf16 one-hot and the R padding are that workaround and are not ported;
Hopper gathers directly.

:func:`take_payload` is the port of ``take_payload_onehot``
(``out[i, s] = payload[jn[i, s], rk[i, s]]``, mxutake.py:184-220) by its
contract: ONE :func:`take_words` over the payload seen as a ``[1, N*K]``
word table at ``idx = jn*K + rk``. The reference instead routes the K slot
columns as K word planes in ``payload_w_tile`` tiles and picks the slot
with a K-wide one-hot select, because the whole [N*K] table would not fit
its one-hot tile in VMEM; carried over, that would move K times the bytes.
"""

from __future__ import annotations

import torch

from . import cudalib
from .bits import I32


def _check(x_w, idx):
    if x_w.dtype != I32 or x_w.dim() != 2:
        raise TypeError(f"take_words: x_w must be a [W, N] int32 tensor, got "
                        f"{x_w.dtype} {tuple(x_w.shape)}")
    if idx.dtype != I32 or idx.dim() != 1:
        raise TypeError(f"take_words: idx must be an [R] int32 tensor, got "
                        f"{idx.dtype} {tuple(idx.shape)}")


def take_words_plain(x_w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`take_words` (the reference's
    ``take_words_twolevel_ref``, mxutake.py:282)."""
    _check(x_w, idx)
    return x_w[:, idx.long()]


def take_words(x_w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[w, r] = x_w[w, idx[r]]``: ``x_w`` [W, N] int32 words, ``idx``
    [R] int32 pre-clipped to [0, N) (any R, 0 included) -> [W, R] int32."""
    if not cudalib.use_kernel("take_words", x_w, idx):
        return take_words_plain(x_w, idx)
    _check(x_w, idx)
    w, n = x_w.shape
    (r,) = idx.shape
    cudalib.check_args("take_words", [("x_w", x_w, I32, (w, n)),
                                      ("idx", idx, I32, (r,))])
    out = torch.empty((w, r), dtype=I32, device=x_w.device)
    cudalib.launch("take_words", x_w, idx, out, n, r, w)
    return out


def take_payload(payload: torch.Tensor, jn: torch.Tensor,
                 rk: torch.Tensor) -> torch.Tensor:
    """``out[i, s] = payload[jn[i, s], rk[i, s]]`` for a [N, K] payload of
    any 4-byte dtype (bits moved as int32, so float32 is exact); ``jn``/
    ``rk`` int32 pre-clipped to valid range."""
    if payload.dim() != 2 or payload.element_size() != 4 \
            or payload.dtype.is_complex:
        raise TypeError(f"take_payload: payload must be a 2-D tensor of a "
                        f"4-byte dtype, got {payload.dtype} "
                        f"{tuple(payload.shape)}")
    n, k = payload.shape
    words = payload.contiguous().view(I32).reshape(1, n * k)
    idx = (jn * k + rk).reshape(-1)
    return take_words(words, idx).reshape(jn.shape).view(payload.dtype)
