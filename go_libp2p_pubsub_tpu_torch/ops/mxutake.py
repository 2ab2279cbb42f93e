"""The flat take behind ``edge_gather_mode="mxu"`` (port of ops/mxutake.py).

:func:`take_words` computes ``out[w, r] = x_w[w, idx[r]]``, the contract of
the reference's ``take_words_twolevel``, and :func:`take_rows` the same
take over an n-major table, ``out[r, w] = tab[idx[r], w]``: the plain
PyTorch versions for CPU tensors, the CUDA kernel csrc/take_words.cu for
CUDA tensors; anything else raises. On the card the kernel reads the
table n-major, a lookup's W words in one row (one 32-byte L2 sector while
W <= 8), so :func:`take_words` first interleaves its word-major table
into rows (``x_w.T.contiguous()``, 0.4 MB at [2, 51200]).

On the TPU that contract is a one-hot bf16 matrix product: the table split
into u8 chunk planes, a [block_g, NB] one-hot block select on the MXU and a
128-lane select, because Mosaic lowers no table lookup wider than one
vector register. ``_prep_table``, ``_select_block``, ``pad_lanes``, the
bf16 one-hot and the R padding are that workaround and are not ported;
Hopper gathers directly.

:func:`take_payload` is the port of ``take_payload_onehot``
(``out[i, s] = payload[jn[i, s], rk[i, s]]``, mxutake.py:184-220) by its
contract: ONE :func:`take_rows` over the payload seen as a ``[N*K, 1]``
word table at ``idx = jn*K + rk``. The reference instead routes the K slot
columns as K word planes in ``payload_w_tile`` tiles and picks the slot
with a K-wide one-hot select, because the whole [N*K] table would not fit
its one-hot tile in VMEM; carried over, that would move K times the bytes.
"""

from __future__ import annotations

import torch

from . import cudalib
from .bits import I32


def _check(what, tab, idx):
    if tab.dtype != I32 or tab.dim() != 2:
        raise TypeError(f"{what}: the table must be a 2-D int32 tensor, got "
                        f"{tab.dtype} {tuple(tab.shape)}")
    if idx.dtype != I32 or idx.dim() != 1:
        raise TypeError(f"{what}: idx must be an [R] int32 tensor, got "
                        f"{idx.dtype} {tuple(idx.shape)}")


def _take(tab, idx, out_shape, os_r, os_w):
    """Launch the take kernel on an n-major [N, W] table: ``out[r*os_r +
    w*os_w] = tab[idx[r], w]`` (element strides) into a new ``out_shape``
    int32 tensor."""
    out = torch.empty(out_shape, dtype=I32, device=tab.device)
    cudalib.launch("take_words", tab, idx, out, idx.shape[0], tab.shape[1],
                   os_r, os_w)
    return out


def take_words_plain(x_w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`take_words` (the reference's
    ``take_words_twolevel_ref``, mxutake.py:282)."""
    _check("take_words", x_w, idx)
    return x_w[:, idx.long()]


def take_words(x_w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[w, r] = x_w[w, idx[r]]``: ``x_w`` [W, N] int32 words, ``idx``
    [R] int32 pre-clipped to [0, N) (any R, 0 included) -> [W, R] int32."""
    if not cudalib.use_kernel("take_words", x_w, idx):
        return take_words_plain(x_w, idx)
    _check("take_words", x_w, idx)
    w, n = x_w.shape
    (r,) = idx.shape
    cudalib.check_args("take_words", [("x_w", x_w, I32, (w, n)),
                                      ("idx", idx, I32, (r,))])
    rows = x_w.T.contiguous()                             # [N, W]
    return _take(rows, idx, (w, r), 1, r)


def take_rows_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`take_rows`."""
    _check("take_rows", tab, idx)
    return tab[idx.long()]


def take_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[r, w] = tab[idx[r], w]``: ``tab`` [N, W] int32 rows, ``idx``
    [R] int32 pre-clipped to [0, N) (any R, 0 included) -> [R, W] int32.
    The kernel of :func:`take_words` on an n-major table, with n-major
    output."""
    if not cudalib.use_kernel("take_words", tab, idx):
        return take_rows_plain(tab, idx)
    _check("take_rows", tab, idx)
    n, w = tab.shape
    (r,) = idx.shape
    cudalib.check_args("take_rows", [("tab", tab, I32, (n, w)),
                                     ("idx", idx, I32, (r,))])
    return _take(tab, idx, (r, w), w, 1)


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
    words = payload.contiguous().view(I32).reshape(n * k, 1)
    idx = (jn * k + rk).reshape(-1)
    return take_rows(words, idx).reshape(jn.shape).view(payload.dtype)


# --- the host-side cost models (mxutake.py:72 and :223-280) ------------------
# ops/dispatch.py prices the reference's two-level one-hot take (the ``mxu``
# formulation) with these, operation for operation, so that the port's
# ranking equals the reference's to the last bit. They describe the TPU
# kernel's bytes and FLOPs, not csrc/take_words.cu's.

LANES = 128
DEFAULT_BLOCK_G = 1024
_PAYLOAD_PLANES_BYTES = 4 * 1024 * 1024


def payload_w_tile(n: int, k: int) -> int:
    """Word-tile size of the reference's blocked payload take: how many of
    the K word planes one two-level take may carry."""
    n_pad = -(-n // LANES) * LANES
    return max(1, min(k, _PAYLOAD_PLANES_BYTES // (8 * n_pad)))


def cost_model(n: int, r: int, w: int, block_g: int = DEFAULT_BLOCK_G) -> dict:
    """Bytes-touched and FLOP inventory of one two-level take of ``r``
    indices over a [w, n] word table (mxutake.py:223-260)."""
    nb = -(-n // LANES)
    bg = min(max(r, 1), block_g)
    n_blocks = -(-r // bg)
    table_bytes = w * 4 * nb * LANES * 2
    onehot_tile = bg * nb * 2
    onehot_bytes = n_blocks * onehot_tile * 4 * w
    lane_bytes = 2 * r * LANES * 4 * 4 * w
    out_bytes = w * r * 4
    flops = r * (2 * nb + 2 * LANES) * 4 * w
    return {
        "table_bytes": table_bytes,
        "vmem_bytes": table_bytes + onehot_tile + bg * LANES * 4,
        "onehot_bytes": onehot_bytes,
        "lane_bytes": lane_bytes,
        "out_bytes": out_bytes,
        "flops": flops,
    }


def cost_model_payload(n: int, k: int,
                       block_g: int = DEFAULT_BLOCK_G) -> dict:
    """Bytes/FLOP inventory of one blocked payload take over an [n, k]
    payload (mxutake.py:263-280): a K-word take over all N*K edges plus the
    K-wide slot select (``select_bytes``)."""
    m = cost_model(n, n * k, k, block_g)
    m["select_bytes"] = k * (n * k) * 4 + n * k * 4
    wt = payload_w_tile(n, k)
    nb = -(-n // LANES)
    m["vmem_bytes"] = (wt * 4 * nb * LANES * 2
                       + min(n * k, block_g) * nb * 2
                       + min(n * k, block_g) * LANES * 4)
    return m
