"""The reverse-edge gathers, in their plain indexed form only.

Every seam resolves to ``"scalar"``: one indexed gather per payload, the
plainest of the program's formulations, whatever the configuration asks
for. The program's other formulations (its kernels, the sort, the take)
compute the same values; this copy keeps none of them."""

from __future__ import annotations

import torch

from .bits import I32


def resolve_mode(mode: str, payload_dtype, n: int, k: int,
                 have_sort_key: bool = False) -> str:
    return "scalar"


def resolve_words_mode(mode: str, w: int, n: int, k: int,
                       itemsize: int = 4,
                       have_sort_key: bool = False) -> str:
    return "scalar"


def resolve_edge_packed_mode(mode: str, n: int, k: int,
                             b_planes: int) -> str:
    return "scalar"


def gather_words(x_w: torch.Tensor, nbr: torch.Tensor,
                 mode: str = "scalar", m: int | None = None,
                 sort_key: torch.Tensor | None = None) -> torch.Tensor:
    """``out[w, k, n] = x_w[w, nbr[n, k]]``: ``x_w`` [W, N] int32 packed
    words, ``nbr`` [N, K] int32 clipped to [0, N)."""
    if x_w.dtype != I32 or nbr.dtype != I32:
        raise TypeError("gather_words: int32 tables and indices only")
    return x_w[:, nbr.T.long()]


def permutation_gather(payload: torch.Tensor, jn: torch.Tensor,
                       rk: torch.Tensor, mode: str = "scalar",
                       sort_key: torch.Tensor | None = None) -> torch.Tensor:
    """``out[n, k] = payload[jn[n, k], rk[n, k]]``; ``jn``/``rk`` [N, K]
    clipped to valid range (callers mask invalid slots on the result)."""
    return payload[jn.long(), rk.long()]
