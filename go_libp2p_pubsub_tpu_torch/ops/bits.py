"""Bit-packed message-window primitives (PyTorch port of ops/bits.py).

The M-slot message window packs into ceil(M/32) 32-bit words per peer. The
JAX package stores those words as ``uint32``; PyTorch's ``uint32`` has no
``~``, ``<<``, ``>>`` or ``+``, so the port stores every packed plane as
**int32 holding the same bits** (the CUDA kernels take them as
``uint32_t*``). Bit extraction ``(x >> i) & 1`` is exact under int32's
arithmetic shift; a shift that must be logical goes through :func:`lsr`.
Torch has no popcount, so :func:`popcount` is SWAR arithmetic on int32.

Layouts are the reference's: ``pack_bool`` packs the last axis
little-endian ([..., M] -> [..., W]); ``pack_words`` is word-major,
peer-minor ([N, M] -> [W, N]).
"""

from __future__ import annotations

import torch

I32 = torch.int32
_M32 = 0xFFFFFFFF


def n_words(m: int) -> int:
    return (m + 31) // 32


def to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 tensor of 32-bit patterns (any sign) -> int32 with the same
    low 32 bits."""
    v = v & _M32
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(I32)


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2**32)."""
    return x.to(torch.int64) & _M32


def lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns by a static 0 <= s < 32."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (32 - s)) - 1)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 in, int32 out): SWAR in int32
    on the low 31 bits, where no step can overflow, plus the sign bit.
    Every temporary is the input's size (an int64 SWAR doubles it)."""
    x = x.to(I32)
    v = x & 0x7FFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = (v + (v >> 16)) & 0x3F
    return v + (x < 0).to(I32)


def _bit_weights(device) -> torch.Tensor:
    return torch.ones(32, dtype=torch.int64, device=device) << torch.arange(
        32, dtype=torch.int64, device=device)


def pack_bool(x: torch.Tensor) -> torch.Tensor:
    """bool [..., M] -> int32 [..., ceil(M/32)] (little-endian bit order)."""
    *lead, m = x.shape
    w = n_words(m)
    pad = w * 32 - m
    if pad:
        x = torch.cat([x, torch.zeros((*lead, pad), dtype=x.dtype,
                                      device=x.device)], dim=-1)
    xr = x.reshape(*lead, w, 32).to(torch.int64)
    return to_i32((xr * _bit_weights(x.device)).sum(-1))


def unpack_bool(p: torch.Tensor, m: int) -> torch.Tensor:
    """int32 [..., ceil(m/32)] -> bool [..., m] (inverse of pack_bool)."""
    *lead, w = p.shape
    if w != n_words(m):
        raise ValueError(
            f"unpack_bool: packed shape {tuple(p.shape)} does not carry "
            f"ceil({m}/32)={n_words(m)} words on the last axis")
    sh = torch.arange(32, dtype=I32, device=p.device)
    bits = (p[..., :, None] >> sh) & 1
    return bits.reshape(*lead, w * 32)[..., :m].bool()


def pack_words(x: torch.Tensor) -> torch.Tensor:
    """bool [N, M] -> int32 [W, N] (word-major, peer-minor)."""
    return pack_bool(x).T.contiguous()


def unpack_words(p: torch.Tensor, m: int) -> torch.Tensor:
    """int32 [W, ...] -> bool [..., m] (inverse of pack_words)."""
    w, *rest = p.shape
    sh = torch.arange(32, dtype=I32, device=p.device).reshape(
        (1, 32) + (1,) * len(rest))
    bits = (p[:, None] >> sh) & 1
    flat = bits.reshape((w * 32,) + tuple(rest))[:m]
    return torch.movedim(flat, 0, -1).bool()


def gather_words_rows(x_w: torch.Tensor, nbr: torch.Tensor,
                      mode: str = "auto", m: int | None = None,
                      sort_key: torch.Tensor | None = None) -> torch.Tensor:
    """out[w, k, n] = x_w[w, nbr[n, k]]: the neighbour gather of packed
    words of an ``m``-message window (bits.py:80-93; ``m`` defaults to
    32 W), in the formulation ``mode`` resolves to
    (ops/permgather.gather_words; ``sort_key`` is the k-major
    ``edge_sort_key`` the sort formulation needs). ``nbr`` must be
    pre-clipped."""
    from .permgather import gather_words
    return gather_words(x_w, nbr, mode, m=m, sort_key=sort_key)


def reduce_or(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Bitwise-OR reduction along ``axis``."""
    parts = torch.unbind(x, dim=axis)
    out = torch.zeros_like(parts[0])
    for p in parts:
        out = out | p
    return out


def exclusive_prefix_or(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Exclusive running OR along ``axis`` (first element -> 0)."""
    parts = torch.unbind(x, dim=axis)
    acc = torch.zeros_like(parts[0])
    outs = []
    for p in parts:
        outs.append(acc)
        acc = acc | p
    return torch.stack(outs, dim=axis)


def popcount_sum(x: torch.Tensor, axis=-1, dtype=torch.float32) -> torch.Tensor:
    """Total set bits summed over ``axis`` (int or tuple), cast to ``dtype``.

    Sums in int64 and casts once: the reference sums float32 popcounts,
    which equals this cast while the partial sums stay below 2**24."""
    return popcount(x).to(torch.int64).sum(dim=axis).to(dtype)


def prefix_count(x: torch.Tensor, exclusive: bool = False) -> torch.Tensor:
    """Running count of set bools along the LAST axis (inclusive by
    default), as bit-pack + masked popcount (the reference's formulation)."""
    return prefix_count_words(pack_bool(x), x.shape[-1], exclusive)


def prefix_count_words(packed: torch.Tensor, k: int,
                       exclusive: bool = False) -> torch.Tensor:
    """:func:`prefix_count` on an ALREADY-PACKED ``[..., ceil(k/32)]`` int32
    input -> ``[..., k]`` int32. Inclusive by default: element j counts the
    set bits at or below j (``exclusive=True``: strictly below j)."""
    w = n_words(k)
    if packed.shape[-1] != w:
        raise ValueError(
            f"prefix_count_words: packed shape {tuple(packed.shape)} does not "
            f"carry ceil({k}/32)={w} words on the last axis")
    dev = packed.device
    kidx = torch.arange(k, device=dev)
    word_of = kidx // 32
    nbits = (kidx % 32) + (0 if exclusive else 1)          # 1..32 bits
    own_mask = to_i32((torch.ones_like(nbits) << nbits) - 1)
    own_word = packed[..., word_of]                        # [..., k]
    total = popcount(own_word & own_mask)
    for wi in range(w - 1):                                # full words below
        below = (word_of > wi).to(I32)
        total = total + popcount(packed[..., wi:wi + 1]) * below
    return total
