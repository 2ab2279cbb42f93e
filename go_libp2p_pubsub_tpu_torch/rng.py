"""jax.random's threefry2x32 streams, bit for bit, in PyTorch.

Every draw on the engine's path is a jax threefry draw, so no trajectory of
the port could be compared with the reference under any other generator.
This module reproduces jax 0.9.0's default (``jax_threefry_partitionable``
True) key derivation and samplers:

- :func:`threefry2x32` — the Threefry-2x32 hash (jax/_src/prng.py
  ``_threefry2x32_lowering``, 20 rounds);
- :func:`split` — the fold-like split (``_threefry_split_foldlike``);
- :func:`fold_in` — ``threefry_2x32(key, threefry_seed(data))``;
- :func:`random_bits` — ``_threefry_random_bits_partitionable`` at 32 bits;
- :func:`uniform`, :func:`randint`, :func:`gumbel` — jax/_src/random.py
  ``_uniform``, ``_randint``, ``_gumbel`` (mode "low").

A key is an explicit ``[2]`` int64 tensor holding two uint32 values; there
is no global generator state. All arithmetic runs in int64 masked to 32
bits, on the key's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` under jax's default 32-bit mode: the
    seed is taken modulo 2**32, so the key is ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=resolve_device(device))


def _rotl(x, d):
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 of the count pairs (x0, x1) under key (k1, k2): all
    int64 tensors (or ints) holding uint32 values, broadcast together."""
    ks = (k1, k2, (k1 ^ k2 ^ 0x1BD11BDA) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _counts(shape, device):
    """jax's ``iota_2x32_shape``: the C-order flat index as (hi, lo)."""
    size = int(np.prod(shape, dtype=np.int64)) if len(shape) else 1
    idx = torch.arange(size, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & _M32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> [num, 2]."""
    hi, lo = _counts((num,), key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for 32-bit ``data``: a Python int
    (filled on the key's device, no host copy) or an integer tensor on the
    key's device (a tick counter folds with no host read). A tensor of
    shape S gives keys of shape S + [2]."""
    if isinstance(data, torch.Tensor):
        d = data.to(torch.int64) & _M32
    else:
        d = torch.full((), int(data) & _M32, dtype=torch.int64,
                       device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(d), d)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit ``jax.random.bits`` of ``shape`` as int64 values in [0, 2**32)."""
    shape = tuple(shape)
    hi, lo = _counts(shape, key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` (float32): 23 random mantissa bits with a unit
    exponent, minus one, scaled and shifted in float32, floored at minval.

    ``lo`` and ``span`` are Python floats holding float32 values exactly
    (``span`` is the float32 difference, as jax takes it), so each scalar
    op casts them back to the same float32 and computes in float32: the
    same bits as float32 tensor operands, with no host-to-device copy."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(floats * span + lo, min=lo)


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` for int32 output and static int bounds within
    the int32 range: two 32-bit draws folded modulo the span, with jax's
    uint32 wrap-around in the multiplier."""
    k = split(key, 2)
    hi_bits = random_bits(k[0], shape)
    lo_bits = random_bits(k[1], shape)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span
    off = (((hi_bits % span) * mult) & _M32) + (lo_bits % span)
    off = (off & _M32) % span
    return (off + minval).to(torch.int32)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` (float32, mode "low"): -log(-log(u)) with u
    uniform in [tiny, 1). ``log`` may differ from XLA's by an ulp."""
    tiny = float(np.finfo(np.float32).tiny)
    u = uniform(key, shape, minval=tiny, maxval=1.0)
    return -torch.log(-torch.log(u))
