"""Parity: the port's packed-word helpers (go_libp2p_pubsub_tpu_torch/
ops/bits.py, int32 words) against ops/bits.py (uint32 words), on inputs with
bit 31 set."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.ops import bits as jb
from go_libp2p_pubsub_tpu_torch.ops import bits as tb


def _words(rng, *shape):
    w = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)
    w.flat[0] |= np.uint32(0x80000000)                     # bit 31 set
    return w


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def _same(jax_out, torch_out):
    a = np.asarray(jax_out)
    b = torch_out.numpy()
    if a.dtype == np.uint32:
        b = b.view(np.uint32)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("m", [1, 32, 37, 64, 100])
def test_pack_unpack_bool(m):
    rng = np.random.default_rng(m)
    x = rng.random((5, 3, m)) < 0.5
    x[..., -1] = True
    if m >= 32:
        x[..., 31] = True                                   # bit 31 of word 0
    _same(jb.pack_bool(jnp.asarray(x)), tb.pack_bool(torch.from_numpy(x)))
    p = _words(rng, 5, 3, tb.n_words(m))
    _same(jb.unpack_bool(jnp.asarray(p), m), tb.unpack_bool(_t(p), m))


@pytest.mark.parametrize("m", [33, 64, 96])
def test_pack_unpack_words(m):
    rng = np.random.default_rng(m)
    x = rng.random((17, m)) < 0.5
    x[:, 31] = True
    _same(jb.pack_words(jnp.asarray(x)), tb.pack_words(torch.from_numpy(x)))
    p = _words(rng, tb.n_words(m), 17)
    _same(jb.unpack_words(jnp.asarray(p), m), tb.unpack_words(_t(p), m))
    p3 = _words(rng, tb.n_words(m), 4, 17)
    _same(jb.unpack_words(jnp.asarray(p3), m), tb.unpack_words(_t(p3), m))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_reduce_and_prefix_or(axis):
    rng = np.random.default_rng(axis)
    x = _words(rng, 3, 7, 5)
    _same(jb.reduce_or(jnp.asarray(x), axis), tb.reduce_or(_t(x), axis))
    _same(jb.exclusive_prefix_or(jnp.asarray(x), axis),
          tb.exclusive_prefix_or(_t(x), axis))


@pytest.mark.parametrize("axis", [0, 1, (0, 1)])
def test_popcount_sum(axis):
    rng = np.random.default_rng(7)
    x = _words(rng, 4, 9)
    x[0, 0] = np.uint32(0xFFFFFFFF)
    for dtype_j, dtype_t in ((jnp.float32, torch.float32),
                             (jnp.int32, torch.int32)):
        _same(jb.popcount_sum(jnp.asarray(x), axis=axis, dtype=dtype_j),
              tb.popcount_sum(_t(x), axis=axis, dtype=dtype_t))
    _same(jb.popcount(jnp.asarray(x)), tb.popcount(_t(x)))


@pytest.mark.parametrize("k", [1, 8, 32, 33, 70])
@pytest.mark.parametrize("exclusive", [False, True])
def test_prefix_count(k, exclusive):
    rng = np.random.default_rng(k)
    x = rng.random((6, 2, k)) < 0.5
    x[..., min(31, k - 1)] = True
    _same(jb.prefix_count(jnp.asarray(x), exclusive=exclusive),
          tb.prefix_count(torch.from_numpy(x), exclusive=exclusive))
    p = _words(rng, 6, tb.n_words(k))
    _same(jb.prefix_count_words(jnp.asarray(p), k, exclusive),
          tb.prefix_count_words(_t(p), k, exclusive))


def test_prefix_count_words_width_guard():
    with pytest.raises(ValueError):
        tb.prefix_count_words(torch.zeros((3, 1), dtype=torch.int32), 40)


def test_logical_shift_and_casts():
    x = torch.tensor([-1, -2 ** 31, 5], dtype=torch.int32)
    assert tb.lsr(x, 31).tolist() == [1, 1, 0]
    assert tb.lsr(x, 4).tolist() == [0x0FFFFFFF, 0x08000000, 0]
    assert tb.to_u32(x).tolist() == [2 ** 32 - 1, 2 ** 31, 5]
    assert tb.to_i32(tb.to_u32(x)).tolist() == x.tolist()
