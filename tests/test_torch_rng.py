"""Parity: the port's threefry streams (go_libp2p_pubsub_tpu_torch/rng.py)
against jax.random, bit for bit, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import rng

SEEDS = [0, 42, 2 ** 40 + 7]
SHAPES = [(), (5,), (3, 4), (2, 3, 5)]


def _key_pair(seed):
    jk = jax.random.PRNGKey(seed)
    tk = rng.PRNGKey(seed, device="cpu")
    return jk, tk


def _u32(a):
    return np.asarray(a).astype(np.uint32)


def _t_u32(t):
    return t.numpy().astype(np.uint64).astype(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey(seed):
    jk, tk = _key_pair(seed)
    np.testing.assert_array_equal(_u32(jk), _t_u32(tk))


@pytest.mark.parametrize("num", [2, 6, 8])
@pytest.mark.parametrize("seed", SEEDS)
def test_split(seed, num):
    jk, tk = _key_pair(seed)
    np.testing.assert_array_equal(_u32(jax.random.split(jk, num)),
                                  _t_u32(rng.split(tk, num)))
    # split of a split: the per-tick key schedule of engine.run
    np.testing.assert_array_equal(
        _u32(jax.random.split(jax.random.split(jk, num)[num - 1], 3)),
        _t_u32(rng.split(rng.split(tk, num)[num - 1], 3)))


@pytest.mark.parametrize("data", [0, 1, 12345, 2 ** 31 + 5])
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed, data):
    jk, tk = _key_pair(seed)
    np.testing.assert_array_equal(_u32(jax.random.fold_in(jk, data)),
                                  _t_u32(rng.fold_in(tk, data)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits(seed, shape):
    jk, tk = _key_pair(seed)
    want = _u32(jax.random.bits(jk, shape, dtype=jnp.uint32))
    np.testing.assert_array_equal(want, _t_u32(rng.random_bits(tk, shape)))


@pytest.mark.parametrize("shape", SHAPES + [(64, 1, 32)])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bit_equal(seed, shape):
    jk, tk = _key_pair(seed)
    want = np.asarray(jax.random.uniform(jk, shape))
    got = rng.uniform(tk, shape).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("bounds", [(0, 1024), (0, 102400), (-5, 7), (3, 3),
                                    (0, 2 ** 31 - 1)])
@pytest.mark.parametrize("seed", SEEDS)
def test_randint(seed, bounds):
    jk, tk = _key_pair(seed)
    lo, hi = bounds
    for shape in [(8,), (4, 3), (257,)]:
        want = np.asarray(jax.random.randint(jk, shape, lo, hi))
        got = rng.randint(tk, shape, lo, hi).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("shape", [(8, 1), (8, 3), (16, 5)])
@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel(seed, shape):
    # -log(-log(u)) over bit-equal u: the port's log may differ from XLA's
    # by an ulp. rtol 1e-6 holds everywhere except next to the outer log's
    # zero crossing, where one ulp of the inner value (~6e-8 absolute) is a
    # large relative change: the 1e-7 absolute floor covers that
    jk, tk = _key_pair(seed)
    want = np.asarray(jax.random.gumbel(jk, shape))
    np.testing.assert_allclose(rng.gumbel(tk, shape).numpy(), want,
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", SEEDS)
def test_choose_publishers_same_at_t3(seed):
    from go_libp2p_pubsub_tpu.sim import SimConfig as JConfig
    from go_libp2p_pubsub_tpu.sim import init_state as jinit
    from go_libp2p_pubsub_tpu.sim import topology as jtopo
    from go_libp2p_pubsub_tpu.sim.engine import choose_publishers as jchoose

    from go_libp2p_pubsub_tpu_torch.sim import SimConfig, init_state, topology
    from go_libp2p_pubsub_tpu_torch.sim.engine import choose_publishers

    n, k, t = 96, 8, 3
    subs = np.random.default_rng(seed).random((n, t)) < 0.6
    jcfg = JConfig(n_peers=n, k_slots=k, n_topics=t, msg_window=32,
                   publishers_per_tick=8)
    jst = jinit(jcfg, jtopo.sparse(n, k, degree=4), subscribed=subs)
    cfg = SimConfig(n_peers=n, k_slots=k, n_topics=t, msg_window=32,
                    publishers_per_tick=8)
    st = init_state(cfg, topology.sparse(n, k, degree=4), subscribed=subs,
                    device="cpu")
    jk, tk = _key_pair(seed)
    for i in range(4):
        jp, jt = jchoose(jst, jcfg, jax.random.split(jk, 4)[i])
        p, tt = choose_publishers(st, cfg, rng.split(tk, 4)[i])
        np.testing.assert_array_equal(np.asarray(jp), p.numpy())
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
