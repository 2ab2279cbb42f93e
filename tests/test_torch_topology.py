"""Parity of the port's topology builders (go_libp2p_pubsub_tpu_torch/sim/
topology.py) with the JAX package's sim/topology.py: every field
array-equal, dtypes included, over several ``(n, k, degree, seed)``; the
sharded builds (``rows=(start, count)``) concatenated equal to the full
build; the refusals raise the reference's errors."""

import numpy as np
import pytest

from go_libp2p_pubsub_tpu.sim import topology as jtopo
from go_libp2p_pubsub_tpu_torch.sim import topology


def _equal(got, want):
    assert type(got).__name__ == "Topology"
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)


def _concat(parts):
    return topology.Topology(*[np.concatenate([getattr(p, f) for p in parts])
                               for f in topology.Topology._fields])


def _shards(n, cuts):
    bounds = [0, *cuts, n]
    return [(a, b - a) for a, b in zip(bounds, bounds[1:])]


@pytest.mark.parametrize("n,k,degree,seed", [(64, 16, 10, 314159),
                                             (200, 24, 6, 7),
                                             (90, 8, 10, 1)])
def test_dense_equal(n, k, degree, seed):
    _equal(topology.dense(n, k, degree=degree, seed=seed),
           jtopo.dense(n, k, degree=degree, seed=seed))


@pytest.mark.parametrize("n,k,degree,seed", [(2, 4, 1, 0), (300, 16, 8, 314159),
                                             (1000, 32, 12, 3),
                                             (4096, 32, 8, 314159),
                                             (500, 6, 8, 11)])
def test_sparse_fast_equal(n, k, degree, seed):
    want = jtopo.sparse_fast(n, k, degree=degree, seed=seed)
    _equal(topology.sparse_fast(n, k, degree=degree, seed=seed), want)
    # the reverse slots are a true involution
    nb, rs = want.neighbors, want.reverse_slot
    i, s = np.nonzero(nb >= 0)
    assert (nb[nb[i, s], rs[i, s]] == i).all()


@pytest.mark.parametrize("n,k,degree,seed", [(64, 16, 4, 314159),
                                             (1001, 24, 8, 5),
                                             (4096, 32, 8, 314159),
                                             (9, 8, 4, 2)])
def test_sparse_hash_equal_and_shards_concatenate(n, k, degree, seed):
    np.testing.assert_array_equal(topology.hash_offsets(n, degree, seed),
                                  jtopo.hash_offsets(n, degree, seed))
    full = topology.sparse_hash(n, k, degree=degree, seed=seed)
    _equal(full, jtopo.sparse_hash(n, k, degree=degree, seed=seed))
    _equal(topology.sparse_hash(n, k, degree=degree, seed=seed,
                                chunk_rows=7), full)
    for cuts in ([n // 2], [1, n // 3, n - 2]):
        parts = [topology.sparse_hash(n, k, degree=degree, seed=seed, rows=r)
                 for r in _shards(n, cuts)]
        _equal(_concat(parts), full)
        r = _shards(n, cuts)[-1]
        _equal(parts[-1], jtopo.sparse_hash(n, k, degree=degree, seed=seed,
                                            rows=r))


@pytest.mark.parametrize("n,d_min,d_max,alpha", [(64, 8, 64, 2.0),
                                                 (1000, 4, 32, 2.5),
                                                 (4096, 8, 64, 2.0),
                                                 (300, 2, 16, 1.5)])
def test_powerlaw_equal_and_shards_concatenate(n, d_min, d_max, alpha):
    levels = topology.powerlaw_levels(n, d_min=d_min, d_max=d_max,
                                      alpha=alpha)
    assert levels == jtopo.powerlaw_levels(n, d_min=d_min, d_max=d_max,
                                           alpha=alpha)
    k = 2 * sum(c for _, c in levels)
    kw = dict(d_min=d_min, d_max=d_max, alpha=alpha, seed=314159)
    full = topology.powerlaw(n, k, **kw)
    _equal(full, jtopo.powerlaw(n, k, **kw))
    _equal(topology.powerlaw(n, k + 3, **kw), jtopo.powerlaw(n, k + 3, **kw))
    _equal(topology.powerlaw(n, k, chunk_elems=100, **kw), full)
    for cuts in ([3], [n // 7, n // 2, n - 1]):
        parts = [topology.powerlaw(n, k, rows=r, **kw)
                 for r in _shards(n, cuts)]
        _equal(_concat(parts), full)
    # degrees non-increasing with the id; hubs are the low ids
    assert (np.diff(full.degree) <= 0).all()
    with pytest.raises(ValueError, match="needs k >="):
        topology.powerlaw(n, k - 1, **kw)


@pytest.mark.parametrize("kw", [dict(n=3), dict(n=64, d_min=3),
                                dict(n=64, d_min=8, d_max=4),
                                dict(n=64, alpha=1.0)])
def test_powerlaw_levels_refuse_what_the_reference_refuses(kw):
    with pytest.raises(ValueError) as want:
        jtopo.powerlaw_levels(**kw)
    with pytest.raises(ValueError) as got:
        topology.powerlaw_levels(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,k", [(2, 1), (9, 8), (17, 20)])
def test_full_and_star_equal(n, k):
    _equal(topology.full(n, k), jtopo.full(n, k))
    _equal(topology.star(n, max(k, n - 1)), jtopo.star(n, max(k, n - 1)))
    # a hub narrower than its spokes orphans the spokes past slot k
    _equal(topology.star(n, k), jtopo.star(n, k))


def test_builders_refuse_what_the_reference_refuses():
    calls = [("full", (9, 7), {}), ("sparse_fast", (1, 4), {}),
             ("sparse_hash", (1, 4), {}), ("sparse_hash", (64, 7), {}),
             ("sparse_hash", (64, 16), dict(rows=(60, 5))),
             ("hash_offsets", (8, 4), {})]
    for name, args, kw in calls:
        with pytest.raises(ValueError) as want:
            getattr(jtopo, name)(*args, **kw)
        with pytest.raises(ValueError) as got:
            getattr(topology, name)(*args, **kw)
        assert str(got.value) == str(want.value), name
