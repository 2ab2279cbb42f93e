"""Parity: each CUDA kernel's plain PyTorch version (the path the wrappers
take for CPU tensors) against the JAX package's Pallas kernel in interpret
mode, exactly, at T=1 and T=3 (emit also with budget < M). The kernels
themselves are held to these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.ops.hopkernel import (emit_pallas, hop_pallas,
                                                iwant_resolve_pallas)
from go_libp2p_pubsub_tpu.ops.permgather import _edge_table_pallas
from go_libp2p_pubsub_tpu_torch.ops import hopkernel as hk
from go_libp2p_pubsub_tpu_torch.ops import permgather as pg

N, K, M = 256, 16, 64
W = M // 32


def _words(rng, *shape, density=0.5):
    bits = rng.random(shape + (32,)) < density
    w = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    w = w.astype(np.uint32)
    w.flat[0] |= np.uint32(0x80000000)                     # bit 31 set
    return w


def _topic_bits(rng, t):
    topic = rng.integers(-1, t, size=W * 32)
    bits = topic[None, :] == np.arange(t)[:, None]
    return (bits.reshape(t, W, 32).astype(np.uint64)
            << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def _same(jax_out, torch_out, what):
    a = np.asarray(jax_out)
    b = torch_out.numpy()
    if a.dtype == np.uint32:
        b = b.view(np.uint32)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _inputs(seed, t):
    """Numpy inputs of all four kernels at one seed and topic count."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, N, size=(N, K), dtype=np.int32)
    d = dict(
        nbr=nbr, tb=_topic_bits(rng, t),
        frontier=_words(rng, W, N, density=0.1),
        have=_words(rng, W, N, density=0.3),
        dlv=_words(rng, W, N, density=0.3),
        dlv_new=_words(rng, W, N, density=0.1),
        vm=_words(rng, W, N, density=0.9),
        inv_n=_words(rng, W, N, density=0.05),
        window_old=_words(rng, W, N, density=0.2),
        valid_msg=_words(rng, W, 1, density=0.9),
        fwd=(rng.random((N, t, K)) < 0.3).astype(np.uint8),
        mesh=(rng.random((N, t, K)) < 0.3).astype(np.uint8),
        nv=rng.integers(0, 256, size=(t, K, N), dtype=np.uint8),
        ni=rng.integers(0, 256, size=(t, K, N), dtype=np.uint8),
        dup=rng.integers(0, 256, size=(t, K, N), dtype=np.uint8),
        pend=rng.integers(-1, K, size=(N, M), dtype=np.int32),
        answers=_words(rng, W, N, density=0.5),
        alive=_words(rng, W, 1, density=0.9),
        data_ok=(rng.random((N, K)) < 0.9).astype(np.uint8),
        window=_words(rng, W, N, density=0.3),
        gossip=(rng.random((N, t, K)) < 0.3).astype(np.uint8),
    )
    return d


@pytest.mark.parametrize("b_planes", [1, 2, 6])
@pytest.mark.parametrize("seed", [0, 1])
def test_edge_table_plain_equals_pallas(seed, b_planes):
    rng = np.random.default_rng(seed)
    wb = (b_planes * K + 31) // 32
    table = _words(rng, N, wb, density=0.3)
    jn = rng.integers(0, N, size=(N, K), dtype=np.int32)
    rk = rng.integers(0, K, size=(N, K), dtype=np.int32)
    want = _edge_table_pallas(jnp.asarray(table), jnp.asarray(jn),
                              jnp.asarray(rk), b_planes=b_planes,
                              interpret=True)
    got = pg.edge_table(_t(table), _t(jn), _t(rk), b_planes)
    assert len(got) == len(want) == (b_planes + 31) // 32
    for g_j, g_t in zip(want, got):
        _same(g_j, g_t, "edge_table")


@pytest.mark.parametrize("t", [1, 3])
def test_hop_plain_equals_pallas(t):
    d = _inputs(10 + t, t)
    names = ["frontier", "have", "dlv", "dlv_new", "vm", "inv_n",
             "window_old", "valid_msg", "nbr", "fwd", "mesh", "tb", "nv",
             "ni", "dup"]
    want = hop_pallas(*[jnp.asarray(d[k]) for k in names], interpret=True)
    got = hk.hop(*[_t(d[k]) for k in names])
    for f, a, b in zip(want._fields, want, got):
        _same(a, b, f"hop.{f}")
    # non-vacuous: the hop found new messages and counted events
    assert int(np.asarray(want.new_valid).any())


@pytest.mark.parametrize("t", [1, 3])
def test_iwant_resolve_plain_equals_pallas(t):
    d = _inputs(20 + t, t)
    names = ["pend", "answers", "have", "vm", "inv_n", "alive", "data_ok",
             "tb", "nbr"]
    want = iwant_resolve_pallas(*[jnp.asarray(d[k]) for k in names], m=M,
                                interpret=True)
    got = hk.iwant_resolve(*[_t(d[k]) for k in names], M)
    for f, a, b in zip(want._fields, want, got):
        _same(a, b, f"iwant_resolve.{f}")
    assert int(np.asarray(want.broken).sum()) > 0


@pytest.mark.parametrize("t,budget", [(1, M), (1, 5), (3, M), (3, 2)])
def test_emit_plain_equals_pallas(t, budget):
    d = _inputs(30 + t, t)
    names = ["window", "have", "gossip", "tb", "nbr"]
    want = emit_pallas(*[jnp.asarray(d[k]) for k in names], m=M,
                       budget=budget, interpret=True)
    got = hk.emit(*[_t(d[k]) for k in names], M, budget)
    _same(want, got, "emit")
    assert int((np.asarray(want) >= 0).sum()) > 0


def test_wrappers_refuse_other_devices():
    meta = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        pg.edge_table(meta, meta, meta, 1)
    d = _inputs(0, 1)
    cpu = [_t(d[k]) for k in ("window", "have", "gossip", "tb")]
    with pytest.raises(ValueError):
        hk.emit(*cpu, torch.zeros((N, K), dtype=torch.int32, device="meta"),
                M, M)
