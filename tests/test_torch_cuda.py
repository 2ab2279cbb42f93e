"""The port's CUDA kernels against their plain PyTorch versions on the card,
and the card's 4-tick trajectory against the CPU's. Every test here needs an
NVIDIA GPU and nvcc, and skips without them. This file imports nothing of
JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.ops import hopkernel as hk
from go_libp2p_pubsub_tpu_torch.ops import permgather as pg
from go_libp2p_pubsub_tpu_torch.ops.bits import pack_bool

pytestmark = pytest.mark.cuda

N, K, M = 4096, 32, 64
W = M // 32


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels run only on "
                    "the card")


def _inputs(seed, t):
    g = torch.Generator().manual_seed(seed)

    def words(*shape, p=0.5):
        return pack_bool(torch.rand(*shape, 32, generator=g) < p)[..., 0]

    def u8(*shape, p=0.3):
        return (torch.rand(*shape, generator=g) < p).to(torch.uint8)

    topic = torch.randint(-1, t, (W * 32,), generator=g)
    return dict(
        nbr=torch.randint(0, N, (N, K), generator=g, dtype=torch.int32),
        tb=pack_bool(topic[None, :] == torch.arange(t)[:, None]),
        frontier=words(W, N, p=0.1), have=words(W, N, p=0.3),
        dlv=words(W, N, p=0.3), dlv_new=words(W, N, p=0.1),
        vm=words(W, N, p=0.9), inv_n=words(W, N, p=0.05),
        window_old=words(W, N, p=0.2), valid_msg=words(W, 1, p=0.9),
        fwd=u8(N, t, K), mesh=u8(N, t, K),
        nv=torch.randint(0, 256, (t, K, N), generator=g).to(torch.uint8),
        ni=torch.randint(0, 256, (t, K, N), generator=g).to(torch.uint8),
        dup=torch.randint(0, 256, (t, K, N), generator=g).to(torch.uint8),
        pend=torch.randint(-1, K, (N, M), generator=g, dtype=torch.int32),
        answers=words(W, N), alive=words(W, 1, p=0.9),
        data_ok=u8(N, K, p=0.9), window=words(W, N, p=0.3),
        gossip=u8(N, t, K, p=0.2))


def _both(fn, d, names, *extra):
    """fn on CUDA copies and on the CPU originals, outputs as CPU lists."""
    got = fn(*[d[k].cuda() for k in names], *extra)
    want = fn(*[d[k].clone() for k in names], *extra)
    torch.cuda.synchronize()
    got = list(got) if isinstance(got, (tuple, list)) else [got]
    want = list(want) if isinstance(want, (tuple, list)) else [want]
    return [x.cpu() for x in got], want


@pytest.mark.parametrize("t", [1, 3])
def test_hop_kernel_equals_plain(t):
    _need_card()
    names = ["frontier", "have", "dlv", "dlv_new", "vm", "inv_n",
             "window_old", "valid_msg", "nbr", "fwd", "mesh", "tb", "nv",
             "ni", "dup"]
    for a, b in zip(*_both(hk.hop, _inputs(t, t), names)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("t", [1, 3])
def test_iwant_resolve_kernel_equals_plain(t):
    _need_card()
    names = ["pend", "answers", "have", "vm", "inv_n", "alive", "data_ok",
             "tb", "nbr"]
    for a, b in zip(*_both(hk.iwant_resolve, _inputs(10 + t, t), names, M)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("t,budget", [(1, M), (1, 5), (3, M), (3, 1)])
def test_emit_kernel_equals_plain(t, budget):
    _need_card()
    names = ["window", "have", "gossip", "tb", "nbr"]
    got, want = _both(hk.emit, _inputs(20 + t, t), names, M, budget)
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("b_planes", [1, 2, 6, 40])
def test_edge_table_kernel_equals_plain(b_planes):
    _need_card()
    g = torch.Generator().manual_seed(b_planes)
    wb = (b_planes * K + 31) // 32
    d = dict(table=pack_bool(torch.rand(N, wb, 32, generator=g) < 0.3)[..., 0],
             jn=torch.randint(0, N, (N, K), generator=g, dtype=torch.int32),
             rk=torch.randint(0, K, (N, K), generator=g, dtype=torch.int32))
    got, want = _both(pg.edge_table, d, ["table", "jn", "rk"], b_planes)
    assert len(got) == (b_planes + 31) // 32
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_trajectory_cuda_equals_cpu():
    """4 ticks of the headline network at 512 peers: every field of the
    card's state equals the CPU's (float32 within rtol 1e-6)."""
    _need_card()
    from go_libp2p_pubsub_tpu_torch.sim import (build_headline, run,
                                                state_to_numpy, topology)
    topo = topology.sparse(512, K, degree=12)
    outs = []
    for dev in ("cuda", "cpu"):
        cfg, tp, st = build_headline(512, device=dev, topo=topo)
        outs.append(state_to_numpy(run(st, cfg, tp, rng.PRNGKey(0, device=dev),
                                       4, device=dev)))
    for f, a in outs[0].items():
        b = outs[1][f]
        if a.dtype == np.float32:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
