"""The port's CUDA kernels against their plain PyTorch versions on the card,
the card's 4-tick trajectory against the CPU's, and the captured engine
plane (parallel/compile_plan.py) against the eager run, with an eager tick
that makes no synchronization. Every test here needs an
NVIDIA GPU and nvcc, and skips without them. This file imports nothing of
JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.ops import hopkernel as hk
from go_libp2p_pubsub_tpu_torch.ops import mxutake as mt
from go_libp2p_pubsub_tpu_torch.ops import permgather as pg
from go_libp2p_pubsub_tpu_torch.ops.bits import pack_bool

pytestmark = pytest.mark.cuda

N, K, M = 4096, 32, 64
W = M // 32


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels run only on "
                    "the card")


def _inputs(seed, t, n=N, k=K, w=W):
    g = torch.Generator().manual_seed(seed)
    m = 32 * w

    def words(*shape, p=0.5):
        return pack_bool(torch.rand(*shape, 32, generator=g) < p)[..., 0]

    def u8(*shape, p=0.3):
        return (torch.rand(*shape, generator=g) < p).to(torch.uint8)

    topic = torch.randint(-1, t, (w * 32,), generator=g)
    return dict(
        nbr=torch.randint(0, n, (n, k), generator=g, dtype=torch.int32),
        tb=pack_bool(topic[None, :] == torch.arange(t)[:, None]),
        frontier=words(w, n, p=0.1), have=words(w, n, p=0.3),
        dlv=words(w, n, p=0.3), dlv_new=words(w, n, p=0.1),
        vm=words(w, n, p=0.9), inv_n=words(w, n, p=0.05),
        window_old=words(w, n, p=0.2), valid_msg=words(w, 1, p=0.9),
        fwd=u8(n, t, k), mesh=u8(n, t, k),
        nv=torch.randint(0, 256, (t, k, n), generator=g).to(torch.uint8),
        ni=torch.randint(0, 256, (t, k, n), generator=g).to(torch.uint8),
        dup=torch.randint(0, 256, (t, k, n), generator=g).to(torch.uint8),
        pend=torch.randint(-1, k, (n, m), generator=g, dtype=torch.int32),
        answers=words(w, n), alive=words(w, 1, p=0.9),
        data_ok=u8(n, k, p=0.9), window=words(w, n, p=0.3),
        gossip=u8(n, t, k, p=0.2))


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


# the slot-parallel hop at K below, above and at twice one warp of slots,
# N = 1001 (no multiple of any block of receivers), W = 1 to 3, T = 1 (the
# kernel's single-topic instance), 3 and 8
@pytest.mark.parametrize("k,t,w", [(8, 1, 1), (8, 3, 3), (40, 1, 3),
                                   (40, 3, 1), (64, 1, 1), (64, 3, 3),
                                   (64, 8, 2)])
def test_hop_kernel_slot_chunks_equal_plain(k, t, w):
    _need_card()
    names = ["frontier", "have", "dlv", "dlv_new", "vm", "inv_n",
             "window_old", "valid_msg", "nbr", "fwd", "mesh", "tb", "nv",
             "ni", "dup"]
    d = _inputs(100 + k + t + w, t, n=1001, k=k, w=w)
    for a, b in zip(*_both(hk.hop, d, names)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("t", [1, 3])
def test_iwant_resolve_kernel_equals_plain(t):
    _need_card()
    names = ["pend", "answers", "have", "vm", "inv_n", "alive", "data_ok",
             "tb", "nbr"]
    for a, b in zip(*_both(hk.iwant_resolve, _inputs(10 + t, t), names, M)):
        assert torch.equal(a, b)


# the slot-parallel resolve at K below, above and past four warps of slots
# (K = 130, beyond the earlier kernel's 128), N = 1001 (no multiple of a
# block), W = 1 to 3, with random and with empty pend rows
@pytest.mark.parametrize("empty", [False, True])
@pytest.mark.parametrize("k,t,w", [(8, 1, 1), (8, 3, 3), (40, 1, 3),
                                   (40, 3, 2), (130, 1, 2), (130, 3, 1)])
def test_iwant_resolve_kernel_slot_chunks_equal_plain(k, t, w, empty):
    _need_card()
    names = ["pend", "answers", "have", "vm", "inv_n", "alive", "data_ok",
             "tb", "nbr"]
    d = _inputs(300 + k + t + w, t, n=1001, k=k, w=w)
    if empty:
        d["pend"].fill_(-1)
    got, want = _both(hk.iwant_resolve, d, names, 32 * w)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert empty or want[4].any()


@pytest.mark.parametrize("t,budget", [(1, M), (1, 5), (3, M), (3, 1)])
def test_emit_kernel_equals_plain(t, budget):
    _need_card()
    names = ["window", "have", "gossip", "tb", "nbr"]
    got, want = _both(hk.emit, _inputs(20 + t, t), names, M, budget)
    assert torch.equal(got[0], want[0])


# the slot-parallel emit: budget 1 and 5 (the serial scan) and M (the
# prefix-OR), K up to 64 and K = 130 (int16 slot tile), N = 1001
@pytest.mark.parametrize("k,t,w,budget", [(8, 1, 1, 1), (8, 3, 3, 5),
                                          (40, 1, 3, 96), (40, 3, 1, 5),
                                          (64, 1, 1, 32), (64, 3, 3, 1),
                                          (130, 1, 2, 5), (130, 3, 2, 64)])
def test_emit_kernel_slot_chunks_equal_plain(k, t, w, budget):
    _need_card()
    names = ["window", "have", "gossip", "tb", "nbr"]
    d = _inputs(200 + k + t + w + budget, t, n=1001, k=k, w=w)
    got, want = _both(hk.emit, d, names, 32 * w, budget)
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


# N = 1001: B 1, 8 and 40 (a row wider than 8 words) at K = 32, K = 40, 8
# and 7 (bits selected in registers; at K = 7 an odd edge count, edges one
# at a time), B = 6 (a row padded to 8 words) and B = 12 at K = 8 (3 words
# padded to 4)
@pytest.mark.parametrize("b_planes,k", [(1, 32), (8, 32), (40, 32), (8, 40),
                                        (2, 8), (6, 32), (3, 7), (12, 8)])
def test_edge_table_kernel_shapes_equal_plain(b_planes, k):
    _need_card()
    n = 1001
    g = torch.Generator().manual_seed(80 + b_planes + k)
    wb = (b_planes * k + 31) // 32
    d = dict(table=pack_bool(torch.rand(n, wb, 32, generator=g) < 0.3)[..., 0],
             jn=torch.randint(0, n, (n, k), generator=g, dtype=torch.int32),
             rk=torch.randint(0, k, (n, k), generator=g, dtype=torch.int32))
    d["jn"][0, 0], d["jn"][-1, -1] = 0, n - 1
    got, want = _both(pg.edge_table, d, ["table", "jn", "rk"], b_planes)
    assert len(got) == (b_planes + 31) // 32
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# K * N no multiple of the block and N no multiple of the kernel's
# 32-receiver tile, a source wider than N; sources 0 and N_src - 1 among
# the indices. W = 9 (the wide window's rows) is read as nine 4-byte
# vectors by a block 8 lanes wide: one lane takes a second vector. K = 383
# is one staged chunk of nbr (a 48 KB tile); beyond it chunks of 382
# slots: two with a short second one, several, and a last one of a single
# slot
@pytest.mark.parametrize("w,n_src,n,k", [(1, N, N, K), (2, N, N, K),
                                         (3, N, N, K), (2, 1500, 1000, 7),
                                         (4, N, N, K), (8, N, N, K),
                                         (9, N, N, K),
                                         (10, N, N, K), (10, 1500, 1000, 7),
                                         (2, 1001, 1001, 383),
                                         (3, 1001, 1001, 384),
                                         (2, 1001, 1001, 512),
                                         (3, 1001, 1001, 765),
                                         (2, 1500, 1001, 1000)])
def test_gather_words_kernel_equals_plain(w, n_src, n, k):
    _need_card()
    g = torch.Generator().manual_seed(40 + w)
    d = dict(x=pack_bool(torch.rand(w, n_src, 32, generator=g) < 0.5)[..., 0],
             nbr=torch.randint(0, n_src, (n, k), generator=g,
                               dtype=torch.int32))
    d["nbr"][0, 0], d["nbr"][-1, -1] = 0, n_src - 1
    got, want = _both(pg.gather_words, d, ["x", "nbr"])
    assert got[0].shape == (w, k, n) and torch.equal(got[0], want[0])
    got, want = _both(pg.gather_words_plain, d, ["x", "nbr"])
    assert torch.equal(got[0], want[0])


def _at_offset(x, ofs):
    """``x`` copied into a buffer at a storage offset of ``ofs`` elements:
    on the card, an address no multiple of 16 bytes when ofs is odd."""
    buf = torch.empty(x.numel() + ofs, dtype=x.dtype, device=x.device)
    view = buf[ofs:].view(x.shape)
    view.copy_(x)
    return view


# N*K a multiple of 4 and not; jn, rk and out at a storage offset of one
# element (an address no multiple of 16 bytes)
@pytest.mark.parametrize("n,k,ofs", [(N, K, 0), (1001, 7, 0), (N, K, 1),
                                     (1001, 7, 1)])
def test_permutation_gather_kernel_shapes_equal_plain(n, k, ofs):
    _need_card()
    from go_libp2p_pubsub_tpu_torch.ops import cudalib
    g = torch.Generator().manual_seed(55 + k + ofs)
    payload = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, k), generator=g,
                            dtype=torch.int32).cuda()
    jn = torch.randint(0, n, (n, k), generator=g, dtype=torch.int32).cuda()
    rk = torch.randint(0, k, (n, k), generator=g, dtype=torch.int32).cuda()
    jn, rk = _at_offset(jn, ofs), _at_offset(rk, ofs)
    want = pg.permutation_gather_plain(payload, jn, rk)
    assert torch.equal(pg.permutation_gather(payload, jn, rk), want)
    out = _at_offset(torch.zeros_like(want), ofs)
    cudalib.launch("permutation_gather", payload, jn, rk, out, n, k, k)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_permutation_gather_kernel_equals_plain(dtype):
    _need_card()
    g = torch.Generator().manual_seed(50)
    payload = torch.randint(-2 ** 31, 2 ** 31 - 1, (N, K), generator=g,
                            dtype=torch.int32).view(dtype)
    d = dict(payload=payload,
             jn=torch.randint(0, N, (N, K), generator=g, dtype=torch.int32),
             rk=torch.randint(0, K, (N, K), generator=g, dtype=torch.int32))
    got, want = _both(pg.permutation_gather, d, ["payload", "jn", "rk"])
    assert got[0].dtype == dtype
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


# W from 1 to 10, R = 0 and R = N*K - 7 (no multiple of a block's rows);
# rows 0 and N - 1 among the indices
@pytest.mark.parametrize("w,r", [(2, N * K), (10, N * K), (1, N * K - 7),
                                 (3, 1000), (2, 0), (4, N * K), (8, N * K),
                                 (3, N * K - 7), (10, N * K - 7), (1, 0),
                                 (8, 0)])
def test_take_words_kernel_equals_plain(w, r):
    _need_card()
    g = torch.Generator().manual_seed(60 + w)
    d = dict(x=pack_bool(torch.rand(w, N, 32, generator=g) < 0.5)[..., 0],
             idx=torch.randint(0, N, (r,), generator=g, dtype=torch.int32))
    d["idx"][:2] = torch.tensor([0, N - 1], dtype=torch.int32)[:r]
    got, want = _both(mt.take_words, d, ["x", "idx"])
    assert got[0].shape == (w, r) and torch.equal(got[0], want[0])
    # the n-major take over the interleaved table
    d["tab"] = d["x"].T.contiguous()
    got, rows = _both(mt.take_rows, d, ["tab", "idx"])
    assert got[0].shape == (r, w) and torch.equal(got[0], rows[0])
    assert torch.equal(rows[0].T, want[0])


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_take_payload_kernel_equals_plain(dtype):
    _need_card()
    g = torch.Generator().manual_seed(70)
    payload = torch.randint(-2 ** 31, 2 ** 31 - 1, (N, K), generator=g,
                            dtype=torch.int32).view(dtype)
    d = dict(payload=payload,
             jn=torch.randint(0, N, (N, K), generator=g, dtype=torch.int32),
             rk=torch.randint(0, K, (N, K), generator=g, dtype=torch.int32))
    got, want = _both(mt.take_payload, d, ["payload", "jn", "rk"])
    assert got[0].dtype == dtype
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


@pytest.mark.parametrize("gather", ["pallas", "mxu"])
def test_churn_trajectory_cuda_equals_cpu(gather):
    """4 ticks of churn_50k at 512 peers with the validation cap cut to 4
    (throttle and RED drop live), hop_mode="xla": the card's state equals
    the CPU's (float32 within rtol 1e-6)."""
    _need_card()
    import dataclasses
    from go_libp2p_pubsub_tpu_torch.sim import run, scenarios, state_to_numpy
    from go_libp2p_pubsub_tpu_torch.sim import topology
    topo = topology.sparse(512, K, degree=12, seed=scenarios.SEED)
    outs = []
    for dev in ("cuda", "cpu"):
        cfg, tp, st = scenarios.churn_50k(512, device=dev, topo=topo)
        cfg = dataclasses.replace(cfg, hop_mode="xla", edge_gather_mode=gather,
                                  validation_queue_cap=4)
        outs.append(state_to_numpy(run(st, cfg, tp,
                                       rng.PRNGKey(0, device=dev), 4,
                                       device=dev)))
    for f, a in outs[0].items():
        b = outs[1][f]
        if a.dtype == np.float32:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_wide_window_trajectory_cuda_equals_cpu():
    """The headline network at 512 peers with a 288-message window (W = 9,
    beyond the fused kernels' 8 words) and int32 counts, under the
    builder's ``hop_mode="pallas"``: on the card it runs the non-fused
    path, launching no fused kernel, and after 4 ticks its state equals
    the CPU's."""
    _need_card()
    import dataclasses
    from go_libp2p_pubsub_tpu_torch.ops import cudalib
    from go_libp2p_pubsub_tpu_torch.sim import (build_headline, run,
                                                state_to_numpy, topology)
    topo = topology.sparse(512, K, degree=12)
    outs = []
    for dev in ("cuda", "cpu"):
        cfg, tp, st = build_headline(512, msg_window=288, device=dev,
                                     topo=topo)
        cfg = dataclasses.replace(cfg, count_dtype="int32")
        cudalib.reset_launches()
        outs.append(state_to_numpy(run(st, cfg, tp, rng.PRNGKey(0, device=dev),
                                       4, device=dev)))
        if dev == "cuda":
            launched = {k for k, v in cudalib.LAUNCHES.items() if v}
            assert launched == {"edge_table", "gather_words"}, launched
    assert outs[0]["delivered_total"] > 0 and outs[0]["fault_flags"] == 0
    for f, a in outs[0].items():
        b = outs[1][f]
        if a.dtype == np.float32:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


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


# the data plane's branches at 512 peers: both routers without a heartbeat,
# flood publish, queue caps with provenance, and a plan of every fault
# family (the victim publishes often as one of the storm's hot peers)
_EVERY_FAMILY = ("drop=0.1,dup=0.2,corrupt=0.3,partition=2@1:4,"
                 "outage=0.2@2:5,eclipse=0.1@3:6,censor=0.4x1@1:7,"
                 "storm=4x0.9x0@2:5,slowlink=0.3@3:0.1,wave=0.25@4:2:8,seed=3")


def _dataplane_case(case, dev, topo):
    import dataclasses
    from go_libp2p_pubsub_tpu_torch.sim import build_headline, scenarios
    from go_libp2p_pubsub_tpu_torch.sim.faults import FaultPlan
    if case in ("floodsub", "randomsub"):
        return scenarios.router_sweep_100k(case, 512, device=dev, topo=topo)
    if case == "every fault family":
        cfg, tp, st = scenarios.partition_small(512, k_slots=K, degree=12,
                                                device=dev, topo=topo)
        mal = torch.zeros(512, dtype=torch.bool, device=dev)
        mal[::25] = True
        return (dataclasses.replace(
            cfg, fault_plan=FaultPlan.parse(_EVERY_FAMILY)), tp,
            st._replace(malicious=mal))
    cfg, tp, st = build_headline(512, device=dev, topo=topo)
    over = (dict(flood_publish=True) if case == "flood publish" else
            dict(edge_queue_cap=2, record_provenance=True, prop_substeps=2,
                 gater_enabled=True, validation_queue_cap=8))
    return dataclasses.replace(cfg, **over), tp, st


@pytest.mark.parametrize("case", ["floodsub", "randomsub", "flood publish",
                                  "edge caps, provenance",
                                  "every fault family"])
def test_dataplane_trajectory_cuda_equals_cpu(case):
    """8 ticks of each data-plane branch at 512 peers: the card's state
    equals the CPU's after every tick (float32 within rtol 1e-6), and the
    fault flags hold the plan's bits and no violation."""
    _need_card()
    from go_libp2p_pubsub_tpu_torch.sim import scenarios, state_to_numpy, step
    from go_libp2p_pubsub_tpu_torch.sim import topology
    from go_libp2p_pubsub_tpu_torch.sim.invariants import VIOLATION_MASK
    topo = topology.sparse(512, K, degree=12, seed=scenarios.SEED)
    runs = [_dataplane_case(case, dev, topo) for dev in ("cuda", "cpu")]
    keys = [rng.split(rng.PRNGKey(0, device=dev), 8) for dev in ("cuda", "cpu")]
    states = [r[2] for r in runs]
    for tick in range(8):
        states = [step(s, r[0], r[1], kk[tick], device=d) for s, r, kk, d
                  in zip(states, runs, keys, ("cuda", "cpu"))]
        a, b = (state_to_numpy(s) for s in states)
        for f, x in a.items():
            if x.dtype == np.float32:
                np.testing.assert_allclose(x, b[f], rtol=1e-6, atol=0,
                                           err_msg=f"{f}, tick {tick}")
            else:
                np.testing.assert_array_equal(x, b[f],
                                              err_msg=f"{f}, tick {tick}")
    flags = int(a["fault_flags"])
    assert a["delivered_total"] > 0 and not flags & VIOLATION_MASK
    assert (flags == 0x3FF) == (case == "every fault family")


def _baseline_case(case, dev, topo):
    """The BASELINE scenarios' card cases at 1024 peers: beacon_10k (T = 9,
    K = 48) with subscription churn at 0.02, and sybil_small (K = 16)."""
    import dataclasses
    from go_libp2p_pubsub_tpu_torch.sim import scenarios
    if case == "beacon, subscription churn":
        cfg, tp, st = scenarios.beacon_10k(1024, device=dev, topo=topo)
        return dataclasses.replace(cfg, sub_leave_prob=0.02,
                                   sub_join_prob=0.02), tp, st
    return scenarios.sybil_small(1024, device=dev, topo=topo)


@pytest.mark.parametrize("case", ["beacon, subscription churn",
                                  "sybil_small"])
def test_baseline_trajectory_cuda_equals_cpu(case):
    """8 ticks of each BASELINE card case at 1024 peers: the card's state
    equals the CPU's after every tick (float32 within rtol 1e-6), with no
    violation bit; the beacon network takes the fused kernels at K = 48."""
    _need_card()
    from go_libp2p_pubsub_tpu_torch.ops import cudalib
    from go_libp2p_pubsub_tpu_torch.sim import scenarios, state_to_numpy, step
    from go_libp2p_pubsub_tpu_torch.sim import topology
    from go_libp2p_pubsub_tpu_torch.sim.invariants import VIOLATION_MASK
    k, degree = (48, 16) if case.startswith("beacon") else (16, 6)
    topo = topology.sparse(1024, k, degree=degree, seed=scenarios.SEED)
    runs = [_baseline_case(case, dev, topo) for dev in ("cuda", "cpu")]
    keys = [rng.split(rng.PRNGKey(0, device=dev), 8) for dev in ("cuda", "cpu")]
    states = [r[2] for r in runs]
    cudalib.reset_launches()
    for tick in range(8):
        states = [step(s, r[0], r[1], kk[tick], device=d) for s, r, kk, d
                  in zip(states, runs, keys, ("cuda", "cpu"))]
        a, b = (state_to_numpy(s) for s in states)
        for f, x in a.items():
            if x.dtype == np.float32:
                np.testing.assert_allclose(x, b[f], rtol=1e-6, atol=0,
                                           err_msg=f"{f}, tick {tick}")
            else:
                np.testing.assert_array_equal(x, b[f],
                                              err_msg=f"{f}, tick {tick}")
    assert a["delivered_total"] > 0
    assert not int(a["fault_flags"]) & VIOLATION_MASK
    for name in ("edge_table", "hop", "iwant_resolve", "emit"):
        assert cudalib.LAUNCHES[name] > 0, name


def test_run_checked_cuda_raises_as_on_cpu():
    """run_checked under invariant_mode="raise" on the card: a clean run
    passes and equals the CPU's; a state poisoned as tests/test_faults.py
    poisons it (mesh_failure_penalty[0,0,0] = inf) raises with the same
    violation bits and tick as on the CPU."""
    _need_card()
    import dataclasses
    from go_libp2p_pubsub_tpu_torch.sim import (run_checked, scenarios,
                                                state_to_numpy, topology)
    from go_libp2p_pubsub_tpu_torch.sim.invariants import InvariantViolation
    topo = topology.sparse(512, K, degree=12, seed=scenarios.SEED)
    clean, raised = [], []
    for dev in ("cuda", "cpu"):
        cfg, tp, st = scenarios.single_topic_1k(512, device=dev, topo=topo)
        cfg = dataclasses.replace(cfg, invariant_mode="raise")
        clean.append(state_to_numpy(run_checked(
            st, cfg, tp, rng.PRNGKey(0, device=dev), 4, device=dev)))
        mfp = st.mesh_failure_penalty.clone()
        mfp[0, 0, 0] = float("inf")
        with pytest.raises(InvariantViolation,
                           match="^invariant violation: fault_flags=") as e:
            run_checked(st._replace(mesh_failure_penalty=mfp), cfg, tp,
                        rng.PRNGKey(0, device=dev), 4, device=dev)
        raised.append((e.value.flags, e.value.tick))
    assert raised[0] == raised[1] and raised[0][0] != 0, raised
    for f, a in clean[0].items():
        b = clean[1][f]
        if a.dtype == np.float32:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def _formulation_case(case, dev, topo):
    """The formulation card cases at 1024 peers: the frontier under its
    sort exchanges; the headline's non-fused path under scalar, rows and
    sort (with flood publish under sort); churn_50k under sort; the
    headline under the iter and sort selections."""
    import dataclasses
    from go_libp2p_pubsub_tpu_torch.sim import build_headline, scenarios
    if case == "frontier":
        return scenarios.frontier(1024, device=dev)
    if case == "churn, sort":
        cfg, tp, st = scenarios.churn_50k(n_peers=1024, device=dev,
                                          topo=topo)
        return dataclasses.replace(cfg, hop_mode="xla",
                                   edge_gather_mode="sort"), tp, st
    cfg, tp, st = build_headline(1024, device=dev, topo=topo)
    over = {"headline, scalar": dict(hop_mode="xla", edge_gather_mode="scalar"),
            "headline, rows": dict(hop_mode="xla", edge_gather_mode="rows"),
            "headline, sort, flood publish": dict(
                hop_mode="xla", edge_gather_mode="sort", flood_publish=True),
            "selection iter": dict(selection_mode="iter"),
            "selection sort": dict(selection_mode="sort")}[case]
    return dataclasses.replace(cfg, **over), tp, st


@pytest.mark.parametrize("case", ["frontier", "headline, scalar",
                                  "headline, rows",
                                  "headline, sort, flood publish",
                                  "churn, sort", "selection iter",
                                  "selection sort"])
def test_formulation_trajectory_cuda_equals_cpu(case):
    """8 ticks of each formulation case at 1024 peers: the card's state
    equals the CPU's after every tick (float32 within rtol 1e-6), with no
    violation bit; the sort paths launch no gather kernel."""
    _need_card()
    from go_libp2p_pubsub_tpu_torch.ops import cudalib
    from go_libp2p_pubsub_tpu_torch.sim import scenarios, state_to_numpy, step
    from go_libp2p_pubsub_tpu_torch.sim import topology
    from go_libp2p_pubsub_tpu_torch.sim.invariants import VIOLATION_MASK
    topo = topology.sparse(1024, K, degree=12, seed=scenarios.SEED)
    runs = [_formulation_case(case, dev, topo) for dev in ("cuda", "cpu")]
    keys = [rng.split(rng.PRNGKey(0, device=dev), 8) for dev in ("cuda", "cpu")]
    states = [r[2] for r in runs]
    cudalib.reset_launches()
    for tick in range(8):
        states = [step(s, r[0], r[1], kk[tick], device=d) for s, r, kk, d
                  in zip(states, runs, keys, ("cuda", "cpu"))]
        a, b = (state_to_numpy(s) for s in states)
        for f, x in a.items():
            if x.dtype == np.float32:
                np.testing.assert_allclose(x, b[f], rtol=1e-6, atol=0,
                                           err_msg=f"{f}, tick {tick}")
            else:
                np.testing.assert_array_equal(x, b[f],
                                              err_msg=f"{f}, tick {tick}")
    assert a["delivered_total"] > 0
    assert not int(a["fault_flags"]) & VIOLATION_MASK
    if "sort" in case and not case.startswith("selection"):
        for name in ("edge_table", "gather_words", "permutation_gather",
                     "take_words"):
            assert cudalib.LAUNCHES[name] == 0, name


@pytest.mark.parametrize("mode", ["scalar", "rows", "sort"])
def test_formulations_cuda_equal_cpu(mode):
    """Each gather formulation's output on the card equals the CPU's, on a
    real edge involution with empty slots: the payload permute, the words
    gather and the packed exchange (with an extra table under sort); and
    each selection formulation on keys with exact ties."""
    _need_card()
    from types import SimpleNamespace
    from go_libp2p_pubsub_tpu_torch.ops import heartbeat as hb
    from go_libp2p_pubsub_tpu_torch.ops import selection as sel
    from go_libp2p_pubsub_tpu_torch.sim import topology
    n, k, m = 4096, 32, 64
    topo = topology.sparse(n, k, degree=12, seed=1)
    g = torch.Generator().manual_seed(5)
    nbr_full = torch.from_numpy(topo.neighbors)
    rs = torch.from_numpy(topo.reverse_slot)
    inputs = dict(
        nbr_full=nbr_full, rs=rs, jn=nbr_full.clamp(0, n - 1),
        rk=rs.clamp(0, k - 1),
        payload=torch.randint(-2 ** 31, 2 ** 31 - 1, (n, k), generator=g,
                              dtype=torch.int32),
        x_w=torch.randint(-2 ** 31, 2 ** 31 - 1, (2, n), generator=g,
                          dtype=torch.int32),
        masks=torch.rand(n, 40, k, generator=g) < 0.4)

    def run(d):
        x = {name: t.to(d) for name, t in inputs.items()}
        key_n = pg.edge_sort_key(x["nbr_full"], x["rs"], k_major=False)
        key_k = pg.edge_sort_key(x["nbr_full"], x["rs"], k_major=True)
        state = SimpleNamespace(neighbors=x["nbr_full"], reverse_slot=x["rs"])
        extra = [x["x_w"]] if mode == "sort" else []
        masks, extras = hb.edge_gather_packed(
            [x["masks"][:, :20], x["masks"][:, 20:]], state, mode,
            extra_words=extra)
        return [pg.permutation_gather(x["payload"], x["jn"], x["rk"], mode,
                                      sort_key=key_n),
                pg.gather_words(x["x_w"], x["jn"], mode, m=m, sort_key=key_k),
                *masks, *extras]

    for got, want in zip(run("cuda"), run("cpu")):
        assert torch.equal(got.cpu(), want), mode
    sel_mode = {"scalar": "iter", "rows": "sort", "sort": "ranks"}[mode]
    mask = torch.rand(n, 2, k, generator=g) < 0.7
    noise = torch.randint(0, 4, (n, 2, k), generator=g).float() / 4
    count = torch.randint(0, k, (n, 2), generator=g)
    outs = [sel.select_random(mask.to(d), count.to(d), None,
                              max_count=k - 1, mode=sel_mode,
                              noise=noise.to(d)) for d in ("cuda", "cpu")]
    assert torch.equal(outs[0].cpu(), outs[1]), sel_mode


# --- the captured engine plane (parallel/compile_plan.py) ------------------

def _captured_case(case, dev, topo):
    import dataclasses
    from go_libp2p_pubsub_tpu_torch.sim import build_headline, scenarios
    if case == "headline":
        return build_headline(512, device=dev, topo=topo)
    cfg, tp, st = scenarios.churn_50k(512, device=dev, topo=topo)
    return (dataclasses.replace(cfg, hop_mode="xla",
                                edge_gather_mode=case.split(", ")[1]),
            tp, st)


@pytest.mark.parametrize("case", ["headline", "churn, pallas", "churn, mxu"])
def test_eager_tick_makes_no_sync(case):
    """One eager tick raises nothing under
    ``torch.cuda.set_sync_debug_mode("error")``: no host read, no
    synchronous host-to-device copy."""
    _need_card()
    from go_libp2p_pubsub_tpu_torch.sim import scenarios, step, topology
    topo = topology.sparse(512, K, degree=12, seed=scenarios.SEED)
    cfg, tp, st = _captured_case(case, "cuda", topo)
    key = rng.PRNGKey(0, device="cuda")
    st = step(st, cfg, tp, key, device="cuda")        # first use, warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = step(st, cfg, tp, key, device="cuda")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("schedule", ["chunk", "window"])
@pytest.mark.parametrize("case", ["headline", "churn, pallas", "churn, mxu"])
def test_captured_chunks_equal_eager(case, schedule, donate):
    """Two replayed chunks of 4 ticks, the second fed the first's result,
    equal the eager 8-tick ``run_keys``/``run_window`` from the same state
    and keys in every field, exactly (the same card and kernels): the
    replay draws fresh numbers for every tick, and a plain executable
    leaves the caller's state as it was."""
    _need_card()
    import dataclasses
    from go_libp2p_pubsub_tpu_torch.parallel import compile_plan
    from go_libp2p_pubsub_tpu_torch.sim import (run_keys, run_window,
                                                scenarios, state_to_numpy,
                                                topology)
    topo = topology.sparse(512, K, degree=12, seed=scenarios.SEED)
    cfg, tp, st = _captured_case(case, "cuda", topo)
    before = state_to_numpy(st)
    key = rng.PRNGKey(7, device="cuda")
    try:
        if schedule == "chunk":
            keys = rng.split(key, 8)
            want = run_keys(st, cfg, tp, keys, device="cuda")
            exe = compile_plan.engine_chunk(cfg, st, tp, keys[:4],
                                            donate=donate)
            got = exe(exe(st, tp, keys[:4]), tp, keys[4:])
        else:
            cfg = dataclasses.replace(cfg, key_schedule="fold_in")
            want = run_window(st, cfg, tp, key, 8, device="cuda")
            exe = compile_plan.engine_window(cfg, st, tp, key, 4,
                                             donate=donate)
            got = exe(exe(st, tp, key), tp, key)
        assert exe.graph is not None and exe.launches
        want, got = state_to_numpy(want), state_to_numpy(got)
        for f, a in want.items():
            np.testing.assert_array_equal(got[f], a, err_msg=f)
        for f, a in state_to_numpy(st).items():
            np.testing.assert_array_equal(a, before[f], err_msg=f)
    finally:
        compile_plan.clear_caches()
