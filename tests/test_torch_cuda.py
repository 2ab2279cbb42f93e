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
from go_libp2p_pubsub_tpu_torch.ops import cudalib
from go_libp2p_pubsub_tpu_torch.ops import hopkernel as hk
from go_libp2p_pubsub_tpu_torch.ops import mxutake as mt
from go_libp2p_pubsub_tpu_torch.ops import permgather as pg
from go_libp2p_pubsub_tpu_torch.ops import selection as sel
from go_libp2p_pubsub_tpu_torch.ops.bits import pack_bool
from go_libp2p_pubsub_tpu_torch.parallel import kernel_context as kc

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


# --- the heartbeat's selections (csrc/select_rows.cu) -----------------------

SELECT_K = [1, 5, 16, 31, 32, 33, 48, 64, 128, 1000]


def _select_inputs(seed, lead, k):
    """CUDA mask, count, noise, score and median values of ``lead + (k,)``:
    the first row all masked, the second none; counts from -3 to K + 3,
    the first rows' K, 3, -1, 0, K, K + 5; a row of tied noise; scores
    from 4 values (ties in every row); NaN and signed zeros in the
    values."""
    r = np.random.default_rng(seed)
    shape = tuple(lead) + (k,)
    mask = r.random(shape) < 0.6
    mask.reshape(-1, k)[0], mask.reshape(-1, k)[1] = True, False
    count = r.integers(-3, k + 4, size=lead).astype(np.int64)
    count.reshape(-1)[:6] = [k, 3, -1, 0, k, k + 5]
    noise = r.random(shape, dtype=np.float32)
    noise.reshape(-1, k)[2] = 0.5
    score = (r.integers(0, 4, size=shape) / 4 * 10 - 5).astype(np.float32)
    vals = score.copy()
    vals.reshape(-1, k)[0, :3] = [np.nan, -0.0, 0.0][:k]
    vals.reshape(-1, k)[3, ::2] = np.nan
    vals.reshape(-1, k)[4] = -0.0
    vals.reshape(-1, k)[5, ::3] = 0.0
    return {name: torch.from_numpy(x).cuda() for name, x in
            dict(mask=mask, count=count, noise=noise, score=score,
                 vals=vals).items()}


def _select_pairs(kind, d, key):
    """(label, kernel call, plain twin) of one kind on inputs ``d``."""
    m, c = d["mask"], d["count"]
    sb = d["score"][..., :1, :].expand(m.shape)      # the heartbeat's sb
    if kind == "random":
        return [("counts", lambda: sel.select_random(m, c, key),
                 lambda: sel.select_random_plain(m, c, key)),
                ("static 3", lambda: sel.select_random(m, 3, key),
                 lambda: sel.select_random_plain(m, 3, key))]
    if kind == "noise":
        nz = d["noise"]
        return [("counts", lambda: sel.select_random(m, c, None, noise=nz),
                 lambda: sel.select_random_plain(m, c, None, noise=nz))]
    if kind == "top":
        return [(f"{what}, {cn}", lambda s=s, cc=cc: sel.select_top(s, m, cc),
                 lambda s=s, cc=cc: sel.select_top_plain(s, m, cc))
                for what, s in (("score", d["score"]), ("broadcast", sb))
                for cn, cc in (("counts", c), ("static 2", 2))]
    return [(what, lambda v=v: sel.masked_median(v, m),
             lambda v=v: sel.masked_median_plain(v, m))
            for what, v in (("values", d["vals"]), ("broadcast", sb))]


def _check_select(kind, d, key, what):
    for label, kernel, plain in _select_pairs(kind, d, key):
        before = cudalib.LAUNCHES["select_rows"]
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        assert cudalib.LAUNCHES["select_rows"] == before + 1, (what, label)
        assert got.dtype == want.dtype and got.shape == want.shape
        if kind == "median":
            assert torch.equal(got.isnan(), want.isnan()), (what, label)
            ok = got.isnan() | (got == want)
            assert bool(ok.all()), (what, label)
        else:
            assert torch.equal(got, want), (what, label)


@pytest.mark.parametrize("k", SELECT_K)
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("kind", ["random", "noise", "top", "median"])
def test_select_rows_kernel_equals_plain(kind, t, k):
    """Each mode of the kernel equals its plain twin at every K regime of
    its slots per lane: counts below 0, at 0 and above K, all-masked and
    empty rows, tied keys, the score broadcast over the topic axis, and
    medians of NaN and signed zeros (values equal, NaN positions
    equal)."""
    _need_card()
    n = max(64, 8192 // k)
    d = _select_inputs(100 * k + t, (n, t), k)
    _check_select(kind, d, rng.PRNGKey(2 ** 31 + k, device="cuda"),
                  f"{kind} K={k} T={t}")


def test_select_rows_kernel_fleet_shape_and_peer_group_rows(monkeypatch):
    """A fleet's [B, N, T, K] in every mode, and a peer group's rows of the
    draw at ``row0`` > 0 (the counter base's high half nonzero in the
    second)."""
    _need_card()
    d = _select_inputs(9, (3, 256, 2), 40)
    key = rng.PRNGKey(77, device="cuda")
    for kind in ("random", "noise", "top", "median"):
        _check_select(kind, d, key, f"fleet {kind}")
    d = _select_inputs(10, (512, 2), 40)
    for row0 in (5, (1 << 32) // 80 + 1):
        monkeypatch.setattr(kc, "row0", lambda r=row0: r)
        _check_select("random", d, key, f"row0={row0}")


def test_captured_heartbeat_makes_ten_select_rows_launches_a_tick():
    """A captured headline chunk at 1024 peers (net_100k's shape: K = 32,
    one topic) records exactly 10 select_rows launches a tick (8 random,
    1 top, 1 median) and equals the eager run."""
    _need_card()
    from go_libp2p_pubsub_tpu_torch.parallel import compile_plan
    from go_libp2p_pubsub_tpu_torch.sim import (build_headline, run_keys,
                                                scenarios, state_to_numpy,
                                                topology)
    topo = topology.sparse(1024, K, degree=12, seed=scenarios.SEED)
    cfg, tp, st = build_headline(1024, device="cuda", topo=topo)
    keys = rng.split(rng.PRNGKey(3, device="cuda"), 4)
    try:
        exe = compile_plan.engine_chunk(cfg, st, tp, keys)
        got = state_to_numpy(exe(st, tp, keys))
        assert exe.launches.get("select_rows") == 10 * 4, exe.launches
        cudalib.reset_launches()
        want = state_to_numpy(run_keys(st, cfg, tp, keys, device="cuda"))
        assert cudalib.LAUNCHES["select_rows"] == 10 * 4
        for f, a in want.items():
            np.testing.assert_array_equal(got[f], a, err_msg=f)
    finally:
        compile_plan.clear_caches()


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
    path, launching no fused kernel (the heartbeat's selections launch
    select_rows), and after 4 ticks its state equals the CPU's."""
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
            assert launched == {"edge_table", "gather_words",
                                "select_rows"}, launched
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


@pytest.mark.parametrize("case", ["headline", "churn, pallas"])
def test_stage_timed_chunk_equals_plain_and_times_its_spans(case,
                                                           monkeypatch):
    """A chunk of 4 ticks at 8192 peers captured with ``stage_timing=True``
    replays bit-equal to the plain capture; the plain capture makes no
    event and the timed one two per span; every span's device time is
    positive; the tick's own spans (``engine.*``) sum to within 5% of the
    graph's replay time by CUDA events; the heartbeat's parts sum to no
    more than ``engine.heartbeat``."""
    _need_card()
    import dataclasses
    from go_libp2p_pubsub_tpu_torch import spans
    from go_libp2p_pubsub_tpu_torch.parallel import compile_plan
    from go_libp2p_pubsub_tpu_torch.sim import (build_headline, scenarios,
                                                state_to_numpy, topology)
    n = 8192
    topo = topology.sparse_fast(n, K, degree=12, seed=scenarios.SEED)
    if case == "headline":
        cfg, tp, st = build_headline(n, device="cuda", topo=topo)
    else:
        cfg, tp, st = scenarios.churn_50k(n, device="cuda", topo=topo)
        cfg = dataclasses.replace(cfg, hop_mode="xla",
                                  edge_gather_mode="pallas")
    keys = rng.split(rng.PRNGKey(11, device="cuda"), 4)
    made = []
    base = torch.cuda.Event

    class Counted(base):
        def __new__(cls, *a, **k):
            made.append(k.get("external", False))
            return super().__new__(cls, *a, **k)

    try:
        monkeypatch.setattr(torch.cuda, "Event", Counted)
        plain = compile_plan.engine_chunk(cfg, st, tp, keys, telemetry=True)
        assert made == []
        timed = compile_plan.engine_chunk(cfg, st, tp, keys, telemetry=True,
                                          stage_timing=True)
        monkeypatch.setattr(torch.cuda, "Event", base)
        assert made and all(made)
        assert len(made) == 2 * len(timed._timer.marks)
        want, want_rec = plain(st, tp, keys)
        got, got_rec = timed(st, tp, keys)
        want, got = state_to_numpy(want), state_to_numpy(got)
        for f, a in want.items():
            np.testing.assert_array_equal(got[f], a, err_msg=f)
        for f, a, b in zip(want_rec._fields, want_rec, got_rec):
            assert torch.equal(a, b), f
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        timed.graph.replay()
        ev1.record()
        torch.cuda.synchronize()
        replay_ms = ev0.elapsed_time(ev1)
        ms = timed.stage_ms()
        assert all(v > 0 for v in ms.values()), ms
        ticks = sum(v for k, v in ms.items() if k.startswith("engine."))
        assert abs(ticks - replay_ms) <= 0.05 * replay_ms, (ms, replay_ms)
        parts = sum(v for k, v in ms.items() if k.startswith("heartbeat."))
        assert 0 < parts <= ms["engine.heartbeat"], ms
        assert {"engine.publish", "engine.heartbeat", "engine.forward",
                "engine.flags", "engine.telemetry", "heartbeat.score",
                "heartbeat.select", "heartbeat.exchange"} <= set(ms)
        assert ("engine.churn" in ms) == (case != "headline")
        assert ("engine.gater" in ms) == cfg.gater_enabled
        assert set(ms) <= set(spans.NAMES)
    finally:
        compile_plan.clear_caches()


# --- the supervised and fleet planes (sim/supervisor.py, sim/fleet.py) -----

@pytest.mark.parametrize("b", [1, 3])
def test_captured_fleet_window_equals_members_eager_runs(b):
    """A captured ``fleet_chunk`` window of B members x 4 ticks, replayed
    twice (the second fed the first's result), equals each member's eager
    8-tick ``run_keys`` on its own key rows; one graph of one member's
    ticks serves every B (a window of B - 1 members reuses it), and it
    records one member's kernel launches."""
    _need_card()
    from go_libp2p_pubsub_tpu_torch.parallel import compile_plan
    from go_libp2p_pubsub_tpu_torch.sim import (run_keys, scenarios,
                                                state_to_numpy, topology)
    from go_libp2p_pubsub_tpu_torch.sim.fleet import (member_state,
                                                      stack_states)
    topo = topology.sparse(512, K, degree=12, seed=scenarios.SEED)
    cfg, tp, st = scenarios.single_topic_1k(512, device="cuda", topo=topo)
    keys = torch.stack([rng.split(rng.PRNGKey(i, device="cuda"), 8)
                        for i in range(b)], dim=1)
    states, tps = stack_states([st] * b), stack_states([tp] * b)
    try:
        exe, _ = compile_plan.fleet_chunk(cfg, states, tps, keys[:4])
        got = exe(exe(states, tps, keys[:4]), tps, keys[4:])
        graph = exe.member_exe
        one = compile_plan.engine_chunk(cfg, st, tp, keys[:4, 0])
        assert graph is not None and exe.launches == one.launches
        for i in range(b):
            want = state_to_numpy(run_keys(st, cfg, tp, keys[:, i],
                                           device="cuda"))
            have = state_to_numpy(member_state(got, i))
            for f, a in want.items():
                np.testing.assert_array_equal(have[f], a, err_msg=f"{i} {f}")
        if b > 1:
            fewer, first = compile_plan.fleet_chunk(
                cfg, stack_states([st] * (b - 1)),
                stack_states([tp] * (b - 1)), keys[:4, 1:])
            assert fewer is exe and not first
            last = fewer(stack_states([st] * (b - 1)),
                         stack_states([tp] * (b - 1)), keys[:4, 1:])
            assert exe.member_exe is graph
            want = state_to_numpy(run_keys(st, cfg, tp, keys[:4, b - 1],
                                           device="cuda"))
            have = state_to_numpy(member_state(last, b - 2))
            for f, a in want.items():
                np.testing.assert_array_equal(have[f], a, err_msg=f)
    finally:
        compile_plan.clear_caches()


def test_supervised_run_on_the_card_equals_run(tmp_path):
    """A supervised run with checkpoints and the health journal, through
    captured chunks (a donated one among them), equals ``run``, with no
    retry and no degrade, and its chunks launched the path's kernels."""
    _need_card()
    from go_libp2p_pubsub_tpu_torch.ops import cudalib
    from go_libp2p_pubsub_tpu_torch.parallel import compile_plan
    from go_libp2p_pubsub_tpu_torch.sim import (build_headline, run,
                                                scenarios, state_to_numpy,
                                                topology)
    from go_libp2p_pubsub_tpu_torch.sim.supervisor import (SupervisorConfig,
                                                           supervised_run)
    topo = topology.sparse(512, K, degree=12, seed=scenarios.SEED)
    cfg, tp, st = build_headline(512, device="cuda", topo=topo)
    key = rng.PRNGKey(3, device="cuda")
    want = state_to_numpy(run(st, cfg, tp, key, 10, device="cuda"))
    # a checkpoint every 8 ticks: chunk [4, 8) runs the donated graph
    sup = SupervisorConfig(chunk_ticks=4, checkpoint_every_ticks=8,
                           checkpoint_dir=str(tmp_path / "ck"),
                           health_path=str(tmp_path / "h.ndjson"))
    compile_plan.clear_caches()
    cudalib.reset_launches()
    try:
        got, rep = supervised_run(st, cfg, tp, key, 10, sup, device="cuda")
    finally:
        compile_plan.clear_caches()
    assert rep.retries == 0 and rep.degrade_level == 0
    assert rep.chunks_run == 3 and len(rep.checkpoints) == 2
    for k in ("edge_table", "hop", "iwant_resolve", "emit"):
        assert cudalib.LAUNCHES[k] > 0, k
    have = state_to_numpy(got)
    for f, a in want.items():
        np.testing.assert_array_equal(have[f], a, err_msg=f)


def test_supervised_retry_on_the_card_keeps_the_kernels():
    """A transient failure on the card halves the chunk and never steps to
    the conservative formulations: the retried run still launches
    kernels 1-4 and equals ``run``."""
    _need_card()
    from go_libp2p_pubsub_tpu_torch.parallel import compile_plan
    from go_libp2p_pubsub_tpu_torch.sim import (build_headline, run,
                                                scenarios, state_to_numpy,
                                                topology)
    from go_libp2p_pubsub_tpu_torch.sim.supervisor import (SupervisorConfig,
                                                           supervised_run)
    topo = topology.sparse(512, K, degree=12, seed=scenarios.SEED)
    cfg, tp, st = build_headline(512, device="cuda", topo=topo)
    key = rng.PRNGKey(4, device="cuda")
    want = state_to_numpy(run(st, cfg, tp, key, 8, device="cuda"))
    fails = iter([True])

    def flaky(info):
        if next(fails, False):
            raise RuntimeError("transient")

    compile_plan.clear_caches()
    try:
        got, rep = supervised_run(
            st, cfg, tp, key, 8, SupervisorConfig(
                chunk_ticks=4, backoff_base_s=0.0, sleep=lambda s: None),
            device="cuda", _chunk_hook=flaky)
        # the retried chunks' executable: the caller's config, C = 2
        retried = [exe for k, exe in compile_plan._ENGINE_PLANS.items()
                   if k[2] == 2]
    finally:
        compile_plan.clear_caches()
    assert rep.retries == 1 and rep.degrade_level == 1
    assert [e for e in rep.events if e["event"] == "degrade"] == \
        [{"event": "degrade", "chunk_ticks": 2}]
    assert retried and all(exe.cfg == cfg for exe in retried)
    for k in ("edge_table", "hop", "iwant_resolve", "emit"):
        assert all(exe.launches.get(k, 0) > 0 for exe in retried), k
    have = state_to_numpy(got)
    for f, a in want.items():
        np.testing.assert_array_equal(have[f], a, err_msg=f)


# --- the command plane and the trace loop (sim/commands.py, trace/) --------

def _attack_state(dev):
    """single_topic_1k at 512 peers with eight sybils, after three ticks
    (on the CPU, then moved), and the frame of a storm, an eclipse and a
    censor directive."""
    from go_libp2p_pubsub_tpu_torch.sim import (run, scenarios,
                                                state_from_reference,
                                                state_to_numpy, topology)
    from go_libp2p_pubsub_tpu_torch.sim import commands
    topo = topology.sparse(512, K, degree=12, seed=scenarios.SEED)
    cfg, tp, st = scenarios.single_topic_1k(512, device="cpu", topo=topo)
    mal = torch.zeros(512, dtype=torch.bool)
    mal[400:408] = True
    st = run(st._replace(malicious=mal), cfg, tp,
             rng.PRNGKey(1, device="cpu"), 3, device="cpu")
    st = state_from_reference(state_to_numpy(st), device=dev)
    tp = type(tp)(*(x.to(dev) for x in tp))
    slots = 16
    op = np.zeros(slots, np.int32)
    a, b, c = (np.zeros(slots, np.int32) for _ in range(3))
    lanes = [(commands.OP_PUBLISH, 5, 3), (commands.OP_PUBLISH, 6, 4),
             (commands.OP_JOIN, 9, -1), (commands.OP_ECLIPSE, 0, -1),
             (commands.OP_ECLIPSE, 1, -1), (commands.OP_ECLIPSE, 2, -1),
             (commands.OP_CENSOR, 50, -1), (commands.OP_CENSOR, 51, -1)]
    for i, (o, p, s) in enumerate(lanes):
        op[i], a[i], b[i] = o, p, s
    frame = commands.empty_frame(slots)._replace(op=op, a=a, b=b, c=c,
                                                 count=len(lanes))
    return cfg, tp, st, frame


def test_apply_frame_with_attack_lanes_cuda_equals_cpu():
    """A frame with publish, join, eclipse and censor lanes applied on the
    card equals the CPU's in every field, makes no synchronization (sync
    debug "error"), and leaves the input state as it was."""
    _need_card()
    from go_libp2p_pubsub_tpu_torch.sim import commands, state_to_numpy
    cfg, tp, st, frame = _attack_state("cuda")
    ccfg, ctp, cst, _ = _attack_state("cpu")
    before = state_to_numpy(st)
    commands.apply_frame(st, cfg, tp, frame)        # first use, warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = commands.apply_frame(st, cfg, tp, frame)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = state_to_numpy(commands.apply_frame(cst, ccfg, ctp, frame))
    have = state_to_numpy(got)
    for f, x in want.items():
        np.testing.assert_array_equal(have[f], x, err_msg=f)
    for f, x in state_to_numpy(st).items():
        np.testing.assert_array_equal(x, before[f], err_msg=f)
    assert int(have["fault_flags"]) & (1 << 7) and \
        int(have["fault_flags"]) & (1 << 8)


def _traced_case(dev, ticks=3):
    import dataclasses
    from go_libp2p_pubsub_tpu_torch.sim import scenarios, topology
    from go_libp2p_pubsub_tpu_torch.sim.trace_export import run_traced
    topo = topology.sparse(256, 16, degree=6, seed=scenarios.SEED)
    cfg, tp, st = scenarios.single_topic_1k(256, 16, 6, device=dev,
                                            topo=topo)
    cfg = dataclasses.replace(cfg, record_provenance=True)
    rows = []
    out, events = run_traced(st, cfg, tp, None, 0, health_out=rows,
                             keys=rng.split(rng.PRNGKey(5, device=dev),
                                            ticks), device=dev)
    return cfg, tp, out, events, rows, topo


def test_run_traced_events_cuda_equal_cpu():
    """``run_traced`` on the card: the same events, list for list, the same
    final state and the same health rows (float32 columns to rtol 1e-6,
    ``score_mean`` to 1e-5) as on the CPU."""
    _need_card()
    from go_libp2p_pubsub_tpu_torch.sim import state_to_numpy
    _, _, out, events, rows, _ = _traced_case("cuda")
    _, _, cout, cevents, crows, _ = _traced_case("cpu")
    assert events == cevents and len(events) > 256
    have, want = state_to_numpy(out), state_to_numpy(cout)
    for f, x in want.items():
        np.testing.assert_array_equal(have[f], x, err_msg=f)
    for r, w in zip(rows, crows):
        for k in w:
            if isinstance(w[k], float):
                np.testing.assert_allclose(
                    r[k], w[k], rtol=1e-5 if k == "score_mean" else 1e-6)
            else:
                assert r[k] == w[k], k


def test_replay_feed_cuda_makes_no_sync_and_equals_cpu():
    """The exported events of a traced CPU run, tensorized and replayed
    into a fresh state on the card under sync debug "error" (no op reads
    the device), equal the CPU's replay in every field."""
    _need_card()
    import importlib
    from go_libp2p_pubsub_tpu_torch.sim import (init_state, state_to_numpy)
    rp = importlib.import_module("go_libp2p_pubsub_tpu_torch.trace.replay")
    cfg, tp, _, events, _, topo = _traced_case("cpu")
    pre = [{"type": "JOIN", "peerID": f"p{i}", "timestamp": 0.1,
            "join": {"topic": "t0"}} for i in range(256)]
    feed = rp.tensorize_trace(pre + events, {f"p{i}": i for i in range(256)},
                              {"t0": 0}, msg_window=cfg.msg_window,
                              t_end=3.0)
    fresh = np.zeros((256, 1), bool)
    want = state_to_numpy(rp.replay_feed(
        init_state(cfg, topo, subscribed=fresh, device="cpu"), cfg, tp,
        feed))
    st = init_state(cfg, topo, subscribed=fresh, device="cuda")
    gtp = type(tp)(*(x.cuda() for x in tp))
    rp.replay_feed(st, cfg, gtp, feed._replace(
        op=feed.op[:64], a=feed.a[:64], b=feed.b[:64], c=feed.c[:64]))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = rp.replay_feed(st, cfg, gtp, feed)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    have = state_to_numpy(got)
    for f, x in want.items():
        np.testing.assert_array_equal(have[f], x, err_msg=f)


def test_supervised_commands_on_the_card_leave_frames_intact(tmp_path):
    """A supervised run on the card fed a directive stream (publishes, a
    join, eclipse and censor attacks, a malformed line) equals the
    unsupervised loop that applies the same frames at the same boundaries
    and steps with ``run_keys``; no donated executable is built while the
    command plane is attached; and a frame applied to a donated chunk's
    result (its graph's static state) leaves those buffers as they
    were."""
    _need_card()
    from go_libp2p_pubsub_tpu_torch.parallel import compile_plan
    from go_libp2p_pubsub_tpu_torch.sim import (commands, run_keys,
                                                state_to_numpy)
    from go_libp2p_pubsub_tpu_torch.sim.supervisor import (SupervisorConfig,
                                                           supervised_run)
    cfg, tp, st, frame = _attack_state("cuda")
    src = str(tmp_path / "s.ndjson")
    directives = [
        {"op": "publish", "tick": 1, "peer": 3, "topic": 0},
        {"op": "join", "tick": 2, "peer": 7, "topic": 0},
        {"op": "attack", "tick": 5, "kind": "eclipse", "peers": [0, 1, 2]},
        {"op": "attack", "tick": 6, "kind": "censor", "peers": [20, 21]},
        {"op": "frobnicate", "tick": 6},
    ]
    commands.write_stream(src, directives)
    key = rng.PRNGKey(8, device="cuda")

    def queue():
        return commands.CommandQueue(src, n_peers=512, n_topics=1,
                                     msg_window=cfg.msg_window, slots=8,
                                     stall_timeout_s=30.0)

    q = queue()
    compile_plan.clear_caches()
    try:
        got, rep = supervised_run(
            st, cfg, tp, key, 12, SupervisorConfig(
                chunk_ticks=4, checkpoint_every_ticks=12, commands=q),
            device="cuda")
        donated = [k for k, e in compile_plan._ENGINE_PLANS.items()
                   if e.donate]
    finally:
        q.close()
        compile_plan.clear_caches()
    assert rep.retries == 0 and not donated
    # the unsupervised loop: the same frames at the same boundaries
    q = queue().start(0)
    keys = rng.split(key, 12)
    want = st
    t0 = int(st.tick)                   # the state after three ticks
    try:
        for start in (0, 4, 8):
            f = q.frame_for(t0 + start, 4)
            if f.count:
                want = commands.apply_frame(want, cfg, tp, f)
            want = run_keys(want, cfg, tp, keys[start:start + 4],
                            device="cuda")
    finally:
        q.close()
    assert q.refused_total == 1
    have, want = state_to_numpy(got), state_to_numpy(want)
    for f, x in want.items():
        np.testing.assert_array_equal(have[f], x, err_msg=f)
    # a frame applied to a donated result writes none of its buffers
    try:
        exe = compile_plan.engine_chunk(cfg, st, tp, keys[:4], donate=True)
        out = exe(st, tp, keys[:4])
        before = [x.clone() for x in out]
        applied = commands.apply_frame(out, cfg, tp, frame)
        for f, x, y in zip(out._fields, out, before):
            assert torch.equal(x, y), f
        assert any(a is not b for a, b in zip(applied, out))
    finally:
        compile_plan.clear_caches()


# --- the degree-bucketed engine (sim/bucketed.py) ---------------------------

def _bucketed_case(dev, rng_mode="bucket", precision="f32"):
    """A 1024-peer power-law network on its degree buckets (d 4-16):
    scoring, the gater, connection churn, link drop and duplication and an
    eclipse of the hub bucket, on ``dev``, under the fold_in schedule (a
    one-tick ``bucketed_run`` per tick lands on the run's trajectory)."""
    from go_libp2p_pubsub_tpu_torch.sim import (SimConfig, bucketed,
                                                scenarios, topology)
    from go_libp2p_pubsub_tpu_torch.sim.faults import EclipseWindow, FaultPlan
    n = 1024
    buckets = topology.powerlaw_buckets(n, d_min=4, d_max=16)
    k = buckets[0][1]
    plan = FaultPlan(link_drop_prob=0.02, link_dup_prob=0.02,
                     eclipses=(EclipseWindow(2, 6,
                                             fraction=buckets[0][0] / n),),
                     seed=5)
    cfg = SimConfig(n_peers=n, k_slots=k, n_topics=2, msg_window=8,
                    publishers_per_tick=4, prop_substeps=4,
                    scoring_enabled=True, gater_enabled=True,
                    churn_disconnect_prob=0.05, churn_reconnect_prob=0.2,
                    fault_plan=plan, degree_buckets=buckets,
                    bucketed_rng=rng_mode, state_precision=precision,
                    key_schedule="fold_in")
    topo = topology.powerlaw(n, k, d_min=4, d_max=16, seed=11)
    bs = bucketed.init_bucketed_state(cfg, topo, device=dev,
                                      malicious=np.arange(n) >= 896)
    return cfg, scenarios.default_topic_params(2, device=dev), bs


def _same_leaves(got: dict, want: dict):
    for name, a in want.items():
        b = got[name]
        if a.dtype == np.float32:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("rng_mode", ["bucket", "dense"])
def test_bucketed_trajectory_cuda_equals_cpu(rng_mode):
    """6 ticks of the 1024-peer bucketed network: after every tick every
    array of ``g``, of every bucket and of ``rev`` on the card equals the
    CPU's (float32 within rtol 1e-6), and no hand kernel launches but the
    selections' select_rows."""
    _need_card()
    from go_libp2p_pubsub_tpu_torch.ops import cudalib
    from go_libp2p_pubsub_tpu_torch.sim import bucketed
    runs = {}
    for dev in ("cuda", "cpu"):
        cfg, tp, bs = _bucketed_case(dev, rng_mode)
        key = rng.PRNGKey(0, device=dev)
        cudalib.reset_launches()
        ticks = []
        for _ in range(6):
            bs = bucketed.bucketed_run(bs, cfg, tp, key, 1, device=dev)
            ticks.append(bucketed.bucketed_state_to_numpy(bs))
        runs[dev] = ticks
        if dev == "cuda":
            launched = {k for k, v in cudalib.LAUNCHES.items() if v}
            assert launched == {"select_rows"}, cudalib.LAUNCHES
    for got, want in zip(runs["cuda"], runs["cpu"]):
        _same_leaves(got, want)
    assert int(runs["cuda"][-1]["g.fault_flags"]) & 0x80


def test_bucketed_tick_makes_no_sync():
    """A compact bucketed tick on the card raises nothing under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    _need_card()
    from go_libp2p_pubsub_tpu_torch.sim import bucketed
    cfg, tp, bs = _bucketed_case("cuda", precision="compact")
    key = rng.PRNGKey(0, device="cuda")
    bs = bucketed.bucketed_step(bs, cfg, tp, key, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        bs = bucketed.bucketed_step(bs, cfg, tp, key, device="cuda")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_bucketed_checkpoint_from_the_cpu_steps_on_the_card(tmp_path):
    """A compact bucketed ``.npz`` saved after 2 CPU ticks restores onto a
    card state and steps there equal to the CPU's next tick."""
    _need_card()
    from go_libp2p_pubsub_tpu_torch.sim import bucketed, checkpoint
    cfg, tp, bs = _bucketed_case("cpu", precision="compact")
    key = rng.PRNGKey(3, device="cpu")
    bs = bucketed.bucketed_run(bs, cfg, tp, key, 2, device="cpu")
    path = str(tmp_path / "bucketed.npz")
    checkpoint.save(path, bs, cfg=cfg)
    want = bucketed.bucketed_run(bs, cfg, tp, key, 1, device="cpu")
    _, tp_c, like = _bucketed_case("cuda", precision="compact")
    back = checkpoint.restore(path, like, cfg=cfg)
    assert back.g.tick.device.type == "cuda"
    got = bucketed.bucketed_run(back, cfg, tp_c,
                                rng.PRNGKey(3, device="cuda"), 1,
                                device="cuda")
    _same_leaves(bucketed.bucketed_state_to_numpy(got),
                 bucketed.bucketed_state_to_numpy(want))
