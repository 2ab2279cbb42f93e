"""The edge-table kernel and the slot-parallel IWANT resolve
(csrc/edge_table.cu, csrc/iwant_resolve.cu) on the CPU: each wrapper runs
its kernel route with ``cudalib.launch`` replaced by an emulation of the
kernel's algorithm and addressing, and is compared with the JAX package's
Pallas kernel in interpret mode, exactly.

The edge-table emulation reads each edge's row of the padded table (WB
rounded up to a multiple of 4 words from 3 on) at ``x[j * PW + i]`` and
takes the bits as the kernel does: from row word b at K = 32, from a word
selected in registers at other K, and 4 words at a time for rows wider
than 8 words.

The resolve emulation follows the warp per receiver: the pend row read a
word at a time, lane b holding message 32 i + b; the ballot that skips a
receiver with nothing pending; each alive message's lane ORing its bit
into its slot's word of a per-warp [W][32] shared array (atomicOr),
chunk by chunk, read and cleared by the slot's lane; answer rows (n-major,
``x[j * W + i]``) loaded only for lanes whose ask set is not empty; the
OR over lanes in five xor shuffles; the counts put in a zeroed
[(2T+1) * K][pitch] byte tile per block (pitch BR, plus a word where
BR >= 8) and written out row by row. The outputs start as garbage, so
every byte the kernel must write is checked. The kernels themselves are
held to the plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.ops.hopkernel import iwant_resolve_pallas
from go_libp2p_pubsub_tpu.ops.permgather import _edge_table_pallas
from go_libp2p_pubsub_tpu_torch.ops import cudalib
from go_libp2p_pubsub_tpu_torch.ops import hopkernel as hk
from go_libp2p_pubsub_tpu_torch.ops import permgather as pg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs (the
    suite runs in several worker processes; see
    tests/test_torch_engine_modes.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


I32, I64 = torch.int32, torch.int64
LANE = torch.arange(32)
GARBAGE = 0x5A                        # fill of memory the kernel must write
RESOLVE_ARGS = ["pend", "answers", "have", "vm", "inv_n", "alive", "data_ok",
                "tb", "nbr"]


# --- inputs ---------------------------------------------------------------

def _words(rng, *shape, density=0.5):
    bits = rng.random(shape + (32,)) < density
    w = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    w = w.astype(np.uint32)
    w.flat[0] |= np.uint32(0x80000000)                     # bit 31 set
    return w


def _topic_bits(rng, t, w):
    topic = rng.integers(-1, t, size=w * 32)
    bits = topic[None, :] == np.arange(t)[:, None]
    return (bits.reshape(t, w, 32).astype(np.uint64)
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
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _u(x):
    """int32 words as their uint32 values, in int64."""
    return x.to(I64) & 0xFFFFFFFF


def _popc(x):
    """popcount of uint32 values held in int64."""
    return sum(((x >> b) & 1) for b in range(32))


# --- csrc/edge_table.cu ---------------------------------------------------

def _emulated_edge_table(table, jn, rk, out, n, k, pw, b_planes):
    # the launcher's refusals
    assert pw in (1, 2) or (pw > 2 and pw % 4 == 0)
    assert 1 <= b_planes and b_planes * k <= 32 * pw
    assert table.shape[1] == pw and table.is_contiguous()
    assert table.data_ptr() % (4 * min(pw, 4)) == 0
    flat = table.reshape(-1)
    j = jn.reshape(-1).to(I64)
    r = rk.reshape(-1).to(I64)
    groups = (b_planes + 31) // 32
    acc = torch.zeros((groups, j.numel()), dtype=I64)
    if pw <= 8:
        # the whole row in registers, as one or two vectors
        row = _u(flat[j[:, None] * pw + torch.arange(pw)])   # [E, PW]
        if k == 32:
            for b in range(min(pw, b_planes)):             # word b, bit r
                acc[0] |= ((row[:, b] >> r) & 1) << b
        else:
            for b in range(b_planes):                      # pick in registers
                pos = b * k + r
                word = row.gather(1, (pos >> 5)[:, None])[:, 0]
                acc[b // 32] |= ((word >> (pos & 31)) & 1) << (b % 32)
    else:
        # 4 words at a time, in plane order: a quad is read when the bit's
        # quad differs from the one held
        cur = torch.full_like(j, -1)
        quad = torch.zeros((j.numel(), 4), dtype=I64)
        for b in range(b_planes):
            pos = b * k + r
            new = (pos >> 7) != cur
            if new.any():
                words = (pos[new] >> 7)[:, None] * 4 + torch.arange(4)
                quad[new] = _u(flat[j[new][:, None] * pw + words])
                cur = torch.where(new, pos >> 7, cur)
            word = quad.gather(1, ((pos >> 5) & 3)[:, None])[:, 0]
            acc[b // 32] |= ((word >> (pos & 31)) & 1) << (b % 32)
    out.copy_(_as_i32(acc).view(groups, n, k))


def _as_i32(x):
    """uint32 values held in int64 -> the int32 words with those bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(I32)


# --- csrc/iwant_resolve.cu ------------------------------------------------

TILE_MAX = 32 * 1024                  # csrc/iwant_resolve.cu TILE_MAX


def _tile_pitch(br):
    """tile_pitch: a tile row's bytes, BR plus a word from BR = 8 up."""
    return br + 4 if br >= 8 else br


def _block_rows(t, k):
    """block_rows: the largest power of two <= 64 receivers whose
    [(2T+1) * K][pitch] tile fits TILE_MAX; 0 where one receiver's does
    not."""
    br = 64
    while br and (2 * t + 1) * k * _tile_pitch(br) > TILE_MAX:
        br //= 2
    return br


def _emulated_resolve(pend, answers, have, vm, inv_n, alive, data_ok, tb,
                      nbr, got_any, got_valid_any, nv, ni, broken, n, k, t, w,
                      m, lookups):
    # the launcher's refusals (cudaErrorInvalidValue, raised by launch)
    br = _block_rows(t, k)
    if not (1 <= w <= 8 and m <= 32 * w and br):
        raise RuntimeError("CUDA kernel iwant_resolve failed to launch: "
                           "cudaError 1")
    pitch = _tile_pitch(br)                                 # tile row bytes
    assert answers.shape[1] == w and answers.is_contiguous()  # n-major rows
    for x in (got_any, got_valid_any, nv, ni, broken):      # torch.empty
        x.view(torch.uint8).fill_(GARBAGE)
    al = _u(alive[:, 0])                                    # [W]
    # the pend row: lane b holds message 32 i + b of word i
    mm = 32 * torch.arange(w)[:, None] + LANE               # [W, 32]
    v = torch.full((n, w, 32), -1, dtype=I64)
    v[:, mm < m] = pend[:, mm[mm < m]].to(I64)
    inr = (v >= 0) & (v < k)
    ballot = (inr.to(I64) << LANE).sum(-1)                  # [N, W]
    live = ((ballot & al).sum(1) != 0)                      # [N]
    hv, vmv, inv = _u(have.T), _u(vm.T), _u(inv_n.T)       # [N, W]
    tbu = _u(tb)                                            # [T, W]
    nq = (2 * t + 1) * k
    nblk = -(-n // br)
    tile = torch.zeros((nblk, nq * pitch), dtype=I64)       # zeroed tiles
    ga = torch.zeros((n, w, 32), dtype=I64)
    gva = torch.zeros((n, w, 32), dtype=I64)
    rows = torch.arange(n)
    blk, rl = rows // br, rows % br
    for c in range(-(-k // 32)):
        s = 32 * c + LANE
        # each alive message's lane ORs its bit into its slot's ask set
        # (a shared-memory atomicOr per lane)
        ask_sh = torch.zeros((n, w, 32), dtype=I64)
        d = v - 32 * c
        dep = live[:, None, None] & inr & (d >= 0) & (d < 32) \
            & (((al[None, :, None] >> LANE) & 1) != 0)
        for b in range(32):
            ni_, wi_ = dep[:, :, b].nonzero(as_tuple=True)
            ask_sh[ni_, wi_, d[ni_, wi_, b]] |= 1 << b
        ask = ask_sh                                          # lane l: slot l
        anyl = (ask != 0).any(1) & live[:, None]             # [N, 32]
        r_, l_ = anyl.nonzero(as_tuple=True)
        lookups.append(len(r_))
        if not len(r_):
            continue
        sl = s[l_]
        assert int(sl.max()) < k
        j = nbr[r_, sl].to(I64)
        adm = torch.where(data_ok[r_, sl] != 0, 0xFFFFFFFF, 0)
        ans = _u(answers.reshape(-1)[j[:, None] * w + torch.arange(w)])
        a = ask[r_, :, l_]                                   # [L, W]
        got = a & ans & (~hv[r_] & 0xFFFFFFFF) & adm[:, None]
        gv = got & vmv[r_]
        ga[r_, :, l_] |= got
        gva[r_, :, l_] |= gv
        bk = _popc(a & (~ans & 0xFFFFFFFF)).sum(1)
        base = rl[r_]
        tile[blk[r_], (2 * t * k + sl) * pitch + base] = bk & 0xFF
        for tt in range(t):
            tw = tbu[tt][None, :]
            cnv = _popc(got & vmv[r_] & tw).sum(1)
            cni = _popc(got & inv[r_] & tw).sum(1)
            tile[blk[r_], (tt * k + sl) * pitch + base] = cnv & 0xFF
            tile[blk[r_], ((t + tt) * k + sl) * pitch + base] = cni & 0xFF
    # the OR over lanes, five xor shuffles
    for dlt in (16, 8, 4, 2, 1):
        ga = ga | ga[..., LANE ^ dlt]
        gva = gva | gva[..., LANE ^ dlt]
    # each tile row out as a run of the block's receivers
    for q in range(nq):
        dst = nv[q // k, q % k] if q < t * k else (
            ni[(q - t * k) // k, q % k] if q < 2 * t * k
            else broken[q - 2 * t * k])
        dst.copy_(tile[blk, q * pitch + rl].to(torch.uint8))
    got_any.copy_(_as_i32(ga[..., 0]).T)
    got_valid_any.copy_(_as_i32(gva[..., 0]).T)


@pytest.fixture
def kernel_route(monkeypatch):
    """The wrappers' kernel route on CPU tensors, kernels emulated; the
    launches and the resolve's answer-row lookups (per chunk) counted."""
    calls, lookups = [], []

    def launch(name, *args):
        calls.append(name)
        if name == "edge_table":
            _emulated_edge_table(*args)
        elif name == "iwant_resolve":
            _emulated_resolve(*args, lookups)
        else:
            raise AssertionError(f"unexpected kernel {name}")

    monkeypatch.setattr(cudalib, "use_kernel", lambda name, *t: True)
    monkeypatch.setattr(cudalib, "check_args", lambda name, specs: None)
    monkeypatch.setattr(cudalib, "launch", launch)
    return calls, lookups


# --- edge_table tests -------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _edge_case(n, k, b_planes):
    rng = np.random.default_rng(n * 1000 + k * 10 + b_planes)
    wb = (b_planes * k + 31) // 32
    table = _words(rng, n, wb, density=0.3)
    jn = rng.integers(0, n, size=(n, k), dtype=np.int32)
    rk = rng.integers(0, k, size=(n, k), dtype=np.int32)
    jn[0, 0], jn[-1, -1] = 0, n - 1
    want = _edge_table_pallas(jnp.asarray(table), jnp.asarray(jn),
                              jnp.asarray(rk), b_planes=b_planes,
                              interpret=True)
    return table, jn, rk, [np.asarray(x) for x in want]


# B 1, 2, 6, 8 and 40 planes, K 8 / 32 / 40 (and 7: an odd edge count),
# ragged N; the padded widths (WB 6 -> 8, 10 -> 12, 3 -> 4) and rows wider
# than 8 words (12, 40, 52)
EDGE_CASES = [(200, 32, 1), (200, 32, 2), (257, 32, 8), (130, 8, 6),
              (301, 32, 6), (99, 40, 8), (150, 8, 40), (77, 32, 40),
              (513, 8, 2), (64, 40, 1), (120, 40, 40), (211, 8, 12),
              (101, 7, 3), (257, 32, 4)]


@pytest.mark.parametrize("n,k,b_planes", EDGE_CASES)
def test_edge_table_kernel_route_equals_pallas(n, k, b_planes, kernel_route):
    table, jn, rk, want = _edge_case(n, k, b_planes)
    got = pg.edge_table(_t(table), _t(jn), _t(rk), b_planes)
    assert kernel_route[0] == ["edge_table"]
    assert len(got) == len(want) == (b_planes + 31) // 32
    for a, b in zip(want, got):
        _same(a, b, "edge_table")
    assert any(np.asarray(a).any() for a in want)


def test_edge_table_row_words():
    """Rows of 1 and 2 words as they are, wider ones padded to a multiple
    of 4 words: the paths' tables (B = 2, 1 at the headline, 8, 4 on the
    churn cell, K = 32) are read unpadded."""
    assert [pg.edge_table_row_words(w)
            for w in (1, 2, 3, 4, 5, 6, 8, 9, 10, 40)] \
        == [1, 2, 4, 4, 8, 8, 8, 12, 12, 40]


def test_edge_table_kernel_route_pads_and_aligns(kernel_route):
    """A 6-word table reaches the kernel padded to 8 words; a table at an
    address that is no multiple of 16 bytes is copied first."""
    seen = []
    real = cudalib.launch

    def spy(name, *args):
        seen.append((tuple(args[0].shape), args[0].data_ptr() % 16))
        real(name, *args)

    table6, jn6, rk6, want6 = _edge_case(301, 32, 6)
    table2, jn2, rk2, want2 = _edge_case(200, 32, 2)
    base = torch.zeros(table2.size + 1, dtype=I32)
    shifted = base[1:].view(table2.shape)
    shifted.copy_(_t(table2))
    assert shifted.data_ptr() % 16
    cudalib.launch = spy
    try:
        got6 = pg.edge_table(_t(table6), _t(jn6), _t(rk6), 6)
        got2 = pg.edge_table(shifted, _t(jn2), _t(rk2), 2)
    finally:
        cudalib.launch = real
    assert seen == [((301, 8), 0), ((200, 2), 0)]
    _same(want6[0], got6[0], "edge_table padded")
    _same(want2[0], got2[0], "edge_table realigned")


# --- iwant_resolve tests -----------------------------------------------------

def _resolve_inputs(seed, n, n_src, k, t, w, m):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n_src, size=(n, k), dtype=np.int32)
    nbr[0, 0], nbr[-1, -1] = 0, n_src - 1
    return dict(
        nbr=nbr, tb=_topic_bits(rng, t, w),
        pend=rng.integers(-1, k, size=(n, m), dtype=np.int32),
        answers=_words(rng, w, n_src, density=0.5),
        have=_words(rng, w, n, density=0.3),
        vm=_words(rng, w, n, density=0.9),
        inv_n=_words(rng, w, n, density=0.05),
        alive=_words(rng, w, 1, density=0.9),
        data_ok=(rng.random((n, k)) < 0.9).astype(np.uint8))


def _check_resolve(d, m, kernel_route):
    want = iwant_resolve_pallas(*[jnp.asarray(d[a]) for a in RESOLVE_ARGS],
                                m=m, interpret=True)
    got = hk.iwant_resolve(*[_t(d[a]) for a in RESOLVE_ARGS], m)
    assert kernel_route[0] == ["iwant_resolve"]
    for f, a, b in zip(want._fields, want, got):
        _same(a, b, f"iwant_resolve.{f}")
    return want


# K 8 / 32 / 40 / 130 (one, two and five chunks of 32 slots), T 1-3, W 1-8,
# M below and at 32 W, N no multiple of the block, senders wider than N
RESOLVE_CASES = [(200, 200, 8, 1, 1, 32), (256, 256, 32, 1, 2, 64),
                 (130, 150, 40, 3, 3, 96), (257, 257, 130, 1, 2, 64),
                 (150, 170, 130, 3, 2, 50), (100, 100, 32, 2, 8, 256),
                 (99, 99, 8, 3, 4, 100), (301, 301, 40, 1, 5, 150)]


@pytest.mark.parametrize("n,n_src,k,t,w,m", RESOLVE_CASES)
def test_iwant_resolve_kernel_route_equals_pallas(n, n_src, k, t, w, m,
                                                  kernel_route):
    d = _resolve_inputs(4000 + k * 10 + t * 3 + w, n, n_src, k, t, w, m)
    want = _check_resolve(d, m, kernel_route)
    # non-vacuous: pulls and broken promises counted, also past slot 31
    bk = np.asarray(want.broken)
    assert np.asarray(want.got_any).any() and bk.any()
    assert k <= 32 or bk[32:].any()
    # a lookup per (receiver, slot) with a non-empty ask set, no more
    asked = np.zeros((n, k), dtype=bool)
    al = np.unpackbits(d["alive"][:, 0].view(np.uint8), bitorder="little")
    for r in range(n):
        for mm in range(m):
            s = d["pend"][r, mm]
            if 0 <= s < k and al[mm]:
                asked[r, s] = True
    assert sum(kernel_route[1]) == int(asked.sum())


def test_iwant_resolve_kernel_route_empty_pend(kernel_route):
    """Nothing pending (the headline's real ticks): no lookup at all, every
    count zero and both tables empty, all written over the garbage."""
    d = _resolve_inputs(4100, 300, 300, 32, 1, 2, 64)
    d["pend"][:] = -1
    d["pend"][::7, 5] = 40                   # out of range: not a slot
    want = _check_resolve(d, 64, kernel_route)
    assert sum(kernel_route[1]) == 0
    assert not any(np.asarray(x).any() for x in want)


def test_iwant_resolve_kernel_route_counts_wrap(kernel_route):
    """M = 256 (W = 8): 256 messages asked from one slot wrap the uint8
    counts to 0, 255 of them stay 255."""
    n, k, m, w = 64, 32, 256, 8
    d = _resolve_inputs(4200, n, n, k, 1, w, m)
    r = np.arange(16)
    d["pend"][r] = 3
    d["pend"][r[8:], 0] = -1                 # 255 messages asked
    d["nbr"][r, 3] = r
    d["answers"][:, r] = np.where(r % 2 == 0, 0, 0xFFFFFFFF)
    d["have"][:, r] = 0
    d["vm"][:, r] = 0xFFFFFFFF
    d["alive"][:] = 0xFFFFFFFF
    d["data_ok"][r, 3] = 1
    d["tb"][:] = 0xFFFFFFFF                  # one topic holds every message
    want = _check_resolve(d, m, kernel_route)
    bk = np.asarray(want.broken)[3, r]
    nv = np.asarray(want.nv)[0, 3, r]
    assert list(bk[:8:2]) == [0] * 4 and list(nv[1:8:2]) == [0] * 4
    assert list(bk[8::2]) == [255] * 4 and list(nv[9::2]) == [255] * 4


def test_iwant_resolve_refuses_only_what_it_must(kernel_route):
    """W > 8, M > 32 W and a tile of counts too large for one receiver
    ((2T+1) K > 32768, the launcher's own refusal too) are refused before
    any launch; K = 130 (beyond the earlier kernel's 128) and the widest W
    go through."""
    d = _resolve_inputs(4300, 40, 40, 8, 1, 9, 64)
    with pytest.raises(ValueError):
        hk.iwant_resolve(*[_t(d[a]) for a in RESOLVE_ARGS], 9 * 32)
    d = _resolve_inputs(4301, 40, 40, 8, 1, 2, 64)
    with pytest.raises(ValueError):
        hk.iwant_resolve(*[_t(d[a]) for a in RESOLVE_ARGS], 65)
    d = _resolve_inputs(4302, 4, 4, 10923, 1, 1, 32)
    with pytest.raises(ValueError, match="2T"):
        hk.iwant_resolve(*[_t(d[a]) for a in RESOLVE_ARGS], 32)
    assert kernel_route[0] == []
    for k, w in ((130, 2), (8, 8)):
        d = _resolve_inputs(4303 + k, 40, 40, k, 1, w, 32 * w)
        got = hk.iwant_resolve(*[_t(d[a]) for a in RESOLVE_ARGS], 32 * w)
        want = hk.iwant_resolve_plain(*[_t(d[a]) for a in RESOLVE_ARGS],
                                      32 * w)
        for f, a, b in zip(want._fields, want, got):
            assert torch.equal(a, b), f
    assert kernel_route[0] == ["iwant_resolve", "iwant_resolve"]
