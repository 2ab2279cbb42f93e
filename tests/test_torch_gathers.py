"""Parity of the port's gather kernels' plain versions against the JAX
package's Pallas kernels in interpret mode, exactly: the words gather
(kernel 5, ``_gather_words_pallas``), the payload permute (kernel 6,
``_gather_pallas``) and the two-level take (kernel 7,
``take_words_twolevel``), plus the formulations built on them
(the n-major ``take_rows``, ``take_payload_onehot``, ``_edge_table_mxu``
with ride-along tables, ``bits.gather_words_rows`` under both gather
modes), at widths W from 1 to 10 and at row and index counts that are no
multiple of a vector width. The kernels
themselves are held to these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.ops.bits import gather_words_rows as jgather_words_rows
from go_libp2p_pubsub_tpu.ops.mxutake import (take_payload_onehot,
                                              take_words_twolevel)
from go_libp2p_pubsub_tpu.ops.permgather import (_edge_table_mxu as jtable_mxu,
                                                 _gather_pallas,
                                                 _gather_words_pallas)
from go_libp2p_pubsub_tpu_torch.ops import mxutake as mt
from go_libp2p_pubsub_tpu_torch.ops import permgather as pg
from go_libp2p_pubsub_tpu_torch.ops.bits import gather_words_rows


def _words(rng, *shape, density=0.5):
    bits = rng.random(shape + (32,)) < density
    w = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    w = w.astype(np.uint32)
    w.flat[0] |= np.uint32(0x80000000)                     # bit 31 set
    return w


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
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a.view(np.uint32) if a.dtype == np.float32
                                  else a,
                                  b.view(np.uint32) if b.dtype == np.float32
                                  else b, err_msg=what)


@pytest.mark.parametrize("w", [1, 2, 3, 8, 10])
@pytest.mark.parametrize("n,k", [(256, 16), (1024, 32)])
def test_gather_words_plain_equals_pallas(w, n, k):
    rng = np.random.default_rng(w * 100 + k)
    x_w = _words(rng, w, n)
    nbr = rng.integers(0, n, size=(n, k), dtype=np.int32)
    want = _gather_words_pallas(jnp.asarray(x_w), jnp.asarray(nbr),
                                interpret=True)
    got = pg.gather_words(_t(x_w), _t(nbr))
    assert got.shape == (w, k, n)
    _same(want, got, "gather_words")


@pytest.mark.parametrize("dtype", [np.uint32, np.float32])
@pytest.mark.parametrize("n,k", [(256, 16), (1024, 32)])
def test_permutation_gather_plain_equals_pallas(dtype, n, k):
    rng = np.random.default_rng(n + k)
    if dtype == np.uint32:
        payload = _words(rng, n, k)
    else:
        payload = rng.standard_normal((n, k)).astype(np.float32)
        payload.flat[:3] = [np.nan, -0.0, np.inf]
    jn = rng.integers(0, n, size=(n, k), dtype=np.int32)
    rk = rng.integers(0, k, size=(n, k), dtype=np.int32)
    want = _gather_pallas(jnp.asarray(payload), jnp.asarray(jn),
                          jnp.asarray(rk), interpret=True)
    got = pg.permutation_gather(_t(payload), _t(jn), _t(rk))
    _same(want, got, "permutation_gather")
    # the flat take formulation (edge_gather_mode="mxu") is the same function
    _same(want, pg.permutation_gather(_t(payload), _t(jn), _t(rk), "mxu"),
          "permutation_gather[mxu]")


@pytest.mark.parametrize("w", [1, 2, 3, 8, 10])
@pytest.mark.parametrize("r,block_g", [(2500, 1024), (1000, 256), (777, 1024),
                                       (0, 1024)])
def test_take_words_plain_equals_twolevel(w, r, block_g):
    n = 1000                                   # not a multiple of 128
    rng = np.random.default_rng(w * 10 + r)
    x_w = _words(rng, w, n)
    idx = rng.integers(0, n, size=(r,), dtype=np.int32)
    want = take_words_twolevel(jnp.asarray(x_w), jnp.asarray(idx),
                               block_g=block_g, interpret=True)
    got = mt.take_words(_t(x_w), _t(idx))
    assert got.shape == (w, r)
    _same(want, got, "take_words")
    # the same take over the n-major table, with n-major rows out
    rows = mt.take_rows(_t(x_w).T.contiguous(), _t(idx))
    assert rows.shape == (r, w)
    _same(want, rows.T, "take_rows")


# a table whose row count is no multiple of 4, an R no multiple of 4, the
# first and last rows among the indices
@pytest.mark.parametrize("w", [1, 3, 8, 10])
@pytest.mark.parametrize("n,r", [(1001, 777), (61, 4099), (1001, 0)])
def test_take_rows_plain_equals_twolevel(w, n, r):
    rng = np.random.default_rng(w * 1000 + n + r)
    x_w = _words(rng, w, n)
    idx = rng.integers(0, n, size=(r,), dtype=np.int32)
    idx[:2] = [0, n - 1][:r]
    want = take_words_twolevel(jnp.asarray(x_w), jnp.asarray(idx),
                               interpret=True)
    tab = _t(np.ascontiguousarray(x_w.T))                   # [N, W]
    got = mt.take_rows(tab, _t(idx))
    assert got.shape == (r, w)
    _same(np.asarray(want).T, got, "take_rows")


@pytest.mark.parametrize("dtype", [np.uint32, np.float32])
def test_take_payload_equals_onehot(dtype):
    n, k = 384, 16
    rng = np.random.default_rng(7)
    payload = _words(rng, n, k) if dtype == np.uint32 else \
        rng.standard_normal((n, k)).astype(np.float32)
    jn = rng.integers(0, n, size=(n, k), dtype=np.int32)
    rk = rng.integers(0, k, size=(n, k), dtype=np.int32)
    want = take_payload_onehot(jnp.asarray(payload), jnp.asarray(jn),
                               jnp.asarray(rk), interpret=True)
    _same(want, mt.take_payload(_t(payload), _t(jn), _t(rk)), "take_payload")


def _edge_table_mxu_case(n, k, b_planes, extra_ws, seed):
    rng = np.random.default_rng(seed)
    wb = (b_planes * k + 31) // 32
    table = _words(rng, n, wb, density=0.3)
    extras = [_words(rng, w, n) for w in extra_ws]
    jn = rng.integers(0, n, size=(n, k), dtype=np.int32)
    jn.flat[:2] = [0, n - 1]
    rk = rng.integers(0, k, size=(n, k), dtype=np.int32)
    want_g, want_x = jtable_mxu(jnp.asarray(table), jnp.asarray(jn),
                                jnp.asarray(rk), b_planes,
                                extra_words=tuple(jnp.asarray(e)
                                                  for e in extras),
                                interpret=True)
    got_g, got_x = pg._edge_table_mxu(_t(table), _t(jn), _t(rk), b_planes,
                                      tuple(_t(e) for e in extras))
    assert len(got_g) == len(want_g)
    assert len(got_x) == len(want_x) == len(extras)
    for a, b in zip(want_g, got_g):
        _same(a, b, "_edge_table_mxu groups")
    for a, b in zip(want_x, got_x):
        _same(a, b, "_edge_table_mxu extras")                # [W, K, N]
    # the groups equal the bit-table kernel's; the extras equal the words
    # gather's k-major receiver view
    for a, b in zip(pg.edge_table(_t(table), _t(jn), _t(rk), b_planes),
                    got_g):
        assert torch.equal(a, b)
    for e, b in zip(extras, got_x):
        assert torch.equal(b, pg.gather_words(_t(e), _t(jn)))


# bit-table widths W = B*K/32 of 2, 8, 1, 3 and 10 words, each with a
# two-word ride-along table
@pytest.mark.parametrize("b_planes", [2, 8, 1, 3, 10])
def test_edge_table_mxu_with_extra_table(b_planes):
    _edge_table_mxu_case(256, 32, b_planes, (2,), b_planes)


# peer counts and R = N*K no multiple of 4, several or no ride-along tables
@pytest.mark.parametrize("n,k,b_planes,extra_ws", [(250, 7, 3, (1, 3)),
                                                   (1001, 5, 40, (2,)),
                                                   (61, 3, 1, ())])
def test_edge_table_mxu_ragged_shapes(n, k, b_planes, extra_ws):
    _edge_table_mxu_case(n, k, b_planes, extra_ws, n + k)


@pytest.mark.parametrize("mode", ["pallas", "mxu"])
def test_gather_words_rows_equals_reference(mode):
    n, k, m = 256, 16, 64
    rng = np.random.default_rng(3)
    x_w = _words(rng, 2, n)
    nbr = rng.integers(0, n, size=(n, k), dtype=np.int32)
    want = jgather_words_rows(jnp.asarray(x_w), jnp.asarray(nbr), m, mode)
    _same(want, gather_words_rows(_t(x_w), _t(nbr), mode), f"gw[{mode}]")


def test_gather_modes_resolve_and_refuse():
    """``"auto"`` takes the kernels (the dispatch table's ``cuda`` entry),
    each explicit formulation resolves to itself, an unknown one raises;
    the scalar, rows and sort gathers equal the reference's same
    formulations on a real edge involution."""
    from go_libp2p_pubsub_tpu.ops import permgather as jpg
    from go_libp2p_pubsub_tpu_torch.sim import topology
    for n, k in ((256, 16), (102400, 32), (1 << 20, 32)):
        assert pg.resolve_mode("auto", torch.int32, n, k,
                               have_sort_key=True) == "pallas"
        assert pg.resolve_words_mode("auto", 2, n, k,
                                     have_sort_key=True) == "pallas"
        assert pg.resolve_edge_packed_mode("auto", n, k, 2) == "pallas"
        for mode in ("scalar", "rows", "sort", "pallas", "mxu"):
            assert pg.resolve_mode(mode, torch.int32, n, k,
                                   have_sort_key=True) == mode
            assert pg.resolve_words_mode(mode, 2, n, k,
                                         have_sort_key=True) == mode
            assert pg.resolve_edge_packed_mode(mode, n, k, 2) == mode
    for fn in (lambda: pg.resolve_mode("bogus", torch.int32, 8, 4),
               lambda: pg.resolve_words_mode("bogus", 1, 8, 4),
               lambda: pg.resolve_edge_packed_mode("bogus", 8, 4, 2)):
        with pytest.raises(ValueError):
            fn()
    n, k, m = 256, 16, 64
    topo = topology.sparse(n, k, degree=6)
    rng = np.random.default_rng(5)
    jn = np.clip(topo.neighbors, 0, n - 1)
    rk = np.clip(topo.reverse_slot, 0, k - 1)
    payload = _words(rng, n, k)
    x_w = _words(rng, 2, n)
    for mode in ("scalar", "rows", "sort"):
        jk = [jpg.edge_sort_key(jnp.asarray(topo.neighbors),
                                jnp.asarray(topo.reverse_slot), k_major=km)
              for km in (False, True)]
        tk = [pg.edge_sort_key(_t(topo.neighbors), _t(topo.reverse_slot),
                               k_major=km) for km in (False, True)]
        want = jpg.permutation_gather(jnp.asarray(payload), jnp.asarray(jn),
                                      jnp.asarray(rk), mode, sort_key=jk[0])
        _same(want, pg.permutation_gather(_t(payload), _t(jn), _t(rk), mode,
                                          sort_key=tk[0]), f"perm[{mode}]")
        want = jpg.gather_words(jnp.asarray(x_w), jnp.asarray(jn), m, mode,
                                sort_key=jk[1])
        _same(want, pg.gather_words(_t(x_w), _t(jn), mode, m=m,
                                    sort_key=tk[1]), f"words[{mode}]")


def test_gather_wrappers_refuse_other_devices_and_types():
    meta = torch.zeros((4, 4), dtype=torch.int32, device="meta")
    cpu = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        pg.gather_words(meta, meta)
    with pytest.raises(ValueError):
        pg.permutation_gather(cpu, meta, meta)
    with pytest.raises(ValueError):
        mt.take_words(meta, torch.zeros(4, dtype=torch.int32, device="meta"))
    with pytest.raises(TypeError):
        pg.permutation_gather(cpu.to(torch.int64), cpu, cpu)
    with pytest.raises(TypeError):
        mt.take_words(cpu, torch.zeros(4, dtype=torch.int64))


GARBAGE = 0x5A5A5A5A              # fill of memory a kernel must write
GW_BN, GW_TILE_K, GW_CHUNK_K = 32, 383, 382   # csrc/gather_words.cu
SMEM_NO_OPT_IN = 48 * 1024


def _emulated_gather_words(tab, nbr, out, n, k, w):
    """csrc/gather_words.cu: a block of BN receivers stages its nbr rows
    into a [BN, KC + 1] tile one chunk of slots at a time (KC = K up to
    383, else 382) and gathers each chunk's slots from the tile; the tile
    keeps the previous chunk's words where this one is shorter."""
    kc = k if k <= GW_TILE_K else GW_CHUNK_K               # chunk_slots
    ld = kc + 1
    assert GW_BN * ld * 4 <= SMEM_NO_OPT_IN                # no opt-in
    assert k <= GW_TILE_K or ld % 2 == 1                   # odd pitch
    flat = tab.reshape(-1)
    out.fill_(GARBAGE)
    rows = torch.arange(n)
    blk, i = rows // GW_BN, rows % GW_BN
    tile = torch.full((-(-n // GW_BN), GW_BN * ld), GARBAGE, dtype=torch.int32)
    for c0 in range(0, k, kc):
        cn = min(kc, k - c0)
        at = (blk[:, None], i[:, None] * ld + torch.arange(cn))
        tile[at] = nbr[:, c0:c0 + cn]                      # cp.async stage
        j = tile[at].long()                                # [N, cn]
        src = j.T[None] * w + torch.arange(w)[:, None, None]
        out[:, c0:c0 + cn, :] = flat[src]                  # [W, cn, N]


def _emulated_permutation_gather(payload, jn, rk, out, n, k, k_src):
    """csrc/permutation_gather.cu: one thread per flat edge e = n * K + k,
    ``out[e] = payload[jn[e] * K_src + rk[e]]``, at any alignment and edge
    count."""
    flat, o = payload.reshape(-1), out.view(-1)
    o.fill_(GARBAGE)
    o[:n * k] = flat[jn.reshape(-1).long() * k_src + rk.reshape(-1).long()]


def _emulated_launch(name, *args):
    """The gather kernels' documented addressing, in PyTorch: what
    csrc/take_words.cu, csrc/gather_words.cu and
    csrc/permutation_gather.cu write from the tables, indices and output
    strides a wrapper passes them."""
    if name == "take_words":
        tab, idx, out, r, w, os_r, os_w = args
        assert tab.shape[1] == w and tab.is_contiguous()
        rr = torch.arange(r)[:, None]
        ww = torch.arange(w)[None, :]
        src = idx.long()[:, None] * w + ww
        out.view(-1)[(rr * os_r + ww * os_w).reshape(-1)] = \
            tab.reshape(-1)[src.reshape(-1)]
    elif name == "gather_words":
        tab, nbr, out, n, k, w = args
        assert tab.shape[1] == w and tab.is_contiguous()
        _emulated_gather_words(tab, nbr, out, n, k, w)
    elif name == "permutation_gather":
        _emulated_permutation_gather(*args)
    else:
        raise AssertionError(f"unexpected kernel {name}")


def _kernel_route(monkeypatch):
    from go_libp2p_pubsub_tpu_torch.ops import cudalib
    monkeypatch.setattr(cudalib, "use_kernel", lambda name, *t: True)
    monkeypatch.setattr(cudalib, "check_args", lambda name, specs: None)
    monkeypatch.setattr(cudalib, "launch", _emulated_launch)


@pytest.mark.parametrize("w", [1, 2, 3, 9, 10])
def test_wrapper_layouts_equal_reference(w, monkeypatch):
    """The wrappers' layout logic on the kernel route (the interleave into
    rows, the strides, the n-major concatenation and the output views)
    with the kernels' addressing emulated, against the JAX package."""
    _kernel_route(monkeypatch)
    n, k, r = 1001, 7, 777
    rng = np.random.default_rng(90 + w)
    x_w = _words(rng, w, n)
    nbr = rng.integers(0, n, size=(n, k), dtype=np.int32)
    idx = rng.integers(0, n, size=(r,), dtype=np.int32)
    want = _gather_words_pallas(jnp.asarray(x_w), jnp.asarray(nbr),
                                interpret=True)
    _same(want, pg.gather_words(_t(x_w), _t(nbr)), "gather_words")
    _same(want, pg.gather_words(_t(x_w), _t(nbr), "mxu"), "gather_words[mxu]")
    want = take_words_twolevel(jnp.asarray(x_w), jnp.asarray(idx),
                               interpret=True)
    _same(want, mt.take_words(_t(x_w), _t(idx)), "take_words")
    _same(np.asarray(want).T, mt.take_rows(_t(x_w).T.contiguous(), _t(idx)),
          "take_rows")
    # the bit-table exchange with ride-along tables, and the payload take
    table = _words(rng, n, w, density=0.3)
    extra = _words(rng, 2, n)
    jn = rng.integers(0, n, size=(n, k), dtype=np.int32)
    rk = rng.integers(0, k, size=(n, k), dtype=np.int32)
    b_planes = w * 32 // k
    want_g, want_x = jtable_mxu(jnp.asarray(table), jnp.asarray(jn),
                                jnp.asarray(rk), b_planes,
                                extra_words=(jnp.asarray(extra),),
                                interpret=True)
    got_g, got_x = pg._edge_table_mxu(_t(table), _t(jn), _t(rk), b_planes,
                                      (_t(extra),))
    for a, b in zip(want_g, got_g):
        _same(a, b, "_edge_table_mxu groups")
    _same(want_x[0], got_x[0], "_edge_table_mxu extras")
    payload = _words(rng, n, k)
    want = take_payload_onehot(jnp.asarray(payload), jnp.asarray(jn),
                               jnp.asarray(rk), interpret=True)
    _same(want, mt.take_payload(_t(payload), _t(jn), _t(rk)), "take_payload")


# one chunk at its largest (the 48 KB tile), two chunks with a short
# second one, several, and a last chunk of one slot
@pytest.mark.parametrize("k", [383, 384, 512, 1000, 765])
def test_gather_words_takes_any_k_in_chunks(monkeypatch, k):
    """On the kernel route a K whose nbr rows do not fit one staged tile
    goes through in chunks of slots, with no refusal, equal to the plain
    version (held to the JAX package's Pallas kernel above)."""
    _kernel_route(monkeypatch)
    n = 40
    rng = np.random.default_rng(k)
    x_w = _words(rng, 2, n)
    nbr = rng.integers(0, n, size=(n, k), dtype=np.int32)
    nbr[0, 0], nbr[-1, -1] = 0, n - 1
    got = pg.gather_words(_t(x_w), _t(nbr))
    assert got.shape == (2, k, n)
    assert torch.equal(got, pg.gather_words_plain(_t(x_w), _t(nbr)))


def _offset(a, ofs):
    """``a`` as a CPU tensor whose data begins ``ofs`` elements into its
    storage, so that its address is no multiple of 16 bytes when ofs is odd."""
    t = _t(a)
    buf = torch.empty(t.numel() + ofs, dtype=t.dtype)
    view = buf[ofs:].view(t.shape)
    view.copy_(t)
    return view


# N*K a multiple of 4 and not, aligned and at a storage offset of one
# element (an address no multiple of 16 bytes)
@pytest.mark.parametrize("n,k,ofs", [(256, 16, 0), (250, 7, 0), (256, 16, 1),
                                     (61, 3, 1)])
@pytest.mark.parametrize("dtype", [np.uint32, np.float32])
def test_permutation_gather_kernel_route_equals_pallas(monkeypatch, n, k,
                                                       ofs, dtype):
    """The payload permute on its kernel route, with csrc/
    permutation_gather.cu's addressing emulated, against the JAX package's
    Pallas kernel and the plain version; with ``ofs = 1`` the output too is
    written at an address no multiple of 16 bytes."""
    _kernel_route(monkeypatch)
    rng = np.random.default_rng(n + k + ofs)
    payload = _words(rng, n, k) if dtype == np.uint32 else \
        rng.standard_normal((n, k)).astype(np.float32)
    jn = rng.integers(0, n, size=(n, k), dtype=np.int32)
    rk = rng.integers(0, k, size=(n, k), dtype=np.int32)
    jn[0, 0], jn[-1, -1], rk[-1, -1] = 0, n - 1, k - 1
    want = _gather_pallas(jnp.asarray(payload), jnp.asarray(jn),
                          jnp.asarray(rk), interpret=True)
    tj, tr = _offset(jn, ofs), _offset(rk, ofs)
    got = pg.permutation_gather(_t(payload), tj, tr)
    _same(want, got, "permutation_gather")
    assert torch.equal(got.view(torch.int32), pg.permutation_gather_plain(
        _t(payload), tj, tr).view(torch.int32))
    # the launch with an output at the same offset
    out = _offset(np.zeros((n, k), np.int32), ofs)
    _emulated_launch("permutation_gather", _t(payload).view(torch.int32),
                     tj, tr, out, n, k, k)
    _same(want, out.view(got.dtype), "permutation_gather, offset output")
