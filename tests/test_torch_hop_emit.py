"""The slot-parallel hop and emit kernels (csrc/hop.cu, csrc/emit.cu) on
the CPU: each wrapper runs its kernel route with ``cudalib.launch``
replaced by an emulation of the kernel's algorithm and addressing, and is
compared with the JAX package's Pallas kernel in interpret mode, exactly.

The emulations follow the CUDA sources step by step, vectorised over the
receivers (one warp each) and the 32 lanes of a warp (one slot each): the
n-major frontier and window rows read at ``x[j * W + i]`` and only where
the edge's plane allows a topic; the inclusive prefix-OR over lanes by
five ``__shfl_up_sync`` steps; K > 32 as chunks of 32 with the OR of
earlier chunks carried; the hop's counts added in place at
``(t * K + s) * N + n``, only where not zero; the emit's budgeted scan over
the offering lanes in slot order, and its [32, M] tile per block of int8,
int16 or int32 slots filled with -1 and written out as int32 rows. The
kernels themselves are held to the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.ops.hopkernel import emit_pallas, hop_pallas
from go_libp2p_pubsub_tpu_torch.ops import cudalib
from go_libp2p_pubsub_tpu_torch.ops import hopkernel as hk
from go_libp2p_pubsub_tpu_torch.ops.bits import popcount


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs (the
    suite runs in several worker processes; see
    tests/test_torch_engine_modes.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


I32 = torch.int32
LANE = torch.arange(32)
EMIT_BR = 32                          # csrc/emit.cu BR: receivers per block
HOP_ARGS = ["frontier", "have", "dlv", "dlv_new", "vm", "inv_n",
            "window_old", "valid_msg", "nbr", "fwd", "mesh", "tb", "nv", "ni",
            "dup"]
EMIT_ARGS = ["window", "have", "gossip", "tb", "nbr"]


# --- inputs -------------------------------------------------------------------

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


def _inputs(seed, n, n_src, k, t, w):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n_src, size=(n, k), dtype=np.int32)
    nbr[0, 0], nbr[-1, -1] = 0, n_src - 1
    return dict(
        nbr=nbr, tb=_topic_bits(rng, t, w),
        frontier=_words(rng, w, n_src, density=0.1),
        have=_words(rng, w, n, density=0.3),
        dlv=_words(rng, w, n, density=0.3),
        dlv_new=_words(rng, w, n, density=0.1),
        vm=_words(rng, w, n, density=0.9),
        inv_n=_words(rng, w, n, density=0.05),
        window_old=_words(rng, w, n, density=0.2),
        valid_msg=_words(rng, w, 1, density=0.9),
        fwd=(rng.random((n, t, k)) < 0.3).astype(np.uint8),
        mesh=(rng.random((n, t, k)) < 0.3).astype(np.uint8),
        nv=rng.integers(0, 256, size=(t, k, n), dtype=np.uint8),
        ni=rng.integers(0, 256, size=(t, k, n), dtype=np.uint8),
        dup=rng.integers(0, 256, size=(t, k, n), dtype=np.uint8),
        window=_words(rng, w, n_src, density=0.3),
        gossip=(rng.random((n, t, k)) < 0.3).astype(np.uint8),
    )


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


# --- warp primitives (csrc/slot_warp.cuh) -----------------------------------

def _shfl_up(v, d):
    """``__shfl_up_sync`` over the last (lane) axis: lane l reads lane
    l - d; lanes below d read their own value."""
    out = v.clone()
    out[..., d:] = v[..., :-d]
    return out


def _prefix_or(v):
    for d in (1, 2, 4, 8, 16):
        v = torch.where(LANE >= d, v | _shfl_up(v, d), v)
    return v


def _exclusive_of(incl):
    return torch.where(LANE == 0, torch.zeros_like(incl), _shfl_up(incl, 1))


def _expand(plane, tb, rows, s, live):
    """expand_topics: [R, W, 32] OR of topic_bits[tt] where plane byte set."""
    k = plane.shape[2]
    out = torch.zeros((len(rows), tb.shape[1], 32), dtype=I32)
    for tt in range(tb.shape[0]):
        on = (plane[rows][:, tt, s.clamp(max=k - 1)] != 0) & live
        out = out | torch.where(on[:, None, :], tb[tt][None, :, None],
                                torch.zeros((), dtype=I32))
    return out


def _load_rows(tab, nbr, rows, s, any_):
    """load_row: lane s of receiver r reads x[j * W + i], j = nbr[r][s],
    where any_ (the plane allows a topic); zeros elsewhere."""
    w = tab.shape[1]
    j = nbr[rows][:, s.clamp(max=nbr.shape[1] - 1)].long()        # [R, 32]
    flat = tab.reshape(-1)
    row = flat[j[:, None, :] * w + torch.arange(w)[None, :, None]]  # [R,W,32]
    return torch.where(any_[:, None, :], row, torch.zeros((), dtype=I32))


def _chunk(c, k):
    s = 32 * c + LANE
    return s, s < k


# --- csrc/hop.cu ---------------------------------------------------------------

def _edge_offer(fr, nbr, fwd, mesh, tb, rows, c, k):
    s, live = _chunk(c, k)
    allowed = _expand(fwd, tb, rows, s, live)
    meb = _expand(mesh, tb, rows, s, live)
    off = _load_rows(fr, nbr, rows, s, (allowed != 0).any(1)) & allowed
    return off, off & meb


def _emulated_hop(fr, have, dlv, dlv_new, vm, inv_n, wold, vmsg, nbr, fwd,
                  mesh, tb, nv, ni, dup, new_valid, n, k, t, w):
    assert fr.shape[1] == w and fr.is_contiguous()          # n-major rows
    nch = (k + 31) // 32
    rows = torch.arange(n)
    cnt = [x.view(-1).to(torch.int64) for x in (nv, ni, dup)]

    def add(p, tt, s, live, v):
        """lane s adds v into byte (tt * K + s) * N + r where v != 0"""
        idx = (tt * k + s)[None, :] * n + rows[:, None]
        on = live[None, :] & (v != 0)
        cnt[p][idx[on]] += v[on].long()

    hv = have.T[:, :, None]
    vmv = vm.T[:, :, None]
    inv = inv_n.T[:, :, None]
    carry = torch.zeros((n, w), dtype=I32)
    for c in range(nch):
        s, live = _chunk(c, k)
        off, offm = _edge_offer(fr, nbr, fwd, mesh, tb, rows, c, k)
        incl = _prefix_or(off)
        nf = off & ~(_exclusive_of(incl) | carry[:, :, None]) & ~hv
        carry = carry | incl[:, :, 31]
        for tt in range(t):
            tw = tb[tt][None, :, None]
            add(0, tt, s, live, popcount(nf & vmv & tw).sum(1))
            add(1, tt, s, live, popcount(nf & inv & tw).sum(1))
    new_any = carry & ~hv[:, :, 0]
    nval = new_any & vmv[:, :, 0]
    elig = (wold.T | dlv_new.T | nval) & vmsg[:, 0]
    for c in range(nch):
        s, live = _chunk(c, k)
        if nch > 1:
            off, offm = _edge_offer(fr, nbr, fwd, mesh, tb, rows, c, k)
        for tt in range(t):
            add(2, tt, s, live, popcount(
                offm & elig[:, :, None] & tb[tt][None, :, None]).sum(1))
    new_valid.copy_(nval.T)
    have |= new_any.T
    dlv |= nval.T
    dlv_new |= nval.T
    for p, x in enumerate((nv, ni, dup)):
        x.view(-1).copy_((cnt[p] & 0xFF).to(torch.uint8))


# --- csrc/emit.cu --------------------------------------------------------------

def _first_bits(x, budget):
    """first_bits: the first ``budget`` set bits of each row's W words."""
    left = torch.full((x.shape[0],), budget, dtype=torch.int64)
    take = torch.zeros_like(x)
    for i in range(x.shape[1]):
        xi = x[:, i]
        cnt = popcount(xi).long()
        some = (left > 0) & (xi != 0)
        whole, part = some & (cnt <= left), some & (cnt > left)
        v, peeled = xi.clone(), torch.zeros_like(xi)
        for q in range(32):
            low = torch.where(part & (q < left), v & -v, torch.zeros_like(v))
            peeled, v = peeled | low, v ^ low
        take[:, i] = torch.where(whole, xi, peeled)
        left = torch.where(whole, left - cnt,
                           torch.where(part, torch.zeros_like(left), left))
    return take


def _emulated_emit(win, have, gossip, tb, nbr, out, n, k, t, w, m, budget,
                   slot_bytes):
    assert win.shape[1] == w and win.is_contiguous()        # n-major rows
    assert slot_bytes == hk.emit_slot_bytes(k)
    br = EMIT_BR
    dtype = {1: torch.int8, 2: torch.int16, 4: torch.int32}[slot_bytes]
    assert k - 1 <= torch.iinfo(dtype).max
    rem = m - 32 * torch.arange(w)
    valid = torch.where(rem >= 32, -1, (1 << rem.clamp(0, 31)) - 1).to(I32)
    for r0 in range(0, n, br):
        rows = torch.arange(r0, min(r0 + br, n))
        nr = len(rows)
        tile = torch.full((br * m,), -1, dtype=dtype)
        asg = have[:, rows].T.clone()                        # [R, W]
        carry = torch.zeros_like(asg)
        for c in range((k + 31) // 32):
            s, live = _chunk(c, k)
            allowed = _expand(gossip, tb, rows, s, live)
            row = _load_rows(win, nbr, rows, s, (allowed != 0).any(1))
            masked = row & allowed & ~asg[:, :, None] & valid[None, :, None]
            if budget >= m:
                incl = _prefix_or(masked)
                take = masked & ~(_exclusive_of(incl) | carry[:, :, None])
                carry = carry | incl[:, :, 31]
            else:
                # the offering lanes (the ballot) take turns in slot order
                take = torch.zeros_like(masked)
                turn = (masked != 0).any(1)                      # [R, 32]
                for lane in range(32):
                    on = turn[:, lane, None]
                    take[:, :, lane] = torch.where(
                        on, _first_bits(masked[:, :, lane] & ~asg, budget),
                        torch.zeros((), dtype=I32))
                    asg = asg | take[:, :, lane]
            # each id is taken by one lane at most: tile[rl][32i + b] = s
            bit = (take[:, :, :, None] >> torch.arange(32)) & 1  # [R,W,L,B]
            assert int(bit.sum(2).max()) <= 1
            hit = bit.sum(2) > 0                                 # [R, W, B]
            slot = (bit * s[None, None, :, None]).sum(2)
            idx = ((torch.arange(nr)[:, None, None] * m)
                   + 32 * torch.arange(w)[None, :, None]
                   + torch.arange(32)[None, None, :])
            tile[idx[hit]] = slot[hit].to(dtype)
        out.view(-1)[r0 * m:r0 * m + nr * m] = tile[:nr * m].to(I32)


def _emulated_launch(name, *args):
    if name == "hop":
        _emulated_hop(*args)
    elif name == "emit":
        _emulated_emit(*args)
    else:
        raise AssertionError(f"unexpected kernel {name}")


@pytest.fixture
def kernel_route(monkeypatch):
    """The wrappers' kernel route on CPU tensors, kernels emulated; the
    launches are counted."""
    calls = []

    def launch(name, *args):
        calls.append(name)
        _emulated_launch(name, *args)

    monkeypatch.setattr(cudalib, "use_kernel", lambda name, *t: True)
    monkeypatch.setattr(cudalib, "check_args", lambda name, specs: None)
    monkeypatch.setattr(cudalib, "launch", launch)
    return calls


# --- tests -------------------------------------------------------------------

# N no multiple of the kernels' block rows, a sender table wider than N, K
# below, at and above one warp of slots, T = 1 and 3, W = 1 to 3
HOP_CASES = [(200, 200, 8, 1, 1), (256, 256, 32, 1, 2), (200, 230, 32, 3, 3),
             (130, 130, 40, 1, 2), (257, 257, 40, 3, 1), (100, 100, 64, 1, 3),
             (150, 170, 64, 3, 2), (300, 300, 8, 3, 2)]


@pytest.mark.parametrize("n,n_src,k,t,w", HOP_CASES)
def test_hop_kernel_route_equals_pallas(n, n_src, k, t, w, kernel_route):
    d = _inputs(1000 + k * 10 + t * 3 + w, n, n_src, k, t, w)
    want = hop_pallas(*[jnp.asarray(d[a]) for a in HOP_ARGS], interpret=True)
    got = hk.hop(*[_t(d[a]) for a in HOP_ARGS])
    assert kernel_route == ["hop"]
    for f, a, b in zip(want._fields, want, got):
        _same(a, b, f"hop.{f}")
    # non-vacuous: new messages, first deliveries and duplicates counted,
    # also at slots past the first warp
    assert np.asarray(want.new_valid).any()
    for f in ("nv", "dup"):
        moved = np.asarray(getattr(want, f)) != d[f]
        assert moved.any() and (k <= 32 or moved[:, 32:].any()), f


# many topics and slots: T*K = 512 and 320, K in two chunks; against the
# plain twin, which test_torch_kernels.py holds to the Pallas kernel
@pytest.mark.parametrize("t,k,w", [(8, 64, 2), (5, 64, 3)])
def test_hop_kernel_route_many_topics(t, k, w, kernel_route):
    d = _inputs(77 + t, 99, 120, k, t, w)
    want = hk.hop_plain(*[_t(d[a]) for a in HOP_ARGS])
    got = hk.hop(*[_t(d[a]) for a in HOP_ARGS])
    assert kernel_route == ["hop"]
    for f, a, b in zip(want._fields, want, got):
        assert torch.equal(a, b), f


# emit: budget 1, 5 (< M, the serial scan) and M (the prefix-OR), M no
# multiple of 32 once
EMIT_CASES = [(200, 200, 8, 1, 1, 32, 1), (200, 200, 8, 3, 2, 64, 64),
              (256, 256, 32, 1, 2, 64, 5), (256, 256, 32, 1, 2, 64, 64),
              (130, 150, 40, 3, 3, 96, 1), (257, 257, 40, 1, 2, 40, 5),
              (100, 100, 64, 1, 1, 32, 32), (150, 150, 64, 3, 2, 64, 5),
              (300, 300, 32, 3, 3, 96, 96)]


@pytest.mark.parametrize("n,n_src,k,t,w,m,budget", EMIT_CASES)
def test_emit_kernel_route_equals_pallas(n, n_src, k, t, w, m, budget,
                                         kernel_route):
    d = _inputs(2000 + k * 10 + t * 3 + w + budget, n, n_src, k, t, w)
    want = emit_pallas(*[jnp.asarray(d[a]) for a in EMIT_ARGS], m=m,
                       budget=budget, interpret=True)
    got = hk.emit(*[_t(d[a]) for a in EMIT_ARGS], m, budget)
    assert kernel_route == ["emit"]
    _same(want, got, "emit")
    picks = np.asarray(want)
    assert (picks >= 0).any() and (k <= 32 or (picks >= 32).any())


@pytest.mark.parametrize("budget", [5, 64])
def test_emit_kernel_route_wide_slots(budget, kernel_route):
    """K = 130: slots past 127 need the int16 tile."""
    k, t, w, m = 130, 1, 2, 64
    assert hk.emit_slot_bytes(k) == 2
    d = _inputs(3000 + budget, 140, 140, k, t, w)
    d["gossip"][:, :, :120] = 0          # leave the offers to slots >= 120
    want = emit_pallas(*[jnp.asarray(d[a]) for a in EMIT_ARGS], m=m,
                       budget=budget, interpret=True)
    got = hk.emit(*[_t(d[a]) for a in EMIT_ARGS], m, budget)
    assert kernel_route == ["emit"]
    _same(want, got, "emit")
    assert (np.asarray(want) >= 128).any()


def test_emit_slot_bytes():
    """The emit's choice tile holds slots as int8 up to K = 128, int16 up
    to K = 2**15, int32 above."""
    assert [hk.emit_slot_bytes(k) for k in (1, 32, 128, 129, 1 << 15,
                                            (1 << 15) + 1)] == [1, 1, 1, 2,
                                                                2, 4]


def test_wrappers_refuse_only_what_they_refused(kernel_route):
    """W > 8 and, for emit, M > 32 W are refused before any launch; the
    widest W and a wide K and T go through."""
    d = _inputs(5, 40, 40, 8, 1, 9)
    with pytest.raises(ValueError):
        hk.hop(*[_t(d[a]) for a in HOP_ARGS])
    with pytest.raises(ValueError):
        hk.emit(*[_t(d[a]) for a in EMIT_ARGS], 9 * 32, 5)
    d = _inputs(6, 40, 40, 8, 1, 2)
    with pytest.raises(ValueError):
        hk.emit(*[_t(d[a]) for a in EMIT_ARGS], 65, 5)
    assert kernel_route == []
    d = _inputs(7, 40, 40, 130, 3, 8)
    got = hk.hop(*[_t(d[a]) for a in HOP_ARGS])
    want = hk.hop_plain(*[_t(d[a]) for a in HOP_ARGS])
    for f, a, b in zip(want._fields, want, got):
        assert torch.equal(a, b), f
    got = hk.emit(*[_t(d[a]) for a in EMIT_ARGS], 256, 3)
    assert torch.equal(got, hk.emit_plain(*[_t(d[a]) for a in EMIT_ARGS],
                                          256, 3))
    assert kernel_route == ["hop", "emit"]
