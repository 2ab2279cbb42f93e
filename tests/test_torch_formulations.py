"""Parity of the port's scalar, rows and sort formulations and of its
three selection formulations with the JAX package's same formulations on
the CPU, every output exact.

- ``edge_sort_key`` in both orders on the headline's, the frontier's and
  churn_50k's states (the last after 4 ticks of connection churn, so with
  down edges and empty slots), each equal to the reference's keys and a
  bijection of [0, N*K).
- ``permutation_gather``, ``gather_words`` and ``edge_gather_packed``
  (over 32 planes, with and without ``extra_words``) in ``scalar``,
  ``rows`` and ``sort`` on the churned state. Raw outputs are compared
  only against the reference's SAME formulation: at invalid slots
  scalar/rows read the clipped source and sort leaves the slot's own
  value.
- ``select_random``/``select_top`` in ``iter``, ``sort`` and ``ranks`` on
  keys with exact float ties, counts 0 ... K; ``iter``'s truncation above
  ``max_count`` and ``CHECK_COUNT_BOUND``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build
from go_libp2p_pubsub_tpu.ops import heartbeat as jhb
from go_libp2p_pubsub_tpu.ops import permgather as jpg
from go_libp2p_pubsub_tpu.ops import selection as jsel
from go_libp2p_pubsub_tpu.sim import scenarios as jscenarios
from go_libp2p_pubsub_tpu.sim.engine import run as jrun
from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.ops import heartbeat as hb
from go_libp2p_pubsub_tpu_torch.ops import permgather as pg
from go_libp2p_pubsub_tpu_torch.ops import selection as sel
from go_libp2p_pubsub_tpu_torch.sim import state_from_reference

FORMS = ["scalar", "rows", "sort"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs (several
    worker processes share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


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


def _words(rng_, *shape):
    return rng_.integers(0, 2 ** 32, size=shape, dtype=np.uint64) \
        .astype(np.uint32)


@pytest.fixture(scope="module")
def churned():
    """churn_50k at 256 peers after 4 ticks of connection churn (the JAX
    package's run), with the port's state made from its arrays."""
    jcfg, jtp, jst = jscenarios.churn_50k(n_peers=256, k_slots=16, degree=6)
    js = jrun(jst, jcfg, jtp, jax.random.PRNGKey(0), 4)
    arrays = _arrays(js)
    known = arrays["neighbors"] >= 0
    assert (known & ~arrays["connected"]).any()    # edges went down
    assert (arrays["neighbors"] < 0).any()         # empty slots
    return js, state_from_reference(arrays, device="cpu")


def _edge_states():
    jcfg, jtp, jst = _build(1024, 32, 12)
    yield "headline", np.asarray(jst.neighbors), np.asarray(jst.reverse_slot)
    jst = jscenarios.frontier(1024)[2]
    yield "frontier", np.asarray(jst.neighbors), np.asarray(jst.reverse_slot)


@pytest.mark.parametrize("k_major", [False, True])
def test_edge_sort_key_equal_and_bijective(k_major, churned):
    states = list(_edge_states())
    js, _ = churned
    states.append(("churn after 4 ticks", np.asarray(js.neighbors),
                   np.asarray(js.reverse_slot)))
    for what, nbr, rs in states:
        want = jpg.edge_sort_key(jnp.asarray(nbr), jnp.asarray(rs), k_major)
        got = pg.edge_sort_key(_t(nbr), _t(rs), k_major)
        _same(want, got, f"{what} k_major={k_major}")
        n, k = nbr.shape
        np.testing.assert_array_equal(np.sort(got.numpy()),
                                      np.arange(n * k), err_msg=what)


@pytest.mark.parametrize("mode", FORMS)
def test_permutation_gather_equal(mode, churned):
    js, st = churned
    n, k = st.neighbors.shape
    jn = np.clip(np.asarray(js.neighbors), 0, n - 1)
    rk = np.clip(np.asarray(js.reverse_slot), 0, k - 1)
    jkey = jpg.edge_sort_key(js.neighbors, js.reverse_slot, k_major=False)
    key = pg.edge_sort_key(st.neighbors, st.reverse_slot, k_major=False)
    r = np.random.default_rng(7)
    for payload in (_words(r, n, k), r.normal(size=(n, k)).astype(np.float32),
                    r.random((n, k)) < 0.5):
        want = jpg.permutation_gather(jnp.asarray(payload), jnp.asarray(jn),
                                      jnp.asarray(rk), mode, sort_key=jkey)
        got = pg.permutation_gather(_t(payload), _t(jn), _t(rk), mode,
                                    sort_key=key)
        _same(want, got, f"{mode} {payload.dtype}")


@pytest.mark.parametrize("mode", FORMS)
@pytest.mark.parametrize("w,m", [(1, 20), (2, 64), (3, 70)])
def test_gather_words_equal(mode, w, m, churned):
    js, st = churned
    n, k = st.neighbors.shape
    nbr = np.clip(np.asarray(js.neighbors), 0, n - 1)
    x_w = _words(np.random.default_rng(w), w, n)
    jkey = jpg.edge_sort_key(js.neighbors, js.reverse_slot, k_major=True)
    key = pg.edge_sort_key(st.neighbors, st.reverse_slot, k_major=True)
    want = jpg.gather_words(jnp.asarray(x_w), jnp.asarray(nbr), m, mode,
                            sort_key=jkey)
    got = pg.gather_words(_t(x_w), _t(nbr), mode, m=m, sort_key=key)
    _same(want, got, f"{mode} W={w} M={m}")


@pytest.mark.parametrize("mode", FORMS)
@pytest.mark.parametrize("extras", [0, 1, 2])
def test_edge_gather_packed_equal(mode, extras, churned):
    """Two masks of 20 topic planes each (B = 40: two payload groups);
    the extra word tables ride the sort's permutation, and scalar/rows
    refuse them in both packages."""
    js, st = churned
    n, k = st.neighbors.shape
    r = np.random.default_rng(11 + extras)
    masks = [r.random((n, 20, k)) < p for p in (0.3, 0.6)]
    tabs = [_words(r, wi, n) for wi in (2, 3)[:extras]]
    jmasks = [jnp.asarray(m_) for m_ in masks]
    tmasks = [torch.from_numpy(m_) for m_ in masks]
    if extras and mode != "sort":
        with pytest.raises(ValueError, match="extra_words"):
            jhb.edge_gather_packed(jmasks, js, mode,
                                   extra_words=[jnp.asarray(t) for t in tabs])
        with pytest.raises(ValueError, match="extra_words"):
            hb.edge_gather_packed(tmasks, st, mode,
                                  extra_words=[_t(t) for t in tabs])
        return
    if extras:
        want, want_x = jhb.edge_gather_packed(
            jmasks, js, mode, extra_words=[jnp.asarray(t) for t in tabs])
    else:
        want, want_x = jhb.edge_gather_packed(jmasks, js, mode), []
    got, got_x = hb.edge_gather_packed(tmasks, st, mode,
                                       extra_words=[_t(t) for t in tabs])
    assert len(want) == len(got) == 2 and len(want_x) == len(got_x)
    for i, (a, b) in enumerate(zip(want, got)):
        _same(a, b, f"{mode} mask {i}")
    for i, (a, b) in enumerate(zip(want_x, got_x)):
        _same(a, b, f"{mode} extra {i}")


def _tied_keys(r, shape):
    """Keys from 4 values, so that rows hold exact float ties."""
    return (r.integers(0, 4, size=shape) / 4).astype(np.float32)


@pytest.mark.parametrize("mode", ["iter", "sort", "ranks"])
def test_selection_equal_with_ties(mode):
    n, t, k = 64, 3, 32
    r = np.random.default_rng(3)
    mask = r.random((n, t, k)) < 0.7
    count = r.integers(0, k + 1, size=(n, t)).astype(np.int32)
    count[0, :] = [0, k, k - 1]
    max_count = k - 1 if mode == "iter" else k
    count = np.minimum(count, max_count)
    noise = _tied_keys(r, (n, t, k))
    score = _tied_keys(r, (n, t, k)) * 10 - 5
    want = jsel.select_random(jnp.asarray(mask), jnp.asarray(count), None,
                              max_count=max_count, mode=mode,
                              noise=jnp.asarray(noise))
    got = sel.select_random(torch.from_numpy(mask), torch.from_numpy(count),
                            None, max_count=max_count, mode=mode,
                            noise=torch.from_numpy(noise))
    _same(want, got, f"select_random[{mode}]")
    want = jsel.select_top(jnp.asarray(score), jnp.asarray(mask),
                           jnp.asarray(count), max_count=max_count, mode=mode)
    got = sel.select_top(torch.from_numpy(score), torch.from_numpy(mask),
                         torch.from_numpy(count), max_count=max_count,
                         mode=mode)
    _same(want, got, f"select_top[{mode}]")
    # the drawn noise path: the reference's uniform draw, bit for bit
    want = jsel.select_random(jnp.asarray(mask), jnp.asarray(count),
                              jax.random.PRNGKey(5), max_count=max_count,
                              mode=mode)
    got = sel.select_random(torch.from_numpy(mask), torch.from_numpy(count),
                            rng.PRNGKey(5, device="cpu"),
                            max_count=max_count, mode=mode)
    _same(want, got, f"select_random[{mode}] drawn")
    assert sel.resolve_selection_mode(mode, k, max_count) == mode


def test_iter_truncates_above_max_count_and_check_raises(monkeypatch):
    n, t, k, max_count = 16, 2, 16, 3
    r = np.random.default_rng(9)
    mask = np.ones((n, t, k), dtype=bool)
    count = np.full((n, t), 6, dtype=np.int32)
    noise = r.random((n, t, k)).astype(np.float32)
    want = jsel.select_random(jnp.asarray(mask), jnp.asarray(count), None,
                              max_count=max_count, mode="iter",
                              noise=jnp.asarray(noise))
    got = sel.select_random(torch.from_numpy(mask), torch.from_numpy(count),
                            None, max_count=max_count, mode="iter",
                            noise=torch.from_numpy(noise))
    _same(want, got, "iter above max_count")
    assert (got.sum(-1) == max_count).all()        # truncated to the bound
    monkeypatch.setattr(sel, "CHECK_COUNT_BOUND", True)
    with pytest.raises(AssertionError, match="max_count=3"):
        sel.select_random(torch.from_numpy(mask), torch.from_numpy(count),
                          None, max_count=max_count, mode="iter",
                          noise=torch.from_numpy(noise))
    ok = torch.full((n, t), max_count, dtype=torch.int32)
    assert (sel.select_random(torch.from_numpy(mask), ok, None,
                              max_count=max_count, mode="iter",
                              noise=torch.from_numpy(noise)).sum(-1)
            == max_count).all()
