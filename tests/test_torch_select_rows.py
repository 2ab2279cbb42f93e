"""The heartbeat's selections (ops/selection.py) on the CPU.

- The wrappers' CPU route (the plain twins) against ``ranks_desc`` and the
  JAX package's ``select_random``, ``select_top`` and ``masked_median``
  under ``"ranks"``, exactly: a peer group's rows (``row0`` > 0) of the
  reference's whole draw, counts below 0, at 0 and above K, all-masked and
  empty rows, tied keys, the ``noise=`` substitution, medians of NaN and
  signed zeros.
- The kernel route (csrc/select_rows.cu) with ``cudalib.launch`` stubbed:
  the arguments each wrapper passes (the mode, the rows of every leading
  axis, the expanded [rows] counts, the values plane and its ``rep``, the
  counter base's two 32-bit halves) are recorded and checked, and the
  stub answers what they ask for through the plain twins, so each call
  equals its plain twin at every K regime of the kernel's slots per lane,
  on fleet-shaped inputs and at ``row0`` > 0, and one engine tick through
  it equals the plain tick with exactly 10 launches. The kernel's own
  arithmetic is held to the plain twins on the card by
  tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.ops import selection as jsel
from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.ops import cudalib
from go_libp2p_pubsub_tpu_torch.ops import selection as sel
from go_libp2p_pubsub_tpu_torch.parallel import kernel_context as kc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs (several
    worker processes share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- inputs -------------------------------------------------------------------

def _inputs(seed, lead, k):
    """mask, count, noise, score of ``lead + (k,)``: the first rows all
    masked, then none masked; counts from -3 to K + 3 with the first rows'
    -1, 0, K, K + 5; keys from 4 values, so rows hold exact ties."""
    r = np.random.default_rng(seed)
    shape = tuple(lead) + (k,)
    mask = r.random(shape) < 0.6
    flat = mask.reshape(-1, k)
    flat[0], flat[1] = True, False
    count = r.integers(-3, k + 4, size=lead).astype(np.int64)
    cflat = count.reshape(-1)
    cflat[:6] = [k, 3, -1, 0, k, k + 5][:cflat.size]
    noise = (r.integers(0, 4, size=shape) / 4).astype(np.float32)
    score = (r.integers(0, 4, size=shape) / 4 * 10 - 5).astype(np.float32)
    return mask, count, noise, score


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (what, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


# --- the plain route against the reference ------------------------------------

@pytest.mark.parametrize("n,t,k,row0", [(24, 1, 5, 0), (16, 4, 32, 0),
                                        (12, 2, 33, 5), (8, 1, 48, 3)])
def test_plain_route_equals_reference(n, t, k, row0, monkeypatch):
    """CPU selections equal ``ranks_desc``'s and the reference's; at
    ``row0`` > 0 the port's rows [row0, row0 + n) of a peer group draw the
    reference's whole draw's rows."""
    rows = row0 + n
    mask, count, noise, score = _inputs(k + t, (rows, t), k)
    jkey = jax.random.PRNGKey(11)
    want = np.asarray(jsel.select_random(
        jnp.asarray(mask), jnp.asarray(count), jkey, mode="ranks"))[row0:]
    monkeypatch.setattr(kc, "row0", lambda: row0)
    m, c = torch.from_numpy(mask[row0:]), torch.from_numpy(count[row0:])
    got = sel.select_random(m, c, rng.PRNGKey(11, device="cpu"))
    _same(got, want, "select_random drawn")
    drawn = rng.uniform(rng.PRNGKey(11, device="cpu"), (n, t, k), row0=row0)
    keys = torch.where(m, drawn, torch.full_like(drawn, sel.NEG_INF))
    _same(got, (sel.ranks_desc(keys) < c[..., None]) & m, "ranks_desc")

    j = (jnp.asarray(mask), jnp.asarray(count))
    _same(sel.select_random(torch.from_numpy(mask), torch.from_numpy(count),
                            None, noise=torch.from_numpy(noise)),
          jsel.select_random(*j, None, mode="ranks",
                             noise=jnp.asarray(noise)), "noise")
    _same(sel.select_top(torch.from_numpy(score), torch.from_numpy(mask),
                         torch.from_numpy(count)),
          jsel.select_top(jnp.asarray(score), *j, mode="ranks"), "top")
    vals = score.copy()
    vals.reshape(-1, k)[0, :3] = [np.nan, -0.0, 0.0]
    vals.reshape(-1, k)[2, ::2] = np.nan
    _same(sel.masked_median(torch.from_numpy(vals), torch.from_numpy(mask)),
          jsel.masked_median(jnp.asarray(vals), jnp.asarray(mask)), "median")


# --- the kernel route, its launch stubbed ------------------------------------

M32 = 0xFFFFFFFF


def _launch_contract(m8, cnt, key, plane, out, rows, k, rep, base_hi,
                     base_lo, mode):
    """What one launch of csrc/select_rows.cu is asked for, computed by the
    plain twins from its arguments as the kernel reads them: row ``r`` of
    the [rows, K] mask and counts, row ``r // rep`` of the values plane,
    the draw at counter ``base + r * K + s``, ``base`` from its two 32-bit
    halves. The kernel's own arithmetic is held to the plain twins on the
    card (tests/test_torch_cuda.py)."""
    mask = m8.view(torch.bool).reshape(rows, k)
    if mode == sel.KERNEL_MODES["median"]:
        vals = plane.reshape(-1, k).repeat_interleave(rep, 0)
        res = sel.masked_median_plain(vals, mask)
    elif mode == sel.KERNEL_MODES["top"]:
        vals = plane.reshape(-1, k).repeat_interleave(rep, 0)
        res = sel.select_top_plain(vals, mask, cnt.reshape(rows))
    else:
        if mode == sel.KERNEL_MODES["random"]:
            base = ((base_hi & M32) << 32) | (base_lo & M32)
            assert base % k == 0, (base, k)
            noise = rng.uniform(key, (rows, k), row0=base // k)
        else:
            assert rep == 1, rep
            noise = plane.reshape(rows, k)
        res = sel.select_random_plain(mask, cnt.reshape(rows), None,
                                      noise=noise)
    out.copy_(res.reshape(out.shape))


@pytest.fixture
def kernel_route(monkeypatch):
    """The selections' kernel route on the CPU: ``use_kernel`` says yes for
    select_rows alone, the argument check without its device test, and
    ``launch`` records its arguments, counts the launch and fills the
    output by :func:`_launch_contract`. Yields the recorded launches."""
    use = cudalib.use_kernel
    calls = []

    def use_kernel(name, *ts):
        return True if name == "select_rows" else use(name, *ts)

    def check_args(name, specs):
        for label, t, dtype, shape in specs:
            assert t.is_contiguous(), (name, label)
            assert t.dtype == dtype and tuple(t.shape) == tuple(shape), \
                (name, label, t.dtype, tuple(t.shape), dtype, shape)

    def launch(name, *args):
        assert name == "select_rows", name
        m8, cnt, key, plane, out, rows, k, rep, hi, lo, mode = args
        calls.append(dict(mode=mode, rows=rows, k=k, rep=rep,
                          base=((hi & M32) << 32) | (lo & M32),
                          count=None if isinstance(cnt, int)
                          else tuple(cnt.shape),
                          plane=None if isinstance(plane, int)
                          else tuple(plane.shape)))
        _launch_contract(*args)
        cudalib.LAUNCHES[name] += 1

    monkeypatch.setattr(cudalib, "use_kernel", use_kernel)
    monkeypatch.setattr(cudalib, "check_args", check_args)
    monkeypatch.setattr(cudalib, "launch", launch)
    cudalib.reset_launches()
    yield calls
    cudalib.reset_launches()


def _both(fn, plain):
    """(kernel route, plain twin)."""
    before = cudalib.LAUNCHES["select_rows"]
    got = fn()
    assert cudalib.LAUNCHES["select_rows"] == before + 1
    return got, plain()


@pytest.mark.parametrize("lead,k", [((40, 1), 1), ((24, 4), 5),
                                    ((16, 4), 31), ((16, 4), 32),
                                    ((16, 1), 33), ((8, 4), 48),
                                    ((3, 8, 2), 64), ((4, 2), 1000)])
def test_kernel_route_passes_each_mode_its_rows(lead, k, kernel_route):
    """Each mode's launch gets the rows of every leading axis, an int64
    count of the leading shape (a scalar count filled), the key or a
    contiguous values plane, and ``rep`` = T for a score broadcast over
    the topic axis as the heartbeat passes it (its [.., 1, K] rows, not T
    copies), 1 otherwise; what the arguments ask for equals the plain
    twin, at K of 1 to 32 slots a lane and on a fleet's [B, N, T, K]."""
    mask, count, noise, score = _inputs(k, lead, k)
    m, c = torch.from_numpy(mask), torch.from_numpy(count)
    rows, t = int(np.prod(lead)), lead[-1]
    key = rng.PRNGKey(2 ** 32 - 3, device="cpu")
    got, want = _both(lambda: sel.select_random(m, c, key),
                      lambda: sel.select_random_plain(m, c, key))
    _same(got, want, "random")
    nz = torch.from_numpy(noise)
    got, want = _both(lambda: sel.select_random(m, c, None, noise=nz),
                      lambda: sel.select_random_plain(m, c, None, noise=nz))
    _same(got, want, "noise")
    sb = torch.from_numpy(score[..., :1, :]).expand(m.shape)
    for sc, what in ((torch.from_numpy(score), "top"), (sb, "top, broadcast")):
        got, want = _both(lambda: sel.select_top(sc, m, 3),
                          lambda: sel.select_top_plain(sc, m, 3))
        _same(got, want, what)
        got, want = _both(lambda: sel.select_top(sc, m, c),
                          lambda: sel.select_top_plain(sc, m, c))
        _same(got, want, what + ", counts")
    vals = score.copy()
    vals.reshape(-1, k)[0, :3] = [np.nan, -0.0, 0.0][:k]
    vals.reshape(-1, k)[2, ::2] = np.nan
    for v, what in ((torch.from_numpy(vals), "median"),
                    (sb, "median, broadcast")):
        got, want = _both(lambda: sel.masked_median(v, m),
                          lambda: sel.masked_median_plain(v, m))
        _same(got, want, what)
    modes, full, lead = sel.KERNEL_MODES, (*lead, k), tuple(lead)
    # a score broadcast over T > 1 topics goes as its [.., K] rows
    rep, plane = (t, (*lead[:-1], k)) if t > 1 else (1, full)
    assert [(x["mode"], x["rep"], x["count"], x["plane"])
            for x in kernel_route] == [
        (modes["random"], 1, lead, None), (modes["noise"], 1, lead, full),
        (modes["top"], 1, lead, full), (modes["top"], 1, lead, full),
        (modes["top"], rep, lead, plane), (modes["top"], rep, lead, plane),
        (modes["median"], 1, None, full), (modes["median"], rep, None, plane)]
    assert all(x["rows"] == rows and x["k"] == k and x["base"] == 0
               for x in kernel_route)


def test_kernel_route_draws_a_peer_groups_rows(kernel_route, monkeypatch):
    """At ``row0`` > 0 the launch's counter base is ``row0 * T * K``, in
    two 32-bit halves (the high one nonzero for the second group), and
    asks for the plain twin's rows of the group's draw."""
    mask, count, _, _ = _inputs(7, (6, 2), 40)
    m, c = torch.from_numpy(mask), torch.from_numpy(count)
    key = rng.PRNGKey(1234567, device="cpu")
    for row0 in (3, (1 << 32) // 80 + 1):
        monkeypatch.setattr(kc, "row0", lambda r=row0: r)
        got, want = _both(lambda: sel.select_random(m, c, key),
                          lambda: sel.select_random_plain(m, c, key))
        _same(got, want, f"row0={row0}")
    assert [x["base"] for x in kernel_route] == [3 * 80,
                                                 ((1 << 32) // 80 + 1) * 80]
    assert kernel_route[1]["base"] >> 32 == 1


def test_other_formulations_and_big_k_stay_off_the_kernel(kernel_route):
    """``"sort"`` and bounded ``"iter"`` keep their torch code on the
    kernel's route; a K above the kernel's 1024 slots is refused."""
    mask, count, noise, _ = _inputs(3, (8, 2), 16)
    m, c = torch.from_numpy(mask), torch.from_numpy(count).clamp(max=4)
    key = rng.PRNGKey(0, device="cpu")
    for mode, bound in (("sort", None), ("iter", 4)):
        got = sel.select_random(m, c, key, max_count=bound, mode=mode)
        _same(got, sel.select_random_plain(m, c, key, max_count=bound),
              mode)
    assert cudalib.LAUNCHES["select_rows"] == 0
    wide = torch.ones((2, 1, 1025), dtype=torch.bool)
    with pytest.raises(ValueError, match="K=1025"):
        sel.select_random(wide, 3, key)


def test_engine_tick_through_the_kernel_route(kernel_route, monkeypatch):
    """One headline tick with the selections on the stubbed launch equals
    the plain tick in every field, with exactly 10 launches: 8 random, 1
    top, 1 median."""
    from go_libp2p_pubsub_tpu_torch.sim import (build_headline, scenarios,
                                                state_to_numpy, step,
                                                topology)
    topo = topology.sparse(256, 32, degree=12, seed=scenarios.SEED)
    cfg, tp, st = build_headline(256, device="cpu", topo=topo)
    key = rng.PRNGKey(5, device="cpu")
    got = state_to_numpy(step(st, cfg, tp, key, device="cpu"))
    assert cudalib.LAUNCHES["select_rows"] == 10
    modes = [x["mode"] for x in kernel_route]
    assert sorted(modes) == [sel.KERNEL_MODES["random"]] * 8 + [
        sel.KERNEL_MODES["top"], sel.KERNEL_MODES["median"]], modes
    monkeypatch.setattr(cudalib, "use_kernel", lambda name, *ts: False)
    want = state_to_numpy(step(st, cfg, tp, key, device="cpu"))
    assert cudalib.LAUNCHES["select_rows"] == 10
    for f, a in want.items():
        np.testing.assert_array_equal(got[f], a, err_msg=f)
