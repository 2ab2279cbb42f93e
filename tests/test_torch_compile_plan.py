"""The port's engine plane (go_libp2p_pubsub_tpu_torch/parallel/
compile_plan.py) against the JAX package's parallel/compile_plan.py on the
CPU, and the no-host-read guard on the port's step.

- the donation audit and the cache, as tests/test_compile_plan.py:38-66
  and :108-114 run them on the reference: both flavours of
  ``engine_chunk`` and ``engine_window`` (``donated_param_count``), a
  donated executable still computes, the same key gives the same
  executable and a tail chunk its own;
- the port's executables bit-equal, every field, to the reference's
  compiled ones on the same keys, donated and plain, and two chained
  chunks equal to one eager run of both;
- the refusals: ``ops.selection.CHECK_COUNT_BOUND`` (a host read by
  design) and ``invariant_mode="raise"``; ``telemetry=True`` is no longer
  refused: its chunk equals the reference's ``run_keys(telemetry=True)``;
- the telemetry lane and compact storage: donated ``engine_chunk`` and
  ``engine_window`` executables with ``telemetry=True`` under f32 and
  compact storage equal to the eager lanes, state and records, and the
  compact chunk to the reference's;
- the guard: a ``TorchDispatchMode`` that raises on any host read of a
  device value (``aten._local_scalar_dense``, ``item``, ``is_nonzero``,
  ``nonzero``, ``masked_select``) and on a tensor made from host data
  (``lift_fresh``, which on the card is a host-to-device copy), around
  ``step`` on every path the captured chunks run: the headline at 256
  peers fused and non-fused, ``churn_50k(256)`` under ``pallas`` and
  ``mxu``, floodsub, the every-family plan with subscription churn,
  ``frontier(512)`` and a config with P6 on, and around a compact
  ``run_keys(telemetry=True)`` of the headline and of the every-family
  plan; and a config with
  ``opportunistic_graft_ticks=3`` and unsubscribed publishers (fanout),
  whose ungated blocks take both sides of their device gates over 8
  ticks, every field equal to the reference after every tick.

The reference side runs on the CPU; its kernels resolve as its own tests
resolve them there."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from go_libp2p_pubsub_tpu.parallel import compile_plan as jplan
from go_libp2p_pubsub_tpu.sim import SimConfig as JConfig
from go_libp2p_pubsub_tpu.sim import TopicParams as JTopicParams
from go_libp2p_pubsub_tpu.sim import init_state as jinit_state
from go_libp2p_pubsub_tpu.sim import scenarios as jscenarios
from go_libp2p_pubsub_tpu.sim import topology as jtopology
from go_libp2p_pubsub_tpu.sim.engine import run_keys as jrun_keys
from go_libp2p_pubsub_tpu.sim.engine import step_jit as jstep
from go_libp2p_pubsub_tpu.sim.state import encode_state as jencode
from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.ops import selection
from go_libp2p_pubsub_tpu_torch.parallel import compile_plan
from go_libp2p_pubsub_tpu_torch.sim import hostio
from go_libp2p_pubsub_tpu_torch.sim import (SimConfig, TopicParams,
                                            build_headline, faults,
                                            run_keys, run_window, scenarios,
                                            state_from_reference,
                                            state_to_numpy, step)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs (the
    suite runs in several worker processes; see
    tests/test_torch_engine_modes.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def _assert_equal(ref: dict, got: dict, where: str = ""):
    for f, want in ref.items():
        have = got[f]
        assert have.dtype == want.dtype, (f, have.dtype, want.dtype)
        np.testing.assert_array_equal(have, want, err_msg=f"{f} {where}")


def _assert_records(jrec, rec, where=""):
    """Health records equal to the reference's: exact in every column but
    score_mean, a float32 sum in another reduction order: XLA's CPU
    reduce-window blocks against torch's cascade sum differ by up to
    3.1e-6 relative at 1024 terms, within the float32 summation bound
    (rtol 1e-5)."""
    for f in rec._fields:
        want = np.asarray(getattr(jrec, f))
        have = hostio.fetch_local(getattr(rec, f), want.dtype)
        assert have.shape == want.shape, (f, have.shape, want.shape)
        if f == "score_mean":
            np.testing.assert_allclose(have, want, rtol=1e-5, atol=0,
                                       err_msg=f"{f} {where}")
        else:
            np.testing.assert_array_equal(have, want, err_msg=f"{f} {where}")


def _port(jcfg, jtp, jst):
    return (SimConfig(**dataclasses.asdict(jcfg)),
            TopicParams(*[torch.from_numpy(np.array(x)) for x in jtp]),
            state_from_reference(_arrays(jst), device="cpu"))


def _copy(st):
    return type(st)(*(x.clone() for x in st))


@pytest.fixture(scope="module")
def tiny():
    """tests/test_compile_plan.py's network, on both sides: 64 peers,
    K = 8, one topic, scoring on, 5 ticks' keys."""
    jcfg = JConfig(n_peers=64, k_slots=8, n_topics=1, msg_window=32,
                   publishers_per_tick=2, prop_substeps=4,
                   scoring_enabled=True)
    jtp = JTopicParams.disabled(1)
    jst = jinit_state(jcfg, jtopology.sparse(64, 8, degree=3))
    cfg, tp, st = _port(jcfg, jtp, jst)
    keys = rng.split(rng.PRNGKey(0, device="cpu"), 5)
    jkeys = jax.random.split(jax.random.PRNGKey(0), 5)
    np.testing.assert_array_equal(np.asarray(jkeys).astype(np.int64),
                                  keys.numpy())
    yield (jcfg, jtp, jst, jkeys), (cfg, tp, st, keys)
    compile_plan.clear_caches()


def _fold(cfg):
    return dataclasses.replace(cfg, key_schedule="fold_in")


# --- the donation audit and the cache --------------------------------------

@pytest.mark.parametrize("schedule", ["chunk", "window"])
def test_flavours_report_their_donation(tiny, schedule):
    _, (cfg, tp, st, keys) = tiny
    if schedule == "chunk":
        donating = compile_plan.engine_chunk(cfg, st, tp, keys, donate=True)
        plain = compile_plan.engine_chunk(cfg, st, tp, keys, donate=False)
    else:
        key = rng.PRNGKey(0, device="cpu")
        donating = compile_plan.engine_window(_fold(cfg), st, tp, key, 5,
                                              donate=True)
        plain = compile_plan.engine_window(_fold(cfg), st, tp, key, 5,
                                           donate=False)
    assert compile_plan.donated_param_count(donating) >= 1
    assert compile_plan.donated_param_count(plain) == 0


def test_donated_executable_still_computes(tiny):
    """Donation changes buffer ownership, not the trajectory: the donated
    flavour (fed a copy it may consume) equals run_keys."""
    _, (cfg, tp, st, keys) = tiny
    ref = run_keys(st, cfg, tp, keys, device="cpu")
    exe = compile_plan.engine_chunk(cfg, st, tp, keys, donate=True)
    _assert_equal(state_to_numpy(ref), state_to_numpy(exe(_copy(st), tp,
                                                          keys)))


def test_cache_reuses_executables(tiny):
    _, (cfg, tp, st, keys) = tiny
    a = compile_plan.engine_chunk(cfg, st, tp, keys)
    assert compile_plan.engine_chunk(cfg, st, tp, keys) is a
    tail = compile_plan.engine_chunk(cfg, st, tp, keys[:3])
    assert tail is not a                  # a tail chunk is its own entry
    assert compile_plan.engine_chunk(cfg, st, tp, keys[:3]) is tail
    assert compile_plan.engine_chunk(cfg, st, tp, keys, donate=True) is not a
    key = rng.PRNGKey(0, device="cpu")
    w = compile_plan.engine_window(_fold(cfg), st, tp, key, 5)
    assert compile_plan.engine_window(_fold(cfg), st, tp, key, 5) is w
    assert compile_plan.engine_window(_fold(cfg), st, tp, key, 3) is not w
    with pytest.raises(ValueError, match="keys of shape"):
        a(st, tp, keys[:3])


# --- bit-equal to the reference's executables ------------------------------

@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("schedule", ["chunk", "window"])
def test_executables_equal_the_reference(tiny, schedule, donate):
    (jcfg, jtp, jst, jkeys), (cfg, tp, st, keys) = tiny
    if schedule == "chunk":
        jexe = jplan.engine_chunk(jcfg, jst, jtp, jkeys, donate=donate)
        want = jexe(jax.tree.map(jnp.copy, jst), jtp, jkeys)
        exe = compile_plan.engine_chunk(cfg, st, tp, keys, donate=donate)
        got = exe(_copy(st), tp, keys)
    else:
        jexe = jplan.engine_window(_fold(jcfg), jst, jtp,
                                   jax.random.PRNGKey(3), 5, donate=donate)
        want = jexe(jax.tree.map(jnp.copy, jst), jtp, jax.random.PRNGKey(3))
        exe = compile_plan.engine_window(_fold(cfg), st, tp,
                                         rng.PRNGKey(3, device="cpu"), 5,
                                         donate=donate)
        got = exe(_copy(st), tp, rng.PRNGKey(3, device="cpu"))
    _assert_equal(_arrays(want), state_to_numpy(got), f"{schedule}")
    assert int(got.tick) == int(st.tick) + 5


@pytest.mark.parametrize("schedule", ["chunk", "window"])
def test_chained_chunks_equal_one_run(tiny, schedule):
    """Two donated chunks, the second fed the first's result, land on the
    eager run of both chunks' ticks: no tick's draws repeat."""
    _, (cfg, tp, st, _) = tiny
    if schedule == "chunk":
        keys = rng.split(rng.PRNGKey(5, device="cpu"), 8)
        exe = compile_plan.engine_chunk(cfg, st, tp, keys[:4], donate=True)
        got = exe(exe(_copy(st), tp, keys[:4]), tp, keys[4:])
        want = run_keys(st, cfg, tp, keys, device="cpu")
    else:
        key = rng.PRNGKey(5, device="cpu")
        exe = compile_plan.engine_window(_fold(cfg), st, tp, key, 4,
                                         donate=True)
        got = exe(exe(_copy(st), tp, key), tp, key)
        want = run_window(st, _fold(cfg), tp, key, 8, device="cpu")
        once = exe(_copy(st), tp, key)
        assert not torch.equal(once.have, got.have)
    _assert_equal(state_to_numpy(want), state_to_numpy(got))


def test_refusals(tiny, monkeypatch):
    (jcfg, jtp, jst, jkeys), (cfg, tp, st, keys) = tiny
    # telemetry (Queue 1 item 5) is no longer refused: the chunk's state
    # and records equal the reference's run_keys(telemetry=True)
    got, rec = compile_plan.engine_chunk(cfg, st, tp, keys,
                                         telemetry=True)(st, tp, keys)
    want, jrec = jrun_keys(jst, jcfg, jtp, jkeys, telemetry=True)
    _assert_equal(_arrays(want), state_to_numpy(got))
    _assert_records(jrec, rec)
    with pytest.raises(ValueError, match="raise"):
        compile_plan.engine_chunk(
            dataclasses.replace(cfg, invariant_mode="raise"), st, tp, keys)
    monkeypatch.setattr(selection, "CHECK_COUNT_BOUND", True)
    with pytest.raises(ValueError, match="CHECK_COUNT_BOUND"):
        compile_plan.engine_chunk(dataclasses.replace(cfg, prop_substeps=3),
                                  st, tp, keys)
    with pytest.raises(ValueError, match="host"):
        compile_plan.engine_window(_fold(cfg), st, tp,
                                   rng.PRNGKey(0, device="cpu"), 2)


# --- the telemetry lane and compact storage in the executables -------------

def _compact(cfg, st):
    from go_libp2p_pubsub_tpu_torch.sim import encode_state
    cfg = dataclasses.replace(cfg, state_precision="compact")
    return cfg, encode_state(st, cfg)


@pytest.mark.parametrize("precision", ["f32", "compact"])
@pytest.mark.parametrize("schedule", ["chunk", "window"])
def test_telemetry_chunks_equal_the_eager_lane(tiny, schedule, precision):
    """``telemetry=True`` executables, donated, on either storage layout:
    state and records equal to the eager lane (``run_keys`` /
    ``run_window`` with ``telemetry=True``), and a compact chunk's equal
    to the reference's ``run_keys(telemetry=True)``."""
    (jcfg, jtp, jst, jkeys), (cfg, tp, st, keys) = tiny
    if precision == "compact":
        cfg, st = _compact(cfg, st)
    if schedule == "chunk":
        exe = compile_plan.engine_chunk(cfg, st, tp, keys, telemetry=True,
                                        donate=True)
        got, rec = exe(_copy(st), tp, keys)
        want, wrec = run_keys(st, cfg, tp, keys, telemetry=True,
                              device="cpu")
    else:
        key = rng.PRNGKey(3, device="cpu")
        exe = compile_plan.engine_window(_fold(cfg), st, tp, key, 5,
                                         telemetry=True, donate=True)
        got, rec = exe(_copy(st), tp, key)
        want, wrec = run_window(st, _fold(cfg), tp, key, 5, telemetry=True,
                                device="cpu")
    _assert_equal(state_to_numpy(want), state_to_numpy(got))
    for f, a, b in zip(rec._fields, wrec, rec):
        assert a.shape[0] == 5 and torch.equal(a, b), f
    if precision == "compact" and schedule == "chunk":
        jcfg = dataclasses.replace(jcfg, state_precision="compact")
        jwant, jrec = jrun_keys(jencode(jst, jcfg), jcfg, jtp, jkeys,
                                telemetry=True)
        _assert_equal(_arrays(jwant), state_to_numpy(got))
        _assert_records(jrec, rec)
        assert got.mesh.dtype == torch.int32


# --- the no-host-read guard -------------------------------------------------

# a host read of a device value (each one a device sync on the card), and
# a tensor made from host data (on the card, a host-to-device copy)
HOST_OPS = frozenset({"_local_scalar_dense", "item", "is_nonzero", "nonzero",
                      "masked_select", "lift_fresh", "lift_fresh_copy"})


class NoHostRead(TorchDispatchMode):
    """Raises at the first operator of :data:`HOST_OPS`."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in HOST_OPS:
            raise AssertionError(f"host read inside the step: aten.{name}")
        return func(*args, **(kwargs or {}))


EVERY_FAMILY = ("drop=0.1,dup=0.2,corrupt=0.3,partition=2@1:4,"
                "outage=0.2@2:5,eclipse=0.1@3:6,censor=0.4x9@1:7,"
                "storm=4x0.9x0@2:5,slowlink=0.3@3:0.1,wave=0.25@4:2:8,seed=3")


def _guard_case(case):
    if case.startswith("headline"):
        cfg, tp, st = build_headline(256, device="cpu")
        if case == "headline, non-fused":
            cfg = dataclasses.replace(cfg, hop_mode="xla")
        return cfg, tp, st, 2
    if case.startswith("churn_50k"):
        cfg, tp, st = scenarios.churn_50k(n_peers=256, device="cpu")
        gather = case.split(", ")[1]
        return (dataclasses.replace(cfg, hop_mode="xla",
                                    edge_gather_mode=gather), tp, st, 2)
    if case == "floodsub":
        return (*scenarios.router_sweep_100k("floodsub", n_peers=256,
                                             device="cpu"), 2)
    if case == "every family, subscription churn":
        cfg, tp, st = scenarios.partition_small(n_peers=256, device="cpu")
        mal = np.zeros(256, bool)
        mal[np.random.default_rng(1).choice(256, 20, replace=False)] = True
        cfg = dataclasses.replace(
            cfg, fault_plan=faults.FaultPlan.parse(EVERY_FAMILY),
            sub_leave_prob=0.05, sub_join_prob=0.05)
        return cfg, tp, st._replace(malicious=torch.from_numpy(mal)), 6
    if case == "frontier":
        return (*scenarios.frontier(512, device="cpu"), 2)
    assert case == "P6"
    cfg, tp, st = scenarios.sybil_small(n_peers=256, device="cpu")
    assert cfg.ip_colocation_factor_weight != 0.0
    return cfg, tp, st, 2


@pytest.mark.parametrize("case", [
    "headline, fused", "headline, non-fused", "churn_50k, pallas",
    "churn_50k, mxu", "floodsub", "every family, subscription churn",
    "frontier", "P6"])
def test_step_reads_nothing_on_the_host(case):
    cfg, tp, st, ticks = _guard_case(case)
    keys = rng.split(rng.PRNGKey(0, device="cpu"), ticks)
    with NoHostRead():
        for i in range(ticks):
            st = step(st, cfg, tp, keys[i], device="cpu")
    assert int(st.tick) == ticks


@pytest.mark.parametrize("case", ["headline, fused",
                                  "every family, subscription churn"])
def test_compact_telemetry_lane_reads_nothing_on_the_host(case):
    """The health records and the compact codecs add no host read: a
    compact ``run_keys(telemetry=True)`` under the guard."""
    cfg, tp, st, ticks = _guard_case(case)
    cfg, st = _compact(cfg, st)
    keys = rng.split(rng.PRNGKey(0, device="cpu"), ticks)
    with NoHostRead():
        st, rec = run_keys(st, cfg, tp, keys, telemetry=True, device="cpu")
    assert int(st.tick) == ticks and rec.tick.shape == (ticks,)


def test_guard_catches_a_host_read():
    """Non-vacuous: the guard raises on a bool() of a tensor and on a
    tensor made from host data."""
    x = torch.ones(3)
    with pytest.raises(AssertionError, match="_local_scalar_dense|is_nonzero"):
        with NoHostRead():
            bool(x.any())
    with pytest.raises(AssertionError, match="lift_fresh"):
        with NoHostRead():
            torch.tensor(1.0)


@pytest.fixture(scope="module")
def gated():
    """256 peers, one topic, full scoring with spread app scores (P5),
    opportunistic grafting every 3 ticks against a threshold every mesh
    falls under, and a quarter of the peers subscribed to nothing (they
    publish through fanout, whose TTL of 3 ticks lets rows expire): the
    reference's run, tick by tick."""
    n = 256
    jcfg = JConfig(n_peers=n, k_slots=16, n_topics=1, msg_window=32,
                   publishers_per_tick=8, prop_substeps=4,
                   scoring_enabled=True, opportunistic_graft_ticks=3,
                   opportunistic_graft_threshold=50.0, fanout_ttl_ticks=3,
                   app_specific_weight=1.0, hop_mode="xla")
    sub = np.ones((n, 1), bool)
    sub[np.random.default_rng(2).choice(n, n // 4, replace=False)] = False
    # app scores spread so that some non-mesh neighbours score above a
    # mesh's median: the opportunistic block has peers to graft
    app = np.random.default_rng(3).uniform(0, 10, n).astype(np.float32)
    jtp = jscenarios.default_topic_params(1)
    jst = jinit_state(jcfg, jtopology.sparse(n, 16, degree=12),
                      subscribed=sub, app_score=app)
    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    ticks, st = [], jst
    for i in range(8):
        st = jstep(st, cfg=jcfg, tp=jtp, key=keys[i])
        ticks.append(_arrays(st))
    return jcfg, jtp, jst, ticks


@pytest.mark.parametrize("hop", ["pallas", "xla"])
def test_ungated_blocks_take_both_sides(gated, hop):
    """The opportunistic-graft and fanout blocks run every tick on their
    device gates; every field equals the reference after every tick, under
    the guard, on the fused and the non-fused hop."""
    jcfg, jtp, jst, ticks = gated
    cfg, tp, st = _port(jcfg, jtp, jst)
    cfg = dataclasses.replace(cfg, hop_mode=hop)
    keys = rng.split(rng.PRNGKey(0, device="cpu"), 8)
    fanout_rows = []
    with NoHostRead():
        for i, want in enumerate(ticks):
            st = step(st, cfg, tp, keys[i], device="cpu")
            _assert_equal(want, state_to_numpy(st), f"after tick {i}")
            fanout_rows.append(st.fanout.any(-1).sum())
    # fanout live on some ticks (the block selects) and some rows not
    assert 0 < max(int(r) for r in fanout_rows) < 256


def test_opportunistic_graft_gate_takes_both_sides(gated):
    """Off the graft tick the block selects nothing: a run grafting every
    1000 ticks agrees with the every-3 run through ticks 0-2 and differs
    after tick 3, where only the every-3 run grafts."""
    jcfg, jtp, jst, ticks = gated
    cfg, tp, st = _port(jcfg, jtp, jst)
    rare = dataclasses.replace(cfg, opportunistic_graft_ticks=1000)
    keys = rng.split(rng.PRNGKey(0, device="cpu"), 4)
    a, b = st, st
    for i in range(4):
        a = step(a, cfg, tp, keys[i], device="cpu")
        b = step(b, rare, tp, keys[i], device="cpu")
        same = torch.equal(a.mesh, b.mesh)
        assert same == (i < 3), f"tick {i}"


def test_retired_executable_outlives_the_thread_that_holds_it():
    """A CUDA graph freed while another capture runs invalidates that
    capture. An executable retired while a thread the watchdog abandoned
    still holds it stays alive until that thread has ended and a reap runs
    (before a capture, or in ``clear_caches``), so the thread's end never
    frees it."""
    import threading
    import weakref

    class Exe:
        calls = 0

    exe = Exe()
    ref = weakref.ref(exe)
    go = threading.Event()
    holder = threading.Thread(target=lambda e=exe: go.wait(), daemon=True)
    holder.start()
    compile_plan.retire(exe, holder=holder)
    assert exe.calls == 1
    del exe
    compile_plan.clear_caches()         # the holder still runs: kept
    assert ref() is not None
    go.set()
    holder.join(10)
    assert not holder.is_alive()
    assert ref() is not None            # ended, not reaped yet
    compile_plan.clear_caches()
    assert ref() is None
