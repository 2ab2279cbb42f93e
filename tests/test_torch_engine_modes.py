"""Parity of the port's engine entry points and modes (sim/engine.py,
sim/invariants.py) with the JAX package on the CPU.

- ``key_schedule="fold_in"``: ``run`` equal to the reference's, tick by
  tick against the reference's jitted step on ``fold_in(master, tick)``;
  ``run_window`` in chunks (3 + 5, and 1 x 8) equal to one run;
- ``window_keys`` equal to the reference's, and ``run_keys`` over its
  slices equal to ``run``, under both schedules; ``run_keys(...,
  telemetry=True)`` over a slice equal to the reference's lane (state
  exact, records exact but ``score_mean``, rtol 1e-5);
- ``invariant_mode="off"`` writes no flags (the ``delivered_total = -1``
  poison of tests/test_faults.py), in the reference's state;
- ``invariant_mode="raise"``: a clean ``run_checked`` passes in the
  reference's state; a poisoned one (``mesh_failure_penalty[0,0,0] =
  inf``) raises with the reference's violation bits, also through
  ``run_checked_keys``; the plain entry points raise ValueError, as the
  reference's ``run`` does;
- ``decode_flags`` equal to the reference's;
- ``delivery_latency_ticks`` equal to the reference's on
  ``router_sweep_100k`` at 256 peers for each router.

The network is tests/test_faults.py's (64 peers, K = 16, one topic, full
scoring), with ``hop_mode="xla"`` on the JAX side. Every field is compared
exactly."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.sim import SimConfig as JConfig
from go_libp2p_pubsub_tpu.sim import init_state as jinit_state
from go_libp2p_pubsub_tpu.sim import invariants as jinv
from go_libp2p_pubsub_tpu.sim import scenarios as jscenarios
from go_libp2p_pubsub_tpu.sim import topology as jtopology
from go_libp2p_pubsub_tpu.sim import engine as jengine
from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.sim import (SimConfig, TopicParams, engine,
                                            invariants, scenarios,
                                            state_from_reference,
                                            state_to_numpy)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs: the suite
    runs in several worker processes, and intra-op threads beyond the
    cores stall at every small op's barrier (an 8-tick beacon_10k run at
    256 peers on an 8-core host beside five busy processes: 7 s on one
    thread, 233 s on eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TICKS = 8


def _arrays(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def _assert_equal(ref: dict, got: dict, where: str = ""):
    for f, want in ref.items():
        have = got[f]
        assert have.dtype == want.dtype, (f, have.dtype, want.dtype)
        np.testing.assert_array_equal(have, want, err_msg=f"{f} {where}")


def _port(jcfg, jtp, jst):
    return (SimConfig(**dataclasses.asdict(jcfg)),
            TopicParams(*[torch.from_numpy(np.array(x)) for x in jtp]),
            state_from_reference(_arrays(jst), device="cpu"))


def _key(seed=0):
    return rng.PRNGKey(seed, device="cpu")


@pytest.fixture(scope="module")
def net():
    """tests/test_faults.py's ``_cfg()``: (jcfg, jtp, jst)."""
    jcfg = JConfig(n_peers=64, k_slots=16, n_topics=1, msg_window=32,
                   publishers_per_tick=4, prop_substeps=6,
                   scoring_enabled=True, hop_mode="xla")
    jst = jinit_state(jcfg, jtopology.sparse(64, 16, degree=8, seed=7))
    return jcfg, jscenarios.default_topic_params(1), jst


@pytest.fixture(scope="module")
def fold_ref(net):
    """The reference under ``key_schedule="fold_in"``: its per-tick states
    (jitted step on ``fold_in(master, tick)``) and ``engine.run``'s."""
    jcfg, jtp, jst = net
    jcfg = dataclasses.replace(jcfg, key_schedule="fold_in")
    master = jax.random.PRNGKey(3)
    js, ticks = jst, []
    for _ in range(TICKS):
        js = jengine.step_jit(js, cfg=jcfg, tp=jtp,
                              key=jax.random.fold_in(master, js.tick))
        ticks.append(_arrays(js))
    return jcfg, ticks, _arrays(jengine.run(jst, jcfg, jtp, master, TICKS))


def test_fold_in_run_equal(net, fold_ref):
    jcfg, ticks, final = fold_ref
    _assert_equal(final, ticks[-1], "reference run vs its steps")
    cfg, tp, st = _port(jcfg, net[1], net[2])
    st1 = st
    for i in range(TICKS):
        st1 = engine.run_window(st1, cfg, tp, _key(3), 1, device="cpu")
        _assert_equal(ticks[i], state_to_numpy(st1), f"after tick {i}")
    _assert_equal(final, state_to_numpy(
        engine.run(st, cfg, tp, _key(3), TICKS, device="cpu")), "run")
    # the tick key folds the state's tick tensor, as jax.random.fold_in
    for t in (0, 5, 2 ** 31 - 1):
        np.testing.assert_array_equal(
            rng.fold_in(_key(3), torch.tensor(t, dtype=torch.int32)).numpy(),
            np.asarray(jax.random.fold_in(jax.random.PRNGKey(3),
                                          jnp.int32(t))).astype(np.int64))


@pytest.mark.parametrize("chunks", [(3, 5), (1,) * 8, (8,)])
def test_run_window_chunks_equal_one_run(net, fold_ref, chunks):
    jcfg, _, final = fold_ref
    cfg, tp, st = _port(jcfg, net[1], net[2])
    for c in chunks:
        st = engine.run_window(st, cfg, tp, _key(3), c, device="cpu")
    _assert_equal(final, state_to_numpy(st), f"chunks {chunks}")


@pytest.mark.parametrize("schedule", ["host", "fold_in"])
def test_run_keys_over_window_keys_equal_run(net, schedule):
    jcfg, jtp, jst = net
    jcfg = dataclasses.replace(jcfg, key_schedule=schedule)
    cfg, tp, st = _port(jcfg, jtp, jst)
    for lo, hi, start in ((0, 3, 0), (3, 8, 0), (2, 6, 11)):
        want = jengine.window_keys(jcfg, jax.random.PRNGKey(4), start, lo,
                                   hi, TICKS)
        got = engine.window_keys(cfg, _key(4), start, lo, hi, TICKS)
        assert tuple(got.shape) == (hi - lo, 2)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))
    whole = engine.run(st, cfg, tp, _key(4), TICKS, device="cpu")
    out = st
    for lo, hi in ((0, 3), (3, 8)):
        out = engine.run_keys(out, cfg, tp, engine.window_keys(
            cfg, _key(4), 0, lo, hi, TICKS), device="cpu")
    _assert_equal(state_to_numpy(whole), state_to_numpy(out))
    _assert_equal(_arrays(jengine.run(jst, jcfg, jtp, jax.random.PRNGKey(4),
                                      TICKS)), state_to_numpy(whole),
                  "engine.run")
    # telemetry (Queue 1 item 5): the same window with its records, equal
    # to the reference's lane; score_mean is a float32 sum in another
    # reduction order (3.1e-6 relative apart here; rtol 1e-5)
    got, rec = engine.run_keys(st, cfg, tp, engine.window_keys(
        cfg, _key(4), 0, 0, 2, TICKS), telemetry=True, device="cpu")
    want, jrec = jengine.run_keys(jst, jcfg, jtp, jengine.window_keys(
        jcfg, jax.random.PRNGKey(4), 0, 0, 2, TICKS), telemetry=True)
    _assert_equal(_arrays(want), state_to_numpy(got), "telemetry")
    for f in rec._fields:
        a, b = np.asarray(getattr(jrec, f)), getattr(rec, f).numpy()
        if f == "score_mean":
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=0)
        else:
            np.testing.assert_array_equal(b.view(a.dtype), a, err_msg=f)
    with pytest.raises(ValueError, match="key_schedule"):
        engine.run(st, dataclasses.replace(cfg, key_schedule="bogus"), tp,
                   _key(4), 1, device="cpu")


def test_off_mode_writes_no_flags(net):
    """The poison of tests/test_faults.py:315-318 (a negative
    delivered_total), with the lasting one of :326-329 beside it (an
    infinite mesh_failure_penalty): no bit under "off", the nonfinite bit
    under "record", each in the reference's state."""
    jcfg, jtp, jst = net
    bad = jst._replace(delivered_total=jnp.float32(-1.0),
                       mesh_failure_penalty=(
                           jst.mesh_failure_penalty.at[0, 0, 0].set(jnp.inf)))
    for mode, bits in (("off", 0), ("record", jinv.FLAG_NONFINITE)):
        c = dataclasses.replace(jcfg, invariant_mode=mode)
        want = jengine.step_jit(bad, c, jtp, jax.random.PRNGKey(0))
        cfg, tp, st = _port(c, jtp, bad)
        got = engine.step(st, cfg, tp, _key(0), device="cpu")
        _assert_equal(_arrays(want), state_to_numpy(got), mode)
        assert int(got.fault_flags) & bits == bits
        if mode == "off":
            assert int(got.fault_flags) == 0
            out = engine.run(st, cfg, tp, _key(0), 3, device="cpu")
            assert int(out.fault_flags) == 0


def _flags_of(err) -> int:
    return int(re.search(r"fault_flags=(\d+)", str(err)).group(1))


def test_raise_mode_equal(net):
    """run_checked passes a clean run in the reference's state and raises
    on the poison of tests/test_faults.py:326-329 with the reference's
    violation bits; the plain entry points raise ValueError."""
    jcfg, jtp, jst = net
    jcfg = dataclasses.replace(jcfg, invariant_mode="raise")
    cfg, tp, st = _port(jcfg, jtp, jst)
    want = jengine.run_checked(jst, jcfg, jtp, jax.random.PRNGKey(0), 4)
    got = engine.run_checked(st, cfg, tp, _key(0), 4, device="cpu")
    _assert_equal(_arrays(want), state_to_numpy(got), "clean")
    assert int(got.tick) == 4
    # "raise" steps to the "record" state
    rec = engine.run(st, dataclasses.replace(cfg, invariant_mode="record"),
                     tp, _key(0), 4, device="cpu")
    _assert_equal(state_to_numpy(rec), state_to_numpy(got), "record")

    jbad = jst._replace(mesh_failure_penalty=(
        jst.mesh_failure_penalty.at[0, 0, 0].set(jnp.inf)))
    with pytest.raises(ValueError, match="invariant violation") as want:
        jengine.run_checked(jbad, jcfg, jtp, jax.random.PRNGKey(0), 4)
    _, _, bad = _port(jcfg, jtp, jbad)
    with pytest.raises(invariants.InvariantViolation,
                       match=r"^invariant violation: fault_flags=") as got:
        engine.run_checked(bad, cfg, tp, _key(0), 4, device="cpu")
    assert _flags_of(got.value) == _flags_of(want.value) == got.value.flags
    assert got.value.flags == invariants.FLAG_NONFINITE
    assert got.value.tick == 0
    keys = engine.window_keys(cfg, _key(0), 0, 0, 4, 4)
    with pytest.raises(invariants.InvariantViolation) as got_keys:
        engine.run_checked_keys(bad, cfg, tp, keys, device="cpu")
    with pytest.raises(ValueError, match="invariant violation") as want_keys:
        jengine.run_checked_keys(jbad, jcfg, jtp, jnp.asarray(
            keys.numpy().astype(np.uint32)))
    assert _flags_of(got_keys.value) == _flags_of(want_keys.value)

    with pytest.raises(ValueError):
        jengine.run(jst, jcfg, jtp, jax.random.PRNGKey(0), 2)
    for call in (lambda: engine.run(st, cfg, tp, _key(0), 2, device="cpu"),
                 lambda: engine.run_keys(st, cfg, tp, keys, device="cpu"),
                 lambda: engine.run_window(st, cfg, tp, _key(0), 2,
                                           device="cpu")):
        with pytest.raises(ValueError, match="run_checked"):
            call()


WORDS = [0, jinv.FAULT_PARTITION | jinv.FLAG_NONFINITE, 0x3FF,
         jinv.VIOLATION_MASK, 0xFFFFFFFF, 1 << 12, jinv.FLAG_HALO_OVERFLOW]


@pytest.mark.parametrize("word", WORDS)
def test_decode_flags_equal(word):
    assert invariants.decode_flags(word) == jinv.decode_flags(word)
    assert invariants.decode_flags(word, flags_version=2) == \
        jinv.decode_flags(word, flags_version=2)
    with pytest.raises(ValueError) as want:
        jinv.decode_flags(word, flags_version=1)
    with pytest.raises(ValueError) as got:
        invariants.decode_flags(word, flags_version=1)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("router", ["floodsub", "randomsub", "gossipsub"])
def test_delivery_latency_ticks_equal(router):
    """One forwarding hop a tick, so that gossipsub's pulls deliver on later
    ticks (at 8 hops the 256-peer network is reached within the publish
    tick). Floodsub and randomsub forward only in the publish tick, so
    their mean latency is 0 in both packages."""
    jcfg, jtp, jst = jscenarios.router_sweep_100k(router, n_peers=256)
    jcfg = dataclasses.replace(jcfg, hop_mode="xla", prop_substeps=1)
    jout = jengine.run(jst, jcfg, jtp, jax.random.PRNGKey(0), 6)
    cfg, tp, st = scenarios.router_sweep_100k(router, n_peers=256,
                                              device="cpu")
    cfg = dataclasses.replace(cfg, prop_substeps=1)
    out = engine.run(st, cfg, tp, _key(0), 6, device="cpu")
    _assert_equal(_arrays(jout), state_to_numpy(out), router)
    want = np.asarray(jengine.delivery_latency_ticks(jout, jcfg))
    got = engine.delivery_latency_ticks(out, cfg)
    assert got.dtype == torch.float32
    assert (float(got) > 0) == (router == "gossipsub")
    np.testing.assert_array_equal(got.numpy(), want)
    # nothing delivered but the publishers: 0
    assert float(engine.delivery_latency_ticks(st, cfg)) == 0.0
