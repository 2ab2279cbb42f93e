"""Parity of the port's subscription churn (ops/churn.py
``churn_subscriptions``, wired into ``engine.step``) and of
``heartbeat.edge_gather``'s indexed branch with the JAX package on the CPU.

- tests/test_sim_engine.py's cache case: 64 peers, 3 topics, the ``dense``
  underlay, leave and join at 0.05 a tick, scoring off, 15 ticks; every
  field after every tick, and ``nbr_subscribed`` equal to its refresh;
- a scoring-on multi-topic case, ``beacon_10k`` at 256 peers with leave
  and join at 0.05, 8 ticks under the port's ``pallas`` and ``mxu``
  gather formulations;
- ``churn_subscriptions`` alone on a mid-run beacon state given fanout
  edges and live backoffs (the join's promote path and its two-sided
  backoff check), under both formulations;
- ``edge_gather`` of int32, float32 and bool planes with fills.

The JAX side runs ``hop_mode="xla"``; its formulations are bit-identical.
Every field is compared exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.ops.churn import \
    churn_subscriptions as jchurn_subscriptions
from go_libp2p_pubsub_tpu.ops.heartbeat import edge_gather as jedge_gather
from go_libp2p_pubsub_tpu.sim import SimConfig as JConfig
from go_libp2p_pubsub_tpu.sim import TopicParams as JTopicParams
from go_libp2p_pubsub_tpu.sim import init_state as jinit_state
from go_libp2p_pubsub_tpu.sim import scenarios as jscenarios
from go_libp2p_pubsub_tpu.sim import topology as jtopology
from go_libp2p_pubsub_tpu.sim.engine import step_jit as jstep
from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.ops.churn import churn_subscriptions
from go_libp2p_pubsub_tpu_torch.ops.heartbeat import edge_gather
from go_libp2p_pubsub_tpu_torch.sim import (SimConfig, TopicParams, init_state,
                                            state_from_reference,
                                            state_to_numpy, step, topology)
from go_libp2p_pubsub_tpu_torch.sim.state import refresh_nbr_subscribed


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


def _trajectory(jcfg, jtp, jst, cfg, tp, st, ticks):
    """Step both packages from PRNGKey(0) as ``engine.run`` splits it,
    every field compared after every tick; the port's last state."""
    jkeys = jax.random.split(jax.random.PRNGKey(0), ticks)
    keys = rng.split(rng.PRNGKey(0, device="cpu"), ticks)
    js = jst
    for i in range(ticks):
        js = jstep(js, cfg=jcfg, tp=jtp, key=jkeys[i])
        st = step(st, cfg, tp, keys[i], device="cpu")
        _assert_equal(_arrays(js), state_to_numpy(st), f"after tick {i}")
    return st


def test_engine_cache_case_equal():
    """tests/test_sim_engine.py:141-153's config, built by both packages."""
    kw = dict(n_peers=64, k_slots=16, n_topics=3, msg_window=16,
              publishers_per_tick=2, prop_substeps=4, scoring_enabled=False,
              sub_join_prob=0.05, sub_leave_prob=0.05)
    sub = np.random.default_rng(0).random((64, 3)) < 0.5
    jcfg = dataclasses.replace(JConfig(**kw), hop_mode="xla")
    jst = jinit_state(jcfg, jtopology.dense(64, 16, degree=10), subscribed=sub)
    cfg = SimConfig(**kw)
    st = init_state(cfg, topology.dense(64, 16, degree=10), subscribed=sub,
                    device="cpu")
    _assert_equal(_arrays(jst), state_to_numpy(st), "initial")
    st0 = st
    st = _trajectory(jcfg, JTopicParams.disabled(3), jst, cfg,
                     TopicParams.disabled(3, device="cpu"), st, 15)
    torch.testing.assert_close(st.nbr_subscribed,
                               refresh_nbr_subscribed(st).nbr_subscribed,
                               rtol=0, atol=0)
    assert not torch.equal(st.subscribed, st0.subscribed)


@pytest.fixture(scope="module")
def beacon():
    jcfg, jtp, jst = jscenarios.beacon_10k(n_peers=256)
    return dataclasses.replace(jcfg, hop_mode="xla", sub_leave_prob=0.05,
                               sub_join_prob=0.05), jtp, jst


@pytest.mark.parametrize("gather", ["pallas", "mxu"])
def test_scoring_multi_topic_churn_equal(beacon, gather):
    jcfg, jtp, jst = beacon
    cfg, tp, st = _port(jcfg, jtp, jst)
    cfg = dataclasses.replace(cfg, hop_mode="auto", edge_gather_mode=gather)
    out = _trajectory(jcfg, jtp, jst, cfg, tp, st, 8)
    # non-vacuous: subscriptions moved both ways, and leaves pruned mesh
    # edges into the unsubscribe backoff
    left = st.subscribed & ~out.subscribed
    joined = ~st.subscribed & out.subscribed
    assert int(left.sum()) > 0 and int(joined.sum()) > 0
    assert int((out.backoff > out.tick).sum()) > 0


@pytest.fixture(scope="module")
def mid(beacon):
    """The reference's churning beacon network after 4 ticks of
    ``engine.run``'s key split (its jitted step, compiled once for this
    config)."""
    jcfg, jtp, js = beacon
    for k in jax.random.split(jax.random.PRNGKey(0), 4):
        js = jstep(js, cfg=jcfg, tp=jtp, key=k)
    return js


@pytest.mark.parametrize("gather", ["pallas", "mxu"])
def test_churn_subscriptions_promotes_fanout_equal(beacon, mid, gather):
    """One Join/Leave round at 0.3 on the beacon network after 4 ticks,
    with random fanout edges on unsubscribed topics and random live
    backoffs, so that the join promotes fanout edges into the mesh and the
    two-sided backoff check refuses some."""
    jcfg, jtp, _ = beacon
    jcfg = dataclasses.replace(jcfg, sub_leave_prob=0.3, sub_join_prob=0.3)
    js = mid
    r = np.random.default_rng(5)
    mesh = np.asarray(js.mesh)
    unsub = ~np.asarray(js.subscribed)
    live = np.asarray(js.connected) & (np.asarray(js.neighbors) >= 0)
    fanout = (r.random(mesh.shape) < 0.3) & unsub[:, :, None] \
        & live[:, None, :]
    tick = int(js.tick)
    backoff = np.where(r.random(mesh.shape) < 0.2, tick + 5,
                       np.asarray(js.backoff)).astype(np.int32)
    js = js._replace(fanout=jnp.asarray(fanout), backoff=jnp.asarray(backoff))
    cfg, tp, st = _port(jcfg, jtp, js)
    cfg = dataclasses.replace(cfg, edge_gather_mode=gather)
    key = rng.PRNGKey(9, device="cpu")
    want = jchurn_subscriptions(js, jcfg, jtp, jax.random.PRNGKey(9))
    got = churn_subscriptions(st, cfg, tp, key)
    _assert_equal(_arrays(want), state_to_numpy(got))
    promoted = np.asarray(want.mesh) & ~mesh
    assert promoted.sum() > 0
    refused = fanout & ~np.asarray(want.mesh) \
        & np.asarray(want.subscribed)[:, :, None]
    assert refused.sum() > 0


FILLS = [("int32", -1), ("int32", 7), ("float32", -1.0), ("float32", np.nan),
         ("bool", True), ("int32", 2.5), ("bool", 3)]


@pytest.mark.parametrize("dtype,fill", FILLS)
def test_edge_gather_indexed_equal(beacon, dtype, fill):
    """The indexed branch of ``edge_gather`` on a state with empty slots:
    the receiver view of an [N, T, K] plane, empty slots reading ``fill``,
    in the reference's output type (a float fill of an int plane gives
    float32, an int fill of a bool plane int32)."""
    jcfg, jtp, jst = beacon
    _, _, st = _port(jcfg, jtp, jst)
    assert int((st.neighbors < 0).sum()) > 0
    r = np.random.default_rng(3)
    shape = np.asarray(jst.mesh).shape
    if dtype == "bool":
        x = r.random(shape) < 0.4
    elif dtype == "int32":
        x = r.integers(-5, 1000, shape, dtype=np.int32)
    else:
        x = r.standard_normal(shape).astype(np.float32)
    want = np.asarray(jedge_gather(jnp.asarray(x), jst, fill=fill))
    got = edge_gather(torch.from_numpy(x), st, fill=fill).numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)
