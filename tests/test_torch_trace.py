"""Parity of the port's trace plane (go_libp2p_pubsub_tpu_torch/trace/,
ops/score_ops.decay_counters and sim/trace_export.py) with the JAX
package's on the CPU.

- ``decay_counters`` bit-equal on a state with live counters;
- ``replay`` against the reference's jitted ``lax.scan``/``lax.switch``
  replay on one stream per op code (each of the 14, on a 48-peer, 2-topic
  state that three engine ticks left with live counters and meshes; peers
  drawn from the observer's neighbors and outside them, indices negative
  and out of range), on out-of-range op codes (``lax.switch``'s clamp),
  on a mixed stream, and on a trace recorded by the reference's
  pure-Python router runtime (tests/test_trace_replay.py's network,
  tensorized by both packages' ``tensorize_trace``) and by the port's
  own runtime on its own ``from_hosts`` underlay (the same events, the
  same feed); every field exact, and the input state unchanged;
- ``run_traced``'s events and health rows against the reference's at 128
  peers (4 ticks, ``single_topic_1k`` with provenance; ``score_mean`` to
  rtol 1e-5, the column sim/telemetry.py settles as not exact), its final
  state exact, and the exported events replayed into a fresh state by
  both packages.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.ops.score_ops import decay_counters as jdecay
from go_libp2p_pubsub_tpu.sim import SimConfig as JConfig
from go_libp2p_pubsub_tpu.sim import init_state as jinit_state
from go_libp2p_pubsub_tpu.sim import scenarios as jscenarios
from go_libp2p_pubsub_tpu.sim import topology as jtopology
from go_libp2p_pubsub_tpu.sim.engine import run as jrun
from go_libp2p_pubsub_tpu.sim.trace_export import run_traced as jrun_traced
from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.ops.score_ops import decay_counters
from go_libp2p_pubsub_tpu_torch.sim import (SimConfig, TopicParams,
                                            scenarios, state_from_reference,
                                            state_to_numpy)
from go_libp2p_pubsub_tpu_torch.sim.topology import Topology, from_hosts
from go_libp2p_pubsub_tpu_torch.sim.trace_export import run_traced

from test_torch_runtime import load_test_module
from test_trace_replay import DUP_WINDOW, T_END, TOPIC, TSP, run_traced_network

# the modules (each package's trace/__init__ re-exports the function
# ``replay`` under the module's name)
jreplay_mod = importlib.import_module("go_libp2p_pubsub_tpu.trace.replay")
replay_mod = importlib.import_module("go_libp2p_pubsub_tpu_torch.trace.replay")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs (the
    suite runs in several worker processes; see
    tests/test_torch_engine_modes.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N, K, T, M = 48, 8, 2, 32
N_OPS_STREAM = 48       # one stream length: the reference's replay compiles once


def _arrays(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def _assert_equal(want: dict, got, where: str = ""):
    got = state_to_numpy(got)
    for f, a in want.items():
        b = got[f]
        assert b.dtype == a.dtype, (f, b.dtype, a.dtype)
        np.testing.assert_array_equal(b, a, err_msg=f"{f} {where}")


def _port(jcfg, jtp, jst):
    cfg = SimConfig(**dataclasses.asdict(jcfg))
    tp = TopicParams(*(torch.from_numpy(np.array(x)) for x in jtp))
    return cfg, tp, state_from_reference(_arrays(jst), device="cpu")


@pytest.fixture(scope="module")
def live():
    """A 48-peer, 2-topic network after three engine ticks (meshes,
    counters, deliveries and disconnected slots live), in both packages."""
    jcfg, jtp, _ = jscenarios.partition_small(
        n_peers=N, k_slots=K, degree=4, start=1, heal=2)
    jcfg = dataclasses.replace(jcfg, msg_window=M, hop_mode="xla",
                               churn_disconnect_prob=0.05,
                               retain_score_ticks=1,
                               app_specific_weight=0.5,
                               topic_score_cap=3.0)
    topo = jtopology.sparse(N, K, degree=4, seed=3)
    rs = np.random.default_rng(5)
    jst = jinit_state(jcfg, topo, app_score=rs.normal(size=N)
                      .astype(np.float32))
    jst = jrun(jst, jcfg, jtp, jax.random.PRNGKey(2), 3)
    jst = jst._replace(behaviour_penalty=jnp.asarray(
        rs.uniform(0, 4, size=(N, K)).astype(np.float32)))
    return (jcfg, jtp, jst), _port(jcfg, jtp, jst)


def test_decay_counters_bit_equal(live):
    (jcfg, jtp, jst), (cfg, tp, st) = live
    want = _arrays(jdecay(jst, jcfg, jtp))
    _assert_equal(want, decay_counters(st, cfg, tp))


def _stream(code, nbr, seed):
    """An op stream of ``code``: observers over every peer, ``b`` a neighbor
    of the observer (mostly), a peer outside its table, or -1; ``c`` a
    topic, a message slot or a count as the op reads it; a few negative
    and out-of-range indices."""
    rs = np.random.default_rng(seed)
    a = rs.integers(0, N, N_OPS_STREAM)
    b = np.empty(N_OPS_STREAM, np.int64)
    for i, ai in enumerate(a):
        row = nbr[ai][nbr[ai] >= 0]
        r = rs.random()
        b[i] = rs.choice(row) if r < 0.8 and len(row) else \
            (-1 if r < 0.9 else rs.integers(0, N))
    c = rs.integers(0, T, N_OPS_STREAM)
    if code in (replay_mod.OP_PUBLISH, replay_mod.OP_DELIVER):
        b = rs.integers(0, M, N_OPS_STREAM)
    if code == replay_mod.OP_PENALTY:
        c = rs.integers(0, 4, N_OPS_STREAM)
    a[3], c[5], b[7] = -2, -1, M + 3 if code >= 10 else b[7]
    c[9] = T + 1
    op = np.full(N_OPS_STREAM, code)
    return op, a, b, c


def _replay_both(live, op, a, b, c, where):
    (jcfg, jtp, jst), (cfg, tp, st) = live
    op, a, b, c = (np.asarray(x, np.int32) for x in (op, a, b, c))
    want = _arrays(jreplay_mod.replay(jst, jcfg, jtp, jnp.asarray(op),
                                      jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(c)))
    before = state_to_numpy(st)
    got = replay_mod.replay(st, cfg, tp, op, a, b, c)
    _assert_equal(want, got, where)
    _assert_equal(before, st, f"{where}: the input state was written")


@pytest.mark.parametrize("code", range(replay_mod.N_OPS))
def test_replay_each_op_code(live, code):
    assert replay_mod.N_OPS == jreplay_mod.N_OPS == 14
    nbr = np.asarray(live[0][2].neighbors)
    _replay_both(live, *_stream(code, nbr, seed=code),
                 where=f"op code {code}")


def test_replay_out_of_range_codes_clamp(live):
    nbr = np.asarray(live[0][2].neighbors)
    _, a, b, c = _stream(replay_mod.OP_DISCONNECT, nbr, seed=31)
    op = np.resize(np.asarray([-7, 14, 16, 17, 99, -1]), N_OPS_STREAM)
    _replay_both(live, op, a, b, c, "out-of-range codes")


def test_replay_mixed_stream(live):
    nbr = np.asarray(live[0][2].neighbors)
    rs = np.random.default_rng(7)
    parts = [_stream(code, nbr, seed=40 + code) for code in range(14)]
    pick = rs.integers(0, 14, N_OPS_STREAM)
    cols = [np.asarray([parts[p][j][i] for i, p in enumerate(pick)])
            for j in range(4)]
    _replay_both(live, *cols, "mixed stream")


def test_replay_refuses_compact_state_and_ragged_streams(live):
    (_, _, _), (cfg, tp, st) = live
    z = np.zeros(2, np.int32)
    with pytest.raises(ValueError, match="compact"):
        from go_libp2p_pubsub_tpu_torch.sim import encode_state
        ccfg = dataclasses.replace(cfg, state_precision="compact")
        replay_mod.replay(encode_state(st, ccfg), ccfg, tp, z, z, z, z)
    with pytest.raises(ValueError, match="differ in length"):
        replay_mod.replay(st, cfg, tp, z, z, z, np.zeros(3, np.int32))


# --- a trace from the reference's pure-Python router runtime ----------------

@pytest.fixture(scope="module")
def router_trace():
    """tests/test_trace_replay.py's network (12 peers, scoring, 8
    publishes), its recorded events, and the underlay from_hosts builds."""
    _, nodes, hosts, mem = run_traced_network()
    topo, peer_index = jtopology.from_hosts(hosts, 16)
    return mem.events, topo, peer_index


@pytest.fixture(scope="module")
def port_router_trace():
    """The same network on the port's own runtime (go_libp2p_pubsub_tpu_torch
    api/net/routers), its events, and the port's ``from_hosts`` underlay."""
    _, nodes, hosts, mem = load_test_module(
        "test_trace_replay", "go_libp2p_pubsub_tpu_torch").run_traced_network()
    assert type(nodes[0]).__module__.startswith("go_libp2p_pubsub_tpu_torch.")
    topo, peer_index = from_hosts(hosts, 16)
    return mem.events, topo, peer_index


def test_port_router_trace_feed_equals_reference(router_trace,
                                                 port_router_trace):
    """The port's runtime records the reference runtime's events, its
    ``from_hosts`` builds the same underlay, and the port's tensorizer
    makes the same feed of them as the reference's of the reference's."""
    jevents, jtopo, jindex = router_trace
    events, topo, peer_index = port_router_trace
    assert events == jevents and peer_index == jindex
    for f in jtopo._fields:
        np.testing.assert_array_equal(getattr(topo, f), getattr(jtopo, f))
    kw = dict(msg_window=64, decay_interval=1.0, dup_window=[DUP_WINDOW],
              t_end=T_END)
    jfeed = jreplay_mod.tensorize_trace(jevents, jindex, {TOPIC: 0}, **kw)
    feed = replay_mod.tensorize_trace(events, peer_index, {TOPIC: 0}, **kw)
    for f in ("op", "a", "b", "c"):
        np.testing.assert_array_equal(getattr(feed, f), getattr(jfeed, f))
    assert feed.mid_slot == jfeed.mid_slot


def test_replay_port_router_trace(port_router_trace):
    """The port's trace leg of :func:`test_replay_router_trace`."""
    test_replay_router_trace(port_router_trace)


def test_replay_router_trace(router_trace):
    events, topo, peer_index = router_trace
    n = len(peer_index)
    jfeed = jreplay_mod.tensorize_trace(
        events, peer_index, {TOPIC: 0}, msg_window=64, decay_interval=1.0,
        dup_window=[DUP_WINDOW], t_end=T_END)
    feed = replay_mod.tensorize_trace(
        events, peer_index, {TOPIC: 0}, msg_window=64, decay_interval=1.0,
        dup_window=[DUP_WINDOW], t_end=T_END)
    for f in ("op", "a", "b", "c"):
        np.testing.assert_array_equal(getattr(feed, f), getattr(jfeed, f))
    assert feed.mid_slot == jfeed.mid_slot
    assert set(feed.op.tolist()) >= {replay_mod.OP_DECAY, replay_mod.OP_GRAFT,
                                     replay_mod.OP_FIRST, replay_mod.OP_JOIN,
                                     replay_mod.OP_PUBLISH,
                                     replay_mod.OP_DELIVER}
    jcfg = JConfig(n_peers=n, k_slots=16, n_topics=1, msg_window=64,
                   scoring_enabled=True)
    jtp = jreplay_mod.replay_topic_params([TSP])
    jst = jinit_state(jcfg, topo, subscribed=np.zeros((n, 1), bool))
    want = _arrays(jreplay_mod.replay_feed(jst, jcfg, jtp, jfeed))
    cfg = SimConfig(**dataclasses.asdict(jcfg))
    tp = replay_mod.replay_topic_params([TSP], device="cpu")
    for f, x in zip(tp._fields, jtp):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(x))
    from go_libp2p_pubsub_tpu_torch.sim import init_state
    st = init_state(cfg, Topology(*topo), subscribed=np.zeros((n, 1), bool),
                    device="cpu")
    _assert_equal(want, replay_mod.replay_feed(st, cfg, tp, feed),
                  "router trace")


# --- run_traced against the reference's -----------------------------------

TRACE_N, TRACE_TICKS = 128, 4


@pytest.fixture(scope="module")
def traced():
    jcfg, jtp, jst = jscenarios.single_topic_1k(n_peers=TRACE_N, k_slots=16,
                                                degree=6)
    jcfg = dataclasses.replace(jcfg, record_provenance=True, hop_mode="xla")
    jkeys = jax.random.split(jax.random.PRNGKey(4), TRACE_TICKS)
    jrows: list = []
    jout, jev = jrun_traced(jst, jcfg, jtp, None, 0, health_out=jrows,
                            keys=jkeys)
    cfg, tp, st = scenarios.single_topic_1k(n_peers=TRACE_N, k_slots=16,
                                            degree=6, device="cpu")
    cfg = dataclasses.replace(cfg, record_provenance=True)
    rows: list = []
    out, evs = run_traced(st, cfg, tp, None, 0, health_out=rows,
                          keys=rng.split(rng.PRNGKey(4, device="cpu"), TRACE_TICKS),
                          device="cpu")
    return (jcfg, jtp, jout, jev, jrows), (cfg, tp, out, evs, rows)


def test_run_traced_events_rows_and_state(traced):
    (_, _, jout, jev, jrows), (_, _, out, evs, rows) = traced
    assert len(evs) > TRACE_N and evs == jev
    assert {e["type"] for e in evs} >= {"GRAFT", "PUBLISH_MESSAGE",
                                        "DELIVER_MESSAGE"}
    _assert_equal(_arrays(jout), out, "run_traced")
    assert len(rows) == len(jrows) == TRACE_TICKS
    for r, jr in zip(rows, jrows):
        assert r.keys() == jr.keys()
        for k in r:
            if k == "score_mean":
                np.testing.assert_allclose(r[k], jr[k], rtol=1e-5)
            else:
                assert r[k] == jr[k], (k, r[k], jr[k])


def test_run_traced_chain_split_and_replay_of_its_events(traced):
    """The default chain-split key stream, and the exported events
    replayed into a fresh state by both packages."""
    (jcfg, jtp, _, _, _), (cfg, tp, _, _, _) = traced
    jst = jinit_state(jcfg, jtopology.sparse(TRACE_N, 16, degree=6))
    jout, jev = jrun_traced(jst, jcfg, jtp, jax.random.PRNGKey(9), 2)
    st = scenarios.single_topic_1k(n_peers=TRACE_N, k_slots=16, degree=6,
                                   device="cpu")[2]
    out, evs = run_traced(st, cfg, tp, rng.PRNGKey(9, device="cpu"), 2, device="cpu")
    assert evs == jev
    _assert_equal(_arrays(jout), out, "chain split")
    index = {f"p{i}": i for i in range(TRACE_N)}
    pre = [{"type": "JOIN", "peerID": f"p{i}", "timestamp": 0.1,
            "join": {"topic": "t0"}} for i in range(TRACE_N)]
    jfeed = jreplay_mod.tensorize_trace(pre + jev, index, {"t0": 0},
                                        msg_window=64, t_end=2.0)
    feed = replay_mod.tensorize_trace(pre + evs, index, {"t0": 0},
                                      msg_window=64, t_end=2.0)
    for f in ("op", "a", "b", "c"):
        np.testing.assert_array_equal(getattr(feed, f), getattr(jfeed, f))
    fresh = np.zeros((TRACE_N, 1), bool)
    jrep = jreplay_mod.replay_feed(
        jinit_state(jcfg, jtopology.sparse(TRACE_N, 16, degree=6),
                    subscribed=fresh), jcfg, jtp, jfeed)
    from go_libp2p_pubsub_tpu_torch.sim import init_state
    rep = replay_mod.replay_feed(
        init_state(cfg, Topology(*jtopology.sparse(TRACE_N, 16, degree=6)),
                   subscribed=fresh, device="cpu"), cfg, tp, feed)
    _assert_equal(_arrays(jrep), rep, "replay of the exported events")
