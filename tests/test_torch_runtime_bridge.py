"""Parity of the port's bridges between the functional runtime and the
batched engine with the JAX package's, on the CPU.

- ``sim.topology.from_hosts``: the same arrays and ``peer_index`` from the
  two packages' live swarms (dense, sparse, truncated by ``k``, after
  disconnects);
- ``sim.faults.HostFaultInjector``: one swarm per package under each
  connection-layer family (partition, outage, eclipse, churn wave) and
  each link-layer one (drop, duplication, slow links), and a plan that
  overlaps two windows: the same event streams, deliveries and meshes
  (tests/test_torch_runtime.py's recording), and at each checkpoint the
  same connections, severed pairs and faulted-RPC counts;
- the port's live-against-replay differential (tests/test_trace_replay.py
  on the port alone): the port's routers record a trace, the port's
  tensorizer and ``replay_feed`` inject it into the port's ``SimState``
  on the port's ``from_hosts`` underlay, and the mesh is exact, the
  P2/P3/P3b/P4 counters within 1e-3 and the total scores within 5e-3 of
  the routers' (the reference test's bounds);
- the port's ``PBTracer`` file of a port swarm is byte-equal to the
  reference's file of the same swarm, and the native tensorizer reads it
  into the feed the Python one makes of the events.
"""

from __future__ import annotations

import dataclasses
import functools
import random

import numpy as np
import pytest
import torch

from test_torch_runtime import (PORT, REF, M, assert_same,
                                load_test_module, recording)
from test_trace_replay import DUP_WINDOW, T_END, TOPIC


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs (the
    suite runs in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def traced_network(pkg: str, **kw):
    """tests/test_trace_replay.py's ``run_traced_network`` on the runtime
    of ``pkg``: (net, nodes, hosts, MemoryTracer)."""
    return load_test_module("test_trace_replay", pkg).run_traced_network(**kw)


# --- from_hosts -------------------------------------------------------------

def _swarm(pkg: str, n: int, connect: str, degree: int):
    api, net_m = M(pkg, "api"), M(pkg, "net")
    gs = M(pkg, "routers.gossipsub")
    net = net_m.Network()
    nodes = [api.PubSub(net.add_host(), gs.GossipSubRouter(),
                        sign_policy=api.LAX_NO_SIGN) for _ in range(n)]
    hosts = [p.host for p in nodes]
    if connect == "dense":
        net.dense_connect(hosts, degree=degree)
    elif connect == "sparse":
        net.sparse_connect(hosts, degree=degree)
    else:                                   # dense, then a few hang-ups
        net.dense_connect(hosts, degree=degree)
        for i in range(0, n, 3):
            for pid in sorted(hosts[i].conns)[:2]:
                hosts[i].disconnect(pid)
    net.scheduler.run_for(0.5)
    return hosts


@pytest.mark.parametrize("n,connect,degree,k", [
    (24, "dense", 6, 16), (24, "dense", 6, 5), (30, "sparse", 3, 12),
    (20, "hangups", 8, 16)])
def test_from_hosts_matches_reference(n, connect, degree, k):
    jtopo, jidx = M(REF, "sim.topology").from_hosts(
        _swarm(REF, n, connect, degree), k)
    topo, idx = M(PORT, "sim.topology").from_hosts(
        _swarm(PORT, n, connect, degree), k)
    assert idx == jidx
    for f in jtopo._fields:
        a, b = getattr(jtopo, f), getattr(topo, f)
        assert b.dtype == a.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert (topo.neighbors >= 0).any()


# --- HostFaultInjector ------------------------------------------------------

PLANS = {
    "partition": "partition=2@3:10",
    "outage": "outage=0.3@2:5,seed=3",
    "eclipse": "eclipse=0.2@2:8",
    "wave": "wave=0.3@6:2:13,seed=3",
    "link_drop": "drop=0.3,seed=5",
    "link_dup": "dup=0.3,seed=5",
    "slowlink": "slowlink=0.5@3:0.2,seed=2",
    "overlap": "partition=2@2:6,outage=0.3@4:9,seed=3",
}
N_FAULT = 20
CHECKPOINTS = (1.5, 3.5, 4.5, 6.5, 9.5, 12.5, 18.0)


def run_injected(pkg: str, family: str):
    """A 20-host gossipsub swarm under the plan, publishing every 0.5 s;
    returns its recording and the injector's view at each checkpoint."""
    faults = M(pkg, "sim.faults")
    api, net_m = M(pkg, "api"), M(pkg, "net")
    gs = M(pkg, "routers.gossipsub")
    with recording(pkg) as rec:
        net = net_m.Network()
        nodes = [api.PubSub(net.add_host(), gs.GossipSubRouter(),
                            sign_policy=api.LAX_NO_SIGN)
                 for _ in range(N_FAULT)]
        hosts = [p.host for p in nodes]
        net.dense_connect(hosts, degree=8)
        for p in nodes:
            p.join("t").subscribe()
        mal = [i >= N_FAULT - 4 for i in range(N_FAULT)]
        plan = faults.FaultPlan.parse(PLANS[family])
        inj = faults.HostFaultInjector(
            net, hosts, plan, malicious=mal if plan.eclipses else None)
        views, k = [], 0
        for t in CHECKPOINTS:
            while net.scheduler.now() + 0.5 <= t:
                nodes[k % N_FAULT].my_topics["t"].publish(b"m%d" % k)
                k += 1
                net.scheduler.run_for(0.5)
            net.scheduler.run_until(t)
            views.append((
                [sorted(inj.index[p] for p in h.conns) for h in hosts],
                sorted((inj.index[a.peer_id], inj.index[b.peer_id])
                       for a, b in inj._severed),
                [h.faulted_rpcs for h in hosts],
                inj.rng.getstate()))
    return rec.observe(), views


@pytest.mark.parametrize("family", sorted(PLANS))
def test_host_fault_injector_matches_reference(family):
    want, jviews = run_injected(REF, family)
    got, views = run_injected(PORT, family)
    assert_same(want, got, family)
    assert views == jviews
    # the plan bit: something was cut or lost, or a link drew its coin
    untouched = random.Random(M(PORT, "sim.faults").FaultPlan.parse(
        PLANS[family]).seed).getstate()
    assert any(v[1] or any(v[2]) for v in views) \
        or views[-1][3] != untouched, family


def test_host_fault_injector_refusals_and_dict_plan():
    faults = M(PORT, "sim.faults")
    hosts = _swarm(PORT, 6, "dense", 3)
    net = hosts[0].network
    with pytest.raises(ValueError, match="malicious"):
        faults.HostFaultInjector(net, hosts,
                                 faults.FaultPlan.parse("eclipse=0.2@2:8"))
    plan = faults.FaultPlan.parse("partition=2@1:3")
    inj = faults.HostFaultInjector(net, hosts, dataclasses.asdict(plan))
    assert inj.plan == plan and net.link_fault == inj._link_fault


# --- the injector's cuts against the batched engine's down slots -------------

INJECT_PLAN = "partition=2@2:6,outage=0.2@8:11,seed=7"


def injector_halves(pkg: str, n=128, k=32, ticks=13, checks=(3, 9, 12)):
    """One plan on both halves of ``pkg``: its ``HostFaultInjector`` on an
    ``n``-host swarm and its batched engine (CPU) over that swarm's
    ``from_hosts`` underlay, stepped a tick per scheduler second. At each
    checked tick: (tick, the slots whose connection the injector has cut,
    the slots the engine has down); and the final ``fault_flags``."""
    faults, topology = M(pkg, "sim.faults"), M(pkg, "sim.topology")
    sim = M(pkg, "sim")
    hosts = _swarm(pkg, n, "dense", 8)
    net = hosts[0].network
    topo, peer_index = topology.from_hosts(hosts, k)
    plan = faults.FaultPlan.parse(INJECT_PLAN)
    inj = faults.HostFaultInjector(net, hosts, plan)
    cfg = sim.SimConfig(n_peers=n, k_slots=k, n_topics=1, msg_window=64,
                        publishers_per_tick=2, fault_plan=plan,
                        hop_mode="xla")
    sub = np.ones((n, 1), bool)
    if pkg == REF:
        import jax
        st = sim.init_state(cfg, topo, subscribed=sub)
        tp = M(REF, "sim.config").TopicParams.disabled(1)
        keys = jax.random.split(jax.random.PRNGKey(0), ticks)
        step = jax.jit(M(REF, "sim.engine").step, static_argnums=1)
    else:
        st = sim.init_state(cfg, topo, subscribed=sub, device="cpu")
        tp = M(PORT, "sim.config").TopicParams.disabled(1, device="cpu")
        rng = M(PORT, "rng")
        keys = rng.split(rng.PRNGKey(0, device="cpu"), ticks)
        step = functools.partial(M(PORT, "sim").step, device="cpu")
    nb = topo.neighbors
    out = []
    for t in range(ticks):
        st = step(st, cfg, tp, keys[t])
        net.scheduler.run_until(t + 0.5)
        if t in checks:
            cut = np.zeros((n, k), bool)
            for a, b in inj._severed:
                i, j = peer_index[a.peer_id], peer_index[b.peer_id]
                cut[i, list(nb[i]).index(j)] = True
                cut[j, list(nb[j]).index(i)] = True
            out.append((t, cut, ~np.asarray(st.connected) & (nb >= 0)))
    return out, int(np.asarray(st.fault_flags)) & 0xFFFFFFFF


def test_injector_cuts_are_the_engine_s_down_slots():
    """The port's two halves agree: inside the partition, inside the
    outage and after the heal, the connections the injector cut (through
    ``peer_index``) are the slots the batched engine has down, and
    ``fault_flags`` is exactly the plan's bits."""
    inv = M(PORT, "sim.invariants")
    views, flags = injector_halves(PORT)
    counts = [int(cut.sum()) for _, cut, _ in views]
    for t, cut, down in views:
        np.testing.assert_array_equal(cut, down, err_msg=f"tick {t}")
    assert counts[0] > 0 and counts[1] > 0 and counts[2] == 0, counts
    assert flags == inv.FAULT_PARTITION | inv.FAULT_OUTAGE


# --- the port's live routers against its replay ------------------------------

def replay_port(nodes, hosts, events, k_slots=16, msg_window=64):
    """tests/test_trace_replay.py's ``replay_into_sim`` on the port."""
    sim, replay = M(PORT, "sim"), M(PORT, "trace.replay")
    topo, peer_index = M(PORT, "sim.topology").from_hosts(hosts, k_slots)
    n = len(hosts)
    cfg = sim.SimConfig(n_peers=n, k_slots=k_slots, n_topics=1,
                        msg_window=msg_window, scoring_enabled=True)
    tsp = nodes[0].rt.score.params.topics[TOPIC]
    tp = replay.replay_topic_params([tsp], device="cpu")
    st = sim.init_state(cfg, topo, subscribed=np.zeros((n, 1), bool),
                        device="cpu")
    feed = replay.tensorize_trace(events, peer_index, {TOPIC: 0},
                                  msg_window=msg_window, decay_interval=1.0,
                                  dup_window=[DUP_WINDOW], t_end=T_END)
    return replay.replay_feed(st, cfg, tp, feed), cfg, tp, topo, \
        peer_index, feed


@pytest.fixture(scope="module")
def port_diff():
    net, nodes, hosts, mem = traced_network(PORT)
    assert type(nodes[0]).__module__.startswith(PORT)
    return (nodes, hosts, mem) + replay_port(nodes, hosts, mem.events)


def test_port_replay_mesh_is_exact(port_diff):
    nodes, hosts, mem, st, cfg, tp, topo, peer_index, feed = port_diff
    assert int(st.tick) == int(T_END)
    mesh = st.mesh.numpy()
    for i, x in enumerate(nodes):
        want = {peer_index[p] for p in x.rt.mesh.get(TOPIC, set())}
        got = {int(topo.neighbors[i, k]) for k in range(cfg.k_slots)
               if mesh[i, 0, k]}
        assert got == want, f"node {i}: replay mesh {got} != router {want}"


def test_port_replay_counters_and_scores_match_routers(port_diff):
    nodes, hosts, mem, st, cfg, tp, topo, peer_index, feed = port_diff
    planes = {"first_message_deliveries": st.first_message_deliveries,
              "mesh_message_deliveries": st.mesh_message_deliveries,
              "mesh_failure_penalty": st.mesh_failure_penalty,
              "invalid_message_deliveries": st.invalid_message_deliveries}
    planes = {f: v.numpy() for f, v in planes.items()}
    scores = M(PORT, "ops.score_ops").compute_scores(st, cfg, tp).numpy()
    slot_of = [{int(j): k for k, j in enumerate(topo.neighbors[i]) if j >= 0}
               for i in range(len(nodes))]
    checked = 0
    for i, x in enumerate(nodes):
        for pid, pstats in x.rt.score.peer_stats.items():
            ts = pstats.topics.get(TOPIC)
            if ts is None:
                continue
            k = slot_of[i][peer_index[pid]]
            for f, v in planes.items():
                np.testing.assert_allclose(v[i, 0, k], getattr(ts, f),
                                           atol=1e-3, err_msg=f"{f} {i} {k}")
            np.testing.assert_allclose(scores[i, k], x.rt.score.score(pid),
                                       atol=5e-3, err_msg=f"score {i} {k}")
            checked += 1
    assert checked > len(nodes)


def test_port_replay_delivery_state(port_diff):
    nodes, hosts, mem, st, cfg, tp, topo, peer_index, feed = port_diff
    have = M(PORT, "sim.state").unpack_have(st, cfg.msg_window).numpy()
    assert len(feed.mid_slot) == 8
    for i, x in enumerate(nodes):
        for mid, sl in feed.mid_slot.items():
            assert have[i, sl] == x.seen.has(mid), (i, mid)


def test_port_replay_equals_reference_replay_of_reference_routers(port_diff):
    """The port's whole chain (routers, from_hosts, tensorizer, replay)
    against the reference's whole chain on the same network."""
    nodes, hosts, mem, st, cfg, tp, topo, peer_index, feed = port_diff
    jmod = load_test_module("test_trace_replay", REF)
    jnet, jnodes, jhosts, jmem = jmod.run_traced_network()
    assert M(PORT, "trace.sinks").MemoryTracer is type(mem)
    assert mem.events == jmem.events
    jst, *_, jfeed = jmod.replay_into_sim(jnodes, jhosts, jmem.events)
    for f in ("op", "a", "b", "c"):
        np.testing.assert_array_equal(getattr(feed, f), getattr(jfeed, f))
    got = M(PORT, "sim").state_to_numpy(st)
    for f in jst._fields:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jst, f)),
                                      err_msg=f)


# --- PBTracer files ---------------------------------------------------------

def test_pbtracer_file_is_byte_equal(tmp_path):
    files = {}
    for pkg in (REF, PORT):
        _, _, _, mem = traced_network(pkg, n=10, degree=5, publishes=6)
        path = tmp_path / f"{pkg}.pb"
        pb = M(pkg, "trace.sinks").PBTracer(str(path))
        for e in mem.events:
            pb.trace(e)
        pb.close()
        files[pkg] = path.read_bytes()
    assert len(files[PORT]) > 1000 and files[PORT] == files[REF]
    # the native tensorizer reads the port's file into the Python feed
    native, replay = M(PORT, "trace.native"), M(PORT, "trace.replay")
    _, _, hosts, mem = traced_network(PORT, n=10, degree=5, publishes=6)
    peer_index = {h.peer_id: i for i, h in enumerate(hosts)}
    kw = dict(msg_window=64, decay_interval=1.0, dup_window=[DUP_WINDOW],
              t_end=T_END)
    want = replay.tensorize_trace(mem.events, peer_index, {TOPIC: 0}, **kw)
    got = native.tensorize_file(str(tmp_path / f"{PORT}.pb"), peer_index,
                                {TOPIC: 0}, **kw)
    for f in ("op", "a", "b", "c"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.mid_slot == want.mid_slot
