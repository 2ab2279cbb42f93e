"""Parity of the port's fault plane (go_libp2p_pubsub_tpu_torch/sim/faults.py)
against the JAX package's sim/faults.py on the CPU.

- the plan's ``parse``/``format`` strings and its carry-over from a
  reference config (``SimConfig(**dataclasses.asdict(cfg))``);
- every peer and edge hash bit-equal to the JAX and the host versions;
- ``edge_cut_mask``, ``apply_faults``, ``storm_publishers``,
  ``censor_word_mask`` and ``attacker_mask`` on a fixed state;
- a forward_tick with IWANTs pending on dropped links (a link-eaten answer
  is a broken promise, a graylist/gater drop is not);
- an 8-tick ``engine.run`` per fault family and one with every family,
  ``fault_flags`` included, on the port's fused kernels where the plan
  allows them and on its non-fused path; the every-family plan also under
  the ``sort``, ``rows``, ``scalar`` and ``mxu`` gathers (6 ticks);
- ``partition_small`` and ``outage_small`` over their heal.

The network is ``partition_small`` at 256 peers (2 topics, full scoring,
K = 16) with 20 sybils for the eclipse cut. The JAX side runs
``hop_mode="xla"``. Every field is compared exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build
from go_libp2p_pubsub_tpu.ops.propagate import forward_tick as jforward
from go_libp2p_pubsub_tpu.sim import faults as jfaults
from go_libp2p_pubsub_tpu.sim import invariants as jinv
from go_libp2p_pubsub_tpu.sim import scenarios as jscenarios
from go_libp2p_pubsub_tpu.sim.engine import run as jrun
from go_libp2p_pubsub_tpu.sim.engine import step_jit as jstep
from go_libp2p_pubsub_tpu.sim.state import encode_state as jencode
from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.ops.hopkernel import resolve_hop_mode
from go_libp2p_pubsub_tpu_torch.ops.propagate import forward_tick
from go_libp2p_pubsub_tpu_torch.sim import (SimConfig, TopicParams,
                                            encode_state, faults,
                                            invariants, run, scenarios,
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


N, TICKS = 256, 8
# one plan per family, each active inside the 8 ticks, and one with all
FAMILIES = {
    "link drop": "drop=0.2",
    "link dup": "dup=0.3",
    "corrupt": "corrupt=0.5",
    "partition": "partition=2@2:6",
    "outage": "outage=0.2@2:6",
    "eclipse": "eclipse=0.2@1:5",
    "censor": "censor=0.4x{victim}@1:7",
    "storm": "storm=4x0.9x1@2:5",
    "slow link": "slowlink=0.3@3:0.1",
    "wave": "wave=0.25@4:2:8",
    "every family": ("drop=0.1,dup=0.2,corrupt=0.3,partition=2@1:4,"
                     "outage=0.2@2:5,eclipse=0.1@3:6,censor=0.4x{victim}@1:7,"
                     "storm=4x0.9x0@2:5,slowlink=0.3@3:0.1,wave=0.25@4:2:8,"
                     "seed=3"),
}
SPECS = [
    "", "drop=0.05,dup=0.01,corrupt=0.1,seed=7", "partition=3@10:30",
    "outage=0.2@10:30,outage=0.1@40:50", "eclipse=0.1@10:30",
    "censor=0.2x5@10:30", "censor=0.2@10:30", "storm=8x0.9x1@10:20",
    "storm=8@1:2", "slowlink=0.3@4:0.05", "slowlink=0.3@4",
    "wave=0.25@20:5:60", "wave=0.25@20:5:60:3",
    FAMILIES["every family"].format(victim=9),
]
BAD = ["bogus=1", "drop=2", "partition=2@5:5", "outage=0.2", "storm=0@1:2",
       "slowlink=0.3@0", "wave=0.2@4:5:10", "censor=0.1x1x2@1:2"]


def _arrays(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def _assert_equal(ref: dict, got: dict, where: str = ""):
    for f, want in ref.items():
        have = got[f]
        assert have.dtype == want.dtype, (f, have.dtype, want.dtype)
        np.testing.assert_array_equal(have, want, err_msg=f"{f} {where}")


def _jax_ticks(st, cfg, tp, n):
    """The reference's state after each tick of ``engine.run(st, cfg, tp,
    PRNGKey(0), n)``: its jitted step on run's own split of the key.
    Returns (final state, [numpy fields per tick])."""
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    ticks = []
    for i in range(n):
        st = jstep(st, cfg=cfg, tp=tp, key=keys[i])
        ticks.append(_arrays(st))
    return st, ticks


def _same(jax_out, torch_out, what):
    a = np.asarray(jax_out)
    b = torch_out.numpy()
    if a.dtype == np.uint32:
        b = b.view(np.uint32)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def _port(jcfg, jtp, jst):
    return (SimConfig(**dataclasses.asdict(jcfg)),
            TopicParams(*[torch.from_numpy(np.array(x)) for x in jtp]),
            state_from_reference(_arrays(jst), device="cpu"))


def _plan(fam, victim=0):
    return jfaults.FaultPlan.parse(FAMILIES[fam].format(victim=victim))


def _jax_state(jst, port_state):
    """A port state as the reference's SimState (same fields and dtypes)."""
    return jst._replace(**{f: jnp.asarray(v) for f, v in
                           state_to_numpy(port_state).items()})


@pytest.fixture(scope="module")
def network():
    """partition_small at 256 peers with 20 sybils; for each censor plan a
    victim that publishes in tick 1 under that plan's own key stream (the
    victim changes no draw; the port's 2-tick run finds it), and the
    reference's state after those 2 ticks."""
    jcfg, jtp, jst = jscenarios.partition_small(n_peers=N)
    mal = np.zeros(N, bool)
    mal[np.random.default_rng(1).choice(N, 20, replace=False)] = True
    jst = jst._replace(malicious=jnp.asarray(mal))
    jcfg = dataclasses.replace(jcfg, hop_mode="xla", fault_plan=None)
    victims, early = {}, {}
    for fam in ("censor", "every family"):
        cfg, tp, st = _port(dataclasses.replace(jcfg, fault_plan=_plan(fam)),
                            jtp, jst)
        out = run(st, cfg, tp, rng.PRNGKey(0, device="cpu"), 2, device="cpu")
        pub = out.msg_publisher[16:32].tolist()              # tick 1
        victims[fam] = [p for p in pub if not mal[p]][0]
        c = dataclasses.replace(jcfg, fault_plan=_plan(fam, victims[fam]))
        cfg = SimConfig(**dataclasses.asdict(c))
        early[fam] = (c, _jax_state(jst, run(
            st, cfg, tp, rng.PRNGKey(0, device="cpu"), 2, device="cpu")))
    return jcfg, jtp, jst, victims, early


@pytest.fixture(scope="module")
def ref_runs(network):
    """The JAX package's 8-tick run per family: (cfg, tp, state, final
    state, per-tick fields)."""
    jcfg, jtp, jst, victims, _ = network
    out = {}
    for fam in FAMILIES:
        c = dataclasses.replace(jcfg, fault_plan=_plan(fam,
                                                       victims.get(fam, 0)))
        out[fam] = (c, jtp, jst, *_jax_ticks(jst, c, jtp, TICKS))
    out["none"] = (jcfg, jtp, jst, *_jax_ticks(jst, jcfg, jtp, TICKS))
    return out


# --- the plan --------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_plan_parse_format_equal(spec):
    want = jfaults.FaultPlan.parse(spec)
    got = faults.FaultPlan.parse(spec)
    assert got.format() == want.format()
    assert faults.FaultPlan.parse(got.format()) == got
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.active() == want.active()
    # carried over inside a config, as the tests carry reference configs
    jcfg = dataclasses.replace(jscenarios.partition_small(n_peers=64)[0],
                               fault_plan=want)
    cfg = SimConfig(**dataclasses.asdict(jcfg))
    assert isinstance(cfg.fault_plan, faults.FaultPlan)
    assert cfg.fault_plan == got
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("spec", BAD)
def test_plan_parse_refuses_what_the_reference_refuses(spec):
    with pytest.raises(ValueError) as want:
        jfaults.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as got:
        faults.FaultPlan.parse(spec)
    assert str(got.value) == str(want.value)


def test_config_holds_the_ports_own_plan():
    """A plan reaches SimConfig as the port's FaultPlan or its dict form;
    the reference's plan object itself is refused."""
    jplan = jfaults.FaultPlan.parse(FAMILIES["every family"].format(victim=3))
    got = SimConfig(n_peers=8, k_slots=4,
                    fault_plan=dataclasses.asdict(jplan)).fault_plan
    assert type(got) is faults.FaultPlan
    assert got == faults.as_plan(dataclasses.asdict(jplan))
    assert got.format() == jplan.format()
    for bad in (jplan, jplan.format(), 3):
        with pytest.raises(TypeError):
            SimConfig(n_peers=8, k_slots=4, fault_plan=bad)


# --- the hashes ------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123456789])
@pytest.mark.parametrize("n", [257, 1000])
def test_peer_hashes_equal_jax_and_host(seed, n):
    plan = jfaults.FaultPlan.parse(
        f"outage=0.2@1:2,outage=0.73@1:2,censor=0.3x5@1:2,censor=1.0x0@1:2,"
        f"wave=0.25@4:2:8,wave=0.0@4:2:8,seed={seed}")
    pplan = faults.as_plan(dataclasses.asdict(plan))
    pairs = [(jfaults._outage_peers_jax, faults.outage_peers,
              jfaults.outage_peers_host, len(plan.outages)),
             (jfaults._censor_peers_jax, faults.censor_peers,
              jfaults.censor_peers_host, len(plan.censorships)),
             (jfaults._wave_peers_jax, faults.wave_peers,
              jfaults.wave_peers_host, len(plan.waves))]
    for jfn, fn, host, count in pairs:
        for i in range(count):
            want = np.asarray(jfn(n, i, plan))
            got = fn(n, i, pplan, "cpu").numpy()
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(np.asarray(host(n, i, plan)), want)
            port_host = {"outage_peers": faults.outage_peers_host,
                         "censor_peers": faults.censor_peers_host,
                         "wave_peers": faults.wave_peers_host}[fn.__name__]
            assert port_host(n, i, pplan) == host(n, i, plan)
    for i in range(len(plan.censorships)):
        assert not faults.censor_peers(n, i, pplan, "cpu")[
            plan.censorships[i].victim]
    targets = jfaults.eclipse_targets_host(
        n, 0, jfaults.FaultPlan.parse("eclipse=0.3@1:2"), [False] * n)
    assert faults.eclipse_targets_host(
        n, 0, faults.FaultPlan.parse("eclipse=0.3@1:2"), [False] * n) \
        == targets


@pytest.mark.parametrize("salt", [0, 0xDAA66D2B, 0xFFFFFFFF])
def test_slow_edge_hash_equal_jax_and_host(network, salt):
    jst = network[2]
    nbr = np.asarray(jst.neighbors)
    want = np.asarray(jfaults._slow_edge_hash_jax(jst.neighbors, salt))
    got = faults.slow_edge_hash(torch.from_numpy(nbr.copy()), salt).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    n, k = nbr.shape
    for i, s in zip(*np.nonzero(nbr >= 0)):
        if (i * k + s) % 7 == 0:
            assert int(want[i, s]) == jfaults._slow_edge_hash_host(
                int(i), int(nbr[i, s]), salt) \
                == faults._slow_edge_hash_host(int(i), int(nbr[i, s]), salt)
    # symmetric: both directions of an edge hash alike
    rs = np.asarray(jst.reverse_slot)
    live = (nbr >= 0) & (rs >= 0)
    i, s = np.nonzero(live)
    np.testing.assert_array_equal(got[i, s], got[nbr[i, s], rs[i, s]])


# --- the fault pass on a fixed state --------------------------------------

_japply_faults = jax.jit(jfaults.apply_faults, static_argnums=1)


@pytest.mark.parametrize("tick", [0, 2, 4, 5, 6, 7])
def test_edge_cut_mask_and_apply_faults_equal(network, tick):
    """edge_cut_mask with and without the disconnect stamps, and the whole
    fault pass (state and FaultTick), at ticks before, inside, at the end
    of and after the windows, on a state whose stamps a cut has set."""
    jtp = network[1]
    # the state after two ticks of the plan: edges down, stamps set
    jc, jst = network[4]["every family"]
    jst = jst._replace(tick=jnp.int32(tick))
    cfg, tp, st = _port(jc, jtp, jst)
    for stamps in (True, False):
        want = jfaults.edge_cut_mask(
            jc.fault_plan, jst.tick, jst.neighbors, jst.reverse_slot,
            disconnect_tick=jst.disconnect_tick if stamps else None,
            malicious=jst.malicious)
        got = faults.edge_cut_mask(
            cfg.fault_plan, st.tick, st.neighbors, st.reverse_slot,
            disconnect_tick=st.disconnect_tick if stamps else None,
            malicious=st.malicious)
        for name, a, b in zip(("want_down", "heal", "injected"), want, got):
            _same(a, b, name)
    jout, jft = _japply_faults(jst, jc, jtp, jax.random.PRNGKey(4))
    out, ft = faults.apply_faults(st, cfg, tp, rng.PRNGKey(4, device="cpu"))
    _assert_equal(_arrays(jout), state_to_numpy(out))
    for f in jft._fields:
        _same(getattr(jft, f), getattr(ft, f), f)
    if tick in (2, 4):
        assert np.asarray(jft.want_down).any()


def test_edge_cut_mask_refuses_row_slices(network):
    jst = network[2]
    st = state_from_reference(_arrays(jst), device="cpu")
    plan = faults.FaultPlan.parse("partition=2@1:3")
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 8"):
        faults.edge_cut_mask(plan, st.tick, st.neighbors, st.reverse_slot,
                             row_start=16)
    with pytest.raises(ValueError, match="malicious"):
        faults.edge_cut_mask(faults.FaultPlan.parse("eclipse=0.1@1:3"),
                             st.tick, st.neighbors, st.reverse_slot)


@pytest.mark.parametrize("tick", [1, 2, 3, 7])
def test_storm_censor_and_attacker_masks_equal(network, tick):
    """On the every-family plan's state after 2 ticks (the victim's tick-1
    message live), re-stamped to ``tick``: the storm's publisher redraw
    (window [2, 5)), the censor word mask (window [1, 7)) and the attacker
    mask."""
    jcfg, jout = network[4]["every family"]
    jout = jout._replace(tick=jnp.int32(tick))
    cfg, _, st = _port(jcfg, network[1], jout)
    peers = jnp.asarray([5, 17, 100, 200] * 4, jnp.int32)
    topics = jnp.asarray([0, 1] * 8, jnp.int32)
    want = jfaults.storm_publishers(jout, jcfg, peers, topics,
                                    jax.random.PRNGKey(9))
    got = faults.storm_publishers(st, cfg, _t(peers), _t(topics),
                                  rng.PRNGKey(9, device="cpu"))
    for a, b, name in zip(want, got, ("peers", "topics")):
        _same(a, b, name)
    assert ((np.asarray(want[0]) < 4).sum() > 8) == (2 <= tick < 5)
    want_c = jfaults.censor_word_mask(jout, jcfg)
    got_c = faults.censor_word_mask(st, cfg)
    _same(want_c, got_c, "censor_word_mask")
    assert np.asarray(want_c).any() == (1 <= tick < 7)
    _same(jfaults.attacker_mask(jout, jcfg), faults.attacker_mask(st, cfg),
          "attacker_mask")


def test_link_drop_pulls_are_broken_promises(ref_runs):
    """A forward_tick whose pending IWANTs meet dropped links (and a
    graylist that keeps some answers out): the resolve charges P7 for the
    link-eaten answers only, and the port's tick equals the reference's
    on the fused-ineligible path in both formulations."""
    from go_libp2p_pubsub_tpu.ops.heartbeat import heartbeat as jheartbeat
    jcfg, jtp, _, jst, _ = ref_runs["link drop"]
    jcfg = dataclasses.replace(jcfg, graylist_threshold=-0.5)
    hb = jax.jit(jheartbeat, static_argnums=1)(jst, jcfg, jtp,
                                               jax.random.PRNGKey(7))
    jfwd = jax.jit(lambda st, tp, inc, sc, key, fwd, lk: jforward(
        st, jcfg, tp, inc, sc, key, fwd_send=fwd, link_ok=lk))
    pend = np.asarray(hb.state.iwant_pending)
    link_ok = np.random.default_rng(2).random(pend.shape[:1] + (jcfg.k_slots,)) \
        >= 0.5
    asked = np.zeros_like(link_ok)
    for s in range(jcfg.k_slots):
        asked[:, s] = (pend == s).any(1)
    assert (asked & ~link_ok).sum() > 0          # pulls on dropped links
    outs = {}
    for name, lk in (("dropped", link_ok), ("none", None)):
        outs[name] = jfwd(hb.state, jtp, hb.inc_gossip, hb.scores,
                          jax.random.PRNGKey(8), hb.fwd_send,
                          None if lk is None else jnp.asarray(lk))
        for gather in ("pallas", "mxu"):
            cfg, tp, st = _port(dataclasses.replace(
                jcfg, edge_gather_mode=gather), jtp, hb.state)
            got = forward_tick(
                st, cfg, tp, _t(hb.inc_gossip), _t(hb.scores),
                rng.PRNGKey(8, device="cpu"), fwd_send=_t(hb.fwd_send),
                link_ok=None if lk is None else torch.from_numpy(lk))
            _assert_equal(_arrays(outs[name]), state_to_numpy(got))
    bp = {k: np.asarray(v.behaviour_penalty).sum() for k, v in outs.items()}
    assert bp["dropped"] > bp["none"]


def test_record_flags_with_injected(ref_runs):
    jcfg, jtp, _, jout, _ = ref_runs["none"]
    cfg, _, st = _port(jcfg, jtp, jout)
    inj = invariants.FAULT_OUTAGE | invariants.FAULT_CENSOR
    want = jinv.record_flags(jout, jcfg, injected=jnp.uint32(inj))
    got = invariants.record_flags(st, cfg,
                                  injected=torch.tensor(inj, dtype=torch.int32))
    _assert_equal(_arrays(want), state_to_numpy(got))
    assert int(got.fault_flags) == inj
    for name in dir(jinv):
        if name.startswith("FAULT_"):
            assert getattr(invariants, name) == getattr(jinv, name), name


# --- trajectories ----------------------------------------------------------

@pytest.mark.parametrize("hop", ["auto", "xla"])
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_fault_family_run_equal(ref_runs, fam, hop):
    """The acceptance runs: 8 ticks per family, every field exact after
    every tick, fault_flags included: the plan's injected bits and no
    violation. Under ``auto`` the port takes its fused kernels where the
    plan allows (partition, outage, eclipse, corruption, storm, wave)."""
    jcfg, jtp, jst, _, ticks = ref_runs[fam]
    cfg, tp, st = _port(jcfg, jtp, jst)
    cfg = dataclasses.replace(cfg, hop_mode=hop)
    keys = rng.split(rng.PRNGKey(0, device="cpu"), TICKS)
    for i, want in enumerate(ticks):
        st = step(st, cfg, tp, keys[i], device="cpu")
        _assert_equal(want, state_to_numpy(st), f"after tick {i}")
    flags = int(ticks[-1]["fault_flags"])
    assert flags & invariants.INJECTED_MASK and not \
        flags & invariants.VIOLATION_MASK, hex(flags)
    if fam == "every family":
        assert flags == 0x3FF
        if hop == "auto":
            # the per-tick reference is engine.run's own scan, tick by tick
            _assert_equal(_arrays(jrun(jst, jcfg, jtp,
                                       jax.random.PRNGKey(0), TICKS)),
                          ticks[-1], "engine.run")
    fused = resolve_hop_mode(cfg) == "pallas"
    assert fused == (hop == "auto" and fam in (
        "corrupt", "partition", "outage", "eclipse", "storm", "wave"))


@pytest.mark.parametrize("gather", ["sort", "rows", "scalar", "mxu"])
def test_every_family_plan_under_each_formulation(ref_runs, gather):
    """The every-family plan (20 sybils, the censor victim) under each
    gather formulation besides the default, 6 ticks, every field exact
    after every tick against the reference's jitted step."""
    jcfg, jtp, jst, _, ticks = ref_runs["every family"]
    cfg, tp, st = _port(jcfg, jtp, jst)
    cfg = dataclasses.replace(cfg, hop_mode="auto", edge_gather_mode=gather)
    keys = rng.split(rng.PRNGKey(0, device="cpu"), TICKS)
    for i, want in enumerate(ticks[:6]):
        st = step(st, cfg, tp, keys[i], device="cpu")
        _assert_equal(want, state_to_numpy(st), f"{gather}, after tick {i}")


@pytest.mark.parametrize("fam", ["censor", "eclipse", "storm", "wave",
                                 "slow link", "link dup"])
def test_fault_family_changes_the_run(ref_runs, fam):
    """Non-vacuous: every family leaves another state than the plan-free
    run of the same key."""
    base = _arrays(ref_runs["none"][3])
    got = _arrays(ref_runs[fam][3])
    assert any(not np.array_equal(base[f], got[f]) for f in base
               if f != "fault_flags")


@pytest.mark.parametrize("name", ["partition_small", "outage_small"])
def test_fault_scenario_over_its_heal(name):
    """The two sweep-scale fault scenarios at 256 peers, 22 ticks (the
    window is [8, 20)): array-equal builders, every field equal to
    ``engine.run`` at the end, edges down inside the window and back
    after the heal, the plan's one injected bit."""
    jbuild = getattr(jscenarios, name)
    jcfg, jtp, jst = jbuild(n_peers=N)
    cfg, tp, st = getattr(scenarios, name)(n_peers=N, device="cpu")
    assert SimConfig(**dataclasses.asdict(jcfg)) == cfg
    _assert_equal(_arrays(jst), state_to_numpy(st))
    jc = dataclasses.replace(jcfg, hop_mode="xla")
    end = jrun(jst, jc, jtp, jax.random.PRNGKey(0), 22)
    keys = rng.split(rng.PRNGKey(0, device="cpu"), 22)
    known = np.asarray(jst.neighbors) >= 0
    down = []
    for tick in range(22):
        st = step(st, cfg, tp, keys[tick], device="cpu")
        down.append(int((known & ~st.connected.numpy()).sum()))
    _assert_equal(_arrays(end), state_to_numpy(st))
    down_mid, down_end = down[12], down[-1]
    assert down_mid > 0 and down_end < down_mid
    bit = (jinv.FAULT_PARTITION if name == "partition_small"
           else jinv.FAULT_OUTAGE)
    assert int(end.fault_flags) == bit


# --- the engine's refusals -------------------------------------------------

def test_lifted_configs_run_and_refusals_name_their_item():
    """Every config the port covers runs a step (the data plane's branches,
    since Queue 1 item 2 subscription churn, the raise and off invariant
    modes and the fold_in key schedule, and since item 3 the sort and
    scalar gathers and the iter selection); every refusal left names the
    queue item that lifts it, and none names item 1, 2 or 3."""
    from go_libp2p_pubsub_tpu_torch.sim import build_headline
    cfg, tp, st = build_headline(64, k_slots=8, degree=4, device="cpu")
    key = rng.PRNGKey(0, device="cpu")
    plan = faults.as_plan(dataclasses.asdict(_plan("every family", 1)))
    for over in (dict(router="floodsub"), dict(router="randomsub"),
                 dict(flood_publish=True), dict(record_provenance=True),
                 dict(edge_queue_cap=2), dict(fault_plan=plan),
                 dict(fault_plan=plan, flood_publish=True, edge_queue_cap=1,
                      record_provenance=True, edge_gather_mode="mxu"),
                 dict(sub_leave_prob=0.1), dict(invariant_mode="raise"),
                 dict(key_schedule="fold_in"),
                 dict(sub_join_prob=0.2, invariant_mode="off",
                      key_schedule="fold_in", fault_plan=plan),
                 dict(edge_gather_mode="sort"),
                 dict(edge_gather_mode="scalar", fault_plan=plan,
                      selection_mode="iter")):
        out = step(st, dataclasses.replace(cfg, **over), tp, key,
                   device="cpu")
        assert int(out.tick) == 1
    # Queue 1 item 5: compact storage steps on an encoded state under the
    # every-family plan, equal to the reference's compact step
    jcfg, jtp, jst = _build(64, 8, 4, publishers=8)
    jcfg = dataclasses.replace(jcfg, state_precision="compact",
                               fault_plan=_plan("every family", 1))
    ccfg = SimConfig(**dataclasses.asdict(jcfg))
    out = step(encode_state(st, ccfg), ccfg, tp, key, device="cpu")
    want = jstep(jencode(jst, jcfg), cfg=jcfg, tp=jtp,
                 key=jax.random.PRNGKey(0))
    _assert_equal(_arrays(want), state_to_numpy(out), "compact")
    for over, item in ((dict(degree_buckets=((64, 8),)), 8),):
        with pytest.raises(NotImplementedError,
                           match=rf"Queue 1 item {item}\)"):
            step(st, dataclasses.replace(cfg, **over), tp, key, device="cpu")
    with pytest.raises(ValueError, match="router"):
        step(st, dataclasses.replace(cfg, router="meshsub"), tp, key,
             device="cpu")
