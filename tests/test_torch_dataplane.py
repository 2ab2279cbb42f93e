"""Parity of the port's data-plane branches against the JAX package on the
CPU: flood publish (scoring on and off), per-edge queue caps, and delivery
provenance.

The network is the headline's (``__graft_entry__._build(512, 32, 12)``)
with ``prop_substeps=2``, so that gossip pulls are common and a cap meets
them in the resolve as well as in the hops. Each case runs 8 ticks of
``engine.run`` from PRNGKey(0); the JAX side runs ``hop_mode="xla"``
under its default gather formulation, the port its non-fused path under
``edge_gather_mode="pallas"`` and ``"mxu"`` (the reference pins its
formulations bit-identical). Every field is compared exactly, float32
included."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _build
from go_libp2p_pubsub_tpu.ops.propagate import forward_tick as jforward
from go_libp2p_pubsub_tpu.ops.propagate import publish as jpublish
from go_libp2p_pubsub_tpu.sim.engine import step_jit as jstep
from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.ops.hopkernel import resolve_hop_mode
from go_libp2p_pubsub_tpu_torch.ops.propagate import forward_tick, publish
from go_libp2p_pubsub_tpu_torch.sim import (SimConfig, TopicParams,
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


N, TICKS = 512, 8
CASES = {
    "base": {},
    "flood": dict(flood_publish=True),
    "flood,no scoring": dict(flood_publish=True, scoring_enabled=False),
    "edge cap 1": dict(edge_queue_cap=1),
    "edge cap 2": dict(edge_queue_cap=2),
    # the admission layers together: graylist, gater, edge cap, validation
    "edge cap 1,validation cap 3,gater": dict(
        edge_queue_cap=1, validation_queue_cap=3, gater_enabled=True,
        ignore_fraction=0.1),
    "provenance": dict(record_provenance=True),
    "flood,edge cap 2,provenance,gater": dict(
        flood_publish=True, edge_queue_cap=2, record_provenance=True,
        gater_enabled=True, validation_queue_cap=8),
}


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


def _port(jcfg, jtp, jst, gather):
    cfg = dataclasses.replace(SimConfig(**dataclasses.asdict(jcfg)),
                              edge_gather_mode=gather)
    return (cfg, TopicParams(*[torch.from_numpy(np.array(x)) for x in jtp]),
            state_from_reference(_arrays(jst), device="cpu"))


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def ref_runs():
    """The JAX package's runs, keyed by case: (cfg, tp, initial state,
    final state, per-tick fields)."""
    cfg, tp, st = _build(N, 32, 12)
    out = {}
    for case, over in CASES.items():
        c = dataclasses.replace(cfg, hop_mode="xla", prop_substeps=2, **over)
        out[case] = (c, tp, st, *_jax_ticks(st, c, tp, TICKS))
    return out


@pytest.mark.parametrize("gather", ["pallas", "mxu"])
@pytest.mark.parametrize("case", list(CASES))
def test_dataplane_run_equal(ref_runs, case, gather):
    """The acceptance runs: every SimState field after each of 8 ticks,
    exact."""
    jcfg, jtp, jst, _, ticks = ref_runs[case]
    cfg, tp, st = _port(jcfg, jtp, jst, gather)
    if case != "base":
        assert resolve_hop_mode(dataclasses.replace(cfg, hop_mode="auto")) \
            == "xla"                  # each branch is on the non-fused path
    keys = rng.split(rng.PRNGKey(0, device="cpu"), TICKS)
    for i, want in enumerate(ticks):
        st = step(st, cfg, tp, keys[i], device="cpu")
        _assert_equal(want, state_to_numpy(st), f"after tick {i}")
    ref = ticks[-1]
    assert ref["delivered_total"] > 0 and int(ref["fault_flags"]) == 0


@pytest.mark.parametrize("case", [c for c in CASES if c != "base"])
def test_each_branch_changes_the_run(ref_runs, case):
    """Non-vacuous: each branch leaves another state than the plain run
    (flood publish adds hop-0 offers, a cap drops RPCs, provenance writes
    deliver_from)."""
    base = _arrays(ref_runs["base"][3])
    got = _arrays(ref_runs[case][3])
    differ = [f for f in base if not np.array_equal(base[f], got[f])]
    assert differ, case
    if "cap" in case:
        assert got["delivered_total"] < base["delivered_total"]
    if "provenance" in case:
        assert "deliver_from" in differ


@pytest.mark.parametrize("case", ["provenance",
                                  "flood,edge cap 2,provenance,gater"])
def test_provenance_deliver_from_in_range(ref_runs, case):
    """deliver_from holds a slot in [0, K) for every message a receiver
    got from a neighbour, and -1 for the publisher's own and undelivered
    ones; the port's equals the reference's (test_dataplane_run_equal)."""
    jcfg, _, _, jout, _ = ref_runs[case]
    df = np.asarray(jout.deliver_from)
    dt = np.asarray(jout.deliver_tick)
    pub = np.asarray(jout.msg_publisher)
    assert ((df >= -1) & (df < jcfg.k_slots)).all()
    got = (df >= 0)
    assert got.sum() > 0
    # a delivered message came from a slot unless the receiver published it
    own = np.arange(N)[:, None] == pub[None, :]
    assert (got == ((dt < 2 ** 30) & ~own)).mean() > 0.99
    assert not (got & own).any()


@pytest.mark.parametrize("cap", [1, 2])
def test_edge_cap_binds_in_the_resolve(ref_runs, cap):
    """A forward_tick with no hop (``prop_substeps=0``), so that the tick's
    traffic is the IWANT resolve alone, from a state whose pending pulls
    ask more than ``cap`` messages of one slot: the capped resolve drops
    whole pulls (another state than the uncapped one) and the port's
    equals the reference's in both formulations."""
    jcfg, jtp, jst, jout, _ = ref_runs["base"]
    pend = np.asarray(jout.iwant_pending)
    per_slot = np.stack([(pend == s).sum(1) for s in range(jcfg.k_slots)], 1)
    assert per_slot.max() > cap
    from go_libp2p_pubsub_tpu.ops.heartbeat import heartbeat as jheartbeat
    outs = {}
    for c in (0, cap):
        jc = dataclasses.replace(jcfg, prop_substeps=0, edge_queue_cap=c)
        hb = jheartbeat(jout, jc, jtp, jax.random.PRNGKey(7))
        outs[c] = jforward(hb.state, jc, jtp, hb.inc_gossip, hb.scores,
                           jax.random.PRNGKey(8), fwd_send=hb.fwd_send)
        for gather in ("pallas", "mxu"):
            cfg, tp, st = _port(jc, jtp, hb.state, gather)
            got = forward_tick(st, cfg, tp, _t(hb.inc_gossip), _t(hb.scores),
                               rng.PRNGKey(8, device="cpu"),
                               fwd_send=_t(hb.fwd_send))
            _assert_equal(_arrays(outs[c]), state_to_numpy(got))
    assert float(outs[cap].delivered_total) < float(outs[0].delivered_total)


def test_publish_resets_provenance(ref_runs):
    """publish under record_provenance sets the recycled slots'
    deliver_from to -1 for every receiver, and leaves it alone otherwise
    (at tick 16 the 4 publishes recycle slots 0-3, delivered in tick 0)."""
    jcfg, _, _, jout, _ = ref_runs["provenance"]
    jst = jout._replace(tick=jax.numpy.int32(16))
    slots = np.arange(4)
    before = np.asarray(jst.deliver_from)[:, slots]
    assert (before >= 0).any()
    peers = np.asarray([3, 40, 300, 511], np.int32)
    topics = np.zeros(4, np.int32)
    for prov in (True, False):
        jc = dataclasses.replace(jcfg, record_provenance=prov)
        want = jpublish(jst, jc, peers, topics)
        got = publish(state_from_reference(_arrays(jst), device="cpu"),
                      SimConfig(**dataclasses.asdict(jc)),
                      torch.from_numpy(peers), torch.from_numpy(topics))
        _assert_equal(_arrays(want), state_to_numpy(got))
        after = np.asarray(want.deliver_from)[:, slots]
        if prov:
            assert (after == -1).all()
        else:
            np.testing.assert_array_equal(after, before)
