"""Parity of the port's churn + peer-gater path (the non-fused data path)
against the JAX package on the CPU.

The scenario is ``churn_50k`` (BASELINE config #3: 4 topics, full scoring,
connection churn with PX-gated reconnects, the peer gater with a
validation queue cap of 64) at 1024 peers, 8 ticks from PRNGKey(0) with
``hop_mode="xla"``, under ``edge_gather_mode="pallas"`` and ``"mxu"``, and
with the cap cut to 4 so that the throttle and the gater's RED drop fire;
and at 256 peers under ``hop_mode="pallas"`` (the non-fused hop with the
fused emit). The JAX side runs its Pallas kernels in interpret mode. The
stages (gater_decay, accept_data, churn_edges, heartbeat with a ride-along
table, the non-fused forward_tick with and without the IWANT budget) are
compared one by one on the cap-4 run's final state. Every field is
compared exactly, float32 included: no case has needed a tolerance."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.ops.churn import _symmetric_value as jsym_value
from go_libp2p_pubsub_tpu.ops.churn import churn_edges as jchurn_edges
from go_libp2p_pubsub_tpu.ops.gater import accept_data as jaccept_data
from go_libp2p_pubsub_tpu.ops.gater import gater_decay as jgater_decay
from go_libp2p_pubsub_tpu.ops.heartbeat import edge_gather as jedge_gather
from go_libp2p_pubsub_tpu.ops.heartbeat import \
    edge_gather_packed as jedge_gather_packed
from go_libp2p_pubsub_tpu.ops.heartbeat import heartbeat as jheartbeat
from go_libp2p_pubsub_tpu.ops.propagate import forward_tick as jforward
from go_libp2p_pubsub_tpu.sim import scenarios as jscenarios
from go_libp2p_pubsub_tpu.sim.engine import run as jrun
from go_libp2p_pubsub_tpu.sim.state import NEVER as JNEVER
from go_libp2p_pubsub_tpu.ops.bits import pack_words as jpack_words
from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.ops import cudalib
from go_libp2p_pubsub_tpu_torch.ops.churn import _symmetric_value, churn_edges
from go_libp2p_pubsub_tpu_torch.ops.gater import accept_data, gater_decay
from go_libp2p_pubsub_tpu_torch.ops.heartbeat import (edge_gather,
                                                      edge_gather_packed,
                                                      heartbeat)
from go_libp2p_pubsub_tpu_torch.ops.hopkernel import (resolve_emit_mode,
                                                      resolve_hop_mode)
from go_libp2p_pubsub_tpu_torch.ops.propagate import forward_tick
from go_libp2p_pubsub_tpu_torch.sim import (SimConfig, TopicParams, run,
                                            scenarios, state_from_reference,
                                            state_to_numpy)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs (the
    suite runs in several worker processes; see
    tests/test_torch_engine_modes.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N, TICKS = 1024, 8


def _modes(cfg, gather, hop="xla", **over):
    return dataclasses.replace(cfg, hop_mode=hop, edge_gather_mode=gather,
                               **over)


def _arrays(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def _assert_equal(ref: dict, got: dict):
    for f, want in ref.items():
        have = got[f]
        assert have.dtype == want.dtype, (f, have.dtype, want.dtype)
        np.testing.assert_array_equal(have, want, err_msg=f)


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
    np.testing.assert_array_equal(a, b, err_msg=what)


def _port(jcfg, jtp, jst):
    return (SimConfig(**dataclasses.asdict(jcfg)),
            TopicParams(*[torch.from_numpy(np.array(x)) for x in jtp]),
            state_from_reference(_arrays(jst), device="cpu"))


@pytest.fixture(scope="module")
def ref_runs():
    """The JAX package's churn_50k runs, keyed by case: (cfg, tp, initial
    state, final state)."""
    out = {}
    cfg, tp, st = jscenarios.churn_50k(n_peers=N)
    for case, c in (("pallas", _modes(cfg, "pallas")),
                    ("mxu", _modes(cfg, "mxu")),
                    ("cap4", _modes(cfg, "pallas", validation_queue_cap=4))):
        out[case] = (c, tp, st, jrun(st, c, tp, jax.random.PRNGKey(0), TICKS))
    cfg, tp, st = jscenarios.churn_50k(n_peers=256)
    c = _modes(cfg, "pallas", hop="pallas")
    out["fused_emit"] = (c, tp, st, jrun(st, c, tp, jax.random.PRNGKey(0), 4))
    return out


def test_scenario_array_equal():
    jcfg, jtp, jst = jscenarios.churn_50k(n_peers=256)
    cfg, tp, st = scenarios.churn_50k(n_peers=256, device="cpu")
    assert SimConfig(**dataclasses.asdict(jcfg)) == cfg
    _assert_equal(_arrays(jst), state_to_numpy(st))
    for f in jtp._fields:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jtp, f)), err_msg=f)


@pytest.mark.parametrize("case", ["pallas", "mxu", "cap4", "fused_emit"])
def test_churn_run_equal(ref_runs, case):
    """The acceptance runs: every SimState field after the run, exact."""
    jcfg, jtp, jst, jout = ref_runs[case]
    cfg, tp, st = _port(jcfg, jtp, jst)
    out = run(st, cfg, tp, rng.PRNGKey(0, device="cpu"), int(jout.tick),
              device="cpu")
    ref = _arrays(jout)
    _assert_equal(ref, state_to_numpy(out))
    # non-vacuous: messages moved, churn took edges down, the gater counted
    assert ref["delivered_total"] > 0 and ref["fault_flags"] == 0
    assert (ref["connected"] != _arrays(jst)["connected"]).any()
    assert ref["gater_validate"].sum() > 0
    if case == "cap4":
        assert ref["gater_throttle"].sum() > 0


def test_mode_resolution(ref_runs):
    cfg = _port(*ref_runs["pallas"][:3])[0]
    assert resolve_hop_mode(cfg) == "xla" and resolve_emit_mode(cfg) == "xla"
    for hop in ("auto", "pallas", "pallas-mxu"):
        c = dataclasses.replace(cfg, hop_mode=hop)
        assert resolve_hop_mode(c) == "xla"           # the gater forbids it
        assert resolve_emit_mode(c) == "pallas"
        plain = dataclasses.replace(c, gater_enabled=False,
                                    validation_queue_cap=0)
        assert resolve_hop_mode(plain) == "pallas"
    with pytest.raises(ValueError):
        resolve_hop_mode(dataclasses.replace(cfg, hop_mode="bogus"))


@pytest.mark.parametrize("gather", ["pallas", "mxu"])
def test_routes_name_only_their_kernels(monkeypatch, gather):
    """On the CPU every wrapper still asks cudalib.use_kernel for its route:
    the pallas formulation asks for the bit-table, words and payload
    kernels, the mxu formulation for the flat take only, and both for the
    heartbeat's selection kernel."""
    asked = []
    real = cudalib.use_kernel

    def spy(name, *tensors):
        asked.append(name)
        return real(name, *tensors)

    monkeypatch.setattr(cudalib, "use_kernel", spy)
    cfg, tp, st = scenarios.churn_50k(n_peers=128, device="cpu")
    run(st, _modes(cfg, gather), tp, rng.PRNGKey(0, device="cpu"), 2,
        device="cpu")
    want = {"edge_table", "gather_words", "permutation_gather"} \
        if gather == "pallas" else {"take_words"}
    assert set(asked) == want | {"select_rows"}


@pytest.fixture(scope="module")
def mid(ref_runs):
    """A state with the throttle live: the cap-4 run's final state."""
    jcfg, jtp, _, jst = ref_runs["cap4"]
    assert float(np.asarray(jst.gater_throttle).sum()) > 0
    return jcfg, jtp, jst


def test_gater_decay_and_accept_data_equal(mid):
    jcfg, jtp, jst = mid
    cfg, _, st = _port(jcfg, jtp, jst)
    _assert_equal(_arrays(jgater_decay(jst, jcfg)),
                  state_to_numpy(gater_decay(st, cfg)))
    want = np.asarray(jaccept_data(jst, jcfg, jax.random.PRNGKey(5)))
    got = accept_data(st, cfg, rng.PRNGKey(5, device="cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    assert not want.all() and want.any()          # the RED drop fired


@pytest.mark.parametrize("gather", ["pallas", "mxu"])
def test_churn_edges_equal(mid, gather):
    jcfg, jtp, jst = mid
    jcfg = _modes(jcfg, gather)
    cfg, tp, st = _port(jcfg, jtp, jst)
    scores = np.random.default_rng(1).normal(0, 60, jst.connected.shape)
    scores = scores.astype(np.float32)
    want = jchurn_edges(jst, jcfg, jtp, jax.random.PRNGKey(9),
                        scores_all=scores)
    got = churn_edges(st, cfg, tp, rng.PRNGKey(9, device="cpu"),
                      scores_all=torch.from_numpy(scores))
    _assert_equal(_arrays(want), state_to_numpy(got))
    assert (np.asarray(want.connected) != np.asarray(jst.connected)).any()


def test_heartbeat_with_ride_along_equal(mid):
    jcfg, jtp, jst = mid
    jcfg = _modes(jcfg, "mxu")
    cfg, tp, st = _port(jcfg, jtp, jst)
    answers = jax.numpy.where(jst.malicious[None, :], jax.numpy.uint32(0),
                              jpack_words(jst.deliver_tick < JNEVER))
    want = jheartbeat(jst, jcfg, jtp, jax.random.PRNGKey(3),
                      extra_words=[answers])
    got = heartbeat(st, cfg, tp, rng.PRNGKey(3, device="cpu"),
                    extra_words=[_t(answers)])
    _assert_equal(_arrays(want.state), state_to_numpy(got.state))
    for f in ("scores", "scores_all", "inc_gossip", "fwd_send"):
        _same(getattr(want, f), getattr(got, f), f)
    assert len(want.extra_routed) == len(got.extra_routed) == 1
    _same(want.extra_routed[0], got.extra_routed[0], "extra_routed")


@pytest.mark.parametrize("budget", [5000, 5])
def test_forward_tick_nonfused_equal(mid, budget):
    """One heartbeat + non-fused forward_tick, under the IWANT budget that
    cannot bind (5000 >= M) and one that does (5)."""
    jcfg, jtp, jst = mid
    jcfg = _modes(jcfg, "pallas", max_iwant_per_tick=budget)
    cfg, tp, _ = _port(jcfg, jtp, jst)
    hb = jheartbeat(jst, jcfg, jtp, jax.random.PRNGKey(4))
    want = jforward(hb.state, jcfg, jtp, hb.inc_gossip, hb.scores,
                    jax.random.PRNGKey(6), fwd_send=hb.fwd_send)
    got = forward_tick(state_from_reference(_arrays(hb.state), device="cpu"),
                       cfg, tp, _t(hb.inc_gossip), _t(hb.scores),
                       rng.PRNGKey(6, device="cpu"), fwd_send=_t(hb.fwd_send))
    _assert_equal(_arrays(want), state_to_numpy(got))
    assert int((np.asarray(want.iwant_pending) >= 0).sum()) > 0


@pytest.mark.parametrize("gather", ["pallas", "mxu"])
def test_edge_gather_equal(mid, gather):
    """The receiver view of per-edge bool masks through the packed
    exchange, one mask and two at once, on a state where churn has taken
    edges down; and of a float32 plane with a fill through the indexed
    gather, equal to the reference's."""
    jcfg, jtp, jst = mid
    _, _, st = _port(jcfg, jtp, jst)
    rng_np = np.random.default_rng(11)
    shape = np.asarray(jst.mesh).shape
    masks = [rng_np.random(shape) < p for p in (0.3, 0.7)]
    _same(jedge_gather(jax.numpy.asarray(masks[0]), jst, mode=gather),
          edge_gather(torch.from_numpy(masks[0]), st, mode=gather), "bool")
    want = jedge_gather_packed([jax.numpy.asarray(x) for x in masks], jst,
                               mode=gather)
    got, extras = edge_gather_packed([torch.from_numpy(x) for x in masks], st,
                                     mode=gather)
    assert len(want) == len(got) == 2 and extras == []
    for i, (a, b) in enumerate(zip(want, got)):
        _same(a, b, f"packed mask {i}")
    vals = rng_np.standard_normal(shape).astype(np.float32)
    _same(jedge_gather(jax.numpy.asarray(vals), jst, fill=-1.0, mode=gather),
          edge_gather(torch.from_numpy(vals), st, fill=-1.0, mode=gather),
          "float32 fill -1")


@pytest.mark.parametrize("gather", ["pallas", "mxu"])
def test_symmetric_value_equal(mid, gather):
    """A float32 per-edge value made equal on both directions of each edge
    (the payload permute on float32 bits, NaN and -0.0 included)."""
    jcfg, jtp, jst = mid
    _, _, st = _port(jcfg, jtp, jst)
    vals = np.random.default_rng(12).standard_normal(
        np.asarray(jst.connected).shape).astype(np.float32)
    vals.flat[:2] = [np.nan, -0.0]
    want = np.asarray(jsym_value(jst, jax.numpy.asarray(vals), gather))
    got = _symmetric_value(st, torch.from_numpy(vals), gather).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
