"""Parity of the port's BASELINE scenarios (go_libp2p_pubsub_tpu_torch/sim/
scenarios.py) with the JAX package's on the CPU.

- ``single_topic_1k`` (config #1), ``beacon_10k`` (config #2: T = 9 topics,
  K = 48 slots) and ``sybil_small`` (config #4 at sweep scale: 20% sybils
  on 64 IP groups, connection churn with PX) at 256 peers: the built
  config, topic params and state equal to the reference's, then 8 ticks
  from PRNGKey(0), every field exact after every tick against the
  reference's jitted step on ``engine.run``'s own split of the key (for
  single_topic_1k also the last tick against ``engine.run`` itself). The port takes its fused
  kernels' plain versions where the reference's ``"auto"`` takes its XLA
  path (the two are bit-identical in the reference).
- The frontier family: ``frontier_spec(4096)``'s underlay and
  subscriptions equal to the reference's, whole and as ``rows=`` shards;
  one step of ``frontier(512)`` equal to the reference's, and of its
  compact XL form ``frontier_4m(512)``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.sim import scenarios as jscenarios
from go_libp2p_pubsub_tpu.sim.engine import run as jrun
from go_libp2p_pubsub_tpu.sim.engine import step_jit as jstep
from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.ops.hopkernel import resolve_hop_mode
from go_libp2p_pubsub_tpu_torch.sim import (SimConfig, invariants, scenarios,
                                            state_to_numpy, step)


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


N, TICKS = 256, 8
BASELINE = ["single_topic_1k", "beacon_10k", "sybil_small"]


def _arrays(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def _assert_equal(ref: dict, got: dict, where: str = ""):
    for f, want in ref.items():
        have = got[f]
        assert have.dtype == want.dtype, (f, have.dtype, want.dtype)
        np.testing.assert_array_equal(have, want, err_msg=f"{f} {where}")


def _built(name):
    jcfg, jtp, jst = getattr(jscenarios, name)(n_peers=N)
    cfg, tp, st = getattr(scenarios, name)(n_peers=N, device="cpu")
    return (jcfg, jtp, jst), (cfg, tp, st)


@pytest.mark.parametrize("name", BASELINE)
def test_builder_equal(name):
    (jcfg, jtp, jst), (cfg, tp, st) = _built(name)
    assert SimConfig(**dataclasses.asdict(jcfg)) == cfg
    _assert_equal(_arrays(jst), state_to_numpy(st))
    for f in jtp._fields:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jtp, f)), err_msg=f)


@pytest.mark.parametrize("name", BASELINE)
def test_baseline_run_equal(name):
    """The acceptance runs: every field after every tick, exact."""
    (jcfg, jtp, jst), (cfg, tp, st) = _built(name)
    jkeys = jax.random.split(jax.random.PRNGKey(0), TICKS)
    keys = rng.split(rng.PRNGKey(0, device="cpu"), TICKS)
    js = jst
    for i in range(TICKS):
        js = jstep(js, cfg=jcfg, tp=jtp, key=jkeys[i])
        st = step(st, cfg, tp, keys[i], device="cpu")
        _assert_equal(_arrays(js), state_to_numpy(st), f"after tick {i}")
    if name == "single_topic_1k":
        # the per-tick reference is engine.run's own scan, tick by tick
        _assert_equal(_arrays(jrun(jst, jcfg, jtp, jax.random.PRNGKey(0),
                                   TICKS)), state_to_numpy(st), "engine.run")
    assert float(st.delivered_total) > 0
    assert not int(st.fault_flags) & invariants.VIOLATION_MASK
    assert resolve_hop_mode(cfg) == "pallas"
    if name == "beacon_10k":
        assert (cfg.n_topics, cfg.k_slots) == (9, 48)
    if name == "sybil_small":
        # churn took edges down; sybils exist and publish
        known = st.neighbors >= 0
        assert int((known & ~st.connected).sum()) > 0
        assert bool(st.malicious.any())


def test_frontier_spec_equal():
    n = 4096
    jcfg, jtp, jtopo, jsub = jscenarios.frontier_spec(n)
    cfg, tp, topo, sub = scenarios.frontier_spec(n, device="cpu")
    assert SimConfig(**dataclasses.asdict(jcfg)) == cfg
    np.testing.assert_array_equal(sub, jsub)
    for f in jtopo._fields:
        a, b = getattr(topo, f), getattr(jtopo, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in jtp._fields:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jtp, f)), err_msg=f)
    for rows in ((0, 1000), (1000, n - 1000)):
        jshard = jscenarios.frontier_spec(n, rows=rows)[2]
        shard = scenarios.frontier_spec(n, rows=rows, device="cpu")[2]
        for f in jshard._fields:
            np.testing.assert_array_equal(getattr(shard, f),
                                          getattr(jshard, f), err_msg=f)
    assert scenarios.FRONTIER_NS == jscenarios.FRONTIER_NS
    assert scenarios.frontier_cfg(2 ** 20) == SimConfig(**dataclasses.asdict(
        jscenarios.frontier_cfg(2 ** 20)))


def test_frontier_step_is_refused_naming_its_item():
    """Since Queue 1 item 3 a frontier config steps (under its ``sort``
    exchanges), equal to the reference's jitted step; since item 5 the
    compact XL form builds and steps too, equal to the reference's."""
    jcfg, jtp, jst = jscenarios.frontier(512)
    cfg, tp, st = scenarios.frontier(512, device="cpu")
    _assert_equal(_arrays(jst), state_to_numpy(st))
    want = jstep(jst, cfg=jcfg, tp=jtp, key=jax.random.PRNGKey(0))
    got = step(st, cfg, tp, rng.PRNGKey(0, device="cpu"), device="cpu")
    _assert_equal(_arrays(want), state_to_numpy(got), "after one tick")
    jcfg, jtp, jst = jscenarios.frontier_4m(512)
    cfg, tp, st = scenarios.frontier_4m(512, device="cpu")
    assert cfg.state_precision == "compact"
    _assert_equal(_arrays(jst), state_to_numpy(st), "compact init")
    want = jstep(jst, cfg=jcfg, tp=jtp, key=jax.random.PRNGKey(0))
    got = step(st, cfg, tp, rng.PRNGKey(0, device="cpu"), device="cpu")
    _assert_equal(_arrays(want), state_to_numpy(got), "compact tick")
