"""The port's cross-half runs against the JAX package's, on the CPU (slow
tier).

- tests/test_statistical_parity.py's 512-peer run: the port's functional
  half (its runtime) returns the reference runtime's mesh degrees,
  delivery fraction and latencies, its ``from_hosts`` the same underlay,
  and the port's batched half on it the reference's state; the shared
  parity bands hold on the port's two halves.
- chip_smoke.py phase 11c's fault plan on the reference's two halves: the
  injector's cuts are the engine's down slots, and each port half equals
  its reference half;
- tests/test_cross_half_fuzz.py's fifty random scenarios: each port half
  equals its reference half (mesh degrees, deliveries, underlay, the
  batched state after 16 ticks). The reference's own band checks are not
  repeated: they fail at the reference's case 25 (ROADMAP Queue 3), and
  what the port owes is equality with the reference, case by case.

Both halves of each package run in this one process: a node seeds its RNG
from its peer id's str hash.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.sim import SimConfig as JConfig
from go_libp2p_pubsub_tpu.sim import init_state as jinit_state
from go_libp2p_pubsub_tpu.sim import topology as jtopology
from go_libp2p_pubsub_tpu.sim.config import TopicParams as JTopicParams
from go_libp2p_pubsub_tpu.sim.engine import run as jrun
from go_libp2p_pubsub_tpu_torch import rng as prng
from go_libp2p_pubsub_tpu_torch.sim import (SimConfig, init_state, run,
                                            state_to_numpy, topology)
from go_libp2p_pubsub_tpu_torch.sim.config import TopicParams

from test_torch_runtime import PORT, REF, load_test_module

pytestmark = pytest.mark.slow


def _same_underlay(jtopo, topo):
    for f in jtopo._fields:
        np.testing.assert_array_equal(getattr(topo, f), getattr(jtopo, f),
                                      err_msg=f)


def _same_state(jst, st, where):
    got = state_to_numpy(st)
    for f in jst._fields:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jst, f)),
                                      err_msg=f"{where}: {f}")


def _batched(jcfg, jtp, topo, subscribed, seed, ticks):
    """``ticks`` of the reference's ``run`` and of the port's on the same
    underlay (the reference's non-fused hop: bit-identical to its fused
    kernels, fast on the CPU)."""
    jst = jrun(jinit_state(jcfg, topo, subscribed=subscribed), jcfg, jtp,
               jax.random.PRNGKey(seed), ticks)
    cfg = SimConfig(**dataclasses.asdict(jcfg))
    st = init_state(cfg, topology.Topology(*topo), subscribed=subscribed,
                    device="cpu")
    tp = TopicParams(*(torch.from_numpy(np.array(x)) for x in jtp))
    st = run(st, cfg, tp, prng.PRNGKey(seed, device="cpu"), ticks,
             device="cpu")
    return jst, st


def test_statistical_parity_run_matches_reference():
    jmod = load_test_module("test_statistical_parity", REF)
    pmod = load_test_module("test_statistical_parity", PORT)
    jhosts, jdeg, jfrac, jlat = jmod._run_functional()
    hosts, deg_f, frac_f, lat_f = pmod._run_functional()
    np.testing.assert_array_equal(deg_f, jdeg)
    assert frac_f == jfrac
    np.testing.assert_array_equal(lat_f, jlat)
    jtopo, _ = jtopology.from_hosts(jhosts, jmod.K_SLOTS)
    topo, _ = topology.from_hosts(hosts, jmod.K_SLOTS)
    _same_underlay(jtopo, topo)
    jcfg = JConfig(n_peers=jmod.N, k_slots=jmod.K_SLOTS, n_topics=1,
                   msg_window=64, publishers_per_tick=2, prop_substeps=8,
                   scoring_enabled=True, hop_mode="xla")
    jtp = JTopicParams.from_topic_params([jmod.TSP])
    jst, st = _batched(jcfg, jtp, jtopo, np.ones((jmod.N, 1), bool), 0, 30)
    _same_state(jst, st, "statistical parity")
    deg_b = state_to_numpy(st)["mesh"][:, 0, :].sum(-1)
    jmod._assert_parity_bands(deg_f, deg_b, frac_f, lat_f)


def test_fifty_random_scenarios_each_half_matches_reference():
    jmod = load_test_module("test_cross_half_fuzz", REF)
    pmod = load_test_module("test_cross_half_fuzz", PORT)
    jcfg = dataclasses.replace(jmod._cfg(), hop_mode="xla")
    jtp = JTopicParams.disabled(2)
    master = np.random.default_rng(20260731)
    for case in range(jmod.N_SCENARIOS):
        seed = master.integers(1 << 62)
        rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(seed)
        p = jmod._scenario_params(rng_a)
        assert pmod._scenario_params(rng_b) == p
        jhosts, jsub1, jdeg, jgot = jmod._run_functional(p, rng_a)
        hosts, sub1, deg_f, got_f = pmod._run_functional(p, rng_b)
        where = f"case {case} {p}"
        np.testing.assert_array_equal(sub1, jsub1, err_msg=where)
        np.testing.assert_array_equal(deg_f, jdeg, err_msg=where)
        np.testing.assert_array_equal(got_f, jgot, err_msg=where)
        jtopo, _ = jtopology.from_hosts(jhosts, jmod.K_SLOTS)
        topo, _ = topology.from_hosts(hosts, jmod.K_SLOTS)
        _same_underlay(jtopo, topo)
        subscribed = np.stack([np.ones(jmod.N, bool), jsub1], axis=1)
        jst, st = _batched(jcfg, jtp, jtopo, subscribed,
                           p["graph_seed"] & 0x7FFFFFFF, 16)
        _same_state(jst, st, where)


def test_reference_injector_halves_agree_and_match_the_port():
    """chip_smoke.py's phase 11c plan on the reference's two halves (its
    runtime's injector, its jitted engine): they agree with each other,
    and each port half equals its reference half."""
    from test_torch_runtime_bridge import injector_halves
    jviews, jflags = injector_halves(REF)
    views, flags = injector_halves(PORT)
    assert flags == jflags
    for (t, jcut, jdown), (_, cut, down) in zip(jviews, views, strict=True):
        np.testing.assert_array_equal(jcut, jdown, err_msg=f"tick {t}")
        np.testing.assert_array_equal(cut, jcut, err_msg=f"tick {t}")
        np.testing.assert_array_equal(down, jdown, err_msg=f"tick {t}")
