"""Parity of the port's adversary library (go_libp2p_pubsub_tpu_torch/sim/
adversary.py) and scenario registry (sim/scenarios.py ``SCENARIOS``) with
the JAX package's on the CPU.

- contract evaluation on synthetic row streams (pass, fail, pending; final
  and live), the JSON forms and their refusals (the reference's messages),
  ``contracts_from_schedule`` and ``member_rows``;
- the streaming monitors against the batch evaluators at every prefix of
  tests/test_verdict_plane.py's streams, their transition events and
  state tokens against the reference's monitors;
- the positive control: ``ScoreResponse`` fails with scoring off (the
  five families' trajectories: tests/test_torch_families.py);
- every ``SCENARIOS`` name builds the reference's config, topic params and
  state at a small size.
"""

import dataclasses

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.sim import adversary as jadv
from go_libp2p_pubsub_tpu.sim import scenarios as jscenarios
from go_libp2p_pubsub_tpu.sim.faults import attack_schedule as jschedule
from go_libp2p_pubsub_tpu_torch.sim import (adversary, scenarios,
                                            state_to_numpy)
from go_libp2p_pubsub_tpu_torch.sim.faults import attack_schedule

from test_verdict_plane import PARITY_CONTRACTS, PARITY_STREAMS


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


def _assert_equal(want: dict, got, where: str = ""):
    got = state_to_numpy(got)
    for f, a in want.items():
        assert got[f].dtype == a.dtype, (f, got[f].dtype, a.dtype, where)
        np.testing.assert_array_equal(got[f], a, err_msg=f"{f} {where}")


def _port(c):
    """The port's contract of a reference contract (via its JSON form)."""
    return adversary.contract_from_json(jadv.contract_to_json(c))


def _same_result(got, want):
    assert (got.kind, got.status, got.detail, got.measured) == \
        (want.kind, want.status, want.detail, want.measured)


# --- contracts ------------------------------------------------------------

@pytest.mark.parametrize("stream", list(PARITY_STREAMS))
@pytest.mark.parametrize("final", [True, False])
def test_contract_evaluation_matches_the_reference(stream, final):
    rows = PARITY_STREAMS[stream]
    for jc in PARITY_CONTRACTS:
        c = _port(jc)
        assert adversary.contract_to_json(c) == jadv.contract_to_json(jc)
        _same_result(c.evaluate(rows, final=final),
                     jc.evaluate(rows, final=final))
    got = adversary.evaluate_contracts([_port(c) for c in PARITY_CONTRACTS],
                                       rows, final=final)
    want = jadv.evaluate_contracts(PARITY_CONTRACTS, rows, final=final)
    for g, w in zip(got, want):
        _same_result(g, w)
        assert g.passed == w.passed


BAD_SPECS = [
    {"kind": "nope"}, {"kind": None}, [1, 2], "delivery_floor",
    {"kind": "delivery_floor", "floor": 0.5, "bogus": 1},
    {"kind": "delivery_floor", "floor": None},
    {"kind": "delivery_floor", "floor": True},
    {"kind": "delivery_floor", "floor": 1.5},
    {"kind": "delivery_floor", "floor": 0.5, "start": 4, "end": 4},
    {"kind": "delivery_floor", "floor": 0.5, "start": 1.5},
    {"kind": "recovery_ceiling", "after": 3, "within": 0},
    {"kind": "score_response", "by": -1},
    {"kind": "score_response", "by": 3, "attacker_frac": "half"},
]


@pytest.mark.parametrize("i", range(len(BAD_SPECS)))
def test_contract_json_refusals_match_the_reference(i):
    spec = BAD_SPECS[i]
    with pytest.raises(ValueError) as want:
        jadv.contract_from_json(spec)
    with pytest.raises(ValueError) as got:
        adversary.contract_from_json(spec)
    assert str(got.value) == str(want.value)


def test_schedule_defaults_and_member_rows():
    for build in (jadv.eclipse, jadv.diurnal, jadv.slow_link):
        jcfg = build(n_peers=32).cfg
        sched = jschedule(jcfg.fault_plan)
        assert attack_schedule(scenarios.SimConfig(
            **dataclasses.asdict(jcfg)).fault_plan) == sched
        got = adversary.contracts_to_json(
            adversary.contracts_from_schedule(sched))
        assert got == jadv.contracts_to_json(jadv.contracts_from_schedule(
            sched))
    rows = [{"tick": 0, "member": m} for m in (-1, 0, 1, 0)]
    assert adversary.member_rows(rows, 0) == jadv.member_rows(rows, 0)


# --- monitors ---------------------------------------------------------------

@pytest.mark.parametrize("stream", list(PARITY_STREAMS))
def test_monitors_match_batch_and_the_reference(stream):
    rows = PARITY_STREAMS[stream]
    contracts = tuple(_port(c) for c in PARITY_CONTRACTS)
    mons = adversary.ContractMonitors(contracts)
    jmons = jadv.ContractMonitors(PARITY_CONTRACTS)
    for i, row in enumerate(rows):
        assert mons.fold_rows([row]) == jmons.fold_rows([row])
        for m, c in zip(mons.monitors, contracts):
            _same_result(m.result(final=False),
                         c.evaluate(rows[:i + 1], final=False))
        assert mons.state_token() == jmons.state_token()
        back = adversary.ContractMonitors.from_token(
            jmons.state_token(), contracts)
        assert back.statuses == mons.statuses
    assert mons.finalize() == jmons.finalize()
    for m, c in zip(mons.results(final=True), contracts):
        _same_result(m, c.evaluate(rows, final=True))
    with pytest.raises(ValueError, match="does not match"):
        adversary.ContractMonitors.from_token(mons.state_token(),
                                              contracts[:1])


def test_positive_control_score_response_fails_without_scoring():
    scn = adversary.censorship(n_peers=128, k_slots=16, degree=6,
                               n_ticks=16, start=4, end=12, device="cpu")
    off = dataclasses.replace(scn.cfg, scoring_enabled=False)
    rep = adversary.run_with_contracts(adversary.AttackScenario(
        off, scn.tp, scn.state, scn.contracts, scn.n_ticks, scn.name),
        device="cpu")
    sr = [r for r in rep.results if r.kind == "score_response"]
    assert sr and sr[0].status == "fail", sr
    assert all(r["attacker_graylisted"] == 0 for r in rep.rows)


def test_censorship_refuses_a_victim_elsewhere():
    with pytest.raises(ValueError, match="victim must be 0"):
        adversary.censorship(n_peers=32, victim=3, device="cpu")


# --- the registry ---------------------------------------------------------------

REGISTRY_KW = {
    "1k_single_topic": dict(n_peers=64),
    "10k_beacon": dict(n_peers=64),
    "50k_churn": dict(n_peers=64),
    "100k_sybil": dict(n_peers=64),
    "50k_partition": dict(n_peers=64),
    "10k_outage": dict(n_peers=64),
    "sybil_small": dict(n_peers=64),
    "partition_small": dict(n_peers=64),
    "outage_small": dict(n_peers=64),
    "eclipse_small": dict(n_peers=64),
    "censor_small": dict(n_peers=64),
    "flashcrowd_small": dict(n_peers=64),
    "slowlink_small": dict(n_peers=64),
    "diurnal_small": dict(n_peers=64),
    "eclipse_50k": dict(n_peers=96),
    "flashcrowd_50k": dict(n_peers=96),
    "frontier_250k": dict(n_peers=256),
    "frontier_500k": dict(n_peers=256),
    "frontier_1m": dict(n_peers=256),
    "frontier_4m": dict(n_peers=256),
    "frontier_10m": dict(n_peers=256),
}


def test_registry_names_match_the_reference():
    assert list(scenarios.SCENARIOS) == list(jscenarios.SCENARIOS)
    assert set(REGISTRY_KW) == set(scenarios.SCENARIOS)


@pytest.mark.parametrize("name", list(REGISTRY_KW))
def test_every_scenario_builds_the_reference_state(name):
    kw = REGISTRY_KW[name]
    jcfg, jtp, jst = jscenarios.SCENARIOS[name](**kw)
    cfg, tp, st = scenarios.SCENARIOS[name](**kw, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        scenarios.SimConfig(**dataclasses.asdict(jcfg)))
    for f, x in zip(jtp._fields, jtp):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(x),
                                      err_msg=f)
    _assert_equal(_arrays(jst), st, name)
