"""The port's adversary families (go_libp2p_pubsub_tpu_torch/sim/
adversary.py) against the JAX package's on the CPU: eclipse, censorship
and flash crowd here, slow links and diurnal churn in
tests/test_torch_families_churn.py (one JAX compile a family; the two
modules split the cost).

Each family at 128 peers (K = 16, degree 6) for its own ``n_ticks`` (40 or
55, what tests/test_adversary.py runs): the built config, topic params,
contracts and state equal to the reference's; then every field after every
tick and every health row equal to the reference's jitted step on
``run_with_contracts``' keys; the contract results of the port's rows
equal the reference's evaluation of its rows, whatever they are (the
eclipse verdict fails in the reference too: ROADMAP.md Queue 3). The
port's ``run_with_contracts`` itself runs the censorship family (the
shortest run) and ends on that trajectory.

The two health columns read from ``compute_scores`` (``score_mean``,
``score_min``) are compared to rtol 1e-5: XLA's CPU build contracts that
function's multiply-adds into fused multiply-adds, one rounding where the
port (and the reference's source) round twice, so a score can sit one
ulp apart (ROADMAP.md Queue 3). Every other column and every state field
is exact.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.sim import adversary as jadv
from go_libp2p_pubsub_tpu.sim.engine import step_jit as jstep
from go_libp2p_pubsub_tpu.sim.telemetry import (health_record_jit,
                                                record_to_row)
from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.sim import (adversary, scenarios,
                                            state_to_numpy, step, telemetry)


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


def _same_result(got, want):
    assert (got.kind, got.status, got.detail, got.measured) == \
        (want.kind, want.status, want.detail, want.measured)


N_FAMILY = 128

# the health columns read from compute_scores: not exact against XLA's CPU
# build, which contracts its multiply-adds into FMAs (ROADMAP.md Queue 3)
SCORE_COLUMNS = ("score_mean", "score_min")


def _family_kw():
    return dict(n_peers=N_FAMILY, k_slots=16, degree=6)


def check_family(name):
    """The family ``name`` (an ``adversary.ATTACKS`` key) against the
    reference's (module docstring)."""
    jscn = jadv.ATTACKS[name](**_family_kw())
    scn = adversary.ATTACKS[name](**_family_kw(), device="cpu")
    assert scn.name == jscn.name and scn.n_ticks == jscn.n_ticks
    assert dataclasses.asdict(scn.cfg) == dataclasses.asdict(
        scenarios.SimConfig(**dataclasses.asdict(jscn.cfg)))
    for f, x in zip(jscn.tp._fields, jscn.tp):
        np.testing.assert_array_equal(getattr(scn.tp, f).numpy(),
                                      np.asarray(x), err_msg=f)
    assert adversary.contracts_to_json(scn.contracts) == \
        jadv.contracts_to_json(jscn.contracts)
    _assert_equal(_arrays(jscn.state), scn.state, "built")
    # the reference's run_with_contracts trajectory, tick by tick
    ticks = jscn.n_ticks
    jcfg = dataclasses.replace(jscn.cfg, hop_mode="xla")
    jkeys = jax.random.split(jax.random.PRNGKey(0), ticks)
    keys = rng.split(rng.PRNGKey(0, device="cpu"), ticks)
    jst, st = jscn.state, scn.state
    jrows, port_rows = [], []
    for i in range(ticks):
        jst = jstep(jst, cfg=jcfg, tp=jscn.tp, key=jkeys[i])
        st = step(st, scn.cfg, scn.tp, keys[i], device="cpu")
        _assert_equal(_arrays(jst), st, f"{name} tick {i}")
        jrows.append(record_to_row(health_record_jit(jst, jscn.cfg,
                                                     jscn.tp)))
        row = telemetry.record_to_row(telemetry.health_record(
            st, scn.cfg, scn.tp))
        port_rows.append(row)
        assert row.keys() == jrows[-1].keys()
        for k in row:
            if k in SCORE_COLUMNS:
                np.testing.assert_allclose(row[k], jrows[-1][k], rtol=1e-5)
            else:
                assert row[k] == jrows[-1][k], (name, i, k)
    want = jadv.evaluate_contracts(jscn.contracts, jrows, final=True)
    if name == "censor_small":
        rep = adversary.run_with_contracts(scn, device="cpu")
        _assert_equal(_arrays(jst), rep.state, f"{name} run_with_contracts")
        rows = rep.rows
        assert rep.fault_flags == int(np.asarray(jst.fault_flags))
        assert rep.summary()["contracts"] == [
            {"kind": w.kind, "status": w.status, "detail": w.detail}
            for w in want]
    else:
        rows = port_rows
    assert len(rows) == ticks
    for r, w in zip(rows, jrows):
        assert {k: v for k, v in r.items() if k not in SCORE_COLUMNS} == \
            {k: v for k, v in w.items() if k not in SCORE_COLUMNS}
    got = adversary.evaluate_contracts(scn.contracts, rows, final=True)
    for g, w in zip(got, want):
        _same_result(g, w)


@pytest.mark.parametrize("name", ["eclipse_small", "censor_small",
                                  "flashcrowd_small"])
def test_family_trajectory_and_contracts_equal_the_reference(name):
    check_family(name)
