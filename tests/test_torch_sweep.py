"""Parity of the port's score sweep (go_libp2p_pubsub_tpu_torch/
sweep_scores.py) with scripts/sweep_scores.py, on the CPU.

The reference test's grid (tests/test_sweep_scores.py: sybil_small and
partition_small x baseline and p4_harsh, 128 peers, 10 ticks, 1 seed) run
by both packages gives the same rows: delivery and resistance within 1e-4
(both are rounded to 4 places), every other column exact. A second call on
the port's journal runs no fleet and gives the same rows; a journal of
another grid or another device type does not stand in. The variants, the
Pareto marks and the table match the reference's.
"""

import json

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.sim import scenarios as jscenarios
from go_libp2p_pubsub_tpu_torch import sweep_scores as sw
from go_libp2p_pubsub_tpu_torch.sim import scenarios
from scripts import sweep_scores as jsw

GRID = dict(n=128, ticks=10, seeds=1)
SCENARIOS = ["sybil_small", "partition_small"]
VARIANTS = ["baseline", "p4_harsh"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs (the
    suite runs in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    journal = str(tmp_path_factory.mktemp("sweep") / "sweep.jsonl")
    lines = []
    rows = sw.run_sweep(SCENARIOS, VARIANTS, journal=journal,
                        emit=lines.append, device="cpu", **GRID)
    jrows = jsw.run_sweep(SCENARIOS, VARIANTS, emit=lambda s: None, **GRID)
    return journal, rows, lines, jrows


def _same_rows(rows, jrows):
    assert len(rows) == len(jrows)
    for r, j in zip(rows, jrows):
        assert r.keys() == j.keys()
        for k, v in j.items():
            if k in ("delivery", "resistance") and v is not None:
                assert abs(r[k] - v) <= 1e-4, (r["scenario"], k, r[k], v)
            else:
                assert r[k] == v, (r["scenario"], k, r[k], v)


def test_rows_equal_the_reference(sweeps):
    _, rows, lines, jrows = sweeps
    _same_rows(rows, jrows)
    assert [(r["scenario"], r["variant"]) for r in rows] == [
        (s, v) for s in SCENARIOS for v in VARIANTS]
    assert all(r["resistance"] is None for r in rows
               if r["scenario"] == "partition_small")
    done = [json.loads(ln) for ln in lines
            if json.loads(ln).get("info") == "fleet done"]
    # baseline and p4_harsh share a config: one fleet group a scenario
    assert [(d["scenario"], d["members"], d["groups"]) for d in done] == [
        (s, 2, 1) for s in SCENARIOS]


def test_journal_rerun_runs_no_fleet(sweeps):
    journal, rows, _, _ = sweeps
    with open(journal) as f:
        recs = [json.loads(ln) for ln in f]
    assert len(recs) == 4
    assert all(r["env"] == {**GRID, "platform": "cpu"} for r in recs)
    lines = []
    again = sw.run_sweep(SCENARIOS, VARIANTS, journal=journal,
                         emit=lines.append, device="cpu", **GRID)
    assert again == rows
    infos = [json.loads(ln).get("info") for ln in lines]
    assert infos.count("journal skip") == 4 and "fleet done" not in infos
    with open(journal) as f:
        assert sum(1 for _ in f) == 4


def test_other_grid_or_device_journal_does_not_stand_in(sweeps, tmp_path):
    journal, _, _, _ = sweeps
    other = str(tmp_path / "cuda.jsonl")
    with open(journal) as f, open(other, "w") as g:
        for ln in f:
            r = json.loads(ln)
            r["env"]["platform"] = "cuda"
            g.write(json.dumps(r) + "\n")
    for path, ticks in ((other, GRID["ticks"]), (journal, 8)):
        lines = []
        sw.run_sweep(["sybil_small"], ["baseline"], journal=path,
                     emit=lines.append, device="cpu",
                     **{**GRID, "ticks": ticks})
        assert not any(json.loads(ln).get("info") == "journal skip"
                       for ln in lines)


def test_variants_apply_as_the_reference():
    assert sw.VARIANTS == jsw.VARIANTS
    assert sw.SCENARIO_NAMES == jsw.SCENARIO_NAMES
    assert sw.ATTACK_SCENARIOS == jsw.ATTACK_SCENARIOS
    cfg, tp, _ = scenarios.sybil_small(n_peers=128, device="cpu")
    jcfg, jtp, _ = jscenarios.sybil_small(n_peers=128)
    for name, spec in sw.VARIANTS.items():
        out_cfg, out_tp = sw.apply_variant(cfg, tp, spec)
        jout_cfg, jout_tp = jsw.apply_variant(jcfg, jtp, spec)
        for f in jout_tp._fields:
            np.testing.assert_array_equal(
                getattr(out_tp, f).numpy(), np.asarray(getattr(jout_tp, f)),
                err_msg=f"{name} {f}")
        for f in ("ip_colocation_factor_weight", "behaviour_penalty_weight",
                  "app_specific_weight", "gater_enabled",
                  "validation_queue_cap"):
            assert getattr(out_cfg, f) == getattr(jout_cfg, f), (name, f)
    assert isinstance(out_tp.topic_weight, torch.Tensor)


def test_pareto_and_table(sweeps, tmp_path):
    _, rows, _, jrows = sweeps
    pts = [{"delivery": 0.9, "resistance": 0.5},
           {"delivery": 0.8, "resistance": 0.9},
           {"delivery": 0.7, "resistance": 0.4},
           {"delivery": 0.95, "resistance": None}]
    assert sw._pareto(pts) == jsw._pareto(pts) == {0, 1}
    table = sw.render_table(rows, "cpu")
    assert "| scenario | variant | delivery | resistance | frontier |" \
        in table and "n/a" in table and "platform=cpu" in table
    assert table.splitlines()[2:] == \
        sw.render_table(jrows, "cpu").splitlines()[2:]
    path = str(tmp_path / "frontier.md")
    sw.write_table(rows, path, "cpu")
    first = open(path).read()
    assert first.startswith(sw.TABLE_BEGIN) and sw.TABLE_END in first
    with open(path, "w") as f:
        f.write("# notes\n\nkept\n\n" + first)
    sw.write_table(rows, path, "cpu")
    assert open(path).read() == "# notes\n\nkept\n\n" + first


def test_attack_family_cell_judges_its_contracts():
    """An adversary family's cell runs the telemetry lane for the attack's
    own n_ticks and counts the contracts its member fails, as
    ``adversary.run_with_contracts`` judges the same run."""
    from go_libp2p_pubsub_tpu_torch import rng
    from go_libp2p_pubsub_tpu_torch.sim import adversary
    fleets = []
    rows = sw.run_sweep(["eclipse_small"], ["baseline"], n=128, ticks=10,
                        seeds=1, emit=lambda s: None, device="cpu",
                        on_fleet=lambda *a: fleets.append(a))
    scn = adversary.eclipse(n_peers=128, device="cpu")
    rep = adversary.run_with_contracts(
        scn, key=rng.PRNGKey(sw.SEED_KEY_BASE, device="cpu"), device="cpu")
    (row,) = rows
    failed = [r.kind for r in rep.results if not r.passed]
    assert row["ticks"] == scn.n_ticks > 10
    assert row["contracts"] == len(scn.contracts)
    assert row["contracts_failed"] == len(failed)
    assert row["contracts_failed_kinds"] == sorted(set(failed))
    assert row["fault_flags"] == rep.fault_flags
    (scen, members, results), = fleets
    assert scen == "eclipse_small" and len(members) == len(results) == 1
    assert [dict(r, member=-1) for r in results[0].health_rows] == rep.rows
