"""The reference and the comparison that decides ``correct``, on the CPU at
small sizes: the reference steps as the program does; a run of the
harness is correct; its control (the program's compact storage) and
planted faults in the timed path are not; the result line has the
contract's shape; without a card the run prints nothing and fails.

The harness's look for a card is skipped by calling ``run_cell`` with
``device="cpu"``; everything after it runs as on the card."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from go_libp2p_pubsub_tpu_torch import rng  # noqa: E402
from go_libp2p_pubsub_tpu_torch.core.params import TopicScoreParams  # noqa: E402
from go_libp2p_pubsub_tpu_torch.sim import engine  # noqa: E402
from go_libp2p_pubsub_tpu_torch.sim.config import SimConfig, TopicParams  # noqa: E402
from go_libp2p_pubsub_tpu_torch.sim.state import (SimState, encode_state,  # noqa: E402
                                                  init_state)
from port_bench import harness, spec, underlay  # noqa: E402
from port_bench.reference import config as rconfig  # noqa: E402
from port_bench.reference import engine as rengine  # noqa: E402
from port_bench.reference import params as rparams  # noqa: E402
from port_bench.reference import state as rstate  # noqa: E402

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
N_SMALL = 512
SEED = 4_000_000_123


def _inputs(cell: str, n: int, seed: int):
    c = spec.cell(cell)
    simkw = {**c.sim, "n_peers": n}
    topo = underlay.sparse_fast(n, simkw["k_slots"],
                                degree=c.config["degree"], seed=seed)
    sub = spec.subscriptions(n, simkw["n_topics"],
                             c.config["subscribe_prob"], seed)
    return c, simkw, topo, sub


@pytest.mark.parametrize("cell", CELLS)
def test_reference_steps_as_the_program_does(cell):
    c, simkw, topo, sub = _inputs(cell, 1024, 11)
    cfg = SimConfig(**simkw)
    tp = TopicParams.from_topic_params(
        [TopicScoreParams(**t) for t in c.topics], device="cpu")
    rcfg = rconfig.SimConfig(**simkw)
    rtp = rconfig.TopicParams.from_topic_params(
        [rparams.TopicScoreParams(**t) for t in c.topics], device="cpu")
    st = init_state(cfg, topo, subscribed=sub, device="cpu")
    rst = rstate.init_state(rcfg, topo, subscribed=sub, device="cpu")
    for f, a, b in zip(SimState._fields, st, rst):
        assert torch.equal(a, b), f
    keys = rng.split(rng.PRNGKey(5, device="cpu"), 4)
    out, rec = engine.run_keys(st, cfg, tp, keys, telemetry=True,
                               device="cpu")
    rout, rrec = rengine.run_keys(rst, rcfg, rtp, keys, telemetry=True)
    for f, a, b in zip(SimState._fields, out, rout):
        assert torch.equal(a, b), f
    for f, a, b in zip(rec._fields, rec, rrec):
        assert torch.equal(a, b), f

    # the program's compact storage departs from the f32 reference
    ccfg = dataclasses.replace(cfg, state_precision="compact")
    cout = engine.run_keys(encode_state(st, ccfg), ccfg, tp, keys,
                           device="cpu")
    mm, gap, _ = harness.judge.state_gaps(
        rstate.decode_state(rstate.SimState(*cout),
                            rconfig.SimConfig(**{**simkw,
                                                 "state_precision": "compact"})),
        rout)
    assert mm > 0 or gap > 1e-4


def _run(cell, **kw):
    return harness.run_cell(cell, SEED, 0.5, False, device="cpu",
                            overrides={"n_peers": N_SMALL,
                                       **kw.pop("overrides", {})}, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_is_correct_and_its_line_has_the_contracts_shape(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["failed"] == 0 and r["attempted"] >= 16
    assert {"hb_per_s", "setup_s"} <= set(r["metrics"])
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for v in r["checks"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(r)


@pytest.mark.parametrize("cell", ["net_100k.gossipsub", "churn_50k.churn"])
def test_the_control_is_not_correct(cell):
    r = _run(cell, overrides={"state_precision": "compact"})
    assert not r["correct"]
    assert r["checks"]["float_gap"]["value"] > \
        r["checks"]["float_gap"]["limit"]


def _unchanged(call, state, out):
    # a chunk that hands back the state it was given
    return state, out[1]


def _half(call, state, out):
    # half of the peers' rows left as they came in
    st, rec = out
    n = st.mesh.shape[0]
    return type(st)(*(torch.cat([y[:n // 2], x[n // 2:]])
                      if x.dim() and x.shape[0] == n else y
                      for x, y in zip(st, state))), rec


def _altered(call, state, out):
    # one peer's mesh row flipped where the chunk produced it
    st, rec = out
    mesh = st.mesh.clone()
    mesh[7] = ~mesh[7]
    return st._replace(mesh=mesh), rec


@pytest.mark.parametrize("tamper", [_unchanged, _half, _altered],
                         ids=["state_unchanged", "half_the_peers_left_out",
                              "an_answer_altered"])
def test_a_fault_in_the_timed_path_is_not_correct(tamper):
    r = _run("net_100k.gossipsub", tamper=tamper)
    assert not r["correct"], r["checks"]


def test_without_a_card_the_run_prints_nothing_and_fails():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, os.path.join(ROOT, "port_bench",
                                                     "run.py"),
                        "--workload", "net_100k.gossipsub", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert p.returncode != 0
    assert p.stdout == ""


def test_without_the_program_the_run_prints_nothing_and_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "port_bench"),
                    tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        "churn_50k.calm", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=tmp_path)
    assert p.returncode != 0
    assert p.stdout == ""
    assert "go_libp2p_pubsub_tpu_torch" in p.stderr


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the benchmark runs only there")


@pytest.mark.cuda
def test_one_run_on_the_card(card):
    p = subprocess.run([sys.executable, os.path.join(ROOT, "port_bench",
                                                     "run.py"),
                        "--workload", "net_100k.gossipsub", "--seed",
                        str(SEED), "--seconds", "2", "--trace", "0"],
                       capture_output=True, text=True, timeout=1200,
                       cwd=ROOT)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
