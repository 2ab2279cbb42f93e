"""The port's sharded step (go_libp2p_pubsub_tpu_torch/parallel/: the
peer group of kernel_context.py, sharding.py and compile_plan's sharded
plans) on the CPU, in two gloo processes.

Every rank is a ``python -m go_libp2p_pubsub_tpu_torch.run_multihost``
process (no JAX, one torch thread) meeting the other through a file
rendezvous under ``tmp_path``. Its run writes the whole state's field
digests after every tick (``parallel.sharding.state_digests``, summed over
the ranks) and rank 0 the gathered final state; both are held against the
port's single-process run of the same keys, every field after every tick.
The configurations (tests/test_sharding.py and the guard config of
tests/test_hlo_sharded_budget.py:40-54):

- the headline shape on the fused path (kernels 1-4 through their plain
  twins here) under both routes;
- the guard config (scoring, churn with PX, flood publish, the gater)
  under ``edge_gather_mode="sort"`` and both routes;
- the guard config's final state against the reference's
  ``make_sharded_step`` on 2 of the virtual CPU devices;
- the collective budget, the counterpart of the reference's HLO grep:
  under ``"halo"`` no all-gather result exceeds 4 N ceil(K/32) elements,
  and the ``"replicated"`` control exceeds it with one of at least N K.

And the rng's row slices equal the whole draw's rows.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.parallel.sharding import state_digests
from go_libp2p_pubsub_tpu_torch.run_multihost import build
from go_libp2p_pubsub_tpu_torch.sim import engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N, K, T, M = 256, 16, 2, 64
GUARD = dict(
    n_peers=N, k_slots=K, n_topics=T, msg_window=M,
    publishers_per_tick=4, prop_substeps=4,
    scoring_enabled=True, behaviour_penalty_weight=-1.0,
    gossip_threshold=-10.0, publish_threshold=-20.0,
    graylist_threshold=-30.0,
    churn_disconnect_prob=0.02, churn_reconnect_prob=0.2,
    px_enabled=True, accept_px_threshold=-5.0, retain_score_ticks=10,
    flood_publish=True, gater_enabled=True, edge_gather_mode="sort")
GUARD_KW = {"cfg": GUARD, "degree": 6, "seed": 11}
HEADLINE_KW = {"n_peers": N}
TICKS = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs (the
    suite runs in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spawn_ranks(tmp_path, args: list, nproc: int = 2,
                timeout: float = 240.0) -> None:
    """``nproc`` run_multihost ranks over gloo on the CPU, meeting at a
    file under ``tmp_path``; a rank that fails fails the test."""
    rdv = tmp_path / "rdv"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = REPO
    env["GRAFT_CRASH_DIR"] = str(tmp_path / "crash")
    procs = []
    for r in range(nproc):
        log = open(tmp_path / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "go_libp2p_pubsub_tpu_torch.run_multihost",
             "--backend", "gloo", "--device", "cpu", "--threads", "1",
             "--coordinator", f"file://{rdv}", "--num-processes", str(nproc),
             "--process-id", str(r)] + args,
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    try:
        codes = [p.wait(timeout=timeout) for p, _ in procs]
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if any(codes):
        logs = "\n".join((tmp_path / f"rank{r}.log").read_text()[-3000:]
                         for r in range(nproc))
        raise AssertionError(f"rank exit codes {codes}:\n{logs}")


def run_ranks(tmp_path, scenario, kwargs, cfg_over=None, ticks=TICKS):
    """(per-tick digests, final-state arrays, rank 0's stats) of a 2-rank
    run."""
    spawn_ranks(tmp_path, [
        "--scenario", scenario, "--kwargs", json.dumps(kwargs),
        "--cfg", json.dumps(cfg_over or {}), "--ticks", str(ticks),
        "--digests", str(tmp_path / "d.json"),
        "--dump-state", str(tmp_path / "final"),
        "--stats", str(tmp_path / "s{rank}.json")])
    with open(tmp_path / "d.json") as f:
        digests = json.load(f)
    with np.load(tmp_path / "final.npz") as z:
        final = {k: z[k] for k in z.files}
    with open(tmp_path / "s0.json") as f:
        stats = json.load(f)
    return digests, final, stats


def single_process(scenario, kwargs, cfg_over=None, ticks=TICKS):
    """(per-tick digests, final state) of the port's single-process run
    under the same keys as the ranks' (``rng.split`` of PRNGKey(0))."""
    from go_libp2p_pubsub_tpu_torch.sim.state import state_to_numpy
    cfg, tp, st = build(scenario, kwargs, cfg_over or {}, None)
    keys = rng.split(rng.PRNGKey(0, device="cpu"), ticks)
    digests = []
    for i in range(ticks):
        st = engine._step(st, cfg, tp, keys[i])[0]
        digests.append(state_digests(st, cfg))
    return digests, state_to_numpy(st)


CASES = {
    "fused-replicated": ("headline", HEADLINE_KW, {}),
    "fused-halo": ("headline", HEADLINE_KW, {"sharded_route": "halo"}),
    "guard-replicated": ("spec", GUARD_KW, {}),
    "guard-halo": ("spec", GUARD_KW, {"sharded_route": "halo"}),
}
# the fused path exchanges no payload through the halo (its edge tables
# and kernels read replicated tables under either route): a slow leg
SLOW = {"fused-halo"}


@pytest.mark.parametrize("case", [
    pytest.param(c, marks=pytest.mark.slow) if c in SLOW else c
    for c in CASES])
def test_two_ranks_equal_single_process(case, tmp_path):
    scenario, kw, over = CASES[case]
    digests, final, stats = run_ranks(tmp_path, scenario, kw, over)
    want_d, want = single_process(scenario, kw, over)
    for i, (got, exp) in enumerate(zip(digests, want_d)):
        bad = [f for f in exp if got[f] != exp[f]]
        assert not bad, f"tick {i}: fields {bad} differ ({case})"
    for f, a in want.items():
        np.testing.assert_array_equal(final[f], a, err_msg=f"{f} ({case})")
    assert int(final["halo_overflow"]) == 0
    # the ranks exchanged rows: one collective a tick at the least
    assert stats["collectives_per_tick"] >= 1


def test_two_ranks_equal_reference_sharded_step(tmp_path):
    """The guard config under the halo route: the port's 2-rank final
    state equals the reference's sharded step on 2 virtual devices, tick
    keys ``jax.random.split(PRNGKey(0), TICKS)``: every field, float
    planes included, bit for bit."""
    from go_libp2p_pubsub_tpu.parallel.sharding import (make_mesh,
                                                        make_sharded_step,
                                                        shard_state)
    from go_libp2p_pubsub_tpu.sim import SimConfig as JConfig
    from go_libp2p_pubsub_tpu.sim import TopicParams as JTopicParams
    from go_libp2p_pubsub_tpu.sim import init_state as jinit_state
    from go_libp2p_pubsub_tpu.sim import topology as jtopology
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices (conftest XLA_FLAGS)")
    over = {"sharded_route": "halo"}
    _, final, _ = run_ranks(tmp_path, "spec", GUARD_KW, over)
    jcfg = JConfig(**{**GUARD, **over})
    jst = jinit_state(jcfg, jtopology.sparse(N, K, degree=6, seed=11))
    mesh = make_mesh(jax.devices()[:2])
    step = make_sharded_step(mesh, jcfg, JTopicParams.disabled(T))
    st = shard_state(jst, mesh, jcfg)
    for k in jax.random.split(jax.random.PRNGKey(0), TICKS):
        st = step(st, k)
    for f in st._fields:
        np.testing.assert_array_equal(final[f], np.asarray(getattr(st, f)),
                                      err_msg=f)


BUDGET = 4 * N * ((K + 31) // 32)


@pytest.mark.parametrize("route", ["halo", "replicated"])
def test_collective_budget(route, tmp_path):
    """The guard config's collectives, recorded by the group helper: under
    the halo route no all-gather result exceeds the packed budget; the
    replicated control exceeds it (test_hlo_sharded_budget.py:81)."""
    spawn_ranks(tmp_path, [
        "--scenario", "spec", "--kwargs", json.dumps(GUARD_KW),
        "--cfg", json.dumps({"sharded_route": route}), "--ticks", "3",
        "--digests", str(tmp_path / "d.json"),
        "--stats", str(tmp_path / "s{rank}.json")])
    for r in range(2):
        with open(tmp_path / f"s{r}.json") as f:
            biggest = json.load(f)["max_result_elements"]["all_gather"]
        if route == "halo":
            assert biggest <= BUDGET, (r, biggest, BUDGET)
        else:
            assert biggest > BUDGET and biggest >= N * K, (r, biggest)


@pytest.mark.parametrize("draw", ["random_bits", "uniform", "randint",
                                  "gumbel"])
def test_rng_row_slice_equals_whole_draw_rows(draw):
    """``row0`` draws rows [row0, row0 + n) of the [N, ...] draw: the
    whole draw's rows, bit for bit, at the slice's cost."""
    key = rng.PRNGKey(7, device="cpu")
    shape = (96, 3, 5)

    def draw_rows(shape, row0=0):
        if draw == "randint":
            return rng.randint(key, shape, 0, 1000, row0=row0)
        return getattr(rng, draw)(key, shape, row0=row0)
    whole = draw_rows(shape)
    for r0, nl in ((0, 32), (32, 32), (64, 32), (17, 5)):
        part = draw_rows((nl,) + shape[1:], row0=r0)
        assert torch.equal(part, whole[r0:r0 + nl]), (draw, r0)


def test_sharded_plans_refuse_by_name():
    """compile_plan's sharded plans keep the reference's refusals: an
    unknown route, and a config with degree_buckets (the bucketed plane
    has its own plan); the bucketed plan refuses telemetry."""
    from go_libp2p_pubsub_tpu_torch.parallel import compile_plan
    from go_libp2p_pubsub_tpu_torch.parallel.sharding import PeerMesh
    from go_libp2p_pubsub_tpu_torch.sim import scenarios
    mesh = PeerMesh(None, 2, 0, {"peers": 2})
    cfg, tp, _ = build("spec", GUARD_KW, {}, None)
    with pytest.raises(ValueError, match="unknown sharded_route"):
        compile_plan.sharded_step_plan(
            mesh, dataclasses.replace(cfg, sharded_route="ring"), tp)
    bcfg, btp, _ = scenarios.heavytail_eclipse(1024, device="cpu")
    with pytest.raises(ValueError, match="degree_buckets is set"):
        compile_plan.sharded_chunk_plan(mesh, bcfg, btp)
    with pytest.raises(ValueError, match="telemetry is not bucketed"):
        compile_plan.bucketed_chunk_plan(mesh, bcfg, btp, telemetry=True)
    with pytest.raises(ValueError, match="does not tile"):
        compile_plan.bucketed_chunk_plan(
            PeerMesh(None, 3, 0, {"peers": 3}), bcfg, btp)
