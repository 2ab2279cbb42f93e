"""The port's resilience plane (go_libp2p_pubsub_tpu_torch/parallel/
resilience.py, its own copy of the reference's jax-free module, and
mh_supervisor.py) against the reference's (tests/test_resilience.py:31-175
and its elastic checkpoint).

- ``ChaosPlan``: the same specs parse to the same dicts, the same junk is
  refused by name, and a plan fires once per run directory, its marker
  read by a second instance, as the reference's;
- ``RankLiveness``: the heartbeat files and the dead-peer verdicts over
  missing, stale, refreshed and finished peers, as the reference's;
- the supervisor: a dead peer aborts the run at a chunk boundary;
- the elastic checkpoint: a 2-rank run's checkpoint (``processes=2``)
  resumes in one process and ends equal to the uninterrupted run;
- the relaunch: ``mh_supervisor`` runs 2 gloo ranks, a ChaosPlan
  SIGKILLs rank 1 after the first chunk, the group relaunches from the
  checkpoint and its final state equals the uninterrupted run.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.parallel import resilience as jres
from go_libp2p_pubsub_tpu_torch import mh_supervisor, rng
from go_libp2p_pubsub_tpu_torch.parallel import resilience
from go_libp2p_pubsub_tpu_torch.run_multihost import build
from go_libp2p_pubsub_tpu_torch.sim import engine
from go_libp2p_pubsub_tpu_torch.sim.state import state_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = {"n_peers": 256}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("spec", [
    "kill@1:4, stall@0:2:1.5", "verdict_kill@7", "ingest_stall@3:0.5",
    "ingest_kill@2", "kill@0:0"])
def test_chaos_parse_equals_reference(spec):
    assert resilience.ChaosPlan.parse(spec) == jres.ChaosPlan.parse(spec)


@pytest.mark.parametrize("bad", ["boom@1:2", "kill@1", "kill@x:2",
                                 "stall@0:2", "kill@1:2:3"])
def test_chaos_refusals_equal_reference(bad):
    with pytest.raises(ValueError, match="GRAFT_CHAOS") as got:
        resilience.ChaosPlan.parse(bad)
    with pytest.raises(ValueError, match="GRAFT_CHAOS") as want:
        jres.ChaosPlan.parse(bad)
    assert str(got.value) == str(want.value)


def test_chaos_fires_once_like_reference(tmp_path):
    def run(mod, d):
        fired = []

        def mk():
            return mod.ChaosPlan(mod.ChaosPlan.parse("kill@0:2"), rank=0,
                                 run_dir=str(d),
                                 kill=lambda: fired.append("kill"))
        for start in (0, 2, 4):
            mk().fire({"chunk_start": start})
        other = mod.ChaosPlan(mod.ChaosPlan.parse("kill@1:0"), rank=0,
                              run_dir=str(d),
                              kill=lambda: fired.append("other"))
        other.fire({"chunk_start": 9})
        return fired, sorted(os.listdir(d))
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    assert run(resilience, tmp_path / "p") == run(jres, tmp_path / "r")


def _liveness_story(mod, d):
    """Verdicts of rank 0 over a peer that is missing, then beating, then
    stale, then refreshed, then finished; and rank 0's heartbeat file
    without its wall clock and pid."""
    a = mod.RankLiveness(str(d), 0, 2, peer_timeout_s=0.3,
                         startup_grace_s=0.2, beat_interval_s=10.0)
    b = mod.RankLiveness(str(d), 1, 2, peer_timeout_s=0.3,
                         startup_grace_s=0.2, beat_interval_s=10.0)
    a.beat(tick=4, chunk=1)
    out = [[r for r, _ in a.dead_peers()]]      # inside the start grace
    time.sleep(0.3)
    out.append([r for r, _ in a.dead_peers()])  # missing past the grace
    b.beat(tick=3, chunk=1)
    out.append([r for r, _ in a.dead_peers()])
    time.sleep(0.4)
    out.append([r for r, _ in a.dead_peers()])  # stale
    b.beat(tick=5, chunk=2)
    out.append([r for r, _ in a.dead_peers()])  # refreshed
    time.sleep(0.4)
    b.finish()
    out.append([r for r, _ in a.dead_peers()])  # finished: never dead
    with open(mod.heartbeat_path(str(d), 0)) as f:
        hb = json.load(f)
    hb.pop("wall", None)
    hb.pop("pid", None)
    return out, hb


def test_liveness_equals_reference(tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    got = _liveness_story(resilience, tmp_path / "p")
    want = _liveness_story(jres, tmp_path / "r")
    assert got == want
    assert got[0][1] == [1] and got[0][-1] == []


def test_dead_peer_aborts_at_chunk_boundary(tmp_path):
    """A peer that never beats: the supervisor's pre-dispatch check
    raises before the first chunk, and the run crashes naming the dead
    peer (tests/test_resilience.py:353)."""
    from go_libp2p_pubsub_tpu_torch.sim.supervisor import (
        SupervisorConfig, SupervisorCrash, supervised_run)
    cfg, tp, st = build("single_topic_1k", {"n_peers": 64}, {}, None)
    live = resilience.RankLiveness(str(tmp_path), 0, 2, peer_timeout_s=0.1,
                                   startup_grace_s=0.0, beat_interval_s=10.0)
    time.sleep(0.2)
    with pytest.raises(SupervisorCrash) as e:
        supervised_run(st, cfg, tp, rng.PRNGKey(0, device="cpu"), 4,
                       SupervisorConfig(chunk_ticks=2, liveness=live,
                                        crash_dir=str(tmp_path / "crash"),
                                        max_retries=0, backoff_base_s=0.0,
                                        sleep=lambda s: None),
                       device="cpu")
    assert isinstance(e.value.__cause__, resilience.PeerDeadError)
    assert e.value.report.chunks_run == 0


def test_mh_supervisor_helpers_equal_reference(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import mh_supervisor as jmh
    finally:
        sys.path.pop(0)
    for text in ("8,8,4", "2", " 3 , 1 "):
        assert mh_supervisor.parse_procs(text) == jmh.parse_procs(text)
    for bad in ("", "x", "0", "2,-1"):
        with pytest.raises(ValueError) as got:
            mh_supervisor.parse_procs(bad)
        with pytest.raises(ValueError) as want:
            jmh.parse_procs(bad)
        assert str(got.value) == str(want.value)
    ck = tmp_path / "ck"
    ck.mkdir()
    for name in ("ckpt_t000000004.npz", "ckpt_t000000012.fingerprint",
                 "other.npz"):
        (ck / name).write_text("")
    assert mh_supervisor._newest_ckpt_tick(str(ck)) == \
        jmh._newest_ckpt_tick(str(ck)) == 12


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA", "GRAFT_"))}
    env["PYTHONPATH"] = REPO
    return env


@pytest.fixture(autouse=True)
def _crash_dir(tmp_path, monkeypatch):
    """Crash dumps of the runs here land under tmp_path."""
    monkeypatch.setenv("GRAFT_CRASH_DIR", str(tmp_path / "crash"))


def _uninterrupted(ticks):
    cfg, tp, st = build("single_topic_1k", KW, {}, None)
    return state_to_numpy(engine.run(st, cfg, tp, rng.PRNGKey(0, device="cpu"),
                                     ticks, device="cpu"))


def _assert_final(path, want):
    with np.load(path) as z:
        for f, a in want.items():
            np.testing.assert_array_equal(z[f], a, err_msg=f)


def test_elastic_checkpoint_resumes_at_one_process(tmp_path):
    """A 2-rank window stops after one chunk (its checkpoint stamped
    ``processes=2``); one process resumes it and ends equal to the
    uninterrupted run."""
    from go_libp2p_pubsub_tpu_torch.sim import checkpoint
    args = ["--backend", "gloo", "--device", "cpu", "--threads", "1",
            "--scenario", "single_topic_1k", "--kwargs", json.dumps(KW),
            "--ticks", "6", "--chunk-ticks", "3",
            "--checkpoint-dir", str(tmp_path / "ck")]
    mod = ["-m", "go_libp2p_pubsub_tpu_torch.run_multihost"]
    procs = [subprocess.Popen(
        [sys.executable, *mod, *args, "--max-chunks", "1",
         "--coordinator", f"file://{tmp_path}/rdv0", "--num-processes", "2",
         "--process-id", str(r)], cwd=REPO, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=180)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    meta = checkpoint.sidecar_meta(str(tmp_path / "ck" / "ckpt_t000000003"))
    assert int(meta["processes"]) == 2
    res = subprocess.run(
        [sys.executable, *mod, *args, "--dump-state", str(tmp_path / "f"),
         "--coordinator", f"file://{tmp_path}/rdv1", "--num-processes", "1",
         "--process-id", "0"], cwd=REPO, env=_env(), capture_output=True,
        text=True, timeout=180)
    assert res.returncode == 0, res.stdout + res.stderr
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["resumed_from"].endswith("ckpt_t000000003")
    _assert_final(tmp_path / "f.npz", _uninterrupted(6))


@pytest.mark.slow
def test_sigkilled_rank_relaunches_to_the_same_state(tmp_path):
    """The acceptance drill: GRAFT_CHAOS kills rank 1 at the second
    chunk; mh_supervisor tears the group down, relaunches both ranks from
    the first chunk's checkpoint, and the final state equals the
    uninterrupted run."""
    env = _env()
    env["GRAFT_CHAOS"] = "kill@1:4"
    run_dir = tmp_path / "mh"
    res = subprocess.run(
        [sys.executable, "-m", "go_libp2p_pubsub_tpu_torch.mh_supervisor",
         "--procs", "2", "--backend", "gloo", "--device", "cpu",
         "--threads", "1", "--rendezvous", "file",
         "--scenario", "single_topic_1k", "--kwargs", json.dumps(KW),
         "--ticks", "8", "--chunk-ticks", "4", "--run-dir", str(run_dir),
         "--dump-state", str(tmp_path / "f"), "--backoff-base-s", "0.1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [json.loads(x) for x in res.stdout.splitlines()
             if x.startswith("{")]
    assert [x["mh"] for x in lines] == ["launch", "failure", "launch",
                                        "done"]
    assert lines[1]["why"].startswith("rank_exit r1=")
    assert lines[2]["ckpt_tick"] == 4
    assert (run_dir / "chaos_kill_r1_t4.fired").exists()
    _assert_final(tmp_path / "f.npz", _uninterrupted(8))
