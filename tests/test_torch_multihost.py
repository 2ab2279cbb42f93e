"""The port's multi-process plane (go_libp2p_pubsub_tpu_torch/parallel/
multihost.py and run_multihost.py) on the CPU (models:
tests/test_multihost.py:37-165).

- every rank's ``init_state_local`` shard, concatenated, equals the
  whole ``init_state`` (and the reference's) field for field;
- ``local_peer_rows`` and ``initialize`` refuse bad arguments by name;
- ``gather_state`` / ``local_rows_state`` / ``global_state`` round-trip
  a whole state in one process;
- two gloo ranks of ``run_multihost`` (supervised chunks, checkpoints)
  stop after one chunk and resume, and the resumed run's final state
  equals the single-process ``engine.run``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.parallel import multihost as jmh
from go_libp2p_pubsub_tpu.sim import SimConfig as JConfig
from go_libp2p_pubsub_tpu.sim import topology as jtopology
from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.parallel import multihost
from go_libp2p_pubsub_tpu_torch.run_multihost import build
from go_libp2p_pubsub_tpu_torch.sim import SimConfig, engine, init_state
from go_libp2p_pubsub_tpu_torch.sim import topology
from go_libp2p_pubsub_tpu_torch.sim.state import state_spec, state_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("procs", [1, 2, 4])
def test_local_shards_concatenate_to_the_full_init(procs):
    n, k, t = 128, 8, 2
    cfg = SimConfig(n_peers=n, k_slots=k, n_topics=t, msg_window=32)
    topo = topology.sparse(n, k, degree=4, seed=7)
    r = np.random.default_rng(3)
    sub = r.random((n, t)) < 0.7
    ipg = r.integers(0, 5, n).astype(np.int32)
    mal = r.random(n) < 0.1
    full = state_to_numpy(init_state(cfg, topo, subscribed=sub,
                                     ip_group=ipg, malicious=mal,
                                     device="cpu"))
    parts = [state_to_numpy(multihost.init_state_local(
        cfg, topo, p, procs, subscribed=sub, ip_group=ipg, malicious=mal,
        device="cpu")) for p in range(procs)]
    jcfg = JConfig(n_peers=n, k_slots=k, n_topics=t, msg_window=32)
    jparts = [jmh.init_state_local(jcfg, jtopology.sparse(n, k, degree=4,
                                                          seed=7),
                                   p, procs, subscribed=sub, ip_group=ipg,
                                   malicious=mal) for p in range(procs)]
    for f, (_shape, _dt, peer_major) in state_spec(cfg).items():
        got = np.concatenate([p[f] for p in parts]) if peer_major \
            else parts[0][f]
        np.testing.assert_array_equal(got, full[f], err_msg=f)
        np.testing.assert_array_equal(
            parts[-1][f], np.asarray(getattr(jparts[-1], f)), err_msg=f)


def test_local_peer_rows_and_initialize_refuse_by_name():
    assert multihost.local_peer_rows(12, 3, 2) == \
        jmh.local_peer_rows(12, 3, 2) == (8, 4)
    for bad in ((10, 3, 0), (12, 3, 3), (12, 0, 0), (12, 3, -1)):
        with pytest.raises(ValueError, match="local_peer_rows") as got:
            multihost.local_peer_rows(*bad)
        with pytest.raises(ValueError) as want:
            jmh.local_peer_rows(*bad)
        assert str(got.value) == str(want.value)
    # a coordinator without a named backend: refused, nothing initialised
    with pytest.raises(ValueError, match="gloo"):
        multihost.initialize("file:///nonexistent", 2, 0, backend=None)
    with pytest.raises(ValueError, match="gloo"):
        multihost.initialize("file:///nonexistent", 2, 0, backend="mpi")
    assert not torch.distributed.is_initialized()
    multihost.initialize(None)          # one process: left alone
    assert multihost.process_count() == 1 and multihost.is_coordinator()


def test_host_round_trip_in_one_process():
    from go_libp2p_pubsub_tpu_torch.parallel.sharding import PeerMesh
    cfg, tp, st = build("single_topic_1k", {"n_peers": 64}, {}, None)
    st = engine.run(st, cfg, tp, rng.PRNGKey(1, device="cpu"), 2,
                    device="cpu")
    host = state_to_numpy(multihost.gather_state(st, cfg))
    want = state_to_numpy(st)
    assert all(np.array_equal(host[f], want[f]) for f in want)
    mesh = PeerMesh(None, 1, 0, {"peers": 1})
    back = multihost.global_state(multihost.local_rows_state(host, cfg),
                                  mesh, cfg, "cpu")
    got = state_to_numpy(back)
    assert all(np.array_equal(got[f], want[f]) for f in want)


def _ranks(tmp_path, tag, extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA", "GRAFT_"))}
    env["PYTHONPATH"] = REPO
    env["GRAFT_CRASH_DIR"] = str(tmp_path / "crash")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "go_libp2p_pubsub_tpu_torch.run_multihost",
         "--backend", "gloo", "--device", "cpu", "--threads", "1",
         "--coordinator", f"file://{tmp_path}/rdv{tag}",
         "--num-processes", "2", "--process-id", str(r),
         "--scenario", "single_topic_1k", "--kwargs", '{"n_peers": 256}',
         "--ticks", "6", "--chunk-ticks", "2",
         "--checkpoint-dir", str(tmp_path / "ck")] + extra,
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    outs = [p.communicate(timeout=180)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    return json.loads([x for x in outs[0].splitlines()
                       if x.startswith('{"metric"')][-1])


def test_two_process_window_resume_equals_single_process(tmp_path):
    first = _ranks(tmp_path, 0, ["--max-chunks", "2"])
    assert first["tick"] == 4 and first["chunks"] == 2
    second = _ranks(tmp_path, 1, ["--dump-state", str(tmp_path / "f")])
    assert second["resumed_from"].endswith("ckpt_t000000004")
    assert second["chunks"] == 1 and second["tick"] == 6
    cfg, tp, st = build("single_topic_1k", {"n_peers": 256}, {}, None)
    want = state_to_numpy(engine.run(st, cfg, tp, rng.PRNGKey(0, device="cpu"),
                                     6, device="cpu"))
    with np.load(tmp_path / "f.npz") as z:
        for f, a in want.items():
            np.testing.assert_array_equal(z[f], a, err_msg=f)
