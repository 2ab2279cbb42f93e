"""The port's row-sharded degree-bucketed plane on the CPU, in two gloo
processes (model: tests/test_bucketed_sharded.py).

Every rank is a ``python -m go_libp2p_pubsub_tpu_torch.run_multihost
--engine bucketed`` process: each holds its window of every bucket and
``g``'s rows at those ids (parallel/kernel_context.bucket_rows), and the
run writes the whole state's leaf digests after every tick. They are held
against the port's single-process ``bucketed_step`` under the same keys,
every leaf of ``g``, of every bucket and of ``rev`` after every tick:

- heavytail_eclipse at 1024 peers (compact, ``"bucket"`` draws, the hub
  eclipse) under the replicated and the halo route;
- under ``bucketed_rng="dense"`` and f32 the gathered final state,
  densified, equals the dense engine's run on the same graph;
- ``--topology sharded`` (each rank builds only its windows of the
  row-window underlay) equals the single-process run of the whole build;
- every rank's ``init_bucketed_local`` part, laid out by ``bucket_rows``,
  makes up ``init_bucketed_state``'s state, and ``shard_bucketed_state``
  cuts the same parts out of it;
- the bucketed flat route of the halo (2 ranks) equals the reference's
  ``route_bucketed_flat`` on 2 virtual devices.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.parallel import multihost
from go_libp2p_pubsub_tpu_torch.parallel.sharding import (
    PeerMesh, bucketed_digests, shard_bucketed_state)
from go_libp2p_pubsub_tpu_torch.run_multihost import build
from go_libp2p_pubsub_tpu_torch.sim import bucketed, engine, scenarios
from go_libp2p_pubsub_tpu_torch.sim.checkpoint import restore
from test_torch_sharding import REPO, spawn_ranks

N, TICKS = 1024, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _single(kw, ticks=TICKS):
    cfg, tp, bs = build("heavytail_eclipse", kw, {}, None)
    keys = rng.split(rng.PRNGKey(0, device="cpu"), ticks)
    digests = []
    for i in range(ticks):
        bs = bucketed.bucketed_step(bs, cfg, tp, keys[i], device="cpu")
        digests.append(bucketed_digests(bs, cfg))
    return cfg, tp, bs, digests


def _ranks(tmp_path, kw, over):
    spawn_ranks(tmp_path, [
        "--engine", "bucketed", "--scenario", "heavytail_eclipse",
        "--kwargs", json.dumps(kw), "--cfg", json.dumps(over),
        "--ticks", str(TICKS), "--digests", str(tmp_path / "d.json"),
        "--dump-state", str(tmp_path / "f"),
        "--stats", str(tmp_path / "s{rank}.json")])
    with open(tmp_path / "d.json") as f:
        return json.load(f)


@pytest.mark.parametrize("route", ["replicated", "halo"])
def test_two_ranks_equal_single_process(tmp_path, route):
    kw = {"n_peers": N}
    got = _ranks(tmp_path, kw, {"sharded_route": route})
    cfg, _, bs, want = _single(kw)
    for i, (g, w) in enumerate(zip(got, want)):
        bad = [k for k in w if g[k] != w[k]]
        assert not bad, f"tick {i}: {bad[:8]} differ ({route})"
    assert int(bs.g.fault_flags) & 0x80, "the eclipse window never fired"
    with open(tmp_path / "s0.json") as f:
        ops = json.load(f)["collective_bytes_per_tick"]
    assert ("all_to_all" in ops) == (route == "halo")


def test_dense_draws_equal_the_dense_run(tmp_path):
    """``bucketed_rng="dense"``, f32: the 2-rank final state, densified,
    equals the dense engine's run of the same graph and keys."""
    kw = {"n_peers": N, "bucketed_rng": "dense", "state_precision": "f32"}
    _ranks(tmp_path, kw, {})
    cfg, tp, bs0 = build("heavytail_eclipse", kw, {}, None)
    got = bucketed.densify_state(restore(str(tmp_path / "f"), bs0, cfg=cfg),
                                 cfg)
    want = engine.run(bucketed.densify_state(bs0, cfg), cfg, tp,
                      rng.PRNGKey(0, device="cpu"), TICKS, device="cpu")
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.slow
def test_row_window_build_equals_single_process(tmp_path):
    """``--topology sharded``: each rank builds only its bucket windows
    from ``powerlaw_mh_spec``'s row-window underlay (the powerlaw_10m
    launch at 2048 peers); 4 ticks equal the single-process run of the
    whole build, leaf for leaf."""
    n, ticks = 2048, 4
    spawn_ranks(tmp_path, [
        "--engine", "bucketed", "--topology", "sharded",
        "--scenario", "powerlaw_10m", "--kwargs", json.dumps({"n_peers": n}),
        "--ticks", str(ticks), "--unsupervised",
        "--dump-state", str(tmp_path / "f")])
    cfg, tp, topo_rows, sub = scenarios.powerlaw_mh_spec(n, device="cpu")
    bs = bucketed.init_bucketed_state(cfg, topo_rows(0, n), device="cpu",
                                      subscribed=sub)
    keys = rng.split(rng.PRNGKey(0, device="cpu"), ticks)
    for i in range(ticks):
        bs = bucketed.bucketed_step(bs, cfg, tp, keys[i], device="cpu")
    want = bucketed.bucketed_state_to_numpy(bs)
    with np.load(tmp_path / "f.npz") as z:
        for k, a in want.items():
            np.testing.assert_array_equal(z[k], a, err_msg=k)


@pytest.mark.parametrize("procs", [2, 4])
def test_local_parts_make_up_the_whole(procs):
    cfg, _, topo, sub = scenarios.powerlaw_spec(N, device="cpu")
    whole = bucketed.init_bucketed_state(cfg, topo, device="cpu",
                                         subscribed=sub)
    for p in range(procs):
        part = multihost.init_bucketed_local(cfg, topo, p, procs,
                                             subscribed=sub, device="cpu")
        cut = shard_bucketed_state(whole, PeerMesh(None, procs, p,
                                                   {"peers": procs}), cfg)
        for (name, a, _), (_, b, _) in zip(bucketed.named_leaves(part),
                                           bucketed.named_leaves(cut)):
            assert torch.equal(a, b), (p, name)


RANK = r"""
import sys, numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
from go_libp2p_pubsub_tpu_torch.parallel import halo, kernel_context as kc
r, path, out, inp = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + path, rank=r,
                        world_size=2)
z = np.load(inp)
nb = int(z["nb"])
pl, rv = [], []
for b in range(nb):
    p, v = z[f"p{b}"], z[f"r{b}"]
    cl = p.shape[0] // 2
    pl.append(torch.from_numpy(np.ascontiguousarray(p[r * cl:(r + 1) * cl])))
    rv.append(torch.from_numpy(np.ascontiguousarray(v[r * cl:(r + 1) * cl])))
n = int(z["n"])
with kc.kernel_mesh(n, route="halo", buckets=[tuple(x) for x in z["bks"]]):
    got = halo.route_bucketed_flat(pl, rv)
np.savez(out, **{f"o{b}": g.numpy() for b, g in enumerate(got)})
dist.destroy_process_group()
"""


def test_bucketed_flat_route_equals_reference(tmp_path):
    from jax.sharding import Mesh

    from go_libp2p_pubsub_tpu.parallel import halo as jhalo
    from go_libp2p_pubsub_tpu.parallel.kernel_context import kernel_mesh
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices (conftest XLA_FLAGS)")
    cfg, _, topo, sub = scenarios.powerlaw_spec(N, device="cpu")
    bs = bucketed.init_bucketed_state(cfg, topo, device="cpu",
                                      subscribed=sub)
    r = np.random.default_rng(4)
    pays = [r.integers(-2 ** 31, 2 ** 31, size=tuple(x.shape),
                       dtype=np.int64).astype(np.int32) for x in bs.rev]
    revs = [x.numpy() for x in bs.rev]
    np.savez(tmp_path / "in.npz", nb=len(revs), n=N,
             bks=np.array(cfg.degree_buckets),
             **{f"p{b}": p for b, p in enumerate(pays)},
             **{f"r{b}": v for b, v in enumerate(revs)})
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(q), str(tmp_path / "rdv"),
         str(tmp_path / f"o{q}.npz"), str(tmp_path / "in.npz")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for q in range(2)]
    outs = [p.communicate(timeout=180)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    parts = [np.load(tmp_path / f"o{q}.npz") for q in range(2)]
    mesh = Mesh(np.array(jax.devices()[:2]), ("peers",))
    with kernel_mesh(mesh, ("peers",), route="halo"):
        want = jhalo.route_bucketed_flat(
            [p.view(np.uint32) for p in pays], revs)
    for b, w in enumerate(want):
        got = np.concatenate([p[f"o{b}"] for p in parts])
        np.testing.assert_array_equal(got, np.asarray(w).view(np.int32))
