"""The port's halo route (go_libp2p_pubsub_tpu_torch/parallel/halo.py)
against the reference's (parallel/halo.py) on the CPU.

- ``required_capacity_factor`` and ``required_bucket_capacity`` (host-side
  numpy) equal the reference's on several underlays and device counts,
  the bucketed flat space included;
- ``route_words_halo`` and ``route_payloads_halo`` in two gloo processes
  (each rank a jax-free ``python -c`` process meeting the other through a
  file under ``tmp_path``), their rank outputs concatenated, equal the
  reference's routes run on 2 of the virtual CPU devices, on the same
  seeded inputs, and so does the overflow count;
- a starved bucket capacity sets the overflow count on both sides.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.parallel import halo as jhalo
from go_libp2p_pubsub_tpu.parallel.kernel_context import kernel_mesh
from go_libp2p_pubsub_tpu.sim import topology as jtopology
from go_libp2p_pubsub_tpu_torch.parallel import halo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, K, W = 256, 16, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("degree", [4, 12])
def test_required_capacities_equal_reference(n_dev, degree):
    topo = jtopology.sparse(N, K, degree=degree, seed=5)
    nbr, rks = np.asarray(topo.neighbors), np.asarray(topo.reverse_slot)
    assert halo.required_capacity_factor(nbr, rks, n_dev) == \
        jhalo.required_capacity_factor(nbr, rks, n_dev)
    assert halo.required_bucket_capacity(nbr, rks, n_dev) == \
        jhalo.required_bucket_capacity(nbr, rks, n_dev)


def test_required_bucket_capacity_bucketed_equals_reference():
    n_dev = 4
    bks = jtopology.align_degree_buckets(jtopology.powerlaw_buckets(
        N, d_min=4, d_max=K, alpha=2.0, round_to=8), n_dev)
    topo = jtopology.powerlaw(N, K, d_min=4, d_max=K, alpha=2.0, seed=11)
    nbr, rks = np.asarray(topo.neighbors), np.asarray(topo.reverse_slot)
    assert halo.required_bucket_capacity(nbr, rks, n_dev, buckets=bks) == \
        jhalo.required_bucket_capacity(nbr, rks, n_dev, buckets=bks)
    with pytest.raises(ValueError, match="divide evenly"):
        halo.required_bucket_capacity(nbr[:255], rks[:255], 2)


def _inputs():
    from go_libp2p_pubsub_tpu_torch.sim import topology
    topo = topology.sparse(N, K, degree=6, seed=3)
    r = np.random.default_rng(9)
    x_w = r.integers(-2 ** 31, 2 ** 31, size=(W, N), dtype=np.int64) \
        .astype(np.int32)
    p_i = r.integers(-2 ** 31, 2 ** 31, size=(N, K), dtype=np.int64) \
        .astype(np.int32)
    p_f = r.standard_normal((N, K)).astype(np.float32)
    return (np.asarray(topo.neighbors), np.asarray(topo.reverse_slot),
            x_w, p_i, p_f)


RANK = r"""
import sys, numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
from go_libp2p_pubsub_tpu_torch.parallel import halo, kernel_context as kc
r, path, out, cap = int(sys.argv[1]), sys.argv[2], sys.argv[3], int(sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + path, rank=r,
                        world_size=2)
z = np.load(sys.argv[5])
nl = z["nbr"].shape[0] // 2
rows = slice(r * nl, (r + 1) * nl)
t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
with kc.kernel_mesh(z["nbr"].shape[0], route="halo", bucket_capacity=cap):
    words = halo.route_words_halo(t(z["x_w"][:, rows]), t(z["nbr"][rows]),
                                  t(z["rks"][rows]))
    pi, pf = halo.route_payloads_halo([t(z["p_i"][rows]), t(z["p_f"][rows])],
                                      t(z["nbr"][rows]), t(z["rks"][rows]))
    ovf = [int(v) for v in kc.drain_halo_overflow()]
np.savez(out, words=words.numpy(), pi=pi.numpy(), pf=pf.numpy(),
         ovf=np.array(ovf))
dist.destroy_process_group()
"""


def _port_routes(tmp_path, cap):
    nbr, rks, x_w, p_i, p_f = _inputs()
    np.savez(tmp_path / "in.npz", nbr=nbr, rks=rks, x_w=x_w, p_i=p_i,
             p_f=p_f)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(tmp_path / "rdv"),
         str(tmp_path / f"out{r}.npz"), str(cap), str(tmp_path / "in.npz")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    outs = [p.communicate(timeout=180)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    parts = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]
    return (np.concatenate([p["words"] for p in parts], axis=2),
            np.concatenate([p["pi"] for p in parts]),
            np.concatenate([p["pf"] for p in parts]),
            [p["ovf"].tolist() for p in parts])


def _reference_routes(cap):
    from jax.sharding import Mesh
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices (conftest XLA_FLAGS)")
    nbr, rks, x_w, p_i, p_f = _inputs()
    mesh = Mesh(np.array(jax.devices()[:2]), ("peers",))
    with kernel_mesh(mesh, ("peers",), route="halo", bucket_capacity=cap):
        words = jhalo.route_words_halo(x_w.view(np.uint32), nbr, rks)
        pi, pf = jhalo.route_payloads_halo([p_i.view(np.uint32), p_f],
                                           nbr, rks)
        from go_libp2p_pubsub_tpu.parallel.kernel_context import \
            drain_halo_overflow
        ovf = [int(v) for v in drain_halo_overflow()]
    return (np.asarray(words).view(np.int32), np.asarray(pi).view(np.int32),
            np.asarray(pf), ovf)


def test_routes_equal_reference(tmp_path):
    """Both routes at the uniform-degree capacity: every output word and
    float bit as the reference's, and no overflow on either side."""
    got = _port_routes(tmp_path, 0)
    want = _reference_routes(0)
    nbr, rks = _inputs()[:2]
    valid = (nbr >= 0) & (rks >= 0)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2].view(np.int32),
                                  want[2].view(np.int32))
    assert valid.any()
    assert got[3] == [[0, 0], [0, 0]] and want[3] == [0, 0]


def test_starved_capacity_sets_overflow(tmp_path):
    """A bucket capacity of one slot overflows: both ranks note the same
    group-summed count, equal to the reference's."""
    got = _port_routes(tmp_path, 1)
    want = _reference_routes(1)
    assert got[3][0] == got[3][1] == want[3]
    assert all(v > 0 for v in want[3])
