"""The benchmark's inputs against the program's own builders at this
commit: the configuration and traffic files, the underlay, the
subscription rule, the roofline byte functions and the no-JAX check."""

from __future__ import annotations

import dataclasses
import math
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from go_libp2p_pubsub_tpu_torch import sim  # noqa: E402
from go_libp2p_pubsub_tpu_torch.core.params import TopicScoreParams  # noqa: E402
from go_libp2p_pubsub_tpu_torch.sim import scenarios, topology  # noqa: E402
from go_libp2p_pubsub_tpu_torch.sim.config import SimConfig, TopicParams  # noqa: E402
from port_bench import nojax, roofline, spec, underlay  # noqa: E402

N_SMALL = 256


def _builder(cell: str):
    """The program's builder of ``cell`` at N_SMALL peers."""
    topo = topology.sparse_fast(N_SMALL, 32, degree=12, seed=3)
    if cell == "net_100k.gossipsub":
        cfg, tp, _ = sim.build_headline(N_SMALL, device="cpu", topo=topo)
    elif cell == "churn_50k.churn":
        cfg, tp, _ = scenarios.churn_50k(N_SMALL, device="cpu", topo=topo)
    else:
        cfg, tp, _ = scenarios.churn_50k(N_SMALL, disconnect_prob=0.0,
                                         device="cpu", topo=topo)
    return cfg, tp


CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_files_give_the_builders_config_and_topic_params(cell):
    c = spec.cell(cell)
    want_cfg, want_tp = _builder(cell)
    got_cfg = SimConfig(**{**c.sim, "n_peers": N_SMALL})
    assert got_cfg == want_cfg
    got_tp = TopicParams.from_topic_params(
        [TopicScoreParams(**t) for t in c.topics], device="cpu")
    for f, a, b in zip(TopicParams._fields, got_tp, want_tp):
        assert torch.equal(a, b), f


@pytest.mark.parametrize("cell", CELLS)
def test_every_simconfig_and_topic_value_is_written_out(cell):
    c = spec.cell(cell)
    assert set(c.config["sim"]) == {f.name for f in
                                    dataclasses.fields(SimConfig)}
    fields = {f.name for f in dataclasses.fields(TopicScoreParams)}
    assert all(set(t) == fields for t in c.topics)


def test_published_sizes_and_reductions():
    bench = spec.benchmark()
    for entry in bench["configs"]:
        cfg = spec._load(os.path.join(spec.ROOT, entry["file"]))
        assert set(entry["reduced"]) == set(cfg["published"])
        for key, published in cfg["published"].items():
            assert cfg["sim"][key] != published
    assert spec.cell("net_100k.gossipsub").sim["n_peers"] == 102400
    assert spec.cell("churn_50k.churn").sim["n_peers"] == 51200


@pytest.mark.parametrize("seed", [1, 314159, 5_000_000_017])
def test_underlay_is_sparse_fast(seed):
    got = underlay.sparse_fast(3000, 32, degree=12, seed=seed)
    want = topology.sparse_fast(3000, 32, degree=12, seed=seed)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_subscriptions_follow_the_churn_builders_rule():
    sub = spec.subscriptions(4096, 4, 0.5, seed=77)
    assert sub.any(axis=1).all()
    assert 0.45 < sub[:, 1:].mean() < 0.55
    np.testing.assert_array_equal(sub, spec.subscriptions(4096, 4, 0.5, 77))
    assert not np.array_equal(sub, spec.subscriptions(4096, 4, 0.5, 78))
    assert spec.subscriptions(64, 1, 1.0, 5).all()


# PERF.md section 6's bounds at their stated shapes (ms at 3.35 TB/s)
def _t(*shape, itemsize=4):
    return ("t", tuple(shape), itemsize)


N, K, W, M = 102400, 32, 2, 64
NC = 51200
ROOFLINE_CASES = {
    "hop": ([_t(N, W), _t(W, N), _t(W, N), _t(W, N), _t(W, N), _t(W, N),
             _t(W, N), _t(W, 1), _t(N, K), _t(N, 1, K, itemsize=1),
             _t(N, 1, K, itemsize=1), _t(1, W), _t(1, K, N, itemsize=1),
             _t(1, K, N, itemsize=1), _t(1, K, N, itemsize=1), _t(W, N),
             N, K, 1, W], 0.0144),
    "emit": ([_t(N, W), _t(W, N), _t(N, 1, K, itemsize=1), _t(1, W),
              _t(N, K), _t(N, M), N, K, 1, W, M, 5, 8], 0.0132),
    "iwant_resolve": ([_t(N, M), _t(N, W), _t(W, N), _t(W, N), _t(W, N),
                       _t(W, 1), _t(N, K, itemsize=1), _t(1, W), _t(N, K),
                       _t(W, N), _t(W, N), _t(1, K, N, itemsize=1),
                       _t(1, K, N, itemsize=1), _t(K, N, itemsize=1),
                       N, K, 1, W, M], 0.0112),
    "edge_table": ([_t(N, 2), _t(N, K), _t(N, K), _t(1, N, K), N, K, 2, 2],
                   0.0120),
    "gather_words": ([_t(NC, W), _t(NC, K), _t(W, K, NC), NC, K, W], 0.0060),
    "permutation_gather": ([_t(NC, K), _t(NC, K), _t(NC, K), _t(NC, K),
                            NC, K, K], 0.0078),
    "take_words": ([_t(NC, W), _t(NC * K), _t(W, NC * K), NC * K, W, 1,
                    NC * K], 0.0060),
}


@pytest.mark.parametrize("label", sorted(ROOFLINE_CASES))
def test_roofline_bytes_give_the_recorded_bounds(label):
    args, bound_ms = ROOFLINE_CASES[label]
    mods = roofline.modules()
    rate = roofline.peaks()["hbm_bytes_per_s"]
    got_ms = mods[label].nbytes(args) / rate * 1e3
    assert math.isclose(round(got_ms, 4), bound_ms, abs_tol=1e-12), got_ms


def test_every_kernel_of_the_program_has_a_roofline_file():
    from go_libp2p_pubsub_tpu_torch.ops import cudalib
    assert set(roofline.modules()) == set(cudalib.KERNELS)


def test_no_jax_check_compares_whole_top_level_names():
    assert nojax.forbidden_loaded(["go_libp2p_pubsub_tpu.sim.engine"]) == \
        ["go_libp2p_pubsub_tpu"]
    assert nojax.forbidden_loaded(["jax.numpy", "jaxlib", "flax.linen"]) \
        == ["flax", "jax", "jaxlib"]
    assert nojax.forbidden_loaded([
        "go_libp2p_pubsub_tpu_torch", "go_libp2p_pubsub_tpu_torch.sim",
        "jaxtyping", "numpy", "torch"]) == []
