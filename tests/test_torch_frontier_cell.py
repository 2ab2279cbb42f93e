"""The benchmark's frontier_1m.steady cell on the CPU at small sizes: its
configuration file is the program's frontier builder written out; a run
of the harness (the program's sort routes on the supervised path against
the reference's scalar gathers) is correct, and with a planted fault it
is not; the sort formulation's span ``exchange.sort`` opens once for each
sort that ``ops.permgather.SORTS`` counts; and the per-layer reader
``sort_kernel_ms_per_tick`` reads the sort's kernels by name."""

import dataclasses
import importlib.util
import json
import os

import pytest
import torch

from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.core.params import TopicScoreParams
from go_libp2p_pubsub_tpu_torch.ops import permgather
from go_libp2p_pubsub_tpu_torch.sim import (build_headline, engine,
                                            scenarios, topology)
from go_libp2p_pubsub_tpu_torch.sim.config import SimConfig, TopicParams
from port_bench import harness, spec

CELL = "frontier_1m.steady"
N_SMALL = 128      # the harness runs ~80 ticks: kept small for the suite
SEED = 4_000_000_321


@pytest.fixture
def one_thread():
    """Small tensors gain nothing from intra-op threads, and the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_the_configuration_file_is_the_frontier_builders():
    c = spec.cell(CELL)
    assert c.config["sim"]["n_peers"] == 1048576
    assert set(c.config["sim"]) == {f.name for f in
                                    dataclasses.fields(SimConfig)}
    got = SimConfig(**{**c.sim, "n_peers": N_SMALL})
    assert got == scenarios.frontier_cfg(N_SMALL)
    assert got.edge_gather_mode == "sort" and got.n_topics == 2
    fields = {f.name for f in dataclasses.fields(TopicScoreParams)}
    assert len(c.topics) == 2 and all(set(t) == fields for t in c.topics)
    got_tp = TopicParams.from_topic_params(
        [TopicScoreParams(**t) for t in c.topics], device="cpu")
    want_tp = scenarios.default_topic_params(2, device="cpu")
    for f, a, b in zip(TopicParams._fields, got_tp, want_tp):
        assert torch.equal(a, b), f
    assert (c.config["degree"], c.config["subscribe_prob"]) == (8, 1.0)
    assert c.config["reduced"] == [] and c.config["published"] == {}
    assert c.chunk_ticks == 8 and c.traffic["sim"] == {}


def _run(**kw):
    return harness.run_cell(CELL, SEED, 0.0, False, device="cpu",
                            overrides={"n_peers": N_SMALL}, **kw)


def test_a_run_of_the_cell_is_correct(one_thread):
    permgather.reset_sorts()
    r = _run()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 32
    assert {"hb_per_s", "setup_s"} <= set(r["metrics"])
    # the timed path sorted: three exchanges a tick, warm-up included
    assert permgather.SORTS["calls"] >= 3 * (8 + 16 + r["attempted"])


def _altered(call, state, out):
    # one peer's mesh row flipped where the chunk produced it
    st, rec = out
    mesh = st.mesh.clone()
    mesh[5] = ~mesh[5]
    return st._replace(mesh=mesh), rec


def test_a_planted_fault_is_not_correct(one_thread):
    r = _run(tamper=_altered)
    assert not r["correct"], r["checks"]
    assert r["checks"]["state_mismatch"]["value"] > 0


def _spans(prof, tmp_path):
    """The profile's ranges: name -> [(start, end)], in start order."""
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out: dict = {}
    for e in sorted(events, key=lambda e: float(e.get("ts", 0))):
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            a = float(e["ts"])
            out.setdefault(e["name"], []).append((a, a + float(e["dur"])))
    return out


@pytest.mark.parametrize("config", ["frontier", "net_100k"])
def test_each_sort_opens_one_span_and_counts(config, tmp_path, one_thread):
    """One tick at 256 peers under the profiler: as many ``exchange.sort``
    ranges as SORTS counts, each of N*K keys, every one inside a
    heartbeat exchange; the headline's pallas exchanges sort nothing."""
    n = 256
    if config == "frontier":
        topo = topology.sparse_fast(n, 32, degree=8, seed=3)
        cfg, tp, st = scenarios.frontier(n, device="cpu", topo=topo)
    else:
        topo = topology.sparse_fast(n, 32, degree=12, seed=3)
        cfg, tp, st = build_headline(n, device="cpu", topo=topo)
    keys = rng.split(rng.PRNGKey(7, device="cpu"), 1)
    permgather.reset_sorts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        engine.run_keys(st, cfg, tp, keys, device="cpu")
    ranges = _spans(prof, tmp_path)
    got = ranges.get("exchange.sort", [])
    assert len(got) == permgather.SORTS["calls"]
    assert permgather.SORTS["keys"] == permgather.SORTS["calls"] * n * 32
    if config == "net_100k":
        assert permgather.SORTS["calls"] == 0
        return
    assert permgather.SORTS["calls"] == 3
    for a, b in got:
        assert any(x <= a and b <= y
                   for x, y in ranges["heartbeat.exchange"])


def test_the_span_leaves_the_permutation_as_the_sort_gives_it():
    topo = topology.sparse_fast(256, 32, degree=8, seed=5)
    nbr = torch.as_tensor(topo.neighbors)
    rs = torch.as_tensor(topo.reverse_slot)
    for k_major in (False, True):
        key = permgather.edge_sort_key(nbr, rs, k_major)
        want = torch.sort(key, stable=True).indices
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            got = permgather.sort_permutation(key)
        assert torch.equal(got, want)
        assert torch.equal(permgather.sort_permutation(key), want)


def _reader():
    path = os.path.join(spec.BENCH_DIR, "metrics",
                        "sort_kernel_ms_per_tick.py")
    mod_spec = importlib.util.spec_from_file_location("sort_reader", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def test_the_reader_sums_the_sorts_kernels_per_tick():
    """The sort's kernels and memsets as the card's trace names them
    (torch 2.11, cub's onesweep sort of int32 keys with int64 values), per
    tick; not cub's single-tile kernel of another sort, nor the copies."""
    read = _reader()
    pol = ("at_cuda_detail::cub::DeviceRadixSortPolicy<int, "
           "at::cuda::cub::detail::OpaqueType<8>, unsigned long long>"
           "::Policy900")
    sort = {
        f"void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<{pol}, "
        "false, int>(int*, int*)": 3000.0,
        f"void at_cuda_detail::cub::DeviceRadixSortHistogramKernel<{pol}, "
        "false, int>(unsigned long long*)": 150.0,
        f"void at_cuda_detail::cub::DeviceRadixSortExclusiveSumKernel<{pol}, "
        "unsigned long long>(unsigned long long*)": 4.0,
        "at::native::(anonymous namespace)::fill_reverse_indices_kernel("
        "long*, int, at::cuda::detail::IntDivider<unsigned int>)": 250.0,
        "Memset (Unknown)": 30.0}
    other = {
        "void at_cuda_detail::cub::DeviceRadixSortSingleTileKernel<"
        "at_cuda_detail::cub::DeviceRadixSortPolicy<long, "
        "at::cuda::cub::detail::OpaqueType<8>, unsigned long long>"
        "::Policy900, false, long>(long const*)": 5.0,
        "Memcpy DtoD (Device -> Device)": 400.0,
        "Memcpy DtoH (Device -> Pinned)": 6.0,
        "void hop_kernel<2, 0>(unsigned int const*)": 5000.0}
    ctx = {"trace": {"stretch": {"ticks": 24,
                                 "device_us": {**sort, **other}}}}
    assert read(ctx) == pytest.approx(3434.0 / 1e3 / 24)
    ctx["trace"]["stretch"]["device_us"] = other
    assert read(ctx) is None
    assert read({"trace": None}) is None
