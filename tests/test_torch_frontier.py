"""Parity of the port's frontier family and of the scalar, rows and sort
gather formulations and the iter, sort and ranks selections with the JAX
package on the CPU, every field exact after every tick.

- ``frontier(512)`` (``edge_gather_mode="sort"`` over the fused hop,
  resolve and emit; the reference's ``"auto"`` takes its XLA hop, which it
  pins bit-identical to its fused kernels), 8 ticks, against the
  reference's jitted step on ``engine.run``'s own split of the key, and
  the last tick against ``engine.run`` itself.
- The 256-peer headline under ``hop_mode="xla"`` in the ``scalar``,
  ``rows`` and ``sort`` formulations (the non-fused words gather in each;
  under ``sort`` the IWANT answer table rides the heartbeat's last
  exchange), and with flood publish under ``sort`` (both sender-side
  planes by one sort permutation).
- ``churn_50k(256)`` under ``sort`` (churn's payload exchange).
- The headline under each ``selection_mode``.
- ``frontier_4m``'s compact default is still refused (ROADMAP.md, Queue
  1 item 5); at an explicit ``state_precision="f32"`` it steps."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _build
from go_libp2p_pubsub_tpu.sim import scenarios as jscenarios
from go_libp2p_pubsub_tpu.sim.engine import run as jrun
from go_libp2p_pubsub_tpu.sim.engine import step_jit as jstep
from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.ops import dispatch
from go_libp2p_pubsub_tpu_torch.sim import (SimConfig, build_headline,
                                            invariants, scenarios,
                                            state_to_numpy, step)
from go_libp2p_pubsub_tpu_torch.sim import engine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs: the suite
    runs in several worker processes, and intra-op threads beyond the
    cores stall at every small op's barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TICKS = 8


def _arrays(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def _assert_equal(ref: dict, got: dict, where: str = ""):
    for f, want in ref.items():
        have = got[f]
        assert have.dtype == want.dtype, (f, have.dtype, want.dtype)
        np.testing.assert_array_equal(have, want, err_msg=f"{f} {where}")


def _trajectory(jbuilt, built, over=None, ticks=TICKS):
    """Step both sides ``ticks`` times on ``engine.run``'s split of
    PRNGKey(0), comparing every field after every tick; returns both
    configs and the last states."""
    (jcfg, jtp, jst), (cfg, tp, st) = jbuilt, built
    if over:
        jcfg = dataclasses.replace(jcfg, **over)
        cfg = dataclasses.replace(cfg, **over)
    assert SimConfig(**dataclasses.asdict(jcfg)) == cfg
    _assert_equal(_arrays(jst), state_to_numpy(st), "built")
    jkeys = jax.random.split(jax.random.PRNGKey(0), ticks)
    keys = rng.split(rng.PRNGKey(0, device="cpu"), ticks)
    js = jst
    for i in range(ticks):
        js = jstep(js, cfg=jcfg, tp=jtp, key=jkeys[i])
        st = step(st, cfg, tp, keys[i], device="cpu")
        _assert_equal(_arrays(js), state_to_numpy(st), f"after tick {i}")
    assert float(st.delivered_total) > 0
    assert not int(st.fault_flags) & invariants.VIOLATION_MASK
    return (jcfg, jtp, jst, js), (cfg, st)


def test_frontier_512_equals_engine_run():
    (jcfg, jtp, jst, js), (cfg, st) = _trajectory(
        jscenarios.frontier(512), scenarios.frontier(512, device="cpu"))
    _assert_equal(_arrays(jrun(jst, jcfg, jtp, jax.random.PRNGKey(0),
                               TICKS)), state_to_numpy(st), "engine.run")
    got = dispatch.resolved_formulations(cfg)
    assert got == {"edge_permute": "sort", "words": "sort",
                   "edge_packed": "sort", "hop": "pallas", "emit": "pallas",
                   "selection": "ranks"}, got


def _headline(n=256):
    """The headline network (``__graft_entry__._build``) at 256 peers,
    K = 16, degree 6, 8 publishers, in the reference's config."""
    jcfg, jtp, jst = _build(n, 16, 6, publishers=8)
    _, tp, st = build_headline(n, k_slots=16, degree=6, publishers=8,
                               device="cpu")
    return (jcfg, jtp, jst), (SimConfig(**dataclasses.asdict(jcfg)), tp, st)


@pytest.mark.parametrize("gather", ["scalar", "rows", "sort"])
def test_headline_nonfused_formulation_equal(gather, monkeypatch):
    """The non-fused words gathers in each formulation; the answer table
    rides the heartbeat's last exchange under ``sort`` only."""
    rides = []
    orig = engine._iwant_answer_extras

    def spy(*a, **kw):
        out = orig(*a, **kw)
        rides.append(out is not None)
        return out

    monkeypatch.setattr(engine, "_iwant_answer_extras", spy)
    jbuilt, built = _headline()
    _trajectory(jbuilt, built, dict(hop_mode="xla", edge_gather_mode=gather))
    assert rides == [gather == "sort"] * TICKS


def test_headline_flood_publish_sort_equal():
    jbuilt, built = _headline()
    _trajectory(jbuilt, built, dict(edge_gather_mode="sort",
                                    flood_publish=True))


def test_churn_sort_equal():
    """churn_50k's connection churn exchanges its decisions through the
    sort formulation's payload permute."""
    jbuilt = jscenarios.churn_50k(n_peers=256, k_slots=16, degree=6)
    built = scenarios.churn_50k(n_peers=256, k_slots=16, degree=6,
                                device="cpu")
    _, (cfg, st) = _trajectory(jbuilt, built,
                               dict(edge_gather_mode="sort", hop_mode="xla"))
    known = st.neighbors >= 0
    assert int((known & ~st.connected).sum()) > 0


@pytest.mark.parametrize("selection", ["iter", "sort", "ranks"])
def test_selection_mode_equal(selection):
    jbuilt, built = _headline()
    _, (cfg, _) = _trajectory(jbuilt, built, dict(selection_mode=selection))
    assert dispatch.resolved_formulations(cfg)["selection"] == selection


def test_frontier_xl_compact_refused_f32_steps():
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 5\)"):
        scenarios.frontier_4m(512, device="cpu")
    cfg, tp, st = scenarios.frontier_4m(512, state_precision="f32",
                                        device="cpu")
    out = step(st, cfg, tp, rng.PRNGKey(0, device="cpu"), device="cpu")
    assert int(out.tick) == 1 and cfg.edge_gather_mode == "sort"
