"""Parity of the port's router variants (floodsub, randomsub) against the
JAX package on the CPU.

``router_sweep_100k`` (BASELINE config #5, scoring off) at two sizes that
put randomsub's target max(D, ceil(sqrt N)) on both sides of K: 1024 peers
with K = 16 (target 32 > K, every candidate forwards) and 256 peers with
K = 32 (target 16 < K). The forwarding mask of each router, randomsub's
selection under each of the reference's three selection formulations, and
8-tick runs of each router compared with ``engine.run`` in every field.
The JAX side runs ``hop_mode="xla"``; the port runs its fused kernels
(``"auto"``) and its non-fused path (``"xla"``); the reference pins the
two formulations bit-identical. Every field is compared exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.ops.propagate import \
    _edge_forward_mask as jforward_mask
from go_libp2p_pubsub_tpu.ops.selection import select_random as jselect
from go_libp2p_pubsub_tpu.sim import scenarios as jscenarios
from go_libp2p_pubsub_tpu.sim.engine import step_jit as jstep
from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.ops.hopkernel import resolve_hop_mode
from go_libp2p_pubsub_tpu_torch.ops.propagate import _edge_forward_mask
from go_libp2p_pubsub_tpu_torch.ops.selection import select_random
from go_libp2p_pubsub_tpu_torch.sim import (SimConfig, TopicParams,
                                            scenarios, state_from_reference,
                                            state_to_numpy, step)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs (the
    suite runs in several worker processes; see
    tests/test_torch_engine_modes.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TICKS = 8
# (n_peers, k_slots): randomsub's target above K, and below it
SIZES = {"target>K": (1024, 16), "target<K": (256, 32)}


def _arrays(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def _assert_equal(ref: dict, got: dict, where: str = ""):
    for f, want in ref.items():
        have = got[f]
        assert have.dtype == want.dtype, (f, have.dtype, want.dtype)
        np.testing.assert_array_equal(have, want, err_msg=f"{f} {where}")


def _jax_ticks(st, cfg, tp, n):
    """The reference's state after each tick of ``engine.run(st, cfg, tp,
    PRNGKey(0), n)``: its jitted step on run's own split of the key.
    Returns (final state, [numpy fields per tick])."""
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    ticks = []
    for i in range(n):
        st = jstep(st, cfg=cfg, tp=tp, key=keys[i])
        ticks.append(_arrays(st))
    return st, ticks


def _port_each_tick(st, cfg, tp, ticks):
    """The port's run from PRNGKey(0) (its per-tick key split), every
    field held to the reference's after every tick."""
    keys = rng.split(rng.PRNGKey(0, device="cpu"), len(ticks))
    for i, want in enumerate(ticks):
        st = step(st, cfg, tp, keys[i], device="cpu")
        _assert_equal(want, state_to_numpy(st), f"after tick {i}")
    return st


def _port(jcfg, jtp, jst):
    return (SimConfig(**dataclasses.asdict(jcfg)),
            TopicParams(*[torch.from_numpy(np.array(x)) for x in jtp]),
            state_from_reference(_arrays(jst), device="cpu"))


def _sweep(router, size):
    n, k = SIZES[size]
    return jscenarios.router_sweep_100k(router, n_peers=n, k_slots=k,
                                        degree=6)


@pytest.fixture(scope="module")
def ref_runs():
    """The JAX package's 8-tick router sweep runs (hop_mode="xla"), keyed by
    (router, size): (cfg, tp, initial state, final state, per-tick
    fields)."""
    out = {}
    for router in ("floodsub", "randomsub", "gossipsub"):
        for size in SIZES:
            cfg, tp, st = _sweep(router, size)
            cfg = dataclasses.replace(cfg, hop_mode="xla")
            out[router, size] = (cfg, tp, st,
                                 *_jax_ticks(st, cfg, tp, TICKS))
    return out


def test_router_sweep_scenario_array_equal():
    for router in ("floodsub", "randomsub", "gossipsub"):
        jcfg, jtp, jst = jscenarios.router_sweep_100k(router, n_peers=128,
                                                      k_slots=16, degree=6)
        cfg, tp, st = scenarios.router_sweep_100k(router, n_peers=128,
                                                  k_slots=16, degree=6,
                                                  device="cpu")
        assert SimConfig(**dataclasses.asdict(jcfg)) == cfg
        _assert_equal(_arrays(jst), state_to_numpy(st))
        for f in jtp._fields:
            np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                          np.asarray(getattr(jtp, f)))


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("mode", ["ranks", "sort", "iter"])
def test_randomsub_selection_equal(size, mode):
    """randomsub's sender-side draw: the reference's
    ``select_random(cand, target, key, max_count=min(target, K), mode)``
    in each formulation equals the port's with the same ``max_count`` and
    ``mode``. Above K every candidate is chosen."""
    n, k = SIZES[size]
    _, _, jst = _sweep("randomsub", size)
    target = max(6, int(np.ceil(np.sqrt(n))))
    assert (target > k) == (size == "target>K")
    cand = jst.connected[:, None, :] & jst.nbr_subscribed
    key = jax.random.PRNGKey(11)
    want = np.asarray(jselect(cand, jnp.full((n, 1), target), key,
                              max_count=min(target, k), mode=mode))
    got = select_random(torch.from_numpy(np.array(cand)),
                        torch.full((n, 1), target),
                        rng.PRNGKey(11, device="cpu"),
                        max_count=min(target, k), mode=mode).numpy()
    np.testing.assert_array_equal(got, want)
    per_row = want.sum(-1)
    n_cand = np.asarray(cand).sum(-1)
    np.testing.assert_array_equal(per_row, np.minimum(n_cand, target))
    if size == "target>K":
        np.testing.assert_array_equal(want, np.asarray(cand))
    else:
        assert (n_cand > target).any()     # the draw chose among more


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("router", ["gossipsub", "floodsub", "randomsub"])
@pytest.mark.parametrize("gather", ["pallas", "mxu"])
def test_edge_forward_mask_equal(ref_runs, router, size, gather):
    """The receiver-view forwarding mask of each router on the run's final
    state (gossipsub with no heartbeat view passed: it gathers its own
    through the edge exchange)."""
    jcfg, jtp, _, jst, _ = ref_runs[router, size]
    jcfg = dataclasses.replace(jcfg, edge_gather_mode=gather)
    if router == "gossipsub":
        # a mesh to forward along: the sweep's gossipsub run grafted one
        assert np.asarray(jst.mesh).any()
    want = np.asarray(jforward_mask(jst, jcfg, jax.random.PRNGKey(5)))
    cfg, _, st = _port(jcfg, jtp, jst)
    got = _edge_forward_mask(st, cfg, rng.PRNGKey(5, device="cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any()


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("router", ["floodsub", "randomsub", "gossipsub"])
@pytest.mark.parametrize("hop", ["auto", "xla"])
def test_router_run_equal(ref_runs, router, size, hop):
    """The acceptance runs: 8 ticks of ``engine.run`` from PRNGKey(0),
    every SimState field exact after every tick, the port on its fused
    kernels (``auto``) and on its non-fused path (``xla``)."""
    jcfg, jtp, jst, _, ticks = ref_runs[router, size]
    cfg, tp, st = _port(jcfg, jtp, jst)
    cfg = dataclasses.replace(cfg, hop_mode=hop)
    assert resolve_hop_mode(cfg) == ("pallas" if hop == "auto" else "xla")
    _port_each_tick(st, cfg, tp, ticks)
    ref = ticks[-1]
    assert ref["delivered_total"] > 0 and int(ref["fault_flags"]) == 0
    if router != "gossipsub":
        # no heartbeat: no mesh, no scores
        assert not ref["mesh"].any()
