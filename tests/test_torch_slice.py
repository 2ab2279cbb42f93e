"""Parity of the PyTorch port's slice (go_libp2p_pubsub_tpu_torch) against
the JAX package on the CPU: one publish, heartbeat and forward_tick, and the
headline network ``__graft_entry__._build(1024, 32, 12)`` run for 8 ticks on
the fused-kernel configuration (``hop_mode="pallas"``,
``edge_gather_mode="pallas"``; the JAX side runs its Pallas kernels in
interpret mode). Every SimState field is compared exactly, the float32
counters included: the port repeats the reference's float32 operations in
the same order, and no case has needed a tolerance."""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build
from go_libp2p_pubsub_tpu.ops.heartbeat import heartbeat as jheartbeat
from go_libp2p_pubsub_tpu.ops.propagate import forward_tick as jforward
from go_libp2p_pubsub_tpu.ops.propagate import publish as jpublish
from go_libp2p_pubsub_tpu.sim.engine import run as jrun
from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.ops.heartbeat import heartbeat
from go_libp2p_pubsub_tpu_torch.ops.propagate import forward_tick, publish
from go_libp2p_pubsub_tpu_torch.sim import (SimConfig, TopicParams,
                                            build_headline, run,
                                            state_from_reference,
                                            state_to_numpy)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs (the
    suite runs in several worker processes; see
    tests/test_torch_engine_modes.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "go_libp2p_pubsub_tpu_torch")


def _fused(cfg):
    return dataclasses.replace(cfg, hop_mode="pallas",
                               edge_gather_mode="pallas")


def _port_cfg(jcfg):
    return SimConfig(**dataclasses.asdict(jcfg))


def _port_tp(jtp):
    return TopicParams(*[torch.from_numpy(np.array(x)) for x in jtp])


def _arrays(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def _assert_states_equal(ref: dict, got: dict):
    for f, want in ref.items():
        have = got[f]
        assert have.dtype == want.dtype, (f, have.dtype, want.dtype)
        np.testing.assert_array_equal(have, want, err_msg=f)


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def ref_run():
    """The JAX package's headline network (``_build(1024, 32, 12)``, fused
    configuration) before and after 8 ticks from PRNGKey(0)."""
    cfg, tp, st = _build(1024, 32, 12)
    cfg = _fused(cfg)
    return cfg, tp, st, jrun(st, cfg, tp, jax.random.PRNGKey(0), 8)


def test_headline_1024_eight_ticks_equal(ref_run):
    """The acceptance run: every SimState field after 8 ticks from
    PRNGKey(0), exact."""
    jcfg, _, jst, jout = ref_run
    ref = _arrays(jout)
    cfg, tp, st = build_headline(1024, publishers=4, device="cpu")
    assert _port_cfg(jcfg) == cfg
    _assert_states_equal(_arrays(jst), state_to_numpy(st))
    out = run(st, cfg, tp, rng.PRNGKey(0, device="cpu"), 8, device="cpu")
    _assert_states_equal(ref, state_to_numpy(out))
    assert ref["delivered_total"] > 0 and int(ref["tick"]) == 8


def test_publish_heartbeat_forward_tick_equal(ref_run):
    """publish, then two heartbeat + forward_tick rounds with ONE hop per
    tick, so the first round leaves gossip pulls pending (emit) and the
    second resolves them (iwant_resolve): each stage is compared."""
    jcfg, jtp, _, jst = ref_run
    jcfg = dataclasses.replace(jcfg, prop_substeps=1)
    peers = jnp.asarray([5, 77, 130, 900], jnp.int32)
    topics = jnp.zeros((4,), jnp.int32)
    jst = jpublish(jst, jcfg, peers, topics)
    pub = publish(state_from_reference(_arrays(ref_run[3]), device="cpu"),
                  _port_cfg(jcfg), _t(peers), _t(topics))
    _assert_states_equal(_arrays(jst), state_to_numpy(pub))
    for rnd in range(2):
        hb = jheartbeat(jst, jcfg, jtp, jax.random.PRNGKey(1 + rnd))
        thb = heartbeat(state_from_reference(_arrays(jst), device="cpu"),
                        _port_cfg(jcfg), _port_tp(jtp),
                        rng.PRNGKey(1 + rnd, device="cpu"))
        _assert_states_equal(_arrays(hb.state), state_to_numpy(thb.state))
        for f in ("scores", "scores_all", "inc_gossip", "fwd_send"):
            np.testing.assert_array_equal(getattr(thb, f).numpy(),
                                          np.asarray(getattr(hb, f)),
                                          err_msg=f)
        want = jforward(hb.state, jcfg, jtp, hb.inc_gossip, hb.scores,
                        jax.random.PRNGKey(2), fwd_send=hb.fwd_send)
        got = forward_tick(
            state_from_reference(_arrays(hb.state), device="cpu"),
            _port_cfg(jcfg), _port_tp(jtp), _t(hb.inc_gossip),
            _t(hb.scores), rng.PRNGKey(2, device="cpu"),
            fwd_send=_t(hb.fwd_send))
        _assert_states_equal(_arrays(want), state_to_numpy(got))
        # non-vacuous: messages moved; round 0 leaves pulls pending
        assert float(want.delivered_total) > float(hb.state.delivered_total)
        if rnd == 0:
            assert int((np.asarray(want.iwant_pending) >= 0).sum()) > 0
        jst = want._replace(tick=want.tick + 1)


def test_state_round_trip(ref_run):
    _, _, _, jst = ref_run
    arrays = _arrays(jst)
    st = state_from_reference(arrays, device="cpu")
    assert st.have.dtype == torch.int32 and st.fault_flags.dtype == torch.int32
    _assert_states_equal(arrays, state_to_numpy(st))


def test_port_imports_no_jax():
    """The port imports and steps with jax unimportable (the headline, the
    churn path, a fault plan with flood publish, randomsub, subscription
    churn on the beacon network, chunked ``run_window`` under the fold_in
    schedule, a frontier config under its ``sort`` exchanges, the
    dispatch table's ``resolved_formulations``), and neither it nor
    chip_smoke.py imports the JAX package."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.path.insert(0, %r)\n"
        "import pkgutil, importlib, go_libp2p_pubsub_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from go_libp2p_pubsub_tpu_torch import rng\n"
        "from go_libp2p_pubsub_tpu_torch.sim import build_headline, run\n"
        "cfg, tp, st = build_headline(64, k_slots=8, degree=4, device='cpu')\n"
        "out = run(st, cfg, tp, rng.PRNGKey(0, device='cpu'), 2, device='cpu')\n"
        "assert int(out.tick) == 2\n"
        "import dataclasses\n"
        "from go_libp2p_pubsub_tpu_torch.sim import scenarios\n"
        "cfg, tp, st = scenarios.churn_50k(64, k_slots=8, degree=4, device='cpu')\n"
        "for g in ('pallas', 'mxu'):\n"
        "    c = dataclasses.replace(cfg, hop_mode='xla', edge_gather_mode=g)\n"
        "    out = run(st, c, tp, rng.PRNGKey(0, device='cpu'), 2, device='cpu')\n"
        "    assert int(out.tick) == 2\n"
        "from go_libp2p_pubsub_tpu_torch.sim import faults, invariants\n"
        "cfg, tp, st = scenarios.partition_small(64, k_slots=8, degree=4, "
        "start=0, heal=1, device='cpu')\n"
        "cfg = dataclasses.replace(cfg, fault_plan=faults.FaultPlan.parse("
        "'partition=2@0:1,drop=0.1,censor=0.3x1@0:2'), flood_publish=True)\n"
        "out = run(st, cfg, tp, rng.PRNGKey(0, device='cpu'), 2, device='cpu')\n"
        "assert int(out.fault_flags) == (invariants.FAULT_PARTITION | "
        "invariants.FAULT_LINK_DROP | invariants.FAULT_CENSOR)\n"
        "cfg, tp, st = scenarios.router_sweep_100k('randomsub', 64, k_slots=8, "
        "degree=4, device='cpu')\n"
        "assert int(run(st, cfg, tp, rng.PRNGKey(0, device='cpu'), 2, "
        "device='cpu').tick) == 2\n"
        "from go_libp2p_pubsub_tpu_torch.sim import run_window\n"
        "cfg, tp, st = scenarios.beacon_10k(64, k_slots=16, degree=4, "
        "device='cpu')\n"
        "cfg = dataclasses.replace(cfg, sub_leave_prob=0.2, sub_join_prob=0.2, "
        "key_schedule='fold_in')\n"
        "out = run_window(st, cfg, tp, rng.PRNGKey(0, device='cpu'), 1, "
        "device='cpu')\n"
        "out = run_window(out, cfg, tp, rng.PRNGKey(0, device='cpu'), 1, "
        "device='cpu')\n"
        "assert int(out.tick) == 2 and not bool((out.subscribed == "
        "st.subscribed).all())\n"
        "from go_libp2p_pubsub_tpu_torch.ops import dispatch\n"
        "cfg, tp, st = scenarios.frontier(256, device='cpu')\n"
        "assert dispatch.resolved_formulations(cfg)['edge_packed'] == 'sort'\n"
        "assert int(run(st, cfg, tp, rng.PRNGKey(0, device='cpu'), 2, "
        "device='cpu').tick) == 2\n"
        "assert not any(n == 'jax' or n.startswith(('jax.', 'go_libp2p_pubsub_tpu.'))"
        " or n == 'go_libp2p_pubsub_tpu' for n in sys.modules if sys.modules[n])\n"
        "print('ok')\n") % REPO
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr[-2000:]
    pat = re.compile(r"^\s*(from|import)\s+(jax\b|go_libp2p_pubsub_tpu\b(?!_))",
                     re.M)
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in sources:
        with open(path) as f:
            assert not pat.search(f.read()), path


def test_entry_points_refuse_cpu_without_device(monkeypatch):
    """With no CUDA device and no device argument, the entry points raise
    instead of running on the CPU."""
    from go_libp2p_pubsub_tpu_torch.sim import init_state, step, topology

    cfg, tp, st = build_headline(64, k_slots=8, degree=4, device="cpu")
    key = rng.PRNGKey(0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = topology.sparse(64, 8, degree=4)
    for call in (lambda: build_headline(64, k_slots=8, degree=4),
                 lambda: init_state(cfg, topo),
                 lambda: TopicParams.disabled(1),
                 lambda: rng.PRNGKey(0),
                 lambda: step(st, cfg, tp, key),
                 lambda: run(st, cfg, tp, key, 1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_step_refuses_configs_outside_the_slice():
    from go_libp2p_pubsub_tpu_torch.sim import step

    cfg, tp, st = build_headline(64, k_slots=8, degree=4, device="cpu")
    key = rng.PRNGKey(0, device="cpu")
    # lifted by Queue 1 item 3: every gather formulation steps
    for gather in ("sort", "scalar", "rows"):
        out = step(st, dataclasses.replace(cfg, edge_gather_mode=gather), tp,
                   key, device="cpu")
        assert int(out.tick) == 1
    for over, item in ((dict(state_precision="compact"), 5),):
        with pytest.raises(NotImplementedError,
                           match=rf"Queue 1 item {item}\)"):
            step(st, dataclasses.replace(cfg, **over), tp, key, device="cpu")


@pytest.mark.parametrize("n,k,degree,seed", [(64, 8, 4, 314159),
                                             (200, 16, 12, 7),
                                             (128, 6, 6, 1)])
def test_topology_sparse_array_equal(n, k, degree, seed):
    from go_libp2p_pubsub_tpu.sim import topology as jtopo
    from go_libp2p_pubsub_tpu_torch.sim import topology

    want = jtopo.sparse(n, k, degree=degree, seed=seed)
    got = topology.sparse(n, k, degree=degree, seed=seed)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f


def test_config_and_topic_params_convert_field_by_field():
    from go_libp2p_pubsub_tpu.core.params import GossipSubParams as JGsp
    from go_libp2p_pubsub_tpu.core.params import TopicScoreParams as JTsp
    from go_libp2p_pubsub_tpu.sim import SimConfig as JConfig
    from go_libp2p_pubsub_tpu.sim import TopicParams as JTopicParams
    from go_libp2p_pubsub_tpu.sim.config import (
        with_score_weights as jwith)
    from go_libp2p_pubsub_tpu_torch.core.params import (GossipSubParams,
                                                        TopicScoreParams)
    from go_libp2p_pubsub_tpu_torch.sim import with_score_weights

    assert [f.name for f in dataclasses.fields(SimConfig)] == \
        [f.name for f in dataclasses.fields(JConfig)]
    jcfg = JConfig.from_params(300, 16, 2, params=JGsp(d=8, dhi=14),
                               prune_backoff_ticks=30)
    cfg = SimConfig.from_params(300, 16, 2, params=GossipSubParams(d=8, dhi=14),
                                prune_backoff_ticks=30)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert _port_cfg(jcfg) == cfg

    kw = dict(topic_weight=0.7, time_in_mesh_weight=0.01,
              time_in_mesh_quantum=2.5, time_in_mesh_cap=10.0,
              first_message_deliveries_weight=1.0,
              first_message_deliveries_decay=0.3,
              mesh_message_deliveries_activation=7.0)
    pairs = [(JTopicParams.from_topic_params([JTsp(**kw), JTsp()]),
              TopicParams.from_topic_params([TopicScoreParams(**kw),
                                             TopicScoreParams()],
                                            device="cpu")),
             (JTopicParams.disabled(3), TopicParams.disabled(3, device="cpu"))]
    jtp, tp = pairs[0]
    over = dict(p1=0.5, p3=[-2.0, -3.0], p7=-4.0)
    jtp2, jcfg2 = jwith(jtp, cfg=jcfg, **over)
    tp2, cfg2 = with_score_weights(tp, cfg=cfg, **over)
    pairs.append((jtp2, tp2))
    assert dataclasses.asdict(cfg2) == dataclasses.asdict(jcfg2)
    for want, got in pairs:
        for f in want._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
    with pytest.raises(ValueError):
        with_score_weights(tp, p6=-1.0)
