"""Parity of the port's degree-bucketed engine (go_libp2p_pubsub_tpu_torch/
sim/bucketed.py) with the JAX package's sim/bucketed.py on the CPU.

- ``check_bucketable`` refuses what the reference refuses, with its
  messages;
- ``bucketize_state``/``densify_state`` round trip, and shard builds
  (``rows=``) that concatenate into the full build, equal to the
  reference's;
- the conversions ``bucketed_state_from_reference`` and
  ``bucketed_state_to_numpy`` both ways, in either storage layout;
- 8 ticks on a 128-peer power-law graph with scoring, the gater,
  connection churn, link drop and duplication and an eclipse of the hub
  bucket: every field of ``g``, of every bucket and of ``rev`` equal to
  the reference's after every tick, under ``bucketed_rng`` ``"bucket"``
  (compact) and ``"dense"`` (f32) under the fold_in schedule (the port's
  ``bucketed_run`` one tick at a time), and ``"dense"`` under ``"host"``
  keys; then the port's
  8-tick ``bucketed_run`` equal to the last tick. The reference steps
  through one ``jax.jit(bucketed_step)`` per program (its ``bucketed_run``
  scans that step over the same keys);
- under ``"dense"`` the densified state equals the port's dense ``run``
  on the same graph, every field;
- the reverse-edge exchange of 32 planes (``n_topics = 16``: bit 31) equal
  to the reference's;
- the power-law builders and ``BUCKETED_SCENARIOS`` at small N equal to
  the reference's;
- the ΣD guard (the counterpart of the reference's HLO grep): no gather or
  index output of a ``"bucket"`` step at N = 4096, K = 64 holds N·K_max
  elements, while the dense ``scalar`` step at the same shape does;
- a bucketed tick reads nothing on the host; ``"raise"`` behaves as the
  reference's (``bucketed_run`` refuses it); the sharded branches are
  refused naming their queue item."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from go_libp2p_pubsub_tpu.sim import SimConfig as JConfig
from go_libp2p_pubsub_tpu.sim import bucketed as jbk
from go_libp2p_pubsub_tpu.sim import checkpoint as jckpt
from go_libp2p_pubsub_tpu.sim import scenarios as jscenarios
from go_libp2p_pubsub_tpu.sim import topology as jtopology
from go_libp2p_pubsub_tpu.sim.faults import EclipseWindow, FaultPlan
from go_libp2p_pubsub_tpu.sim.state import decode_state as jdecode
from go_libp2p_pubsub_tpu.sim.state import init_state as jinit_state
from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.sim import (SimConfig, bucketed, engine,
                                            init_state, scenarios, topology)
from go_libp2p_pubsub_tpu_torch.sim.invariants import VIOLATION_MASK
from go_libp2p_pubsub_tpu_torch.sim.state import decode_state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs (the
    suite runs in several worker processes; see
    tests/test_torch_engine_modes.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N, TICKS = 128, 8
BUCKETS = jtopology.powerlaw_buckets(N, d_min=4, d_max=16, alpha=2.0,
                                     round_to=4)
K = BUCKETS[0][1]
SEED_KEY = 42


def _cfg_kw():
    """Everything on at once: scoring, gater, churn, drop/dup faults and
    an eclipse aimed at the hub bucket (the low ids)."""
    plan = FaultPlan(link_drop_prob=0.02, link_dup_prob=0.02,
                     eclipses=(EclipseWindow(2, 6, fraction=0.15),), seed=5)
    return dict(n_peers=N, k_slots=K, n_topics=2, msg_window=8,
                publishers_per_tick=2, prop_substeps=4,
                scoring_enabled=True, gater_enabled=True,
                churn_disconnect_prob=0.05, churn_reconnect_prob=0.2,
                fault_plan=plan, invariant_mode="record",
                degree_buckets=BUCKETS)


def _cfg(**over) -> SimConfig:
    """The port's config of ``_cfg_kw()`` (its own FaultPlan)."""
    return SimConfig(**dataclasses.asdict(JConfig(**dict(_cfg_kw(),
                                                         **over))))


def _graph():
    topo = jtopology.powerlaw(N, K, d_min=4, d_max=16, alpha=2.0, seed=11)
    return topo, np.arange(N) >= 112


def _port_topo(topo):
    return topology.Topology(*[np.asarray(x) for x in topo])


def _jarrays(bs) -> dict:
    return {name: np.asarray(v) for name, v in jckpt._named_leaves(bs)}


def _assert_same(want: dict, got: dict, where: str = ""):
    assert sorted(want) == sorted(got), where
    for name, a in want.items():
        b = got[name]
        assert (a.dtype, a.shape) == (b.dtype, b.shape), (name, where)
        np.testing.assert_array_equal(b, a, err_msg=f"{name} {where}")


def _tick_keys(schedule):
    """The reference's per-tick keys and the port's, of a run of TICKS
    from PRNGKey(SEED_KEY) at tick 0 under ``schedule``."""
    jkey, key = jax.random.PRNGKey(SEED_KEY), rng.PRNGKey(SEED_KEY,
                                                          device="cpu")
    if schedule == "fold_in":
        return ([jax.random.fold_in(jkey, i) for i in range(TICKS)],
                [rng.fold_in(key, i) for i in range(TICKS)])
    return list(jax.random.split(jkey, TICKS)), list(rng.split(key, TICKS))


# the trajectory cases: (key schedule, bucketed_rng, state precision)
CASES = [("fold_in", "bucket", "compact"), ("fold_in", "dense", "f32"),
         ("host", "dense", "f32")]


@pytest.fixture(scope="module")
def ref_trajectories():
    """case -> the reference's named arrays after each tick. The step's
    program does not read the key schedule, so the reference compiles one
    step per (bucketed_rng, precision) and each schedule feeds it its
    own keys."""
    topo, mal = _graph()
    tp = jscenarios.default_topic_params(2)
    steps = {}
    out = {}
    for schedule, rng_mode, prec in CASES:
        jcfg = JConfig(**_cfg_kw(), bucketed_rng=rng_mode,
                       state_precision=prec)
        jbs = jbk.init_bucketed_state(jcfg, topo, malicious=mal)
        step = steps.setdefault((rng_mode, prec), jax.jit(
            jbk.bucketed_step, static_argnames=("cfg",)))
        ticks = [_jarrays(jbs)]
        for k in _tick_keys(schedule)[0]:
            jbs = step(jbs, cfg=jcfg, tp=tp, key=k)
            ticks.append(_jarrays(jbs))
        out[(schedule, rng_mode, prec)] = ticks
    return out


def _port_case(schedule, rng_mode, prec):
    cfg = _cfg(bucketed_rng=rng_mode, state_precision=prec,
               key_schedule=schedule)
    topo, mal = _graph()
    bs = bucketed.init_bucketed_state(cfg, _port_topo(topo), device="cpu",
                                      malicious=mal)
    return cfg, scenarios.default_topic_params(2, device="cpu"), bs


# --- check_bucketable --------------------------------------------------------

def _base(**over):
    kw = dict(n_peers=N, k_slots=K, n_topics=2, msg_window=8,
              degree_buckets=BUCKETS)
    kw.update(over)
    return kw


def test_valid_config_passes():
    bucketed.check_bucketable(SimConfig(**_base()))


@pytest.mark.parametrize("over,msg", [
    (dict(degree_buckets=None), "degree_buckets"),
    (dict(degree_buckets=((64, 16), (32, 8))), "tile the id space"),
    (dict(degree_buckets=((64, 8), (64, 16)), k_slots=8), "non-increasing"),
    (dict(degree_buckets=((128, 0),)), "positive"),
    (dict(k_slots=32), "widest bucket"),
    (dict(bucketed_rng="xla"), "bucketed_rng"),
    (dict(router="floodsub"), "router"),
    (dict(flood_publish=True), "flood_publish"),
    (dict(record_provenance=True), "record_provenance"),
    (dict(validation_queue_cap=4), "validation_queue_cap"),
    (dict(edge_queue_cap=4), "edge_queue_cap"),
    (dict(sub_leave_prob=0.01), "subscription churn"),
    (dict(max_iwant_per_tick=4), "budgeted-IWANT"),
    (dict(hop_mode="pallas"), "dense-only"),
    (dict(n_topics=17), "2\\*n_topics"),
])
def test_refused_by_name(over, msg):
    with pytest.raises(ValueError, match=msg) as want:
        jbk.check_bucketable(JConfig(**_base(**over)))
    with pytest.raises(ValueError, match=msg) as got:
        bucketed.check_bucketable(SimConfig(**_base(**over)))
    assert str(got.value) == str(want.value)


# --- layout ------------------------------------------------------------------

@pytest.mark.parametrize("prec", ["f32", "compact"])
def test_bucketize_densify_round_trip(prec):
    """The dense initial state bucketizes and densifies back to itself,
    and (compact) encodes and decodes back; the bucket planes keep no
    storage of the dense state. The initial bucketed states themselves
    equal the reference's (test_bucketed_run_equals_the_reference)."""
    cfg = _cfg(state_precision=prec)
    topo, mal = _graph()
    dense = decode_state(init_state(cfg, _port_topo(topo), device="cpu",
                                    malicious=mal), cfg)
    split = bucketed.bucketize_state(dense, cfg)
    back = bucketed.densify_state(split, cfg)
    for f in dense._fields:
        assert torch.equal(getattr(dense, f), getattr(back, f)), f
    assert split.e[0].mesh.data_ptr() != dense.mesh.data_ptr()
    assert split.g.mesh.shape == (N, 2, 0)
    enc = bucketed.encode_bucketed(split, cfg)
    dec = bucketed.decode_bucketed(enc, cfg)
    for a, b in zip(bucketed.named_leaves(split), bucketed.named_leaves(dec)):
        assert torch.equal(a[1], b[1]), a[0]
    if prec == "compact":
        assert enc.e[0].mesh.dtype == torch.int32
        assert enc.e[0].mesh.shape == (BUCKETS[0][0], 2, 1)
        with pytest.raises(TypeError, match="already in the compact"):
            bucketed.encode_bucketed(enc, cfg)
        with pytest.raises(TypeError, match="compute layout"):
            bucketed.decode_bucketed(dec, cfg)


def test_shard_builds_concatenate_into_the_full_build():
    """``bucketize_state(rows=)`` over ragged windows (one spans a bucket
    boundary, one a whole bucket and part of the next): per bucket, the
    shards' planes and flat reverse indices concatenate row-wise into the
    full build's, and each shard equals the reference's shard build."""
    jcfg = JConfig(**_cfg_kw())
    cfg = SimConfig(**dataclasses.asdict(jcfg))
    topo, mal = _graph()
    jdense = jdecode(jinit_state(jcfg, topo, malicious=mal), jcfg)
    dense = decode_state(init_state(cfg, _port_topo(topo), device="cpu",
                                    malicious=mal), cfg)
    full = bucketed.bucketize_state(dense, cfg)
    windows = ((0, 20), (20, 60), (80, 48))
    shards = []
    for r0, cnt in windows:
        sl = slice(r0, r0 + cnt)
        part = dense._replace(**{f: getattr(dense, f)[sl]
                                 for f in bucketed.EDGE_FIELDS
                                 + bucketed.ROW_FIELDS})
        shard = bucketed.bucketize_state(part, cfg, rows=(r0, cnt))
        jpart = jdense._replace(**{f: getattr(jdense, f)[sl]
                                   for f in jbk.EDGE_FIELDS})
        jshard = jbk.bucketize_state(jpart, jcfg, rows=(r0, cnt))
        want = {n: a for n, a in _jarrays(jshard).items()
                if not n.startswith("g.")}
        got = {n: a for n, a in bucketed.bucketed_state_to_numpy(
            shard).items() if not n.startswith("g.")}
        _assert_same(want, got, f"rows {r0}+{cnt}")
        shards.append(shard)
    for b in range(len(BUCKETS)):
        for f in bucketed.EDGE_FIELDS:
            assert torch.equal(torch.cat([getattr(s.e[b], f)
                                          for s in shards]),
                               getattr(full.e[b], f)), (b, f)
        assert torch.equal(torch.cat([s.rev[b] for s in shards]),
                           full.rev[b]), b
    with pytest.raises(ValueError, match="rows="):
        bucketed.bucketize_state(dense, cfg, rows=(0, 20))


def test_live_edge_beyond_a_ceiling_is_refused():
    cfg = _cfg()
    topo, mal = _graph()
    dense = decode_state(init_state(cfg, _port_topo(topo), device="cpu"),
                         cfg)
    nbr = dense.neighbors.clone()
    nbr[N - 1, K - 1] = 0
    with pytest.raises(ValueError, match="beyond their k_ceil"):
        bucketed.bucketize_state(dense._replace(neighbors=nbr), cfg)


@pytest.mark.parametrize("case", [CASES[1], CASES[0]],
                         ids=["f32", "compact"])
def test_conversions_both_ways(ref_trajectories, case):
    """The reference's state after 8 ticks into the port and back, and the
    port's state to numpy and back, unchanged (uint32 words and uint16
    bf16 patterns on the reference's side)."""
    cfg = _cfg(bucketed_rng=case[1], state_precision=case[2])
    arrays = ref_trajectories[case][-1]
    bs = bucketed.bucketed_state_from_reference(arrays, cfg, device="cpu")
    _assert_same(arrays, bucketed.bucketed_state_to_numpy(bs))
    again = bucketed.bucketed_state_from_reference(
        bucketed.bucketed_state_to_numpy(bs), cfg, device="cpu")
    for a, b in zip(bucketed.named_leaves(bs), bucketed.named_leaves(again)):
        assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]
        assert b[1].is_contiguous(), a[0]
    if case[2] == "compact":
        assert arrays["e0.mesh"].dtype == np.uint32
        assert arrays["g.have"].dtype == np.uint32
        assert arrays["e1.behaviour_penalty"].dtype == np.uint16
        assert arrays["g.neighbors"].dtype == np.int32


# --- trajectories --------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_bucketed_run_equals_the_reference(ref_trajectories, case):
    schedule, rng_mode, prec = case
    want = ref_trajectories[case]
    cfg, tp, bs0 = _port_case(*case)
    _assert_same(want[0], bucketed.bucketed_state_to_numpy(bs0), "init")
    bs = bs0
    master = rng.PRNGKey(SEED_KEY, device="cpu")
    keys = _tick_keys(schedule)[1]
    for i in range(TICKS):
        if schedule == "fold_in":
            # the run's own schedule: its key folds the state's tick
            bs = bucketed.bucketed_run(bs, cfg, tp, master, 1, device="cpu")
        else:
            bs = bucketed.bucketed_step(bs, cfg, tp, keys[i], device="cpu")
        _assert_same(want[i + 1], bucketed.bucketed_state_to_numpy(bs),
                     f"after tick {i}")
    whole = bucketed.bucketed_run(bs0, cfg, tp, master, TICKS, device="cpu")
    _assert_same(want[-1], bucketed.bucketed_state_to_numpy(whole), "run")
    flags = int(whole.fault_flags)
    assert flags & 0x80, "the eclipse window never fired"
    assert flags & VIOLATION_MASK == 0
    assert float(whole.g.delivered_total) > 0


def test_dense_rng_equals_the_dense_run():
    """Under ``bucketed_rng="dense"`` the densified bucketed state after 8
    ticks equals the port's dense ``run`` on the same graph and config
    (its kernels' plain versions here), every field."""
    cfg, tp, bs = _port_case("fold_in", "dense", "f32")
    topo, mal = _graph()
    key = rng.PRNGKey(SEED_KEY, device="cpu")
    got = bucketed.densify_state(
        bucketed.bucketed_run(bs, cfg, tp, key, TICKS, device="cpu"), cfg)
    st = init_state(cfg, _port_topo(topo), device="cpu", malicious=mal)
    want = engine.run(st, cfg, tp, key, TICKS, device="cpu")
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_exchange_of_32_planes_equals_the_reference():
    """``_exchange_masks`` of 32 planes (two [N, 16, K] masks, as the
    heartbeat's last exchange at n_topics = 16: bit 31 carries a plane)
    equals the reference's, bucket by bucket, and the plain gather
    ``x[neighbors, t, reverse_slot]`` on the densified layout."""
    jcfg = dataclasses.replace(JConfig(**_cfg_kw()), n_topics=16,
                               fault_plan=None)
    cfg = SimConfig(**dataclasses.asdict(jcfg))
    topo, _ = _graph()
    jbs = jbk.init_bucketed_state(jcfg, topo)
    bs = bucketed.init_bucketed_state(cfg, _port_topo(topo), device="cpu")
    gen = np.random.default_rng(3)
    planes = []
    for (_, c, kb) in bucketed._buckets(cfg):
        planes.append([gen.random((c, 16, kb)) < 0.5,
                       gen.random((c, 16, kb)) < 0.5])
    want = jbk._exchange_masks(jbs, [[jax.numpy.asarray(p) for p in pl]
                                     for pl in planes])
    got = bucketed._exchange_masks(bs, [[torch.from_numpy(p) for p in pl]
                                        for pl in planes])
    for w_b, g_b in zip(want, got):
        for w, g in zip(w_b, g_b):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the plain gather on the densified layout

    def padded(x):
        return np.concatenate([x, np.zeros(x.shape[:2] + (K - x.shape[2],),
                                           bool)], -1)

    nbr = np.asarray(topo.neighbors)
    rs = np.asarray(topo.reverse_slot)
    valid = (nbr >= 0) & (rs >= 0)
    j, r = np.clip(nbr, 0, N - 1), np.clip(rs, 0, K - 1)
    for i in range(2):
        dense = np.concatenate([padded(pl[i]) for pl in planes])
        plain = dense[j[:, None, :], np.arange(16)[None, :, None],
                      r[:, None, :]] & valid[:, None, :]
        mine = np.concatenate([padded(g_b[i].numpy()) for g_b in got])
        np.testing.assert_array_equal(mine, plain)
    assert any((g_b[1].numpy()[:, 15]).any() for g_b in got)


# --- scenarios -------------------------------------------------------------

def test_powerlaw_builders_equal_the_reference():
    """``powerlaw_cfg``/``powerlaw_spec``/``powerlaw_mh_spec``, the
    single-process builders at 1024 peers (``heavytail_eclipse`` with its
    hub-bucket window and tail sybils, and ``powerlaw_bucketed``) and the
    bucket helpers equal the reference's."""
    assert sorted(scenarios.BUCKETED_SCENARIOS) == \
        sorted(jscenarios.BUCKETED_SCENARIOS)
    assert scenarios.POWERLAW_NS == jscenarios.POWERLAW_NS
    assert scenarios.POWERLAW_MH_ALIGN == jscenarios.POWERLAW_MH_ALIGN
    for n in (1024, 131_072, 10_485_760):
        for align in (None, 64):
            jcfg = jscenarios.powerlaw_cfg(n, shard_align=align)
            assert SimConfig(**dataclasses.asdict(jcfg)) == \
                scenarios.powerlaw_cfg(n, shard_align=align)
    jcfg, _, jbs = jscenarios.powerlaw_bucketed(1024)
    cfg, _, bs = scenarios.powerlaw_bucketed(1024, device="cpu")
    assert SimConfig(**dataclasses.asdict(jcfg)) == cfg
    _assert_same(_jarrays(jbs), bucketed.bucketed_state_to_numpy(bs),
                 "powerlaw_bucketed")
    jcfg, _, jbs = jscenarios.heavytail_eclipse(1024)
    cfg, _, bs = scenarios.heavytail_eclipse(1024, device="cpu")
    assert SimConfig(**dataclasses.asdict(jcfg)) == cfg
    _assert_same(_jarrays(jbs), bucketed.bucketed_state_to_numpy(bs),
                 "heavytail_eclipse")
    assert not bs.g.malicious[:cfg.degree_buckets[0][0]].any()
    jcfg, _, jtopo_rows, jsub = jscenarios.powerlaw_mh_spec(1024)
    cfg, _, topo_rows, sub = scenarios.powerlaw_mh_spec(1024, device="cpu")
    assert SimConfig(**dataclasses.asdict(jcfg)) == cfg
    np.testing.assert_array_equal(sub, jsub)
    for a, b in zip(topo_rows(100, 300), jtopo_rows(100, 300)):
        np.testing.assert_array_equal(a, b)
    topo = topology.powerlaw(1024, 64, seed=scenarios.SEED)
    assert topology.degree_stats(topo) == jtopology.degree_stats(
        jtopology.powerlaw(1024, 64, seed=scenarios.SEED))
    for args in ((1024,), (4096, 8, 64, 2.5, 16), (N, 4, 16, 2.0, 4)):
        b = topology.powerlaw_buckets(*args)
        assert b == jtopology.powerlaw_buckets(*args)
        for align in (8, 64, 256):
            if sum(r for r, _ in b) % align == 0:
                assert topology.align_degree_buckets(b, align) == \
                    jtopology.align_degree_buckets(b, align)
    with pytest.raises(ValueError, match="tile align"):
        topology.align_degree_buckets(((100, 8),), 64)


# --- the ΣD guard -----------------------------------------------------------

GATHERS = frozenset({"index", "gather", "index_select", "take",
                     "take_along_dim"})


class GatherSizes(TorchDispatchMode):
    """Records (op, elements) of every gather and index output."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in GATHERS:
            self.sizes.append((func.overloadpacket.__name__, out.numel()))
        return out


N_GUARD, K_GUARD = 4096, 64


def _guard_case():
    buckets = topology.powerlaw_buckets(N_GUARD, d_min=8, d_max=64)
    assert buckets[0][1] == K_GUARD
    cfg = SimConfig(n_peers=N_GUARD, k_slots=K_GUARD, n_topics=1,
                    msg_window=32, publishers_per_tick=4, prop_substeps=4,
                    scoring_enabled=True, degree_buckets=buckets,
                    bucketed_rng="bucket")
    topo = topology.powerlaw(N_GUARD, K_GUARD, d_min=8, d_max=64, seed=1)
    return cfg, scenarios.default_topic_params(1, device="cpu"), topo


def test_no_dense_sized_gather_in_a_bucketed_step():
    """At N = 4096, K = 64 no gather or index output of one ``"bucket"``
    step holds N·K_max elements: per-edge work runs at bucket width."""
    cfg, tp, topo = _guard_case()
    bs = bucketed.init_bucketed_state(cfg, topo, device="cpu")
    key = rng.PRNGKey(0, device="cpu")
    with GatherSizes() as mode:
        bucketed.bucketed_step(bs, cfg, tp, key, device="cpu")
    assert mode.sizes, "the guard recorded nothing"
    big = [s for s in mode.sizes if s[1] >= N_GUARD * K_GUARD]
    assert not big, big[:5]


def test_dense_scalar_step_trips_the_guard():
    """The control: the dense ``scalar`` step at the same shape gathers
    N·K-sized outputs, so the guard sees them."""
    cfg, tp, topo = _guard_case()
    cfg = dataclasses.replace(cfg, degree_buckets=None,
                              edge_gather_mode="scalar")
    st = init_state(cfg, topo, device="cpu")
    with GatherSizes() as mode:
        engine.step(st, cfg, tp, rng.PRNGKey(0, device="cpu"), device="cpu")
    assert [s for s in mode.sizes if s[1] >= N_GUARD * K_GUARD]


# --- host reads, raise mode, the sharded branches ------------------------

HOST_OPS = frozenset({"_local_scalar_dense", "item", "is_nonzero", "nonzero",
                      "masked_select", "lift_fresh", "lift_fresh_copy"})


class NoHostRead(TorchDispatchMode):
    """Raises at the first operator of :data:`HOST_OPS` (a host read of a
    device value, or a tensor made from host data)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in HOST_OPS:
            raise AssertionError(f"host read inside the step: aten.{name}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("prec", ["f32", "compact"])
def test_bucketed_tick_reads_nothing_on_the_host(prec):
    cfg, tp, bs = _port_case("fold_in", "bucket", prec)
    key = rng.PRNGKey(0, device="cpu")
    bs = bucketed.bucketed_step(bs, cfg, tp, key, device="cpu")
    with NoHostRead():
        for _ in range(2):
            bs = bucketed.bucketed_run(bs, cfg, tp, key, 1, device="cpu")


def test_raise_mode_as_the_reference():
    """The reference's jitted ``bucketed_run`` cannot evaluate its
    checkify check under ``"raise"`` and raises ValueError; the port's
    refuses it the same way. ``bucketed_step`` under ``"raise"`` computes
    the ``"record"`` state, as the dense ``step`` does."""
    jcfg = JConfig(**dict(_cfg_kw(), fault_plan=None,
                          invariant_mode="raise"))
    cfg = SimConfig(**dataclasses.asdict(jcfg))
    topo, _ = _graph()
    jbs = jbk.init_bucketed_state(jcfg, topo)
    tp = scenarios.default_topic_params(2, device="cpu")
    bs = bucketed.init_bucketed_state(cfg, _port_topo(topo), device="cpu")
    key = rng.PRNGKey(0, device="cpu")
    with pytest.raises(ValueError):
        jbk.bucketed_run(jbs, jcfg, jscenarios.default_topic_params(2),
                         jax.random.PRNGKey(0), 1)
    with pytest.raises(ValueError, match="raise"):
        bucketed.bucketed_run(bs, cfg, tp, key, 1, device="cpu")
    rec = dataclasses.replace(cfg, invariant_mode="record")
    a = bucketed.bucketed_step(bs, cfg, tp, key, device="cpu")
    b = bucketed.bucketed_step(bs, rec, tp, key, device="cpu")
    for x, y in zip(bucketed.named_leaves(a), bucketed.named_leaves(b)):
        assert torch.equal(x[1], y[1]), x[0]


def test_sharded_branches_are_refused(monkeypatch):
    """Inside a torch.distributed group of more than one process (the
    counterpart of the reference's kernel mesh) the step refuses, naming
    Queue 1 item 7."""
    cfg, tp, bs = _port_case("fold_in", "bucket", "f32")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 7\)"):
        bucketed.bucketed_step(bs, cfg, tp, rng.PRNGKey(0, device="cpu"),
                               device="cpu")
