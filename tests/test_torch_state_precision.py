"""The port's compact storage (go_libp2p_pubsub_tpu_torch/sim/state.py,
``state_precision="compact"``) against the JAX package on the CPU.

- the codecs: ``encode_state`` and ``decode_state`` bit-equal to the
  reference's on random f32-layout states holding NEVER and -NEVER,
  deltas beyond the int16 saturation, ragged packed words (K = 20, pad
  bits zero), NaN of either sign and payload, infinities, subnormals and
  rounding ties; the NaN encoding pinned (torch's own conversion gives
  other bits); ``have_set_bit``;
- the pricing: ``state_spec``, ``state_nbytes`` (one device and a 2 x 4
  mesh), ``per_peer_byte_ceilings`` and ``check_hbm_budget`` (its
  refusal text too) equal to the reference's for the headline,
  ``beacon_10k`` (K = 48, T = 9) and every ``frontier_*`` size, under
  both precisions; ``GRAFT_HBM_BUDGET`` parses the same;
- the trajectories: 8 ticks of the 1024-peer headline (fused) and of
  ``frontier(1024)`` (sort exchanges) under compact storage, the stored
  state equal to the reference's compact run, bit for bit, after every
  tick (the reference's headline under its XLA hop, which it pins
  bit-identical to its fused kernels); ``run``, ``run_keys`` over
  ``window_keys``, ``run_window`` and ``run_checked`` on one compact
  trajectory; ``mesh_degrees`` and ``delivery_latency_ticks`` on a
  compact state;
- the refusals by name: k_slots > 127, an unknown precision, a state
  handed to the wrong codec direction (TypeError, as the reference's);
  and the bucketed pricing (``bucketed_edge_nbytes``, ``state_nbytes``
  with ``bucket_shards``, ``check_hbm_budget`` and its refusal text)
  equal to the reference's on the power-law configs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build
from go_libp2p_pubsub_tpu.sim import scenarios as jscenarios
from go_libp2p_pubsub_tpu.sim import state as jstate
from go_libp2p_pubsub_tpu.sim.engine import delivery_latency_ticks as jlat
from go_libp2p_pubsub_tpu.sim.engine import mesh_degrees as jdeg
from go_libp2p_pubsub_tpu.sim.engine import step_jit as jstep
from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.sim import (SimConfig, build_headline,
                                            engine, scenarios, state,
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


TICKS = 8
NEVER = 2 ** 30


def _arrays(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def _assert_equal(ref: dict, got: dict, where: str = ""):
    for f, want in ref.items():
        have = got[f]
        assert have.dtype == want.dtype, (f, have.dtype, want.dtype, where)
        np.testing.assert_array_equal(have, want, err_msg=f"{f} {where}")


def _jax_state(arrays):
    return jstate.SimState(**{f: jnp.asarray(a) for f, a in arrays.items()})


# --- the codecs -------------------------------------------------------------

def _f32_bits(rng_, shape):
    """float32 values with every awkward class: random magnitudes over the
    whole range, NaN of both signs and several payloads, infinities,
    subnormals, zeros of both signs, and exact bf16 rounding ties."""
    bits = rng_.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
        np.uint32)
    special = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800123,
                        0x7FBFFFFF, 0x7F800000, 0xFF800000, 0x00000001,
                        0x800AE398, 0x007FFFFF, 0x00008000, 0x3F808000,
                        0x3F818000, 0x80000000, 0x00000000, 0x7F7FFFFF],
                       np.uint32)
    pick = rng_.random(shape) < 0.3
    bits[pick] = rng_.choice(special, size=int(pick.sum()))
    tame = rng_.random(shape) < 0.3               # counter-like magnitudes
    bits[tame] = rng_.uniform(-200, 200, int(tame.sum())).astype(
        np.float32).view(np.uint32)
    return bits.view(np.float32)


def _random_f32_state(seed, n=48, k=20, t=2, m=40, tick=1234):
    """An f32-layout state of (n, k, t, m) with random planes; returns the
    reference's numpy arrays and the (compact) config."""
    r = np.random.default_rng(seed)
    cfg = jstate.SimConfig(n_peers=n, k_slots=k, n_topics=t, msg_window=m,
                           state_precision="compact")
    spec = jstate.state_spec(dataclasses.replace(cfg, state_precision="f32"))
    out = {}
    for f, (shape, dtype, _) in spec.items():
        codec = jstate._COMPACT_CODECS[f]
        if dtype == np.bool_:
            a = r.random(shape) < 0.5
        elif dtype == np.float32:
            a = _f32_bits(r, shape)
        elif dtype == np.uint32:
            a = r.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
                np.uint32)
        elif codec == "tick16":
            a = (tick + r.integers(-40000, 40000, size=shape)).astype(np.int32)
            a[r.random(shape) < 0.2] = NEVER
            a[r.random(shape) < 0.1] = -NEVER
            a[r.random(shape) < 0.1] = tick + 32766
            a[r.random(shape) < 0.1] = tick - 32767
        elif codec == "slot8":
            a = r.integers(-1, k, size=shape).astype(np.int32)
        else:
            a = r.integers(-5, 1000, size=shape).astype(np.int32)
        out[f] = np.asarray(a, dtype)
    out["tick"] = np.int32(tick)
    return out, cfg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_decode_equal_the_reference(seed):
    arrays, jcfg = _random_f32_state(seed)
    cfg = SimConfig(**dataclasses.asdict(jcfg))
    jenc = jstate.encode_state(_jax_state(arrays), jcfg)
    enc = state.encode_state(state_from_reference(arrays, device="cpu"), cfg)
    _assert_equal(_arrays(jenc), state_to_numpy(enc), "encoded")
    # pad bits of the ragged packed words are zero
    pad = ~((1 << 20) - 1) & 0xFFFFFFFF
    assert not (state_to_numpy(enc)["mesh"] & pad).any()
    jdec = jstate.decode_state(jenc, jcfg)
    dec = state.decode_state(enc, cfg)
    _assert_equal(_arrays(jdec), state_to_numpy(dec), "decoded")
    # the carry-across round trip of a compact state
    back = state_from_reference(_arrays(jenc), device="cpu")
    _assert_equal(_arrays(jenc), state_to_numpy(back), "carried")


def test_nan_encodes_as_the_reference_quiet_nan():
    """XLA's f32 -> bf16 convert gives the quiet NaN of the input's sign
    (0x7FC0 / 0xFFC0) whatever the payload; torch's conversion on the CPU
    gives 0xFFFF. The port follows the reference."""
    nan = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800123,
                    0x7FBFFFFF], np.uint32).view(np.float32)
    raw = torch.from_numpy(nan).to(torch.bfloat16).view(torch.int16)
    assert (raw.numpy().view(np.uint16) == 0xFFFF).all()
    want = np.asarray(jax.lax.bitcast_convert_type(
        jnp.asarray(nan).astype(jnp.bfloat16), jnp.uint16))
    got = state._encode_bf16(torch.from_numpy(nan), None).numpy().view(
        np.uint16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, [0x7FC0, 0xFFC0, 0x7FC0, 0xFFC0,
                                         0x7FC0])


def test_have_set_bit_equals_the_reference():
    r = np.random.default_rng(5)
    have = r.integers(0, 2 ** 32, size=(16, 3), dtype=np.uint64).astype(
        np.uint32)
    t = torch.from_numpy(have.view(np.int32).copy())
    for peer, slot in ((0, 0), (3, 31), (7, 32), (15, 95), (2, 63)):
        want = np.asarray(jstate.have_set_bit(jnp.asarray(have), peer, slot))
        got = state.have_set_bit(t, peer, torch.tensor(slot))
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        have, t = want, got


def test_compact_init_is_the_encoded_f32_init():
    """The compact init equals the reference's compact init and the
    encoded f32 init (state.py:676), on ``frontier(256)``."""
    jc, _, jst = jscenarios.frontier(256, k_slots=16, degree=6,
                                     state_precision="compact")
    cfg, _, st = scenarios.frontier(256, k_slots=16, degree=6,
                                    state_precision="compact", device="cpu")
    _assert_equal(_arrays(jst), state_to_numpy(st), "init")
    _, _, st_f = scenarios.frontier(256, k_slots=16, degree=6, device="cpu")
    _assert_equal(state_to_numpy(state.encode_state(st_f, cfg)),
                  state_to_numpy(st), "encoded f32 init")


# --- the pricing ------------------------------------------------------------

def _pricing_cfgs():
    hl = _build(64, 32, 12)[0]
    beacon = jscenarios.beacon_10k(n_peers=128)[0]
    out = {"headline": dataclasses.replace(hl, n_peers=102400),
           "beacon_10k": dataclasses.replace(beacon, n_peers=10240)}
    for name, n in scenarios.FRONTIER_NS.items():
        out[name] = jscenarios.frontier_cfg(n)
    return out


PRICED = ["headline", "beacon_10k", *scenarios.FRONTIER_NS]


@pytest.fixture(scope="module")
def pricing_cfgs():
    return _pricing_cfgs()


@pytest.mark.parametrize("precision", ["f32", "compact"])
@pytest.mark.parametrize("name", PRICED)
def test_pricing_equals_the_reference(pricing_cfgs, name, precision):
    jcfg = dataclasses.replace(pricing_cfgs[name], state_precision=precision)
    cfg = SimConfig(**dataclasses.asdict(jcfg))
    assert state.state_spec(cfg) == jstate.state_spec(jcfg)
    assert state.per_peer_byte_ceilings(cfg) == \
        jstate.per_peer_byte_ceilings(jcfg)
    for n_dev in (1, {"dcn": 2, "peers": 4}):
        assert state.state_nbytes(cfg, n_dev) == \
            jstate.state_nbytes(jcfg, n_dev)
    assert state.check_hbm_budget(cfg, budget=2 ** 50) == \
        jstate.check_hbm_budget(jcfg, budget=2 ** 50)
    small = state.state_nbytes(cfg)["per_shard"] // 3
    with pytest.raises(ValueError) as want:
        jstate.check_hbm_budget(jcfg, budget=small)
    with pytest.raises(ValueError) as got:
        state.check_hbm_budget(cfg, budget=small)
    assert str(got.value) == str(want.value)
    # every peer-major plane within its ceiling
    ceil = state.per_peer_byte_ceilings(cfg)
    for f, (shape, dtype, peer_major) in state.state_spec(cfg).items():
        if peer_major:
            per_peer = int(np.prod(shape[1:], dtype=np.int64)) \
                * np.dtype(dtype).itemsize
            assert per_peer <= ceil[f], (f, per_peer, ceil[f])


def test_frontier_1m_prices_as_the_issue_reckons(pricing_cfgs):
    """frontier_1m: 3.632 GiB under f32, 1.794 GiB compact."""
    cfg = SimConfig(**dataclasses.asdict(pricing_cfgs["frontier_1m"]))
    gib = {p: state.state_nbytes(dataclasses.replace(
        cfg, state_precision=p))["total"] / 2 ** 30
        for p in ("f32", "compact")}
    assert round(gib["f32"], 3) == 3.632 and round(gib["compact"], 3) == 1.794


@pytest.mark.parametrize("raw", ["", "1000", "2.5GiB", "512mib", "3g", "7K",
                                 "80 GiB", "bogus"])
def test_budget_env_parses_as_the_reference(monkeypatch, raw):
    monkeypatch.setenv("GRAFT_HBM_BUDGET", raw)
    try:
        want = jstate.hbm_budget_bytes()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            state.hbm_budget_bytes()
        assert str(got.value) == str(e)
        return
    assert state.hbm_budget_bytes() == want


# --- the trajectories ---------------------------------------------------------

def _compact(cfg):
    return dataclasses.replace(cfg, state_precision="compact")


@pytest.mark.parametrize("path", ["headline", "frontier"])
def test_compact_trajectory_equals_the_reference(path):
    if path == "headline":
        jcfg, jtp, jst = _build(1024, 32, 12, publishers=8)
        jcfg = dataclasses.replace(_compact(jcfg), hop_mode="xla")
        cfg, tp, st = build_headline(1024, device="cpu")
        cfg = _compact(cfg)
        st = state.encode_state(st, cfg)
        jst = jstate.encode_state(jst, jcfg)
    else:
        jcfg, jtp, jst = jscenarios.frontier(1024, state_precision="compact")
        cfg, tp, st = scenarios.frontier(1024, state_precision="compact",
                                         device="cpu")
        assert SimConfig(**dataclasses.asdict(jcfg)) == cfg
    _assert_equal(_arrays(jst), state_to_numpy(st), "built")
    jkeys = jax.random.split(jax.random.PRNGKey(0), TICKS)
    keys = rng.split(rng.PRNGKey(0, device="cpu"), TICKS)
    for i in range(TICKS):
        jst = jstep(jst, cfg=jcfg, tp=jtp, key=jkeys[i])
        st = engine.step(st, cfg, tp, keys[i], device="cpu")
        assert st.mesh.dtype == torch.int32 and st.deliver_tick.dtype == \
            torch.int16
        _assert_equal(_arrays(jst), state_to_numpy(st), f"after tick {i}")
    assert float(st.delivered_total) > 0
    np.testing.assert_array_equal(engine.mesh_degrees(st).numpy(),
                                  np.asarray(jdeg(jst)))
    assert float(engine.delivery_latency_ticks(st, cfg)) == \
        float(jlat(jst, jcfg))


def test_compact_entry_points_land_on_one_trajectory():
    """A compact headline (256 peers): ``run``, ``run_keys`` over two
    ``window_keys`` windows, ``run_checked`` under ``"raise"`` and the
    ``fold_in`` schedule in ``run_window`` chunks against its ``run``."""
    cfg, tp, st = build_headline(256, k_slots=16, degree=6, device="cpu")
    cfg = _compact(cfg)
    st = state.encode_state(st, cfg)
    key = rng.PRNGKey(9, device="cpu")
    whole = engine.run(st, cfg, tp, key, 6, device="cpu")
    out = st
    for lo, hi in ((0, 2), (2, 6)):
        out = engine.run_keys(out, cfg, tp, engine.window_keys(
            cfg, key, 0, lo, hi, 6), device="cpu")
    _assert_equal(state_to_numpy(whole), state_to_numpy(out), "run_keys")
    checked = engine.run_checked(
        st, dataclasses.replace(cfg, invariant_mode="raise"), tp, key, 6,
        device="cpu")
    _assert_equal(state_to_numpy(whole), state_to_numpy(checked),
                  "run_checked")
    fold = dataclasses.replace(cfg, key_schedule="fold_in")
    want = engine.run(st, fold, tp, key, 6, device="cpu")
    got = engine.run_window(engine.run_window(st, fold, tp, key, 4,
                                              device="cpu"),
                            fold, tp, key, 2, device="cpu")
    _assert_equal(state_to_numpy(want), state_to_numpy(got), "run_window")
    assert int(got.tick) == 6 and got.backoff.dtype == torch.int16


# --- the refusals -------------------------------------------------------------

def test_refusals_by_name():
    cfg, tp, st = build_headline(64, k_slots=8, degree=4, device="cpu")
    key = rng.PRNGKey(0, device="cpu")
    wide = SimConfig(n_peers=256, k_slots=128, state_precision="compact")
    with pytest.raises(ValueError, match="k_slots"):
        state.state_spec(wide)
    with pytest.raises(ValueError, match="state_precision"):
        state.state_spec(SimConfig(n_peers=256, k_slots=16,
                                   state_precision="f16"))
    with pytest.raises(ValueError, match="state_precision"):
        engine.step(st, dataclasses.replace(cfg, state_precision="f16"), tp,
                    key, device="cpu")
    ccfg = _compact(cfg)
    with pytest.raises(TypeError, match="compute layout"):
        engine.step(st, ccfg, tp, key, device="cpu")
    enc = state.encode_state(st, ccfg)
    with pytest.raises(TypeError, match="already in the compact"):
        state.encode_state(enc, ccfg)
    # Queue 1 item 8: the bucketed pricing equals the reference's, its
    # per-bucket list and per-shard split included, on a one-bucket
    # config and the power-law family (powerlaw_10m shard-aligned); a
    # partition that does not tile the id space is refused as there
    jcfgs = [dataclasses.replace(_build(64, 8, 4)[0],
                                 degree_buckets=((64, 8),))]
    jcfgs += [jscenarios.powerlaw_cfg(n, state_precision=p)
              for n in (131_072, 1_048_576) for p in ("f32", "compact")]
    jcfgs.append(jscenarios.powerlaw_cfg(
        10_485_760, shard_align=jscenarios.POWERLAW_MH_ALIGN))
    for jcfg in jcfgs:
        bcfg = SimConfig(**dataclasses.asdict(jcfg))
        for per_bucket in (False, True):
            assert state.bucketed_edge_nbytes(bcfg, per_bucket) == \
                jstate.bucketed_edge_nbytes(jcfg, per_bucket)
        for n_dev in (1, 8, {"dcn": 2, "peers": 4}):
            got = state.state_nbytes(bcfg, n_dev)
            assert got == jstate.state_nbytes(jcfg, n_dev)
            assert len(got["bucket_shards"]) == len(bcfg.degree_buckets)
        assert state.check_hbm_budget(bcfg, 8, budget=2 ** 50) == \
            jstate.check_hbm_budget(jcfg, 8, budget=2 ** 50)
        small = jstate.state_nbytes(jcfg)["per_shard"] // 3
        with pytest.raises(ValueError) as want:
            jstate.check_hbm_budget(jcfg, budget=small)
        with pytest.raises(ValueError) as got:
            state.check_hbm_budget(bcfg, budget=small)
        assert str(got.value) == str(want.value)
    assert round(state.state_nbytes(SimConfig(**dataclasses.asdict(
        jcfgs[4])))["total"] / 2 ** 30, 3) == 1.397
    untiled = dataclasses.replace(cfg, degree_buckets=((32, 8),))
    with pytest.raises(ValueError, match="tile the id space"):
        state.state_nbytes(untiled)
