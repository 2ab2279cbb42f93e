"""The port's ``.npz`` checkpoints (go_libp2p_pubsub_tpu_torch/sim/
checkpoint.py) against the JAX package's on the CPU.

- a save at tick 4, a restore and 4 more ticks equal the 8 uninterrupted
  ticks, under f32 and compact storage;
- a checkpoint the reference saved as ``.npz`` restores in the port, and
  one the port saved restores in the reference, bit for bit, in either
  layout, and resumes to the reference's uninterrupted trajectory;
  sidecars and ``config_fingerprint`` equal the reference's (a plain
  config, one with a fault plan, a compact one, a fleet axis);
- ``restore``'s validation: a shape or a dtype mismatch names the field,
  a field missing from the file restores from ``like``, a torn payload
  raises ``CheckpointCorrupt``, a cross-precision restore and another
  config are refused by name, the bucketed state by its queue item; the
  crash-atomic save leaves no temp files."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build
from go_libp2p_pubsub_tpu.sim import checkpoint as jckpt
from go_libp2p_pubsub_tpu.sim import faults as jfaults
from go_libp2p_pubsub_tpu.sim import scenarios as jscenarios
from go_libp2p_pubsub_tpu.sim.engine import run_keys as jrun_keys
from go_libp2p_pubsub_tpu.sim.state import encode_state as jencode
from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.sim import (SimConfig, TopicParams,
                                            checkpoint, engine,
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


def _arrays(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def _assert_equal(ref: dict, got: dict, where: str = ""):
    for f, want in ref.items():
        have = got[f]
        assert have.dtype == want.dtype, (f, have.dtype, want.dtype)
        np.testing.assert_array_equal(have, want, err_msg=f"{f} {where}")


def _net(precision):
    """The reference's 256-peer headline (its XLA hop) in ``precision``'s
    stored layout, and the port's copy."""
    jcfg, jtp, jst = _build(256, 16, 6, publishers=8)
    jcfg = dataclasses.replace(jcfg, hop_mode="xla",
                               state_precision=precision)
    jst = jencode(jst, jcfg)
    cfg = SimConfig(**dataclasses.asdict(jcfg))
    tp = TopicParams(*[torch.from_numpy(np.array(x)) for x in jtp])
    return (jcfg, jtp, jst), (cfg, tp, state_from_reference(_arrays(jst),
                                                            device="cpu"))


@pytest.fixture(scope="module", params=["f32", "compact"])
def net(request):
    (jcfg, jtp, jst), port = _net(request.param)
    keys = jax.random.split(jax.random.PRNGKey(0), TICKS)
    half = jrun_keys(jst, jcfg, jtp, keys[:4])
    whole = jrun_keys(half, jcfg, jtp, keys[4:])
    return (jcfg, jtp, jst, half, whole), port


def _keys():
    return rng.split(rng.PRNGKey(0, device="cpu"), TICKS)


def test_resume_equals_the_uninterrupted_run(net, tmp_path):
    (_, _, _, _, whole), (cfg, tp, st) = net
    keys = _keys()
    want = engine.run_keys(st, cfg, tp, keys, device="cpu")
    _assert_equal(_arrays(whole), state_to_numpy(want), "reference")
    half = engine.run_keys(st, cfg, tp, keys[:4], device="cpu")
    path = str(tmp_path / "ck")
    checkpoint.save(path, half, cfg=cfg)
    assert os.path.exists(path + ".npz") and sorted(os.listdir(tmp_path)) \
        == ["ck.fingerprint", "ck.npz"]
    back = checkpoint.restore(path, st, cfg=cfg)
    _assert_equal(state_to_numpy(half), state_to_numpy(back), "restored")
    got = engine.run_keys(back, cfg, tp, keys[4:], device="cpu")
    _assert_equal(state_to_numpy(want), state_to_numpy(got), "resumed")


def test_restored_planes_are_contiguous(net, tmp_path):
    """A CPU run leaves some planes as transposed views (``deliver_tick``,
    ``iwant_pending``), which ``.npz`` stores in Fortran order; a restored
    or converted state is contiguous all the same, as the card's kernels
    need (a CPU checkpoint resumed on the card fed ``iwant_resolve`` a
    strided ``pend``, which it refuses)."""
    _, (cfg, tp, st) = net
    half = engine.run_keys(st, cfg, tp, _keys()[:4], device="cpu")
    path = str(tmp_path / "ck")
    checkpoint.save(path, half, cfg=cfg)
    for back in (checkpoint.restore(path, st, cfg=cfg),
                 state_from_reference(state_to_numpy(half), device="cpu")):
        assert [f for f, x in zip(back._fields, back)
                if not x.is_contiguous()] == []
        _assert_equal(state_to_numpy(half), state_to_numpy(back))


def test_checkpoints_cross_between_packages(net, tmp_path):
    (jcfg, jtp, jst, jhalf, jwhole), (cfg, tp, st) = net
    keys = _keys()
    # the reference's save restores in the port and resumes
    ref_path = str(tmp_path / "ref.npz")
    jckpt.save(ref_path, jhalf, cfg=jcfg, processes=1)
    back = checkpoint.restore(ref_path, st, cfg=cfg)
    _assert_equal(_arrays(jhalf), state_to_numpy(back), "from reference")
    got = engine.run_keys(back, cfg, tp, keys[4:], device="cpu")
    _assert_equal(_arrays(jwhole), state_to_numpy(got), "resumed")
    # the port's save restores in the reference, bit for bit
    port_path = str(tmp_path / "port.npz")
    checkpoint.save(port_path, back, cfg=cfg, extra={"stream_offset": 17})
    jback = jckpt.restore(port_path, jst, cfg=jcfg)
    _assert_equal(_arrays(jhalf), _arrays(jback), "into reference")
    meta, jmeta = checkpoint.sidecar_meta(port_path), \
        jckpt.sidecar_meta(ref_path)
    assert jckpt.sidecar_meta(port_path) == meta
    assert meta.pop("stream_offset") == "17" and meta == jmeta
    assert meta["fingerprint"] == jckpt.config_fingerprint(jcfg)
    assert meta["state_precision"] == cfg.state_precision
    assert meta["processes"] == "1"


def test_fingerprints_equal_the_reference():
    plan = ("drop=0.1,partition=2@1:4,censor=0.4x1@1:7,storm=4x0.9x0@2:5,"
            "wave=0.25@4:2:8,seed=3")
    jcfgs = [_build(64, 8, 4)[0],
             dataclasses.replace(jscenarios.frontier_cfg(1024),
                                 fault_plan=jfaults.FaultPlan.parse(plan)),
             jscenarios.frontier_cfg(4096, state_precision="compact")]
    for jcfg in jcfgs:
        cfg = SimConfig(**dataclasses.asdict(jcfg))
        assert repr(cfg) == repr(jcfg)
        for fleet in (None, 4):
            assert checkpoint.config_fingerprint(cfg, fleet) == \
                jckpt.config_fingerprint(jcfg, fleet)
    st = _net("f32")[1][2]
    assert checkpoint.fleet_axis(st) is None
    assert checkpoint.fleet_axis(st._replace(tick=torch.zeros(3))) == 3


def test_restore_validates_every_field(tmp_path):
    _, (cfg, tp, st) = _net("f32")
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, st)
    arrays = dict(np.load(path))
    # a shape mismatch names the field
    bad = dict(arrays, deliver_tick=arrays["deliver_tick"][:, :-1])
    np.savez(path, **bad)
    with pytest.raises(ValueError, match="'deliver_tick'"):
        checkpoint.restore(path, st)
    # a dtype mismatch names the field
    bad = dict(arrays, have=arrays["have"].view(np.int32))
    np.savez(path, **bad)
    with pytest.raises(ValueError, match="'have'.*int32"):
        checkpoint.restore(path, st)
    # a missing field restores from like
    part = {f: a for f, a in arrays.items() if f != "iwant_pending"}
    np.savez(path, **part)
    like = st._replace(iwant_pending=torch.full_like(st.iwant_pending, 5))
    back = checkpoint.restore(path, like)
    assert back.iwant_pending is like.iwant_pending
    _assert_equal({f: a for f, a in arrays.items() if f != "iwant_pending"},
                  state_to_numpy(back), "partial")
    # a torn payload
    checkpoint.save(path, st)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(checkpoint.CheckpointCorrupt, match="unreadable"):
        checkpoint.restore(path, st)
    with pytest.raises(checkpoint.CheckpointCorrupt):
        checkpoint.restore(str(tmp_path / "missing.npz"), st)


def test_refusals_by_name(tmp_path):
    (jcfg_f, _, jst_f), (cfg_f, _, st_f) = _net("f32")
    (_, _, jst_c), (cfg_c, _, st_c) = _net("compact")
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, st_c, cfg=cfg_c)
    with pytest.raises(ValueError, match="state_precision mismatch"):
        checkpoint.restore(path, st_f, cfg=cfg_f)
    jpath = str(tmp_path / "jck.npz")
    jckpt.save(jpath, jst_c, cfg=dataclasses.replace(
        jcfg_f, state_precision="compact"))
    with pytest.raises(ValueError, match="state_precision mismatch") as want:
        jckpt.restore(jpath, jst_f, cfg=jcfg_f)
    with pytest.raises(ValueError, match="state_precision mismatch") as got:
        checkpoint.restore(jpath, st_f, cfg=cfg_f)
    assert str(got.value) == str(want.value)
    # the matching restore round-trips
    back = checkpoint.restore(path, st_c, cfg=cfg_c)
    _assert_equal(state_to_numpy(st_c), state_to_numpy(back), "compact")
    other = dataclasses.replace(cfg_c, publishers_per_tick=3)
    with pytest.raises(ValueError, match="different config"):
        checkpoint.restore(path, st_c, cfg=other)
    # a compact checkpoint under an f32 like without cfg: field by field
    with pytest.raises(ValueError, match="checkpoint field 'connected'"):
        checkpoint.restore(path, st_f)
    bucketed = dataclasses.replace(cfg_f, degree_buckets=((256, 16),))
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 8\)"):
        checkpoint.save(path, st_f, cfg=bucketed)
    with pytest.raises(TypeError, match="SimState"):
        checkpoint.save(path, tuple(st_f))
    assert sorted(os.listdir(tmp_path)) == ["ck.npz", "ck.npz.fingerprint",
                                            "jck.npz", "jck.npz.fingerprint"]
    assert jnp.asarray(jst_c.mesh).dtype == jnp.uint32
