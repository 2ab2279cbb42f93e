"""The port's health telemetry (go_libp2p_pubsub_tpu_torch/sim/telemetry.py),
its journal and sim/hostio.py against the JAX package on the CPU.

- ``run_keys(telemetry=True)`` records equal to the reference's lane,
  exact in every column but ``score_mean`` (a float32 sum in another
  reduction order, rtol 1e-5), and the final state equal: on the 256-peer
  headline under both storage precisions, and on ``partition_small(256)``
  with the every-family plan and 20 sybils (attacker columns non-zero);
  ``run_window`` and ``run_checked_keys`` with telemetry on the same
  trajectory as ``run_keys``;
- the streamed records equal to ``health_record`` applied after the fact
  to the stored trajectory, bit for bit;
- the host side: ``records_to_rows`` / ``record_to_row`` equal to the
  reference's on the same records; the port's Python encoder byte-equal
  to the reference's Python encoder and parsing equal to its native
  codec; the journal header's fingerprint, ``flags_version`` and attack
  windows; a torn tail and resume deduplication;
- ``faults.attack_schedule`` / ``attack_end_tick`` equal to the
  reference's for every fault family;
- ``hostio``: ``fetch_local`` copies and views, ``key_data``,
  ``is_deleted``."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _build
from go_libp2p_pubsub_tpu.sim import faults as jfaults
from go_libp2p_pubsub_tpu.sim import scenarios as jscenarios
from go_libp2p_pubsub_tpu.sim import telemetry as jtel
from go_libp2p_pubsub_tpu.sim.engine import run_keys as jrun_keys
from go_libp2p_pubsub_tpu.sim.state import encode_state as jencode
from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.sim import (SimConfig, TopicParams, engine,
                                            faults, hostio, invariants,
                                            state_from_reference,
                                            state_to_numpy, telemetry)


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
# partition_small with a plan of every fault family (peer 1 is the censor
# victim)
EVERY_FAMILY = ("drop=0.1,dup=0.2,corrupt=0.3,partition=2@1:4,"
                "outage=0.2@2:5,eclipse=0.1@3:6,censor=0.4x1@1:7,"
                "storm=4x0.9x0@2:5,slowlink=0.3@3:0.1,wave=0.25@4:2:8,seed=3")
FAMILIES = ["drop=0.2", "dup=0.3", "corrupt=0.5", "partition=2@2:6",
            "outage=0.2@2:6,outage=0.1@9:12", "eclipse=0.2@1:5",
            "censor=0.4x3@1:7", "storm=4x0.9x1@2:5", "slowlink=0.3@3:0.1",
            "wave=0.25@4:2:8", "wave=0.25@4:2:9:1", EVERY_FAMILY, ""]


def _arrays(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def _assert_equal(ref: dict, got: dict, where: str = ""):
    for f, want in ref.items():
        have = got[f]
        assert have.dtype == want.dtype, (f, have.dtype, want.dtype)
        np.testing.assert_array_equal(have, want, err_msg=f"{f} {where}")


def _assert_records(jrec, rec, where=""):
    """Exact in every column but score_mean: XLA's CPU reduce-window
    blocks and torch's cascade sum add the same float32 scores in other
    orders (3.1e-6 relative apart at 1024 terms), rtol 1e-5."""
    for f in telemetry.HealthRecord._fields:
        want = np.asarray(getattr(jrec, f))
        have = hostio.fetch_local(getattr(rec, f), want.dtype)
        assert have.shape == want.shape, (f, have.shape, want.shape)
        if f == "score_mean":
            np.testing.assert_allclose(have, want, rtol=1e-5, atol=0,
                                       err_msg=f"{f} {where}")
        else:
            np.testing.assert_array_equal(have, want, err_msg=f"{f} {where}")


def _port(jcfg, jtp, jst):
    return (SimConfig(**dataclasses.asdict(jcfg)),
            TopicParams(*[torch.from_numpy(np.array(x)) for x in jtp]),
            state_from_reference(_arrays(jst), device="cpu"))


def _case(name):
    """(jcfg, jtp, jst) of a telemetry case, the reference's state in the
    config's stored layout."""
    if name == "every family":
        jcfg, jtp, jst = jscenarios.partition_small(256)
        mal = np.zeros(256, bool)
        mal[np.random.default_rng(1).choice(256, 20, replace=False)] = True
        jcfg = dataclasses.replace(
            jcfg, fault_plan=jfaults.FaultPlan.parse(EVERY_FAMILY))
        return jcfg, jtp, jst._replace(malicious=jax.numpy.asarray(mal))
    jcfg, jtp, jst = _build(256, 16, 6, publishers=8)
    jcfg = dataclasses.replace(jcfg, hop_mode="xla")
    if name == "headline, compact":
        jcfg = dataclasses.replace(jcfg, state_precision="compact")
        jst = jencode(jst, jcfg)
    return jcfg, jtp, jst


CASES = ["headline", "headline, compact", "every family"]


@pytest.fixture(scope="module")
def reference():
    """Each case's reference run: run_keys(telemetry=True) over PRNGKey(0)'s
    split."""
    keys = jax.random.split(jax.random.PRNGKey(0), TICKS)
    out = {}
    for name in CASES:
        jcfg, jtp, jst = _case(name)
        out[name] = (jcfg, jtp, jst, jrun_keys(jst, jcfg, jtp, keys,
                                               telemetry=True))
    return out


def _keys():
    return rng.split(rng.PRNGKey(0, device="cpu"), TICKS)


@pytest.mark.parametrize("name", CASES)
def test_run_keys_records_equal_the_reference(reference, name):
    jcfg, jtp, jst, (jout, jrec) = reference[name]
    cfg, tp, st = _port(jcfg, jtp, jst)
    out, rec = engine.run_keys(st, cfg, tp, _keys(), telemetry=True,
                               device="cpu")
    _assert_equal(_arrays(jout), state_to_numpy(out))
    _assert_records(jrec, rec, name)
    assert rec.tick.tolist() == list(range(TICKS))
    if name == "every family":
        assert int(rec.attacker_edges.min()) > 0
        assert int(rec.fault_flags[-1]) != 0


def test_lanes_land_on_one_trajectory(reference):
    """run_window (fold_in) and run_checked_keys stream the same records
    as run_keys over the same keys."""
    jcfg, jtp, jst, _ = reference["headline, compact"]
    cfg, tp, st = _port(jcfg, jtp, jst)
    keys = _keys()
    out, rec = engine.run_keys(st, cfg, tp, keys, telemetry=True,
                               device="cpu")
    cout, crec = engine.run_checked_keys(
        st, dataclasses.replace(cfg, invariant_mode="raise"), tp, keys,
        telemetry=True, device="cpu")
    _assert_equal(state_to_numpy(out), state_to_numpy(cout))
    for a, b in zip(rec, crec):
        assert torch.equal(a, b)
    fold = dataclasses.replace(cfg, key_schedule="fold_in")
    key = rng.PRNGKey(3, device="cpu")
    wout, wrec = engine.run_window(st, fold, tp, key, 4, telemetry=True,
                                   device="cpu")
    kout, krec = engine.run_keys(st, fold, tp, engine.window_keys(
        fold, key, 0, 0, 4, 4), telemetry=True, device="cpu")
    _assert_equal(state_to_numpy(kout), state_to_numpy(wout))
    for a, b in zip(krec, wrec):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", CASES)
def test_streamed_records_equal_post_hoc(reference, name):
    jcfg, jtp, jst, _ = reference[name]
    cfg, tp, st = _port(jcfg, jtp, jst)
    keys = _keys()
    _, rec = engine.run_keys(st, cfg, tp, keys, telemetry=True, device="cpu")
    post = []
    for i in range(TICKS):
        st = engine.step(st, cfg, tp, keys[i], device="cpu")
        post.append(telemetry.health_record(st, cfg, tp))
    for a, b in zip(rec, telemetry.stack_records(post)):
        assert torch.equal(a, b)


# --- the host side ------------------------------------------------------------

def test_rows_equal_the_reference(reference):
    jcfg, jtp, jst, (_, jrec) = reference["every family"]
    cfg, tp, st = _port(jcfg, jtp, jst)
    _, rec = engine.run_keys(st, cfg, tp, _keys(), telemetry=True,
                             device="cpu")
    # the reference's own records carried across, so the rows compare
    # exactly
    mine = telemetry.HealthRecord(*(
        torch.from_numpy(np.array(x).view(np.int32)
                         if np.asarray(x).dtype == np.uint32
                         else np.array(x)) for x in jrec))
    mat, cols = telemetry.records_to_rows(mine)
    jmat, jcols = jtel.records_to_rows(jrec)
    assert cols == jcols
    np.testing.assert_array_equal(mat, jmat)
    one = telemetry.HealthRecord(*(x[3] for x in mine))
    assert telemetry.record_to_row(one, member=2) == jtel.record_to_row(
        jtel.HealthRecord(*(x[3] for x in jrec)), member=2)
    with pytest.raises(ValueError, match="member ids"):
        telemetry.records_to_rows(rec, member_ids=[0, 1])
    assert telemetry.INGEST_COLUMNS == jtel.INGEST_COLUMNS
    assert telemetry.health_columns(3) == jtel.health_columns(3)


def test_encoders_parse_equal(reference):
    _, _, _, (_, jrec) = reference["every family"]
    mat, cols = jtel.records_to_rows(jrec)
    mat[1, 2] = np.nan                          # degraded float columns
    mat[2, cols.index(("score_mean", False))] = np.inf
    payload, encoder = telemetry.encode_rows(mat, cols)
    assert encoder == "python"
    assert payload == jtel.encode_rows_py(mat, cols)
    native, how = jtel.encode_rows(mat, cols, prefer_native=True)
    if how != "native":
        pytest.skip("the reference's native trace codec did not build here")
    mine = [json.loads(ln) for ln in payload.splitlines()]
    theirs = [json.loads(ln) for ln in native.splitlines()]
    assert mine == theirs


def test_journal_header_torn_tail_and_resume(reference, tmp_path):
    jcfg, jtp, jst, _ = reference["every family"]
    cfg, tp, st = _port(jcfg, jtp, jst)
    path = str(tmp_path / "health.jsonl")
    keys = _keys()
    with telemetry.HealthJournal(path) as j:
        j.header(cfg, run="a")
        _, rec = engine.run_keys(st, cfg, tp, keys[:5], telemetry=True,
                                 device="cpu")
        assert j.append_records(rec, lo=0, hi=5) == 5
        j.note("checkpoint", tick=3)
        assert j.append_dicts([{"tick": 99, "member": 5, "x": None}]) == 1
    with open(path, "ab") as f:                 # a kill mid-append
        f.write(b'{"kind": "health", "tick": 9, "memb')
    torn = telemetry.read_journal(path)
    assert [r["tick"] for r in torn["rows"]] == list(range(5)) + [99]
    # resume from tick 3: ticks 3 and 4 stream again, with new values
    mid = engine.run_keys(st, cfg, tp, keys[:3], device="cpu")
    with telemetry.HealthJournal(path, sync_every_write=False) as j:
        _, rec2 = engine.run_keys(mid, cfg, tp, keys[3:], telemetry=True,
                                  device="cpu")
        j.append_records(rec2, lo=3, hi=TICKS)
        j.sync()
    got = telemetry.read_journal(path)
    assert got == jtel.read_journal(path)
    assert [r["tick"] for r in got["rows"]] == list(range(TICKS)) + [99]
    got["rows"].pop()
    # the resumed chunk's marker joined the torn fragment and reads as one
    # torn line, as the reference reads it (two chunk markers remain: the
    # first chunk's and the dict rows'); the resumed rows all arrive
    assert len(got["chunks"]) == 2 and got["notes"][0]["kind"] == "checkpoint"
    assert got["rows"][-1] == telemetry.rows_to_dicts(
        *telemetry.records_to_rows(rec2))[-1] | {"kind": "health"}
    run = got["runs"][0]
    from go_libp2p_pubsub_tpu.sim import checkpoint as jckpt
    from go_libp2p_pubsub_tpu.sim.invariants import FLAGS_VERSION
    assert run["fingerprint"] == jckpt.config_fingerprint(jcfg)
    assert run["flags_version"] == FLAGS_VERSION == invariants.FLAGS_VERSION
    assert run["attack_windows"] == jfaults.attack_schedule(jcfg.fault_plan)
    assert run["columns"] == [nm for nm, _ in
                              jtel.health_columns(jcfg.n_topics)]
    assert telemetry.read_journal(str(tmp_path / "none.jsonl"))["rows"] == []


@pytest.mark.parametrize("spec", FAMILIES)
def test_attack_schedule_equals_the_reference(spec):
    jplan = jfaults.FaultPlan.parse(spec)
    plan = faults.FaultPlan.parse(spec)
    assert faults.attack_schedule(plan) == jfaults.attack_schedule(jplan)
    assert faults.attack_end_tick(plan) == jfaults.attack_end_tick(jplan)
    assert faults.attack_schedule(None) == [] and \
        faults.attack_end_tick(None) == 0


def test_hostio():
    x = torch.tensor([-1, 2], dtype=torch.int32)
    a = hostio.fetch_local(x, np.uint32)
    assert a.tolist() == [0xFFFFFFFF, 2]
    a[1] = 7                                     # a copy, not a view
    assert int(x[1]) == 2
    keys = rng.split(rng.PRNGKey(5, device="cpu"), 3)
    want = np.asarray(jax.random.split(jax.random.PRNGKey(5), 3))
    np.testing.assert_array_equal(hostio.key_data(keys), want)
    assert hostio.key_data(keys).dtype == np.uint32
    rec = telemetry.HealthRecord(*(torch.zeros(2) for _ in range(17)))
    assert not hostio.is_deleted(rec)
    rec.tick.untyped_storage().resize_(0)
    assert hostio.is_deleted(rec)
