"""The port's fleet plane (go_libp2p_pubsub_tpu_torch/sim/fleet.py and
parallel/compile_plan.fleet_chunk) against the JAX package's on the CPU.

The reference tests' tiny config (tests/test_fleet.py:44-51: 64 peers,
K = 8, a 32-message window, scoring on, the canonical topic parameters),
8 ticks. The core claim, as tests/test_fleet.py holds the reference:
every member's final state equals its own sequential ``engine.run`` bit
for bit (B = 1 and 3; score-weight variants batched together; a fault
plan on one member only; heterogeneous tick counts with compaction; kill
and resume; deadline and ladder retries), and once against the
reference's own ``fleet_run`` of the same members (module-scoped: one JAX
compile), whose per-member ``collect_health`` rows the port's equal too
(``score_mean`` to rtol 1e-5, the telemetry lane's documented exception
(sim/telemetry.py); every other column
exact). Also: a B = 4 journal cannot resume into B = 8; a fleet crash
dump carries per-member flags and replays one member in the port; a
raise-mode member retires without its siblings, a record-mode one runs
on; the journal's per-group header binds rows to input indices after
compaction; ``fleet_chunk``'s cache and first-use bookkeeping, one
executable per window length whatever the number of members;
``fleet_run_keys`` and its donated flavour; the row takes keep every
dtype, the compact layout's packed planes included; one-device placement
and the refusals naming their ROADMAP item."""

import dataclasses
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.sim import SimConfig as JConfig
from go_libp2p_pubsub_tpu.sim import init_state as jinit_state
from go_libp2p_pubsub_tpu.sim import scenarios as jscenarios
from go_libp2p_pubsub_tpu.sim import topology as jtopology
from go_libp2p_pubsub_tpu.sim import fleet as jfleet
from go_libp2p_pubsub_tpu_torch import replay_crash, rng
from go_libp2p_pubsub_tpu_torch.parallel import compile_plan
from go_libp2p_pubsub_tpu_torch.sim import (SimConfig, TopicParams,
                                            checkpoint, encode_state,
                                            engine, scenarios,
                                            state_from_reference,
                                            state_to_numpy, telemetry)
from go_libp2p_pubsub_tpu_torch.sim.config import with_score_weights
from go_libp2p_pubsub_tpu_torch.sim.fleet import (
    FleetMember, _put_rows, _take_rows, fleet_devices, fleet_run,
    fleet_run_keys, fleet_run_keys_donated, member_state, shard_fleet,
    stack_states, supervised_fleet_run)
from go_libp2p_pubsub_tpu_torch.sim.invariants import FAULT_PARTITION
from go_libp2p_pubsub_tpu_torch.sim.supervisor import (SupervisorConfig,
                                                       SupervisorCrash)

N_TICKS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs (the
    suite runs in several worker processes; see
    tests/test_torch_engine_modes.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def _assert_equal(want, got, where=""):
    want = want if isinstance(want, dict) else state_to_numpy(want)
    got = state_to_numpy(got)
    for f, a in want.items():
        assert got[f].dtype == a.dtype, (f, got[f].dtype, a.dtype, where)
        np.testing.assert_array_equal(got[f], a, err_msg=f"{f} {where}")


def _port(jcfg, jtp, jst):
    return (SimConfig(**dataclasses.asdict(jcfg)),
            TopicParams(*[torch.from_numpy(np.array(x)) for x in jtp]),
            state_from_reference(_arrays(jst), device="cpu"))


@pytest.fixture(scope="module")
def jbase():
    jcfg = JConfig(n_peers=64, k_slots=8, n_topics=1, msg_window=32,
                   publishers_per_tick=2, prop_substeps=4,
                   scoring_enabled=True)
    jtp = jscenarios.default_topic_params(1)
    jst = jinit_state(jcfg, jtopology.sparse(64, 8, degree=3))
    return jcfg, jtp, jst


@pytest.fixture(scope="module")
def base(jbase):
    return _port(*jbase)


def _members(base, b, n_ticks=N_TICKS):
    cfg, tp, st = base
    return [FleetMember(cfg, tp, st, rng.PRNGKey(100 + i, device="cpu"),
                        n_ticks, name=f"m{i}") for i in range(b)]


def _sup(**kw):
    kw.setdefault("chunk_ticks", 4)
    kw.setdefault("backoff_base_s", 0.0)
    kw.setdefault("sleep", lambda s: None)
    return SupervisorConfig(**kw)


def _sequential(m, n_ticks=None):
    return engine.run(m.state, m.cfg, m.tp, m.key,
                      m.n_ticks if n_ticks is None else n_ticks,
                      device="cpu")


def _supervised(members, sup=None, **kw):
    return supervised_fleet_run(members, sup or _sup(), device="cpu", **kw)


# --- parity -----------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 3])
def test_fleet_bit_exact_vs_sequential(base, b):
    members = _members(base, b)
    results = fleet_run(members, device="cpu")
    for m, r in zip(members, results):
        _assert_equal(_sequential(m), r.state, m.name)
        assert r.ticks_run == m.n_ticks and not r.tripped


@pytest.fixture(scope="module")
def reference_fleet(jbase):
    """The reference's ``fleet_run`` of three members with
    ``collect_health`` (one JAX compile for the module)."""
    jcfg, jtp, jst = jbase
    members = [jfleet.FleetMember(jcfg, jtp, jst,
                                  jax.random.PRNGKey(100 + i), N_TICKS,
                                  name=f"m{i}") for i in range(3)]
    return jfleet.fleet_run(members, collect_health=True)


def test_fleet_equals_the_reference_fleet(base, reference_fleet):
    results = fleet_run(_members(base, 3), collect_health=True,
                        device="cpu")
    for want, got in zip(reference_fleet, results):
        _assert_equal(_arrays(want.state), got.state, got.name)
        assert (got.name, got.ticks_run, got.fault_flags, got.tripped) == \
            (want.name, want.ticks_run, want.fault_flags, want.tripped)
        assert len(got.health_rows) == len(want.health_rows) == N_TICKS
        for a, b in zip(want.health_rows, got.health_rows):
            assert set(a) == set(b)
            for k in a:
                if k == "score_mean":
                    np.testing.assert_allclose(b[k], a[k], rtol=1e-5)
                else:
                    assert a[k] == b[k], (k, a[k], b[k], got.name)


def test_score_weight_variants_batch_together(base):
    cfg, tp, st = base
    variants = [tp, with_score_weights(tp, p2=4.0),
                with_score_weights(tp, p3=0.0, p3b=0.0)]
    members = [FleetMember(cfg, v, st, rng.PRNGKey(7 + i, device="cpu"),
                           N_TICKS, name=f"v{i}")
               for i, v in enumerate(variants)]
    results, rep = _supervised(members)
    plan = next(e for e in rep.events if e["event"] == "fleet_plan")
    assert plan["groups"] == 1 and plan["sizes"] == [3]
    for m, r in zip(members, results):
        _assert_equal(_sequential(m), r.state, m.name)


def test_fault_plan_on_one_member_only(base):
    cfg, tp, st = base
    fcfg, ftp, fst = scenarios.partition_small(
        n_peers=64, k_slots=8, degree=3, start=2, heal=6, device="cpu")
    members = [
        FleetMember(cfg, tp, st, rng.PRNGKey(1, device="cpu"), N_TICKS, "a"),
        FleetMember(fcfg, ftp, fst, rng.PRNGKey(2, device="cpu"), N_TICKS,
                    "faulty"),
        FleetMember(cfg, tp, st, rng.PRNGKey(3, device="cpu"), N_TICKS, "b"),
    ]
    results = fleet_run(members, chunk_ticks=4, device="cpu")
    for m, r in zip(members, results):
        _assert_equal(_sequential(m), r.state, m.name)
    assert results[1].fault_flags & FAULT_PARTITION
    assert "partition" in results[1].flag_names
    assert results[0].fault_flags == 0 and results[2].fault_flags == 0


def test_heterogeneous_ticks_compact_finished_members(base, tmp_path):
    cfg, tp, st = base
    members = [FleetMember(cfg, tp, st, rng.PRNGKey(20 + i, device="cpu"),
                           t, name=f"t{t}") for i, t in enumerate((3, 5, 8))]
    path = str(tmp_path / "h.ndjson")
    results, rep = _supervised(members, _sup(health_path=path),
                               collect_health=True)
    compacts = [e for e in rep.events if e["event"] == "compact"]
    assert [c["active"] for c in compacts] == [2, 1]
    for m, r in zip(members, results):
        _assert_equal(_sequential(m), r.state, m.name)
        assert r.ticks_run == m.n_ticks == len(r.health_rows)
    # the journal binds each lane's rows to its input index after
    # compaction, and they equal the collected ones
    j = telemetry.read_journal(path)
    assert j["runs"][0]["member_ids"] == [0, 1, 2]
    assert j["runs"][0]["member_names"] == ["t3", "t5", "t8"]
    for i, r in enumerate(results):
        assert [{k: v for k, v in row.items() if k != "kind"}
                for row in j["rows"] if row["member"] == i] == r.health_rows


def test_fleet_run_keys_equals_the_members_run_keys(base):
    cfg, tp, st = base
    keys = torch.stack([rng.split(rng.PRNGKey(i, device="cpu"), 3)
                        for i in range(2)], dim=1)
    states, tps = stack_states([st] * 2), stack_states([tp] * 2)
    out, rec = fleet_run_keys(states, cfg, tps, keys, telemetry=True,
                              device="cpu")
    assert tuple(rec.tick.shape) == (3, 2)
    for i in range(2):
        want, wrec = engine.run_keys(st, cfg, tp, keys[:, i],
                                     telemetry=True, device="cpu")
        _assert_equal(want, member_state(out, i))
        for a, b in zip(wrec, rec):
            assert torch.equal(a, b[:, i])
    donated = fleet_run_keys_donated(states, cfg, tps, keys, device="cpu")
    assert donated is states
    _assert_equal(out, states)


def test_fleet_chunk_cache_and_first_use(base):
    cfg, tp, st = base
    states, tps = stack_states([st] * 2), stack_states([tp] * 2)
    keys = torch.stack([rng.split(rng.PRNGKey(i, device="cpu"), 2)
                        for i in range(2)], dim=1)
    compile_plan.clear_caches()
    try:
        exe, first = compile_plan.fleet_chunk(cfg, states, tps, keys,
                                              mark=False)
        assert first and compile_plan.fleet_chunk(
            cfg, states, tps, keys, mark=False) == (exe, True)
        assert compile_plan.fleet_chunk(cfg, states, tps, keys) == \
            (exe, True)
        assert compile_plan.fleet_chunk(cfg, states, tps, keys) == \
            (exe, False)
        # one executable serves any number of members
        one = member_state(states, 0)
        assert compile_plan.fleet_chunk(
            cfg, stack_states([one]), stack_states([tp]), keys[:, :1]) == \
            (exe, False)
        tail, first = compile_plan.fleet_chunk(cfg, states, tps, keys[:1])
        assert tail is not exe and first
        assert compile_plan.donated_param_count(exe) == 0
        assert compile_plan.cache_sizes() == {"engine": 0, "fleet": 2}
        _assert_equal(fleet_run_keys(states, cfg, tps, keys, device="cpu"),
                      exe(states, tps, keys))
        with pytest.raises(ValueError, match="this executable takes"):
            exe(states, tps, keys[:1])
        compile_plan.retire(exe)
        again, first = compile_plan.fleet_chunk(cfg, states, tps, keys)
        assert again is not exe and first
        with pytest.raises(ValueError, match="invariant_mode='raise'"):
            compile_plan.fleet_chunk(
                dataclasses.replace(cfg, invariant_mode="raise"), states,
                tps, keys)
    finally:
        compile_plan.clear_caches()


def test_compaction_adds_no_executable(base):
    """Windows of 3, 2 and 1 members (tick counts 3, 5, 8 in windows of
    4: lengths 3, 2, 3) leave one fleet executable per window length,
    whatever the number of members: the cache stays bounded by the
    lengths, never by the active counts."""
    cfg, tp, st = base
    members = [FleetMember(cfg, tp, st, rng.PRNGKey(30 + i, device="cpu"),
                           t, name=f"t{t}") for i, t in enumerate((3, 5, 8))]
    compile_plan.clear_caches()
    try:
        results, rep = _supervised(members)
        windows = [(e["b_active"], e["window_ticks"]) for e in rep.events
                   if e["event"] == "chunk_ok"]
        assert windows == [(3, 3), (2, 2), (1, 3)]
        assert compile_plan.cache_sizes() == {"engine": 0, "fleet": 2}
    finally:
        compile_plan.clear_caches()
    for m, r in zip(members, results):
        _assert_equal(_sequential(m), r.state, m.name)


def test_row_takes_keep_every_dtype(base):
    """``_take_rows``/``_put_rows`` keep each field's dtype and values,
    in the compact layout too (packed int32 planes, int16, int8)."""
    cfg, tp, st = base
    ccfg = dataclasses.replace(cfg, state_precision="compact")
    for s in (st, encode_state(st, ccfg)):
        mid = engine.run(s, ccfg if s is not st else cfg, tp,
                         rng.PRNGKey(3, device="cpu"), 2, device="cpu")
        full = stack_states([s, mid, s])
        idx = torch.tensor([2, 1], dtype=torch.int64)
        rows = _take_rows(full, idx)
        assert [x.dtype for x in rows] == [x.dtype for x in s]
        _assert_equal(mid, member_state(rows, 1))
        put = _put_rows(full, idx, stack_states([mid, s]))
        assert [x.dtype for x in put] == [x.dtype for x in s]
        for i, want in enumerate((s, s, mid)):
            _assert_equal(want, member_state(put, i))
        _assert_equal(s, member_state(full, 2))   # out of place


def test_placement_is_one_device(base):
    cfg, tp, st = base
    states, tps = stack_states([st] * 4), stack_states([tp] * 4)
    assert fleet_devices(4) == 1 and fleet_devices(4, ["a", "b"]) == 2
    assert fleet_devices(3, ["a", "b"]) == 1
    got = shard_fleet(states, tps)
    assert got[0] is states and got[1] is tps
    assert shard_fleet(states, tps, keys="k")[2] == "k"
    assert shard_fleet(stack_states([st] * 3), stack_states([tp] * 3),
                       devices=["cpu", "cpu"])[0] is not None
    # over two devices: contiguous member blocks, one per device, as the
    # reference's fleet axis splits (fleet.py:150-191)
    keys = torch.arange(3 * 4 * 2).reshape(3, 4, 2)
    parts, tparts, kparts = shard_fleet(states, tps, keys,
                                        devices=["cpu", "cpu"])
    assert len(parts) == len(tparts) == len(kparts) == 2
    for i in range(2):
        for a, w in zip(parts[i], states):
            assert torch.equal(a, w[2 * i:2 * i + 2])
        assert torch.equal(kparts[i], keys[:, 2 * i:2 * i + 2])


@pytest.mark.parametrize("hook, item", [
    # the reference's fleet plane never reads commands: refused, naming
    # the directives a fleet would drop
    ({"commands": object()}, "drop every directive"),
    # nor the multi-process hooks: refused, naming them
    ({"run_fn": lambda *a: None}, "runs no multi-process hook"),
    ({"liveness": object()}, "runs no multi-process hook"),
])
def test_unported_hooks_are_refused_by_item(base, hook, item):
    with pytest.raises(NotImplementedError, match=item):
        _supervised(_members(base, 2), _sup(**hook))


# --- supervision ----------------------------------------------------------------

def _kill_at(start):
    def kill(info):
        if info["window_start"] >= start:
            raise KeyboardInterrupt("simulated preemption")
    return kill


def test_kill_resume_bit_identical(base, tmp_path):
    members = _members(base, 3)
    ck = str(tmp_path / "ck")
    with pytest.raises(KeyboardInterrupt):
        _supervised(members, _sup(checkpoint_dir=ck), _chunk_hook=_kill_at(4))
    assert os.listdir(os.path.join(ck, "fleet_g00"))
    results, rep = _supervised(members, _sup(checkpoint_dir=ck))
    assert rep.resumed_tick == 4
    assert rep.ticks_run == 3 * 4        # only the missing window re-ran
    for m, r in zip(members, results):
        _assert_equal(_sequential(m), r.state, m.name)


def test_b4_journal_cannot_resume_into_b8(base, tmp_path):
    ck = str(tmp_path / "ck")
    _, rep4 = _supervised(_members(base, 4), _sup(checkpoint_dir=ck))
    assert rep4.checkpoints
    results, rep8 = _supervised(_members(base, 8), _sup(checkpoint_dir=ck))
    skips = [e for e in rep8.events if e["event"] == "resume_skip"]
    assert skips and "fleet-axis mismatch" in skips[0]["error"]
    assert rep8.resumed_from is None
    for m, r in zip(_members(base, 8), results):
        _assert_equal(_sequential(m), r.state, m.name)


def test_deadline_trip_backoff_then_parity(base):
    members = _members(base, 3)

    def slow_once(info):
        if info["window_start"] == 4 and info["attempt"] == 0:
            time.sleep(4.0)

    # a first use of a window shape runs under the compile deadline: run
    # the fleet once so the C = 4 window is a steady-state one. The
    # watchdog stands at ten times a window's time on one idle core, so
    # that only the hook's sleep overruns it when other processes share
    # the cores
    _supervised(members)
    results, rep = _supervised(members, _sup(deadline_s=3.0, max_retries=2),
                               _chunk_hook=slow_once)
    assert rep.retries == 1
    fails = [e for e in rep.events if e["event"] == "chunk_failed"]
    assert fails and "deadline" in fails[0]["error"]
    for m, r in zip(members, results):
        _assert_equal(_sequential(m), r.state, m.name)


def test_retry_ladder_then_parity(base):
    members = _members(base, 2)
    fails = iter([True])

    def flaky(info):
        if next(fails, False):
            raise RuntimeError("transient")

    results, rep = _supervised(members, _sup(max_retries=2),
                               _chunk_hook=flaky)
    assert rep.retries == 1
    assert any(e["event"] == "degrade" for e in rep.events)
    for m, r in zip(members, results):
        _assert_equal(_sequential(m), r.state, m.name)


def test_crash_dump_carries_per_member_flags(base, tmp_path):
    members = _members(base, 2)

    def boom(info):
        raise RuntimeError("permanent failure")

    with pytest.raises(SupervisorCrash) as ei:
        _supervised(members, _sup(max_retries=1, crash_dir=str(tmp_path)),
                    _chunk_hook=boom)
    dump = ei.value.dump_dir
    meta = json.load(open(os.path.join(dump, "crash.json")))
    assert meta["fleet_size"] == 2 and meta["member_ids"] == [0, 1]
    assert meta["member_names"] == ["m0", "m1"]
    assert meta["fault_flags"] == [0, 0]
    assert meta["config_fingerprint"] == checkpoint.config_fingerprint(
        members[0].cfg, fleet=2)
    assert np.asarray(meta["window_key_data"]).shape == (4, 2, 2)
    like = stack_states([members[0].state, members[1].state])
    back = checkpoint.restore(os.path.join(dump, "last_good"), like,
                              cfg=members[0].cfg)
    assert tuple(back.tick.shape) == (2,)
    # member 1's window replays alone, on its own keys
    cfg, tp, st = base
    res = replay_crash.replay_fleet(dump, 1, like=st, cfg=cfg, tp=tp,
                                    device="cpu")
    assert res["tripped"] is False and res["ticks"] == 4
    assert res["member_name"] == "m1"
    with pytest.raises(SystemExit, match="not in this dump"):
        replay_crash.replay_fleet(dump, 5, like=st, cfg=cfg, tp=tp,
                                  device="cpu")


def _poisoned(st):
    return st._replace(halo_overflow=torch.tensor(3, dtype=torch.int32))


def test_raise_member_retires_without_killing_siblings(base, tmp_path):
    cfg, tp, st = base
    rcfg = dataclasses.replace(cfg, invariant_mode="raise")
    members = [
        FleetMember(cfg, tp, st, rng.PRNGKey(1, device="cpu"), N_TICKS,
                    "ok0"),
        FleetMember(rcfg, tp, _poisoned(st), rng.PRNGKey(2, device="cpu"),
                    N_TICKS, "poisoned"),
        FleetMember(cfg, tp, st, rng.PRNGKey(3, device="cpu"), N_TICKS,
                    "ok1"),
    ]
    results, rep = _supervised(members, _sup(
        checkpoint_dir=str(tmp_path / "ck")))
    tripped = results[1]
    assert tripped.tripped and tripped.ticks_run == 4   # retired early
    assert any("VIOLATION" in n for n in tripped.flag_names)
    assert any(e["event"] == "member_tripped" for e in rep.events)
    # frozen at the end of the window where the trip showed: its first 4
    # ticks of its own 8-tick key stream, run under "record"
    m = members[1]
    want = engine.run_keys(m.state, cfg, tp,
                           rng.split(m.key, N_TICKS)[:4], device="cpu")
    _assert_equal(want, tripped.state)
    for i in (0, 2):
        m, r = members[i], results[i]
        assert not r.tripped and r.fault_flags == 0
        _assert_equal(_sequential(m), r.state, m.name)
    # resume from the final checkpoint keeps the trip and runs nothing
    again, rep2 = _supervised(members, _sup(
        checkpoint_dir=str(tmp_path / "ck")))
    assert rep2.ticks_run == 0 and again[1].tripped
    _assert_equal(tripped.state, again[1].state)


def test_record_member_with_flags_is_not_retired(base):
    cfg, tp, st = base
    members = [FleetMember(cfg, tp, _poisoned(st),
                           rng.PRNGKey(5, device="cpu"), N_TICKS,
                           "recorded")]
    results = fleet_run(members, device="cpu")
    assert not results[0].tripped
    assert results[0].ticks_run == N_TICKS
    assert any("VIOLATION" in n for n in results[0].flag_names)


def test_fleet_run_refuses_the_cpu_without_device(base):
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is the default device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fleet_run(_members(base, 1))
