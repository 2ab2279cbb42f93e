"""The port's supervised execution plane (go_libp2p_pubsub_tpu_torch/sim/
supervisor.py and replay_crash.py) against the JAX package's on the CPU.

The reference tests' tiny config (tests/test_supervisor.py:41-51: 64 peers,
K = 8, a 32-message window, scoring on) and its 13-tick run from one
master key: the reference's ``engine.run`` is the yardstick, and the
port's eager ``run`` equals it in every field (checked once, in the
module fixture). Then, as tests/test_supervisor.py holds the reference:

- chunked supervised runs (chunks of 5 and of 1, the async pipeline and
  the synchronous one, both key schedules) equal the single run;
- kill and resume, a window bounded by ``max_chunks`` and its resume, a
  foreign config's checkpoint skipped, a torn checkpoint fallen back past;
- the watchdog's deadline, backoff and degrade, still equal; the mode
  rung first on the CPU, and skipped by the card's ladder; an unknown
  mode degrading instead of dead-ending; the backoff schedule;
  ``initial_degrade``;
- crash dumps: retries exhausted, an invariant trip never retried, the
  port's replay of a clean and of a tripped dump, sinks hard-flushed;
- each multi-process hook (``run_fn``, ``state_to_host``,
  ``state_from_host``, ``liveness``, ``chaos``) in one process, equal to
  the reference's run with the same hook;
- the health journal's rows equal the reference's (``score_mean`` to rtol
  1e-5, the one column not exact, sim/telemetry.py; every other column
  exact);
- across the packages: a reference run stopped by ``max_chunks`` resumes
  in the port from its checkpoint directory and ends equal to the
  reference's uninterrupted run; a reference crash dump replays in the
  port, and a port crash dump in the reference. The reference writes
  ``.npz`` checkpoints here (its orbax form needs JAX to read).

Integer, bool and packed planes are exact; float32 planes bit-equal."""

import dataclasses
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.sim import SimConfig as JConfig
from go_libp2p_pubsub_tpu.sim import TopicParams as JTopicParams
from go_libp2p_pubsub_tpu.sim import checkpoint as jckpt
from go_libp2p_pubsub_tpu.sim import init_state as jinit_state
from go_libp2p_pubsub_tpu.sim import topology as jtopology
from go_libp2p_pubsub_tpu.sim import supervisor as jsupervisor
from go_libp2p_pubsub_tpu.sim.engine import run as jrun
from go_libp2p_pubsub_tpu_torch import replay_crash, rng
from go_libp2p_pubsub_tpu_torch.sim import (SimConfig, TopicParams,
                                            checkpoint, engine,
                                            state_from_reference,
                                            state_to_numpy, telemetry)
from go_libp2p_pubsub_tpu_torch.sim.supervisor import (
    ChunkDeadline, SupervisorConfig, SupervisorCrash, SupervisorReport,
    _degrade, list_checkpoints, supervised_run)

N_TICKS = 13


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


def _assert_equal(want: dict, got, where: str = ""):
    """Every field of the port's ``got`` equal to the reference arrays
    ``want`` (dtype included)."""
    got = state_to_numpy(got)
    for f, a in want.items():
        assert got[f].dtype == a.dtype, (f, got[f].dtype, a.dtype, where)
        np.testing.assert_array_equal(got[f], a, err_msg=f"{f} {where}")


@pytest.fixture(scope="module")
def plain():
    """The tiny config on both sides, and the reference's uninterrupted
    13-tick run (one JAX compile for the module)."""
    jcfg = JConfig(n_peers=64, k_slots=8, n_topics=1, msg_window=32,
                   publishers_per_tick=2, prop_substeps=4,
                   scoring_enabled=True)
    jtp = JTopicParams.disabled(1)
    jst = jinit_state(jcfg, jtopology.sparse(64, 8, degree=3))
    jkey = jax.random.PRNGKey(42)
    want = _arrays(jrun(jst, jcfg, jtp, jkey, N_TICKS))
    cfg = SimConfig(**dataclasses.asdict(jcfg))
    tp = TopicParams(*[torch.from_numpy(np.array(x)) for x in jtp])
    st = state_from_reference(_arrays(jst), device="cpu")
    key = rng.PRNGKey(42, device="cpu")
    _assert_equal(want, engine.run(st, cfg, tp, key, N_TICKS, device="cpu"),
                  "eager run")
    return (jcfg, jtp, jst, jkey), (cfg, tp, st, key), want


def _sup(**kw):
    kw.setdefault("chunk_ticks", 5)
    kw.setdefault("backoff_base_s", 0.0)
    kw.setdefault("sleep", lambda s: None)
    return SupervisorConfig(**kw)


def _run(port, n=N_TICKS, sup=None, **kw):
    cfg, tp, st, key = port
    return supervised_run(st, cfg, tp, key, n, sup or _sup(), device="cpu",
                          **kw)


def _kill_at(tick):
    def kill(info):
        if info["chunk_start"] >= tick:
            raise KeyboardInterrupt("simulated preemption")
    return kill


# --- chunked parity ---------------------------------------------------------

@pytest.mark.parametrize("async_chunks", [True, False])
def test_chunked_equals_single_scan(plain, async_chunks):
    _, port, want = plain
    out, rep = _run(port, sup=_sup(async_chunks=async_chunks))
    _assert_equal(want, out)
    assert rep.chunks_run == 3 and rep.ticks_run == N_TICKS
    assert rep.retries == 0 and rep.degrade_level == 0


def test_chunk_size_one(plain):
    _, port, want = plain
    out, rep = _run(port, sup=_sup(chunk_ticks=1))
    _assert_equal(want, out)
    assert rep.chunks_run == N_TICKS


def test_fold_in_schedule_chunks_equal_run_window(plain):
    """Under ``key_schedule="fold_in"`` the chunks dispatch through
    ``engine_window`` and land on the single ``run``'s trajectory."""
    _, (cfg, tp, st, key), _ = plain
    fcfg = dataclasses.replace(cfg, key_schedule="fold_in")
    ref = engine.run(st, fcfg, tp, key, N_TICKS, device="cpu")
    out, _ = _run((fcfg, tp, st, key), sup=_sup(chunk_ticks=4))
    _assert_equal(state_to_numpy(ref), out)


def test_the_input_state_is_left_as_it_was(plain):
    _, (cfg, tp, st, key), _ = plain
    before = state_to_numpy(st)
    _run((cfg, tp, st, key))
    _assert_equal(before, st)


# --- kill, resume, windows ----------------------------------------------------

def test_kill_and_resume_bit_identical(plain, tmp_path):
    _, port, want = plain
    ck = str(tmp_path / "ck")
    with pytest.raises(KeyboardInterrupt):
        _run(port, sup=_sup(checkpoint_dir=ck), _chunk_hook=_kill_at(10))
    out, rep = _run(port, sup=_sup(checkpoint_dir=ck))
    assert rep.resumed_tick == 10
    assert rep.ticks_run == 3          # only the missing window re-ran
    _assert_equal(want, out)


def test_max_chunks_window_then_resume(plain, tmp_path):
    """A window of two chunks stops cleanly with a checkpoint; the same
    (key, n_ticks) resumed finishes equal to the single run."""
    _, port, want = plain
    ck = str(tmp_path / "ck")
    mid, rep = _run(port, sup=_sup(checkpoint_dir=ck, max_chunks=2))
    assert rep.ticks_run == 10 and int(mid.tick) == 10
    assert [e for e in rep.events if e["event"] == "window_end"]
    assert [t for _, t in list_checkpoints(ck)] == [5, 10]
    out, rep = _run(port, sup=_sup(checkpoint_dir=ck))
    assert rep.resumed_tick == 10 and rep.ticks_run == 3
    _assert_equal(want, out)


def test_resume_ignores_foreign_config_checkpoint(plain, tmp_path):
    _, (cfg, tp, st, key), want = plain
    ck = str(tmp_path / "ck")
    os.makedirs(ck)
    other = dataclasses.replace(cfg, publishers_per_tick=3)
    mid = engine.run(st, other, tp, key, 5, device="cpu")
    checkpoint.save(os.path.join(ck, "ckpt_t000000005"), mid, cfg=other)
    out, rep = _run((cfg, tp, st, key), sup=_sup(checkpoint_dir=ck))
    assert rep.resumed_from is None
    assert any(e["event"] == "resume_skip" for e in rep.events)
    _assert_equal(want, out)


def test_falls_back_past_torn_checkpoint(plain, tmp_path):
    _, port, want = plain
    ck = str(tmp_path / "ck")
    with pytest.raises(KeyboardInterrupt):
        _run(port, sup=_sup(checkpoint_dir=ck), _chunk_hook=_kill_at(10))
    newest = os.path.join(ck, "ckpt_t000000010.npz")
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 2)
    out, rep = _run(port, sup=_sup(checkpoint_dir=ck))
    assert rep.resumed_tick == 5, rep.events
    assert any(e["event"] == "resume_skip" for e in rep.events)
    _assert_equal(want, out)


def test_checkpoints_pruned_to_the_newest(plain, tmp_path):
    _, port, _ = plain
    ck = str(tmp_path / "ck")
    _, rep = _run(port, sup=_sup(checkpoint_dir=ck, chunk_ticks=3,
                                 keep_checkpoints=2))
    assert len(rep.checkpoints) == 5
    assert [t for _, t in list_checkpoints(ck)] == [12, 13]
    assert not [f for f in os.listdir(ck) if ".tmp" in f]


# --- watchdog and ladder ------------------------------------------------------

def test_deadline_trip_backoff_degrade_then_parity(plain):
    _, port, want = plain
    delays = []

    def slow_once(info):
        if info["chunk_start"] == 0 and info["attempt"] == 0:
            time.sleep(2.5)

    # the watchdog stands at ten times a chunk's time on one idle core, so
    # that only the hook's sleep overruns it when other processes share
    # the cores
    out, rep = _run(port, sup=_sup(deadline_s=1.5, sleep=delays.append,
                                   backoff_base_s=0.25),
                    _chunk_hook=slow_once)
    assert rep.retries == 1
    assert delays == [0.25]
    assert [e["event"] for e in rep.events][:3] == \
        ["chunk_failed", "degrade", "backoff"]
    assert rep.events[0]["kind"] == "deadline"
    _assert_equal(want, out)


def test_mode_fallback_rung_first(plain):
    _, (cfg, tp, st, key), _ = plain
    mcfg = dataclasses.replace(cfg, edge_gather_mode="sort")
    ref = engine.run(st, mcfg, tp, key, N_TICKS, device="cpu")
    fails = iter([True, False])

    def flaky(info):
        if next(fails, False):
            raise RuntimeError("transient")

    out, rep = _run((mcfg, tp, st, key), _chunk_hook=flaky)
    deg = [e for e in rep.events if e["event"] == "degrade"]
    assert deg and deg[0].get("edge_gather_mode") == "scalar"
    assert rep.degrade_level == 1
    _assert_equal(state_to_numpy(ref), out)


def test_card_ladder_skips_the_mode_rung(plain):
    """On the card (``modes=False``) a retry never steps to the
    conservative formulations, which route around the hand kernels: the
    first rung halves the chunk, and at the floor the ladder is spent."""
    _, (cfg, tp, st, key), _ = plain
    sup, rep = _sup(chunk_ticks=4, min_chunk_ticks=2), SupervisorReport()
    got = _degrade(cfg, 4, sup, rep, modes=False)
    assert got == (cfg, 2) and rep.degrade_level == 1
    assert _degrade(cfg, 2, sup, rep, modes=False) == (cfg, 2)
    assert rep.events == [{"event": "degrade", "chunk_ticks": 2}]
    # the CPU's ladder (and initial_degrade anywhere) takes the mode rung
    cons, ticks = _degrade(cfg, 4, sup, SupervisorReport(), modes=True)
    assert ticks == 4 and (cons.hop_mode, cons.edge_gather_mode,
                           cons.selection_mode) == ("xla", "scalar", "sort")


def test_unknown_mode_degrades_instead_of_deadending(plain):
    _, (cfg, tp, st, key), want = plain
    bogus = dataclasses.replace(cfg, hop_mode="blocked-onehot-v2")
    out, rep = _run((bogus, tp, st, key))
    deg = [e for e in rep.events if e["event"] == "degrade"]
    assert deg and deg[0] == {"event": "degrade", "hop_mode": "xla",
                              "edge_gather_mode": "scalar",
                              "selection_mode": "sort"}
    _assert_equal(want, out)


def test_backoff_schedule_is_exponential_and_capped(plain):
    _, port, _ = plain
    delays = []
    fails = iter([True, True, True])

    def flaky(info):
        if next(fails, False):
            raise RuntimeError("transient")

    _run(port, sup=_sup(backoff_base_s=1.0, backoff_factor=2.0,
                        backoff_cap_s=3.0, sleep=delays.append,
                        max_retries=4), _chunk_hook=flaky)
    assert delays == [1.0, 2.0, 3.0]        # 4.0 capped to 3.0


def test_initial_degrade_walks_the_ladder_before_the_first_chunk(plain):
    _, port, want = plain
    out, rep = _run(port, sup=_sup(initial_degrade=2))
    assert rep.degrade_level == 2 and rep.retries == 0
    assert [e.get("chunk_ticks") for e in rep.events
            if e["event"] == "degrade"] == [None, 2]
    assert rep.chunks_run == 7
    _assert_equal(want, out)


def test_supervisor_config_from_env(monkeypatch):
    for k, v in {"GRAFT_CHUNK_TICKS": "7", "GRAFT_DEADLINE_S": "2.5",
                 "GRAFT_ASYNC_CHUNKS": "off", "GRAFT_WRITER_QUEUE": "9",
                 "GRAFT_MH_RUNG": "1", "GRAFT_CRASH_DIR": "/x",
                 "GRAFT_VERDICT_POLICY": "abort"}.items():
        monkeypatch.setenv(k, v)
    sup = SupervisorConfig.from_env(keep_checkpoints=5)
    assert (sup.chunk_ticks, sup.deadline_s, sup.async_chunks,
            sup.writer_queue, sup.initial_degrade, sup.crash_dir,
            sup.verdict_policy, sup.keep_checkpoints) == \
        (7, 2.5, False, 9, 1, "/x", "abort", 5)
    assert [f.name for f in dataclasses.fields(SupervisorConfig)] == \
        [f.name for f in dataclasses.fields(jsupervisor.SupervisorConfig)]


# --- crash dumps and replay ---------------------------------------------------

def _boom(info):
    raise RuntimeError("permanent failure")


def test_retries_exhausted_dumps_and_raises(plain, tmp_path):
    _, (cfg, tp, st, key), _ = plain
    with pytest.raises(SupervisorCrash) as ei:
        _run((cfg, tp, st, key), sup=_sup(max_retries=2,
                                          crash_dir=str(tmp_path)),
             _chunk_hook=_boom)
    dump = ei.value.dump_dir
    meta = json.load(open(os.path.join(dump, "crash.json")))
    assert meta["error_type"] == "RuntimeError" and meta["tick_start"] == 0
    assert meta["config_fingerprint"] == checkpoint.config_fingerprint(cfg)
    # the failing window's keys, replay-ready: the third attempt ran the
    # ladder's halved chunk of 2 ticks
    keys = np.asarray(meta["window_key_data"], dtype=np.uint32)
    assert meta["tick_end"] == 2
    np.testing.assert_array_equal(
        keys, rng.split(key, N_TICKS)[:2].numpy().astype(np.uint32))
    back = checkpoint.restore(os.path.join(dump, "last_good"), st, cfg=cfg)
    assert int(back.tick) == 0
    assert ei.value.report.retries == 2


def _poisoned(st):
    return st._replace(halo_overflow=torch.tensor(3, dtype=torch.int32))


def test_invariant_trip_is_unrecoverable_no_retry(plain, tmp_path):
    _, (cfg, tp, st, key), _ = plain
    rcfg = dataclasses.replace(cfg, invariant_mode="raise")
    with pytest.raises(SupervisorCrash) as ei:
        _run((rcfg, tp, _poisoned(st), key),
             sup=_sup(crash_dir=str(tmp_path)))
    assert ei.value.report.retries == 0
    meta = json.load(open(os.path.join(ei.value.dump_dir, "crash.json")))
    assert "invariant violation" in meta["error"]
    assert "halo_overflow" in meta["error"] and meta["tick_start"] == 0


def test_replay_reproduces_clean_and_tripped(plain, tmp_path):
    _, (cfg, tp, st, key), _ = plain
    with pytest.raises(SupervisorCrash) as ei:
        _run((cfg, tp, st, key), sup=_sup(max_retries=1,
                                          crash_dir=str(tmp_path)),
             _chunk_hook=_boom)
    res = replay_crash.replay(ei.value.dump_dir, like=st, cfg=cfg, tp=tp,
                              device="cpu")
    assert res["tripped"] is False and res["fault_flags"] == 0
    assert res["ticks"] == res["tick_end"] - res["tick_start"] == 5
    rcfg = dataclasses.replace(cfg, invariant_mode="raise")
    with pytest.raises(SupervisorCrash) as ei2:
        _run((rcfg, tp, _poisoned(st), key),
             sup=_sup(crash_dir=str(tmp_path / "p")))
    res2 = replay_crash.replay(ei2.value.dump_dir, like=st, cfg=rcfg, tp=tp,
                               device="cpu")
    assert res2["tripped"] is True
    assert "invariant violation" in res2["error"]


def test_replay_refusals_name_their_item(plain, tmp_path, capsys):
    """A stamped name that is not a ``SCENARIOS`` key is refused naming
    the known ones, as the reference's replay refuses it; a dump with no
    stamp asks for ``--scenario``; a drifted config names the
    fingerprint."""
    from scripts.replay_crash import replay as jreplay
    _, (cfg, tp, st, key), _ = plain
    with pytest.raises(SupervisorCrash) as ei:
        _run((cfg, tp, st, key), sup=_sup(max_retries=0,
                                          crash_dir=str(tmp_path),
                                          scenario="single_topic_1k"),
             _chunk_hook=_boom)
    with pytest.raises(SystemExit) as want:
        jreplay(ei.value.dump_dir)
    with pytest.raises(SystemExit, match="unknown scenario") as got:
        replay_crash.replay(ei.value.dump_dir, device="cpu")
    assert str(got.value) == str(want.value)
    assert replay_crash.main([ei.value.dump_dir, "--device", "cpu"]) == 1
    assert "unknown scenario" in json.loads(
        capsys.readouterr().out)["error"]
    assert replay_crash.main([ei.value.dump_dir, "--scenario", "nope"]) == 1
    assert "known" in json.loads(capsys.readouterr().out)
    with pytest.raises(SupervisorCrash) as ei2:
        _run((cfg, tp, st, key), sup=_sup(max_retries=0,
                                          crash_dir=str(tmp_path / "b")),
             _chunk_hook=_boom)
    with pytest.raises(SystemExit, match="no scenario metadata"):
        replay_crash.replay(ei2.value.dump_dir, device="cpu")
    other = dataclasses.replace(cfg, publishers_per_tick=3)
    with pytest.raises(SystemExit, match="fingerprint"):
        replay_crash.replay(ei.value.dump_dir, like=st, cfg=other, tp=tp,
                            device="cpu")


def test_replay_by_scenario_equals_the_reference(tmp_path, capsys):
    """A dump stamped with a ``SCENARIOS`` name and its keyword arguments
    replays from the stamp alone, and from ``--scenario``/``--kwargs``, as
    the reference's replay does; the reference replays the port's dump the
    same way."""
    from scripts.replay_crash import replay as jreplay
    from go_libp2p_pubsub_tpu_torch.sim import scenarios
    kwargs = {"n_peers": 64, "k_slots": 8, "degree": 3}
    cfg, tp, st = scenarios.SCENARIOS["sybil_small"](**kwargs, device="cpu")
    rcfg = dataclasses.replace(cfg, invariant_mode="raise")
    with pytest.raises(SupervisorCrash) as ei:
        supervised_run(st, cfg, tp, rng.PRNGKey(3, device="cpu"), 6,
                       _sup(chunk_ticks=3, max_retries=0,
                            crash_dir=str(tmp_path), scenario="sybil_small",
                            scenario_kwargs=kwargs),
                       device="cpu", _chunk_hook=lambda i: (
                           _boom(i) if i["chunk_start"] >= 3 else None))
    dump = ei.value.dump_dir
    got = replay_crash.replay(dump, invariant_mode="record", device="cpu")
    want = jreplay(dump, invariant_mode="record")
    assert got == want and got["tripped"] is False
    assert (got["tick_start"], got["tick_end"]) == (3, 6)
    assert replay_crash.main([dump, "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out) == jreplay(dump)
    assert replay_crash.main([dump, "--device", "cpu", "--scenario",
                              "sybil_small", "--kwargs",
                              json.dumps(kwargs)]) == 0
    assert json.loads(capsys.readouterr().out)["ticks"] == 3
    assert rcfg.invariant_mode == "raise"


class _Sink:
    def __init__(self):
        self.flushed = 0

    def hard_flush(self):
        self.flushed += 1


def test_sinks_hard_flushed_on_failure(plain, tmp_path):
    _, port, _ = plain
    sink = _Sink()
    with pytest.raises(SupervisorCrash):
        _run(port, sup=_sup(max_retries=0, crash_dir=str(tmp_path),
                            sinks=(sink,)), _chunk_hook=_boom)
    assert sink.flushed == 1


class _Recorder:
    """A chaos object that records the ticks its verdict drill would fire
    at, instead of killing the process."""

    def __init__(self):
        self.ticks = []

    def fire_verdict(self, tick):
        self.ticks.append(int(tick))


def _mp_hook(pkg, hook, plain, d):
    """One single-process supervised run of ``pkg`` with the multi-process
    hook ``hook``: (final state as arrays, the hook's record)."""
    from go_libp2p_pubsub_tpu.parallel import resilience as jres
    from go_libp2p_pubsub_tpu.sim import adversary as jadversary
    from go_libp2p_pubsub_tpu.sim import engine as jengine
    from go_libp2p_pubsub_tpu_torch.parallel import resilience
    from go_libp2p_pubsub_tpu_torch.sim import SimState, adversary, supervisor
    ref = pkg == "reference"
    adv = jadversary if ref else adversary
    (jcfg, jtp, jst, jkey), (cfg, tp, st, key), _ = plain
    sv = jsupervisor if ref else supervisor
    res = jres if ref else resilience
    args = (jst, jcfg, jtp, jkey) if ref else (st, cfg, tp, key)
    extra = {} if ref else {"device": "cpu"}
    kw = dict(chunk_ticks=5, backoff_base_s=0.0, sleep=lambda s: None)
    record = None
    if hook == "run_fn":
        calls = []

        def run_fn(s, c, t, keys):
            calls.append(int(keys.shape[0]))
            return jengine.run_keys(s, c, t, keys) if ref else \
                engine.run_keys(s, c, t, keys, device="cpu")
        kw["run_fn"], record = run_fn, calls
    elif hook == "state_to_host":
        kw["checkpoint_dir"] = str(d / "ck")
        kw["state_to_host"] = (lambda s: jax.tree.map(np.asarray, s)) if ref \
            else (lambda s: SimState(*(x.cpu() for x in s)))
    elif hook == "state_from_host":
        kw["checkpoint_dir"] = str(d / "ck")
        sv.supervised_run(*args, N_TICKS, sv.SupervisorConfig(
            max_chunks=1, **kw), **extra)
        kw["state_from_host"] = lambda s: s
    elif hook == "liveness":
        kw["liveness"] = res.RankLiveness(str(d), 0, 1)
    elif hook == "chaos":
        kw["chaos"] = record = _Recorder()
        kw["health_path"] = str(d / "h.ndjson")
        kw["contracts"] = adv.contracts_from_json(CONTRACTS)
    out, rep = sv.supervised_run(*args, N_TICKS, sv.SupervisorConfig(**kw),
                                 **extra)
    if hook == "state_to_host":
        record = [os.path.basename(p) for p in rep.checkpoints]
    elif hook == "state_from_host":
        record = (rep.resumed_tick, rep.chunks_run)
    elif hook == "chaos":
        record = record.ticks
    elif hook == "liveness":
        with open(res.heartbeat_path(str(d), 0)) as f:
            hb = json.load(f)
        record = (hb["tick"], hb["chunk"])
    return (_arrays(out) if ref else state_to_numpy(out)), record


@pytest.mark.parametrize("hook", ["run_fn", "state_to_host",
                                  "state_from_host", "liveness", "chaos"])
def test_multiprocess_hooks_match_the_reference(plain, hook, tmp_path):
    """Each multi-process hook in one process, against the reference's
    supervised run with the same hook: the final state equals the
    uninterrupted run, and the hook's trace (the runner's chunk sizes,
    the checkpoints the gathered copies wrote, the resume point, the
    heartbeat's last stamp, the verdict drill's ticks) is the
    reference's."""
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want, rec_ref = _mp_hook("reference", hook, plain, tmp_path / "ref")
    got, rec = _mp_hook("port", hook, plain, tmp_path / "port")
    for f, a in want.items():
        np.testing.assert_array_equal(got[f], a, err_msg=f"{f} ({hook})")
    assert rec == rec_ref
    if hook == "chaos":
        assert rec, "no verdict transition reached the drill"


# --- the lifted hooks against the reference -----------------------------------

# contracts on the 13-tick run whose verdicts move: a floor that fails, a
# recovery that passes, a response that stays pending until tick 5 fails it
CONTRACTS = ({"kind": "delivery_floor", "floor": 0.99, "start": 1},
             {"kind": "recovery_ceiling", "after": 3, "within": 4,
              "floor": 0.5},
             {"kind": "score_response", "by": 5, "attacker_frac": 0.5})

HOOKS = {
    "commands": dict(commands=True),
    "contracts": dict(contracts=True),
    "verdict_policy snapshot": dict(contracts=True, verdict_policy="snapshot",
                                    checkpoint_dir=True),
    "verdict_policy abort": dict(contracts=True, verdict_policy="abort",
                                 checkpoint_dir=True),
    "traced": dict(traced=True),
}
LIFTED_STREAM = [
    {"op": "publish", "tick": 1, "peer": 3, "topic": 0},
    {"op": "join", "tick": 4, "peer": 7, "topic": 0},
    {"op": "attack", "tick": 6, "kind": "eclipse", "peers": [0, 1, 2]},
    {"op": "attack", "tick": 7, "kind": "censor", "peers": [20, 21]},
    {"op": "bogus", "tick": 8},
    {"op": "leave", "tick": 10, "peer": 7, "topic": 0},
]


def _lifted(pkg, hook, cfg, tp, st, key, d):
    """One supervised run of ``pkg`` (the reference's modules, or the
    port's) with ``hook``: its final state (or None after an abort), the
    raised VerdictAbort's message, the report, the journal, the traced
    lane's events and rows."""
    from go_libp2p_pubsub_tpu.sim import adversary as jadversary
    from go_libp2p_pubsub_tpu.sim import commands as jcommands
    from go_libp2p_pubsub_tpu_torch.sim import adversary, commands
    from go_libp2p_pubsub_tpu_torch.sim import supervisor
    ref = pkg == "reference"
    adv, cmds = (jadversary, jcommands) if ref else (adversary, commands)
    sv = jsupervisor if ref else supervisor
    kw = dict(chunk_ticks=5, backoff_base_s=0.0, sleep=lambda s: None,
              health_path=str(d / "h.ndjson"))
    traced = hook.get("traced", False)
    q = None
    if hook.get("commands"):
        src = str(d.parent / "stream.ndjson")
        cmds.write_stream(src, LIFTED_STREAM)
        q = cmds.CommandQueue(src, n_peers=cfg.n_peers, n_topics=1,
                              msg_window=cfg.msg_window, slots=4,
                              stall_timeout_s=30.0)
        kw["commands"] = q
    if hook.get("contracts"):
        kw["contracts"] = adv.contracts_from_json(CONTRACTS)
        kw["verdict_policy"] = hook.get("verdict_policy", "journal")
    if hook.get("checkpoint_dir"):
        kw["checkpoint_dir"] = str(d / "ck")
    events, rows = [], []
    out = abort = None
    extra = {} if ref else {"device": "cpu"}
    try:
        out, rep = sv.supervised_run(
            st, cfg, tp, key, N_TICKS, sv.SupervisorConfig(**kw),
            traced=traced, events_out=events, health_out=rows, **extra)
    except sv.VerdictAbort as e:
        abort, rep = str(e), e.report
    finally:
        if q is not None:
            q.close()
    j = telemetry.read_journal(str(d / "h.ndjson"))
    return out, abort, rep, j, events, rows


def _strip(notes):
    """Notes without their wall clocks, paths by base name."""
    return [{k: (os.path.basename(v) if k == "path" else v)
             for k, v in n.items() if k not in ("wall", "done_wall")}
            for n in notes]


@pytest.mark.parametrize("name", list(HOOKS))
def test_lifted_hooks_equal_the_reference(plain, tmp_path, name):
    """``commands``, ``contracts`` under each verdict policy, and
    ``traced=True``, each against the reference's ``supervised_run`` of
    the same input: final state, journal rows and every journal note
    (verdicts, alarms, ingest, checkpoints), the checkpoints' ticks, the
    verdict events of the report, the traced lane's events and rows."""
    (jcfg, jtp, jst, jkey), (cfg, tp, st, key), _ = plain
    hook = HOOKS[name]
    if hook.get("traced"):
        jcfg = dataclasses.replace(jcfg, record_provenance=True)
        cfg = dataclasses.replace(cfg, record_provenance=True)
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    mp = pytest.MonkeyPatch()
    mp.setattr(jckpt, "_HAVE_ORBAX", False)
    try:
        want = _lifted("reference", hook, jcfg, jtp, jst, jkey,
                       tmp_path / "ref")
    finally:
        mp.undo()
    got = _lifted("port", hook, cfg, tp, st, key, tmp_path / "port")
    (w_out, w_abort, w_rep, w_j, w_ev, w_rows) = want
    (g_out, g_abort, g_rep, g_j, g_ev, g_rows) = got
    assert g_abort == w_abort
    if w_out is not None:
        _assert_equal(_arrays(w_out), g_out, name)
    _assert_rows_equal(w_j["rows"], g_j["rows"])
    assert _strip(g_j["notes"]) == _strip(w_j["notes"])
    assert [os.path.basename(p) for p in g_rep.checkpoints] == \
        [os.path.basename(p) for p in w_rep.checkpoints]
    verdicts = [e for e in g_rep.events if e["event"] == "contract_verdict"]
    assert verdicts == [e for e in w_rep.events
                        if e["event"] == "contract_verdict"]
    assert g_ev == w_ev
    _assert_rows_equal(w_rows, g_rows) if w_rows else None
    assert len(g_rows) == len(w_rows)
    if hook.get("contracts"):
        assert verdicts and any(e["status"] == "fail" for e in verdicts)
        # the reference's dashboard reads the port's journal as its own
        from scripts.dashboard import render, snapshot
        port_snap = snapshot(str(tmp_path / "port" / "h.ndjson"))
        ref_snap = snapshot(str(tmp_path / "ref" / "h.ndjson"))
        assert port_snap["contracts"] == ref_snap["contracts"]
        assert port_snap.get("verdict_abort") == ref_snap.get(
            "verdict_abort")
        assert "delivery_floor" in render(port_snap)
        # and the port's dashboard reads both journals as the reference's
        from go_libp2p_pubsub_tpu_torch import dashboard
        ported = {who: dashboard.snapshot(str(tmp_path / who / "h.ndjson"))
                  for who in ("port", "ref")}
        assert ported["port"]["contracts"] == ported["ref"]["contracts"]
        assert ported["port"].get("verdict_abort") == ported["ref"].get(
            "verdict_abort")
        assert "delivery_floor" in dashboard.render(ported["port"])
        assert ported["port"] == port_snap and ported["ref"] == ref_snap
        assert dashboard.render(ported["port"]) == render(port_snap)
    if hook.get("verdict_policy") == "abort":
        assert "verdict_policy='abort'" in g_abort
    if hook.get("commands"):
        assert any(n["kind"] == "directive_refused" for n in g_j["notes"])
    if hook.get("traced"):
        assert g_ev and len(g_rows) == N_TICKS


def test_contract_checks_refuse_by_name(plain):
    from go_libp2p_pubsub_tpu_torch.sim.adversary import contracts_from_json
    _, port, _ = plain
    cs = contracts_from_json(CONTRACTS[:1])
    with pytest.raises(ValueError, match="verdict_policy 'loud' unknown"):
        _run(port, sup=_sup(contracts=cs, verdict_policy="loud",
                            health_path="/dev/null"))
    with pytest.raises(ValueError, match="telemetry lane"):
        _run(port, sup=_sup(contracts=cs))


def test_run_refuses_the_cpu_without_device(plain):
    _, (cfg, tp, st, key), _ = plain
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is the default device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        supervised_run(st, cfg, tp, key, 2, _sup())


# --- the health journal against the reference -------------------------------

def _journal_rows(path):
    return telemetry.read_journal(path)["rows"]


def _assert_rows_equal(want, got):
    assert len(want) == len(got) > 0
    for a, b in zip(want, got):
        assert set(a) == set(b)
        for k in a:
            if k == "score_mean":
                np.testing.assert_allclose(b[k], a[k], rtol=1e-5)
            else:
                assert a[k] == b[k], (k, a[k], b[k], a["tick"])


@pytest.fixture(scope="module")
def reference_runs(plain, tmp_path_factory):
    """The reference's supervised runs with the telemetry lane (its
    ``.npz`` checkpoint form): a whole run's journal, a two-chunk window's
    checkpoint directory, and a crash dump."""
    (jcfg, jtp, jst, jkey), _, _ = plain
    d = tmp_path_factory.mktemp("reference")
    mp = pytest.MonkeyPatch()
    mp.setattr(jckpt, "_HAVE_ORBAX", False)
    try:
        sup = jsupervisor.SupervisorConfig(
            chunk_ticks=5, backoff_base_s=0.0, sleep=lambda s: None,
            health_path=str(d / "whole.ndjson"))
        jsupervisor.supervised_run(jst, jcfg, jtp, jkey, N_TICKS, sup)
        jsupervisor.supervised_run(
            jst, jcfg, jtp, jkey, N_TICKS, dataclasses.replace(
                sup, health_path=str(d / "window.ndjson"),
                checkpoint_dir=str(d / "ck"), max_chunks=2))
        with pytest.raises(jsupervisor.SupervisorCrash) as ei:
            jsupervisor.supervised_run(
                jst, jcfg, jtp, jkey, N_TICKS, dataclasses.replace(
                    sup, health_path=str(d / "crash.ndjson"), max_retries=0,
                    crash_dir=str(d / "crash")), _chunk_hook=_boom)
    finally:
        mp.undo()
    return d, ei.value.dump_dir


@pytest.mark.parametrize("async_chunks", [True, False])
def test_health_journal_rows_equal_the_reference(plain, reference_runs,
                                                 tmp_path, async_chunks):
    _, port, want = plain
    d, _ = reference_runs
    path = str(tmp_path / "h.ndjson")
    out, _ = _run(port, sup=_sup(health_path=path,
                                 async_chunks=async_chunks))
    _assert_equal(want, out)
    _assert_rows_equal(_journal_rows(str(d / "whole.ndjson")),
                       _journal_rows(path))
    j = telemetry.read_journal(path)
    assert j["runs"][0]["fingerprint"] == \
        telemetry.read_journal(str(d / "whole.ndjson"))["runs"][0][
            "fingerprint"]
    assert [n["kind"] for n in j["notes"]][-1] == "run_end"
    assert len(j["chunks"]) == 3


def test_reference_window_resumes_in_the_port(plain, reference_runs,
                                              tmp_path):
    """A reference run stopped by ``max_chunks`` resumes in the port from
    its checkpoint directory, appending to its journal, and ends equal to
    the reference's uninterrupted run, every journal row included."""
    _, port, want = plain
    d, _ = reference_runs
    journal = str(tmp_path / "window.ndjson")
    with open(d / "window.ndjson", "rb") as src, open(journal, "wb") as dst:
        dst.write(src.read())
    out, rep = _run(port, sup=_sup(checkpoint_dir=str(d / "ck"),
                                   health_path=journal))
    assert rep.resumed_tick == 10 and rep.ticks_run == 3
    _assert_equal(want, out)
    _assert_rows_equal(_journal_rows(str(d / "whole.ndjson")),
                       _journal_rows(journal))


def test_reference_crash_dump_replays_in_the_port(plain, reference_runs):
    _, (cfg, tp, st, key), _ = plain
    _, dump = reference_runs
    res = replay_crash.replay(dump, like=st, cfg=cfg, tp=tp, device="cpu")
    assert res["tripped"] is False and res["fault_flags"] == 0
    assert (res["tick_start"], res["tick_end"], res["ticks"]) == (0, 5, 5)


def test_port_crash_dump_replays_in_the_reference(plain, tmp_path):
    from scripts.replay_crash import replay as jreplay
    (jcfg, jtp, jst, _), port, _ = plain
    def wedged(info):
        raise ChunkDeadline("wedged")

    with pytest.raises(SupervisorCrash) as ei:
        _run(port, sup=_sup(max_retries=0, crash_dir=str(tmp_path),
                            chunk_ticks=4), _chunk_hook=wedged)
    res = jreplay(ei.value.dump_dir, like=jst, cfg=jcfg, tp=jtp,
                  invariant_mode="record")
    assert res["tripped"] is False and res["fault_flags"] == 0
    assert res["ticks"] == 4
    state = jckpt.restore(os.path.join(ei.value.dump_dir, "last_good"), jst,
                          cfg=jcfg)
    _assert_equal(_arrays(state), port[2])


def test_writer_runs_every_task_in_order_under_backpressure():
    """The writer thread behind a queue of 2, fed 2000 tasks with the
    interpreter switching threads as often as it can: every task runs,
    in order, the flush fires when the queue runs dry, and a failing
    task's error surfaces at the next drain."""
    import sys

    from go_libp2p_pubsub_tpu_torch.sim.supervisor import _Writer
    done, flushes = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        w = _Writer(maxsize=2, flush=lambda: flushes.append(len(done)))
        for i in range(2000):
            w.submit(lambda i=i: done.append(i))
        w.drain()

        def fail():
            raise OSError("disk full")

        w.submit(fail)
        with pytest.raises(OSError, match="disk full"):
            w.drain()
        w.close()
    finally:
        sys.setswitchinterval(old)
    assert done == list(range(2000))
    assert flushes and flushes[-1] == 2000
    assert w._thread is None


def test_retry_on_a_consumed_donated_input_replays_from_the_anchor(
        plain, monkeypatch):
    """On the card a donated chunk's result is its graph's static state,
    which the executable's next call overwrites. Here every donated
    result is stamped so (as a CUDA executable stamps it), and the third
    donated call fails after consuming its input: the retry finds the
    carry overwritten, replays the confirmed gap from the anchor with the
    same keys (a ``catchup``) and ends equal to the single run."""
    from go_libp2p_pubsub_tpu_torch.parallel import compile_plan
    _, port, want = plain
    exe_cls = compile_plan.EngineExecutable
    monkeypatch.setattr(exe_cls, "stamp", lambda self: (
        (self, self.calls) if self.donate else None))
    real = exe_cls.__call__

    def call(self, state, tp, keys):
        out = real(self, state, tp, keys)
        if self.donate and self.calls == 3:
            raise RuntimeError("the replay failed after consuming its input")
        return out

    monkeypatch.setattr(exe_cls, "__call__", call)
    compile_plan.clear_caches()
    try:
        out, rep = _run(port, sup=_sup(chunk_ticks=3,
                                       checkpoint_every_ticks=N_TICKS))
    finally:
        compile_plan.clear_caches()
    events = [e["event"] for e in rep.events]
    assert rep.retries == 1 and "catchup" in events, events
    catchup = next(e for e in rep.events if e["event"] == "catchup")
    assert (catchup["chunk_start"], catchup["chunk_ticks"]) == (0, 9)
    _assert_equal(want, out)


def test_donated_results_are_stamped_and_retired(plain):
    """``compile_plan.live`` tells a stamped result held until its
    executable's next call; ``retire`` drops the executable and marks its
    results stale."""
    from go_libp2p_pubsub_tpu_torch.parallel import compile_plan
    _, (cfg, tp, st, key), _ = plain
    keys = rng.split(key, 2)
    compile_plan.clear_caches()
    try:
        exe = compile_plan.engine_chunk(cfg, st, tp, keys, donate=True)
        assert exe.stamp() is None          # the CPU: results own tensors
        stamp = (exe, exe.calls)
        assert compile_plan.live(stamp) and compile_plan.live(None)
        exe(st, tp, keys)
        assert not compile_plan.live(stamp)
        stamp = (exe, exe.calls)
        compile_plan.retire(exe)
        assert not compile_plan.live(stamp)
        assert compile_plan.engine_chunk(cfg, st, tp, keys,
                                         donate=True) is not exe
    finally:
        compile_plan.clear_caches()
