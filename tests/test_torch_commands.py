"""Parity of the port's live command plane (go_libp2p_pubsub_tpu_torch/sim/
commands.py) with the JAX package's on the CPU.

- the directive parser: every accepted line parses to the reference's ops,
  and every refused line raises ``DirectiveError`` with the reference's
  text, word for word;
- ``CommandQueue``: the boundary drain by tick, the frame cache, shedding,
  coast mode and its markers, the exactly-once byte offset: the port's
  frames equal the reference queue's on the same stream file;
- ``apply_frame`` with and without attack lanes (storm, eclipse, censor)
  against the reference's on the same 128-peer state, every field exact,
  the input state unchanged;
- a supervised run fed the stream (128 peers, chunks of 3, 12 ticks)
  against the reference's ``supervised_run`` on the same stream: final
  state, journal rows and ingest notes equal; a kill after tick 9 and a
  resume from the sidecar's ``stream_offset`` equal to the uninterrupted
  run; ``BroadcastCommands`` and ``chaos`` refused by name (ROADMAP item
  7).
"""

import dataclasses
import importlib
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.sim import commands as jcmds
from go_libp2p_pubsub_tpu.sim import scenarios as jscenarios
from go_libp2p_pubsub_tpu.sim import supervisor as jsupervisor
from go_libp2p_pubsub_tpu.sim.engine import run as jrun
from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.sim import (SimConfig, TopicParams, checkpoint,
                                            commands, state_from_reference,
                                            state_to_numpy, telemetry)
from go_libp2p_pubsub_tpu_torch.sim.supervisor import (SupervisorConfig,
                                                       supervised_run)

from test_commands import DIRECTIVES, STREAM


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
    got = state_to_numpy(got)
    for f, a in want.items():
        assert got[f].dtype == a.dtype, (f, got[f].dtype, a.dtype, where)
        np.testing.assert_array_equal(got[f], a, err_msg=f"{f} {where}")


# --- the parser -----------------------------------------------------------

PARSER_CASES = [
    '{"op":"publish","tick":3,"peer":5,"topic":1}',
    '{"op":"join","peer":0,"topic":0}',
    '{"op":"leave","tick":0,"peer":63,"topic":1}',
    '{"op":"attack","tick":2,"kind":"storm","topic":1,"peers":[1,2,3]}',
    '{"op":"attack","tick":2,"kind":"eclipse","peers":[4,5]}',
    '{"op":"attack","kind":"censor","peers":[9]}',
    json.dumps({"op": "compose", "tick": 4, "parts": [
        {"op": "attack", "kind": "eclipse", "peers": [0, 1]},
        {"op": "attack", "kind": "censor", "peers": [2]},
        {"op": "publish", "peer": 3, "topic": 1},
        {"op": "join", "peer": 4, "topic": 0}]}),
    '{"op":"tick","tick":9}', '{"op":"end"}', "", "   ",
    '{"type":"JOIN","peerID":"5","timestamp":2.5,"join":{"topic":"1"}}',
    '{"type":"GRAFT","peerID":"5","timestamp":1.0}',
    '{"type":"PUBLISH_MESSAGE","peerID":"3","timestamp":7.9,'
    '"publishMessage":{"topic":"0","messageID":"m"}}',
    # refusals (tests/test_commands.py's, and the trace-event ones)
    "not json at all", '{"op":"publish","peer":5}', '{"op":"frobnicate"}',
    "[1, 2, 3]", '{"op":"publish","peer":-1,"topic":0}',
    '{"op":"publish","peer":64,"topic":0}',
    '{"op":"publish","peer":0,"topic":2}',
    '{"op":"publish","peer":"x","topic":0}',
    '{"op":"publish","peer":true,"topic":0}',
    '{"op":"join","peer":0,"topic":0,"tick":-7}',
    '{"op":"attack","kind":"surge","topic":0,"peers":[1]}',
    '{"op":"attack","kind":"storm","topic":0,"peers":[]}',
    '{"op":"attack","kind":"storm","topic":0,"peers":[999]}',
    '{"op":"tick"}',
    '{"op":"attack","kind":"eclipse","topic":0,"peers":[1]}',
    '{"op":"attack","kind":"censor","peers":[true]}',
    '{"op":"compose","tick":1,"parts":[]}',
    '{"op":"compose","tick":1,"parts":[7]}',
    '{"op":"compose","tick":1,"parts":[{"op":"publish","tick":2,'
    '"peer":1,"topic":0}]}',
    '{"op":"compose","tick":1,"parts":[{"op":"compose","parts":[]}]}',
    '{"op":"compose","tick":1,"parts":[{"op":"end"}]}',
    '{"type":7}', '{"type":"JOIN","peerID":"5","timestamp":"x",'
    '"join":{"topic":"0"}}',
    '{"type":"JOIN","peerID":"q","join":{"topic":"0"}}',
    '{"type":"LEAVE","peerID":"99","leave":{"topic":"0"}}',
    '{"type":"LEAVE","peerID":"1","leave":{"topic":"5"}}',
    b"\xff\xfe",
    json.dumps({"op": "attack", "kind": "storm", "topic": 0,
                "peers": list(range(20))}),
]


def _parse_both(line, **kw):
    out = []
    for mod in (jcmds, commands):
        try:
            out.append(("ok", mod.parse_line(line, **kw)))
        except mod.DirectiveError as e:
            out.append(("refused", str(e)))
    return out


@pytest.mark.parametrize("i", range(len(PARSER_CASES)))
def test_parser_matches_the_reference(i):
    want, got = _parse_both(PARSER_CASES[i], n_peers=64, n_topics=2,
                            max_batch=10)
    assert got[0] == want[0]
    if got[0] == "ok":
        assert tuple(got[1]) == tuple(want[1])
    else:
        assert got[1] == want[1], (got[1], want[1])


def test_parser_index_maps_and_fuzz_match_the_reference():
    kw = dict(n_peers=64, n_topics=2, peer_index={"alice": 3},
              topic_index={"blocks": 1}, heartbeat_interval=0.5)
    for line in ('{"type":"JOIN","peerID":"alice","timestamp":3.0,'
                 '"join":{"topic":"blocks"}}',
                 '{"type":"JOIN","peerID":"bob","join":{"topic":"blocks"}}',
                 '{"type":"JOIN","peerID":"alice","join":{"topic":"x"}}'):
        want, got = _parse_both(line, **kw)
        assert got == want
    rs = np.random.default_rng(314159)
    alphabet = list('{}[]",:0123456789abcdefopt\\ ')
    for _ in range(300):
        line = "".join(rs.choice(alphabet, rs.integers(0, 40)))
        want, got = _parse_both(line, n_peers=64, n_topics=2)
        assert got == want, line


def test_op_codes_mirror_the_port_replay():
    rp = importlib.import_module("go_libp2p_pubsub_tpu_torch.trace.replay")
    for name in ("OP_NOP", "OP_JOIN", "OP_LEAVE", "OP_PUBLISH"):
        assert getattr(commands, name) == getattr(rp, name) == \
            getattr(jcmds, name)
    assert commands.ATTACK_OP_BASE == jcmds.ATTACK_OP_BASE >= rp.N_OPS
    assert (commands.OP_ECLIPSE, commands.OP_CENSOR) == \
        (jcmds.OP_ECLIPSE, jcmds.OP_CENSOR)


# --- the queue -------------------------------------------------------------

def _mkq(mod, src, slots=4, stall=2.0, **kw):
    kw.setdefault("n_peers", 64)
    kw.setdefault("n_topics", 2)
    kw.setdefault("msg_window", 32)
    kw.setdefault("coast_poll_s", 0.01)
    return mod.CommandQueue(str(src), slots=slots, stall_timeout_s=stall,
                            **kw)


def _frame_key(f):
    return (f.op.tolist(), f.a.tolist(), f.b.tolist(), f.c.tolist(), f.count,
            f.shed, f.shed_total, f.refused_total, f.applied_total, f.offset,
            f.lag, f.depth, f.coasting,
            [(k, m) for k, m in f.notes])


def _frames(mod, src, bounds, **kw):
    q = _mkq(mod, src, **kw).start(0)
    try:
        return [q.frame_for(s, n) for s, n in bounds]
    finally:
        q.close()


def test_queue_frames_equal_the_reference(tmp_path):
    src = tmp_path / "s.ndjson"
    size = commands.write_stream(str(src), STREAM)
    assert size == os.path.getsize(src)
    bounds = [(0, 5), (5, 5), (10, 5)]
    want = [_frame_key(f) for f in _frames(jcmds, src, bounds)]
    got = [_frame_key(f) for f in _frames(commands, src, bounds)]
    assert got == want
    assert got[0][4] == 2 and got[2][9] == size
    q = _mkq(commands, src).start(0)
    try:
        f0 = q.frame_for(0, 5)
        assert q.frame_for(0, 5) is f0      # a retry's re-fetch
    finally:
        q.close()


def test_queue_sheds_by_stream_position(tmp_path):
    src = tmp_path / "s.ndjson"
    commands.write_stream(str(src), [
        {"op": "publish", "tick": 0, "peer": p, "topic": 0}
        for p in range(10)])
    bounds = [(0, 2), (2, 2)]
    want = [_frame_key(f) for f in _frames(jcmds, src, bounds)]
    got = [_frame_key(f) for f in _frames(commands, src, bounds)]
    assert got == want
    assert got[0][4:6] == (4, 6) and got[0][1] == [0, 1, 2, 3]


def test_queue_offset_is_an_exactly_once_cursor(tmp_path):
    src = tmp_path / "s.ndjson"
    commands.write_stream(str(src), STREAM)
    q = _mkq(commands, src).start(0)
    f0 = q.frame_for(0, 5)
    f1 = q.frame_for(5, 5)
    q.close()
    q2 = _mkq(commands, src).start(f0.offset)
    g1 = q2.frame_for(5, 5)
    q2.close()
    jq = _mkq(jcmds, src).start(f0.offset)
    h1 = jq.frame_for(5, 5)
    jq.close()
    assert _frame_key(g1) == _frame_key(h1)
    # the resumed queue's frame is the uninterrupted one's (its totals
    # count from the resume)
    assert _frame_key(g1)[:6] == _frame_key(f1)[:6]
    assert g1.offset == f1.offset


def test_queue_coasts_through_silence_and_resumes(tmp_path):
    src = tmp_path / "s.ndjson"
    with open(src, "w") as f:
        f.write(json.dumps({"op": "publish", "tick": 1, "peer": 1,
                            "topic": 0}) + "\n")
    q = _mkq(commands, src, stall=0.3).start(0)
    try:
        f0 = q.frame_for(0, 2)
        assert f0.coasting and f0.count == 1
        assert [k for k, _m in f0.notes] == ["ingest_stalled"]
        meta = dict(f0.notes)["ingest_stalled"]
        assert meta["offset"] == os.path.getsize(src)
        # the reference's command, naming the port's producer
        assert meta["resume_cmd"] == _mkq(jcmds, src).resume_cmd(
            meta["offset"]).replace(
                "python scripts/directive_producer.py",
                "python -m go_libp2p_pubsub_tpu_torch.directive_producer")
        assert meta["resume_cmd"].startswith(
            "python -m go_libp2p_pubsub_tpu_torch.directive_producer ")
        f1 = q.frame_for(2, 2)
        assert f1.coasting and not f1.notes
        with open(src, "a") as fh:
            fh.write(json.dumps({"op": "publish", "tick": 5, "peer": 2,
                                 "topic": 0}) + "\n")
            fh.write(json.dumps({"op": "end"}) + "\n")
        deadline = time.monotonic() + 5.0
        while not q._eof and time.monotonic() < deadline:
            time.sleep(0.02)
        f2 = q.frame_for(4, 2)
        assert not f2.coasting and f2.count == 1
        assert "ingest_resumed" in [k for k, _m in f2.notes]
    finally:
        q.close()


def _drain_frames(mod, q, starts):
    frames = []
    try:
        q.start(0)
        for t0 in starts:
            frames.append(_frame_key(q.frame_for(t0, 2)))
    finally:
        q.close()
    return frames


@pytest.mark.parametrize("spec", ["ingest_kill@2", "ingest_stall@2:0.2"])
def test_chaos_drills_match_the_reference(tmp_path, spec):
    """CommandQueue(chaos=ChaosPlan(...)): the reader killed or paused at
    a boundary, frame for frame as the reference's queue under the same
    plan (each package with its own marker directory)."""
    from go_libp2p_pubsub_tpu.parallel import resilience as jres
    from go_libp2p_pubsub_tpu_torch.parallel import resilience
    src = tmp_path / "s.ndjson"
    commands.write_stream(str(src), STREAM)
    got = {}
    for name, mod, res in (("ref", jcmds, jres),
                           ("port", commands, resilience)):
        d = tmp_path / name
        d.mkdir()
        plan = res.ChaosPlan(res.ChaosPlan.parse(spec), 0, str(d))
        got[name] = _drain_frames(mod, _mkq(mod, src, chaos=plan),
                                  [0, 2, 4, 6])
        assert os.listdir(d), name      # the drill's marker landed
    assert got["port"] == got["ref"]


def test_broadcast_frames_match_the_reference(tmp_path):
    """BroadcastCommands in a one-process group (gloo, a file rendezvous):
    rank 0's frames after the broadcast, and a cached refetch, as the
    reference's wrapper hands them out."""
    import torch.distributed as dist
    src = tmp_path / "s.ndjson"
    commands.write_stream(str(src), STREAM)
    want = _drain_frames(jcmds, jcmds.BroadcastCommands(
        _mkq(jcmds, src), slots=4), [0, 2, 4])
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        bc = commands.BroadcastCommands(_mkq(commands, src), slots=4)
        got = _drain_frames(commands, bc, [0, 2, 4])
        assert _frame_key(bc.frame_for(2, 2)) == got[1]     # the cache
    finally:
        dist.destroy_process_group()
    assert got == want


# --- apply_frame -------------------------------------------------------------

N, SLOTS = 128, 8


@pytest.fixture(scope="module")
def small():
    """single_topic_1k at 128 peers after three ticks, in both packages
    (with eight sybils, so the eclipse cut keeps attacker links)."""
    jcfg, jtp, jst = jscenarios.single_topic_1k(n_peers=N, k_slots=16,
                                                degree=6)
    mal = np.zeros(N, bool)
    mal[100:108] = True
    jst = jst._replace(malicious=jax.numpy.asarray(mal))
    jmid = jrun(jst, jcfg, jtp, jax.random.PRNGKey(1), 3)
    cfg = SimConfig(**dataclasses.asdict(jcfg))
    tp = TopicParams(*[torch.from_numpy(np.array(x)) for x in jtp])
    st = state_from_reference(_arrays(jst), device="cpu")
    mid = state_from_reference(_arrays(jmid), device="cpu")
    return (jcfg, jtp, jst, jmid), (cfg, tp, st, mid)


def _frame(mod, prims, start=0):
    op = np.zeros(SLOTS, np.int32)
    a, b, c = (np.zeros(SLOTS, np.int32) for _ in range(3))
    codes = {"publish": mod.OP_PUBLISH, "join": mod.OP_JOIN,
             "leave": mod.OP_LEAVE, "eclipse": mod.OP_ECLIPSE,
             "censor": mod.OP_CENSOR}
    for i, (kind, peer, topic) in enumerate(prims):
        op[i], a[i], c[i] = codes[kind], peer, topic
        b[i] = (start * SLOTS + i) % 64 if kind == "publish" else -1
    return mod.empty_frame(SLOTS)._replace(op=op, a=a, b=b, c=c,
                                           count=len(prims))


@pytest.mark.parametrize("prims", [
    [("publish", 3, 0), ("join", 7, 0), ("leave", 9, 0),
     ("publish", 10, 0)],
    [("eclipse", 0, 0), ("eclipse", 1, 0), ("eclipse", 2, 0),
     ("censor", 40, 0), ("censor", 41, 0), ("publish", 5, 0)],
    [("censor", 60, 0)],
], ids=["plain lanes", "attack lanes", "censor only"])
def test_apply_frame_matches_the_reference(small, prims):
    (jcfg, jtp, _, jmid), (cfg, tp, _, mid) = small
    want = _arrays(jcmds.apply_frame(jmid, jcfg, jtp, _frame(jcmds, prims)))
    before = state_to_numpy(mid)
    got = commands.apply_frame(mid, cfg, tp, _frame(commands, prims))
    _assert_equal(want, got, str(prims))
    _assert_equal(before, mid, "the input state was written")


# --- a supervised run fed the stream ----------------------------------------

CHUNK, TICKS = 3, 12


def _queue(mod, cfg, src, **kw):
    kw.setdefault("stall_timeout_s", 30.0)
    return mod.CommandQueue(str(src), n_peers=cfg.n_peers,
                            n_topics=cfg.n_topics, msg_window=cfg.msg_window,
                            slots=SLOTS, **kw)


def _notes(path, drop=("wall", "done_wall")):
    j = telemetry.read_journal(path)
    notes = [{k: v for k, v in n.items() if k not in drop}
             for n in j["notes"]]
    return notes, [{k: v for k, v in r.items() if k != "kind"}
                   for r in j["rows"]]


def _rows_equal(got, want):
    assert len(got) == len(want)
    for r, w in zip(got, want):
        assert r.keys() == w.keys()
        for k in r:
            if k == "score_mean":
                np.testing.assert_allclose(r[k], w[k], rtol=1e-5)
            else:
                assert r[k] == w[k], (k, r[k], w[k])


STREAM_IN = DIRECTIVES + [
    {"op": "attack", "tick": 5, "kind": "eclipse", "peers": [0, 1, 2, 3]},
    {"op": "attack", "tick": 8, "kind": "censor", "peers": [50, 51]},
    {"op": "frobnicate", "tick": 8},
]


@pytest.fixture(scope="module")
def reference_stream_run(small, tmp_path_factory):
    (jcfg, jtp, jst, _), _ = small
    tmp = tmp_path_factory.mktemp("ref")
    src = tmp / "s.ndjson"
    jcmds.write_stream(str(src), sorted(STREAM_IN, key=lambda d: d["tick"]))
    q = _queue(jcmds, jcfg, src)
    try:
        out, rep = jsupervisor.supervised_run(
            jst, jcfg, jtp, jax.random.PRNGKey(42), TICKS,
            jsupervisor.SupervisorConfig(
                chunk_ticks=CHUNK, commands=q, backoff_base_s=0.0,
                sleep=lambda s: None, health_path=str(tmp / "h.ndjson")))
    finally:
        q.close()
    return src, _arrays(out), rep, _notes(str(tmp / "h.ndjson"))


def test_supervised_stream_run_equals_the_reference(small,
                                                    reference_stream_run,
                                                    tmp_path):
    _, (cfg, tp, st, _) = small
    src, want, jrep, (jnotes, jrows) = reference_stream_run
    q = _queue(commands, cfg, src)
    try:
        out, rep = supervised_run(
            st, cfg, tp, rng.PRNGKey(42, device="cpu"), TICKS,
            SupervisorConfig(chunk_ticks=CHUNK, commands=q,
                             backoff_base_s=0.0, sleep=lambda s: None,
                             health_path=str(tmp_path / "h.ndjson")),
            device="cpu")
    finally:
        q.close()
    _assert_equal(want, out, "supervised stream run")
    notes, rows = _notes(str(tmp_path / "h.ndjson"))
    _rows_equal(rows, jrows)
    assert notes == jnotes
    kinds = [n["kind"] for n in notes]
    assert "directive_refused" in kinds and kinds[-1] == "run_end"
    assert notes[-1]["commands_applied"] == 12
    assert notes[-1]["commands_refused"] == 1
    assert [e.get("directives") for e in rep.events if "directives" in e] \
        == [e.get("directives") for e in jrep.events if "directives" in e]


def test_kill_and_resume_apply_each_directive_once(small,
                                                   reference_stream_run,
                                                   tmp_path):
    _, (cfg, tp, st, _) = small
    src, want, _, _ = reference_stream_run
    ck = str(tmp_path / "ck")
    key = rng.PRNGKey(42, device="cpu")

    def sup(q):
        return SupervisorConfig(chunk_ticks=CHUNK, commands=q,
                                checkpoint_dir=ck, backoff_base_s=0.0,
                                sleep=lambda s: None)

    def kill(info):
        if info["chunk_start"] >= 9:
            raise KeyboardInterrupt("simulated preemption")

    q1 = _queue(commands, cfg, src)
    with pytest.raises(KeyboardInterrupt):
        try:
            supervised_run(st, cfg, tp, key, TICKS, sup(q1), device="cpu",
                           _chunk_hook=kill)
        finally:
            q1.close()
    offsets = [checkpoint.sidecar_meta(os.path.join(ck, p[:-4]))
               .get("stream_offset") for p in os.listdir(ck)
               if p.endswith(".npz")]
    assert offsets and all(o is not None for o in offsets)
    q2 = _queue(commands, cfg, src)
    try:
        out, rep = supervised_run(st, cfg, tp, key, TICKS, sup(q2),
                                  device="cpu")
    finally:
        q2.close()
    assert rep.resumed_tick == 9
    start = next(e for e in rep.events if e["event"] == "ingest_start")
    assert start["offset"] > 0
    _assert_equal(want, out, "kill and resume")
