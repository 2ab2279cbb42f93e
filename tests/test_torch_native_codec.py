"""Parity of the port's native host codec (csrc/trace_codec.cpp through
go_libp2p_pubsub_tpu_torch/trace/native.py) with the JAX package's Python
tensorizer and health encoder, on the CPU.

- ``tensorize_bytes`` against the reference's ``tensorize_trace(
  decode_trace_bytes(...))``, array by array and slot by slot, on the cases
  of tests/test_native_codec.py: a trace of the reference's router runtime
  with and without ``t_end``, the window overflow, a malformed stream, a
  truncated varint, empty input, and the golden bytes of
  tests/test_trace_golden.py;
- processes that build the library at once all load a whole library, and
  the build leaves one library and no temporary file in its directory;
- ``encode_health_json`` parses equal to the Python encoder, non-finite
  values as null;
- a 128-peer ``run_traced`` written by ``PBTracer``, read back by
  ``replay.tensorize_trace_file`` and replayed by ``replay_feed``, equals
  in every field the reference's replay of the same file.
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.pb import codec as jcodec
from go_libp2p_pubsub_tpu.sim import init_state as jinit_state
from go_libp2p_pubsub_tpu.sim import scenarios as jscenarios
from go_libp2p_pubsub_tpu.sim import telemetry as jtel
from go_libp2p_pubsub_tpu.sim import topology as jtopology
from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.sim import (init_state, scenarios,
                                            state_to_numpy, telemetry)
from go_libp2p_pubsub_tpu_torch.sim.topology import Topology
from go_libp2p_pubsub_tpu_torch.sim.trace_export import run_traced
from go_libp2p_pubsub_tpu_torch.trace import PBTracer, native

from test_trace_golden import A, B, TOPIC as GTOPIC, build_golden
from test_trace_replay import DUP_WINDOW, T_END, TOPIC, run_traced_network

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
jreplay = importlib.import_module("go_libp2p_pubsub_tpu.trace.replay")
replay = importlib.import_module("go_libp2p_pubsub_tpu_torch.trace.replay")

TRACE_N, TRACE_TICKS = 128, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs (the
    suite runs in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(events):
    return b"".join(jcodec.write_uvarint(len(b)) + b
                    for b in map(jcodec.encode_trace_event, events))


def _same_feed(got, want):
    for f in ("op", "a", "b", "c"):
        arr = getattr(got, f)
        assert arr.dtype == np.int32, f
        np.testing.assert_array_equal(arr, getattr(want, f), err_msg=f)
    assert got.mid_slot == want.mid_slot


@pytest.fixture(scope="module")
def traced():
    mem = run_traced_network(n=10, degree=5, publishes=6)
    hosts = mem[2]
    return mem[3].events, {h.peer_id: i for i, h in enumerate(hosts)}


def test_the_library_builds_here():
    assert native.available()
    path = native.lib_path()
    assert os.path.dirname(path) == os.path.join(
        REPO, "go_libp2p_pubsub_tpu_torch", "_build")
    assert os.path.exists(path)


@pytest.mark.parametrize("t_end", [T_END, None])
def test_feed_equals_the_reference_tensorizer(traced, t_end):
    events, peer_index = traced
    data = _stream(events if t_end else events[:50])
    kw = dict(msg_window=64, decay_interval=1.0, dup_window=[DUP_WINDOW],
              t_end=t_end)
    want = jreplay.tensorize_trace(jcodec.decode_trace_bytes(data),
                                   peer_index, {TOPIC: 0}, **kw)
    _same_feed(native.tensorize_bytes(data, peer_index, {TOPIC: 0}, **kw),
               want)
    # a scalar dup window, as the reference's tensorizer broadcasts it
    kw["dup_window"] = DUP_WINDOW
    _same_feed(native.tensorize_bytes(data, peer_index, {TOPIC: 0}, **kw),
               jreplay.tensorize_trace(jcodec.decode_trace_bytes(data),
                                       peer_index, {TOPIC: 0}, **kw))


def test_golden_bytes_feed(traced):
    data = build_golden(t0_ns=250_000_000)
    kw = dict(msg_window=16, decay_interval=1.0, t_end=5.0)
    _same_feed(native.tensorize_bytes(data, {A: 0, B: 1}, {GTOPIC: 0}, **kw),
               jreplay.tensorize_trace(jcodec.decode_trace_bytes(data),
                                       {A: 0, B: 1}, {GTOPIC: 0}, **kw))


@pytest.mark.parametrize("data,match", [
    (b"\xff" * 10, "malformed"),                  # a varint past 64 bits
    (b"\x80", "malformed"),                       # a truncated varint
    (b"\x05\x08\x00", "malformed"),               # a frame past the end
])
def test_malformed_streams_raise(data, match):
    with pytest.raises(ValueError, match=match):
        native.tensorize_bytes(data, {}, {}, msg_window=8)


def test_window_overflow_raises(traced):
    events, peer_index = traced
    with pytest.raises(ValueError, match="msg_window"):
        native.tensorize_bytes(_stream(events), peer_index, {TOPIC: 0},
                               msg_window=2)
    with pytest.raises(ValueError, match="msg_window"):
        jreplay.tensorize_trace(events, peer_index, {TOPIC: 0}, msg_window=2)


def test_empty_input_is_one_nop():
    feed = native.tensorize_bytes(b"", {"a": 0}, {TOPIC: 0}, msg_window=8)
    _same_feed(feed, jreplay.tensorize_trace([], {"a": 0}, {TOPIC: 0},
                                             msg_window=8))
    assert list(feed.op) == [0] and feed.mid_slot == {}


_BUILD_CHILD = """
import sys, time
sys.path.insert(0, {repo!r})
from go_libp2p_pubsub_tpu_torch.trace import native
native.BUILD_DIR = sys.argv[1]
while not __import__("os").path.exists(sys.argv[2]):
    time.sleep(0.005)
ok = native.available()
feed = native.tensorize_bytes(b"", {{"a": 0}}, {{"t": 0}}, msg_window=4)
print(ok, native.lib_path(), feed.op.tolist())
"""


def test_concurrent_first_builds_all_load(tmp_path):
    """Processes that find no library build it at once; each loads a whole
    one, and one library and no temporary file remain."""
    build = tmp_path / "_build"
    go = tmp_path / "go"
    code = _BUILD_CHILD.format(repo=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build),
                               str(go)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    time.sleep(0.5)
    go.write_text("")
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    lines = {o.strip() for o, _ in outs}
    want = f"True {build}/{os.path.basename(native.lib_path())} [0]"
    assert lines == {want}
    assert os.listdir(build) == [os.path.basename(native.lib_path())]


def test_health_encoder_parses_equal_to_python():
    gen = np.random.default_rng(0)
    cols = [("tick", True), ("member", True), ("delivery_t0", False),
            ("score_mean", False), ("fault_flags", True)]
    mat = gen.random((7, len(cols))) * 1e3
    mat[:, 0] = np.arange(7)
    mat[:, 1] = 3
    mat[:, 4] = [0, 1, 2 ** 31, 5, 7, 9, 2 ** 32 - 1]
    mat[1, 2] = np.nan
    mat[2, 3] = np.inf
    mat[3, 3] = -np.inf
    mat[4, 2] = 0.1
    payload = native.encode_health_json(mat, cols)
    py = [json.loads(ln) for ln in jtel.encode_rows_py(mat, cols).splitlines()]
    assert [json.loads(ln) for ln in payload.splitlines()] == py
    assert py[1]["delivery_t0"] is None and py[2]["score_mean"] is None
    theirs, how = jtel.encode_rows(mat, cols, prefer_native=True)
    assert payload == theirs or how == "python"     # the same C source
    assert native.encode_health_json(mat[:0], cols) == b""
    with pytest.raises(ValueError, match="columns"):
        native.encode_health_json(mat[:, :3], cols)
    got, how = telemetry.encode_rows(mat, cols)
    assert how == "native" and got == payload
    got, how = telemetry.encode_rows(mat, cols, prefer_native=False)
    assert how == "python" and got == jtel.encode_rows_py(mat, cols)


def test_journal_notes_the_native_encoder(tmp_path):
    cfg, tp, st = scenarios.single_topic_1k(64, k_slots=8, degree=4,
                                            device="cpu")
    from go_libp2p_pubsub_tpu_torch.sim.engine import run_keys
    keys = rng.split(rng.PRNGKey(2, device="cpu"), 3)
    _, rec = run_keys(st, cfg, tp, keys, telemetry=True, device="cpu")
    paths = {}
    for native_first in (True, False):
        paths[native_first] = str(tmp_path / f"{native_first}.jsonl")
        with telemetry.HealthJournal(paths[native_first],
                                     prefer_native=native_first) as j:
            assert j.append_records(rec, lo=0, hi=3) == 3
            assert j.encoder == ("native" if native_first else "python")
    got = {k: telemetry.read_journal(p) for k, p in paths.items()}
    assert [c["encoder"] for c in got[True]["chunks"]] == ["native"]
    assert [c["encoder"] for c in got[False]["chunks"]] == ["python"]
    assert got[True]["rows"] == got[False]["rows"]
    assert got[True]["rows"] == jtel.read_journal(paths[True])["rows"]


def test_run_traced_file_replays_as_the_reference(tmp_path):
    """A 128-peer run_traced through a PBTracer file: the port's file
    tensorizer (native) and replay against the reference's
    read_trace_file, tensorize_trace and replay_feed."""
    cfg, tp, st = scenarios.single_topic_1k(n_peers=TRACE_N, k_slots=16,
                                            degree=6, device="cpu")
    cfg = dataclasses.replace(cfg, record_provenance=True)
    _, events = run_traced(st, cfg, tp, None, 0, device="cpu",
                           keys=rng.split(rng.PRNGKey(4, device="cpu"),
                                          TRACE_TICKS))
    pre = [{"type": "JOIN", "peerID": f"p{i}", "timestamp": 0.1,
            "join": {"topic": "t0"}} for i in range(TRACE_N)]
    path = str(tmp_path / "run.pb")
    pb = PBTracer(path)
    for e in pre + events:
        pb.trace(e)
    pb.close()
    index = {f"p{i}": i for i in range(TRACE_N)}
    kw = dict(msg_window=cfg.msg_window, t_end=float(TRACE_TICKS))
    jfeed = jreplay.tensorize_trace(jcodec.read_trace_file(path), index,
                                    {"t0": 0}, **kw)
    feed = replay.tensorize_trace_file(path, index, {"t0": 0}, **kw)
    _same_feed(feed, jfeed)
    assert len(feed.op) > TRACE_N
    jcfg, jtp, _ = jscenarios.single_topic_1k(n_peers=TRACE_N, k_slots=16,
                                              degree=6)
    jcfg = dataclasses.replace(jcfg, record_provenance=True, hop_mode="xla")
    jtopo = jtopology.sparse(TRACE_N, 16, degree=6)
    fresh = np.zeros((TRACE_N, 1), bool)
    with jax.default_device(jax.devices("cpu")[0]):
        jrep = jreplay.replay_feed(jinit_state(jcfg, jtopo, subscribed=fresh),
                                   jcfg, jtp, jfeed)
    rep = replay.replay_feed(init_state(cfg, Topology(*jtopo),
                                        subscribed=fresh, device="cpu"),
                             cfg, tp, feed)
    got = state_to_numpy(rep)
    for f in jrep._fields:
        want = np.asarray(getattr(jrep, f))
        assert got[f].dtype == want.dtype, f
        np.testing.assert_array_equal(got[f], want, err_msg=f)
    assert torch.equal(rep.subscribed, torch.ones_like(rep.subscribed))
