"""Parity of the port's TraceEvent codec (go_libp2p_pubsub_tpu_torch/pb/
codec.py) and trace sinks (trace/sinks.py) with the JAX package's, on the
CPU.

- every event type, with every payload field, RPC meta in full and a
  UnixNano timestamp above 2**53, encodes byte-equal to the reference's
  ``encode_trace_event`` and decodes back to the reference's dict;
- the golden bytes of tests/test_trace_golden.py (assembled from
  go-libp2p-pubsub's own marshaller, not from either codec) decode to the
  expected dicts and re-encode byte-exact through the port;
- files written by the port's ``PBTracer`` and ``JSONTracer`` from a trace
  of the reference's router runtime read back equal through the
  reference's ``read_trace_file`` and ``json``, and equal the reference
  sinks' files byte for byte;
- ``RemoteTracer`` batches decode equal through the reference's batch
  decoder, with the reference's gating, lossy buffer and reopen-once rule;
- ``SupervisorConfig.sinks`` hard-flushes the port's sinks when a
  supervised run fails.
"""

import json
import os

import pytest
import torch

from go_libp2p_pubsub_tpu.pb import codec as jcodec
from go_libp2p_pubsub_tpu.trace import sinks as jsinks
from go_libp2p_pubsub_tpu_torch.pb import codec
from go_libp2p_pubsub_tpu_torch.trace import (JSONTracer, MemoryTracer,
                                              PBTracer, RemoteTracer, sinks)

from test_trace_golden import EXPECTED, GOLDEN
from test_trace_replay import run_traced_network


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs (the
    suite runs in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TS_NS = 1_785_000_000_123_456_789          # UnixNano, not float-exact
PEER = (bytes([0x12, 0x20]) + bytes(range(0xA0, 0xC0))).decode(
    "utf-8", "surrogateescape")
MID = b"\x00\xff\x10mid".decode("latin-1")

META = {
    "messages": [{"messageID": MID, "topic": "t0"}, {"messageID": "m2"}],
    "subscription": [{"subscribe": True, "topic": "t0"},
                     {"subscribe": False, "topic": "t1"}],
    "control": {
        "ihave": [{"topic": "t0", "messageIDs": [MID, "m2"]}],
        "iwant": [{"messageIDs": ["m3"]}],
        "graft": [{"topic": "t0"}],
        "prune": [{"topic": "t1", "peers": [PEER, "p2"]}],
    },
}

# one event of every type, every payload field set
PAYLOADS = {
    "PUBLISH_MESSAGE": {"publishMessage": {"messageID": MID, "topic": "t0"}},
    "REJECT_MESSAGE": {"rejectMessage": {
        "messageID": MID, "receivedFrom": PEER, "reason": "invalid signature",
        "topic": "t0"}},
    "DUPLICATE_MESSAGE": {"duplicateMessage": {
        "messageID": MID, "receivedFrom": PEER, "topic": "t0"}},
    "DELIVER_MESSAGE": {"deliverMessage": {
        "messageID": MID, "topic": "t0", "receivedFrom": PEER}},
    "ADD_PEER": {"addPeer": {"peerID": PEER, "proto": "/meshsub/1.1.0"}},
    "REMOVE_PEER": {"removePeer": {"peerID": PEER}},
    "RECV_RPC": {"recvRPC": {"receivedFrom": PEER, "meta": META}},
    "SEND_RPC": {"sendRPC": {"sendTo": PEER, "meta": META}},
    "DROP_RPC": {"dropRPC": {"sendTo": PEER, "meta": META}},
    "JOIN": {"join": {"topic": "t0"}},
    "LEAVE": {"leave": {"topic": "t0"}},
    "GRAFT": {"graft": {"peerID": PEER, "topic": "t0"}},
    "PRUNE": {"prune": {"peerID": PEER, "topic": "t0"}},
}


def _event(typ):
    return {"type": typ, "peerID": "p1", "timestamp": TS_NS / 1e9,
            "timestamp_ns": TS_NS, **PAYLOADS[typ]}


def test_schemas_equal_the_reference():
    for name in ("TRACE_TYPES", "TRACE_TYPE_NAMES", "_PAYLOAD_FIELDS",
                 "_PAYLOAD_SCHEMAS", "_TYPE_TO_PAYLOAD_KEY"):
        assert getattr(codec, name) == getattr(jcodec, name), name
    assert set(PAYLOADS) == set(codec.TRACE_TYPES)
    assert codec._PAYLOAD_SCHEMAS["leave"] == [(2, "str", "topic")]


@pytest.mark.parametrize("typ", sorted(PAYLOADS))
def test_every_event_type_byte_equal_and_round_trips(typ):
    evt = _event(typ)
    blob = codec.encode_trace_event(evt)
    assert blob == jcodec.encode_trace_event(evt)
    back = codec.decode_trace_event(blob)
    assert back == jcodec.decode_trace_event(blob) == evt
    assert back["timestamp_ns"] == TS_NS           # above 2**53, exact
    assert TS_NS > 2 ** 53 and int(back["timestamp"] * 1e9) != TS_NS
    # a float timestamp alone is scaled to nanoseconds as the reference's
    short = {k: v for k, v in evt.items() if k != "timestamp_ns"}
    short["timestamp"] = 12.25
    assert codec.encode_trace_event(short) == jcodec.encode_trace_event(short)


@pytest.mark.parametrize("typ", ["RECV_RPC", "SEND_RPC", "DROP_RPC"])
def test_bus_shaped_rpc_events(typ):
    """The tracer bus puts an RPC event's peer and meta at the top level."""
    key = codec._TYPE_TO_PAYLOAD_KEY[typ]
    evt = {"type": typ, "peerID": PEER, "timestamp": 3.5,
           **PAYLOADS[typ][key]}
    blob = codec.encode_trace_event(evt)
    assert blob == jcodec.encode_trace_event(evt)
    assert codec.decode_trace_event(blob)[key] == PAYLOADS[typ][key]


def test_uvarint_primitives_and_malformed_input():
    for n in (0, 1, 127, 128, 300, 2 ** 32, 2 ** 53 + 1, 2 ** 63 - 1):
        raw = codec.write_uvarint(n)
        assert raw == jcodec.write_uvarint(n)
        assert codec.read_uvarint(raw + b"\x01", 0) == (n, len(raw))
    with pytest.raises(ValueError, match="overflow"):
        codec.read_uvarint(b"\xff" * 11, 0)
    with pytest.raises(ValueError, match="wire type"):
        codec.decode_trace_event(b"\x0b")               # field 1, wire 3
    assert codec.decode_trace_bytes(b"") == []


def test_golden_bytes_decode_and_reencode_byte_exact():
    assert codec.decode_trace_bytes(GOLDEN) == EXPECTED
    enc = b"".join(codec.write_uvarint(len(e)) + e
                   for e in (codec.encode_trace_event(x) for x in EXPECTED))
    assert enc == GOLDEN
    batch = codec.encode_trace_event_batch(EXPECTED)
    assert batch == jcodec.encode_trace_event_batch(EXPECTED)
    assert codec.decode_trace_event_batch(batch) == EXPECTED


@pytest.fixture(scope="module")
def router_events():
    """A trace of the reference's pure-Python router runtime (10 peers)."""
    return run_traced_network(n=10, degree=5, publishes=6)[3].events


def test_pbtracer_file_reads_back_through_the_reference(router_events,
                                                         tmp_path):
    mine, theirs = str(tmp_path / "port.pb"), str(tmp_path / "ref.pb")
    pb, jpb = PBTracer(mine), jsinks.PBTracer(theirs)
    for e in router_events:
        pb.trace(e)
        jpb.trace(e)
    pb.flush()
    for e in router_events[:3]:                 # after a flush: appended
        pb.trace(e)
        jpb.trace(e)
    pb.close()
    jpb.close()
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    want = [jcodec.decode_trace_event(jcodec.encode_trace_event(e))
            for e in router_events + router_events[:3]]
    assert jcodec.read_trace_file(mine) == want
    assert codec.read_trace_file(mine) == want
    pb.trace(router_events[0])                   # closed: ignored
    assert pb.buf == []


def test_jsontracer_file_reads_back(router_events, tmp_path):
    mine, theirs = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    js, jjs = JSONTracer(mine), jsinks.JSONTracer(theirs)
    for e in router_events:
        js.trace(e)
        jjs.trace(e)
    js.close()
    jjs.close()
    with open(mine) as f, open(theirs) as g:
        text = f.read()
        assert text == g.read()
    assert [json.loads(ln) for ln in text.splitlines()] == \
        json.loads(json.dumps(router_events))


def test_memory_tracer_keeps_emission_order(router_events):
    mem = MemoryTracer()
    for e in router_events:
        mem.trace(e)
    assert mem.events == router_events


def _remote_pair(fail_plan):
    """A port and a reference RemoteTracer on streams that fail where
    ``fail_plan`` (one bool a write, True = the write raises) says."""
    out = {}
    for label, cls in (("port", RemoteTracer), ("ref", jsinks.RemoteTracer)):
        sent, plan = [], list(fail_plan)
        opens = []

        def open_stream(sent=sent, plan=plan, opens=opens):
            opens.append(1)

            def write(payload):
                if plan and plan.pop(0):
                    raise OSError("stream reset")
                sent.append(payload)
            return write
        out[label] = (cls(open_stream=open_stream), sent, opens)
    return out


def test_remote_batches_decode_through_the_reference(router_events):
    pair = _remote_pair([False, True, False, True, True])
    events = router_events[:100]
    for label, (rt, sent, opens) in pair.items():
        rt.trace(events[0])
        rt.flush()                               # below the batch gate
        assert sent == [] and len(rt.buf) == 1
        for e in events[1:40]:
            rt.trace(e)
        rt.flush()                               # first write goes
        for e in events[40:80]:
            rt.trace(e)
        rt.flush()                               # reset, reopen, retry
        for e in events[80:]:
            rt.trace(e)
        rt.flush()                               # reset, reopen fails: drop
        rt.trace(events[0])
        rt.hard_flush()                          # one event, no gate
        rt.close()
    (rt, sent, opens), (jrt, jsent, jopens) = pair["port"], pair["ref"]
    assert sent == jsent and len(opens) == len(jopens)
    assert rt.dropped == jrt.dropped == 20
    got = [e for p in sent for e in jsinks.RemoteTracer.decode_batch(p)]
    assert got == [e for p in sent for e in RemoteTracer.decode_batch(p)]
    want = [jcodec.decode_trace_event(jcodec.encode_trace_event(e))
            for e in events[:80] + events[:1]]
    assert got == want
    with pytest.raises(ValueError, match="exactly one"):
        RemoteTracer()


def test_remote_buffer_is_lossy_at_its_cap(monkeypatch):
    monkeypatch.setattr(sinks, "TRACE_BUFFER_SIZE", 4)
    rt = RemoteTracer(send=lambda payload: None)
    for i in range(7):
        rt.trace({"type": "JOIN", "peerID": "p", "join": {"topic": "t"}})
    assert len(rt.buf) == 4 and rt.dropped == 3


def test_supervisor_hard_flushes_the_sinks(tmp_path):
    """A failed supervised run hard-flushes ``SupervisorConfig.sinks``: the
    buffered events reach the file and the collector before the crash."""
    from go_libp2p_pubsub_tpu_torch import rng
    from go_libp2p_pubsub_tpu_torch.sim import scenarios
    from go_libp2p_pubsub_tpu_torch.sim.supervisor import (SupervisorConfig,
                                                           SupervisorCrash,
                                                           supervised_run)
    cfg, tp, st = scenarios.single_topic_1k(64, k_slots=8, degree=4,
                                            device="cpu")
    path = str(tmp_path / "t.pb")
    pb = PBTracer(path)
    sent = []
    remote = RemoteTracer(send=sent.append)
    evt = {"type": "JOIN", "peerID": "p0", "timestamp": 0.5,
           "join": {"topic": "t0"}}
    for s in (pb, remote):
        s.trace(evt)

    def fail(info):
        raise RuntimeError("injected")
    sup = SupervisorConfig(chunk_ticks=2, max_retries=0, backoff_base_s=0.0,
                           sleep=lambda s: None, sinks=(pb, remote),
                           crash_dir=str(tmp_path / "crash"))
    with pytest.raises(SupervisorCrash):
        supervised_run(st, cfg, tp, rng.PRNGKey(0, device="cpu"), 4, sup,
                       device="cpu", _chunk_hook=fail)
    want = [jcodec.decode_trace_event(jcodec.encode_trace_event(evt))]
    assert jcodec.read_trace_file(path) == want
    assert os.path.getsize(path) > 0 and pb.buf == [] and not pb.closed
    assert [e for p in sent for e in RemoteTracer.decode_batch(p)] == want
    pb.close()
