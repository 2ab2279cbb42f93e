"""The pubsub wire codec (port of pb/codec.py).

A hand-rolled proto2 codec for go-libp2p-pubsub's schemas, field for field
the JAX package's copy, so frames interoperate with go-libp2p-pubsub:

- RPC{subscriptions=1, publish=2, control=3} with SubOpts{subscribe=1,
  topicid=2}, ControlMessage{ihave=1, iwant=2, graft=3, prune=4},
  ControlIHave{topicID=1, messageIDs=2}, ControlIWant{messageIDs=1},
  ControlGraft{topicID=1}, ControlPrune{topicID=1, peers=2, backoff=3},
  PeerInfo{peerID=1, signedPeerRecord=2} (pb/rpc.proto:5-57), over the
  port's ``core/types.py``; the prune backoff travels as uint64 seconds;
- Message{from=1, data=2, seqno=3, topic=4, signature=5, key=6}, and the
  legacy compat Message with repeated topicIDs=4 (compat/compat.proto:5-12);
- TraceEvent{type=1, peerID=2, timestamp=3, <payload>=4..16} with its
  payload messages and RPCMeta (pb/trace.proto:5-150). ``Leave.topic`` is
  field 2, and an integer ``timestamp_ns`` round-trips UnixNano values
  above 2**53 exactly.

Frames between hosts and PBTracer files are uvarint-length-delimited
(comm.go:64,157-171; tracer.go:132-181). Message ids travel latin-1 and
peer ids through ``surrogateescape``, so arbitrary id bytes survive (the
"string" ids are not valid utf8, pb/rpc.proto:35).
"""

from __future__ import annotations

from ..core.types import (
    RPC,
    ControlGraft,
    ControlIHave,
    ControlIWant,
    ControlMessage,
    ControlPrune,
    Message,
    PeerInfo,
    SubOpts,
)

# --- varint + field primitives ---


def write_uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_uvarint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("uvarint overflow")


def _tag(field: int, wire: int) -> bytes:
    return write_uvarint((field << 3) | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _tag(field, 2) + write_uvarint(len(data)) + data


def _str_field(field: int, s: str) -> bytes:
    return _bytes_field(field, s.encode("utf-8"))


def _mid_field(field: int, s: str) -> bytes:
    # message ids carry raw bytes in a "string" field
    return _bytes_field(field, s.encode("latin-1"))


def _varint_field(field: int, n: int) -> bytes:
    return _tag(field, 0) + write_uvarint(n)


def _iter_fields(buf: bytes):
    """Yield (field, wire, value, next_pos) tuples; value is bytes for wire 2,
    int for wire 0, skipped otherwise."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = read_uvarint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = read_uvarint(buf, pos)
        elif wire == 2:
            ln, pos = read_uvarint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


# --- Message ---


def encode_message(m: Message) -> bytes:
    out = bytearray()
    if m.from_peer is not None:
        out += _bytes_field(1, m.from_peer.encode("utf-8"))
    if m.data:
        out += _bytes_field(2, m.data)
    if m.seqno is not None:
        out += _bytes_field(3, m.seqno)
    if m.topic:
        out += _str_field(4, m.topic)
    if m.signature is not None:
        out += _bytes_field(5, m.signature)
    if m.key is not None:
        out += _bytes_field(6, m.key)
    return bytes(out)


def decode_message(buf: bytes) -> Message:
    m = Message()
    for field, _, val in _iter_fields(buf):
        if field == 1:
            m.from_peer = val.decode("utf-8", "surrogateescape")
        elif field == 2:
            m.data = val
        elif field == 3:
            m.seqno = val
        elif field == 4:
            m.topic = val.decode("utf-8")
        elif field == 5:
            m.signature = val
        elif field == 6:
            m.key = val
    return m


# --- legacy compat Message (repeated topicIDs=4, compat/compat.proto) ---


def encode_compat_message(m: Message, topics: list[str] | None = None) -> bytes:
    out = bytearray()
    if m.from_peer is not None:
        out += _bytes_field(1, m.from_peer.encode("utf-8"))
    if m.data:
        out += _bytes_field(2, m.data)
    if m.seqno is not None:
        out += _bytes_field(3, m.seqno)
    for t in (topics if topics is not None else ([m.topic] if m.topic else [])):
        out += _str_field(4, t)
    if m.signature is not None:
        out += _bytes_field(5, m.signature)
    if m.key is not None:
        out += _bytes_field(6, m.key)
    return bytes(out)


def decode_compat_message(buf: bytes) -> tuple[Message, list[str]]:
    m = Message()
    topics: list[str] = []
    for field, _, val in _iter_fields(buf):
        if field == 1:
            m.from_peer = val.decode("utf-8", "surrogateescape")
        elif field == 2:
            m.data = val
        elif field == 3:
            m.seqno = val
        elif field == 4:
            topics.append(val.decode("utf-8"))
        elif field == 5:
            m.signature = val
        elif field == 6:
            m.key = val
    if topics:
        m.topic = topics[0]
    return m, topics


# --- control messages ---


def _encode_control(c: ControlMessage) -> bytes:
    out = bytearray()
    for ih in c.ihave:
        body = bytearray()
        if ih.topic:
            body += _str_field(1, ih.topic)
        for mid in ih.message_ids:
            body += _mid_field(2, mid)
        out += _bytes_field(1, bytes(body))
    for iw in c.iwant:
        body = bytearray()
        for mid in iw.message_ids:
            body += _mid_field(1, mid)
        out += _bytes_field(2, bytes(body))
    for g in c.graft:
        body = _str_field(1, g.topic) if g.topic else b""
        out += _bytes_field(3, bytes(body))
    for pr in c.prune:
        body = bytearray()
        if pr.topic:
            body += _str_field(1, pr.topic)
        for pi in pr.peers:
            pibody = _bytes_field(1, pi.peer_id.encode("utf-8"))
            if pi.signed_peer_record is not None:
                pibody += _bytes_field(2, pi.signed_peer_record)
            body += _bytes_field(2, pibody)
        if pr.backoff:
            body += _varint_field(3, int(pr.backoff))
        out += _bytes_field(4, bytes(body))
    return bytes(out)


def _decode_control(buf: bytes) -> ControlMessage:
    c = ControlMessage()
    for field, _, val in _iter_fields(buf):
        if field == 1:
            ih = ControlIHave()
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:
                    ih.topic = v2.decode("utf-8")
                elif f2 == 2:
                    ih.message_ids.append(v2.decode("latin-1"))
            c.ihave.append(ih)
        elif field == 2:
            iw = ControlIWant()
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:
                    iw.message_ids.append(v2.decode("latin-1"))
            c.iwant.append(iw)
        elif field == 3:
            g = ControlGraft()
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:
                    g.topic = v2.decode("utf-8")
            c.graft.append(g)
        elif field == 4:
            pr = ControlPrune()
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:
                    pr.topic = v2.decode("utf-8")
                elif f2 == 2:
                    pi = PeerInfo()
                    for f3, _, v3 in _iter_fields(v2):
                        if f3 == 1:
                            pi.peer_id = v3.decode("utf-8", "surrogateescape")
                        elif f3 == 2:
                            pi.signed_peer_record = v3
                    pr.peers.append(pi)
                elif f2 == 3:
                    pr.backoff = float(v2)
            c.prune.append(pr)
    return c


# --- RPC ---


def encode_rpc(rpc: RPC) -> bytes:
    out = bytearray()
    for sub in rpc.subscriptions:
        body = _varint_field(1, 1 if sub.subscribe else 0) + _str_field(2, sub.topicid)
        out += _bytes_field(1, body)
    for msg in rpc.publish:
        out += _bytes_field(2, encode_message(msg))
    if rpc.control is not None and not rpc.control.is_empty():
        out += _bytes_field(3, _encode_control(rpc.control))
    return bytes(out)


def decode_rpc(buf: bytes) -> RPC:
    rpc = RPC()
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            sub = SubOpts()
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:
                    sub.subscribe = bool(v2)
                elif f2 == 2:
                    sub.topicid = v2.decode("utf-8")
            rpc.subscriptions.append(sub)
        elif field == 2:
            rpc.publish.append(decode_message(val))
        elif field == 3:
            rpc.control = _decode_control(val)
    return rpc


def frame_rpc(rpc: RPC) -> bytes:
    """uvarint-length-delimited frame (comm.go:157-171)."""
    payload = encode_rpc(rpc)
    return write_uvarint(len(payload)) + payload


def read_frames(buf: bytes) -> list[RPC]:
    out = []
    pos = 0
    while pos < len(buf):
        ln, pos = read_uvarint(buf, pos)
        out.append(decode_rpc(buf[pos:pos + ln]))
        pos += ln
    return out


# --- TraceEvent (pb/trace.proto) ---

TRACE_TYPES = {
    "PUBLISH_MESSAGE": 0, "REJECT_MESSAGE": 1, "DUPLICATE_MESSAGE": 2,
    "DELIVER_MESSAGE": 3, "ADD_PEER": 4, "REMOVE_PEER": 5, "RECV_RPC": 6,
    "SEND_RPC": 7, "DROP_RPC": 8, "JOIN": 9, "LEAVE": 10, "GRAFT": 11,
    "PRUNE": 12,
}
TRACE_TYPE_NAMES = {v: k for k, v in TRACE_TYPES.items()}

# payload field number per event type (pb/trace.proto:9-22)
_PAYLOAD_FIELDS = {
    "PUBLISH_MESSAGE": 4, "REJECT_MESSAGE": 5, "DUPLICATE_MESSAGE": 6,
    "DELIVER_MESSAGE": 7, "ADD_PEER": 8, "REMOVE_PEER": 9, "RECV_RPC": 10,
    "SEND_RPC": 11, "DROP_RPC": 12, "JOIN": 13, "LEAVE": 14, "GRAFT": 15,
    "PRUNE": 16,
}

# sub-message schemas: payload key -> list of (field_no, kind, dict key)
# NOTE Leave.topic is field 2, not 1 (pb/trace.proto:94 — the only payload
# whose first field number is not 1; verified against trace.pb.go's
# TraceEvent_Leave.MarshalToSizedBuffer tag byte 0x12).
_PAYLOAD_SCHEMAS: dict[str, list[tuple[int, str, str]]] = {
    "publishMessage": [(1, "mid", "messageID"), (2, "str", "topic")],
    "rejectMessage": [(1, "mid", "messageID"), (2, "peer", "receivedFrom"),
                      (3, "str", "reason"), (4, "str", "topic")],
    "duplicateMessage": [(1, "mid", "messageID"), (2, "peer", "receivedFrom"),
                         (3, "str", "topic")],
    "deliverMessage": [(1, "mid", "messageID"), (2, "str", "topic"),
                       (3, "peer", "receivedFrom")],
    "addPeer": [(1, "peer", "peerID"), (2, "str", "proto")],
    "removePeer": [(1, "peer", "peerID")],
    "recvRPC": [(1, "peer", "receivedFrom"), (2, "meta", "meta")],
    "sendRPC": [(1, "peer", "sendTo"), (2, "meta", "meta")],
    "dropRPC": [(1, "peer", "sendTo"), (2, "meta", "meta")],
    "join": [(1, "str", "topic")],
    "leave": [(2, "str", "topic")],
    "graft": [(1, "peer", "peerID"), (2, "str", "topic")],
    "prune": [(1, "peer", "peerID"), (2, "str", "topic")],
}

_TYPE_TO_PAYLOAD_KEY = {
    "PUBLISH_MESSAGE": "publishMessage", "REJECT_MESSAGE": "rejectMessage",
    "DUPLICATE_MESSAGE": "duplicateMessage", "DELIVER_MESSAGE": "deliverMessage",
    "ADD_PEER": "addPeer", "REMOVE_PEER": "removePeer", "RECV_RPC": "recvRPC",
    "SEND_RPC": "sendRPC", "DROP_RPC": "dropRPC", "JOIN": "join",
    "LEAVE": "leave", "GRAFT": "graft", "PRUNE": "prune",
}


def _peer_field(field: int, s: str) -> bytes:
    # peer ids are raw multihash bytes surviving in str via surrogateescape
    return _bytes_field(field, s.encode("utf-8", "surrogateescape"))


def _encode_rpc_meta(meta: dict) -> bytes:
    """TraceEvent.RPCMeta (pb/trace.proto:106-110), dict shape of the reference's
    tracer bus (trace/bus.py ``_rpc_meta``): messages / subscription /
    control."""
    out = bytearray()
    for mm in meta.get("messages", ()):
        body = bytearray()
        if mm.get("messageID") is not None:
            body += _mid_field(1, mm["messageID"])
        if mm.get("topic") is not None:
            body += _str_field(2, mm["topic"])
        out += _bytes_field(1, bytes(body))
    for sm in meta.get("subscription", ()):
        body = bytearray()
        if sm.get("subscribe") is not None:
            body += _varint_field(1, 1 if sm["subscribe"] else 0)
        if sm.get("topic") is not None:
            body += _str_field(2, sm["topic"])
        out += _bytes_field(2, bytes(body))
    ctl = meta.get("control")
    if ctl is not None:
        body = bytearray()
        for ih in ctl.get("ihave", ()):
            b2 = bytearray()
            if ih.get("topic") is not None:
                b2 += _str_field(1, ih["topic"])
            for mid in ih.get("messageIDs", ()):
                b2 += _mid_field(2, mid)
            body += _bytes_field(1, bytes(b2))
        for iw in ctl.get("iwant", ()):
            b2 = bytearray()
            for mid in iw.get("messageIDs", ()):
                b2 += _mid_field(1, mid)
            body += _bytes_field(2, bytes(b2))
        for g in ctl.get("graft", ()):
            b2 = _str_field(1, g["topic"]) if g.get("topic") is not None else b""
            body += _bytes_field(3, bytes(b2))
        for p in ctl.get("prune", ()):
            b2 = bytearray()
            if p.get("topic") is not None:
                b2 += _str_field(1, p["topic"])
            for pid in p.get("peers", ()):
                b2 += _peer_field(2, pid)
            body += _bytes_field(4, bytes(b2))
        out += _bytes_field(3, bytes(body))
    return bytes(out)


def _decode_rpc_meta(buf: bytes) -> dict:
    meta: dict = {}
    for field, _, val in _iter_fields(buf):
        if field == 1:
            mm: dict = {}
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:
                    mm["messageID"] = v2.decode("latin-1")
                elif f2 == 2:
                    mm["topic"] = v2.decode("utf-8")
            meta.setdefault("messages", []).append(mm)
        elif field == 2:
            sm: dict = {}
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:
                    sm["subscribe"] = bool(v2)
                elif f2 == 2:
                    sm["topic"] = v2.decode("utf-8")
            meta.setdefault("subscription", []).append(sm)
        elif field == 3:
            ctl: dict = {}
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:
                    ih: dict = {}
                    for f3, _, v3 in _iter_fields(v2):
                        if f3 == 1:
                            ih["topic"] = v3.decode("utf-8")
                        elif f3 == 2:
                            ih.setdefault("messageIDs", []).append(
                                v3.decode("latin-1"))
                    ctl.setdefault("ihave", []).append(ih)
                elif f2 == 2:
                    iw: dict = {}
                    for f3, _, v3 in _iter_fields(v2):
                        if f3 == 1:
                            iw.setdefault("messageIDs", []).append(
                                v3.decode("latin-1"))
                    ctl.setdefault("iwant", []).append(iw)
                elif f2 == 3:
                    g: dict = {}
                    for f3, _, v3 in _iter_fields(v2):
                        if f3 == 1:
                            g["topic"] = v3.decode("utf-8")
                    ctl.setdefault("graft", []).append(g)
                elif f2 == 4:
                    p: dict = {}
                    for f3, _, v3 in _iter_fields(v2):
                        if f3 == 1:
                            p["topic"] = v3.decode("utf-8")
                        elif f3 == 2:
                            p.setdefault("peers", []).append(
                                v3.decode("utf-8", "surrogateescape"))
                    ctl.setdefault("prune", []).append(p)
            meta["control"] = ctl
    return meta


def _encode_payload(key: str, payload: dict) -> bytes:
    out = bytearray()
    for field, kind, name in _PAYLOAD_SCHEMAS[key]:
        v = payload.get(name)
        if v is None:
            continue
        if kind == "mid":
            out += _mid_field(field, v)
        elif kind == "peer":
            out += _peer_field(field, v)
        elif kind == "meta":
            out += _bytes_field(field, _encode_rpc_meta(v))
        else:
            out += _str_field(field, v)
    return bytes(out)


def _decode_payload(key: str, buf: bytes) -> dict:
    schema = {f: (kind, name) for f, kind, name in _PAYLOAD_SCHEMAS[key]}
    out: dict = {}
    for field, _, val in _iter_fields(buf):
        if field not in schema:
            continue
        kind, name = schema[field]
        if kind == "mid":
            out[name] = val.decode("latin-1")
        elif kind == "peer":
            out[name] = val.decode("utf-8", "surrogateescape")
        elif kind == "meta":
            out[name] = _decode_rpc_meta(val)
        else:
            out[name] = val.decode("utf-8")
    return out


def encode_trace_event(evt: dict) -> bytes:
    """Encode a tracer-bus event dict (trace/bus.py shape) to TraceEvent bytes.

    Timestamps are virtual-clock seconds scaled to int64 nanoseconds, matching
    the reference's UnixNano timestamps (trace.go:90); an integer
    ``timestamp_ns`` takes precedence so real UnixNano values (> 2**53, not
    exactly representable as float seconds) round-trip bit-exactly."""
    typ = evt["type"]
    out = bytearray()
    out += _varint_field(1, TRACE_TYPES[typ])
    if "peerID" in evt:
        out += _peer_field(2, evt["peerID"])
    if "timestamp_ns" in evt:
        out += _varint_field(3, int(evt["timestamp_ns"]))
    elif "timestamp" in evt:
        out += _varint_field(3, int(evt["timestamp"] * 1e9))
    key = _TYPE_TO_PAYLOAD_KEY[typ]
    payload = evt.get(key)
    if payload is None:
        # RPC events carry their peer + meta at the top level of the bus dict
        payload = {k: v for k, v in evt.items()
                   if k in ("receivedFrom", "sendTo", "meta")}
    if payload:
        out += _bytes_field(_PAYLOAD_FIELDS[typ], _encode_payload(key, payload))
    return bytes(out)


def decode_trace_event(buf: bytes) -> dict:
    evt: dict = {}
    payload_field_to_type = {v: k for k, v in _PAYLOAD_FIELDS.items()}
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            evt["type"] = TRACE_TYPE_NAMES[val]
        elif field == 2:
            evt["peerID"] = val.decode("utf-8", "surrogateescape")
        elif field == 3:
            evt["timestamp"] = val / 1e9
            evt["timestamp_ns"] = val
        elif field in payload_field_to_type:
            typ = payload_field_to_type[field]
            evt[_TYPE_TO_PAYLOAD_KEY[typ]] = _decode_payload(
                _TYPE_TO_PAYLOAD_KEY[typ], val)
    return evt


def decode_trace_bytes(data: bytes) -> list[dict]:
    """Decode a uvarint-delimited TraceEvent stream."""
    out = []
    pos = 0
    while pos < len(data):
        ln, pos = read_uvarint(data, pos)
        out.append(decode_trace_event(data[pos:pos + ln]))
        pos += ln
    return out


def read_trace_file(path: str) -> list[dict]:
    """Read a PBTracer output file (uvarint-delimited TraceEvents)."""
    with open(path, "rb") as f:
        return decode_trace_bytes(f.read())


def encode_trace_event_batch(events: list[dict]) -> bytes:
    """TraceEventBatch{batch=1 repeated TraceEvent} (pb/trace.proto:148-150),
    the RemoteTracer wire unit (tracer.go:239)."""
    out = bytearray()
    for e in events:
        out += _bytes_field(1, encode_trace_event(e))
    return bytes(out)


def decode_trace_event_batch(buf: bytes) -> list[dict]:
    return [decode_trace_event(val)
            for field, _, val in _iter_fields(buf) if field == 1]
