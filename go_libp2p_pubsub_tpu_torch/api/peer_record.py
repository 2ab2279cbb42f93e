"""Signed peer records + envelopes for PX validation.

Mirrors the reference's record validation on the PX dial path
(gossipsub.go:893-926): a ``PeerInfo`` carrying a ``signedPeerRecord`` must
unmarshal as a signed envelope over the peer-record domain, its payload must
be a peer record, and the record's peer id must match the announced id —
otherwise the peer is skipped without dialing. Records are produced on the
prune side from the host's certified-record store (gossipsub.go:1885-1901
``cab.GetPeerRecord``) and consumed into it after a successful PX dial
(gossipsub.go:954-958 ``ConsumePeerRecord``).

Wire layout follows libp2p's envelope.proto / peer_record.proto field
numbers (Envelope: publicKey=1, payloadType=2, payload=3, signature=5;
PeerRecord: peerId=1, seq=2, addresses=3{multiaddr=1}; signed payload =
len-prefixed domain + payloadType + payload), with the raw Ed25519 public
key standing in for libp2p's PublicKey submessage on this simulated
substrate — the framework's ids are self-certifying ``ed25519:<hex>``
(api/sign.py), so the key IS the identity and the envelope is
self-validating.
"""

from __future__ import annotations

from dataclasses import dataclass

try:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )
    _HAVE_CRYPTOGRAPHY = True
except ImportError:  # minimal images: record encode/decode stays available,
    # only seal/consume (the ed25519 envelope paths) are gated below
    _HAVE_CRYPTOGRAPHY = False
    InvalidSignature = None
    Ed25519PrivateKey = Ed25519PublicKey = None

from ..core.types import PeerID
from ..pb.codec import (
    _bytes_field,
    _iter_fields,
    _str_field,
    _varint_field,
    write_uvarint,
)
from .sign import peer_id_from_key

PEER_RECORD_ENVELOPE_DOMAIN = "libp2p-peer-record"
PEER_RECORD_PAYLOAD_TYPE = b"\x03\x01"  # multicodec libp2p-peer-record


class RecordError(ValueError):
    """Envelope/record that fails to parse or validate."""


@dataclass
class PeerRecord:
    """peer_record.proto: the routable self-description PX hands around."""

    peer_id: PeerID = ""
    seq: int = 0
    addrs: tuple[str, ...] = ()


def encode_peer_record(rec: PeerRecord) -> bytes:
    out = bytearray()
    out += _bytes_field(1, rec.peer_id.encode("utf-8", "surrogateescape"))
    out += _varint_field(2, rec.seq)
    for a in rec.addrs:
        out += _bytes_field(3, _str_field(1, a))
    return bytes(out)


def decode_peer_record(buf: bytes) -> PeerRecord:
    pid, seq, addrs = "", 0, []
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 2:
            pid = val.decode("utf-8", "surrogateescape")
        elif field == 2 and wire == 0:
            seq = int(val)
        elif field == 3 and wire == 2:
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:
                    addrs.append(v2.decode("utf-8", "surrogateescape"))
    return PeerRecord(peer_id=pid, seq=seq, addrs=tuple(addrs))


def _unsigned_bytes(domain: str, payload_type: bytes, payload: bytes) -> bytes:
    """The byte string the envelope signature covers (record/envelope.go):
    each component length-prefixed so the triple is unambiguous."""
    out = bytearray()
    for part in (domain.encode(), payload_type, payload):
        out += write_uvarint(len(part)) + part
    return bytes(out)


def seal_record(rec: PeerRecord, key: Ed25519PrivateKey) -> bytes:
    """Sign ``rec`` into an envelope over the peer-record domain."""
    if not _HAVE_CRYPTOGRAPHY:
        raise RecordError("the 'cryptography' package is not installed: "
                          "cannot seal peer-record envelopes")
    from cryptography.hazmat.primitives.serialization import (
        Encoding, PublicFormat)

    payload = encode_peer_record(rec)
    sig = key.sign(_unsigned_bytes(
        PEER_RECORD_ENVELOPE_DOMAIN, PEER_RECORD_PAYLOAD_TYPE, payload))
    pub = key.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw)
    out = bytearray()
    out += _bytes_field(1, pub)
    out += _bytes_field(2, PEER_RECORD_PAYLOAD_TYPE)
    out += _bytes_field(3, payload)
    out += _bytes_field(5, sig)
    return bytes(out)


def consume_peer_record(envelope: bytes) -> PeerRecord:
    """Validate an envelope and return its peer record.

    Raises RecordError when the envelope doesn't parse, the payload type is
    not a peer record, the signature doesn't verify, or the record's peer id
    doesn't match the signing key (self-certifying ids) — the failure modes
    the reference skips PX peers for (gossipsub.go:909-926)."""
    pub_raw = payload_type = payload = sig = None
    try:
        for field, wire, val in _iter_fields(envelope):
            if wire != 2:
                continue    # all envelope fields are length-delimited; a
                            # varint here is an attack shape, not our data
            if field == 1:
                pub_raw = val
            elif field == 2:
                payload_type = val
            elif field == 3:
                payload = val
            elif field == 5:
                sig = val
    except (ValueError, IndexError) as e:
        raise RecordError(f"malformed envelope: {e}") from e
    if pub_raw is None or payload is None or sig is None:
        raise RecordError("envelope missing key, payload, or signature")
    if payload_type != PEER_RECORD_PAYLOAD_TYPE:
        raise RecordError("envelope payload is not a peer record")
    if not _HAVE_CRYPTOGRAPHY:
        raise RecordError("the 'cryptography' package is not installed: "
                          "cannot verify peer-record envelopes")
    try:
        pub = Ed25519PublicKey.from_public_bytes(bytes(pub_raw))
    except ValueError as e:
        raise RecordError(f"bad envelope key: {e}") from e
    try:
        pub.verify(bytes(sig), _unsigned_bytes(
            PEER_RECORD_ENVELOPE_DOMAIN, PEER_RECORD_PAYLOAD_TYPE,
            bytes(payload)))
    except InvalidSignature as e:
        raise RecordError("invalid envelope signature") from e
    try:
        rec = decode_peer_record(bytes(payload))
    except (ValueError, IndexError, UnicodeDecodeError) as e:
        # validly signed garbage is still garbage (attacker signs anything
        # with their own key) — reject, don't crash the PRUNE handler
        raise RecordError(f"malformed peer record payload: {e}") from e
    if rec.peer_id != peer_id_from_key(pub):
        raise RecordError(
            f"record peer id {rec.peer_id!r} doesn't match signing key")
    return rec
