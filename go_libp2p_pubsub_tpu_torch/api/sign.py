"""Message signing: policies + Ed25519 sign/verify (sign.go).

Policies mirror sign.go:13-45 (StrictSign / StrictNoSign / LaxSign /
LaxNoSign as a bitfield of sign|verify). The signed payload is the message's
deterministic serialization prefixed with ``libp2p-pubsub:`` (sign.go:47,
109-134). Key resolution mirrors sign.go:77-107: a peer id of the form
``ed25519:<hex pubkey>`` is self-certifying (the analogue of identity-hashed
libp2p IDs, whose pubkey is extractable); otherwise the message must carry
the author's public key and it must match the id.
"""

from __future__ import annotations

import enum
import hashlib

try:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )
    HAVE_CRYPTOGRAPHY = True
except ImportError:  # minimal images: the package must stay importable
    # (LAX_NO_SIGN swarms, the batched engine, and trace tooling need no
    # signing at all); only the ed25519 entry points below are gated
    HAVE_CRYPTOGRAPHY = False
    InvalidSignature = None
    Ed25519PrivateKey = Ed25519PublicKey = None

from ..core.types import Message, PeerID


def _require_crypto() -> None:
    if not HAVE_CRYPTOGRAPHY:
        raise SignError(
            "the 'cryptography' package is not installed: Ed25519 "
            "signing/verification is unavailable (use LAX_NO_SIGN, or "
            "install cryptography for strict policies)")

SIGN_PREFIX = b"libp2p-pubsub:"


class SignPolicy(enum.IntFlag):
    """MessageSignaturePolicy (sign.go:13-34)."""

    MSG_SIGNING = 1
    MSG_VERIFICATION = 2

    @property
    def must_sign(self) -> bool:
        return bool(self & SignPolicy.MSG_SIGNING)

    @property
    def must_verify(self) -> bool:
        return bool(self & SignPolicy.MSG_VERIFICATION)


STRICT_SIGN = SignPolicy.MSG_SIGNING | SignPolicy.MSG_VERIFICATION
STRICT_NO_SIGN = SignPolicy.MSG_VERIFICATION
LAX_SIGN = SignPolicy.MSG_SIGNING
LAX_NO_SIGN = SignPolicy(0)


class SignError(ValueError):
    pass


def generate_keypair(seed: bytes | None = None) -> tuple[Ed25519PrivateKey, PeerID]:
    """New Ed25519 key + its self-certifying peer id."""
    _require_crypto()
    if seed is not None:
        priv = Ed25519PrivateKey.from_private_bytes(hashlib.sha256(seed).digest())
    else:
        priv = Ed25519PrivateKey.generate()
    return priv, peer_id_from_key(priv.public_key())


def peer_id_from_key(pub: Ed25519PublicKey) -> PeerID:
    _require_crypto()
    from cryptography.hazmat.primitives.serialization import (
        Encoding, PublicFormat)
    raw = pub.public_bytes(Encoding.Raw, PublicFormat.Raw)
    return "ed25519:" + raw.hex()


def _pubkey_from_peer_id(pid: PeerID) -> Ed25519PublicKey | None:
    if pid.startswith("ed25519:"):
        _require_crypto()
        try:
            return Ed25519PublicKey.from_public_bytes(bytes.fromhex(pid[8:]))
        except ValueError:
            return None
    return None


def signable_bytes(m: Message) -> bytes:
    """Deterministic serialization of the message sans signature/key.

    Stands in for the proto marshal in sign.go:56-62; length-prefixed fields
    keep it unambiguous.
    """
    parts = []
    for b in ((m.from_peer or "").encode(), m.data, m.seqno or b"",
              m.topic.encode()):
        parts.append(len(b).to_bytes(4, "big"))
        parts.append(b)
    return SIGN_PREFIX + b"".join(parts)


def sign_message(pid: PeerID, key: Ed25519PrivateKey, m: Message) -> None:
    """Sign in place; attaches the pubkey when the id is not self-certifying
    (sign.go:109-134)."""
    _require_crypto()
    m.signature = key.sign(signable_bytes(m))
    if _pubkey_from_peer_id(pid) is None:
        from cryptography.hazmat.primitives.serialization import (
            Encoding, PublicFormat)
        m.key = key.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw)


def verify_message_signature(m: Message) -> None:
    """Raises SignError when the signature doesn't verify (sign.go:49-75)."""
    _require_crypto()
    pid = m.from_peer or ""
    pub = _pubkey_from_peer_id(pid)
    if pub is None:
        if m.key is None:
            raise SignError("cannot extract signing key")
        try:
            pub = Ed25519PublicKey.from_public_bytes(m.key)
        except ValueError as e:
            raise SignError(f"cannot unmarshal signing key: {e}") from e
        # a self-certifying id must match the attached key
        if pid.startswith("ed25519:") and peer_id_from_key(pub) != pid:
            raise SignError(f"bad signing key; source ID {pid} doesn't match key")
    if m.signature is None:
        raise SignError("missing signature")
    try:
        pub.verify(m.signature, signable_bytes(m))
    except InvalidSignature as e:
        raise SignError("invalid signature") from e
