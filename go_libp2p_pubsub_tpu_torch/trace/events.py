"""Tracer contracts: rejection reasons + the RawTracer hook protocol (a
copy of the reference's trace/events.py, which imports no jax; the port
imports nothing of the JAX package).

Mirrors trace.go:15-60 and tracer.go:27-39. The RawTracer bus is the
reference's internal event backbone (SURVEY.md L5): scoring, promise
tracking, connmgr tags, and the peer gater all implement this protocol.
"""

from __future__ import annotations

from typing import Protocol

# rejection reasons (tracer.go:27-39)
REJECT_BLACKLISTED_PEER = "blacklisted peer"
REJECT_BLACKLISTED_SOURCE = "blacklisted source"
REJECT_MISSING_SIGNATURE = "missing signature"
REJECT_UNEXPECTED_SIGNATURE = "unexpected signature"
REJECT_UNEXPECTED_AUTH_INFO = "unexpected auth info"
REJECT_INVALID_SIGNATURE = "invalid signature"
REJECT_VALIDATION_QUEUE_FULL = "validation queue full"
REJECT_VALIDATION_THROTTLED = "validation throttled"
REJECT_VALIDATION_FAILED = "validation failed"
REJECT_VALIDATION_IGNORED = "validation ignored"
REJECT_SELF_ORIGIN = "self originated message"


class RawTracer(Protocol):
    """Synchronous hook bus, 15 methods (trace.go:27-60).

    Implementations may subclass ``RawTracerBase`` for default no-ops.
    """

    def add_peer(self, peer: str, proto: str) -> None: ...
    def remove_peer(self, peer: str) -> None: ...
    def join(self, topic: str) -> None: ...
    def leave(self, topic: str) -> None: ...
    def graft(self, peer: str, topic: str) -> None: ...
    def prune(self, peer: str, topic: str) -> None: ...
    def validate_message(self, msg: "Message") -> None: ...
    def deliver_message(self, msg: "Message") -> None: ...
    def reject_message(self, msg: "Message", reason: str) -> None: ...
    def duplicate_message(self, msg: "Message") -> None: ...
    def throttle_peer(self, peer: str) -> None: ...
    def recv_rpc(self, rpc: "RPC") -> None: ...
    def send_rpc(self, rpc: "RPC", peer: str) -> None: ...
    def drop_rpc(self, rpc: "RPC", peer: str) -> None: ...
    def undeliverable_message(self, msg: "Message") -> None: ...


class RawTracerBase:
    """No-op defaults for all 15 RawTracer hooks."""

    def add_peer(self, peer: str, proto: str) -> None: pass
    def remove_peer(self, peer: str) -> None: pass
    def join(self, topic: str) -> None: pass
    def leave(self, topic: str) -> None: pass
    def graft(self, peer: str, topic: str) -> None: pass
    def prune(self, peer: str, topic: str) -> None: pass
    def validate_message(self, msg: "Message") -> None: pass
    def deliver_message(self, msg: "Message") -> None: pass
    def reject_message(self, msg: "Message", reason: str) -> None: pass
    def duplicate_message(self, msg: "Message") -> None: pass
    def throttle_peer(self, peer: str) -> None: pass
    def recv_rpc(self, rpc: "RPC") -> None: pass
    def send_rpc(self, rpc: "RPC", peer: str) -> None: pass
    def drop_rpc(self, rpc: "RPC", peer: str) -> None: pass
    def undeliverable_message(self, msg: "Message") -> None: pass
