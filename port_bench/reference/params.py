"""Parameter dataclasses + validation.

Mirrors the reference's three config mechanisms (SURVEY.md §5.6):
- ``GossipSubParams`` defaults (gossipsub.go:32-60, 63-205)
- ``PeerScoreParams`` / ``TopicScoreParams`` / ``PeerScoreThresholds`` with
  the atomic-or-selective validation matrix (score_params.go:12-398)
- ``score_parameter_decay`` helper (score_params.go:407-417)

Durations are virtual-clock float seconds (core/clock.py). All dataclasses are
plain (not frozen) to allow the reference's selective-mutation idiom, but the
batched engine snapshots them into jit-static tuples.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

from .clock import MILLISECOND, MINUTE, SECOND

# --- gossipsub global defaults (gossipsub.go:32-60) ---
GOSSIPSUB_D = 6
GOSSIPSUB_DLO = 5
GOSSIPSUB_DHI = 12
GOSSIPSUB_DSCORE = 4
GOSSIPSUB_DOUT = 2
GOSSIPSUB_HISTORY_LENGTH = 5
GOSSIPSUB_HISTORY_GOSSIP = 3
GOSSIPSUB_DLAZY = 6
GOSSIPSUB_GOSSIP_FACTOR = 0.25
GOSSIPSUB_GOSSIP_RETRANSMISSION = 3
GOSSIPSUB_HEARTBEAT_INITIAL_DELAY = 100 * MILLISECOND
GOSSIPSUB_HEARTBEAT_INTERVAL = 1 * SECOND
GOSSIPSUB_FANOUT_TTL = 60 * SECOND
GOSSIPSUB_PRUNE_PEERS = 16
GOSSIPSUB_PRUNE_BACKOFF = MINUTE
GOSSIPSUB_UNSUBSCRIBE_BACKOFF = 10 * SECOND
GOSSIPSUB_CONNECTORS = 8
GOSSIPSUB_MAX_PENDING_CONNECTIONS = 128
GOSSIPSUB_CONNECTION_TIMEOUT = 30 * SECOND
GOSSIPSUB_DIRECT_CONNECT_TICKS = 300
GOSSIPSUB_DIRECT_CONNECT_INITIAL_DELAY = 1 * SECOND
GOSSIPSUB_OPPORTUNISTIC_GRAFT_TICKS = 60
GOSSIPSUB_OPPORTUNISTIC_GRAFT_PEERS = 2
GOSSIPSUB_GRAFT_FLOOD_THRESHOLD = 10 * SECOND
GOSSIPSUB_MAX_IHAVE_LENGTH = 5000
GOSSIPSUB_MAX_IHAVE_MESSAGES = 10
GOSSIPSUB_IWANT_FOLLOWUP_TIME = 3 * SECOND

# pubsub-level defaults (pubsub.go:27-36)
DEFAULT_MAX_MESSAGE_SIZE = 1 << 20
TIME_CACHE_DURATION = 120 * SECOND
DEFAULT_PEER_OUTBOUND_QUEUE_SIZE = 32
DEFAULT_VALIDATE_QUEUE_SIZE = 32
DEFAULT_VALIDATE_THROTTLE = 8192
DEFAULT_VALIDATE_CONCURRENCY = 1024


def _invalid(x: float) -> bool:
    """NaN/Inf check (score_params.go:419-423)."""
    return math.isnan(x) or math.isinf(x)


@dataclass
class GossipSubParams:
    """All gossipsub-specific knobs (gossipsub.go:63-205)."""

    d: int = GOSSIPSUB_D
    dlo: int = GOSSIPSUB_DLO
    dhi: int = GOSSIPSUB_DHI
    dscore: int = GOSSIPSUB_DSCORE
    dout: int = GOSSIPSUB_DOUT
    history_length: int = GOSSIPSUB_HISTORY_LENGTH
    history_gossip: int = GOSSIPSUB_HISTORY_GOSSIP
    dlazy: int = GOSSIPSUB_DLAZY
    gossip_factor: float = GOSSIPSUB_GOSSIP_FACTOR
    gossip_retransmission: int = GOSSIPSUB_GOSSIP_RETRANSMISSION
    heartbeat_initial_delay: float = GOSSIPSUB_HEARTBEAT_INITIAL_DELAY
    heartbeat_interval: float = GOSSIPSUB_HEARTBEAT_INTERVAL
    slow_heartbeat_warning: float = 0.1
    fanout_ttl: float = GOSSIPSUB_FANOUT_TTL
    prune_peers: int = GOSSIPSUB_PRUNE_PEERS
    prune_backoff: float = GOSSIPSUB_PRUNE_BACKOFF
    unsubscribe_backoff: float = GOSSIPSUB_UNSUBSCRIBE_BACKOFF
    connectors: int = GOSSIPSUB_CONNECTORS
    max_pending_connections: int = GOSSIPSUB_MAX_PENDING_CONNECTIONS
    connection_timeout: float = GOSSIPSUB_CONNECTION_TIMEOUT
    direct_connect_ticks: int = GOSSIPSUB_DIRECT_CONNECT_TICKS
    direct_connect_initial_delay: float = GOSSIPSUB_DIRECT_CONNECT_INITIAL_DELAY
    opportunistic_graft_ticks: int = GOSSIPSUB_OPPORTUNISTIC_GRAFT_TICKS
    opportunistic_graft_peers: int = GOSSIPSUB_OPPORTUNISTIC_GRAFT_PEERS
    graft_flood_threshold: float = GOSSIPSUB_GRAFT_FLOOD_THRESHOLD
    max_ihave_length: int = GOSSIPSUB_MAX_IHAVE_LENGTH
    max_ihave_messages: int = GOSSIPSUB_MAX_IHAVE_MESSAGES
    iwant_followup_time: float = GOSSIPSUB_IWANT_FOLLOWUP_TIME


@dataclass
class PeerScoreThresholds:
    """Score thresholds gating router behavior (score_params.go:12-35)."""

    skip_atomic_validation: bool = False
    gossip_threshold: float = 0.0
    publish_threshold: float = 0.0
    graylist_threshold: float = 0.0
    accept_px_threshold: float = 0.0
    opportunistic_graft_threshold: float = 0.0

    def validate(self) -> None:
        """Validation per score_params.go:37-64."""
        if (not self.skip_atomic_validation or self.publish_threshold != 0
                or self.gossip_threshold != 0 or self.graylist_threshold != 0):
            if self.gossip_threshold > 0 or _invalid(self.gossip_threshold):
                raise ValueError("invalid gossip threshold; it must be <= 0 and a valid number")
            if (self.publish_threshold > 0 or self.publish_threshold > self.gossip_threshold
                    or _invalid(self.publish_threshold)):
                raise ValueError(
                    "invalid publish threshold; it must be <= 0 and <= gossip threshold and a valid number")
            if (self.graylist_threshold > 0 or self.graylist_threshold > self.publish_threshold
                    or _invalid(self.graylist_threshold)):
                raise ValueError(
                    "invalid graylist threshold; it must be <= 0 and <= publish threshold and a valid number")
        if not self.skip_atomic_validation or self.accept_px_threshold != 0:
            if self.accept_px_threshold < 0 or _invalid(self.accept_px_threshold):
                raise ValueError("invalid accept PX threshold; it must be >= 0 and a valid number")
        if not self.skip_atomic_validation or self.opportunistic_graft_threshold != 0:
            if self.opportunistic_graft_threshold < 0 or _invalid(self.opportunistic_graft_threshold):
                raise ValueError(
                    "invalid opportunistic grafting threshold; it must be >= 0 and a valid number")


@dataclass
class TopicScoreParams:
    """Per-topic score function parameters P1-P4 (score_params.go:117-170)."""

    skip_atomic_validation: bool = False
    topic_weight: float = 0.0
    # P1: time in mesh
    time_in_mesh_weight: float = 0.0
    time_in_mesh_quantum: float = 0.0
    time_in_mesh_cap: float = 0.0
    # P2: first message deliveries
    first_message_deliveries_weight: float = 0.0
    first_message_deliveries_decay: float = 0.0
    first_message_deliveries_cap: float = 0.0
    # P3: mesh message delivery rate
    mesh_message_deliveries_weight: float = 0.0
    mesh_message_deliveries_decay: float = 0.0
    mesh_message_deliveries_cap: float = 0.0
    mesh_message_deliveries_threshold: float = 0.0
    mesh_message_deliveries_window: float = 0.0
    mesh_message_deliveries_activation: float = 0.0
    # P3b: sticky mesh failure penalty
    mesh_failure_penalty_weight: float = 0.0
    mesh_failure_penalty_decay: float = 0.0
    # P4: invalid messages
    invalid_message_deliveries_weight: float = 0.0
    invalid_message_deliveries_decay: float = 0.0

    def validate(self) -> None:
        """Validation per score_params.go:236-398 (atomic or selective)."""
        if self.topic_weight < 0 or _invalid(self.topic_weight):
            raise ValueError("invalid topic weight; must be >= 0 and a valid number")
        self._validate_time_in_mesh()
        self._validate_first_message_deliveries()
        self._validate_mesh_message_deliveries()
        self._validate_mesh_failure_penalty()
        self._validate_invalid_message_deliveries()

    def _validate_time_in_mesh(self) -> None:
        if self.skip_atomic_validation and (
                self.time_in_mesh_weight == 0 and self.time_in_mesh_quantum == 0
                and self.time_in_mesh_cap == 0):
            return
        if self.time_in_mesh_quantum == 0:
            raise ValueError("invalid TimeInMeshQuantum; must be non zero")
        if self.time_in_mesh_weight < 0 or _invalid(self.time_in_mesh_weight):
            raise ValueError("invalid TimeInMeshWeight; must be positive (or 0 to disable)")
        if self.time_in_mesh_weight != 0 and self.time_in_mesh_quantum <= 0:
            raise ValueError("invalid TimeInMeshQuantum; must be positive")
        if self.time_in_mesh_weight != 0 and (
                self.time_in_mesh_cap <= 0 or _invalid(self.time_in_mesh_cap)):
            raise ValueError("invalid TimeInMeshCap; must be positive")

    def _validate_first_message_deliveries(self) -> None:
        if self.skip_atomic_validation and (
                self.first_message_deliveries_weight == 0
                and self.first_message_deliveries_cap == 0
                and self.first_message_deliveries_decay == 0):
            return
        w = self.first_message_deliveries_weight
        if w < 0 or _invalid(w):
            raise ValueError("invalid FirstMessageDeliveriesWeight; must be positive (or 0 to disable)")
        if w != 0 and (self.first_message_deliveries_decay <= 0
                       or self.first_message_deliveries_decay >= 1
                       or _invalid(self.first_message_deliveries_decay)):
            raise ValueError("invalid FirstMessageDeliveriesDecay; must be between 0 and 1")
        if w != 0 and (self.first_message_deliveries_cap <= 0
                       or _invalid(self.first_message_deliveries_cap)):
            raise ValueError("invalid FirstMessageDeliveriesCap; must be positive")

    def _validate_mesh_message_deliveries(self) -> None:
        if self.skip_atomic_validation and (
                self.mesh_message_deliveries_weight == 0
                and self.mesh_message_deliveries_cap == 0
                and self.mesh_message_deliveries_decay == 0
                and self.mesh_message_deliveries_threshold == 0
                and self.mesh_message_deliveries_window == 0
                and self.mesh_message_deliveries_activation == 0):
            return
        w = self.mesh_message_deliveries_weight
        if w > 0 or _invalid(w):
            raise ValueError("invalid MeshMessageDeliveriesWeight; must be negative (or 0 to disable)")
        if w != 0 and (self.mesh_message_deliveries_decay <= 0
                       or self.mesh_message_deliveries_decay >= 1
                       or _invalid(self.mesh_message_deliveries_decay)):
            raise ValueError("invalid MeshMessageDeliveriesDecay; must be between 0 and 1")
        if w != 0 and (self.mesh_message_deliveries_cap <= 0
                       or _invalid(self.mesh_message_deliveries_cap)):
            raise ValueError("invalid MeshMessageDeliveriesCap; must be positive")
        if w != 0 and (self.mesh_message_deliveries_threshold <= 0
                       or _invalid(self.mesh_message_deliveries_threshold)):
            raise ValueError("invalid MeshMessageDeliveriesThreshold; must be positive")
        if self.mesh_message_deliveries_window < 0:
            raise ValueError("invalid MeshMessageDeliveriesWindow; must be non-negative")
        if w != 0 and self.mesh_message_deliveries_activation < 1 * SECOND:
            raise ValueError("invalid MeshMessageDeliveriesActivation; must be at least 1s")

    def _validate_mesh_failure_penalty(self) -> None:
        if self.skip_atomic_validation and (
                self.mesh_failure_penalty_decay == 0 and self.mesh_failure_penalty_weight == 0):
            return
        if self.mesh_failure_penalty_weight > 0 or _invalid(self.mesh_failure_penalty_weight):
            raise ValueError("invalid MeshFailurePenaltyWeight; must be negative (or 0 to disable)")
        if self.mesh_failure_penalty_weight != 0 and (
                _invalid(self.mesh_failure_penalty_decay)
                or self.mesh_failure_penalty_decay <= 0
                or self.mesh_failure_penalty_decay >= 1):
            raise ValueError("invalid MeshFailurePenaltyDecay; must be between 0 and 1")

    def _validate_invalid_message_deliveries(self) -> None:
        if self.skip_atomic_validation and (
                self.invalid_message_deliveries_decay == 0
                and self.invalid_message_deliveries_weight == 0):
            return
        if self.invalid_message_deliveries_weight > 0 or _invalid(self.invalid_message_deliveries_weight):
            raise ValueError("invalid InvalidMessageDeliveriesWeight; must be negative (or 0 to disable)")
        if (self.invalid_message_deliveries_decay <= 0
                or self.invalid_message_deliveries_decay >= 1
                or _invalid(self.invalid_message_deliveries_decay)):
            raise ValueError("invalid InvalidMessageDeliveriesDecay; must be between 0 and 1")


@dataclass
class PeerScoreParams:
    """Global score function parameters P5-P7 + per-topic table (score_params.go:66-115)."""

    skip_atomic_validation: bool = False
    topics: dict[str, TopicScoreParams] = field(default_factory=dict)
    topic_score_cap: float = 0.0
    app_specific_score: Callable[[str], float] | None = None
    app_specific_weight: float = 0.0
    ip_colocation_factor_weight: float = 0.0
    ip_colocation_factor_threshold: int = 0
    ip_colocation_factor_whitelist: list[str] = field(default_factory=list)  # CIDR strings
    behaviour_penalty_weight: float = 0.0
    behaviour_penalty_threshold: float = 0.0
    behaviour_penalty_decay: float = 0.0
    decay_interval: float = 0.0
    decay_to_zero: float = 0.0
    retain_score: float = 0.0
    seen_msg_ttl: float = 0.0

    def validate(self) -> None:
        """Validation per score_params.go:173-234."""
        for topic, tp in self.topics.items():
            try:
                tp.validate()
            except ValueError as e:
                raise ValueError(f"invalid score parameters for topic {topic}: {e}") from e

        if not self.skip_atomic_validation or self.topic_score_cap != 0:
            if self.topic_score_cap < 0 or _invalid(self.topic_score_cap):
                raise ValueError("invalid topic score cap; must be positive (or 0 for no cap)")

        if self.app_specific_score is None:
            if self.skip_atomic_validation:
                self.app_specific_score = lambda p: 0.0
            else:
                raise ValueError("missing application specific score function")

        if not self.skip_atomic_validation or self.ip_colocation_factor_weight != 0:
            if self.ip_colocation_factor_weight > 0 or _invalid(self.ip_colocation_factor_weight):
                raise ValueError(
                    "invalid IPColocationFactorWeight; must be negative (or 0 to disable)")
            if self.ip_colocation_factor_weight != 0 and self.ip_colocation_factor_threshold < 1:
                raise ValueError("invalid IPColocationFactorThreshold; must be at least 1")

        if (not self.skip_atomic_validation or self.behaviour_penalty_weight != 0
                or self.behaviour_penalty_threshold != 0):
            if self.behaviour_penalty_weight > 0 or _invalid(self.behaviour_penalty_weight):
                raise ValueError("invalid BehaviourPenaltyWeight; must be negative (or 0 to disable)")
            if self.behaviour_penalty_weight != 0 and (
                    self.behaviour_penalty_decay <= 0 or self.behaviour_penalty_decay >= 1
                    or _invalid(self.behaviour_penalty_decay)):
                raise ValueError("invalid BehaviourPenaltyDecay; must be between 0 and 1")
            if self.behaviour_penalty_threshold < 0 or _invalid(self.behaviour_penalty_threshold):
                raise ValueError("invalid BehaviourPenaltyThreshold; must be >= 0")

        if not self.skip_atomic_validation or self.decay_interval != 0 or self.decay_to_zero != 0:
            if self.decay_interval < 1 * SECOND:
                raise ValueError("invalid DecayInterval; must be at least 1s")
            if self.decay_to_zero <= 0 or self.decay_to_zero >= 1 or _invalid(self.decay_to_zero):
                raise ValueError("invalid DecayToZero; must be between 0 and 1")


DEFAULT_DECAY_INTERVAL = 1 * SECOND
DEFAULT_DECAY_TO_ZERO = 0.01


def score_parameter_decay_with_base(decay: float, base: float, decay_to_zero: float) -> float:
    """factor^n = decay_to_zero for n = decay/base ticks (score_params.go:412-417).

    Matches Go's integer duration division truncation; for decay < base the
    tick count truncates to 0 and the factor is decay_to_zero^Inf == 0."""
    ticks = float(int(decay / base))
    if ticks == 0.0:
        return 0.0
    return decay_to_zero ** (1.0 / ticks)


def score_parameter_decay(decay: float) -> float:
    """Decay factor assuming 1s DecayInterval, 0.01 floor (score_params.go:407-410)."""
    return score_parameter_decay_with_base(decay, DEFAULT_DECAY_INTERVAL, DEFAULT_DECAY_TO_ZERO)
