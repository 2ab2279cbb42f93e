"""Named benchmark scenarios as reproducible constructors (port of
sim/scenarios.py; the scenarios the port runs so far).

Each constructor returns ``(cfg, tp, state)`` ready for ``engine.run``, with
the state on ``device`` (cuda unless the caller passes ``device="cpu"``),
array-equal to the reference constructor's for the same arguments.

- ``churn_50k`` — BASELINE config #3: 50k peers, 4 topics with random 50%
  subscription, full scoring, per-tick connection churn with PX-gated
  reconnects and 30-tick score retention, and the peer gater with a
  validation queue cap of 64 (scenarios.py:130-153). The gater and the
  cap put it on the non-fused data path. Its 128-friendly size is 51200.

Seeds are fixed (314159, the reference's test seed).
"""

from __future__ import annotations

import numpy as np

from ..core.params import TopicScoreParams
from . import topology
from .config import SimConfig, TopicParams
from .state import SimState, init_state

SEED = 314159


def default_topic_params(n_topics: int = 1, device=None) -> TopicParams:
    """The reference tests' canonical params shape (scenarios.py:51-63):
    all P components active with mild weights."""
    return TopicParams.from_topic_params([TopicScoreParams(
        topic_weight=1.0, time_in_mesh_weight=0.01, time_in_mesh_quantum=1.0,
        time_in_mesh_cap=3600.0, first_message_deliveries_weight=1.0,
        first_message_deliveries_decay=0.5, first_message_deliveries_cap=100.0,
        mesh_message_deliveries_weight=-1.0, mesh_message_deliveries_decay=0.5,
        mesh_message_deliveries_cap=100.0, mesh_message_deliveries_threshold=2.0,
        mesh_message_deliveries_window=0.01, mesh_message_deliveries_activation=5.0,
        mesh_failure_penalty_weight=-1.0, mesh_failure_penalty_decay=0.5,
        invalid_message_deliveries_weight=-10.0, invalid_message_deliveries_decay=0.9,
    )] * n_topics, device=device)


def churn_50k(n_peers: int = 50_000, k_slots: int = 32, degree: int = 12,
              n_topics: int = 4, disconnect_prob: float = 0.02,
              reconnect_prob: float = 0.2, device=None,
              topo: topology.Topology | None = None,
              ) -> tuple[SimConfig, TopicParams, SimState]:
    """Config 3: multi-topic, per-tick connection churn, peer gater.
    ``topo`` may carry a prebuilt ``topology.sparse(n_peers, k_slots,
    degree=degree, seed=SEED)``."""
    rng = np.random.default_rng(SEED)
    subscribed = rng.random((n_peers, n_topics)) < 0.5
    subscribed[~subscribed.any(axis=1), 0] = True
    cfg = SimConfig(
        n_peers=n_peers, k_slots=k_slots, n_topics=n_topics, msg_window=64,
        publishers_per_tick=16, prop_substeps=8,
        scoring_enabled=True, behaviour_penalty_weight=-10.0,
        behaviour_penalty_decay=0.999, gossip_threshold=-100.0,
        publish_threshold=-200.0, graylist_threshold=-300.0,
        retain_score_ticks=30, churn_disconnect_prob=disconnect_prob,
        churn_reconnect_prob=reconnect_prob,
        gater_enabled=True, validation_queue_cap=64,
        px_enabled=True, accept_px_threshold=-50.0)
    if topo is None:
        topo = topology.sparse(n_peers, k_slots, degree=degree, seed=SEED)
    return cfg, default_topic_params(n_topics, device=device), \
        init_state(cfg, topo, subscribed=subscribed, device=device)
