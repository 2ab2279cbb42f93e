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
- ``router_sweep_100k`` — BASELINE config #5: one 100k network per router
  (floodsub, randomsub, gossipsub), scoring off (scenarios.py:193-203).
  Floodsub and randomsub run no heartbeat; all three take the fused
  kernels. Its 128-friendly size is 102400.
- ``partition_50k`` — fault scenario 6: 2 topics at 70% subscription, full
  scoring, a 2-way partition on ticks [start, heal) with RemovePeer cuts
  and a redial at ``heal`` (scenarios.py:206-235); the fused kernels.
- ``outage_10k`` — fault scenario 7: background churn with PX, and 20% of
  the peers dark on ticks [start, heal) (scenarios.py:238-262); the fused
  kernels, churn's exchanges through ``permutation_gather``.
- ``partition_small`` / ``outage_small`` — the two at sweep scale (512
  peers, K = 16, degree 6, window [8, 20); scenarios.py:453-467).

Seeds are fixed (314159, the reference's test seed).
"""

from __future__ import annotations

import numpy as np

from ..core.params import TopicScoreParams
from . import topology
from .config import SimConfig, TopicParams
from .faults import FaultPlan, OutageWindow, PartitionWindow
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


def _topology(topo, n_peers, k_slots, degree):
    if topo is None:
        topo = topology.sparse(n_peers, k_slots, degree=degree, seed=SEED)
    return topo


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
    topo = _topology(topo, n_peers, k_slots, degree)
    return cfg, default_topic_params(n_topics, device=device), \
        init_state(cfg, topo, subscribed=subscribed, device=device)


def router_sweep_100k(router: str, n_peers: int = 100_000, k_slots: int = 32,
                      degree: int = 12, device=None,
                      topo: topology.Topology | None = None,
                      ) -> tuple[SimConfig, TopicParams, SimState]:
    """Config 5: one 100k network per router variant, scoring off (floodsub
    and randomsub have no scoring; the comparison isolates propagation).
    ``topo`` may carry a prebuilt ``topology.sparse(n_peers, k_slots,
    degree=degree, seed=SEED)``."""
    cfg = SimConfig(
        n_peers=n_peers, k_slots=k_slots, n_topics=1, msg_window=32,
        publishers_per_tick=4, prop_substeps=8,
        router=router, scoring_enabled=False)
    topo = _topology(topo, n_peers, k_slots, degree)
    return cfg, TopicParams.disabled(1, device=device), \
        init_state(cfg, topo, device=device)


def partition_50k(n_peers: int = 50_000, k_slots: int = 32, degree: int = 12,
                  n_topics: int = 2, start: int = 10, heal: int = 25,
                  components: int = 2, device=None,
                  topo: topology.Topology | None = None,
                  ) -> tuple[SimConfig, TopicParams, SimState]:
    """Fault scenario 6: full scoring, a ``components``-way partition on
    ticks [start, heal): cross-component edges go down with RemovePeer
    semantics and redial at ``heal`` (sim/faults.py)."""
    rng = np.random.default_rng(SEED)
    subscribed = rng.random((n_peers, n_topics)) < 0.7
    subscribed[~subscribed.any(axis=1), 0] = True
    cfg = SimConfig(
        n_peers=n_peers, k_slots=k_slots, n_topics=n_topics, msg_window=64,
        publishers_per_tick=16, prop_substeps=8,
        scoring_enabled=True, behaviour_penalty_weight=-10.0,
        behaviour_penalty_decay=0.999, gossip_threshold=-100.0,
        publish_threshold=-200.0, graylist_threshold=-300.0,
        retain_score_ticks=30,
        fault_plan=FaultPlan(partitions=(
            PartitionWindow(start, heal, components=components),)))
    topo = _topology(topo, n_peers, k_slots, degree)
    return cfg, default_topic_params(n_topics, device=device), \
        init_state(cfg, topo, subscribed=subscribed, device=device)


def outage_10k(n_peers: int = 10_000, k_slots: int = 32, degree: int = 12,
               fraction: float = 0.2, start: int = 10, heal: int = 25,
               device=None, topo: topology.Topology | None = None,
               ) -> tuple[SimConfig, TopicParams, SimState]:
    """Fault scenario 7: background churn with PX; a ``fraction`` of the
    peers goes dark on ticks [start, heal) and returns through the
    churn/backoff/retention path (sim/faults.py)."""
    cfg = SimConfig(
        n_peers=n_peers, k_slots=k_slots, n_topics=1, msg_window=64,
        publishers_per_tick=8, prop_substeps=8,
        scoring_enabled=True, behaviour_penalty_weight=-10.0,
        behaviour_penalty_decay=0.999, gossip_threshold=-100.0,
        publish_threshold=-200.0, graylist_threshold=-300.0,
        churn_disconnect_prob=0.005, churn_reconnect_prob=0.2,
        px_enabled=True, accept_px_threshold=-50.0, retain_score_ticks=30,
        fault_plan=FaultPlan(outages=(
            OutageWindow(start, heal, fraction=fraction),)))
    topo = _topology(topo, n_peers, k_slots, degree)
    return cfg, default_topic_params(1, device=device), \
        init_state(cfg, topo, device=device)


def partition_small(n_peers: int = 512, k_slots: int = 16, degree: int = 6,
                    start: int = 8, heal: int = 20, **kw
                    ) -> tuple[SimConfig, TopicParams, SimState]:
    """partition_50k's 2-way cut and heal at sweep scale."""
    return partition_50k(n_peers=n_peers, k_slots=k_slots, degree=degree,
                         start=start, heal=heal, **kw)


def outage_small(n_peers: int = 512, k_slots: int = 16, degree: int = 6,
                 start: int = 8, heal: int = 20, **kw
                 ) -> tuple[SimConfig, TopicParams, SimState]:
    """outage_10k's 20%-dark regional outage at sweep scale."""
    return outage_10k(n_peers=n_peers, k_slots=k_slots, degree=degree,
                      start=start, heal=heal, **kw)
