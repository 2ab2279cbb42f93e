"""Named benchmark scenarios as reproducible constructors (port of
sim/scenarios.py).

Each constructor returns ``(cfg, tp, state)`` ready for ``engine.run``, with
the state on ``device`` (cuda unless the caller passes ``device="cpu"``),
array-equal to the reference constructor's for the same arguments. Each
takes a prebuilt underlay as ``topo=`` (the O(N^2) ``topology.sparse``
build at the scenario's arguments and seed).

The five BASELINE configs:

1. ``single_topic_1k`` — 1k-peer single-topic gossipsub with the default
   score params (scenarios.py:66-77). Its 128-friendly size is 1024.
2. ``beacon_10k`` — 10k peers, an Ethereum beacon-chain-style set of 9
   topics (5 joined by all, 4 attestation subnets joined by random 15%
   committees), K = 48 slots and the beacon scoring shape
   (scenarios.py:84-127). Its 128-friendly size is 10240.
3. ``churn_50k`` — 50k peers, 4 topics with random 50% subscription, full
   scoring, per-tick connection churn with PX-gated reconnects and 30-tick
   score retention, and the peer gater with a validation queue cap of 64
   (scenarios.py:130-153). The gater and the cap put it on the non-fused
   data path. Its 128-friendly size is 51200.
4. ``sybil_100k`` — 100k peers, 20% sybils sharing 64 IP groups (invalid
   publishes, IHAVE floods, unanswered IWANTs) under full scoring with
   colocation penalties, connection churn with PX and 600-tick score
   retention (scenarios.py:156-190). Its 128-friendly size is 102400.
5. ``router_sweep_100k`` — one 100k network per router (floodsub,
   randomsub, gossipsub), scoring off (scenarios.py:193-203). Floodsub and
   randomsub run no heartbeat; all three take the fused kernels.

Fault scenarios: ``partition_50k`` (6: 2 topics at 70% subscription, full
scoring, a 2-way partition on ticks [start, heal); scenarios.py:206-235),
``outage_10k`` (7: background churn with PX, 20% of the peers dark on
ticks [start, heal); scenarios.py:238-262), and at sweep scale (512 peers,
K = 16, degree 6) ``sybil_small``, ``partition_small`` and
``outage_small`` (scenarios.py:447-467).

The frontier family (scenarios.py:274-370): ``frontier_cfg``,
``frontier_spec`` (the host-side inputs, on ``topology.sparse_fast`` or,
with ``rows=``, a shard of ``topology.sparse_hash``), ``frontier`` and
``frontier_250k`` ... ``frontier_10m``. Its configs ask for
``edge_gather_mode="sort"`` (every exchange by one sort permutation) over
the fused hop, resolve and emit; the two XL sizes default to the compact
state precision (sim/state.py) at any ``n_peers`` the caller passes.

The adversary families (sim/adversary.py; scenarios.py:385-441):
``eclipse_small``, ``censor_small``, ``flashcrowd_small``,
``slowlink_small``, ``diurnal_small`` and the bench-scale ``eclipse_50k``
and ``flashcrowd_50k``. :data:`SCENARIOS` is the reference's name
registry.

The heavy-tailed family (scenarios.py:479-627): ``powerlaw_cfg``,
``powerlaw_spec``, ``powerlaw_mh_spec``, ``powerlaw_bucketed``,
``powerlaw_100k``/``_1m``/``_10m`` and ``heavytail_eclipse`` (a
hub-targeted eclipse) return ``(cfg, tp, BucketedState)`` for
``sim.bucketed.bucketed_run``; :data:`BUCKETED_SCENARIOS` names them.

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


def single_topic_1k(n_peers: int = 1024, k_slots: int = 32, degree: int = 12,
                    device=None, topo: topology.Topology | None = None,
                    ) -> tuple[SimConfig, TopicParams, SimState]:
    """Config 1: the gossipsub_test.go harness at 1k scale."""
    cfg = SimConfig(
        n_peers=n_peers, k_slots=k_slots, n_topics=1, msg_window=64,
        publishers_per_tick=8, prop_substeps=8,
        scoring_enabled=True, behaviour_penalty_weight=-10.0,
        behaviour_penalty_decay=0.999, gossip_threshold=-100.0,
        publish_threshold=-200.0, graylist_threshold=-300.0)
    topo = _topology(topo, n_peers, k_slots, degree)
    return cfg, default_topic_params(1, device=device), \
        init_state(cfg, topo, device=device)


# Beacon-chain-style topic roles: (name, joined-by-all, weight): one heavy
# global block topic, a global aggregate topic, and per-subnet attestation
# topics joined by rotating committees (the published Eth2 gossip scoring
# shape; exact production constants are chain-config dependent)
_BEACON_TOPICS = [
    ("beacon_block", True, 0.5),
    ("beacon_aggregate_and_proof", True, 0.5),
    ("voluntary_exit", True, 0.05),
    ("proposer_slashing", True, 0.05),
    ("attester_slashing", True, 0.05),
    ("beacon_attestation_0", False, 0.25),
    ("beacon_attestation_1", False, 0.25),
    ("beacon_attestation_2", False, 0.25),
    ("beacon_attestation_3", False, 0.25),
]


def beacon_10k(n_peers: int = 10_000, k_slots: int = 48, degree: int = 16,
               subnet_fraction: float = 0.15, device=None,
               topo: topology.Topology | None = None,
               ) -> tuple[SimConfig, TopicParams, SimState]:
    """Config 2: 10k peers over a beacon-style topic set with peer
    scoring."""
    rng = np.random.default_rng(SEED)
    t = len(_BEACON_TOPICS)
    subscribed = np.zeros((n_peers, t), dtype=bool)
    for i, (_, global_topic, _) in enumerate(_BEACON_TOPICS):
        if global_topic:
            subscribed[:, i] = True
        else:
            subscribed[:, i] = rng.random(n_peers) < subnet_fraction
    tp = TopicParams.from_topic_params([TopicScoreParams(
        topic_weight=w, time_in_mesh_weight=0.03, time_in_mesh_quantum=1.0,
        time_in_mesh_cap=300.0, first_message_deliveries_weight=1.0,
        first_message_deliveries_decay=0.99, first_message_deliveries_cap=50.0,
        mesh_message_deliveries_weight=-1.0, mesh_message_deliveries_decay=0.97,
        mesh_message_deliveries_cap=100.0, mesh_message_deliveries_threshold=4.0,
        mesh_message_deliveries_window=0.01, mesh_message_deliveries_activation=10.0,
        mesh_failure_penalty_weight=-1.0, mesh_failure_penalty_decay=0.95,
        invalid_message_deliveries_weight=-100.0, invalid_message_deliveries_decay=0.99,
    ) for (_, _, w) in _BEACON_TOPICS], device=device)
    cfg = SimConfig(
        n_peers=n_peers, k_slots=k_slots, n_topics=t, msg_window=64,
        publishers_per_tick=16, prop_substeps=8,
        scoring_enabled=True, topic_score_cap=100.0,
        behaviour_penalty_weight=-15.9, behaviour_penalty_threshold=6.0,
        behaviour_penalty_decay=0.986, gossip_threshold=-4000.0,
        publish_threshold=-8000.0, graylist_threshold=-16000.0)
    topo = _topology(topo, n_peers, k_slots, degree)
    return cfg, tp, init_state(cfg, topo, subscribed=subscribed,
                               device=device)


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


def sybil_100k(n_peers: int = 100_000, k_slots: int = 32, degree: int = 12,
               sybil_fraction: float = 0.2, n_sybil_ips: int = 64,
               device=None, topo: topology.Topology | None = None,
               ) -> tuple[SimConfig, TopicParams, SimState]:
    """Config 4: 100k-peer mesh, 20% sybil attackers sharing few IPs. Sybils
    publish invalid messages, advertise the whole window and never answer
    IWANTs (the gossipsub_spam_test.go actor set); scoring must graylist
    them (P4 + P7 + P6 colocation). Churn with PX lets honest peers
    reconnect preferentially to peers they score above the PX threshold;
    the long score retention keeps sybil history across their down-time."""
    rng = np.random.default_rng(SEED)
    malicious = rng.random(n_peers) < sybil_fraction
    # honest peers get unique ip groups; sybils share n_sybil_ips groups
    ip_group = np.arange(n_peers, dtype=np.int32)
    ip_group[malicious] = n_peers + (rng.integers(
        0, n_sybil_ips, malicious.sum())).astype(np.int32)
    _, ip_group = np.unique(ip_group, return_inverse=True)
    ip_group = ip_group.astype(np.int32)
    cfg = SimConfig(
        n_peers=n_peers, k_slots=k_slots, n_topics=1, msg_window=32,
        publishers_per_tick=8, prop_substeps=8,
        scoring_enabled=True, behaviour_penalty_weight=-10.0,
        behaviour_penalty_threshold=2.0, behaviour_penalty_decay=0.99,
        ip_colocation_factor_weight=-50.0, ip_colocation_factor_threshold=4,
        n_ip_groups=int(ip_group.max()) + 1,
        gossip_threshold=-10.0, publish_threshold=-50.0,
        graylist_threshold=-100.0,
        churn_disconnect_prob=0.01, churn_reconnect_prob=0.2,
        px_enabled=True, accept_px_threshold=-5.0, retain_score_ticks=600)
    topo = _topology(topo, n_peers, k_slots, degree)
    return cfg, default_topic_params(1, device=device), \
        init_state(cfg, topo, malicious=malicious, ip_group=ip_group,
                   device=device)


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


# --- frontier family: the million-peer trajectory slot --------------------
# A sparse random underlay (the vectorized builder: topology.sparse is
# O(N^2) Python), K=32, a small topic set, full scoring, and the reference's
# packed sharded configuration (edge_gather_mode="sort", sharded_route=
# "halo"). Peer counts are powers of two.

FRONTIER_NS = {"frontier_250k": 262_144, "frontier_500k": 524_288,
               "frontier_1m": 1_048_576,
               # XL tier: compact storage precision by construction
               "frontier_4m": 4_194_304, "frontier_10m": 10_485_760}


def frontier_cfg(n_peers: int, k_slots: int = 32, n_topics: int = 2,
                 msg_window: int = 64,
                 state_precision: str = "f32") -> SimConfig:
    """The frontier SimConfig alone, with no topology build."""
    return SimConfig(
        n_peers=n_peers, k_slots=k_slots, n_topics=n_topics,
        msg_window=msg_window, publishers_per_tick=16, prop_substeps=8,
        scoring_enabled=True, behaviour_penalty_weight=-10.0,
        behaviour_penalty_decay=0.999, gossip_threshold=-100.0,
        publish_threshold=-200.0, graylist_threshold=-300.0,
        edge_gather_mode="sort", sharded_route="halo",
        state_precision=state_precision)


def frontier_spec(n_peers: int, k_slots: int = 32, degree: int = 8,
                  n_topics: int = 2, msg_window: int = 64,
                  subnet_fraction: float = 0.3,
                  state_precision: str = "f32",
                  rows: tuple[int, int] | None = None, device=None,
                  topo: topology.Topology | None = None,
                  ) -> tuple[SimConfig, TopicParams, topology.Topology,
                             np.ndarray]:
    """The frontier scenario without device state: ``(cfg, tp, topo,
    subscribed)``. ``rows=(start, count)`` builds only those rows of the
    seeded circulant underlay (``topology.sparse_hash``); without it the
    underlay is ``topology.sparse_fast``, or ``topo`` when the caller
    built it (``topology.sparse_fast(n_peers, k_slots, degree=degree,
    seed=SEED)``). ``subscribed`` stays global (one global topic, random
    subnets)."""
    cfg = frontier_cfg(n_peers, k_slots=k_slots, n_topics=n_topics,
                       msg_window=msg_window,
                       state_precision=state_precision)
    rng = np.random.default_rng(SEED)
    subscribed = np.zeros((n_peers, n_topics), dtype=bool)
    subscribed[:, 0] = True                      # one global topic
    for t in range(1, n_topics):                 # random subnets
        subscribed[:, t] = rng.random(n_peers) < subnet_fraction
    if topo is None and rows is None:
        topo = topology.sparse_fast(n_peers, k_slots, degree=degree,
                                    seed=SEED)
    elif topo is None:
        topo = topology.sparse_hash(n_peers, k_slots, degree=degree,
                                    seed=SEED, rows=rows)
    return cfg, default_topic_params(n_topics, device=device), topo, \
        subscribed


def frontier(n_peers: int, device=None, **kw
             ) -> tuple[SimConfig, TopicParams, SimState]:
    """Single-process frontier constructor: the full ``init_state`` build
    of :func:`frontier_spec`."""
    cfg, tp, topo, subscribed = frontier_spec(n_peers, device=device, **kw)
    return cfg, tp, init_state(cfg, topo, subscribed=subscribed,
                               device=device)


def frontier_250k(n_peers: int = FRONTIER_NS["frontier_250k"], **kw):
    return frontier(n_peers, **kw)


def frontier_500k(n_peers: int = FRONTIER_NS["frontier_500k"], **kw):
    return frontier(n_peers, **kw)


def frontier_1m(n_peers: int = FRONTIER_NS["frontier_1m"], **kw):
    return frontier(n_peers, **kw)


def frontier_4m(n_peers: int = FRONTIER_NS["frontier_4m"], **kw):
    """XL frontier: compact storage precision by default."""
    kw.setdefault("state_precision", "compact")
    return frontier(n_peers, **kw)


def frontier_10m(n_peers: int = FRONTIER_NS["frontier_10m"], **kw):
    """The 10M-peer frontier: compact storage precision by default; pair it
    with the sharded underlay (``frontier_spec(..., rows=...)``)."""
    kw.setdefault("state_precision", "compact")
    return frontier(n_peers, **kw)


def sybil_small(n_peers: int = 512, k_slots: int = 16, degree: int = 6,
                **kw) -> tuple[SimConfig, TopicParams, SimState]:
    """sybil_100k's 20%-sybil colocation attack at sweep scale."""
    return sybil_100k(n_peers=n_peers, k_slots=k_slots, degree=degree, **kw)


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


# --- the adversary families (sim/adversary.py) ---------------------------
# Five attack/workload families with machine-checkable behaviour contracts
# (delivery floor, recovery ceiling, score response). The registry entries
# below return the plain (cfg, tp, state) triple; the contracts travel on
# adversary.ATTACKS[name](). Lazy imports: adversary imports this module
# for the shared helpers.


def eclipse_small(**kw) -> tuple[SimConfig, TopicParams, SimState]:
    """Sybil mesh takeover of a target region (adversary.eclipse)."""
    from . import adversary
    return tuple(adversary.eclipse(**kw)[:3])


def censor_small(**kw) -> tuple[SimConfig, TopicParams, SimState]:
    """Score-gamed starvation of a victim publisher
    (adversary.censorship)."""
    from . import adversary
    return tuple(adversary.censorship(**kw)[:3])


def flashcrowd_small(**kw) -> tuple[SimConfig, TopicParams, SimState]:
    """Hot-topic publish storm, skewed publishers
    (adversary.flash_crowd)."""
    from . import adversary
    return tuple(adversary.flash_crowd(**kw)[:3])


def slowlink_small(**kw) -> tuple[SimConfig, TopicParams, SimState]:
    """Heterogeneous per-edge delay/drop classes (adversary.slow_link)."""
    from . import adversary
    return tuple(adversary.slow_link(**kw)[:3])


def diurnal_small(**kw) -> tuple[SimConfig, TopicParams, SimState]:
    """Scheduled diurnal join/leave waves (adversary.diurnal)."""
    from . import adversary
    return tuple(adversary.diurnal(**kw)[:3])


def eclipse_50k(n_peers: int = 50_000, k_slots: int = 32, degree: int = 12,
                **kw) -> tuple[SimConfig, TopicParams, SimState]:
    """The eclipse family at bench scale: 50k peers, its window at ticks
    [3, 8) so the attack fires inside a 10-tick measurement."""
    from . import adversary
    kw.setdefault("start", 3)
    kw.setdefault("end", 8)
    return tuple(adversary.eclipse(n_peers=n_peers, k_slots=k_slots,
                                   degree=degree, **kw)[:3])


def flashcrowd_50k(n_peers: int = 50_000, k_slots: int = 32,
                   degree: int = 12, **kw
                   ) -> tuple[SimConfig, TopicParams, SimState]:
    """The flash-crowd family at bench scale (hot set scaled with N)."""
    from . import adversary
    kw.setdefault("start", 3)
    kw.setdefault("end", 8)
    kw.setdefault("hot", 64)
    return tuple(adversary.flash_crowd(n_peers=n_peers, k_slots=k_slots,
                                       degree=degree, **kw)[:3])


# --- the heavy-tailed family (sim/bucketed.py; scenarios.py:479-627) ----
# Truncated power-law degree sequences (topology.powerlaw), run on the
# degree-bucketed layout, so a tick's work and the resting bytes scale
# with the sum of degrees instead of N * D_max. The builders return
# (cfg, tp, BucketedState) for sim.bucketed.bucketed_run, not engine.run,
# so they live in BUCKETED_SCENARIOS, not SCENARIOS.

POWERLAW_NS = {"powerlaw_100k": 131_072, "powerlaw_1m": 1_048_576,
               "powerlaw_10m": 10_485_760}

# Row alignment of a multi-process bucketed run: every bucket boundary
# rounds to a multiple of this, independent of the process count, so the
# partition (and the checkpoint fingerprint) is the same at every count
# dividing it.
POWERLAW_MH_ALIGN = 64


def powerlaw_cfg(n_peers: int, d_min: int = 8, d_max: int = 64,
                 alpha: float = 2.0, n_topics: int = 2,
                 msg_window: int = 64, state_precision: str = "compact",
                 bucketed_rng: str = "bucket",
                 shard_align: int | None = None) -> SimConfig:
    """The heavy-tail SimConfig alone, with no topology build: the bucket
    partition is closed-form (topology.powerlaw_buckets), so the pricing
    sees the bucketed layout before anything is built. ``shard_align``
    rounds the partition for a row-sharded run
    (topology.align_degree_buckets; POWERLAW_MH_ALIGN)."""
    buckets = topology.powerlaw_buckets(n_peers, d_min=d_min, d_max=d_max,
                                        alpha=alpha)
    if shard_align is not None:
        buckets = topology.align_degree_buckets(buckets, shard_align)
    return SimConfig(
        n_peers=n_peers, k_slots=buckets[0][1], n_topics=n_topics,
        msg_window=msg_window, publishers_per_tick=16, prop_substeps=8,
        scoring_enabled=True, behaviour_penalty_weight=-10.0,
        behaviour_penalty_decay=0.999, gossip_threshold=-100.0,
        publish_threshold=-200.0, graylist_threshold=-300.0,
        churn_disconnect_prob=0.002, churn_reconnect_prob=0.2,
        retain_score_ticks=30, state_precision=state_precision,
        degree_buckets=buckets, bucketed_rng=bucketed_rng)


def _powerlaw_subscriptions(n_peers: int, n_topics: int,
                            subnet_fraction: float) -> np.ndarray:
    rng = np.random.default_rng(SEED)
    subscribed = np.zeros((n_peers, n_topics), dtype=bool)
    subscribed[:, 0] = True
    for t in range(1, n_topics):
        subscribed[:, t] = rng.random(n_peers) < subnet_fraction
    return subscribed


def powerlaw_spec(n_peers: int, d_min: int = 8, d_max: int = 64,
                  alpha: float = 2.0, subnet_fraction: float = 0.3,
                  rows: tuple[int, int] | None = None, device=None,
                  topo: topology.Topology | None = None, **cfg_kw,
                  ) -> tuple[SimConfig, TopicParams, topology.Topology,
                             np.ndarray]:
    """The heavy-tail scenario without device state: ``(cfg, tp, topo,
    subscribed)``. ``rows=(start, count)`` builds only that shard of the
    underlay (topology.powerlaw is a pure function of the row id); ``topo``
    is the caller's prebuilt ``topology.powerlaw(n_peers, cfg.k_slots,
    d_min=d_min, d_max=d_max, alpha=alpha, seed=SEED)``."""
    cfg = powerlaw_cfg(n_peers, d_min=d_min, d_max=d_max, alpha=alpha,
                       **cfg_kw)
    subscribed = _powerlaw_subscriptions(n_peers, cfg.n_topics,
                                         subnet_fraction)
    if topo is None:
        topo = topology.powerlaw(n_peers, cfg.k_slots, d_min=d_min,
                                 d_max=d_max, alpha=alpha, seed=SEED,
                                 rows=rows)
    return cfg, default_topic_params(cfg.n_topics, device=device), topo, \
        subscribed


def powerlaw_mh_spec(n_peers: int, d_min: int = 8, d_max: int = 64,
                     alpha: float = 2.0, subnet_fraction: float = 0.3,
                     device=None, **cfg_kw):
    """The multi-process heavy-tail spec: ``(cfg, tp, topo_rows,
    subscribed)``, ``topo_rows(start, count)`` building only those
    underlay rows. The partition is shard-aligned by default
    (POWERLAW_MH_ALIGN)."""
    cfg_kw.setdefault("shard_align", POWERLAW_MH_ALIGN)
    cfg = powerlaw_cfg(n_peers, d_min=d_min, d_max=d_max, alpha=alpha,
                       **cfg_kw)
    subscribed = _powerlaw_subscriptions(n_peers, cfg.n_topics,
                                         subnet_fraction)

    def topo_rows(start: int, count: int) -> topology.Topology:
        return topology.powerlaw(n_peers, cfg.k_slots, d_min=d_min,
                                 d_max=d_max, alpha=alpha, seed=SEED,
                                 rows=(start, count))

    return cfg, default_topic_params(cfg.n_topics, device=device), \
        topo_rows, subscribed


def powerlaw_bucketed(n_peers: int, device=None, **kw):
    """Single-process heavy-tail constructor: (cfg, tp, BucketedState) on
    ``device`` (cuda unless the caller passes ``device="cpu"``)."""
    from . import bucketed
    cfg, tp, topo, subscribed = powerlaw_spec(n_peers, device=device, **kw)
    return cfg, tp, bucketed.init_bucketed_state(
        cfg, topo, device=device, subscribed=subscribed)


def powerlaw_100k(n_peers: int = POWERLAW_NS["powerlaw_100k"], **kw):
    return powerlaw_bucketed(n_peers, **kw)


def powerlaw_1m(n_peers: int = POWERLAW_NS["powerlaw_1m"], **kw):
    return powerlaw_bucketed(n_peers, **kw)


def powerlaw_10m(n_peers: int = POWERLAW_NS["powerlaw_10m"], **kw):
    """The 10M heavy-tailed network, its partition shard-aligned. On one
    process it builds whole. Its row-sharded launch builds only each
    rank's bucket windows (``python -m go_libp2p_pubsub_tpu_torch.
    run_multihost --engine bucketed --topology sharded --scenario
    powerlaw_10m``: :func:`powerlaw_mh_spec` and
    ``parallel/multihost.init_bucketed_local``), priced per bucket shard
    by ``state.state_nbytes(cfg, n_ranks)``; it needs more than one
    card."""
    kw.setdefault("shard_align", POWERLAW_MH_ALIGN)
    return powerlaw_bucketed(n_peers, **kw)


def heavytail_eclipse(n_peers: int = POWERLAW_NS["powerlaw_100k"],
                      start: int = 3, end: int = 8,
                      sybil_fraction: float = 0.1, device=None, **kw):
    """Hub-targeted eclipse on the heavy-tailed underlay: the power law
    puts the hubs at the low ids, the contiguous region EclipseWindow
    targets, so the window's fraction covers the hub bucket and the
    sybils are drawn from the tail. Cutting the hub bucket severs the
    underlay's high-degree core."""
    import dataclasses

    from . import bucketed
    from .faults import EclipseWindow
    cfg, tp, topo, subscribed = powerlaw_spec(n_peers, device=device, **kw)
    n_hub = cfg.degree_buckets[0][0]
    rng = np.random.default_rng(SEED)
    malicious = np.zeros(n_peers, dtype=bool)
    tail = np.arange(n_hub, n_peers)
    malicious[rng.choice(tail, size=min(len(tail),
                                        int(sybil_fraction * n_peers)),
                         replace=False)] = True
    cfg = dataclasses.replace(cfg, fault_plan=FaultPlan(eclipses=(
        EclipseWindow(start, end, fraction=n_hub / n_peers),)))
    return cfg, tp, bucketed.init_bucketed_state(
        cfg, topo, device=device, subscribed=subscribed,
        malicious=malicious)


BUCKETED_SCENARIOS = {
    "powerlaw_100k": powerlaw_100k,
    "powerlaw_1m": powerlaw_1m,
    "powerlaw_10m": powerlaw_10m,
    "heavytail_eclipse": heavytail_eclipse,
}


# name -> builder, the reference's registry (scenarios.py:628-650): the
# names crash dumps stamp and replay_crash.py rebuilds a run from
SCENARIOS = {
    "1k_single_topic": single_topic_1k,
    "10k_beacon": beacon_10k,
    "50k_churn": churn_50k,
    "100k_sybil": sybil_100k,
    "50k_partition": partition_50k,
    "10k_outage": outage_10k,
    "sybil_small": sybil_small,
    "partition_small": partition_small,
    "outage_small": outage_small,
    "eclipse_small": eclipse_small,
    "censor_small": censor_small,
    "flashcrowd_small": flashcrowd_small,
    "slowlink_small": slowlink_small,
    "diurnal_small": diurnal_small,
    "eclipse_50k": eclipse_50k,
    "flashcrowd_50k": flashcrowd_50k,
    "frontier_250k": frontier_250k,
    "frontier_500k": frontier_500k,
    "frontier_1m": frontier_1m,
    "frontier_4m": frontier_4m,
    "frontier_10m": frontier_10m,
}
