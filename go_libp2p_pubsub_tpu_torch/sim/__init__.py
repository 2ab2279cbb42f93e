"""The batched simulation engine (PyTorch port): config, state, topology,
the step, and :func:`build_headline`, the port's copy of the reference's
headline network builder (``__graft_entry__._build``)."""

from __future__ import annotations

from . import scenarios, topology  # noqa: F401
from .config import SimConfig, TopicParams, with_score_weights  # noqa: F401
from .state import (  # noqa: F401
    SimState,
    check_hbm_budget,
    decode_state,
    encode_state,
    init_state,
    state_from_reference,
    state_nbytes,
    state_spec,
    state_to_numpy,
)

_ENGINE_EXPORTS = ("choose_publishers", "delivery_fraction",
                   "delivery_latency_ticks", "mesh_degrees", "run",
                   "run_checked", "run_checked_keys", "run_keys",
                   "run_window", "step", "window_keys")


def __getattr__(name):
    # engine depends on ops/, which depends back on sim.config — the lazy
    # import keeps `import go_libp2p_pubsub_tpu_torch.ops.heartbeat`
    # cycle-free, as in the reference's sim/__init__.py
    if name in _ENGINE_EXPORTS:
        from . import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def build_headline(n_peers: int, k_slots: int = 32, degree: int = 12,
                   msg_window: int = 64, publishers: int = 8, device=None,
                   topo: "topology.Topology | None" = None):
    """(cfg, tp, state) of the headline network on ``device`` (cuda unless
    the caller passes ``device="cpu"``): single-topic gossipsub with scoring
    on (``__graft_entry__._build``), on the fused kernels
    (``hop_mode="pallas"``, ``edge_gather_mode="pallas"``). ``topo`` may
    carry a prebuilt ``topology.sparse(n_peers, k_slots, degree=degree)``."""
    from ..core.params import TopicScoreParams

    cfg = SimConfig(
        n_peers=n_peers, k_slots=k_slots, n_topics=1, msg_window=msg_window,
        publishers_per_tick=publishers, prop_substeps=8,
        scoring_enabled=True, behaviour_penalty_weight=-10.0,
        behaviour_penalty_decay=0.999, gossip_threshold=-100.0,
        publish_threshold=-200.0, graylist_threshold=-300.0,
        hop_mode="pallas", edge_gather_mode="pallas")
    topics = [TopicScoreParams(
        topic_weight=1.0, time_in_mesh_weight=0.01, time_in_mesh_quantum=1.0,
        time_in_mesh_cap=3600.0, first_message_deliveries_weight=1.0,
        first_message_deliveries_decay=0.5, first_message_deliveries_cap=100.0,
        mesh_message_deliveries_weight=-1.0, mesh_message_deliveries_decay=0.5,
        mesh_message_deliveries_cap=100.0, mesh_message_deliveries_threshold=2.0,
        mesh_message_deliveries_window=0.01, mesh_message_deliveries_activation=5.0,
        mesh_failure_penalty_weight=-1.0, mesh_failure_penalty_decay=0.5,
        invalid_message_deliveries_weight=-10.0, invalid_message_deliveries_decay=0.9)]
    tp = TopicParams.from_topic_params(topics, device=device)
    if topo is None:
        topo = topology.sparse(n_peers, k_slots, degree=degree)
    return cfg, tp, init_state(cfg, topo, device=device)
