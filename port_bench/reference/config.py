"""Static configuration for the batched simulation engine (PyTorch port).

``SimConfig`` is a field-for-field copy of the JAX package's
``sim/config.SimConfig``, so a reference config converts with
``SimConfig(**dataclasses.asdict(ref_cfg))``. Its comments are the
reference's own; the port runs the subset of knobs its engine implements
(sim/engine.step raises NotImplementedError for the rest).

How the port resolves the formulation knobs (ops/hopkernel.
resolve_hop_mode / resolve_emit_mode, ops/permgather.resolve_mode /
resolve_words_mode / resolve_edge_packed_mode, ops/selection.
resolve_selection_mode; ``ops.dispatch.resolved_formulations(cfg)`` lists
what each seam runs). ``"auto"`` ranks the candidates through
ops/dispatch.py under its ``"cuda"`` table entry on every device, so the
CPU runs the formulation the card runs; an explicit mode is taken where it
can run:

- ``hop_mode``: ``"auto"``, ``"pallas"`` and ``"pallas-mxu"`` take the fused
  hop and IWANT-resolve kernels when ``_hop_config_ok(cfg)`` holds (no
  gater, queue caps, provenance, flood publish or fault inputs) and the
  shapes fit the kernels (``_fused_shape_ok``: W = ceil(msg_window / 32)
  <= 8 and (2 n_topics + 1) k_slots <= 32768), and the non-fused data path
  of ops/propagate.py otherwise; the IHAVE emit is the fused kernel under
  all three wherever W <= 8, whatever the rest of the config. ``"xla"``
  takes the non-fused resolve, hops and emit. ``"pallas-mxu"`` differs
  from ``"pallas"`` in the reference only by its in-kernel gather, so on
  Hopper it runs the same kernels.
- ``edge_gather_mode`` (the packed edge exchanges, the words gathers and
  the payload permute): ``"auto"`` and ``"pallas"`` take the kernels
  ``edge_table``, ``gather_words`` and ``permutation_gather``; ``"mxu"``
  the flat take ``take_words``; ``"scalar"`` the indexed gathers;
  ``"rows"`` the row gathers; ``"sort"`` one sort permutation of the
  ``edge_sort_key`` destination keys per exchange. Under ``"sort"`` and
  ``"mxu"`` the IWANT answer table rides the heartbeat's last exchange
  when the resolve is non-fused.
- ``selection_mode``: ``"auto"`` and ``"ranks"`` take the comparison-count
  rank; ``"sort"`` the per-row sort and threshold; ``"iter"`` the
  ``max_count`` argmax passes (each call site passes the reference's
  bound). The three select the same slots.

``TopicParams`` holds the per-topic score parameters as [T]-shaped float32
tensors on the run's device (score_params.go:117-170 vectorized over topics).

All durations are expressed in heartbeat ticks: DecayInterval (1s default)
== HeartbeatInterval == 1 tick (score_params.go:401).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from .params import GossipSubParams, PeerScoreThresholds, TopicScoreParams
from .device import resolve_device


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Jit-static simulation shape + gossipsub knobs (in ticks)."""

    n_peers: int
    k_slots: int              # max neighbors per peer (adjacency capacity)
    n_topics: int = 1
    msg_window: int = 128     # active message slots (rotating)
    publishers_per_tick: int = 4
    # router variant: "gossipsub" (mesh), "floodsub" (all topic peers,
    # floodsub.go:76-100), "randomsub" (random max(D, sqrt N), randomsub.go:99-160)
    router: str = "gossipsub"
    # WithFloodPublish (gossipsub.go:321-327): a publisher sends its OWN
    # messages to every topic peer it scores >= publish_threshold, not just
    # its mesh (gossipsub.go:989-1004); forwarding stays mesh-only
    flood_publish: bool = False
    prop_substeps: int = 8    # intra-tick forwarding hops (mesh diameter bound)

    # overlay degree bounds (gossipsub.go:32-40)
    d: int = 6
    dlo: int = 5
    dhi: int = 12
    dscore: int = 4
    dout: int = 2
    dlazy: int = 6
    gossip_factor: float = 0.25

    # windows, in ticks (gossipsub.go:37-58 durations / 1s heartbeat)
    history_length: int = 5
    history_gossip: int = 3
    fanout_ttl_ticks: int = 60
    prune_backoff_ticks: int = 60
    unsubscribe_backoff_ticks: int = 10
    opportunistic_graft_ticks: int = 60
    opportunistic_graft_peers: int = 2
    graft_flood_ticks: int = 10
    # IHAVE flood protection (gossipsub.go:57-58, 654-676): cap on message
    # ids a peer will IWANT per heartbeat (the ``iasked`` counter vs
    # MaxIHaveLength; counters reset every tick, gossipsub.go:1608-1618)
    max_iwant_per_tick: int = 5000

    # score thresholds (score_params.go:12-35)
    gossip_threshold: float = 0.0
    publish_threshold: float = 0.0
    graylist_threshold: float = 0.0
    accept_px_threshold: float = 0.0
    opportunistic_graft_threshold: float = 0.0

    # global score params (score_params.go:66-115)
    topic_score_cap: float = 0.0
    app_specific_weight: float = 0.0
    ip_colocation_factor_weight: float = 0.0
    ip_colocation_factor_threshold: int = 1
    n_ip_groups: int = 1      # static bound for colocation bincount
    behaviour_penalty_weight: float = 0.0
    behaviour_penalty_threshold: float = 0.0
    behaviour_penalty_decay: float = 0.999
    decay_to_zero: float = 0.01
    retain_score_ticks: int = 0

    # P3 window in ticks; default 10ms << 1 tick -> same-round only
    mesh_message_deliveries_window_ticks: int = 0

    scoring_enabled: bool = True

    # reverse-edge permutation gather formulation (ops/permgather.py):
    # "auto" (measured cost-model dispatch, ops/dispatch.py) | "scalar" |
    # "rows" | "sort" | "pallas" | "mxu" — "mxu" routes EVERY gather
    # through the gather-free two-level MXU take (ops/mxutake.py): the
    # word tables (hop gathers, the packed edge exchange via its
    # bit-table, the IWANT answer table riding the exchange as extra word
    # rows) AND the generic [N, K] payload permute (the blocked one-hot
    # take) — zero serialized scalar HBM gathers, the one formulation the
    # Mosaic 128-lane gather wall cannot block. "auto" ranks candidates
    # by the dispatch table (GRAFT_DISPATCH_TABLE loads a calibrated one;
    # the shipped default reproduces the measured sort-era picks)
    edge_gather_mode: str = "auto"

    # masked selection formulation (ops/selection.py):
    # "auto" (cost-model dispatch) | "ranks" | "sort" | "iter"
    selection_mode: str = "auto"

    # forwarding-hop formulation (ops/hopkernel.py): "auto" | "xla" |
    # "pallas" | "pallas-mxu" — the fused Pallas hop needs cap-free/
    # gater-free/provenance-free configs and falls back to the XLA hop
    # otherwise; "auto" ranks through ops/dispatch.py (xla everywhere
    # under the shipped conservative table: the Mosaic gather wall
    # quarantines "pallas", and "pallas-mxu" is priced at its streamed
    # worst case until a live window calibrates). "pallas-mxu" is the
    # fused design with the in-kernel gathers rewritten as the
    # gather-free two-level one-hot select (ops/mxutake.py) — the S1-S7
    # resurrection candidate; any peer count works (out-of-kernel pad
    # seam), subject to the VMEM block gates (GRAFT_HOP_MODE sweep knob)
    hop_mode: str = "auto"

    # sort-mode routing under a sharded step (parallel/halo.py):
    # "replicated" lowers the global sorts via all-gathers (correct,
    # unscaled); "halo" routes per-shard with one all_to_all of padded
    # buckets (scales with devices; capacity-factor assumption on random
    # underlays, overflow poisons rather than drops)
    sharded_route: str = "replicated"
    # halo bucket capacity over the uniform mean (parallel/halo.py
    # CAPACITY RULE). 4 covers random underlays ~3x over their measured
    # worst bucket; clustered underlays must set this to
    # halo.required_capacity_factor(neighbors, reverse_slot, n_dev)
    halo_capacity_factor: int = 4

    # dtype of the per-hop delivery-event count accumulators
    # (ops/propagate.py, PERF_MODEL.md S3): "uint8" minimizes HBM bytes;
    # "int32" trades 4x bytes for native 32-bit vector ops — TPU emulates
    # sub-word lanes with masking, a live-window ablation candidate for
    # the ~16 ms/hop of non-gather math. Trajectories are bit-identical
    # either way (counts are bounded by msg_window and land in f32).
    count_dtype: str = "uint8"

    # record delivery provenance (msg_publisher / deliver_from) so a run can
    # be exported as a pb/trace event stream (sim/trace_export.py); when on
    # it costs a bit-plane decode + two scatters per tick, when off
    # deliver_from is a dormant buffer no hot-path op touches
    record_provenance: bool = False

    # --- peer gater (peer_gater.go:19-116), ticks domain; off by default so
    # non-gater configs compile the same op graph (RNG streams shifted by
    # the extra key splits, so trajectories differ from round-1 builds) ---
    gater_enabled: bool = False
    gater_threshold: float = 0.33          # throttled/validated RED trigger
    gater_global_decay: float = 0.9928     # ScoreParameterDecay(2 min) @ 1s ticks
    gater_source_decay: float = 0.999808   # ScoreParameterDecay(1 hour)
    gater_quiet_ticks: int = 60            # auto-off after quiet period
    gater_duplicate_weight: float = 0.125
    gater_ignore_weight: float = 1.0
    gater_reject_weight: float = 16.0
    # validation pipeline admission cap (validation.go:13-17 queue sizes):
    # max NEW messages a receiver admits per tick; excess is throttled —
    # dropped unseen and counted into the gater's throttle stat
    # (validation.go:246-260 Push drop-on-full). 0 = unbounded.
    validation_queue_cap: int = 0
    # fraction of honest publishes whose validation verdict is IGNORE
    # (validation.go:344-370 ValidationIgnore: dropped + marked seen, no P4)
    ignore_fraction: float = 0.0
    # per-edge data-plane capacity (comm.go:156-191: the 32-RPC per-peer
    # queue, drop-on-full traced at gossipsub.go:1195-1202): max messages an
    # edge carries per tick; a hop whose RPC would blow the budget is dropped
    # whole (the reference drops entire RPCs). 0 = unbounded.
    edge_queue_cap: int = 0

    # connection churn per tick (0.0 = off; ops/churn.py). Models the
    # dead-peer / reconnect lifecycle (pubsub.go:711-757, notify.go:11-75).
    churn_disconnect_prob: float = 0.0
    churn_reconnect_prob: float = 0.0
    # PX-seeded reconnects (gossipsub.go:893-973 pxConnect): a down edge
    # whose remote side the reconnecting peer scores >= accept_px_threshold
    # reconnects at churn_reconnect_prob (a PX referral re-seeds the dial);
    # below-threshold edges fall back to px_low_score_factor of that rate
    # (no referral — only slow ambient discovery brings them back).
    px_enabled: bool = False
    px_low_score_factor: float = 0.1
    # forced redial cadence for direct peers (gossipsub.go:1648-1670), ticks
    direct_connect_ticks: int = 300
    # subscription churn per tick (0.0 = off): peers Leave topics (PRUNE all
    # mesh members with the unsubscribe backoff, gossipsub.go:1104-1124) and
    # Join them back (promoting live fanout edges, gossipsub.go:1047-1102)
    sub_leave_prob: float = 0.0
    sub_join_prob: float = 0.0

    # declarative fault injection (sim/faults.py FaultPlan): link drop/
    # duplication, partition + outage tick schedules, honest-publish
    # corruption — applied by engine.step each tick. None (default)
    # compiles the identical plan-free program with the identical RNG
    # stream; the plan is frozen/hashable, so it rides the jit-static
    # config like every other knob
    fault_plan: object | None = None
    # invariant sentinel escalation (sim/invariants.py): "record" ORs
    # injected-fault + violation bits into SimState.fault_flags each tick
    # (default — the flags travel with every bench line); "raise"
    # additionally escalates violations via jax.experimental.checkify
    # (callers must use engine.run_checked); "off" skips checks and flag
    # writes entirely
    invariant_mode: str = "record"
    # per-tick key derivation schedule: "host" pre-splits ONE
    # master key into [n_ticks] per-tick keys on the host and ships the
    # window in (the historical discipline — kept as default because
    # fold_in provably CANNOT reproduce the split tree's streams);
    # "fold_in" derives each tick's key inside the scan as
    # jax.random.fold_in(master, state.tick) — no host pre-split, no
    # shipped [C, 2] key window, and chunking-invariance/resume-
    # consistency by construction (the key depends only on the master
    # and the ABSOLUTE tick the state carries). Parity is pinned PER
    # schedule (tests/test_overlap.py); the schedules' trajectories
    # intentionally differ from each other.
    key_schedule: str = "host"
    # stored precision of the scan carry (sim/state.py codec tables):
    # "f32" keeps the historical layout bit-exact; "compact" stores the
    # f32 score-counter planes as bf16 bit patterns (u16), the bounded
    # tick planes as i16 relative-to-current-tick, the [N,*,K] bool
    # planes bit-packed into u32 words (the `have` discipline), and the
    # slot-index planes as i8 — compute stays f32/i32: engine.step
    # decodes at entry and re-encodes at exit, so ops never see the
    # narrow types. Roughly halves the per-peer HBM bytes (PERF_MODEL
    # "Frontier memory budget"); trajectories agree within the
    # documented tolerance (tests/test_state_precision.py)
    state_precision: str = "f32"
    # exact halo bucket capacity (entries per (src_dev, dest_dev)
    # bucket). 0 = derive from halo_capacity_factor's uniform-degree
    # rule; a positive value (e.g. halo.required_bucket_capacity's
    # answer for a heavy-tailed underlay) overrides the factor rule so
    # clustered topologies neither overflow nor over-allocate
    halo_bucket_capacity: int = 0
    # degree-bucketed edge planes (sim/bucketed.py): peers are
    # partitioned host-side at topology build into contiguous id-ordered
    # degree classes, ``((n_rows, k_ceil), ...)`` with Σ n_rows ==
    # n_peers and k_slots == the first (hub) bucket's ceiling; every
    # [N, K]-adjacent edge plane is stored per bucket padded only to
    # that bucket's ceiling, and the per-edge ops run once per bucket at
    # the bucket's width — per-tick cost and resting HBM scale with the
    # true edge count ΣD = Σ_b n_rows_b·k_ceil_b instead of N·D_max.
    # None (default) is the dense-uniform fast path: byte-identical
    # state layout, HLO, and RNG stream to every pre-bucketing build.
    # topology.powerlaw_buckets derives the partition a powerlaw graph
    # induces.
    degree_buckets: tuple | None = None
    # RNG discipline for the bucketed step's K-shaped draws (selection
    # noise, churn, gater, link faults): "dense" draws them at the full
    # [N, ..., k_slots] shape and slices per bucket — the bucketed
    # trajectory is then BIT-EXACT vs the dense-padded reference on the
    # same graph (what tests/test_bucketed.py pins), at dense-RNG cost;
    # "bucket" folds the bucket index into the key and draws at bucket
    # width — ΣD-scaling cost (the perf configuration), statistically
    # equivalent but a different stream, so trajectories diverge from
    # the dense reference. Ignored when degree_buckets is None.
    bucketed_rng: str = "dense"

    @staticmethod
    def from_params(n_peers: int, k_slots: int, n_topics: int = 1,
                    params: GossipSubParams | None = None,
                    thresholds: PeerScoreThresholds | None = None,
                    **overrides) -> "SimConfig":
        p = params or GossipSubParams()
        th = thresholds or PeerScoreThresholds()
        hb = p.heartbeat_interval
        kw = dict(
            n_peers=n_peers, k_slots=k_slots, n_topics=n_topics,
            d=p.d, dlo=p.dlo, dhi=p.dhi, dscore=p.dscore, dout=p.dout,
            dlazy=p.dlazy, gossip_factor=p.gossip_factor,
            history_length=p.history_length, history_gossip=p.history_gossip,
            fanout_ttl_ticks=max(1, int(p.fanout_ttl / hb)),
            prune_backoff_ticks=max(1, int(p.prune_backoff / hb)),
            unsubscribe_backoff_ticks=max(1, int(p.unsubscribe_backoff / hb)),
            opportunistic_graft_ticks=int(p.opportunistic_graft_ticks),
            opportunistic_graft_peers=p.opportunistic_graft_peers,
            graft_flood_ticks=max(1, int(p.graft_flood_threshold / hb)),
            max_iwant_per_tick=p.max_ihave_length,
            gossip_threshold=th.gossip_threshold,
            publish_threshold=th.publish_threshold,
            graylist_threshold=th.graylist_threshold,
            accept_px_threshold=th.accept_px_threshold,
            opportunistic_graft_threshold=th.opportunistic_graft_threshold,
        )
        kw.update(overrides)
        return SimConfig(**kw)



class TopicParams(NamedTuple):
    """[T]-shaped per-topic score parameters (score_params.go:117-170)."""

    topic_weight: torch.Tensor
    time_in_mesh_weight: torch.Tensor
    time_in_mesh_quantum_ticks: torch.Tensor   # >=1, integer ticks
    time_in_mesh_cap: torch.Tensor
    first_message_deliveries_weight: torch.Tensor
    first_message_deliveries_decay: torch.Tensor
    first_message_deliveries_cap: torch.Tensor
    mesh_message_deliveries_weight: torch.Tensor
    mesh_message_deliveries_decay: torch.Tensor
    mesh_message_deliveries_cap: torch.Tensor
    mesh_message_deliveries_threshold: torch.Tensor
    mesh_message_deliveries_activation_ticks: torch.Tensor
    mesh_failure_penalty_weight: torch.Tensor
    mesh_failure_penalty_decay: torch.Tensor
    invalid_message_deliveries_weight: torch.Tensor
    invalid_message_deliveries_decay: torch.Tensor

    @staticmethod
    def from_topic_params(topics: list[TopicScoreParams],
                          heartbeat_interval: float = 1.0,
                          device=None) -> "TopicParams":
        """Pack a list of per-topic params into [T] float32 tensors (ticks
        domain), with the reference's float32 rounding of every value."""
        hb = heartbeat_interval
        getters = [
            lambda t: t.topic_weight,
            lambda t: t.time_in_mesh_weight,
            lambda t: max(t.time_in_mesh_quantum / hb, 1e-9),
            lambda t: t.time_in_mesh_cap,
            lambda t: t.first_message_deliveries_weight,
            lambda t: t.first_message_deliveries_decay if t.first_message_deliveries_decay else 1.0,
            lambda t: t.first_message_deliveries_cap if t.first_message_deliveries_cap else math.inf,
            lambda t: t.mesh_message_deliveries_weight,
            lambda t: t.mesh_message_deliveries_decay if t.mesh_message_deliveries_decay else 1.0,
            lambda t: t.mesh_message_deliveries_cap if t.mesh_message_deliveries_cap else math.inf,
            lambda t: t.mesh_message_deliveries_threshold,
            lambda t: t.mesh_message_deliveries_activation / hb,
            lambda t: t.mesh_failure_penalty_weight,
            lambda t: t.mesh_failure_penalty_decay if t.mesh_failure_penalty_decay else 1.0,
            lambda t: t.invalid_message_deliveries_weight,
            lambda t: t.invalid_message_deliveries_decay if t.invalid_message_deliveries_decay else 1.0,
        ]
        mat = torch.from_numpy(np.array([[g(t) for t in topics] for g in getters],
                                        dtype=np.float32))
        mat = mat.to(resolve_device(device))
        return TopicParams(*mat)

    @staticmethod
    def disabled(n_topics: int, device=None) -> "TopicParams":
        """All-zero-weight params (scoring effectively off) for T topics."""
        return TopicParams.from_topic_params(
            [TopicScoreParams(skip_atomic_validation=True, time_in_mesh_quantum=1.0)
             for _ in range(n_topics)], device=device)


