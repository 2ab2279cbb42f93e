#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # the whole check, on cuda:0

Phases, each printing its own lines and its seconds:

1. build: the card's name and power limit (nvidia-smi), then one nvcc per
   CUDA source of go_libp2p_pubsub_tpu_torch/csrc, all in parallel;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes: the fused kernels at N=102400, K=32, T=1, M=64
   plus a T=3 case, an emit case with budget 5 < M and a resolve case with
   nothing pending; the gathers at the churn path's N=51200 (the bit-table
   exchange at the churn path's B=8 and B=4 planes, words gather also at
   102400, payload permute with int32 and float32 payloads, flat take at
   each of its call shapes, at W = 1 and 3 and at an R that is no multiple
   of 1024; the words gather also at K = 383, 384, 512 and 1000 slots, one
   and several staged chunks of nbr, at N=8192, W=2; the payload permute
   also at an N*K that is no multiple of 4 and with jn, rk and out 4 bytes
   past a 16-byte boundary); the selections' ``select_rows`` in each mode
   (random, noise, top, median) at [102400, 1, 32] and [51200, 4, 32]
   against ``select_random_plain``, ``select_top_plain`` and
   ``masked_median_plain``, and random also with counts on 10% of rows,
   as most heartbeat calls see them. Beside each words gather and
   take, on its print line only: the 32-byte L2 sectors that one lookup's
   table row spans, computed from the indices and the row width (not
   measured), and that sector traffic over the measured time. Equality is
   exact (bit for bit). Times are device times by CUDA events: 20 calls
   queued back to back behind a spin kernel (so the host's enqueue time is
   hidden), median of 5 such rounds (a call whose first run takes over
   2 ms, as the plain versions at the full shapes do: one call a round,
   median of 3 rounds); ``library_ms`` times the one PyTorch
   indexing call that computes a gather, on int64 indices, the same way
   (the faster of two such calls where there are two);
3. main path: ``build_headline(102400)`` and 8 ticks of ``run``, with the
   kernels' launch counts reset just before and read just after; then one
   more tick whose heartbeat edge_table calls (B = 2, 1, 2) and whose
   iwant_resolve, hop and emit calls are recorded, and the four kernels
   checked and timed as in phase 2 on that tick's real inputs (the
   network's own neighbours, reverse slots, planes and pend rows; the hop
   whose frontier holds the most bits), with the share of slots whose
   plane allows a topic (the lookups the kernels make) and the share of
   pend rows holding a pending message printed beside; then the pull
   path: two ticks with ``prop_substeps=1`` from that state, the second
   one's iwant_resolve checked and timed on its real inputs;
3b. churn path: ``scenarios.churn_50k(n_peers=51200)`` (gater, validation
   queue cap 64, connection churn with PX; the non-fused data path): first
   the words gather, the take, the bit-table exchange (B = 8 and 4) and
   the payload permute checked and timed as in phase 2 on the built
   state's own neighbour indices and reverse slots, then 8 ticks with
   ``hop_mode="xla"`` under ``edge_gather_mode="pallas"`` and under
   ``"mxu"``, each twice, in turns, from copies of one initial state
   and one key, the counts reset before and read after each run; every
   run's final state must equal the first's in every field;
3c. wide window: ``build_headline(4096, msg_window=288)`` (W = 9 words,
   beyond the fused kernels' 8; int32 hop counts, which a window above 255
   needs) under the builder's ``hop_mode="pallas"``: 4 ticks of ``step``
   on the card with the counts reset before and read after; the resolvers
   route it to the non-fused path, so hop, iwant_resolve and emit must not
   launch and edge_table and gather_words must; clean fault flags, some
   deliveries, and the state equal to the port's CPU run after every tick
   (as phase 4 compares); then one more tick whose edge_table calls and
   words gathers (W = 9 rows) are recorded, and each checked and timed as
   in phase 2 on that tick's real inputs;
3d. the data plane: six paths, 8 ticks of ``step`` each with the counts
   reset before and read after: ``router_sweep_100k("floodsub")`` and
   ``("randomsub")`` at 102400 peers (no heartbeat), the headline with
   ``flood_publish=True`` (102400, non-fused), ``partition_50k(51200,
   start=2, heal=6)``, the same network under the combined plan of
   tests/test_faults.py (link drop 0.2, corruption 0.5, a partition on
   ticks [2, 5); non-fused) and ``outage_10k(10240, start=2, heal=6)``;
   each prints hb/s, delivery, the edges down after every tick and its
   launches, and must set exactly its plan's fault bits with no violation
   bit, and (partition, combined plan, outage) take edges down and bring
   them back; then one more tick whose every kernel call is recorded,
   checked against its plain version and timed as in phase 2;
3e. the BASELINE configs at full size, 8 ticks of ``run`` each with the
   counts reset before and read after: ``single_topic_1k(1024)``,
   ``beacon_10k(10240)`` (T = 9 topics, K = 48 slots: the fused kernels'
   K > 32 branches and 27-word bit-table rows), the same beacon network
   with attestation-subnet rotation (subscription churn at 0.01 a tick, a
   stress rate, not the chain's real rotation) and ``sybil_100k(102400)``
   (churn with PX); each prints hb/s, delivery and its launches and must
   end with fault_flags 0; the rotation prints the subscriptions left and
   joined, sybil the share of honest peers' mesh edges that point at
   sybils after ticks 1 and 8; then one more tick whose every kernel call
   is recorded, checked and timed as in phase 3d;
3f. the frontier at full size and the formulations: ``frontier_1m()``
   (1,048,576 peers on ``topology.sparse_fast(n, 32, degree=8)``, T = 2,
   M = 64, 16 publishers, scoring on, ``edge_gather_mode="sort"`` over the
   fused hop, resolve and emit), 8 ticks of ``run`` with hb/s, delivery,
   fault_flags (must be 0), the peak device memory beside the state's
   bytes and its launches (hop, iwant_resolve and emit must launch, no
   gather kernel may), then one more tick whose every kernel call is
   recorded, checked and timed as in phase 3d; then the headline network
   at 102400 under ``edge_gather_mode="sort"``, ``hop_mode="xla"`` (what
   the reference's shipped table resolves to on a TPU: no hand kernel may
   launch, and the IWANT answer table must ride the heartbeat's last
   exchange every tick), 8 ticks; then, at both networks' shapes, each
   formulation of the payload permute, the words gather and the packed
   exchange (``rows`` up to 102400 peers only) and each selection
   formulation timed by CUDA events (5 calls behind a spin kernel, median
   of 5 rounds), every output equal to the ``pallas`` (``ranks``) one at
   the valid slots;
3g. compact storage (``state_precision="compact"``), telemetry and
   checkpoints: the headline (102400, kernels 1-4) in f32 and compact from
   one build, 8 ticks of ``run_keys`` each, twice, in turns (hb/s, peak
   memory, the compact runs' launches against their set, the stored
   bytes equal to ``state_nbytes``), the codec's device time (decode,
   encode, the encode's ``pack_bool``) beside the tick's; 8 ticks with the
   telemetry lane, its last record equal to ``health_record`` of the
   final state; a ``.npz`` checkpoint after tick 4, restored and run 4
   more ticks, equal to the 8 uninterrupted ticks; then compact
   ``frontier_1m`` (kernels 1-3) with telemetry, its stored bytes, peak
   memory, hb/s and codec share; then ``frontier_4m`` and
   ``frontier_10m`` priced under both precisions against the card's
   memory (``check_hbm_budget``), not allocated;
4. the card's 8-tick trajectory at 1024 peers against the port's CPU run
   (plain versions): integer, bool and packed fields equal, float32 fields
   within rtol 1e-6, checked after every tick (the CPU runs of 4, 4b, 4c,
   4d and 4e in a child process started with the underlay builds, sent
   back as per-tick fingerprints); then the same network
   under compact storage, each tick decoded, stepped and encoded on both
   devices: int8, int16 and packed planes exact, each bf16 plane exact
   where the float32 inputs to its encode agree bitwise and within one
   bf16 ulp where they differ (within rtol 1e-6);
4b. the same for ``churn_50k(n_peers=1024)`` with the validation queue cap
   cut to 4 (throttle and RED drop live), under both gather formulations;
4c. the same for the data plane's branches at 1024 peers: floodsub,
   randomsub, flood publish, edge caps with provenance and the gater, and
   a plan of every fault family (link drop, duplication, slow links,
   corruption, partition, outage, eclipse, wave, censor, storm);
4d. the same for ``beacon_10k(1024)`` with subscription churn (0.02 a tick)
   and ``sybil_small(1024)``; then ``single_topic_1k(1024)`` under
   ``key_schedule="fold_in"``, tick by tick (``run_window`` of one tick)
   on the card against the CPU, two ``run_window`` chunks (3 + 5) and one
   8-tick ``run`` on the card equal to it exactly; then ``run_checked``
   under ``invariant_mode="raise"``: a clean run passes, and a state
   poisoned with an infinite ``mesh_failure_penalty`` raises on the card
   with the violation bits and tick it raises with on the CPU;
4e. the same for the formulations at 1024 peers: ``frontier(1024)`` under
   its sort exchanges, the headline's non-fused path under ``scalar``,
   ``rows`` and ``sort`` with flood publish, ``churn_50k(1024)`` under
   ``sort``, and the headline under ``selection_mode="iter"`` and
   ``"sort"``;
5. captured chunks (parallel/compile_plan.py): the paths phases 3-3g
   left states for (the headline, the compact headline, churn under
   ``pallas`` and ``mxu``, single_topic_1k, beacon_10k, sybil_100k, the
   combined fault plan on the non-fused hop, frontier_1m and compact
   frontier_1m last; the compact paths with the telemetry lane, whose C
   records the replay must equal too, and the compact headline also
   without it, for the lane's cost), each from that state: one
   eager tick under ``torch.cuda.set_sync_debug_mode("error")`` (it must
   not raise), then 8 eager ticks of ``run_keys`` and a donated
   ``engine_chunk`` of C = 8 (on the headline also ``run_window`` against
   ``engine_window``) replayed from the same state and keys, every field
   equal exactly; eager and captured hb/s by CUDA events, the
   synchronizations each makes (sync debug mode "warn") and the peak
   device memory of each, and the kernels recorded into the graph,
   counted at capture time, against the path's set (busy shares:
   go_libp2p_pubsub_tpu_torch/profile_step.py --captured). The eager run's cached blocks
   are released before each capture (at 1,048,576 peers two pools would
   not fit);
6. the supervised and fleet planes (sim/supervisor.py, sim/fleet.py):
   6a the headline under ``supervised_run`` (16 ticks in chunks of 8,
   journal and async pipeline): with no checkpoint and with one at every
   chunk, kill and resume, a deadline overrun retried on a halved chunk
   (the card's ladder keeps the kernels), a crash dump replayed on the
   card, each equal to the eager ``run_keys`` in every field (and
   journal row); 6b bench.py's fleet_256x1k (256
   ``single_topic_1k(1024)`` members, 8 ticks of ``fleet_run``): four
   members equal to their own ``run``, the window's executable (one
   member's graph replayed over the members) against 256 sequential
   ``engine_chunk`` replays, capture seconds, recorded launches, peak
   memory; 6c eight members of mixed tick counts, one raise-mode and
   poisoned, under ``supervised_fleet_run`` with checkpoints, each equal
   to its own card run and the poisoned one frozen where it retired, one
   fleet executable per window length. Runs without an
   injected failure must report no retry and no degrade and record
   kernels 1-4. 6b and 6c run right after phase 2, while the underlays
   build; 6a after phase 5;
7. adversaries, directives and traces (sim/adversary.py, sim/commands.py,
   sim/trace_export.py, trace/replay.py), after 6a: 7a the five attack
   families at 512 peers (K = 16) through ``run_with_contracts`` on the
   card, each tick's state and health row and every contract result equal
   to a CPU run of the port (integer, bool and packed planes exact,
   float32 rtol 1e-6, ``score_mean`` rtol 1e-5; the CPU side runs in a
   child process started with the underlay builds); 7b ``eclipse_50k``
   and ``flashcrowd_50k`` at 51200 peers on the churn underlay
   (``topology.sparse(51200, 32, degree=12)``, the reference's
   construction at any N) for 40 ticks, eager ``run_with_contracts``
   against a captured ``engine_chunk(telemetry=True)`` of C = 8 from the
   same state and keys (rows and final state equal), hb/s, peak memory,
   launches (kernels 1-4), each contract's verdict (printed, not fatal);
   7c ``eclipse_50k`` for 16 ticks under ``supervised_run`` in chunks of
   8 with a journal, its contracts live under ``verdict_policy=
   "snapshot"`` and a ``CommandQueue`` tailing an NDJSON stream
   (publishes, a join and a leave, storm, eclipse and censor attacks, a
   malformed line refused by name): equal to the unsupervised loop that
   applies the same frames at the same boundaries and steps with
   ``run_keys``, in every field and journal row; a kill after chunk 1 and
   a resume from the sidecar's ``stream_offset`` equal too; every frame
   applied under sync debug "error"; no retry, no degrade, kernels 1-4;
   7d ``run_traced`` of ``single_topic_1k(1024)`` with provenance for 4
   ticks, its events equal to the CPU run's list for list, then
   ``tensorize_trace`` and ``replay_feed`` into a fresh state under sync
   debug "error", equal to the CPU's replay;
8. the degree-bucketed engine (sim/bucketed.py), after 7d: 8a a 1024-peer
   power-law network on its degree buckets (d 4-16: scoring, the gater,
   connection churn, link drop and duplication, an eclipse of the hub
   bucket) for 8 ticks under each ``bucketed_rng``, every array of ``g``,
   of every bucket and of ``rev`` after every tick equal to a CPU run of
   the port (float32 rtol 1e-6, the rest exact; the CPU side runs in a
   child process started with the underlay builds), no hand kernel but
   the selections' ``select_rows`` launched; 8b ``powerlaw_1m`` at
   1,048,576 peers (its own config: compact, ``"bucket"`` draws) on its
   power-law underlay: stored bytes equal to ``state_nbytes``, one warm
   tick, then 4 ticks timed by CUDA events (eager hb/s), the peak device
   memory above the start, the underlay's ``degree_stats``, delivery and
   ``fault_flags`` (no violation), kernels 1-7 launched 0 times and
   ``select_rows`` some, and one more tick under sync debug "error"; 8c
   ``heavytail_eclipse`` at 131,072 peers for 10 ticks (the window is
   [3, 8): the eclipse bit must be set), then under
   ``bucketed_rng="dense"`` and f32 the densified state after 4 ticks
   equal in every field to the dense ``run`` on the same graph on the
   card, which runs kernels 1-4 (their launches printed). The two
   power-law underlays build in child processes with the others;
9. the multi-device plane (parallel/), after 8c: two ranks of ``python
   -m go_libp2p_pubsub_tpu_torch.run_multihost``, both on ``cuda:0`` in a
   gloo group (NCCL refuses two ranks on one device), started after the
   kernels are built, a failed rank failing the phase. 9a the headline
   (102400, kernels 1-4 on each rank's 51,200 rows) for 8 ticks: the
   whole state's digests after every tick and the gathered final state
   equal to the single-process card run of the same keys, then one more
   tick whose every kernel call is held against its plain version on the
   rank's own inputs; each rank prints its hb/s (two ranks sharing one
   card, not a scaling figure), collective bytes per tick and launches.
   9b the headline under ``sort`` and the halo route (4 ticks, overflow
   0, equal to the single-process run), its starved control
   (``halo_bucket_capacity=1`` must set ``halo_overflow`` and its flag),
   and churn_50k (51200) under ``pallas`` for 4 ticks with kernels 4-6
   checked on each rank. 9c ``mh_supervisor`` runs two ranks of
   single_topic_1k(1024) for 16 ticks in chunks of 8, ``GRAFT_CHAOS``
   kills rank 1 at tick 8, the group relaunches from the checkpoint, and
   the final state equals the uninterrupted run. 9d heavytail_eclipse
   (131,072) on the row-sharded bucketed step for 10 ticks, equal leaf
   for leaf to the single-process card run, the eclipse bit set;
10. the host tools around the engine. 10a, right after 6c while the
    underlays build (3c and 9c follow it there, before phase 3): ``sweep_scores.run_sweep`` over eclipse_small and
    sybil_small x baseline, p1_off, p6_harsh and gater_on (512 peers, 2
    seeds, 40 ticks or the attack's own; fleet windows of 8) on the card, killed when the
    second scenario's fleet completes and run again on its journal (the
    first scenario's rows from the journal, no fleet; the second's members
    equal the killed run's), kernels 1-4 launched, aggregate member-ticks/s;
    after 9d its rows and every member's final state against a CPU run of
    the port (a child process started with the underlay builds). 10b, after
    7d: 7d's events through a ``PBTracer`` and a ``JSONTracer`` file, the
    native tensorizer's feed of the file equal array for array to the
    Python tensorizer's (of the file and of the events in memory), the
    file's feed replayed on the card equal to 7d's replay, native and Python
    tensorize MB/s. 10c: 8 ticks of the headline's telemetry lane through
    ``HealthJournal`` with the native encoder, rows equal to the Python
    encoder's, us a row of both. 10d: ``calibrate_dispatch.calibrate`` at
    (102400, 32, 64) and (10240, 32, 64) on the phase-3 and outage
    underlays, 5 repeats, every kernel label raising its kernel's launch
    count, the table loaded through GRAFT_DISPATCH_TABLE and read back by
    ``dispatch.explain``, each op's winner beside the shipped table's
    choice;
11. the functional runtime (api/, net/, routers/) and its bridges to
    the engine, after 10d. 11a: a 128-host scoring swarm of the port's
    routers (dense_connect degree 8, 32 publishes, 12 virtual seconds)
    traced through a ``PBTracer`` file, the file tensorized by the native
    codec and replayed on the card into a fresh state over
    ``from_hosts(hosts, 32)``: every node's mesh exact, the P2/P3/P3b/P4
    counters within 1e-3 of the routers', and the card's state equal to
    the CPU replay of the same feed (float32 rtol 1e-6, the rest exact);
    events, file bytes, tensorize MB/s, replay ops/s and the swarm's
    seconds printed. 11b: tests/test_statistical_parity.py's run (512
    hosts, degree 12, K = 40, 24 publishes): the functional half in a
    child process started with the underlay builds returns its underlay,
    degrees, delivery and latencies and a CPU run of the batched half;
    the batched half runs 30 ticks on the card on kernels 1-4 (K = 40:
    the fused kernels' K > 32 branch), its launches counted, equal to the
    CPU run after every tick, and the shared parity bands hold. 11c: one
    plan (a partition into 2 on [2, 6), an outage on [8, 11)) installed
    by ``HostFaultInjector`` on a 128-host swarm and run on the card over
    its ``from_hosts`` underlay: inside each window and after the heal,
    the connections the injector has cut, through ``peer_index``, are the
    card's down slots; ``fault_flags`` is exactly the plan's bits;
12. the ``kernels`` JSON line, then the device JSON line last.

Every path prints the formulation each of its seams runs
(``ops.dispatch.resolved_formulations``). The five underlays (102400,
51200 and 10240 peers at K = 32 and the beacon network's 10240 peers at
K = 48, a pure-Python O(N^2) build at the scenarios' seed; the frontier's
vectorized 1,048,576-peer ``sparse_fast``) are made in child processes
while the kernels are built and checked; phases 3d-3g reuse them.
Any failure exits non-zero without the last line. Imports nothing of
JAX.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
# H100 SXM 32-bit integer issue rate outside the tensor cores: 132 SMs x 64
# INT32 lanes x 1.98 GHz boost clock = 16.7e12 ops/s (the data sheet's 67
# TFLOP/s fp32 counts an FMA as two operations on 128 fp32 lanes per SM).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit integer instructions of one threefry-2x32 draw and its float
# assembly (csrc/select_rows.cu threefry_bits, counted in the SASS of
# sm_90a: 17 IMAD.IADD, 10 IADD3, 20 SHF, 20 LOP3, 1 LEA.HI; and one FADD)
DRAW_OPS = 68
SECTOR = 32                      # bytes of an L2 sector
N_FULL, K, M = 102400, 32, 64
N_CHURN = 51200                  # churn_50k at its 128-friendly size
REPS = 20
SLOW_CALL_MS = 2.0               # time_ms: a longer call is timed singly

# TPU kernel each port replaces (function definition, file:line); select_rows
# replaces no Pallas kernel but the reference's jnp selections
REPLACES = {
    "edge_table": "go_libp2p_pubsub_tpu/ops/permgather.py:230",
    "iwant_resolve": "go_libp2p_pubsub_tpu/ops/hopkernel.py:255",
    "hop": "go_libp2p_pubsub_tpu/ops/hopkernel.py:363",
    "emit": "go_libp2p_pubsub_tpu/ops/hopkernel.py:174",
    "gather_words": "go_libp2p_pubsub_tpu/ops/permgather.py:196",
    "permutation_gather": "go_libp2p_pubsub_tpu/ops/permgather.py:161",
    "take_words": "go_libp2p_pubsub_tpu/ops/mxutake.py:119",
    "select_rows": "none: go_libp2p_pubsub_tpu/ops/selection.py:140, :167, "
                   ":184 (jnp select_random, select_top, masked_median)",
}
LIBRARY_NOTE = ("library_ms is null for edge_table, hop, iwant_resolve, emit "
                "and select_rows: no single PyTorch call computes a "
                "bit-table edge exchange, a fused hop, an IWANT resolve, a "
                "budgeted IHAVE chooser or a masked top-count selection with "
                "a count a row")
# kernels each path must launch (and, for the churn runs, must not)
PATH_KERNELS = {
    "headline": ({"edge_table", "hop", "iwant_resolve", "emit"}, set()),
    "churn[pallas]": ({"edge_table", "gather_words", "permutation_gather"},
                      {"take_words", "hop", "iwant_resolve", "emit"}),
    "churn[mxu]": ({"take_words"}, {"edge_table", "gather_words",
                                    "permutation_gather", "hop",
                                    "iwant_resolve", "emit"}),
    "wide window": ({"edge_table", "gather_words"},
                    {"hop", "iwant_resolve", "emit", "permutation_gather",
                     "take_words"}),
    # phase 3d: the data plane's branches
    "floodsub": ({"hop", "iwant_resolve", "emit"},
                 {"edge_table", "gather_words", "permutation_gather",
                  "take_words"}),
    "randomsub": ({"edge_table", "hop", "iwant_resolve", "emit"},
                  {"gather_words", "permutation_gather", "take_words"}),
    "flood publish": ({"edge_table", "gather_words", "permutation_gather",
                       "emit"}, {"hop", "iwant_resolve", "take_words"}),
    "partition": ({"edge_table", "hop", "iwant_resolve", "emit"},
                  {"gather_words", "permutation_gather", "take_words"}),
    "combined plan": ({"edge_table", "gather_words", "emit"},
                      {"hop", "iwant_resolve", "permutation_gather",
                       "take_words"}),
    "outage": ({"edge_table", "hop", "iwant_resolve", "emit",
                "permutation_gather"}, {"gather_words", "take_words"}),
    # phase 3e: the BASELINE configs
    "single_topic_1k": ({"edge_table", "hop", "iwant_resolve", "emit"},
                        {"gather_words", "permutation_gather", "take_words"}),
    "beacon_10k": ({"edge_table", "hop", "iwant_resolve", "emit"},
                   {"gather_words", "permutation_gather", "take_words"}),
    "beacon rotation": ({"edge_table", "hop", "iwant_resolve", "emit"},
                        {"gather_words", "permutation_gather",
                         "take_words"}),
    "sybil_100k": ({"edge_table", "hop", "iwant_resolve", "emit",
                    "permutation_gather"}, {"gather_words", "take_words"}),
    # phase 3f: the frontier (sort exchanges over the fused hop, resolve
    # and emit) and the reference's TPU resolution, which runs no kernel
    "frontier_1m": ({"hop", "iwant_resolve", "emit"},
                    {"edge_table", "gather_words", "permutation_gather",
                     "take_words"}),
    "sort path": (set(), {"edge_table", "hop", "iwant_resolve", "emit",
                          "gather_words", "permutation_gather",
                          "take_words"}),
    # phase 3g: compact storage on the headline and the frontier
    "compact headline": ({"edge_table", "hop", "iwant_resolve", "emit"},
                         {"gather_words", "permutation_gather",
                          "take_words"}),
    "compact frontier_1m": ({"hop", "iwant_resolve", "emit"},
                            {"edge_table", "gather_words",
                             "permutation_gather", "take_words"}),
    # phase 6: the supervised and fleet planes (captured chunks, windows)
    "supervised headline": ({"edge_table", "hop", "iwant_resolve", "emit"},
                            {"gather_words", "permutation_gather",
                             "take_words"}),
    "fleet_256x1k": ({"edge_table", "hop", "iwant_resolve", "emit"},
                     {"gather_words", "permutation_gather", "take_words"}),
    "supervised fleet": ({"edge_table", "hop", "iwant_resolve", "emit"},
                         {"gather_words", "permutation_gather",
                          "take_words"}),
    # phase 7: the bench-scale attack families (PX + connection churn) and
    # the supervised eclipse run with its command plane
    "eclipse_50k": ({"edge_table", "hop", "iwant_resolve", "emit"},
                    {"gather_words", "take_words"}),
    "flashcrowd_50k": ({"edge_table", "hop", "iwant_resolve", "emit"},
                       {"gather_words", "take_words"}),
    "supervised eclipse": ({"edge_table", "hop", "iwant_resolve", "emit"},
                           {"gather_words", "take_words"}),
    # phase 10a: the score sweep's fleets (sybil_small and eclipse_small at
    # 512 peers: PX reconnects through the payload permute; gater_on's
    # validation queue cap runs the non-fused words gathers)
    "score sweep": ({"edge_table", "hop", "iwant_resolve", "emit",
                     "gather_words", "permutation_gather"}, {"take_words"}),
    # phase 8: the degree-bucketed engine runs no hand kernel but
    # select_rows (added below, as on every path with a heartbeat); the dense
    # engine on the heavy-tailed graph runs kernels 1-4 (and churn's
    # payload permute)
    "powerlaw_1m": (set(), set(REPLACES)),
    "heavytail_eclipse": (set(), set(REPLACES)),
    "heavytail dense": ({"edge_table", "hop", "iwant_resolve", "emit"},
                        {"gather_words", "take_words"}),
    # phase 11: the batched halves of the cross-half run (K = 40, the
    # fused kernels' K > 32 branch) and of the fault injector's plan
    "cross-half": ({"edge_table", "hop", "iwant_resolve", "emit"},
                   {"gather_words", "take_words"}),
    "injector": ({"edge_table", "hop", "iwant_resolve", "emit"},
                 {"gather_words", "take_words"}),
}
# the heartbeat's selections run on select_rows on every path with a
# heartbeat, the bucketed engine's included; floodsub has none
for _path, (_must, _must_not) in PATH_KERNELS.items():
    _must_not.discard("select_rows")
    (_must_not if _path == "floodsub" else _must).add("select_rows")
N_OUTAGE = 10240                 # outage_10k at its 128-friendly size
N_BEACON, K_BEACON = 10240, 48   # beacon_10k at its 128-friendly size
# the beacon network's attestation-subnet rotation: a stress rate, not the
# chain's ~27-hour rotation
ROTATION_PROB = 0.01
N_WIDE, M_WIDE = 4096, 288       # W = 9 packed words per message row
N_FRONTIER = 1 << 20             # frontier_1m: 1,048,576 peers
CAPTURE_TICKS = 8                # phase 5's chunk length C
SUPERVISED_TICKS = 16            # phase 6a: two chunks of C
DEADLINE_S = 5.0                 # phase 6a's watchdog; the hook sleeps past it
FLEET_B, FLEET_N = 256, 1024     # phase 6b: bench.py's fleet_256x1k line
# phase 6c: eight members' tick counts (compaction); member 3 raise-mode,
# poisoned
FLEET_TICKS = (3, 5, 8, 8, 6, 8, 8, 7)
FORMS = ("scalar", "rows", "sort", "pallas", "mxu")
N_FAMILY = 512                   # phase 7a: the families' own width
SCALE_TICKS = 40                 # phase 7b: ticks of each bench family
N_TRACE, TRACE_TICKS = 1024, 4   # phase 7d: the traced single_topic_1k
N_BUCKETED, BUCKETED_TICKS = 1024, 8   # phase 8a
N_POWERLAW_1M, N_POWERLAW_100K = 1 << 20, 1 << 17   # phases 8b, 8c
# phase 10a: the score sweep's grid (sweep_scores.py's defaults: 512 peers,
# 40 ticks or the attack's own n_ticks, 2 seeds)
SWEEP_SCENARIOS = ("eclipse_small", "sybil_small")
SWEEP_VARIANTS = ("baseline", "p1_off", "p6_harsh", "gater_on")
# fleet windows of 8 ticks: one short graph a fleet group to capture
SWEEP_CHUNK_TICKS = 8
# phase 10d: the calibrator's shapes (n, k, m) on the phase-3 and outage
# underlays, and its repeats
CALIBRATE_SHAPES = ((N_FULL, K, M), (N_OUTAGE, K, M))
CALIBRATE_REPEATS = 5
ENCODE_ROWS = 8192               # phase 10c: rows a timed encode formats
# the formulation cases of phase 4e, each at 1024 peers
FORMULATION_CASES = ("frontier, sort", "headline, scalar", "headline, rows",
                     "headline, sort, flood publish", "churn_50k, sort",
                     "selection iter", "selection sort")


def host_rss():
    """The process's resident host memory in bytes (Linux)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def row_sectors(idx, w):
    """Mean 32-byte L2 sectors spanned by the n-major table row of W words
    that each index in ``idx`` reads: computed from the rows' byte offsets,
    not a measured count (a warp whose lanes read one row asks once)."""
    first = idx.long() * (4 * w) // SECTOR
    last = (idx.long() * (4 * w) + 4 * w - 1) // SECTOR
    return float((last - first + 1).double().mean()) if idx.numel() else 0.0


# phase 4's data-plane trajectories: a plan of every fault family (peer 1,
# the victim, is one of the storm's hot publishers)
EVERY_FAMILY = ("drop=0.1,dup=0.2,corrupt=0.3,partition=2@1:4,outage=0.2@2:5,"
                "eclipse=0.1@3:6,censor=0.4x1@1:7,storm=4x0.9x0@2:5,"
                "slowlink=0.3@3:0.1,wave=0.25@4:2:8,seed=3")
DATAPLANE_CASES = ("floodsub", "randomsub", "flood publish",
                   "edge caps, provenance", "every fault family")


def dataplane_case(what, n, dev, topo):
    """(cfg, tp, state) of a data-plane branch at ``n`` peers on ``dev``:
    the router sweep's floodsub and randomsub, the headline with flood
    publish, the headline with edge caps, provenance and the gater (two
    hops a tick, so that pulls meet the caps), and partition_small with
    every fault family and a sybil in 25."""
    import dataclasses
    import torch
    from go_libp2p_pubsub_tpu_torch.sim import build_headline, scenarios
    from go_libp2p_pubsub_tpu_torch.sim.faults import FaultPlan
    if what in ("floodsub", "randomsub"):
        return scenarios.router_sweep_100k(what, n, device=dev, topo=topo)
    if what == "every fault family":
        cfg, tp, st = scenarios.partition_small(n, k_slots=K, degree=12,
                                                device=dev, topo=topo)
        mal = torch.zeros(n, dtype=torch.bool, device=dev)
        mal[::25] = True
        return (dataclasses.replace(
            cfg, fault_plan=FaultPlan.parse(EVERY_FAMILY)), tp,
            st._replace(malicious=mal))
    cfg, tp, st = build_headline(n, device=dev, topo=topo)
    if what == "flood publish":
        return dataclasses.replace(cfg, flood_publish=True), tp, st
    if what == "edge caps, provenance":
        return dataclasses.replace(
            cfg, edge_queue_cap=2, record_provenance=True, prop_substeps=2,
            gater_enabled=True, validation_queue_cap=8), tp, st
    raise ValueError(f"unknown data-plane case {what!r}")


BASELINE_CASES = ("beacon_10k, subscription churn", "sybil_small")

# phase 4's trajectories, (case, gather): their CPU halves run in a child
# process started with the underlay builds
TRAJECTORY_CASES = (("headline", None), ("churn", "pallas"), ("churn", "mxu"),
                    *((c, None) for c in DATAPLANE_CASES
                      + BASELINE_CASES + FORMULATION_CASES))


def baseline_case(what, n, dev, topo):
    """(cfg, tp, state) of a BASELINE card case at ``n`` peers on ``dev``:
    beacon_10k (T = 9, K = 48) with subscription churn at 0.02 a tick, and
    sybil_small on its own K = 16, degree-6 underlay."""
    import dataclasses
    from go_libp2p_pubsub_tpu_torch.sim import scenarios
    if what == "sybil_small":
        return scenarios.sybil_small(n, device=dev, topo=topo)
    cfg, tp, st = scenarios.beacon_10k(n, device=dev, topo=topo)
    return dataclasses.replace(cfg, sub_leave_prob=0.02,
                               sub_join_prob=0.02), tp, st


def formulation_case(what, n, dev, topo):
    """(cfg, tp, state) of a phase-4e case at ``n`` peers on ``dev``: the
    frontier under its sort exchanges (its own ``sparse_fast`` underlay);
    the headline's non-fused path (``hop_mode="xla"``) under scalar, rows,
    and sort with flood publish (the answer table's ride-along and the
    sender-side planes' shared sort); churn_50k under sort (churn's
    payload exchange); the headline under the iter and sort selections."""
    import dataclasses
    from go_libp2p_pubsub_tpu_torch.sim import build_headline, scenarios
    if what == "frontier, sort":
        return scenarios.frontier(n, device=dev)
    if what == "churn_50k, sort":
        cfg, tp, st = scenarios.churn_50k(n_peers=n, device=dev, topo=topo)
        return dataclasses.replace(cfg, hop_mode="xla",
                                   edge_gather_mode="sort"), tp, st
    over = {"headline, scalar": dict(hop_mode="xla", edge_gather_mode="scalar"),
            "headline, rows": dict(hop_mode="xla", edge_gather_mode="rows"),
            "headline, sort, flood publish": dict(
                hop_mode="xla", edge_gather_mode="sort", flood_publish=True),
            "selection iter": dict(selection_mode="iter"),
            "selection sort": dict(selection_mode="sort")}[what]
    cfg, tp, st = build_headline(n, device=dev, topo=topo)
    return dataclasses.replace(cfg, **over), tp, st


def trajectory_case(what, gather, dev, n=1024):
    """``(label, (cfg, tp, state))`` of phase 4's case ``(what, gather)`` at
    ``n`` peers on ``dev``, on :func:`trajectory_topology`'s underlay."""
    import dataclasses
    from go_libp2p_pubsub_tpu_torch.sim import build_headline, scenarios
    topo = trajectory_topology(what, n)
    if what == "headline":
        return f"{n} peers", build_headline(n, device=dev, topo=topo)
    if what == "churn":
        cfg, tp, st = scenarios.churn_50k(n_peers=n, device=dev, topo=topo)
        return (f"churn_50k({n}) cap 4, hop_mode=xla, edge_gather_mode="
                f"{gather}", (dataclasses.replace(
                    cfg, hop_mode="xla", edge_gather_mode=gather,
                    validation_queue_cap=4), tp, st))
    build = (baseline_case if what in BASELINE_CASES else formulation_case
             if what in FORMULATION_CASES else dataplane_case)
    return f"{what}, {n} peers", build(what, n, dev, topo)


def _phase4_cpu(conn):
    """Child process: phase 4's CPU trajectories (8 ticks of every
    TRAJECTORY_CASES case, each tick's fingerprint)."""
    sys.path.insert(0, REPO)
    import torch
    torch.set_num_threads(2)
    from go_libp2p_pubsub_tpu_torch import rng
    from go_libp2p_pubsub_tpu_torch.sim import step, state_to_numpy
    out = {}
    for what, gather in TRAJECTORY_CASES:
        _, (cfg, tp, st) = trajectory_case(what, gather, "cpu")
        keys = rng.split(rng.PRNGKey(0, device="cpu"), 8)
        ticks = []
        for tick in range(8):
            st = step(st, cfg, tp, keys[tick], device="cpu")
            ticks.append(_fingerprint(state_to_numpy(st)))
        out[(what, gather)] = ticks
    conn.send(out)
    conn.close()


def formulations(cfg):
    """The formulation each seam of ``cfg`` runs, as one JSON object."""
    from go_libp2p_pubsub_tpu_torch.ops.dispatch import resolved_formulations
    return json.dumps(resolved_formulations(cfg), sort_keys=True)


def trajectory_topology(what, n):
    """The underlay of a phase-4 case: the scenario's own (K, degree) at
    the scenarios' seed."""
    from go_libp2p_pubsub_tpu_torch.sim import topology
    k, degree = {"sybil_small": (16, 6)}.get(
        what, (K_BEACON, 16) if what.startswith("beacon") else (K, 12))
    return topology.sparse(n, k, degree=degree)


def _build_topology(conn, n, k, degree):
    """Child process: an underlay (a pure-Python O(N^2) build; the
    frontier's vectorized ``sparse_fast`` at degree 8)."""
    sys.path.insert(0, REPO)
    from go_libp2p_pubsub_tpu_torch.sim import scenarios, topology
    if n == N_FRONTIER:
        topo = topology.sparse_fast(n, k, degree=degree, seed=scenarios.SEED)
    else:
        topo = topology.sparse(n, k, degree=degree)
    conn.send(tuple(topo))
    conn.close()


def _fingerprint(arrays):
    """Per field of a state's host arrays: the float32 planes themselves
    (compared to a tolerance), a digest of every other plane (exact)."""
    import hashlib

    import numpy as np
    return {f: (a if a.dtype == np.float32 else
                hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest())
            for f, a in arrays.items()}


def _phase7_cpu(conn):
    """Child process: phase 7's CPU runs of the port (the five families at
    N_FAMILY peers tick by tick, and the traced single_topic_1k with the
    replay of its events), sent back as fingerprints, rows, contract
    results and events."""
    sys.path.insert(0, REPO)
    import torch
    torch.set_num_threads(2)
    from go_libp2p_pubsub_tpu_torch import rng
    from go_libp2p_pubsub_tpu_torch.sim import (adversary, state_to_numpy,
                                                step, telemetry)
    out = {"families": {}}
    for name, build in adversary.ATTACKS.items():
        scn = build(n_peers=N_FAMILY, device="cpu")
        keys = rng.split(rng.PRNGKey(0, device="cpu"), scn.n_ticks)
        st, ticks, rows = scn.state, [], []
        for i in range(scn.n_ticks):
            st = step(st, scn.cfg, scn.tp, keys[i], device="cpu")
            ticks.append(_fingerprint(state_to_numpy(st)))
            rows.append(telemetry.record_to_row(
                telemetry.health_record(st, scn.cfg, scn.tp)))
        results = [(r.kind, r.status, r.detail, r.measured) for r in
                   adversary.evaluate_contracts(scn.contracts, rows)]
        out["families"][name] = (ticks, rows, results)
    cfg, tp, st, topo = _trace_case("cpu")
    fin, events = _run_trace(cfg, tp, st, "cpu")
    rep = _replay_trace(cfg, tp, topo, events, "cpu")[0]
    out["trace"] = (_fingerprint(state_to_numpy(fin)), events,
                    _fingerprint(state_to_numpy(rep)))
    conn.send(out)
    conn.close()


def bucketed_case(dev, rng_mode):
    """8a's network on ``dev``: 1024 peers on a power-law underlay (d
    4-16) in its degree buckets, scoring, the gater, connection churn,
    link drop and duplication and an eclipse of the hub bucket, under
    the fold_in schedule."""
    import numpy as np
    from go_libp2p_pubsub_tpu_torch.sim import (SimConfig, bucketed,
                                                scenarios, topology)
    from go_libp2p_pubsub_tpu_torch.sim.faults import EclipseWindow, FaultPlan
    n = N_BUCKETED
    buckets = topology.powerlaw_buckets(n, d_min=4, d_max=16)
    k = buckets[0][1]
    plan = FaultPlan(link_drop_prob=0.02, link_dup_prob=0.02,
                     eclipses=(EclipseWindow(2, 6,
                                             fraction=buckets[0][0] / n),),
                     seed=5)
    cfg = SimConfig(n_peers=n, k_slots=k, n_topics=2, msg_window=8,
                    publishers_per_tick=4, prop_substeps=4,
                    scoring_enabled=True, gater_enabled=True,
                    churn_disconnect_prob=0.05, churn_reconnect_prob=0.2,
                    fault_plan=plan, degree_buckets=buckets,
                    bucketed_rng=rng_mode, key_schedule="fold_in")
    topo = topology.powerlaw(n, k, d_min=4, d_max=16, seed=11)
    bs = bucketed.init_bucketed_state(cfg, topo, device=dev,
                                      malicious=np.arange(n) >= n - n // 8)
    return cfg, scenarios.default_topic_params(2, device=dev), bs


def _bucketed_ticks(dev, rng_mode):
    """Fingerprints of 8a's state after each tick on ``dev``."""
    from go_libp2p_pubsub_tpu_torch import rng
    from go_libp2p_pubsub_tpu_torch.sim import bucketed
    cfg, tp, bs = bucketed_case(dev, rng_mode)
    key = rng.PRNGKey(0, device=dev)
    out = []
    for _ in range(BUCKETED_TICKS):
        bs = bucketed.bucketed_run(bs, cfg, tp, key, 1, device=dev)
        out.append(_fingerprint(bucketed.bucketed_state_to_numpy(bs)))
    return out, int(bs.fault_flags) & 0xFFFFFFFF


def _phase8_cpu(conn):
    """Child process: 8a's CPU runs of the port under each bucketed_rng."""
    sys.path.insert(0, REPO)
    import torch
    torch.set_num_threads(2)
    conn.send({mode: _bucketed_ticks("cpu", mode)
               for mode in ("bucket", "dense")})
    conn.close()


class _Killed(Exception):
    """Phase 10a's kill of a sweep in flight."""


def _sweep(dev, digests, lines, journal=None, kill_at=None):
    """Phase 10a's grid through ``sweep_scores.run_sweep`` on ``dev``: its
    rows; each emitted line parsed into ``lines``, each member's final
    state fingerprinted into ``digests``. ``kill_at`` names a scenario
    whose completed fleet raises :class:`_Killed` before its rows reach
    the journal."""
    from go_libp2p_pubsub_tpu_torch.sim import state_to_numpy
    from go_libp2p_pubsub_tpu_torch.sim.supervisor import SupervisorConfig
    from go_libp2p_pubsub_tpu_torch.sweep_scores import run_sweep

    def on_fleet(scen, members, results):
        for m, r in zip(members, results):
            digests[m.name] = _fingerprint(state_to_numpy(r.state))
        if scen == kill_at:
            raise _Killed(scen)
    return run_sweep(SWEEP_SCENARIOS, SWEEP_VARIANTS, journal=journal,
                     emit=lambda x: lines.append(json.loads(x)),
                     sup=SupervisorConfig(chunk_ticks=SWEEP_CHUNK_TICKS),
                     device=dev, on_fleet=on_fleet)


def _phase10_cpu(conn):
    """Child process: phase 10a's sweep on the CPU (rows and every
    member's fingerprint)."""
    sys.path.insert(0, REPO)
    import torch
    torch.set_num_threads(2)
    digests = {}
    rows = _sweep("cpu", digests, [])
    conn.send((rows, digests))
    conn.close()


def _build_powerlaw(conn, n):
    """Child process: the power-law scenarios' underlay at ``n`` peers
    (``scenarios.powerlaw_spec``'s own build: d 8-64, alpha 2, K = 64)."""
    sys.path.insert(0, REPO)
    from go_libp2p_pubsub_tpu_torch.sim import scenarios, topology
    cfg = scenarios.powerlaw_cfg(n)
    conn.send(tuple(topology.powerlaw(n, cfg.k_slots, seed=scenarios.SEED)))
    conn.close()


def bucketed_formulations(cfg):
    """What the bucketed fork runs at each seam: its own flat exchange,
    plain word gathers and non-fused hops whatever ``edge_gather_mode`` and
    ``hop_mode`` say, and each bucket's selection as ``selection_mode``
    resolves at that bucket's width."""
    from go_libp2p_pubsub_tpu_torch.ops.dispatch import resolved_formulations
    sel = {b: v["selection"]
           for b, v in resolved_formulations(cfg)["bucketed"].items()}
    return json.dumps({"exchange": "flat reverse-edge index",
                       "gathers": "plain indexing", "hop": "non-fused",
                       "selection": sel}, sort_keys=True)


def _trace_case(dev):
    """7d's network: ``single_topic_1k(N_TRACE)`` with provenance."""
    import dataclasses
    from go_libp2p_pubsub_tpu_torch.sim import scenarios, topology
    topo = topology.sparse(N_TRACE, K, degree=12, seed=scenarios.SEED)
    cfg, tp, st = scenarios.single_topic_1k(N_TRACE, device=dev, topo=topo)
    return dataclasses.replace(cfg, record_provenance=True), tp, st, topo


def _run_trace(cfg, tp, st, dev):
    from go_libp2p_pubsub_tpu_torch import rng
    from go_libp2p_pubsub_tpu_torch.sim.trace_export import run_traced
    return run_traced(st, cfg, tp, None, 0, device=dev, keys=rng.split(
        rng.PRNGKey(5, device=dev), TRACE_TICKS))


def _trace_preamble():
    """What the replays put before the traced events: a JOIN of every peer
    at t=0.1, and the peer index."""
    pre = [{"type": "JOIN", "peerID": f"p{i}", "timestamp": 0.1,
            "join": {"topic": "t0"}} for i in range(N_TRACE)]
    return pre, {f"p{i}": i for i in range(N_TRACE)}


def _replay_trace(cfg, tp, topo, events, dev, guard=None, feed=None):
    """The events, after :func:`_trace_preamble`, tensorized (or ``feed``)
    and replayed into a fresh state (nobody subscribed) on ``dev``;
    ``guard`` wraps the replay (sync debug mode on the card). (state, op
    count, seconds)."""
    import contextlib
    import importlib

    import numpy as np
    from go_libp2p_pubsub_tpu_torch.sim import init_state
    rp = importlib.import_module("go_libp2p_pubsub_tpu_torch.trace.replay")
    if feed is None:
        pre, index = _trace_preamble()
        feed = rp.tensorize_trace(pre + events, index, {"t0": 0},
                                  msg_window=cfg.msg_window,
                                  t_end=float(TRACE_TICKS))
    st = init_state(cfg, topo, subscribed=np.zeros((N_TRACE, 1), bool),
                    device=dev)
    t0 = time.perf_counter()
    with (guard or contextlib.nullcontext)():
        out = rp.replay_feed(st, cfg, tp, feed)
    if str(dev) != "cpu":
        import torch
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, len(feed.op), secs


def _same_fingerprint(label, got, want):
    import numpy as np
    for f, w in want.items():
        g = got[f]
        same = np.allclose(g, w, rtol=1e-6, atol=0.0) \
            if isinstance(w, np.ndarray) else g == w
        if not same:
            raise AssertionError(f"{label}: field {f} differs from the "
                                 f"CPU run")


def _same_rows(label, got, want):
    for g, w in zip(got, want, strict=True):
        for k, x in w.items():
            y = g[k]
            if isinstance(x, float) and x != y:
                rtol = 1e-5 if k == "score_mean" else 1e-6
                if abs(x - y) > rtol * abs(x):
                    raise AssertionError(f"{label}: row {w['tick']} column "
                                         f"{k} {y} against {x}")
            elif not isinstance(x, float) and x != y:
                raise AssertionError(f"{label}: row {w['tick']} column {k} "
                                     f"{y} against {x}")


# ---- phase 11: the functional runtime and its bridges to the engine -------
# 11a: tests/test_trace_replay.py's network, widened; K holds the swarm's
# largest degree (22 at this seed) so from_hosts truncates no edge
N_LIVE, LIVE_DEGREE, K_LIVE, LIVE_PUBS = 128, 8, 32, 32
LIVE_TOPIC, LIVE_T_END, LIVE_DUP_WINDOW, LIVE_WINDOW = "t", 12.0, 0.05, 64
# 11b: tests/test_statistical_parity.py's shape
N_PARITY, PARITY_DEGREE, K_PARITY = 512, 12, 40
PARITY_CONVERGE_T, PARITY_PUBS, PARITY_DRAIN_T = 15.0, 24, 3.0
PARITY_TICKS = 30
# 11c: a partition into 2 on ticks [2, 6) and an outage on [8, 11), read
# inside each window and after the heal
N_INJECT, INJECT_DEGREE, K_INJECT = 128, 8, 32
INJECT_PLAN = "partition=2@2:6,outage=0.2@8:11,seed=7"
INJECT_TICKS, INJECT_CHECKS = 13, (3, 9, 12)


def _live_tsp():
    """tests/test_trace_replay.py's topic score parameters."""
    from go_libp2p_pubsub_tpu_torch.core.params import TopicScoreParams
    return TopicScoreParams(
        topic_weight=1.0, time_in_mesh_weight=0.05, time_in_mesh_quantum=1.0,
        time_in_mesh_cap=100.0, first_message_deliveries_weight=1.0,
        first_message_deliveries_decay=0.9,
        first_message_deliveries_cap=50.0,
        mesh_message_deliveries_weight=-0.5,
        mesh_message_deliveries_decay=0.8, mesh_message_deliveries_cap=30.0,
        mesh_message_deliveries_threshold=3.0,
        mesh_message_deliveries_window=LIVE_DUP_WINDOW,
        mesh_message_deliveries_activation=4.0,
        mesh_failure_penalty_weight=-1.0, mesh_failure_penalty_decay=0.7,
        invalid_message_deliveries_weight=-5.0,
        invalid_message_deliveries_decay=0.9)


def _parity_tsp():
    """tests/test_statistical_parity.py's topic score parameters."""
    from go_libp2p_pubsub_tpu_torch.core.params import TopicScoreParams
    return TopicScoreParams(
        topic_weight=1.0, time_in_mesh_weight=0.05, time_in_mesh_quantum=1.0,
        time_in_mesh_cap=100.0, first_message_deliveries_weight=1.0,
        first_message_deliveries_decay=0.9,
        first_message_deliveries_cap=50.0,
        mesh_message_deliveries_weight=0.0,
        mesh_message_deliveries_decay=0.9, mesh_message_deliveries_cap=30.0,
        mesh_message_deliveries_threshold=3.0,
        mesh_message_deliveries_window=0.05,
        mesh_message_deliveries_activation=4.0,
        mesh_failure_penalty_weight=0.0, mesh_failure_penalty_decay=0.9,
        invalid_message_deliveries_weight=-5.0,
        invalid_message_deliveries_decay=0.9)


class _CountingTracer:
    """An event tracer that counts the events it passes on."""

    def __init__(self, inner):
        self.inner = inner
        self.n = 0

    def trace(self, evt):
        self.n += 1
        self.inner.trace(evt)


def _live_swarm(tracer):
    """11a's swarm on the port's runtime, every node tracing to
    ``tracer``, run to LIVE_T_END: scoring, 32 publishes from 2.5 s on.
    (nodes, hosts)."""
    from go_libp2p_pubsub_tpu_torch.api import LAX_NO_SIGN, PubSub
    from go_libp2p_pubsub_tpu_torch.core.params import (PeerScoreParams,
                                                        PeerScoreThresholds)
    from go_libp2p_pubsub_tpu_torch.net import Network
    from go_libp2p_pubsub_tpu_torch.routers.gossipsub import GossipSubRouter
    tsp = _live_tsp()
    net = Network()
    nodes = []
    for _ in range(N_LIVE):
        sp = PeerScoreParams(app_specific_score=lambda p: 0.0,
                             decay_interval=1.0, decay_to_zero=0.01,
                             topics={LIVE_TOPIC: tsp})
        rt = GossipSubRouter(score_params=sp, thresholds=PeerScoreThresholds(
            gossip_threshold=-10, publish_threshold=-50,
            graylist_threshold=-100))
        nodes.append(PubSub(net.add_host(), rt, sign_policy=LAX_NO_SIGN,
                            event_tracer=tracer))
    hosts = [x.host for x in nodes]
    net.dense_connect(hosts, degree=LIVE_DEGREE)
    net.scheduler.run_for(0.1)
    for x in nodes:
        x.join(LIVE_TOPIC).subscribe()
    net.scheduler.run_until(2.5)
    for i in range(LIVE_PUBS):
        nodes[(i * 37) % N_LIVE].my_topics[LIVE_TOPIC].publish(b"msg %d" % i)
        net.scheduler.run_for(0.25)
    net.scheduler.run_until(LIVE_T_END)
    return nodes, hosts


def _parity_functional():
    """11b's functional half on the port's runtime (the shape of
    tests/test_statistical_parity.py's ``_run_functional``): (hosts, mesh
    degrees, delivery fraction, latencies in virtual seconds)."""
    import numpy as np
    from go_libp2p_pubsub_tpu_torch.api import LAX_NO_SIGN, PubSub
    from go_libp2p_pubsub_tpu_torch.core.params import (PeerScoreParams,
                                                        PeerScoreThresholds)
    from go_libp2p_pubsub_tpu_torch.net import Network
    from go_libp2p_pubsub_tpu_torch.routers.gossipsub import GossipSubRouter
    from go_libp2p_pubsub_tpu_torch.trace import MemoryTracer
    tsp = _parity_tsp()
    net = Network()
    mem = MemoryTracer()
    nodes = []
    for _ in range(N_PARITY):
        sp = PeerScoreParams(app_specific_score=lambda p: 0.0,
                             decay_interval=1.0, decay_to_zero=0.01,
                             topics={LIVE_TOPIC: tsp})
        nodes.append(PubSub(net.add_host(), GossipSubRouter(
            score_params=sp, thresholds=PeerScoreThresholds()),
            sign_policy=LAX_NO_SIGN, event_tracer=mem))
    hosts = [x.host for x in nodes]
    net.dense_connect(hosts, degree=PARITY_DEGREE)
    net.scheduler.run_for(0.1)
    for x in nodes:
        x.join(LIVE_TOPIC).subscribe()
    net.scheduler.run_until(PARITY_CONVERGE_T)
    gen = np.random.default_rng(1)
    t_pub = PARITY_CONVERGE_T
    for i in range(PARITY_PUBS):
        nodes[int(gen.integers(N_PARITY))].my_topics[LIVE_TOPIC].publish(
            b"m%d" % i)
        t_pub += 0.5
        net.scheduler.run_until(t_pub)
    net.scheduler.run_until(t_pub + PARITY_DRAIN_T)
    degrees = np.array([len(x.rt.mesh.get(LIVE_TOPIC, ())) for x in nodes])
    pub_t, delivered, latencies = {}, {}, []
    for e in mem.events:
        if e["type"] == "PUBLISH_MESSAGE":
            pub_t.setdefault(e["publishMessage"]["messageID"], e["timestamp"])
        elif e["type"] == "DELIVER_MESSAGE":
            mid = e["deliverMessage"]["messageID"]
            delivered.setdefault(mid, set()).add(e["peerID"])
            if e["deliverMessage"].get("receivedFrom") != e["peerID"] \
                    and mid in pub_t:
                latencies.append(e["timestamp"] - pub_t[mid])
    frac = float(np.mean([len(delivered.get(m, ())) / N_PARITY
                          for m in pub_t]))
    return hosts, degrees, frac, np.array(latencies)


def parity_case(topo, dev):
    """11b's batched half on ``dev``: (cfg, tp, state) over the functional
    swarm's own underlay, on the fused kernels."""
    import numpy as np
    from go_libp2p_pubsub_tpu_torch.sim import SimConfig, init_state
    from go_libp2p_pubsub_tpu_torch.sim.config import TopicParams
    cfg = SimConfig(n_peers=N_PARITY, k_slots=K_PARITY, n_topics=1,
                    msg_window=64, publishers_per_tick=2, prop_substeps=8,
                    scoring_enabled=True, hop_mode="pallas",
                    edge_gather_mode="pallas")
    tp = TopicParams.from_topic_params([_parity_tsp()], device=dev)
    st = init_state(cfg, topo, subscribed=np.ones((N_PARITY, 1), bool),
                    device=dev)
    return cfg, tp, st


def _phase11_cpu(conn):
    """Child process: 11b's functional half (the port's runtime, 512
    hosts), the underlay ``from_hosts`` reads off it, and the batched
    half's CPU run on that underlay (a fingerprint after every tick).
    Only plain data crosses back: a node's RNG seeds from its peer id's
    str hash, which differs between processes."""
    sys.path.insert(0, REPO)
    import torch
    torch.set_num_threads(2)
    from go_libp2p_pubsub_tpu_torch import rng
    from go_libp2p_pubsub_tpu_torch.sim import state_to_numpy, step, topology
    t0 = time.perf_counter()
    hosts, degrees, frac, lat = _parity_functional()
    topo, _ = topology.from_hosts(hosts, K_PARITY)
    secs = time.perf_counter() - t0
    cfg, tp, st = parity_case(topo, "cpu")
    keys = rng.split(rng.PRNGKey(0, device="cpu"), PARITY_TICKS)
    ticks = []
    for i in range(PARITY_TICKS):
        st = step(st, cfg, tp, keys[i], device="cpu")
        ticks.append(_fingerprint(state_to_numpy(st)))
    conn.send({"topo": tuple(topo), "degrees": degrees, "frac": frac,
               "latencies": lat, "secs": secs, "ticks": ticks})
    conn.close()


def parity_bands(deg_f, deg_b, frac_f, lat_f):
    """tests/test_statistical_parity.py's ``_assert_parity_bands``."""
    import numpy as np
    if not (deg_f.min() >= 5 and deg_f.max() <= 12):
        raise AssertionError(f"phase 11b: functional degrees "
                             f"[{deg_f.min()}, {deg_f.max()}]")
    if abs(deg_f.mean() - deg_b.mean()) > 1.0:
        raise AssertionError(f"phase 11b: mean degrees {deg_f.mean():.2f} "
                             f"vs {deg_b.mean():.2f}")
    grid = np.arange(0, 14)
    cdf_f = np.searchsorted(np.sort(deg_f), grid, side="right") / N_PARITY
    cdf_b = np.searchsorted(np.sort(deg_b), grid, side="right") / N_PARITY
    ks = float(np.abs(cdf_f - cdf_b).max())
    if ks > 0.15:
        raise AssertionError(f"phase 11b: degree CDFs KS {ks:.3f}")
    if frac_f < 0.995:
        raise AssertionError(f"phase 11b: functional delivery {frac_f:.4f}")
    if float(lat_f.mean()) > 0.25:
        raise AssertionError(f"phase 11b: functional latency "
                             f"{lat_f.mean():.3f}")
    return ks


# ---- phase 12: the RPC wire codec, the probe and the operator tools --------
RPC_SEED = 12
RPC_STREAM_BYTES = 25 << 20      # 12b: the seeded stream's size
RPC_PREFIX_FRAMES = 2000         # 12b: the refusals run on this prefix
SEQNO_EDGES = (0, 1, (1 << 63) - 1, 1 << 63, (1 << 63) + 1, (1 << 64) - 1)
# 12c: the kernels the drill's config (single_topic_1k at 128 peers under
# the sort exchanges) runs, and those it must not
SMOKE_KERNELS = ({"hop", "iwant_resolve", "emit"},
                 {"edge_table", "gather_words", "permutation_gather",
                  "take_words"})
# 12d: the operator tools in a child that cannot import JAX or the JAX
# package, each run as ``python -m`` runs it
JAX_FREE_TOOLS = r"""
import contextlib, io, json, runpy, sys
sys.modules["jax"] = None
sys.modules["go_libp2p_pubsub_tpu"] = None
sys.path.insert(0, sys.argv[1])
journal, stream, copy, scen = sys.argv[2:6]

def tool(name, argv):
    sys.argv = [name] + argv
    out = io.StringIO()
    rc = 0
    with contextlib.redirect_stdout(out):
        try:
            runpy.run_module("go_libp2p_pubsub_tpu_torch." + name,
                             run_name="__main__", alter_sys=True)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue()

rc_dash, snap = tool("dashboard", [journal, "--once", "--json"])
rc_copy, _ = tool("directive_producer", ["--stream", stream, "--out", copy])
rc_scen, _ = tool("directive_producer", ["--scenario", "eclipse_censor",
                                         "--out", scen])
leaked = sorted(n for n, m in sys.modules.items() if m is not None and (
    n == "jax" or n.startswith("jax.") or n == "go_libp2p_pubsub_tpu"
    or n.startswith("go_libp2p_pubsub_tpu.")))
print(json.dumps({"rc": [rc_dash, rc_copy, rc_scen],
                  "snapshot": json.loads(snap), "leaked": leaked}))
"""


def rpc_stream(seed: int, target: int) -> bytes:
    """A seeded uvarint-framed RPC stream of at least ``target`` bytes with
    every frame kind: subscriptions, publishes with and without ``from``,
    ``seqno``, ``key`` and ``signature`` (seqnos over the whole 64-bit
    range, the edge values among them, and short ones), IHAVE/IWANT, GRAFT,
    PRUNE with PX records (signed or not) and backoff, and publishes with
    an empty topic."""
    import random

    from go_libp2p_pubsub_tpu_torch.core import types as T
    from go_libp2p_pubsub_tpu_torch.pb import codec
    gen = random.Random(seed)
    topics = [f"topic-{i}" for i in range(24)]
    mids = [gen.randbytes(20).decode("latin-1") for _ in range(512)]
    out = bytearray()
    edges = list(SEQNO_EDGES)
    while len(out) < target:
        rpc = T.RPC()
        for _ in range(gen.randrange(4)):
            rpc.subscriptions.append(T.SubOpts(gen.random() < 0.6,
                                               gen.choice(topics)))
        for _ in range(gen.randrange(5)):
            m = T.Message(data=gen.randbytes(gen.randrange(1024)),
                          topic=gen.choice(topics)
                          if gen.random() < 0.95 else "")
            if gen.random() < 0.8:
                m.from_peer = f"12D3KooW{gen.randrange(1 << 30):x}"
            r = gen.random()
            if edges:
                m.seqno = edges.pop().to_bytes(8, "big")
            elif r < 0.8:
                m.seqno = gen.getrandbits(64).to_bytes(8, "big")
            elif r < 0.9:
                m.seqno = gen.randbytes(gen.randrange(1, 8))
            if gen.random() < 0.5:
                m.signature = gen.randbytes(64)
            if gen.random() < 0.3:
                m.key = gen.randbytes(36)
            rpc.publish.append(m)
        if gen.random() < 0.7:
            c = T.ControlMessage()
            for _ in range(gen.randrange(3)):
                c.ihave.append(T.ControlIHave(
                    topic=gen.choice(topics),
                    message_ids=gen.sample(mids, gen.randrange(12))))
            for _ in range(gen.randrange(2)):
                c.iwant.append(T.ControlIWant(
                    message_ids=gen.sample(mids, gen.randrange(1, 8))))
            for _ in range(gen.randrange(3)):
                c.graft.append(T.ControlGraft(topic=gen.choice(topics)))
            for _ in range(gen.randrange(2)):
                pr = T.ControlPrune(topic=gen.choice(topics),
                                    backoff=float(gen.randrange(1, 120)))
                for _ in range(gen.randrange(4)):
                    pr.peers.append(T.PeerInfo(
                        peer_id=f"px{gen.randrange(1 << 20)}",
                        signed_peer_record=gen.randbytes(48)
                        if gen.random() < 0.5 else None))
                c.prune.append(pr)
            if not c.is_empty():
                rpc.control = c
        out += codec.frame_rpc(rpc)
    return bytes(out)


def _phase12_cpu(conn, work):
    """Child process: phase 12's CPU half. The seeded RPC stream written to
    ``work``, ``read_frames`` of it re-framed against it, and the
    supervisor drill on the CPU (its stage lines and the fingerprints of
    its final states)."""
    sys.path.insert(0, REPO)
    import torch
    torch.set_num_threads(2)
    from go_libp2p_pubsub_tpu_torch import supervisor_smoke
    from go_libp2p_pubsub_tpu_torch.pb import codec
    from go_libp2p_pubsub_tpu_torch.sim import state_to_numpy
    t0 = time.perf_counter()
    data = rpc_stream(RPC_SEED, RPC_STREAM_BYTES)
    gen_s = time.perf_counter() - t0
    path = os.path.join(work, "rpc_stream.bin")
    with open(path, "wb") as f:
        f.write(data)
    t0 = time.perf_counter()
    rpcs = codec.read_frames(data)
    reframed = b"".join(codec.frame_rpc(r) for r in rpcs) == data
    roundtrip_s = time.perf_counter() - t0
    lines, finals = [], {}
    rc = supervisor_smoke.run_smoke(os.path.join(work, "smoke_cpu"),
                                    emit=lines.append, device="cpu",
                                    finals=finals)
    conn.send({"stream": path, "frames": len(rpcs), "gen_s": gen_s,
               "reframed": reframed, "roundtrip_s": roundtrip_s,
               "smoke_rc": rc, "smoke_lines": lines,
               "finals": {k: _fingerprint(state_to_numpy(v))
                          for k, v in finals.items()}})
    conn.close()


class Smoke:
    def __init__(self):
        import torch
        self.torch = torch
        self.dev = torch.device("cuda")
        self.n = N_FULL
        self.results = {}
        self.path_launches = {}
        # label -> (cfg, tp, state): the paths phase 5 captures, each held
        # from its own phase
        self.capture_paths = {}
        # files one phase leaves for a later one (removed by main)
        self.work = tempfile.mkdtemp(prefix="chip_smoke_")
        self.phase7c = None

    # ---- helpers ---------------------------------------------------------
    def sync(self):
        self.torch.cuda.synchronize()

    def smi_line(self):
        """The card's name and power limit as nvidia-smi gives them."""
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        return smi.splitlines()[0] if smi else "nvidia-smi: no output"

    def spin_cycles_per_ms(self):
        """The rate of the card's spin kernel (torch.cuda._sleep), by
        CUDA events."""
        torch = self.torch
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(10 ** 7)
        b.record()
        b.synchronize()
        return 10 ** 7 / a.elapsed_time(b)

    def time_ms(self, fn, reps=REPS, rounds=5):
        """Device milliseconds per call of ``fn()``: ``reps`` calls queued
        back to back between two CUDA events, behind a spin kernel long
        enough that the host enqueues them all before the first one runs,
        so the wrappers' host time is hidden (a call lasting a few
        microseconds on the card costs tens on the host). Median over
        ``rounds``. A call whose first run takes over SLOW_CALL_MS (the
        plain versions at the full paths' shapes) is timed one call a
        round, median of 3 rounds."""
        torch = self.torch
        if not hasattr(self, "spin_rate"):
            self.spin_rate = self.spin_cycles_per_ms()
        t0 = time.perf_counter()
        fn()
        self.sync()
        host_ms = (time.perf_counter() - t0) * 1e3
        if host_ms > SLOW_CALL_MS:
            # a call this long needs no batching to be timed
            reps, rounds = 1, 3
        spin = int(self.spin_rate * (2 * reps * host_ms + 1))
        times = []
        for _ in range(rounds):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(spin)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / reps)
        return statistics.median(times)

    def rand_words(self, gen, *shape, density=0.5):
        """int32 words whose bits are set with probability ``density``."""
        torch = self.torch
        bits = torch.rand(*shape, 32, generator=gen, device=self.dev) < density
        from go_libp2p_pubsub_tpu_torch.ops.bits import pack_bool
        return pack_bool(bits)[..., 0]

    def topic_bits(self, gen, t, w):
        """[T, W] disjoint per-topic message sets (a random topic or none
        per message)."""
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch.ops.bits import pack_bool
        topic = torch.randint(-1, t, (w * 32,), generator=gen, device=self.dev)
        return pack_bool(topic[None, :] == torch.arange(t, device=self.dev)[:, None])

    # ---- phase 2: each kernel against its plain version -------------------
    def check_kernel(self, name, case, kernel_fn, plain_fn, inputs, nbytes,
                     ops, library_fn=None, lookups=0, sectors=0.0):
        """Run the kernel and its plain version on clones of ``inputs``;
        exact equality of every output (float32 outputs compared as their
        bits); times; bound. ``library_fn`` is the one PyTorch call that
        computes the same function, timed beside the kernel, or a dict of
        such calls by label, of which the fastest is kept. ``lookups``
        table reads of ``sectors`` L2 sectors each (computed, not measured)
        give the sector traffic, printed with its rate over the kernel's
        time and not kept in the results."""
        torch = self.torch

        def clone():
            return [x.clone() if isinstance(x, torch.Tensor) else x
                    for x in inputs]

        got = kernel_fn(*clone())
        want = plain_fn(*clone())
        self.sync()
        got = list(got) if isinstance(got, (tuple, list)) else [got]
        want = list(want) if isinstance(want, (tuple, list)) else [want]
        max_err = 0
        for i, (g, w_) in enumerate(zip(got, want)):
            if g.shape != w_.shape or g.dtype != w_.dtype:
                raise AssertionError(f"{name}[{case}] output {i}: "
                                     f"{tuple(g.shape)}/{g.dtype} vs "
                                     f"{tuple(w_.shape)}/{w_.dtype}")
            if g.dtype == torch.float32:
                g, w_ = g.view(torch.int32), w_.view(torch.int32)
            diff = (g.long() - w_.long()).abs()
            err = int(diff.max()) if diff.numel() else 0
            if err:
                idx = (diff != 0).nonzero()[0].tolist()
                raise AssertionError(
                    f"{name}[{case}] output {i} differs from the plain "
                    f"version at {idx}: {int(g[tuple(idx)])} vs "
                    f"{int(w_[tuple(idx)])}")
            max_err = max(max_err, err)
        fixed = clone()
        ms = self.time_ms(lambda: kernel_fn(*fixed))
        plain_ms = self.time_ms(lambda: plain_fn(*fixed), reps=5)
        libs = {} if library_fn is None else (
            library_fn if isinstance(library_fn, dict) else {"": library_fn})
        lib_ms = {label: self.time_ms(fn) for label, fn in libs.items()}
        library_ms = min(lib_ms.values()) if lib_ms else None
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = ops / INT32_OPS_PER_S * 1e3
        row = dict(case=case, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms,
                   bound_ms=max(bound_bytes, bound_ops),
                   bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                   bytes=nbytes, ops=ops)
        lib = "".join(f", library{' ' + label if label else ''} {t:.4f} ms"
                      for label, t in lib_ms.items())
        sec = ""
        if lookups:
            traffic = lookups * sectors * SECTOR
            sec = (f"; {sectors:.3f} table sectors per lookup (computed from "
                   f"the indices, not measured), {traffic / 1e6:.1f} MB of "
                   f"sectors at {traffic / (ms * 1e-3) / 1e12:.2f} TB/s")
        print(f"kernel {name} [{case}]: equal to its plain version "
              f"(max_abs_err {max_err}); {ms:.4f} ms, plain {plain_ms:.4f} ms"
              f"{lib}, bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
              f"({nbytes / 1e6:.1f} MB, {ops / 1e6:.1f} M int ops){sec}",
              flush=True)
        self.results.setdefault(name, []).append(row)

    def phase_kernels(self):
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch.ops import hopkernel as hk
        from go_libp2p_pubsub_tpu_torch.ops import permgather as pg
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(0)
        n, k, m = self.n, K, M
        w = (m + 31) // 32
        u8 = torch.uint8

        def nb(*xs):
            return sum(x.numel() * x.element_size() for x in xs)

        def nbr_tab():
            return torch.randint(0, n, (n, k), generator=gen, device=self.dev,
                                 dtype=torch.int32)

        def bool_u8(*shape, p=0.5):
            return (torch.rand(*shape, generator=gen, device=self.dev) < p).to(u8)

        # edge_table: the heartbeat's exchanges at B = 2 and 1 planes (T=1),
        # and B = 6 (T=3)
        for b_planes, case in ((2, "B=2,T=1"), (1, "B=1,T=1"), (6, "B=6,T=3")):
            wb = (b_planes * k + 31) // 32
            table = self.rand_words(gen, n, wb, density=0.2)
            jn = nbr_tab()
            rk = torch.randint(0, k, (n, k), generator=gen, device=self.dev,
                               dtype=torch.int32)
            self.check_edge_table(case, table, jn, rk, b_planes)

        for t in (1, 3):
            tb = self.topic_bits(gen, t, w)
            nbr = nbr_tab()
            # hop
            tabs = [self.rand_words(gen, w, n, density=d)
                    for d in (0.05, 0.3, 0.3, 0.1, 0.9, 0.05, 0.2)]
            valid_msg = self.rand_words(gen, w, 1, density=0.9)
            fwd = bool_u8(n, t, k, p=0.3)
            mesh = bool_u8(n, t, k, p=0.3)
            cnt = [torch.randint(0, 256, (t, k, n), generator=gen,
                                 device=self.dev, dtype=torch.int32).to(u8)
                   for _ in range(3)]
            hop_in = tabs + [valid_msg, nbr, fwd, mesh, tb] + cnt
            hop_bytes = nb(*hop_in) + nb(*tabs[:4]) + nb(*cnt)
            self.check_kernel("hop", f"T={t}", hk.hop, hk.hop_plain, hop_in,
                              hop_bytes, n * k * w * (16 + 8 * t))
            # iwant_resolve; at T = 1 also with nothing pending
            pend = torch.randint(-1, k, (n, m), generator=gen, device=self.dev,
                                 dtype=torch.int32)
            rtabs = [self.rand_words(gen, w, n, density=d)
                     for d in (0.5, 0.3, 0.9, 0.05)]
            alive = self.rand_words(gen, w, 1, density=0.9)
            data_ok = bool_u8(n, k, p=0.9)
            res_in = [pend] + rtabs + [alive, data_ok, tb, nbr]
            self.check_resolve(f"T={t}", res_in, m)
            if t == 1:
                self.check_resolve("T=1,empty pend",
                                   [torch.full_like(pend, -1)] + res_in[1:],
                                   m)
            # emit, unbudgeted (budget = M) and budgeted (5 < M)
            window = self.rand_words(gen, w, n, density=0.3)
            have = self.rand_words(gen, w, n, density=0.5)
            gossip = bool_u8(n, t, k, p=0.2)
            emit_in = [window, have, gossip, tb, nbr]
            for budget in ((m, 5) if t == 1 else (m,)):
                self.check_kernel(
                    "emit", f"T={t},budget={budget}",
                    lambda *a, b=budget: hk.emit(*a, m, b),
                    lambda *a, b=budget: hk.emit_plain(*a, m, b),
                    emit_in, nb(*emit_in) + n * m * 4,
                    n * k * w * (8 + 2 * t) + n * m)

    def phase_gather_kernels(self):
        """The gathers of the non-fused data path (the bit-table exchange and
        kernels 5-7) at the churn path's shapes. Each is an index copy: no arithmetic, so the bound is
        the bytes. The index contract (pre-clipped, not bounds-checked in
        the kernels) is asserted here, before each launch."""
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch.ops import mxutake as mt
        from go_libp2p_pubsub_tpu_torch.ops import permgather as pg
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(0)
        n, k, w = N_CHURN, K, M // 32

        def nb(*xs):
            return sum(x.numel() * x.element_size() for x in xs)

        def index(hi, *shape):
            x = torch.randint(0, hi, shape, generator=gen, device=self.dev,
                              dtype=torch.int32)
            if not bool(((x >= 0) & (x < hi)).all()):
                raise AssertionError("index out of range")
            return x

        # edge_table at the churn path's heartbeat exchanges (T=4): B = 2T =
        # 8 planes (GRAFT/PRUNE, then gossip/forward) and B = T = 4 (the
        # refusals), a [N, B*K/32] word table
        jn, rk = index(n, n, k), index(k, n, k)
        for b_planes in (8, 4):
            table = self.rand_words(gen, n, b_planes * k // 32, density=0.2)
            self.check_edge_table(f"B={b_planes},T=4,N={n}", table, jn, rk,
                                  b_planes)
        # gather_words: out[w, k, n] = x_w[w, nbr[n, k]], at the churn
        # path's [2, 51200] x [51200, 32] and the headline's [2, 102400]
        for nn in (n, N_FULL):
            x_w = self.rand_words(gen, w, nn)
            nbr = index(nn, nn, k)
            self.check_gather_words(f"W={w},N={nn}", x_w, nbr)
            print(f"interleave of the [{w}, {nn}] table into rows "
                  f"(x_w.T.contiguous(), inside the gather_words and "
                  f"take_words wrappers): "
                  f"{self.time_ms(lambda x=x_w: x.T.contiguous()):.4f} ms",
                  flush=True)
        # gather_words beyond one staged nbr tile (K = 383 is one 48 KB
        # chunk; larger K goes in chunks of 382 slots)
        nk_n = 8192
        for kk in (383, 384, 512, 1000):
            self.check_gather_words(f"W={w},N={nk_n},K={kk}",
                                    self.rand_words(gen, w, nk_n),
                                    index(nk_n, nk_n, kk))
        # permutation_gather: out[n, k] = payload[jn[n, k], rk[n, k]], the
        # churn exchange's packed bit-planes (int32) and a float32 payload
        jn64, rk64 = jn.long(), rk.long()
        for dtype in (torch.int32, torch.float32):
            payload = self.rand_words(gen, n, k).view(dtype)
            self.check_kernel(
                "permutation_gather", f"{dtype},N={n}", pg.permutation_gather,
                pg.permutation_gather_plain, [payload, jn, rk],
                nb(payload, jn, rk) + n * k * 4, 0,
                library_fn=lambda p=payload: p[jn64, rk64])
        self.check_permutation_edges(gen, n, k, index)
        # take_words: out[w, r] = x_w[w, idx[r]] at its call shapes under
        # edge_gather_mode="mxu": the words gather ([2, N], R = N*K, the
        # wrapper interleaving the table into rows), the bit-table
        # exchanges as n-major rows ([N, 8] and [N, 4]) and the last one
        # with the IWANT answer rows ([N, 8 + 2]), churn's payload as one
        # [N*K, 1] table; then W = 1, W = 3 and R = N*K - 7.
        for rows, cols, r, case in ((w, n, n * k, "words"),
                                    (8, n, n * k, "bit-table B=8"),
                                    (4, n, n * k, "bit-table B=4"),
                                    (8 + w, n, n * k, "bit-table+answers"),
                                    (1, n * k, n * k, "payload"),
                                    (1, n, n * k, "W=1"),
                                    (3, n, n * k, "W=3"),
                                    (w, n, n * k - 7, "R=N*K-7")):
            idx = index(cols, r)
            if case.startswith(("bit-table", "payload")):
                self.check_take_rows(f"{case},[{cols},{rows}] rows,R={r}",
                                     self.rand_words(gen, cols, rows), idx)
                continue
            self.check_take_words(f"{case},[{rows},{cols}],R={r}",
                                  self.rand_words(gen, rows, cols), idx)

    def phase_select_kernels(self):
        """``select_rows``, the heartbeat's selections, in each mode against
        its plain twin at the main path's [102400, 1, 32] and the churn
        path's [51200, 4, 32]: mask density 0.5, counts from -2 to K + 2,
        the score and the median's values a [N, 1, K] plane broadcast over
        the topics (as the heartbeat passes ``sb``) in quarters, so rows
        hold ties; at the main shape random also with counts on 10% of
        rows. The bound counts what a launch needs: every count and output
        byte, the mask of each row with a count, the values of each row it
        does not skip (the plane's rows once), and in random mode
        DRAW_OPS integer ops for each masked slot of those rows."""
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.ops import selection as sel
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(0)
        key = rng.PRNGKey(7, device=self.dev)

        def rand(*shape):
            return torch.rand(*shape, generator=gen, device=self.dev)

        for n, t in ((self.n, 1), (N_CHURN, 4)):
            mask = rand(n, t, K) < 0.5
            count = torch.randint(-2, K + 3, (n, t), generator=gen,
                                  device=self.dev)
            sparse = torch.where(rand(n, t) < 0.1, count.abs() + 1, 0)
            noise = rand(n, t, K)
            plane = torch.randint(-8, 9, (n, 1, K), generator=gen,
                                  device=self.dev).float() / 4
            r = n * t
            for mode, cnt in (("random", count), ("random", sparse),
                              ("noise", count), ("top", count),
                              ("median", None)):
                has = mask.any(-1) if cnt is None else cnt > 0
                live = has & mask.any(-1)
                nbytes = (r * K + 4 * r if mode == "median"
                          else 8 * r + r * K + int(has.sum()) * K)
                if mode == "noise":
                    nbytes += 4 * K * int(live.sum())
                elif mode in ("top", "median"):
                    nbytes += 4 * K * int(live.any(-1).sum())
                ops = (DRAW_OPS * int((mask & live[..., None]).sum())
                       if mode == "random" else 0)
                case = (f"{mode},[{n},{t},{K}]"
                        + (",counts on 10% of rows" if cnt is sparse else ""))
                if mode == "random":
                    fns = (lambda m, c, k: sel.select_random(m, c, k),
                           lambda m, c, k: sel.select_random_plain(m, c, k))
                    inputs = [mask, cnt, key]
                elif mode == "noise":
                    fns = (lambda m, c, z: sel.select_random(m, c, None,
                                                             noise=z),
                           lambda m, c, z: sel.select_random_plain(
                               m, c, None, noise=z))
                    inputs = [mask, cnt, noise]
                elif mode == "top":
                    fns = (lambda m, c, p: sel.select_top(
                               p.expand(m.shape), m, c),
                           lambda m, c, p: sel.select_top_plain(
                               p.expand(m.shape), m, c))
                    inputs = [mask, cnt, plane]
                else:
                    fns = (lambda m, p: sel.masked_median(p.expand(m.shape),
                                                          m),
                           lambda m, p: sel.masked_median_plain(
                               p.expand(m.shape), m))
                    inputs = [mask, plane]
                self.check_kernel("select_rows", case, *fns, inputs, nbytes,
                                  ops)

    def check_permutation_edges(self, gen, n, k, index):
        """permutation_gather at an N*K that is no multiple of 4, and with
        jn, rk and out at a storage offset of one element, 4 bytes past a
        16-byte boundary. The launch with the offset output goes to the
        kernel directly (the wrapper allocates its own output); its offset
        views are made once, outside the timed calls."""
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch.ops import cudalib
        from go_libp2p_pubsub_tpu_torch.ops import permgather as pg
        payload = self.rand_words(gen, n, k)
        nbytes = 4 * payload.numel()
        nt, kt = n - 1, k - 1                       # N*K = 1587169, odd
        jt, rt = index(n, nt, kt), index(k, nt, kt)
        self.check_kernel(
            "permutation_gather",
            f"int32,[{nt},{kt}] edges,N*K%4={nt * kt % 4}",
            pg.permutation_gather, pg.permutation_gather_plain,
            [payload, jt, rt], nbytes + 3 * 4 * nt * kt, 0,
            library_fn=lambda j=jt.long(), r=rt.long(): payload[j, r])
        jn, rk = index(n, n, k), index(k, n, k)

        def offset(x):
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
            view = buf[1:].view(x.shape)
            view.copy_(x)
            return view

        jo, ro, oo = offset(jn), offset(rk), offset(torch.zeros_like(jn))
        if not all(x.data_ptr() % 16 for x in (jo, ro, oo)):
            raise AssertionError("offset views landed on 16-byte boundaries")

        def offset_launch(p, _j, _r):
            cudalib.launch("permutation_gather", p, jo, ro, oo, n, k, k)
            return oo

        self.check_kernel(
            "permutation_gather", f"int32,N={n},jn/rk/out at offset 1",
            offset_launch, pg.permutation_gather_plain, [payload, jn, rk],
            nbytes + 3 * 4 * n * k, 0,
            library_fn=lambda j=jn.long(), r=rk.long(): payload[j, r])

    def check_gather_words(self, case, x_w, nbr):
        """``gather_words`` (the wrapper: interleave, then the kernel)
        against its plain version; library ``x_w[:, nbr.T]``."""
        from go_libp2p_pubsub_tpu_torch.ops import permgather as pg
        w = x_w.shape[0]
        n, k = nbr.shape
        self.check_kernel(
            "gather_words", case, pg.gather_words, pg.gather_words_plain,
            [x_w, nbr], (x_w.numel() + nbr.numel() + w * k * n) * 4, 0,
            library_fn=lambda x=x_w, i=nbr.long(): x[:, i.T],
            lookups=n * k, sectors=row_sectors(nbr, w))

    def check_take_words(self, case, x_w, idx):
        """``take_words`` (the wrapper: interleave, then the kernel, out
        word-major) against its plain version; library ``x_w[:, idx]``."""
        from go_libp2p_pubsub_tpu_torch.ops import mxutake as mt
        w = x_w.shape[0]
        r = idx.shape[0]
        self.check_kernel(
            "take_words", case, mt.take_words, mt.take_words_plain,
            [x_w, idx], (x_w.numel() + r + w * r) * 4, 0,
            library_fn=lambda x=x_w, i=idx.long(): x[:, i],
            lookups=r, sectors=row_sectors(idx, w))

    def check_take_rows(self, case, tab, idx):
        """``take_rows`` (the take kernel on an n-major table, rows out)
        against its plain version. Library: the faster of
        ``tab.index_select(0, idx)`` and the column index ``x_w[:, idx]`` of
        the same table word-major (transposed beforehand, not timed)."""
        from go_libp2p_pubsub_tpu_torch.ops import mxutake as mt
        w, r = tab.shape[1], idx.shape[0]
        idx64, x_w = idx.long(), tab.T.contiguous()
        self.check_kernel(
            "take_words", case, mt.take_rows, mt.take_rows_plain,
            [tab, idx], (tab.numel() + r + w * r) * 4, 0,
            library_fn={"index_select": lambda: tab.index_select(0, idx64),
                        "x_w[:, idx]": lambda: x_w[:, idx64]},
            lookups=r, sectors=row_sectors(idx, w))

    def check_edge_table(self, case, table, jn, rk, b_planes):
        """``edge_table`` against its plain version; the bound counts the
        caller's table, jn, rk and the output words."""
        from go_libp2p_pubsub_tpu_torch.ops import permgather as pg
        nr, k = jn.shape
        nbytes = (table.numel() + jn.numel() + rk.numel()
                  + (b_planes + 31) // 32 * nr * k) * 4
        self.check_kernel("edge_table", case, pg.edge_table,
                          pg.edge_table_plain, [table, jn, rk, b_planes],
                          nbytes, nr * k * b_planes * 6)

    def check_resolve(self, case, res_in, m):
        """``iwant_resolve`` against its plain version. The bound counts
        what these inputs need: the pend rows, alive, the topic words and
        every output always; a receiver's nbr and data_ok rows and its
        have/vm/inv_n words only where some alive message is pending from
        a slot (the kernel skips the others), and the answer table once
        where any slot is asked. Prints the share of pend rows with a
        message pending and the answer-row lookups the inputs need."""
        from go_libp2p_pubsub_tpu_torch.ops import hopkernel as hk
        from go_libp2p_pubsub_tpu_torch.ops.bits import unpack_words
        torch = self.torch
        pend, answers, have, vm, inv_n, alive, data_ok, tb, nbr = res_in
        n, k = nbr.shape
        w, t = answers.shape[0], tb.shape[0]
        al = unpack_words(alive, m)[0]                     # [M] bool
        asked = (pend >= 0) & (pend < k) & al[None, :]     # [N, M]
        live = int(asked.any(1).sum())
        slots = torch.zeros((n, k + 1), dtype=torch.bool, device=pend.device)
        slots.scatter_(1, torch.where(asked, pend, k).long(), True)
        lookups = int(slots[:, :k].sum())
        nonempty = float((pend >= 0).any(1).double().mean())
        print(f"iwant_resolve [{case}]: {100 * nonempty:.2f}% of pend rows "
              f"hold a pending message, {live} receivers with an alive ask, "
              f"{lookups} answer-row lookups", flush=True)
        nbytes = ((pend.numel() + alive.numel() + tb.numel()) * 4
                  + 2 * w * n * 4 + (2 * t + 1) * k * n
                  + live * (k * 4 + k + 3 * w * 4)
                  + (answers.numel() * 4 if lookups else 0))
        ops = n * m * 8 + live * k * w * (20 + 6 * t)
        self.check_kernel("iwant_resolve", case,
                          lambda *a: hk.iwant_resolve(*a, m),
                          lambda *a: hk.iwant_resolve_plain(*a, m),
                          res_in, nbytes, ops)

    def record_calls(self, targets, fn):
        """Run ``fn()`` with each ``(module, name)`` of ``targets`` wrapped
        so that its calls are recorded (tensor arguments cloned before the
        call, which may update some in place). Returns name -> [(args,
        kwargs)]."""
        torch = self.torch
        calls = {name: [] for _, name in targets}
        orig = [(mod, name, getattr(mod, name)) for mod, name in targets]

        def recorder(name, fn_):
            def call(*args, **kwargs):
                calls[name].append(([a.clone() if isinstance(a, torch.Tensor)
                                     else a for a in args], dict(kwargs)))
                return fn_(*args, **kwargs)
            return call

        for mod, name, fn_ in orig:
            setattr(mod, name, recorder(name, fn_))
        try:
            fn()
        finally:
            for mod, name, fn_ in orig:
                setattr(mod, name, fn_)
        self.sync()
        return calls

    def real_index_kernels(self, st):
        """The gathers on the churn state's own neighbour indices and
        reverse slots (clipped as the path clips them), beside phase 2's
        uniform random ones: the words gather and the words take at [2, N],
        the bit-table+answers take at [N, 10], the bit-table exchange at
        B = 8 and 4, the payload permute."""
        torch = self.torch
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(1)
        n, k = st.neighbors.shape
        w = M // 32
        empty = float((st.neighbors < 0).double().mean())
        print(f"churn state's neighbour slots: {100 * empty:.2f}% empty "
              f"(clipped to row 0 below)", flush=True)
        nbr = st.neighbors.clamp(0, n - 1)
        self.check_gather_words(f"W={w},N={n},real nbr",
                                self.rand_words(gen, w, n), nbr)
        self.check_take_words(f"words,[{w},{n}],R={n * k},real nbr",
                              self.rand_words(gen, w, n),
                              nbr.T.reshape(-1).contiguous())
        self.check_take_rows(f"bit-table+answers,[{n},{8 + w}] rows,"
                             f"R={n * k},real jn",
                             self.rand_words(gen, n, 8 + w), nbr.reshape(-1))
        # the bit-table exchange and the payload permute on the state's own
        # jn and rk (empty slots clipped to row 0 and slot 0, as the
        # heartbeat and churn clip them)
        rk = st.reverse_slot.clamp(0, k - 1)
        for b_planes in (8, 4):
            self.check_edge_table(f"B={b_planes},T=4,N={n},real jn/rk",
                                  self.rand_words(gen, n, b_planes * k // 32,
                                                  density=0.2),
                                  nbr, rk, b_planes)
        from go_libp2p_pubsub_tpu_torch.ops import permgather as pg
        payload = self.rand_words(gen, n, k)
        self.check_kernel(
            "permutation_gather", f"int32,N={n},real jn/rk",
            pg.permutation_gather, pg.permutation_gather_plain,
            [payload, nbr, rk], 4 * 4 * n * k, 0,
            library_fn=lambda j=nbr.long(), r=rk.long(): payload[j, r])

    # ---- phase 3: the main path at full size ------------------------------
    def phase_main(self, topo):
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.ops import cudalib
        from go_libp2p_pubsub_tpu_torch.sim import (build_headline,
                                                    delivery_fraction,
                                                    mesh_degrees, run)
        from go_libp2p_pubsub_tpu_torch.sim.invariants import (
            VIOLATION_MASK, decode_flags)
        cfg, tp, st = build_headline(self.n, device=self.dev, topo=topo)
        key = rng.PRNGKey(0, device=self.dev)
        self.sync()
        cudalib.reset_launches()
        t0 = time.perf_counter()
        out = run(st, cfg, tp, key, 8, device=self.dev)
        self.sync()
        secs = time.perf_counter() - t0
        launches = dict(cudalib.LAUNCHES)
        deg = mesh_degrees(out).float()
        flags = int(out.fault_flags) & 0xFFFFFFFF
        delivered = float(out.delivered_total)
        print(f"main path: build_headline({self.n}) x 8 ticks in {secs:.3f} s "
              f"= {8 / secs:.3f} hb/s; delivery_fraction "
              f"{float(delivery_fraction(out, cfg)):.6f} (settled, age>=2: "
              f"{float(delivery_fraction(out, cfg, min_age_ticks=2)):.6f}); "
              f"mesh degree min/mean/max {float(deg.min()):.0f}/"
              f"{float(deg.mean()):.4f}/{float(deg.max()):.0f}; "
              f"delivered_total {delivered:.0f}; fault_flags 0x{flags:08x}",
              flush=True)
        print(f"main path launches: {json.dumps(launches)}", flush=True)
        self.check_launches("headline", launches, cfg)
        if delivered <= 0:
            raise AssertionError("the main path delivered nothing")
        if flags & VIOLATION_MASK:
            raise AssertionError(f"invariant violations: "
                                 f"{decode_flags(flags)}")
        self.capture_paths["headline"] = (cfg, tp, out)
        self.real_fused_kernels(out, cfg, tp)

    def real_fused_kernels(self, st, cfg, tp):
        """One more tick of the headline from ``st`` with its heartbeat's
        edge_table calls and its iwant_resolve, hop and emit calls
        recorded; the four kernels checked and timed on those inputs as in
        phase 2, beside the random-input cases. Then the pull path: two
        ticks with ``prop_substeps=1`` (the configuration
        tests/test_torch_slice.py uses to exercise pulls), the second one's
        iwant_resolve recorded, checked and timed."""
        import dataclasses
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.ops import heartbeat as hb
        from go_libp2p_pubsub_tpu_torch.ops import hopkernel as hk
        from go_libp2p_pubsub_tpu_torch.ops import propagate
        from go_libp2p_pubsub_tpu_torch.ops.bits import popcount
        from go_libp2p_pubsub_tpu_torch.sim import step
        targets = [(hb, "edge_table"), (propagate, "iwant_resolve"),
                   (propagate, "hop"), (propagate, "emit")]
        calls = self.record_calls(targets, lambda: step(
            st, cfg, tp, rng.PRNGKey(1, device=self.dev), device=self.dev))
        if (not calls["hop"] or len(calls["emit"]) != 1
                or len(calls["iwant_resolve"]) != 1
                or [a[3] for a, _ in calls["edge_table"]] != [2, 1, 2]):
            raise AssertionError(
                f"the recorded tick made {len(calls['hop'])} hops, "
                f"{len(calls['emit'])} emits, "
                f"{len(calls['iwant_resolve'])} resolves and edge_table "
                f"calls at B={[a[3] for a, _ in calls['edge_table']]}")

        def nb(*xs):
            return sum(x.numel() * x.element_size() for x in xs
                       if isinstance(x, torch.Tensor))

        def live_slots(plane):
            return float((plane != 0).any(1).double().mean())

        for i, (args, _) in enumerate(calls["edge_table"]):
            self.check_edge_table(f"B={args[3]},real tick,call {i + 1}",
                                  *args[:4])
        args, _ = calls["iwant_resolve"][0]
        self.check_resolve("T=1,real tick", args[:9], args[9])
        bits = [int(popcount(a[0]).sum()) for a, _ in calls["hop"]]
        hop_in = calls["hop"][bits.index(max(bits))][0]
        w, n = hop_in[1].shape
        k, t = hop_in[8].shape[1], hop_in[11].shape[0]
        print(f"real headline tick: {len(bits)} hops, frontier bits per hop "
              f"{bits}; slots whose fwd plane allows a topic "
              f"{100 * live_slots(hop_in[9]):.2f}% (hop loads those rows "
              f"only)", flush=True)
        self.check_kernel("hop", f"T={t},real tick, busiest hop", hk.hop,
                          hk.hop_plain, hop_in,
                          nb(*hop_in) + 4 * w * n * 4 + nb(*hop_in[12:]),
                          n * k * w * (16 + 8 * t))
        args, kwargs = calls["emit"][0]
        emit_in, m = args[:5], args[5]
        budget = kwargs.get("budget", args[6] if len(args) > 6 else None)
        print(f"real headline tick: emit budget {budget}, M {m}; slots whose "
              f"gossip plane allows a topic "
              f"{100 * live_slots(emit_in[2]):.2f}% (emit loads those rows "
              f"only)", flush=True)
        self.check_kernel(
            "emit", f"T={t},budget={budget},real tick",
            lambda *a: hk.emit(*a, m, budget),
            lambda *a: hk.emit_plain(*a, m, budget), emit_in,
            nb(*emit_in) + n * m * 4, n * k * w * (8 + 2 * t) + n * m)

        # the pull path: a tick with one forwarding hop leaves IWANTs
        # pending, which the next tick's resolve answers
        cfg1 = dataclasses.replace(cfg, prop_substeps=1)
        st1 = step(st, cfg1, tp, rng.PRNGKey(2, device=self.dev),
                   device=self.dev)
        calls = self.record_calls([(propagate, "iwant_resolve")], lambda: step(
            st1, cfg1, tp, rng.PRNGKey(3, device=self.dev), device=self.dev))
        args, _ = calls["iwant_resolve"][0]
        if not bool((args[0] >= 0).any()):
            raise AssertionError("the prop_substeps=1 tick left no IWANT "
                                 "pending")
        self.check_resolve("T=1,pull tick (prop_substeps=1)", args[:9],
                           args[9])

    def check_launches(self, path, launches, cfg, forms=None):
        """Every kernel of ``path`` launched, and none it must not; the
        formulations ``cfg`` resolves to (or ``forms``) printed before."""
        print(f"{path} formulations: {forms or formulations(cfg)}",
              flush=True)
        must, must_not = PATH_KERNELS[path]
        zero = sorted(name for name in must if launches[name] == 0)
        if zero:
            raise AssertionError(f"kernels never launched on the {path} "
                                 f"path: {zero}")
        stray = sorted(name for name in must_not if launches[name] != 0)
        if stray:
            raise AssertionError(f"kernels outside the {path} path "
                                 f"launched: {stray}")
        self.path_launches[path] = launches

    # ---- phase 3b: the churn + peer-gater path at 51200 peers -------------
    def phase_churn(self, topo):
        import dataclasses

        import numpy as np
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.ops import cudalib
        from go_libp2p_pubsub_tpu_torch.sim import (delivery_fraction, run,
                                                    scenarios, state_to_numpy)
        from go_libp2p_pubsub_tpu_torch.sim.invariants import (
            VIOLATION_MASK, decode_flags)
        cfg, tp, st0 = scenarios.churn_50k(n_peers=N_CHURN, device=self.dev,
                                           topo=topo)
        self.real_index_kernels(st0)
        conn0 = int((st0.connected & (st0.neighbors >= 0)).sum())
        first = None
        # each formulation runs twice, in turns, so that neither pays the
        # process's first-call costs alone
        for gather in ("pallas", "mxu", "mxu", "pallas"):
            c = dataclasses.replace(cfg, hop_mode="xla",
                                    edge_gather_mode=gather)
            st = st0._replace(**{f: getattr(st0, f).clone()
                                 for f in st0._fields})
            key = rng.PRNGKey(0, device=self.dev)
            self.sync()
            cudalib.reset_launches()
            t0 = time.perf_counter()
            out = run(st, c, tp, key, 8, device=self.dev)
            self.sync()
            secs = time.perf_counter() - t0
            launches = dict(cudalib.LAUNCHES)
            conn1 = int((out.connected & (out.neighbors >= 0)).sum())
            flags = int(out.fault_flags) & 0xFFFFFFFF
            delivered = float(out.delivered_total)
            path = f"churn[{gather}]"
            print(f"{path}: churn_50k({N_CHURN}) hop_mode=xla x 8 ticks in "
                  f"{secs:.3f} s = {8 / secs:.3f} hb/s; delivery_fraction "
                  f"(age>=2) "
                  f"{float(delivery_fraction(out, c, min_age_ticks=2)):.6f}; "
                  f"connected edges {conn0} -> {conn1}; gater_validate sum "
                  f"{float(out.gater_validate.double().sum()):.4f}, "
                  f"gater_deliver sum "
                  f"{float(out.gater_deliver.double().sum()):.4f}, "
                  f"gater_throttle sum "
                  f"{float(out.gater_throttle.double().sum()):.4f}; "
                  f"delivered_total {delivered:.0f}; fault_flags "
                  f"0x{flags:08x}", flush=True)
            print(f"{path} launches: {json.dumps(launches)}", flush=True)
            self.check_launches(path, launches, c)
            if delivered <= 0:
                raise AssertionError(f"the {path} path delivered nothing")
            if flags & VIOLATION_MASK:
                raise AssertionError(f"{path}: invariant violations "
                                     f"{decode_flags(flags)}")
            if conn1 == conn0:
                raise AssertionError(f"{path}: no edge changed state")
            if float(out.gater_validate.sum()) <= 0:
                raise AssertionError(f"{path}: the gater counted nothing")
            self.capture_paths.setdefault(path, (c, tp, out))
            got = state_to_numpy(out)
            if first is None:
                first = got
                continue
            differ = [f for f in first if first[f].dtype != got[f].dtype
                      or not np.array_equal(first[f], got[f])]
            if differ:
                raise AssertionError(f"churn path: the {path} run ends in "
                                     f"another state than the first pallas "
                                     f"run: {differ}")
        print("churn path: the pallas, mxu, mxu and pallas runs end in the "
              "same state, every field equal", flush=True)

    # ---- phase 3c: a message window wider than the fused kernels' -------
    def phase_wide(self):
        """``build_headline(4096, msg_window=288)``: W = 9 words, int32
        hop counts, the builder's ``hop_mode="pallas"``. 4 ticks of
        ``step`` on the card and on the CPU from one key, compared after
        every tick; the card's launch counts cover its 4 ticks only."""
        import dataclasses
        import numpy as np
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.ops import cudalib
        from go_libp2p_pubsub_tpu_torch.ops.hopkernel import (
            resolve_emit_mode, resolve_hop_mode)
        from go_libp2p_pubsub_tpu_torch.sim import (build_headline, step,
                                                    state_to_numpy, topology)
        from go_libp2p_pubsub_tpu_torch.sim.invariants import (
            VIOLATION_MASK, decode_flags)
        topo = topology.sparse(N_WIDE, K, degree=12)
        devs = (self.dev, torch.device("cpu"))
        runs = []
        for d in devs:
            cfg, tp, st = build_headline(N_WIDE, msg_window=M_WIDE, device=d,
                                         topo=topo)
            runs.append((dataclasses.replace(cfg, count_dtype="int32"), tp,
                         st))
        cfg = runs[0][0]
        modes = (cfg.hop_mode, resolve_hop_mode(cfg), resolve_emit_mode(cfg))
        if modes != ("pallas", "xla", "xla"):
            raise AssertionError(f"wide window: hop_mode, resolved hop and "
                                 f"emit modes {modes}")
        keys = [rng.split(rng.PRNGKey(0, device=d), 4) for d in devs]
        card, (ccfg, ctp, cpu) = runs[0][2], runs[1]
        self.sync()
        cudalib.reset_launches()
        secs = 0.0
        for tick in range(4):
            t0 = time.perf_counter()
            card = step(card, cfg, runs[0][1], keys[0][tick], device=self.dev)
            self.sync()
            secs += time.perf_counter() - t0
            cpu = step(cpu, ccfg, ctp, keys[1][tick], device="cpu")
            a, b = state_to_numpy(card), state_to_numpy(cpu)
            for f in a:
                x, y = a[f], b[f]
                same = (np.allclose(x, y, rtol=1e-6, atol=0.0)
                        if x.dtype == np.float32 else np.array_equal(x, y))
                if not same:
                    raise AssertionError(
                        f"wide window: field {f} differs between the card "
                        f"and the CPU after tick {tick}")
        launches = dict(cudalib.LAUNCHES)
        flags = int(card.fault_flags) & 0xFFFFFFFF
        delivered = float(card.delivered_total)
        print(f"wide window: build_headline({N_WIDE}, msg_window={M_WIDE}) "
              f"W={(M_WIDE + 31) // 32}, count_dtype=int32, hop_mode "
              f"{modes[0]} -> hop {modes[1]}, emit {modes[2]}; 4 ticks on the "
              f"card in {secs:.3f} s; equal to the CPU run after every tick "
              f"(integer/bool/packed exact, float32 rtol 1e-6); "
              f"delivered_total {delivered:.0f}; fault_flags 0x{flags:08x}",
              flush=True)
        print(f"wide window launches: {json.dumps(launches)}", flush=True)
        self.check_launches("wide window", launches, cfg)
        if delivered <= 0:
            raise AssertionError("the wide-window path delivered nothing")
        if flags & VIOLATION_MASK:
            raise AssertionError(f"wide window: invariant violations "
                                 f"{decode_flags(flags)}")
        self.real_wide_kernels(card, cfg, runs[0][1])

    def real_wide_kernels(self, st, cfg, tp):
        """One more wide tick on the card from ``st`` with its heartbeat's
        edge_table calls and its words gathers recorded; every recorded
        call checked and timed as in phase 2 on its own inputs. At W = 9
        the words gather reads each row as nine 4-byte vectors with a
        block 8 lanes wide, so one lane takes a second vector."""
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.ops import heartbeat as hb
        from go_libp2p_pubsub_tpu_torch.ops import permgather as pg
        from go_libp2p_pubsub_tpu_torch.sim import step
        calls = self.record_calls(
            [(hb, "edge_table"), (pg, "gather_words")], lambda: step(
                st, cfg, tp, rng.PRNGKey(4, device=self.dev),
                device=self.dev))
        shapes = [(tuple(a[0].shape), tuple(a[1].shape))
                  for a, _ in calls["gather_words"]]
        w_wide = (M_WIDE + 31) // 32
        if not calls["edge_table"] or not any(x[0] == w_wide
                                              for x, _ in shapes):
            raise AssertionError(
                f"the recorded wide tick made edge_table calls at "
                f"B={[a[3] for a, _ in calls['edge_table']]} and words "
                f"gathers at {shapes}")
        for i, (args, _) in enumerate(calls["edge_table"]):
            self.check_edge_table(f"B={args[3]},wide tick,call {i + 1}",
                                  *args[:4])
        for i, (args, _) in enumerate(calls["gather_words"]):
            x_w, nbr = args[:2]
            self.check_gather_words(
                f"W={x_w.shape[0]},N={nbr.shape[0]},K={nbr.shape[1]},"
                f"wide tick,call {i + 1}", x_w, nbr)

    # ---- phase 3d: the data plane's branches ------------------------------
    def dataplane_paths(self, topo_full, topo_churn, topo_outage):
        """The six paths of phase 3d: (label, (cfg, tp, state), the fault
        bits the plan must inject, whether its plan cuts and heals edges).
        The routers and flood publish reuse the headline's 102400-peer
        underlay, the partitions the churn path's 51200-peer one: all are
        ``topology.sparse(n, 32, degree=12)`` at the scenarios' seed."""
        import dataclasses
        import inspect
        from go_libp2p_pubsub_tpu_torch.sim import (build_headline, scenarios,
                                                    topology)
        from go_libp2p_pubsub_tpu_torch.sim import invariants as inv
        from go_libp2p_pubsub_tpu_torch.sim.faults import (FaultPlan,
                                                           PartitionWindow)
        if inspect.signature(topology.sparse).parameters["seed"].default \
                != scenarios.SEED:
            raise AssertionError("the underlays' seed is not the scenarios'")
        dev = self.dev
        cfg, tp, st = build_headline(N_FULL, device=dev, topo=topo_full)
        flood = (dataclasses.replace(cfg, flood_publish=True), tp, st)
        part = scenarios.partition_50k(N_CHURN, start=2, heal=6, device=dev,
                                       topo=topo_churn)
        # the combined plan of tests/test_faults.py's union test
        combined = (dataclasses.replace(part[0], fault_plan=FaultPlan(
            link_drop_prob=0.2, corrupt_prob=0.5,
            partitions=(PartitionWindow(2, 5),))), part[1], part[2])
        return [
            ("floodsub", scenarios.router_sweep_100k(
                "floodsub", N_FULL, device=dev, topo=topo_full), 0, False),
            ("randomsub", scenarios.router_sweep_100k(
                "randomsub", N_FULL, device=dev, topo=topo_full), 0, False),
            ("flood publish", flood, 0, False),
            ("partition", part, inv.FAULT_PARTITION, True),
            ("combined plan", combined, inv.FAULT_LINK_DROP
             | inv.FAULT_CORRUPT | inv.FAULT_PARTITION, True),
            ("outage", scenarios.outage_10k(N_OUTAGE, start=2, heal=6,
                                            device=dev, topo=topo_outage),
             inv.FAULT_OUTAGE, True),
        ]

    def phase_dataplane(self, topo_full, topo_churn, topo_outage):
        """Each path of :meth:`dataplane_paths`: 8 ticks of ``step`` from
        one key (as ``run`` splits it), the counts reset just before and
        read just after; hb/s over the 8 ticks, delivery, fault flags (the
        plan's injected bits exactly, no violation), the edges down after
        each tick (down, then back, where the plan cuts); then one more
        tick whose kernel calls are recorded and each checked and timed as
        in phase 2 on its own inputs."""
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.ops import cudalib
        from go_libp2p_pubsub_tpu_torch.ops.hopkernel import (
            resolve_emit_mode, resolve_hop_mode)
        from go_libp2p_pubsub_tpu_torch.sim import delivery_fraction, step
        from go_libp2p_pubsub_tpu_torch.sim.invariants import (
            VIOLATION_MASK, decode_flags)
        for label, (cfg, tp, st), want_flags, cuts in self.dataplane_paths(
                topo_full, topo_churn, topo_outage):
            keys = rng.split(rng.PRNGKey(0, device=self.dev), 8)
            known = st.neighbors >= 0
            down = []
            self.sync()
            cudalib.reset_launches()
            t0 = time.perf_counter()
            for tick in range(8):
                st = step(st, cfg, tp, keys[tick], device=self.dev)
                down.append((known & ~st.connected).sum())
            self.sync()
            secs = time.perf_counter() - t0
            launches = dict(cudalib.LAUNCHES)
            down = [int(d) for d in down]
            flags = int(st.fault_flags) & 0xFFFFFFFF
            delivered = float(st.delivered_total)
            n = cfg.n_peers
            print(f"data plane [{label}]: {n} peers, router {cfg.router}, "
                  f"hop {resolve_hop_mode(cfg)}, emit "
                  f"{resolve_emit_mode(cfg)}, plan "
                  f"{cfg.fault_plan.format() if cfg.fault_plan else None}; "
                  f"8 ticks in {secs:.3f} s = {8 / secs:.3f} hb/s; "
                  f"delivery_fraction (age>=2) "
                  f"{float(delivery_fraction(st, cfg, min_age_ticks=2)):.6f}; "
                  f"edges down after each tick {down}; delivered_total "
                  f"{delivered:.0f}; fault_flags 0x{flags:08x}", flush=True)
            print(f"data plane [{label}] launches: {json.dumps(launches)}",
                  flush=True)
            self.check_launches(label, launches, cfg)
            if delivered <= 0:
                raise AssertionError(f"{label}: the path delivered nothing")
            if flags & VIOLATION_MASK:
                raise AssertionError(f"{label}: invariant violations "
                                     f"{decode_flags(flags)}")
            if flags != want_flags:
                raise AssertionError(f"{label}: fault_flags 0x{flags:x}, the "
                                     f"plan injects 0x{want_flags:x}")
            if cuts and not (max(down) > down[-1] and max(down) > down[0]):
                raise AssertionError(f"{label}: the plan's edges did not go "
                                     f"down and come back: {down}")
            if label == "combined plan":
                self.capture_paths[label] = (cfg, tp, st)
            self.check_recorded(label, st, cfg, tp)

    def check_recorded(self, label, st, cfg, tp, phase="data plane"):
        """One more tick of a path from ``st`` with every kernel wrapper
        recorded where the path calls it; each call checked against its
        plain version and timed, as in phase 2, on its own inputs."""
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.ops import churn
        from go_libp2p_pubsub_tpu_torch.ops import heartbeat as hb
        from go_libp2p_pubsub_tpu_torch.ops import hopkernel as hk
        from go_libp2p_pubsub_tpu_torch.ops import permgather as pg
        from go_libp2p_pubsub_tpu_torch.ops import propagate
        from go_libp2p_pubsub_tpu_torch.sim import step
        targets = [(hb, "edge_table"), (propagate, "iwant_resolve"),
                   (propagate, "hop"), (propagate, "emit"),
                   (pg, "gather_words"), (propagate, "permutation_gather"),
                   (churn, "permutation_gather")]
        calls = self.record_calls(targets, lambda: step(
            st, cfg, tp, rng.PRNGKey(5, device=self.dev), device=self.dev))
        counts = {name: len(c) for name, c in calls.items()}
        print(f"{phase} [{label}]: the recorded tick's calls {counts}",
              flush=True)

        def nb(*xs):
            return sum(x.numel() * x.element_size() for x in xs
                       if isinstance(x, torch.Tensor))

        for i, (args, _) in enumerate(calls["edge_table"]):
            self.check_edge_table(f"B={args[3]},{label},call {i + 1}",
                                  *args[:4])
        for i, (args, _) in enumerate(calls["iwant_resolve"]):
            self.check_resolve(f"T={args[7].shape[0]},{label},call {i + 1}",
                               args[:9], args[9])
        for i, (hop_in, _) in enumerate(calls["hop"]):
            w, n = hop_in[1].shape
            k, t = hop_in[8].shape[1], hop_in[11].shape[0]
            self.check_kernel("hop", f"T={t},{label},hop {i + 1}", hk.hop,
                              hk.hop_plain, hop_in,
                              nb(*hop_in) + 4 * w * n * 4 + nb(*hop_in[12:]),
                              n * k * w * (16 + 8 * t))
        for i, (args, kwargs) in enumerate(calls["emit"]):
            emit_in, m = args[:5], args[5]
            budget = kwargs.get("budget", args[6] if len(args) > 6 else None)
            w, n = emit_in[0].shape
            k, t = emit_in[4].shape[1], emit_in[3].shape[0]
            self.check_kernel(
                "emit", f"T={t},budget={budget},{label},call {i + 1}",
                lambda *a, m=m, b=budget: hk.emit(*a, m, b),
                lambda *a, m=m, b=budget: hk.emit_plain(*a, m, b), emit_in,
                nb(*emit_in) + n * m * 4, n * k * w * (8 + 2 * t) + n * m)
        for i, (args, _) in enumerate(calls["gather_words"]):
            x_w, nbr = args[:2]
            self.check_gather_words(
                f"W={x_w.shape[0]},N={nbr.shape[0]},{label},call {i + 1}",
                x_w, nbr)
        for i, (args, _) in enumerate(calls["permutation_gather"]):
            payload, jn, rk = args[:3]
            n, k = jn.shape
            self.check_kernel(
                "permutation_gather",
                f"{payload.dtype},N={n},{label},call {i + 1}",
                pg.permutation_gather, pg.permutation_gather_plain,
                [payload, jn, rk], nb(payload, jn, rk) + n * k * 4, 0,
                library_fn=lambda p=payload, j=jn.long(), r=rk.long():
                p[j, r])

    # ---- phase 4 / 4b: the card's trajectory against the CPU's -----------
    def phase_trajectory(self, cpu, what="headline", gather=None):
        """Phase 4's case ``(what, gather)``: 8 ticks on the card, every
        field after every tick against the CPU run's fingerprints
        (``cpu``, from :func:`_phase4_cpu`; float32 rtol 1e-6, the rest
        exact)."""
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.sim import step, state_to_numpy
        from go_libp2p_pubsub_tpu_torch.sim.invariants import VIOLATION_MASK
        label, (cfg, tp, st0) = trajectory_case(what, gather, self.dev)
        want = cpu[(what, gather)]
        keys = rng.split(rng.PRNGKey(0, device=self.dev), 8)
        st = st0
        for tick in range(8):
            st = step(st, cfg, tp, keys[tick], device=self.dev)
            _same_fingerprint(f"trajectory [{label}] after tick {tick}",
                              _fingerprint(state_to_numpy(st)), want[tick])
        extra = ""
        if what == "churn":
            extra = (f"; gater_throttle sum "
                     f"{float(st.gater_throttle.double().sum()):.4f}")
        if what.startswith("beacon"):
            sub0, sub1 = st0.subscribed, st.subscribed
            moved = (int((sub0 & ~sub1).sum()), int((~sub0 & sub1).sum()))
            if not all(moved):
                raise AssertionError(f"trajectory [{label}]: subscriptions "
                                     f"left, joined {moved}")
            extra = f"; subscriptions left {moved[0]}, joined {moved[1]}"
        flags = int(st.fault_flags) & 0xFFFFFFFF
        if flags & VIOLATION_MASK or (what == "every fault family"
                                      and flags != 0x3FF):
            raise AssertionError(f"trajectory [{label}]: fault_flags "
                                 f"0x{flags:08x}")
        print(f"trajectory [{label}]: 8 ticks on {self.dev} equal to the CPU "
              f"run (integer/bool/packed exact, float32 rtol 1e-6); "
              f"delivered_total {float(st.delivered_total):.0f}; "
              f"fault_flags 0x{flags:08x}{extra}; formulations "
              f"{formulations(cfg)}", flush=True)

    # ---- phase 4: the compact trajectory on the card against the CPU -----
    def phase_compact_trajectory(self):
        """The 1024-peer headline under compact storage, 8 ticks on the
        card and on the CPU from one stored state and one key, held
        together after every tick: each tick is decoded, stepped in the
        compute layout (``engine._tick``) and encoded on both devices; the
        integer, bool, int8, int16 and packed planes of the stored states
        exactly equal, the float32 ones within rtol 1e-6, and each bf16
        plane exact where the two devices' float32 inputs to its encode
        are bit-equal, and within one bf16 ulp where they differ (within
        rtol 1e-6)."""
        import dataclasses
        import numpy as np
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.sim import (build_headline,
                                                    decode_state,
                                                    encode_state, engine,
                                                    state_to_numpy)
        from go_libp2p_pubsub_tpu_torch.sim.state import _COMPACT_CODECS
        n = 1024
        topo = trajectory_topology("headline", n)
        devs = (self.dev, torch.device("cpu"))
        runs = [build_headline(n, device=d, topo=topo) for d in devs]
        cfg = dataclasses.replace(runs[0][0], state_precision="compact")
        states = [encode_state(r[2], cfg) for r in runs]
        keys = [rng.split(rng.PRNGKey(0, device=d), 8) for d in devs]
        bf16 = [f for f, c in _COMPACT_CODECS.items() if c == "bf16"]
        inputs_apart = ulps = 0
        for tick in range(8):
            pre = [engine._tick(decode_state(s, cfg), cfg, r[1], kk[tick])[0]
                   for s, r, kk in zip(states, runs, keys)]
            states = [encode_state(p, cfg) for p in pre]
            a, b = (state_to_numpy(s) for s in states)
            pa, pb = (state_to_numpy(p) for p in pre)
            for f in a:
                x, y = a[f], b[f]
                if f in bf16:
                    fx, fy = pa[f], pb[f]
                    apart = fx.view(np.uint32) != fy.view(np.uint32)
                    step = np.abs(x.astype(np.int32) - y.astype(np.int32))
                    same = (np.allclose(fx, fy, rtol=1e-6, atol=0.0)
                            and not (step[~apart] != 0).any()
                            and not (step[apart] > 1).any())
                    inputs_apart += int(apart.sum())
                    ulps += int((step != 0).sum())
                elif x.dtype == np.float32:
                    same = np.allclose(x, y, rtol=1e-6, atol=0.0)
                else:
                    same = np.array_equal(x, y)
                if not same:
                    raise AssertionError(
                        f"compact trajectory: field {f} ({x.dtype}) differs "
                        f"between {devs[0]} and cpu after tick {tick}")
        if float(states[0].delivered_total) <= 0:
            raise AssertionError("compact trajectory: nothing delivered")
        print(f"compact trajectory [{n} peers]: 8 ticks on {devs[0]} equal "
              f"to the CPU run (int/bool/int8/int16/packed exact, float32 "
              f"rtol 1e-6, bf16 exact where the float32 inputs agree "
              f"bitwise); float32 inputs to the bf16 encodes apart in "
              f"{inputs_apart} values, bf16 planes one ulp apart in {ulps}; "
              f"delivered_total {float(states[0].delivered_total):.0f}",
              flush=True)

    # ---- phase 3e: the BASELINE configs at full size ---------------------
    def baseline_paths(self, topo_full, topo_beacon):
        """The four paths of phase 3e: (label, (cfg, tp, state)).
        single_topic_1k builds its own 1024-peer underlay; the beacon
        network's is ``topology.sparse(10240, 48, degree=16)``; sybil_100k
        reuses the headline's 102400-peer ``topology.sparse(n, 32,
        degree=12)``, all at the scenarios' seed."""
        import dataclasses
        from go_libp2p_pubsub_tpu_torch.sim import scenarios
        dev = self.dev
        beacon = scenarios.beacon_10k(N_BEACON, device=dev, topo=topo_beacon)
        cfg, tp, st = beacon
        rotation = (dataclasses.replace(cfg, sub_leave_prob=ROTATION_PROB,
                                        sub_join_prob=ROTATION_PROB), tp,
                    st._replace(**{f: getattr(st, f).clone()
                                   for f in st._fields}))
        return [
            ("single_topic_1k", scenarios.single_topic_1k(1024, device=dev)),
            ("beacon_10k", beacon),
            ("beacon rotation", rotation),
            ("sybil_100k", scenarios.sybil_100k(N_FULL, device=dev,
                                                topo=topo_full)),
        ]

    def phase_baseline(self, topo_full, topo_beacon):
        """Each path of :meth:`baseline_paths`: 8 ticks of ``run`` from one
        key, the counts reset just before and read just after; hb/s,
        delivery, launches, fault flags 0; the rotation's subscriptions
        left and joined; sybil's share of honest peers' mesh edges that
        point at sybils after tick 1 (``run_keys`` over the first of
        ``window_keys``' rows, outside the timed run) and after tick 8,
        as information. Then one more tick whose kernel calls are
        recorded, checked and timed as in phase 2."""
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.ops import cudalib
        from go_libp2p_pubsub_tpu_torch.ops.hopkernel import (
            resolve_emit_mode, resolve_hop_mode)
        from go_libp2p_pubsub_tpu_torch.sim import (delivery_fraction, run,
                                                    run_keys, window_keys)
        from go_libp2p_pubsub_tpu_torch.sim.invariants import decode_flags

        def sybil_share(s):
            honest = ~s.malicious
            nbr = s.neighbors.clamp(0, s.neighbors.shape[0] - 1).long()
            to_sybil = s.malicious[nbr][:, None, :]
            mesh = s.mesh & honest[:, None, None]
            return float((mesh & to_sybil).sum()) / max(int(mesh.sum()), 1)

        for label, (cfg, tp, st) in self.baseline_paths(topo_full,
                                                        topo_beacon):
            key = rng.PRNGKey(0, device=self.dev)
            extra = ""
            if label == "sybil_100k":
                first = run_keys(st, cfg, tp, window_keys(cfg, key, 0, 0, 1, 8),
                                 device=self.dev)
                extra = (f"; honest mesh edges to sybils "
                         f"{100 * sybil_share(first):.3f}% after tick 1")
            self.sync()
            cudalib.reset_launches()
            t0 = time.perf_counter()
            out = run(st, cfg, tp, key, 8, device=self.dev)
            self.sync()
            secs = time.perf_counter() - t0
            launches = dict(cudalib.LAUNCHES)
            flags = int(out.fault_flags) & 0xFFFFFFFF
            delivered = float(out.delivered_total)
            if label == "sybil_100k":
                extra += (f", {100 * sybil_share(out):.3f}% after tick 8 "
                          f"(information only)")
            if label == "beacon rotation":
                left = int((st.subscribed & ~out.subscribed).sum())
                joined = int((~st.subscribed & out.subscribed).sum())
                extra = (f"; subscription churn {ROTATION_PROB} a tick (a "
                         f"stress rate, not the chain's ~27-hour subnet "
                         f"rotation): {left} subscriptions left, {joined} "
                         f"joined over 8 ticks")
                if not (left and joined):
                    raise AssertionError(f"{label}: subscriptions left "
                                         f"{left}, joined {joined}")
            print(f"BASELINE [{label}]: {cfg.n_peers} peers, T={cfg.n_topics}, "
                  f"K={cfg.k_slots}, hop {resolve_hop_mode(cfg)}, emit "
                  f"{resolve_emit_mode(cfg)}; 8 ticks of run in {secs:.3f} s "
                  f"= {8 / secs:.3f} hb/s; delivery_fraction (age>=2) "
                  f"{float(delivery_fraction(out, cfg, min_age_ticks=2)):.6f}"
                  f"; delivered_total {delivered:.0f}; fault_flags "
                  f"0x{flags:08x}{extra}", flush=True)
            print(f"BASELINE [{label}] launches: {json.dumps(launches)}",
                  flush=True)
            self.check_launches(label, launches, cfg)
            if delivered <= 0:
                raise AssertionError(f"{label}: the path delivered nothing")
            if flags:
                raise AssertionError(f"{label}: fault_flags 0x{flags:x} "
                                     f"{decode_flags(flags)}")
            if label != "beacon rotation":
                self.capture_paths[label] = (cfg, tp, out)
            self.check_recorded(label, out, cfg, tp, phase="BASELINE")

    # ---- phase 3f: the frontier at full size and the formulations -------
    def run_path(self, label, cfg, tp, st, phase):
        """8 ticks of ``run`` from PRNGKey(0), the counts reset just before
        and read just after; hb/s, delivery, fault flags (must be 0) and
        the launches against ``PATH_KERNELS[label]``. Returns the state."""
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.ops import cudalib
        from go_libp2p_pubsub_tpu_torch.sim import delivery_fraction, run
        from go_libp2p_pubsub_tpu_torch.sim.invariants import decode_flags
        key = rng.PRNGKey(0, device=self.dev)
        self.sync()
        cudalib.reset_launches()
        t0 = time.perf_counter()
        out = run(st, cfg, tp, key, 8, device=self.dev)
        self.sync()
        secs = time.perf_counter() - t0
        launches = dict(cudalib.LAUNCHES)
        flags = int(out.fault_flags) & 0xFFFFFFFF
        delivered = float(out.delivered_total)
        print(f"{phase} [{label}]: {cfg.n_peers} peers, T={cfg.n_topics}, "
              f"K={cfg.k_slots}, M={cfg.msg_window}; 8 ticks of run in "
              f"{secs:.3f} s = {8 / secs:.3f} hb/s; delivery_fraction "
              f"(age>=2) "
              f"{float(delivery_fraction(out, cfg, min_age_ticks=2)):.6f}; "
              f"delivered_total {delivered:.0f}; fault_flags 0x{flags:08x}",
              flush=True)
        print(f"{phase} [{label}] launches: {json.dumps(launches)}",
              flush=True)
        self.check_launches(label, launches, cfg)
        if delivered <= 0:
            raise AssertionError(f"{label}: the path delivered nothing")
        if flags:
            raise AssertionError(f"{label}: fault_flags 0x{flags:x} "
                                 f"{decode_flags(flags)}")
        return out

    def phase_frontier(self, topo_frontier, topo_full):
        """``scenarios.frontier_1m`` (1,048,576 peers on its own
        ``sparse_fast`` underlay, T = 2, M = 64, sort exchanges, the fused
        hop, resolve and emit): 8 ticks of ``run``, the peak device memory
        beside the state's bytes, one more tick whose every kernel call is
        recorded, checked and timed as in phase 3d. Then the headline
        (102400) as the reference's shipped table resolves it on a TPU
        (``edge_gather_mode="sort"``, ``hop_mode="xla"``: no hand kernel,
        the IWANT answer table riding the heartbeat's last exchange), 8
        ticks. Then the formulations of each gather seam and of the
        selection timed side by side at both networks' shapes."""
        import dataclasses
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch.sim import (build_headline, engine,
                                                    scenarios)
        cfg, tp, st = scenarios.frontier_1m(device=self.dev,
                                            topo=topo_frontier)
        state_bytes = sum(x.numel() * x.element_size() for x in st
                          if isinstance(x, torch.Tensor))
        self.sync()
        torch.cuda.reset_peak_memory_stats()
        out = self.run_path("frontier_1m", cfg, tp, st, "frontier")
        peak = torch.cuda.max_memory_allocated()
        print(f"frontier [frontier_1m]: peak device memory "
              f"{peak / 2 ** 30:.3f} GiB (max_memory_allocated over the 8 "
              f"ticks), the state's tensors {state_bytes / 2 ** 30:.3f} GiB",
              flush=True)
        self.check_recorded("frontier_1m", out, cfg, tp, phase="frontier")
        self.time_formulations("frontier_1m", out, cfg)
        self.capture_paths["frontier_1m"] = (cfg, tp, out)
        del out, st

        cfg, tp, st = build_headline(N_FULL, device=self.dev, topo=topo_full)
        cfg = dataclasses.replace(cfg, edge_gather_mode="sort",
                                  hop_mode="xla")
        want = {"edge_permute": "sort", "words": "sort",
                "edge_packed": "sort", "hop": "xla", "emit": "xla"}
        got = json.loads(formulations(cfg))
        if {f: got[f] for f in want} != want:
            raise AssertionError(f"sort path: formulations {got}")
        rides = []
        orig = engine._iwant_answer_extras

        def spy(*a, **kw):
            extra = orig(*a, **kw)
            rides.append(extra is not None)
            return extra

        engine._iwant_answer_extras = spy
        try:
            out = self.run_path("sort path", cfg, tp, st, "frontier")
        finally:
            engine._iwant_answer_extras = orig
        if rides != [True] * 8:
            raise AssertionError(f"sort path: the answer table rode the "
                                 f"heartbeat's exchange on ticks {rides}")
        print("frontier [sort path]: the reference's TPU resolution (its "
              "shipped table's tpu entry: sort for the three gather seams, "
              "xla for hop and emit); the IWANT answer table rode the "
              "heartbeat's last exchange on all 8 ticks", flush=True)
        self.time_formulations("headline", out, cfg)

    def time_formulations(self, label, st, cfg):
        """Each formulation of the payload permute, the words gather, the
        packed exchange (B = 2T and T planes) and the selection (at the
        heartbeat's [N, T, K] masks, counts up to D) on ``st``'s own edge
        involution, by CUDA events (5 calls behind a spin kernel, median
        of 5 rounds); each output equal to the ``pallas`` (``ranks``) one
        at every valid slot. ``rows`` only up to 102400 peers (its
        [N, K, K] and [N, K, M] temporaries are 4 and 2 GiB at 1M)."""
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch.ops import heartbeat as hb
        from go_libp2p_pubsub_tpu_torch.ops import permgather as pg
        from go_libp2p_pubsub_tpu_torch.ops import selection as sel
        n, t, k = st.mesh.shape
        m = cfg.msg_window
        w = (m + 31) // 32
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(7)
        nbr, rs = st.neighbors, st.reverse_slot
        valid = (nbr >= 0) & (rs >= 0)
        jn, rk = nbr.clamp(0, n - 1), rs.clamp(0, k - 1)
        key_n = pg.edge_sort_key(nbr, rs, k_major=False)
        key_k = pg.edge_sort_key(nbr, rs, k_major=True)
        forms = FORMS if n <= N_FULL else tuple(f for f in FORMS
                                                if f != "rows")

        def compare(op, calls, same, ref="pallas", where=" at valid slots"):
            want = calls[ref]()
            times = {}
            for form, fn in calls.items():
                if not same(fn(), want):
                    raise AssertionError(f"formulations [{label}] {op}: "
                                         f"{form} differs from {ref}")
                times[form] = self.time_ms(fn, reps=5)
            best = min(times, key=times.get)
            print(f"formulations [{label}] {op}: "
                  + ", ".join(f"{f} {ms:.4f} ms" for f, ms in times.items())
                  + f"; fastest {best}; each equal to {ref}{where}",
                  flush=True)

        payload = self.rand_words(gen, n, k)
        compare(f"permutation_gather int32 [{n}, {k}]", {
            f: (lambda f=f: pg.permutation_gather(payload, jn, rk, f,
                                                  sort_key=key_n))
            for f in forms}, lambda a, b: torch.equal(a[valid], b[valid]))
        x_w = self.rand_words(gen, w, n)
        vkn = valid.T
        compare(f"gather_words [{w}, {n}], K={k}", {
            f: (lambda f=f: pg.gather_words(x_w, jn, f, m=m, sort_key=key_k))
            for f in forms}, lambda a, b: torch.equal(a[:, vkn], b[:, vkn]))
        for b_planes in (2 * t, t):
            masks = [torch.rand(n, t, k, generator=gen, device=self.dev)
                     < 0.3 for _ in range(b_planes // t)]
            compare(f"edge_gather_packed B={b_planes}, N={n}", {
                f: (lambda f=f: hb.edge_gather_packed(masks, st, f)[0])
                for f in forms},
                lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b)))
        mask = torch.rand(n, t, k, generator=gen, device=self.dev) < 0.4
        noise = torch.rand(n, t, k, generator=gen, device=self.dev)
        count = torch.randint(0, cfg.d + 1, (n, t), generator=gen,
                              device=self.dev)
        compare(f"select_random [{n}, {t}, {k}], count <= D={cfg.d}", {
            f: (lambda f=f: sel.select_random(mask, count, None,
                                              max_count=cfg.d, mode=f,
                                              noise=noise))
            for f in ("iter", "sort", "ranks")}, torch.equal, ref="ranks",
            where="")

    # ---- phase 4d: the fold_in schedule and run_checked on the card -------
    def phase_fold_in(self):
        """single_topic_1k(1024) under ``key_schedule="fold_in"``: tick by
        tick (``run_window`` of one tick) on the card and on the CPU,
        compared after every tick as phase 4 compares; on the card, two
        ``run_window`` chunks (3 + 5) and one 8-tick ``run`` must equal
        the tick-by-tick run in every field, exactly."""
        import dataclasses
        import numpy as np
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.sim import (run, run_window, scenarios,
                                                    state_to_numpy)
        n = 1024
        topo = trajectory_topology("single_topic_1k", n)
        devs = (self.dev, torch.device("cpu"))
        runs = []
        for d in devs:
            cfg, tp, st = scenarios.single_topic_1k(n, device=d, topo=topo)
            runs.append((dataclasses.replace(cfg, key_schedule="fold_in"), tp,
                         st))
        keys = [rng.PRNGKey(0, device=d) for d in devs]
        states = [r[2] for r in runs]
        for tick in range(8):
            states = [run_window(s, r[0], r[1], kk, 1, device=d)
                      for s, r, kk, d in zip(states, runs, keys, devs)]
            a, b = (state_to_numpy(s) for s in states)
            for f in a:
                x, y = a[f], b[f]
                same = (np.allclose(x, y, rtol=1e-6, atol=0.0)
                        if x.dtype == np.float32 else np.array_equal(x, y))
                if not same:
                    raise AssertionError(
                        f"fold_in: field {f} differs between the card and "
                        f"the CPU after tick {tick}")
        cfg, tp, st = runs[0]
        chunked = run_window(run_window(st, cfg, tp, keys[0], 3,
                                        device=self.dev),
                             cfg, tp, keys[0], 5, device=self.dev)
        whole = run(st, cfg, tp, keys[0], 8, device=self.dev)
        want = state_to_numpy(states[0])
        for what, s in (("run_window 3 + 5", chunked), ("run 8", whole)):
            got = state_to_numpy(s)
            differ = [f for f in want if not np.array_equal(want[f], got[f])]
            if differ:
                raise AssertionError(f"fold_in: {what} differs from the "
                                     f"tick-by-tick run in {differ}")
        print(f"fold_in [single_topic_1k({n})]: 8 ticks of run_window(1) on "
              f"{devs[0]} equal to the CPU run after every tick (integer/"
              f"bool/packed exact, float32 rtol 1e-6); run_window 3 + 5 and "
              f"run 8 equal to it in every field; delivered_total "
              f"{float(states[0].delivered_total):.0f}", flush=True)

    def phase_checked(self):
        """``run_checked`` under ``invariant_mode="raise"`` on
        single_topic_1k(1024): a clean 4-tick run passes on the card and
        equals the CPU's; the state poisoned as tests/test_faults.py
        poisons it (``mesh_failure_penalty[0,0,0] = inf``) raises on the
        card with the violation bits and tick it raises with on the CPU."""
        import dataclasses
        import numpy as np
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.sim import (run_checked, scenarios,
                                                    state_to_numpy)
        from go_libp2p_pubsub_tpu_torch.sim.invariants import (
            InvariantViolation, decode_flags)
        n = 1024
        topo = trajectory_topology("single_topic_1k", n)
        clean, raised = [], []
        for d in (self.dev, torch.device("cpu")):
            cfg, tp, st = scenarios.single_topic_1k(n, device=d, topo=topo)
            cfg = dataclasses.replace(cfg, invariant_mode="raise")
            clean.append(state_to_numpy(run_checked(
                st, cfg, tp, rng.PRNGKey(0, device=d), 4, device=d)))
            mfp = st.mesh_failure_penalty.clone()
            mfp[0, 0, 0] = float("inf")
            try:
                run_checked(st._replace(mesh_failure_penalty=mfp), cfg, tp,
                            rng.PRNGKey(0, device=d), 4, device=d)
            except InvariantViolation as e:
                raised.append((e.flags, e.tick, str(e)))
            else:
                raise AssertionError(f"run_checked on {d}: the poisoned "
                                     f"state did not raise")
        if raised[0][:2] != raised[1][:2] or not raised[0][0]:
            raise AssertionError(f"run_checked: the card raised {raised[0]}, "
                                 f"the CPU {raised[1]}")
        for f, x in clean[0].items():
            y = clean[1][f]
            same = (np.allclose(x, y, rtol=1e-6, atol=0.0)
                    if x.dtype == np.float32 else np.array_equal(x, y))
            if not same:
                raise AssertionError(f"run_checked: the clean run's field {f} "
                                     f"differs between the card and the CPU")
        print(f"run_checked [single_topic_1k({n}), invariant_mode=raise]: a "
              f"clean 4-tick run passes on {self.dev}, equal to the CPU's; "
              f"the poisoned state raises on both at tick {raised[0][1]} with "
              f"fault_flags=0x{raised[0][0]:08x} {decode_flags(raised[0][0])}"
              f" (card: {raised[0][2]!r})", flush=True)

    # ---- phase 3g: compact storage, telemetry, checkpoint ----------------
    def stored_bytes(self, label, cfg, st):
        """The stored state's device bytes, which must equal
        ``state_nbytes(cfg)["total"]`` (the reference's pricing)."""
        from go_libp2p_pubsub_tpu_torch.sim import state_nbytes
        got = sum(x.numel() * x.element_size() for x in st)
        want = state_nbytes(cfg)["total"]
        if got != want:
            raise AssertionError(f"{label}: the stored state holds {got} "
                                 f"bytes, state_nbytes prices {want}")
        return got

    def timed_run(self, label, cfg, tp, st, keys, check=True, **kw):
        """``run_keys`` over ``keys`` (``kw``: ``telemetry=True``), the
        counts reset just before and read just after, checked against
        ``PATH_KERNELS[label]`` when ``check``: (result, seconds, peak
        device bytes above the memory held before)."""
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch.ops import cudalib
        from go_libp2p_pubsub_tpu_torch.sim import run_keys
        self.sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cudalib.reset_launches()
        t0 = time.perf_counter()
        out = run_keys(st, cfg, tp, keys, device=self.dev, **kw)
        self.sync()
        secs = time.perf_counter() - t0
        launches = dict(cudalib.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - base
        if check:
            print(f"compact [{label}] launches: {json.dumps(launches)}",
                  flush=True)
            self.check_launches(label, launches, cfg)
        return out, secs, peak

    def codec_share(self, label, cfg, st, tick_ms):
        """Device time of the step's decode (at entry) and encode (at
        exit) of ``st``, and of the encode's bit packing alone, by CUDA
        events, beside the tick's ``tick_ms``."""
        from go_libp2p_pubsub_tpu_torch.ops.bits import pack_bool
        from go_libp2p_pubsub_tpu_torch.sim import decode_state, encode_state
        from go_libp2p_pubsub_tpu_torch.sim.state import _COMPACT_CODECS
        dec = decode_state(st, cfg)
        packed = [getattr(dec, f) for f, c in _COMPACT_CODECS.items()
                  if c == "packK"]
        dec_ms = self.time_ms(lambda: decode_state(st, cfg), reps=3,
                              rounds=3)
        enc_ms = self.time_ms(lambda: encode_state(dec, cfg), reps=3,
                              rounds=3)
        pack_ms = self.time_ms(lambda: [pack_bool(x) for x in packed],
                               reps=3, rounds=3)
        print(f"compact [{label}]: decode {dec_ms:.3f} ms + encode "
              f"{enc_ms:.3f} ms a tick (device time, CUDA events) = "
              f"{100 * (dec_ms + enc_ms) / tick_ms:.2f}% of the {tick_ms:.3f} "
              f"ms compact tick; the encode's pack_bool of the "
              f"{len(packed)} packed planes {pack_ms:.3f} ms = "
              f"{100 * pack_ms / tick_ms:.2f}%", flush=True)
        del dec, packed

    def phase_compact(self, topo_full, topo_frontier):
        """Compact storage on the two paths, each on its own underlay:

        - the headline (102400 peers, fused kernels 1-4): the f32 and the
          compact state from one build, 8 ticks of ``run_keys`` each,
          twice, in turns (f32, compact, compact, f32), with launches,
          hb/s and peak memory; the stored bytes against ``state_nbytes``;
          the codec's device time beside the tick's; ``run_keys(...,
          telemetry=True)``, whose last record must equal
          ``health_record`` of its final state; a checkpoint of the state
          after 4 ticks, saved, restored and run 4 more ticks, equal in
          every field to the 8 uninterrupted ticks;
        - ``frontier_1m`` under compact storage (1,048,576 peers, sort
          exchanges, kernels 1-3): 8 ticks with telemetry, launches, hb/s,
          peak memory, stored bytes and the codec's share;
        - ``frontier_4m`` and ``frontier_10m`` priced under both
          precisions (``state_nbytes``, ``check_hbm_budget`` against the
          card's memory), not allocated.

        Both compact paths go on to phase 5's captured chunks."""
        import dataclasses
        import tempfile
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.sim import (build_headline,
                                                    check_hbm_budget,
                                                    checkpoint,
                                                    delivery_fraction,
                                                    encode_state, scenarios,
                                                    state_nbytes, telemetry)
        from go_libp2p_pubsub_tpu_torch.sim.invariants import VIOLATION_MASK
        gib = 2 ** 30
        dev = self.dev
        keys = rng.split(rng.PRNGKey(0, device=dev), 8)

        cfg, tp, st = build_headline(N_FULL, device=dev, topo=topo_full)
        ccfg = dataclasses.replace(cfg, state_precision="compact")
        cst = encode_state(st, ccfg)
        f32_bytes = self.stored_bytes("headline", cfg, st)
        c_bytes = self.stored_bytes("compact headline", ccfg, cst)
        runs = {"f32": [], "compact": []}
        for prec in ("f32", "compact", "compact", "f32"):
            c, s = (cfg, st) if prec == "f32" else (ccfg, cst)
            runs[prec].append(self.timed_run(
                "compact headline" if prec == "compact" else "headline",
                c, tp, s, keys, check=prec == "compact"))
        out = runs["compact"][0][0]
        for f, a, b in zip(out._fields, out, runs["compact"][1][0]):
            if not torch.equal(a, b):
                raise AssertionError(f"compact headline: two runs differ in "
                                     f"{f}")
        if int(out.fault_flags) & VIOLATION_MASK or \
                float(out.delivered_total) <= 0:
            raise AssertionError("compact headline: violation bits or no "
                                 "delivery")
        hbs = {p: [8 / r[1] for r in rs] for p, rs in runs.items()}
        peaks = {p: max(r[2] for r in rs) / gib for p, rs in runs.items()}
        print(f"compact [headline]: {N_FULL} peers, 8 ticks of run_keys, "
              f"f32 {hbs['f32'][0]:.3f} / {hbs['f32'][1]:.3f} hb/s, compact "
              f"{hbs['compact'][0]:.3f} / {hbs['compact'][1]:.3f} hb/s "
              f"(runs in turns f32, compact, compact, f32); stored state "
              f"f32 {f32_bytes / gib:.4f} GiB, compact {c_bytes / gib:.4f} "
              f"GiB (= state_nbytes); peak above the stored state f32 "
              f"{peaks['f32']:.3f} GiB, compact {peaks['compact']:.3f} GiB; "
              f"delivery_fraction (age>=2) f32 "
              f"{float(delivery_fraction(runs['f32'][0][0], cfg, min_age_ticks=2)):.6f}"
              f", compact "
              f"{float(delivery_fraction(out, ccfg, min_age_ticks=2)):.6f}",
              flush=True)
        tick_ms = 1e3 * min(r[1] for r in runs["compact"]) / 8
        self.codec_share("headline", ccfg, out, tick_ms)
        del runs

        (tout, rec), secs, _ = self.timed_run("compact headline", ccfg, tp,
                                              cst, keys, telemetry=True)
        post = telemetry.health_record(tout, ccfg, tp)
        for f, a, b in zip(rec._fields, rec, post):
            if not torch.equal(a[-1], b):
                raise AssertionError(f"compact headline: the streamed "
                                     f"record's {f} differs from "
                                     f"health_record of the final state")
        for f, a, b in zip(out._fields, out, tout):
            if not torch.equal(a, b):
                raise AssertionError(f"compact headline: the telemetry run "
                                     f"differs in {f}")
        rows = telemetry.rows_to_dicts(*telemetry.records_to_rows(rec))
        print(f"compact [headline] telemetry: 8 ticks of run_keys(telemetry="
              f"True) {8 / secs:.3f} hb/s; the last record equals "
              f"health_record of the final state; last row "
              f"{json.dumps(rows[-1])}", flush=True)

        half = self.timed_run("compact headline", ccfg, tp, cst, keys[:4],
                              check=False)[0]
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "compact_headline.npz")
            t0 = time.perf_counter()
            checkpoint.save(path, half, cfg=ccfg)
            save_s = time.perf_counter() - t0
            size = os.path.getsize(path)
            t0 = time.perf_counter()
            back = checkpoint.restore(path, cst, cfg=ccfg)
            self.sync()
            restore_s = time.perf_counter() - t0
        resumed = self.timed_run("compact headline", ccfg, tp, back,
                                 keys[4:], check=False)[0]
        differ = [f for f, a, b in zip(out._fields, out, resumed)
                  if not torch.equal(a, b)]
        if differ:
            raise AssertionError(f"compact headline: the resumed run differs "
                                 f"from the uninterrupted one in {differ}")
        print(f"compact [headline] checkpoint: saved after tick 4 "
              f"({size / 2 ** 20:.1f} MiB .npz in {save_s:.3f} s), restored "
              f"in {restore_s:.3f} s, 4 more ticks equal to the 8 "
              f"uninterrupted ticks in every field", flush=True)
        self.capture_paths["compact headline"] = (ccfg, tp, out)
        del st, cst, half, back, resumed, tout

        fcfg, ftp, fst = scenarios.frontier_1m(
            device=dev, topo=topo_frontier, state_precision="compact")
        f_bytes = self.stored_bytes("compact frontier_1m", fcfg, fst)
        f32_priced = state_nbytes(dataclasses.replace(
            fcfg, state_precision="f32"))["total"]
        (fout, frec), secs, peak = self.timed_run(
            "compact frontier_1m", fcfg, ftp, fst, keys, telemetry=True)
        flags = int(fout.fault_flags) & 0xFFFFFFFF
        if flags or float(fout.delivered_total) <= 0:
            raise AssertionError(f"compact frontier_1m: fault_flags "
                                 f"0x{flags:x}, delivered "
                                 f"{float(fout.delivered_total)}")
        last = telemetry.record_to_row(
            telemetry.HealthRecord(*(x[-1] for x in frec)))
        print(f"compact [frontier_1m]: {fcfg.n_peers} peers, 8 ticks of "
              f"run_keys(telemetry=True) in {secs:.3f} s = {8 / secs:.3f} "
              f"hb/s; stored state {f_bytes / gib:.4f} GiB (= state_nbytes;"
              f" f32 prices {f32_priced / gib:.4f} GiB); peak "
              f"{peak / gib:.3f} GiB above the stored state; "
              f"delivery_fraction (age>=2) "
              f"{float(delivery_fraction(fout, fcfg, min_age_ticks=2)):.6f}; "
              f"last record {json.dumps(last)}", flush=True)
        self.codec_share("frontier_1m", fcfg, fout, 1e3 * secs / 8)
        self.capture_paths["compact frontier_1m"] = (fcfg, ftp, fout)
        del fst

        total = torch.cuda.mem_get_info()[1]
        for name in ("frontier_4m", "frontier_10m"):
            n = scenarios.FRONTIER_NS[name]
            for prec in ("f32", "compact"):
                pcfg = scenarios.frontier_cfg(n, state_precision=prec)
                acct = state_nbytes(pcfg)
                try:
                    check_hbm_budget(pcfg, budget=total)
                    verdict = "fits"
                except ValueError:
                    verdict = "refused"
                scaled = ""
                if prec == "compact":
                    scaled = (f"; the 1M compact run's stored state plus "
                              f"peak scaled by {n / N_FRONTIER:.0f} (an "
                              f"estimate, not a measurement): "
                              f"{(peak + f_bytes) * n / N_FRONTIER / gib:.3f}"
                              f" GiB")
                print(f"compact [pricing] {name} ({n} peers) {prec}: state "
                      f"{acct['total'] / gib:.3f} GiB, check_hbm_budget "
                      f"against the card's {total / gib:.3f} GiB: {verdict}"
                      f"{scaled}; not allocated", flush=True)

    # ---- phase 5: the captured engine plane (parallel/compile_plan.py) ----
    def phase_captured(self):
        """Each path held in :attr:`capture_paths` (the headline, churn
        under ``pallas`` and ``mxu``, single_topic_1k, beacon_10k,
        sybil_100k, the combined fault plan and, last, frontier_1m) from
        the state its own phase left: :meth:`captured_path`. Each path's
        state and executables are dropped before the next."""
        order = ["headline", "compact headline", "churn[pallas]",
                 "churn[mxu]", "single_topic_1k", "beacon_10k", "sybil_100k",
                 "combined plan", "frontier_1m", "compact frontier_1m"]
        if sorted(order) != sorted(self.capture_paths):
            raise AssertionError(f"phase 5 holds {sorted(self.capture_paths)}"
                                 f", expected {sorted(order)}")
        for label in order:
            cfg, tp, st = self.capture_paths.pop(label)
            t0 = time.perf_counter()
            compact = label.startswith("compact")
            if label == "compact headline":
                # the telemetry lane's cost: the same chunk without it
                self.captured_path(label, cfg, tp, st, "chunk")
            self.captured_path(label, cfg, tp, st, "chunk", compact)
            if label == "headline":
                self.captured_path(label, cfg, tp, st, "window")
            del st
            print(f"phase 5 [{label}]: {time.perf_counter() - t0:.1f} s",
                  flush=True)

    def sync_warnings(self, fn):
        """``fn()`` between two CUDA events, under
        ``torch.cuda.set_sync_debug_mode("warn")`` while it enqueues: (its
        result, the events' milliseconds, the synchronizations it made)."""
        import warnings

        from go_libp2p_pubsub_tpu_torch.profile_step import SYNC_WARNING
        torch = self.torch
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        self.sync()
        a.record()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        b.record()
        b.synchronize()
        return (out, a.elapsed_time(b),
                sum(SYNC_WARNING in str(w.message) for w in caught))

    def captured_path(self, label, cfg, tp, st, schedule, telemetry=False):
        """One path of phase 5 under ``schedule`` ("chunk": ``engine_chunk``
        over C rows of ``rng.split`` against ``run_keys``; "window":
        ``engine_window`` under ``key_schedule="fold_in"`` against
        ``run_window``):

        - one eager tick under ``torch.cuda.set_sync_debug_mode("error")``:
          no synchronizing call may happen;
        - the eager C = 8 ticks from ``st``, timed by CUDA events, with the
          synchronizations counted while they enqueue (sync debug mode
          "warn"), and their peak device memory;
        - the eager run's cached blocks released, then the donated
          executable built (warm-up, capture) and replayed from ``st`` with
          the same keys: every field equal to the eager run's exactly (the
          same card and kernels: the tolerance is zero); then replayed
          again, chained on its own result (no copy in), timed and counted
          the same way; the peak device memory of building and replaying,
          and the allocator's reserve (the graph's pool included);
        - the kernels launched into the graph, counted once at capture time
          (cudalib.LAUNCHES counts Python-side launches; a replay repeats
          them without passing through the wrappers), against the path's
          must and must-not sets.

        ``telemetry=True`` runs both sides with the health-record lane:
        the replay's C records must equal the eager run's exactly too."""
        import dataclasses
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.parallel import compile_plan
        from go_libp2p_pubsub_tpu_torch.sim import (run_keys, run_window,
                                                    step)
        c = CAPTURE_TICKS
        dev = self.dev
        key = rng.PRNGKey(11, device=dev)
        if schedule == "window":
            cfg = dataclasses.replace(cfg, key_schedule="fold_in")
            keys = key

            def eager(s):
                return run_window(s, cfg, tp, key, c, telemetry=telemetry,
                                  device=dev)
        else:
            keys = rng.split(key, c)

            def eager(s):
                return run_keys(s, cfg, tp, keys, telemetry=telemetry,
                                device=dev)
        name = f"{label}, {schedule}" + (", telemetry" if telemetry else "")
        tick_key = rng.PRNGKey(12, device=dev)
        self.sync()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(st, cfg, tp, tick_key, device=dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        self.sync()

        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        want, eager_ms, eager_syncs = self.sync_warnings(lambda: eager(st))
        eager_peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.empty_cache()

        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if schedule == "window":
            exe = compile_plan.engine_window(cfg, st, tp, key, c,
                                             telemetry=telemetry, donate=True)
        else:
            exe = compile_plan.engine_chunk(cfg, st, tp, keys,
                                            telemetry=telemetry, donate=True)
        self.sync()
        build_s = time.perf_counter() - t0
        got = exe(st, tp, keys)
        self.sync()
        fields = st._fields
        if telemetry:
            (want, want_rec), (got, got_rec) = want, got
            fields = fields + tuple(f"record.{f}" for f in want_rec._fields)
            want, got = tuple(want) + tuple(want_rec), \
                tuple(got) + tuple(got_rec)
        differ = []
        for f, a, b in zip(fields, want, got):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if a.dtype != b.dtype or not torch.equal(a, b):
                differ.append(f)
        if differ:
            raise AssertionError(f"phase 5 [{name}]: the replayed chunk "
                                 f"differs from the eager run in {differ}")
        del want
        if telemetry:
            got = type(st)(*got[:len(st._fields)])
        got, cap_ms, cap_syncs = self.sync_warnings(lambda: exe(got, tp, keys))
        cap_peak = torch.cuda.max_memory_allocated() - base
        reserved = torch.cuda.memory_reserved()
        must, must_not = PATH_KERNELS[label]
        missing = sorted(k for k in must if not exe.launches.get(k))
        stray = sorted(k for k in must_not if exe.launches.get(k))
        if missing or stray:
            raise AssertionError(f"phase 5 [{name}]: the graph holds "
                                 f"{exe.launches}; missing {missing}, stray "
                                 f"{stray}")

        print(f"phase 5 [{name}]: {cfg.n_peers} peers; eager {c} ticks "
              f"{eager_ms:.3f} ms = {1e3 * c / eager_ms:.3f} hb/s, "
              f"{eager_syncs} synchronizations (sync debug warnings) = "
              f"{eager_syncs / c:.3f} a tick, peak "
              f"{eager_peak / 2 ** 30:.3f} GiB above the state; captured "
              f"{c} ticks {cap_ms:.3f} ms = {1e3 * c / cap_ms:.3f} hb/s, "
              f"{cap_syncs} synchronizations; build {build_s:.3f} s (warm-up "
              f"{compile_plan.WARMUP_TICKS} ticks + capture); peak "
              f"{cap_peak / 2 ** 30:.3f} GiB above the state over build "
              f"and replay, {reserved / 2 ** 30:.3f} GiB reserved; replay "
              f"equal to the eager run in every field"
              + (" and every health record" if telemetry else ""),
              flush=True)
        print(f"phase 5 [{name}] launches recorded into the graph at "
              f"capture time (each replay repeats them): "
              f"{json.dumps(exe.launches)}", flush=True)
        del exe, got
        compile_plan.clear_caches()
        torch.cuda.empty_cache()

    # ---- phase 6: the supervised and fleet planes -----------------------
    def differ(self, want, got):
        """Fields of two states (or records) that are not bit-equal."""
        torch = self.torch
        out = []
        for f, a, b in zip(want._fields, want, got):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if a.dtype != b.dtype or not torch.equal(a, b):
                out.append(f)
        return out

    def events_ms(self, fn):
        """Milliseconds of ``fn()`` between two CUDA events (the host's
        enqueue included)."""
        torch = self.torch
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        self.sync()
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    def phase_supervised(self, topo, n=N_FULL):
        """6a: ``build_headline(n)``, ``SUPERVISED_TICKS`` ticks of
        ``supervised_run`` in chunks of C = 8 with a health journal and the
        async pipeline, against the eager ``run_keys`` of the same keys
        (its state and its health records):

        1. no checkpoint (one boundary, at the end, so chunk 1 runs the
           donated graph), executables captured in the run: equal in every
           field and journal row, no retry, no degrade, kernels 1-4 in the
           graphs' recorded launches; again with the graphs cached (hb/s);
        2. a checkpoint at every chunk (graphs cached): equal, hb/s, each
           boundary's main-thread pause, and one ``checkpoint.save`` of the
           final state timed alone;
        3. kill and resume: ``max_chunks=1``, then a second call resumes
           from its checkpoint and ends equal;
        4. a hook that sleeps past ``deadline_s`` on the first attempt: one
           retry, one degrade (the chunk halved: on the card the ladder
           never steps off the kernels), equal, the retried chunks'
           executable under the caller's config with kernels 1-4;
        5. a hook that raises: a crash dump, whose replay on the card
           (``replay_crash.replay``) is clean."""
        import tempfile
        from go_libp2p_pubsub_tpu_torch import replay_crash, rng
        from go_libp2p_pubsub_tpu_torch.ops import cudalib
        from go_libp2p_pubsub_tpu_torch.parallel import compile_plan
        from go_libp2p_pubsub_tpu_torch.sim import (build_headline,
                                                    checkpoint, run_keys,
                                                    telemetry)
        from go_libp2p_pubsub_tpu_torch.sim.supervisor import (
            SupervisorConfig, SupervisorCrash, supervised_run)
        dev = self.dev
        ticks, c = SUPERVISED_TICKS, CAPTURE_TICKS
        cfg, tp, st = build_headline(n, device=dev, topo=topo)
        key = rng.PRNGKey(21, device=dev)
        want, want_rec = run_keys(st, cfg, tp, rng.split(key, ticks),
                                  telemetry=True, device=dev)
        want_rows = telemetry.rows_to_dicts(
            *telemetry.records_to_rows(want_rec))

        def journal_rows(path):
            return [{k: v for k, v in r.items() if k != "kind"}
                    for r in telemetry.read_journal(path)["rows"]]

        def supervised(label, fresh=False, hook=None, expect=(0, 0), **kw):
            if fresh:
                compile_plan.clear_caches()
            self.sync()
            cudalib.reset_launches()
            t0 = time.perf_counter()
            got, rep = supervised_run(
                st, cfg, tp, key, ticks,
                SupervisorConfig(chunk_ticks=c, **kw), device=dev,
                _chunk_hook=hook)
            self.sync()
            secs = time.perf_counter() - t0
            if (rep.retries, rep.degrade_level) != expect:
                raise AssertionError(
                    f"phase 6a [{label}]: retries {rep.retries}, degrade "
                    f"level {rep.degrade_level}, expected {expect}: "
                    f"{rep.events}")
            if rep.ticks_run + (rep.resumed_tick or 0) == ticks:
                bad = self.differ(want, got)
                if bad:
                    raise AssertionError(f"phase 6a [{label}]: differs "
                                         f"from the eager run in {bad}")
            path = kw.get("health_path")
            if path and rep.resumed_tick is None and \
                    rep.ticks_run == ticks and journal_rows(path) != \
                    want_rows:
                raise AssertionError(f"phase 6a [{label}]: the journal's "
                                     f"rows differ from the eager run's "
                                     f"records")
            return got, rep, secs, dict(cudalib.LAUNCHES)

        with tempfile.TemporaryDirectory() as tmp:
            # one boundary, at the end: chunk 1 runs the donated graph
            _, rep, secs, launches = supervised(
                "no checkpoint", fresh=True, checkpoint_every_ticks=ticks,
                health_path=os.path.join(tmp, "j1.ndjson"))
            print(f"phase 6a [supervised headline] launches: "
                  f"{json.dumps(launches)}", flush=True)
            self.check_launches("supervised headline", launches, cfg)
            _, _, warm_s, _ = supervised(
                "no checkpoint, cached", checkpoint_every_ticks=ticks,
                health_path=os.path.join(tmp, "j1b.ndjson"))
            got, rep2, ck_s, _ = supervised(
                "checkpoint every chunk", health_path=os.path.join(
                    tmp, "j2.ndjson"), checkpoint_dir=os.path.join(tmp, "ck"))
            pauses = [e["pause_ms"] for e in rep2.events
                      if e["event"] == "boundary"]
            t0 = time.perf_counter()
            checkpoint.save(os.path.join(tmp, "alone"), got, cfg=cfg)
            save_s = time.perf_counter() - t0
            size = os.path.getsize(os.path.join(tmp, "alone.npz"))
            print(f"phase 6a [supervised headline]: {n} peers, {ticks} "
                  f"ticks in chunks of {c}, journal on, async pipeline; "
                  f"equal to the eager run_keys in every field and journal "
                  f"row; retries 0, degrade level 0; no checkpoint (chunk "
                  f"1 donated), first run (the plain and the donated "
                  f"chunk's captures included) {secs:.3f} s = "
                  f"{ticks / secs:.3f} hb/s, graphs cached {warm_s:.3f} s "
                  f"= {ticks / warm_s:.3f} "
                  f"hb/s; a checkpoint at every chunk {ck_s:.3f} s = "
                  f"{ticks / ck_s:.3f} hb/s ({len(rep2.checkpoints)} saves, "
                  f"boundary pauses {pauses} ms on the main thread); one "
                  f"save alone {save_s:.3f} s ({size / 2 ** 20:.1f} MiB "
                  f".npz)", flush=True)

            ck = os.path.join(tmp, "ck3")
            _, rep, _, _ = supervised("kill", checkpoint_dir=ck, max_chunks=1)
            if rep.ticks_run != c:
                raise AssertionError(f"phase 6a: the bounded window ran "
                                     f"{rep.ticks_run} ticks")
            _, rep, _, _ = supervised("resume", checkpoint_dir=ck)
            if rep.resumed_tick != c or rep.ticks_run != ticks - c:
                raise AssertionError(f"phase 6a: resumed at "
                                     f"{rep.resumed_tick}, ran "
                                     f"{rep.ticks_run}")
            print(f"phase 6a [kill and resume]: stopped after {c} ticks "
                  f"(max_chunks=1), resumed from its checkpoint at tick "
                  f"{c}, equal to the eager run", flush=True)

            def slow_once(info):
                if info["chunk_start"] == 0 and info["attempt"] == 0:
                    time.sleep(DEADLINE_S + 1.0)

            _, rep, secs, _ = supervised(
                "deadline", hook=slow_once, expect=(1, 1),
                deadline_s=DEADLINE_S, backoff_base_s=0.0)
            trail = [e["event"] for e in rep.events]
            degrades = [e for e in rep.events if e["event"] == "degrade"]
            retried = [exe for k, exe in compile_plan._ENGINE_PLANS.items()
                       if k[2] == c // 2]
            if degrades != [{"event": "degrade", "chunk_ticks": c // 2}] \
                    or not retried or any(
                        exe.cfg != cfg or not all(
                            exe.launches.get(k, 0) for k in PATH_KERNELS[
                                "supervised headline"][0])
                        for exe in retried):
                raise AssertionError(f"phase 6a [deadline]: the retry left "
                                     f"the kernels: {degrades}, "
                                     f"{[e.launches for e in retried]}")
            print(f"phase 6a [deadline]: the first attempt slept past the "
                  f"{DEADLINE_S} s watchdog: {trail[:4]}; retried on chunks "
                  f"of {c // 2} under the caller's config (launches "
                  f"recorded {json.dumps(retried[0].launches)}), equal to "
                  f"the eager run, {secs:.3f} s", flush=True)

            def boom(info):
                raise RuntimeError("injected failure")

            try:
                supervised("crash", hook=boom, max_retries=0,
                           crash_dir=os.path.join(tmp, "crash"))
            except SupervisorCrash as e:
                dump = e.dump_dir
            else:
                raise AssertionError("phase 6a: the raising hook did not "
                                     "crash the run")
            res = replay_crash.replay(dump, like=st, cfg=cfg, tp=tp,
                                      device=dev)
            if res["tripped"] or res["fault_flags"] or res["ticks"] != c:
                raise AssertionError(f"phase 6a: the replay of the crash "
                                     f"dump: {res}")
            print(f"phase 6a [crash dump]: {os.path.basename(dump)}, "
                  f"replayed on the card: {json.dumps(res)[:300]}",
                  flush=True)
        compile_plan.clear_caches()
        self.torch.cuda.empty_cache()

    def phase_fleet(self, b=FLEET_B):
        """6b: bench.py's fleet_256x1k: B ``single_topic_1k(1024)`` members
        on one underlay, member i keyed from ``PRNGKey(i)``, C = 8 ticks
        through ``fleet_run``; members 0, 1, B/2 - 1 and B - 1 equal to
        their own eager ``run`` in every field; then the window's
        executable (one member's graph of C ticks, replayed member after
        member) against B sequential ``engine_chunk`` replays of the same
        members, each warmed up once, then in turns (fleet, sequential,
        sequential, fleet), CUDA events; capture seconds, the launches
        recorded into the graph (one member's), the host memory the
        cached graph holds, peak memory against B x ``state_nbytes``."""
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.ops import cudalib
        from go_libp2p_pubsub_tpu_torch.parallel import compile_plan
        from go_libp2p_pubsub_tpu_torch.sim import (run, scenarios,
                                                    state_nbytes)
        from go_libp2p_pubsub_tpu_torch.sim.fleet import (FleetMember,
                                                          fleet_run,
                                                          stack_states)
        dev = self.dev
        c = CAPTURE_TICKS
        cfg, tp, st = scenarios.single_topic_1k(FLEET_N, device=dev)
        members = [FleetMember(cfg, tp, st, rng.PRNGKey(i, device=dev), c,
                               f"m{i}") for i in range(b)]
        compile_plan.clear_caches()
        torch.cuda.empty_cache()
        self.sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cudalib.reset_launches()
        rss0 = host_rss()
        t0 = time.perf_counter()
        results = fleet_run(members, device=dev)
        self.sync()
        first_s = time.perf_counter() - t0
        graph_rss = host_rss() - rss0
        peak = torch.cuda.max_memory_allocated() - base
        launches = dict(cudalib.LAUNCHES)
        print(f"phase 6b [fleet_256x1k] launches (warm-up and capture): "
              f"{json.dumps(launches)}", flush=True)
        self.check_launches("fleet_256x1k", launches, cfg)
        for i in sorted({0, 1, b // 2 - 1, b - 1}):
            m = members[i]
            bad = self.differ(run(m.state, m.cfg, m.tp, m.key, c,
                                  device=dev), results[i].state)
            if bad or results[i].ticks_run != c:
                raise AssertionError(f"phase 6b: member {i} differs from "
                                     f"its own run in {bad}")
        states, tps = stack_states([st] * b), stack_states([tp] * b)
        keys = torch.stack([rng.split(m.key, c) for m in members], dim=1)
        exe, first = compile_plan.fleet_chunk(cfg, states, tps, keys)
        one = compile_plan.engine_chunk(cfg, st, tp, keys[:, 0])
        if first or exe.launches != one.launches or \
                compile_plan.cache_sizes()["fleet"] != 1:
            raise AssertionError(f"phase 6b: the window's executable: first "
                                 f"use {first}, launches {exe.launches} "
                                 f"against one member's {one.launches}, "
                                 f"caches {compile_plan.cache_sizes()}")

        def sequential():
            for i in range(b):
                one(st, tp, keys[:, i])

        exe(states, tps, keys)                      # warm-up, untimed
        sequential()
        times = {"fleet": [], "sequential": []}
        for what in ("fleet", "sequential", "sequential", "fleet"):
            fn = sequential if what == "sequential" else \
                (lambda: exe(states, tps, keys))
            times[what].append(self.events_ms(fn))
        hbs = {k: [b * c * 1e3 / ms for ms in v] for k, v in times.items()}
        nbytes = b * state_nbytes(cfg)["total"]
        print(f"phase 6b [fleet_256x1k]: B={b} members x {c} ticks at "
              f"{cfg.n_peers} peers; members 0, 1, {b // 2 - 1}, {b - 1} "
              f"equal to their own run; fleet_run {first_s:.3f} s (capture "
              f"{exe.capture_s:.3f} s: one graph of one member's {c} "
              f"ticks, replayed {b} times a window; the process's resident "
              f"host memory {graph_rss / 2 ** 20:.1f} MiB higher with it "
              f"cached = {graph_rss / 2 ** 20 / c:.1f} MiB a tick recorded; "
              f"launches recorded {json.dumps(exe.launches)}, one "
              f"member's, each replay repeating them); aggregate "
              f"{hbs['fleet'][0]:.3f} / {hbs['fleet'][1]:.3f} hb/s "
              f"(B x ticks / event-timed wall) against {b} sequential "
              f"engine_chunk replays {hbs['sequential'][0]:.3f} / "
              f"{hbs['sequential'][1]:.3f} hb/s; peak "
              f"{peak / 2 ** 30:.3f} GiB above the start against B x "
              f"state_nbytes {nbytes / 2 ** 30:.3f} GiB", flush=True)
        del exe, one, results, states
        compile_plan.clear_caches()
        torch.cuda.empty_cache()

    def phase_supervised_fleet(self):
        """6c: eight ``single_topic_1k(1024)`` members with the tick counts
        ``FLEET_TICKS`` (compaction), member 3 ``invariant_mode="raise"``
        on a poisoned state, under ``supervised_fleet_run`` in windows of
        4 with checkpoints and a journal: every member equal to its own
        eager run on the card, the poisoned one retired at the end of the
        first window and equal to that window's ticks, its siblings'
        flags clean; no retry, no degrade, kernels 1-4 recorded; one fleet
        executable (one graph) per window length, whatever the members
        left."""
        import dataclasses
        import tempfile
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.ops import cudalib
        from go_libp2p_pubsub_tpu_torch.parallel import compile_plan
        from go_libp2p_pubsub_tpu_torch.sim import run, run_keys, scenarios
        from go_libp2p_pubsub_tpu_torch.sim.fleet import (
            FleetMember, supervised_fleet_run)
        from go_libp2p_pubsub_tpu_torch.sim.supervisor import \
            SupervisorConfig
        dev = self.dev
        cfg, tp, st = scenarios.single_topic_1k(FLEET_N, device=dev)
        rcfg = dataclasses.replace(cfg, invariant_mode="raise")
        poisoned = st._replace(halo_overflow=torch.full(
            (), 3, dtype=torch.int32, device=dev))
        members = [FleetMember(rcfg if i == 3 else cfg, tp,
                               poisoned if i == 3 else st,
                               rng.PRNGKey(50 + i, device=dev), t, f"m{i}")
                   for i, t in enumerate(FLEET_TICKS)]
        compile_plan.clear_caches()
        self.sync()
        cudalib.reset_launches()
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            results, rep = supervised_fleet_run(
                members, SupervisorConfig(
                    chunk_ticks=4, checkpoint_dir=os.path.join(tmp, "ck"),
                    health_path=os.path.join(tmp, "j.ndjson")), device=dev)
            self.sync()
            secs = time.perf_counter() - t0
        launches = dict(cudalib.LAUNCHES)
        print(f"phase 6c [supervised fleet] launches: {json.dumps(launches)}",
              flush=True)
        self.check_launches("supervised fleet", launches, cfg)
        if rep.retries or rep.degrade_level:
            raise AssertionError(f"phase 6c: retries {rep.retries}, degrade "
                                 f"level {rep.degrade_level}")
        first = min(4, min(FLEET_TICKS))
        for i, (m, r) in enumerate(zip(members, results)):
            if i == 3:
                want = run_keys(m.state, cfg, m.tp,
                                rng.split(m.key, m.n_ticks)[:first],
                                device=dev)
                ok = r.tripped and r.ticks_run == first
            else:
                want = run(m.state, m.cfg, m.tp, m.key, m.n_ticks,
                           device=dev)
                ok = not r.tripped and r.ticks_run == m.n_ticks \
                    and r.fault_flags == 0
            bad = self.differ(want, r.state)
            if bad or not ok:
                raise AssertionError(f"phase 6c: member {i} ({r.ticks_run} "
                                     f"ticks, tripped {r.tripped}) differs "
                                     f"in {bad}")
        windows = [(e["b_active"], e["window_ticks"]) for e in rep.events
                   if e["event"] == "chunk_ok"]
        cached = compile_plan.cache_sizes()
        if cached["fleet"] != len({t for _, t in windows}):
            raise AssertionError(f"phase 6c: {cached} executables cached "
                                 f"for the windows {windows}")
        print(f"phase 6c [supervised fleet]: 8 members, ticks "
              f"{list(FLEET_TICKS)}, member 3 raise-mode and poisoned: "
              f"retired after {first} ticks ({results[3].flag_names}), "
              f"frozen equal to its first {first} ticks; every member equal "
              f"to its own run; windows (members, ticks) {windows}, "
              f"{cached['fleet']} fleet executables cached; "
              f"{len(rep.checkpoints)} checkpoints; {secs:.3f} s",
              flush=True)
        compile_plan.clear_caches()
        torch.cuda.empty_cache()

    # ---- phase 7: adversaries, directives and traces -------------------
    def phase_families(self, cpu):
        """7a: the five attack families at N_FAMILY peers (K = 16, degree
        6, each its own ``n_ticks``): stepped tick by tick on the card,
        each tick's state and health row against the CPU child's, then
        ``run_with_contracts`` on the card, its final state, rows and
        contract results against the same."""
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.sim import (adversary, state_to_numpy,
                                                    step, telemetry)
        dev = self.dev
        for name, build in adversary.ATTACKS.items():
            want_ticks, want_rows, want_results = cpu["families"][name]
            scn = build(n_peers=N_FAMILY, device=dev)
            keys = rng.split(rng.PRNGKey(0, device=dev), scn.n_ticks)
            st, rows = scn.state, []
            for i in range(scn.n_ticks):
                st = step(st, scn.cfg, scn.tp, keys[i], device=dev)
                _same_fingerprint(f"phase 7a [{name}] tick {i}",
                                  _fingerprint(state_to_numpy(st)),
                                  want_ticks[i])
                rows.append(telemetry.record_to_row(
                    telemetry.health_record(st, scn.cfg, scn.tp)))
            _same_rows(f"phase 7a [{name}]", rows, want_rows)
            self.sync()
            t0 = time.perf_counter()
            rep = adversary.run_with_contracts(scn, device=dev)
            self.sync()
            secs = time.perf_counter() - t0
            if self.differ(st, rep.state) or rep.rows != rows:
                raise AssertionError(f"phase 7a [{name}]: run_with_contracts "
                                     f"left the stepped trajectory")
            got = [(r.kind, r.status, r.detail, r.measured)
                   for r in rep.results]
            if got != want_results:
                raise AssertionError(f"phase 7a [{name}]: contract results "
                                     f"{got} against the CPU's "
                                     f"{want_results}")
            print(f"phase 7a [{name}]: {N_FAMILY} peers, {scn.n_ticks} "
                  f"ticks, every tick's state and health row equal to the "
                  f"CPU run; run_with_contracts {secs:.3f} s = "
                  f"{scn.n_ticks / secs:.3f} hb/s; fault_flags "
                  f"0x{rep.fault_flags:08x}; contracts "
                  f"{[(r.kind, r.status) for r in rep.results]} (equal to "
                  f"the CPU's)", flush=True)

    def bench_family(self, label, topo):
        """``(AttackScenario, key)`` of a phase-7 bench-scale family at
        N_CHURN peers on ``topo``, built as its ``sim.scenarios`` entry
        builds it (K = 32, degree 12, the window at ticks [3, 8))."""
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.sim import adversary
        kw = dict(n_peers=N_CHURN, k_slots=K, degree=12, start=3, end=8,
                  device=self.dev, topo=topo)
        if label == "eclipse_50k":
            scn = adversary.eclipse(**kw)
        else:
            scn = adversary.flash_crowd(hot=64, **kw)
        return scn, rng.PRNGKey(17, device=self.dev)

    def phase_bench_families(self, topo):
        """7b: ``eclipse_50k`` and ``flashcrowd_50k`` at N_CHURN peers,
        SCALE_TICKS ticks: eager ``run_with_contracts`` (launches, peak
        memory, hb/s by the host clock after a sync) and a captured
        ``engine_chunk(telemetry=True)`` of C = 8 replayed SCALE_TICKS / C
        times from the same state and keys (hb/s by CUDA events over the
        replays, capture excluded): rows and final state equal exactly."""
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.ops import cudalib
        from go_libp2p_pubsub_tpu_torch.parallel import compile_plan
        from go_libp2p_pubsub_tpu_torch.sim import adversary, telemetry
        c = CAPTURE_TICKS
        for label in ("eclipse_50k", "flashcrowd_50k"):
            scn, key = self.bench_family(label, topo)
            cfg, tp, st = scn.cfg, scn.tp, scn.state
            torch.cuda.empty_cache()
            self.sync()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            cudalib.reset_launches()
            t0 = time.perf_counter()
            rep = adversary.run_with_contracts(scn, key, SCALE_TICKS,
                                               device=self.dev)
            self.sync()
            eager_s = time.perf_counter() - t0
            eager_peak = torch.cuda.max_memory_allocated() - base
            launches = dict(cudalib.LAUNCHES)
            print(f"phase 7b [{label}] launches: {json.dumps(launches)}",
                  flush=True)
            self.check_launches(label, launches, cfg)
            keys = rng.split(key, SCALE_TICKS)
            compile_plan.clear_caches()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            exe = compile_plan.engine_chunk(cfg, st, tp, keys[:c],
                                            telemetry=True)
            self.sync()
            capture_s = time.perf_counter() - t0
            out, recs = st, []

            def replays():
                nonlocal out
                for i in range(0, SCALE_TICKS, c):
                    out, rec = exe(out, tp, keys[i:i + c])
                    recs.append(rec)

            ms = self.events_ms(replays)
            cap_peak = torch.cuda.max_memory_allocated() - base
            rows = []
            for rec in recs:
                rows += telemetry.rows_to_dicts(
                    *telemetry.records_to_rows(rec))
            if self.differ(rep.state, out) or rows != rep.rows:
                raise AssertionError(f"phase 7b [{label}]: the captured "
                                     f"chunks differ from the eager run")
            print(f"phase 7b [{label}]: {cfg.n_peers} peers on the churn "
                  f"underlay (topology.sparse({N_CHURN}, {K}, degree=12)), "
                  f"{SCALE_TICKS} ticks; eager run_with_contracts "
                  f"{eager_s:.3f} s = {SCALE_TICKS / eager_s:.3f} hb/s, peak "
                  f"{eager_peak / 2 ** 30:.3f} GiB above the state; captured "
                  f"C = {c} (capture {capture_s:.3f} s) replayed "
                  f"{SCALE_TICKS // c} times {ms:.3f} ms = "
                  f"{SCALE_TICKS / ms * 1e3:.3f} hb/s, peak "
                  f"{cap_peak / 2 ** 30:.3f} GiB; rows and final state equal "
                  f"to the eager run; graph launches "
                  f"{json.dumps(exe.launches)}; fault_flags "
                  f"0x{rep.fault_flags:08x}", flush=True)
            for r in rep.results:
                print(f"phase 7b [{label}] contract {r.kind}: {r.status} "
                      f"({r.detail})", flush=True)
            del rep, out, recs, exe, st, scn
            compile_plan.clear_caches()
            torch.cuda.empty_cache()

    def phase_supervised_eclipse(self, topo):
        """7c: ``eclipse_50k`` for SUPERVISED_TICKS ticks under
        ``supervised_run`` in chunks of C = 8 with a journal, its contracts
        live under ``verdict_policy="snapshot"`` and a ``CommandQueue``
        tailing an NDJSON stream that ``write_stream`` wrote (publishes, a
        join and a leave, storm, eclipse and censor directives, one
        malformed line): against the unsupervised loop that applies the
        same frames at the same boundaries and steps with ``run_keys``
        (every field, every journal row), a kill after chunk 1 and a resume
        from the sidecar's ``stream_offset``; every frame applied under
        sync debug "error" and timed by CUDA events."""
        import tempfile
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.ops import cudalib
        from go_libp2p_pubsub_tpu_torch.parallel import compile_plan
        from go_libp2p_pubsub_tpu_torch.sim import (checkpoint, commands,
                                                    run_keys, telemetry)
        from go_libp2p_pubsub_tpu_torch.sim.supervisor import (
            SupervisorConfig, supervised_run)
        dev, c, ticks = self.dev, CAPTURE_TICKS, SUPERVISED_TICKS
        scn, key = self.bench_family("eclipse_50k", topo)
        cfg, tp, st = scn.cfg, scn.tp, scn.state
        directives = [
            {"op": "publish", "tick": 1, "peer": 3, "topic": 0},
            {"op": "join", "tick": 2, "peer": 7, "topic": 0},
            {"op": "attack", "tick": 4, "kind": "storm", "topic": 0,
             "peers": list(range(10, 18))},
            {"op": "attack", "tick": 5, "kind": "eclipse",
             "peers": list(range(100, 108))},
            {"op": "attack", "tick": 6, "kind": "censor",
             "peers": list(range(200, 204))},
            {"op": "attack", "tick": 6, "kind": "eclipse", "topic": 0,
             "peers": [1]},                 # malformed: refused by name
            {"op": "publish", "tick": 9, "peer": 40, "topic": 0},
            {"op": "leave", "tick": 10, "peer": 7, "topic": 0},
        ]
        applies = []

        def queue(src):
            q = commands.CommandQueue(src, n_peers=cfg.n_peers,
                                      n_topics=cfg.n_topics,
                                      msg_window=cfg.msg_window,
                                      stall_timeout_s=30.0)

            def apply(state, cfg_, tp_, frame):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = commands.apply_frame(state, cfg_, tp_, frame)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                b.record()
                applies.append((a, b, frame.count))
                return out
            q.apply = apply
            return q

        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "directives.ndjson")
            size = commands.write_stream(src, directives)

            def supervised(journal, ck, hook=None):
                q = queue(src)
                try:
                    return supervised_run(
                        st, cfg, tp, key, ticks, SupervisorConfig(
                            chunk_ticks=c, health_path=journal,
                            checkpoint_dir=ck, commands=q,
                            contracts=scn.contracts,
                            verdict_policy="snapshot"),
                        device=dev, _chunk_hook=hook)
                finally:
                    q.close()

            compile_plan.clear_caches()
            cudalib.reset_launches()
            self.sync()
            t0 = time.perf_counter()
            got, rep = supervised(os.path.join(tmp, "j.ndjson"),
                                  os.path.join(tmp, "ck"))
            self.sync()
            secs = time.perf_counter() - t0
            launches = dict(cudalib.LAUNCHES)
            print(f"phase 7c [supervised eclipse] launches: "
                  f"{json.dumps(launches)}", flush=True)
            self.check_launches("supervised eclipse", launches, cfg)
            if (rep.retries, rep.degrade_level) != (0, 0):
                raise AssertionError(f"phase 7c: retries {rep.retries}, "
                                     f"degrade {rep.degrade_level}: "
                                     f"{rep.events}")
            apply_ms = [(round(a.elapsed_time(b), 3), n)
                        for a, b, n in applies]
            journal = telemetry.read_journal(os.path.join(tmp, "j.ndjson"))
            notes = journal["notes"]
            end = notes[-1]
            refused = [n for n in notes if n["kind"] == "directive_refused"]
            if end["kind"] != "run_end" or end["commands_refused"] != 1 or \
                    len(refused) != 1 or "takes no 'topic'" not in \
                    refused[0]["reason"] or end["ingest_offset"] != size:
                raise AssertionError(f"phase 7c: the stream's refusal and "
                                     f"offset: {end}, {refused}")
            # the unsupervised loop: the same frames at the same boundaries
            q = commands.CommandQueue(src, n_peers=cfg.n_peers,
                                      n_topics=cfg.n_topics,
                                      msg_window=cfg.msg_window,
                                      stall_timeout_s=30.0).start(0)
            keys = rng.split(key, ticks)
            want, recs = st, []
            try:
                for lo in range(0, ticks, c):
                    f = q.frame_for(int(st.tick) + lo, c)
                    if f.count:
                        want = commands.apply_frame(want, cfg, tp, f)
                    want, rec = run_keys(want, cfg, tp, keys[lo:lo + c],
                                         telemetry=True, device=dev)
                    recs.append(rec)
            finally:
                q.close()
            want_rows = []
            for rec in recs:
                want_rows += telemetry.rows_to_dicts(
                    *telemetry.records_to_rows(rec))
            rows = [{k: v for k, v in r.items() if k != "kind"}
                    for r in journal["rows"]]
            bad = self.differ(want, got)
            if bad or rows != want_rows:
                raise AssertionError(f"phase 7c: differs from the "
                                     f"unsupervised loop in {bad} (rows "
                                     f"equal: {rows == want_rows})")
            verdicts = [(n["contract_kind"], n["status"], n["tick"])
                        for n in notes if n["kind"] == "contract_verdict"]
            # phase 12d renders this journal and copies this stream again
            keep = os.path.join(self.work, "phase7c")
            os.makedirs(keep, exist_ok=True)
            latest = {}
            for n in notes:
                if n["kind"] == "contract_verdict" and (
                        n["contract"] not in latest or n["seq"] >=
                        latest[n["contract"]]["seq"]):
                    latest[n["contract"]] = n
            self.phase7c = {
                "journal": shutil.copy(os.path.join(tmp, "j.ndjson"), keep),
                "stream": shutil.copy(src, keep),
                "contracts": [{"kind": n.get("contract_kind"),
                               "status": n.get("status"),
                               "detail": n.get("detail"),
                               "tick": n.get("tick")}
                              for _c, n in sorted(latest.items())],
                "fault_flags": journal["rows"][-1]["fault_flags"]}
            # kill after chunk 1, resume from the sidecar's offset
            ck = os.path.join(tmp, "ck2")

            def kill(info):
                if info["chunk_start"] >= int(st.tick) + c:
                    raise KeyboardInterrupt("simulated preemption")

            try:
                supervised(os.path.join(tmp, "k.ndjson"), ck, kill)
                raise AssertionError("phase 7c: the kill hook did not fire")
            except KeyboardInterrupt:
                pass
            offsets = [checkpoint.sidecar_meta(p).get("stream_offset")
                       for p in sorted(
                           os.path.join(ck, n[:-4]) for n in os.listdir(ck)
                           if n.endswith(".npz"))]
            resumed, rep2 = supervised(os.path.join(tmp, "k.ndjson"), ck)
            start = next(e for e in rep2.events
                         if e["event"] == "ingest_start")
            bad = self.differ(want, resumed)
            if rep2.resumed_tick != int(st.tick) + c or bad or \
                    start["offset"] <= 0:
                raise AssertionError(f"phase 7c: the resume (tick "
                                     f"{rep2.resumed_tick}, offset "
                                     f"{start['offset']}) differs in {bad}")
        print(f"phase 7c [supervised eclipse]: {cfg.n_peers} peers, {ticks} "
              f"ticks in chunks of {c}, journal, contracts live under "
              f"verdict_policy='snapshot', a CommandQueue on a "
              f"{size}-byte stream; equal to the unsupervised loop in every "
              f"field and journal row; retries 0, degrade 0; {secs:.3f} s = "
              f"{ticks / secs:.3f} hb/s over the run's wall (captures "
              f"included); frame applies (ms, ops) {apply_ms} under sync "
              f"debug 'error'; applied {end['commands_applied']}, shed "
              f"{end['commands_shed']}, refused {end['commands_refused']}; "
              f"checkpoints {[os.path.basename(p) for p in rep.checkpoints]}"
              f"; verdicts {verdicts}; killed after chunk 1 (stamped "
              f"offsets {offsets}), resumed at tick {rep2.resumed_tick} "
              f"from offset {start['offset']}: equal", flush=True)
        compile_plan.clear_caches()
        torch.cuda.empty_cache()

    def phase_trace(self, cpu):
        """7d: ``run_traced`` of ``single_topic_1k(N_TRACE)`` with
        provenance for TRACE_TICKS ticks on the card, its events equal to
        the CPU run's list for list and its final state equal; then the
        events tensorized and replayed into a fresh state on the card under
        sync debug "error", equal to the CPU's replay."""
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch.sim import state_to_numpy
        want_fin, want_events, want_rep = cpu["trace"]
        cfg, tp, st, topo = _trace_case(self.dev)
        t0 = time.perf_counter()
        fin, events = _run_trace(cfg, tp, st, self.dev)
        traced_s = time.perf_counter() - t0
        if events != want_events:
            raise AssertionError(f"phase 7d: {len(events)} events against "
                                 f"the CPU's {len(want_events)}, not equal")
        _same_fingerprint("phase 7d [run_traced]",
                          _fingerprint(state_to_numpy(fin)), want_fin)

        def no_sync():
            import contextlib

            @contextlib.contextmanager
            def guard():
                torch.cuda.set_sync_debug_mode("error")
                try:
                    yield
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            return guard()

        rep, n_ops, secs = _replay_trace(cfg, tp, topo, events,
                                         self.dev, guard=no_sync)
        _same_fingerprint("phase 7d [replay]",
                          _fingerprint(state_to_numpy(rep)), want_rep)
        self.trace = (cfg, tp, topo, events, rep)      # phase 10b's input
        kinds = {}
        for e in events:
            kinds[e["type"]] = kinds.get(e["type"], 0) + 1
        print(f"phase 7d [trace loop]: single_topic_1k({N_TRACE}) with "
              f"provenance, {TRACE_TICKS} ticks of run_traced in "
              f"{traced_s:.3f} s, {len(events)} events {kinds}, equal to "
              f"the CPU run list for list; replay of {n_ops} ops into a "
              f"fresh state under sync debug 'error' in {secs:.3f} s = "
              f"{n_ops / secs:.1f} ops/s, equal to the CPU's replay",
              flush=True)

    # ---- phase 8: the degree-bucketed engine (sim/bucketed.py) ----------
    def phase_bucketed_trajectory(self, cpu):
        """8a: the 1024-peer bucketed network under each bucketed_rng, every
        array after every tick against the CPU child's, no hand kernel."""
        from go_libp2p_pubsub_tpu_torch.ops import cudalib
        from go_libp2p_pubsub_tpu_torch.sim import topology
        buckets = topology.powerlaw_buckets(N_BUCKETED, d_min=4, d_max=16)
        for mode in ("bucket", "dense"):
            want, want_flags = cpu[mode]
            cudalib.reset_launches()
            self.sync()
            t0 = time.perf_counter()
            got, flags = _bucketed_ticks(self.dev, mode)
            secs = time.perf_counter() - t0
            for i, (g, w) in enumerate(zip(got, want, strict=True)):
                _same_fingerprint(f"phase 8a [{mode}] tick {i}", g, w)
            launched = {k: v for k, v in cudalib.LAUNCHES.items()
                        if v and k != "select_rows"}
            if launched or not cudalib.LAUNCHES["select_rows"]:
                raise AssertionError(f"phase 8a [{mode}]: hand kernels "
                                     f"launched on the bucketed path: "
                                     f"{dict(cudalib.LAUNCHES)} (only its "
                                     "selections' select_rows belongs)")
            if flags != want_flags or not flags & 0x80:
                raise AssertionError(f"phase 8a [{mode}]: fault_flags "
                                     f"0x{flags:08x} against the CPU's "
                                     f"0x{want_flags:08x} (eclipse bit 0x80 "
                                     "expected)")
            print(f"phase 8a [{mode}]: {N_BUCKETED} peers in buckets "
                  f"{buckets}, {BUCKETED_TICKS} ticks in "
                  f"{secs:.3f} s (each tick fingerprinted), every array of "
                  f"g, the buckets and rev equal to the CPU run after every "
                  f"tick; fault_flags 0x{flags:08x}; no hand kernel "
                  "launched but select_rows", flush=True)

    def phase_powerlaw_1m(self, topo):
        """8b: ``powerlaw_1m`` at 1,048,576 peers, its own config (compact,
        ``"bucket"`` draws): stored bytes against ``state_nbytes``, one warm
        tick and 4 ticks timed by CUDA events, peak memory above the start,
        kernels 1-7 launched 0 times, one more tick under sync debug
        "error"."""
        import dataclasses
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.ops import cudalib
        from go_libp2p_pubsub_tpu_torch.sim import (bucketed,
                                                    delivery_fraction,
                                                    scenarios, state_nbytes,
                                                    topology)
        from go_libp2p_pubsub_tpu_torch.sim.invariants import (
            VIOLATION_MASK, decode_flags)
        dev = self.dev
        self.sync()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        cfg, tp, bs = scenarios.powerlaw_1m(device=dev, topo=topo)
        self.sync()
        build_s = time.perf_counter() - t0
        stored = sum(v.numel() * v.element_size()
                     for _, v, _ in bucketed.named_leaves(bs))
        priced = state_nbytes(cfg)["total"]
        dense = state_nbytes(dataclasses.replace(cfg, degree_buckets=None))
        if stored != priced:
            raise AssertionError(f"phase 8b: stored {stored} bytes, "
                                 f"state_nbytes prices {priced}")
        print(f"phase 8b [powerlaw_1m]: {cfg.n_peers} peers, buckets "
              f"{cfg.degree_buckets}, T={cfg.n_topics}, M={cfg.msg_window}, "
              f"{cfg.state_precision}, bucketed_rng={cfg.bucketed_rng}; "
              f"degree_stats {json.dumps(topology.degree_stats(topo))}; "
              f"state built on the card in {build_s:.1f} s; stored "
              f"{stored} bytes = {stored / 2 ** 30:.3f} GiB, equal to "
              f"state_nbytes (the dense-padded layout would price "
              f"{dense['total'] / 2 ** 30:.3f} GiB)", flush=True)
        key = rng.PRNGKey(0, device=dev)
        keys = rng.split(key, 6)
        self.sync()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        w0 = time.perf_counter()
        bs = bucketed.bucketed_step(bs, cfg, tp, keys[0], device=dev)
        self.sync()
        warm_s = time.perf_counter() - w0
        cudalib.reset_launches()
        a.record()
        for i in range(1, 5):
            bs = bucketed.bucketed_step(bs, cfg, tp, keys[i], device=dev)
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b)
        launches = dict(cudalib.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - start
        print(f"phase 8b [powerlaw_1m] launches: {json.dumps(launches)}",
              flush=True)
        self.check_launches("powerlaw_1m", launches, cfg,
                            forms=bucketed_formulations(cfg))
        torch.cuda.set_sync_debug_mode("error")
        try:
            bs = bucketed.bucketed_step(bs, cfg, tp, keys[5], device=dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        self.sync()
        flags = int(bs.fault_flags) & 0xFFFFFFFF
        dlv = float(delivery_fraction(bs.g, cfg, min_age_ticks=2))
        print(f"phase 8b [powerlaw_1m]: warm tick {warm_s:.3f} s; 4 ticks "
              f"in {ms:.1f} ms (CUDA events) = {4000 / ms:.3f} hb/s eager; "
              f"peak device memory {peak / 2 ** 30:.3f} GiB above the "
              f"start ({start / 2 ** 30:.3f} GiB allocated then, "
              f"{(start - base) / 2 ** 30:.3f} GiB of it the state); one "
              f"more tick under sync debug 'error' made no synchronization; "
              f"delivery_fraction (age>=2) {dlv:.6f}; delivered_total "
              f"{float(bs.g.delivered_total):.0f}; fault_flags "
              f"0x{flags:08x} {decode_flags(flags)}", flush=True)
        if flags & VIOLATION_MASK or float(bs.g.delivered_total) <= 0:
            raise AssertionError(f"phase 8b: fault_flags 0x{flags:x}, "
                                 f"delivered {float(bs.g.delivered_total)}")

    def phase_heavytail(self, topo):
        """8c: ``heavytail_eclipse`` at 131,072 peers for 10 ticks (eclipse
        window [3, 8)); then under ``bucketed_rng="dense"`` and f32 the
        densified state after 4 ticks against the dense ``run`` on the
        card (kernels 1-4), every field bit for bit."""
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.ops import cudalib
        from go_libp2p_pubsub_tpu_torch.sim import (bucketed,
                                                    delivery_fraction, run,
                                                    scenarios)
        from go_libp2p_pubsub_tpu_torch.sim.invariants import (
            FAULT_ECLIPSE, VIOLATION_MASK, decode_flags)
        dev = self.dev
        cfg, tp, bs = scenarios.heavytail_eclipse(device=dev, topo=topo)
        key = rng.PRNGKey(0, device=dev)
        self.sync()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        cudalib.reset_launches()
        t0 = time.perf_counter()
        out = bucketed.bucketed_run(bs, cfg, tp, key, 10, device=dev)
        self.sync()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - start
        launches = dict(cudalib.LAUNCHES)
        self.check_launches("heavytail_eclipse", launches, cfg,
                            forms=bucketed_formulations(cfg))
        flags = int(out.fault_flags) & 0xFFFFFFFF
        print(f"phase 8c [heavytail_eclipse]: {cfg.n_peers} peers, buckets "
              f"{cfg.degree_buckets}, {cfg.state_precision}, bucketed_rng="
              f"{cfg.bucketed_rng}, {int(out.g.malicious.sum())} sybils; 10 "
              f"ticks of bucketed_run in {secs:.3f} s = {10 / secs:.3f} hb/s "
              f"(host clock, first use included); peak "
              f"{peak / 2 ** 30:.3f} GiB above the start; delivery_fraction "
              f"(age>=2) "
              f"{float(delivery_fraction(out.g, cfg, min_age_ticks=2)):.6f};"
              f" fault_flags 0x{flags:08x} {decode_flags(flags)}; launches "
              f"{json.dumps(launches)}", flush=True)
        if not flags & FAULT_ECLIPSE or flags & VIOLATION_MASK:
            raise AssertionError(f"phase 8c: fault_flags 0x{flags:x} "
                                 "(the eclipse bit set, no violation "
                                 "expected)")
        del out, bs
        cfg, tp, bs = scenarios.heavytail_eclipse(
            device=dev, topo=topo, state_precision="f32",
            bucketed_rng="dense")
        dense0 = bucketed.densify_state(bs, cfg)
        got = bucketed.densify_state(
            bucketed.bucketed_run(bs, cfg, tp, key, 4, device=dev), cfg)
        del bs
        self.sync()
        cudalib.reset_launches()
        want = run(dense0, cfg, tp, key, 4, device=dev)
        self.sync()
        launches = dict(cudalib.LAUNCHES)
        print(f"phase 8c [heavytail dense] launches: {json.dumps(launches)}",
              flush=True)
        self.check_launches("heavytail dense", launches, cfg)
        bad = self.differ(want, got)
        if bad:
            raise AssertionError(f"phase 8c: the densified bucketed state "
                                 f"differs from the dense run in {bad}")
        print(f"phase 8c [heavytail dense]: bucketed_rng='dense', f32, 4 "
              f"ticks: the densified bucketed state equals the dense run "
              f"(kernels 1-4 under the cuda dispatch entry) in every field, "
              f"bit for bit; fault_flags 0x{int(want.fault_flags):08x}",
              flush=True)

    # ---- phase 9: the multi-device plane, two ranks on one card ----------
    def _ranks(self, tag, args, nproc=2, timeout=600, module="run_multihost",
               env_extra=None):
        """``nproc`` ranks of ``python -m go_libp2p_pubsub_tpu_torch.run_
        multihost`` (gloo over the card's tensors, a file rendezvous) with
        ``args`` (``{d}`` replaced by the leg's directory); a failed rank
        fails the phase. Returns (directory, each rank's ``--stats``).
        ``module="mh_supervisor"`` runs the relaunch driver instead, which
        starts the ranks itself."""
        import tempfile
        d = tempfile.mkdtemp(prefix=f"smoke{tag}")
        args = [a.replace("{d}", d) for a in args]
        env = {k: v for k, v in os.environ.items() if k != "GRAFT_CHAOS"}
        env["PYTHONPATH"] = REPO
        env["GRAFT_CRASH_DIR"] = os.path.join(d, "crash")
        env.update(env_extra or {})
        if module == "mh_supervisor":
            res = subprocess.run(
                [sys.executable, "-m", "go_libp2p_pubsub_tpu_torch."
                 "mh_supervisor", "--procs", str(nproc), "--backend",
                 "gloo", "--device", "cuda", "--rendezvous", "file",
                 "--run-dir", os.path.join(d, "mh")] + args,
                cwd=REPO, env=env, capture_output=True, text=True,
                timeout=timeout)
            if res.returncode:
                logs = "".join(
                    open(os.path.join(d, "mh", f)).read()[-2000:]
                    for f in sorted(os.listdir(os.path.join(d, "mh")))
                    if f.endswith(".log"))
                raise AssertionError(f"phase {tag}: mh_supervisor exited "
                                     f"{res.returncode}\n{res.stdout}\n"
                                     f"{res.stderr[-2000:]}\n{logs}")
            return d, res.stdout
        procs = []
        for r in range(nproc):
            log = open(os.path.join(d, f"rank{r}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-m",
                 "go_libp2p_pubsub_tpu_torch.run_multihost",
                 "--backend", "gloo", "--device", "cuda",
                 "--coordinator", f"file://{d}/rdv",
                 "--num-processes", str(nproc), "--process-id", str(r),
                 "--stats", os.path.join(d, "s{rank}.json")] + args,
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT),
                log))
        try:
            codes = [p.wait(timeout=timeout) for p, _ in procs]
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        if any(codes):
            tails = "\n".join(open(os.path.join(d, f"rank{r}.log")).read()
                               [-3000:] for r in range(nproc))
            raise AssertionError(f"phase {tag}: rank exit codes "
                                 f"{codes}\n{tails}")
        stats = []
        for r in range(nproc):
            with open(os.path.join(d, f"s{r}.json")) as f:
                stats.append(json.load(f))
        return d, stats

    def _rank_report(self, leg, stats, path=None):
        for st in stats:
            print(f"phase {leg} rank {st['rank']} ({st['backend']} on "
                  f"{st['device']}): {st['hbps']:.3f} hb/s, two ranks "
                  f"sharing one card (not a scaling figure); collective "
                  f"bytes per tick "
                  f"{json.dumps(st['collective_bytes_per_tick'])}, "
                  f"{st['collectives_per_tick']:.1f} collectives per tick, "
                  f"largest result elements "
                  f"{json.dumps(st['max_result_elements'])}; launches "
                  f"{json.dumps(st['launches'])}; kernel calls held "
                  f"against their plain versions on the rank's rows: "
                  f"{json.dumps(st['checked_calls'])}", flush=True)
            if path is not None:
                self.path_launches[f"{path} rank {st['rank']}"] = \
                    st["launches"]

    def _single_digests(self, cfg, tp, st, n_ticks):
        """The single-process card run of ``n_ticks`` under the ranks' keys
        (``rng.split(PRNGKey(0), n_ticks)``): (final state, per-tick
        digests)."""
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.parallel.sharding import \
            state_digests
        from go_libp2p_pubsub_tpu_torch.sim.engine import _step
        keys = rng.split(rng.PRNGKey(0, device=self.dev), n_ticks)
        out = []
        for i in range(n_ticks):
            st = _step(st, cfg, tp, keys[i])[0]
            out.append(state_digests(st, cfg))
        return st, out

    def _same_run(self, leg, d, want_digests, want_state):
        """The ranks' per-tick digests and gathered final state against the
        single-process run's; returns the final ``halo_overflow``."""
        import numpy as np
        from go_libp2p_pubsub_tpu_torch.sim import state_to_numpy
        if want_digests is not None:
            with open(os.path.join(d, "d.json")) as f:
                got = json.load(f)
            if len(got) != len(want_digests):
                raise AssertionError(f"phase {leg}: {len(got)} ticks of "
                                     "digests")
            for i, (g, w) in enumerate(zip(got, want_digests)):
                bad = [f for f in w if g[f] != w[f]]
                if bad:
                    raise AssertionError(
                        f"phase {leg}: tick {i} fields {bad} differ from "
                        "the single-process run")
        want = state_to_numpy(want_state)
        with np.load(os.path.join(d, "f.npz")) as z:
            bad = [f for f in want if not np.array_equal(z[f], want[f])]
            overflow = int(z["halo_overflow"])
        if bad:
            raise AssertionError(f"phase {leg}: the gathered final state "
                                 f"differs in {bad}")
        return overflow

    def _save_topology(self, topo):
        import tempfile

        import numpy as np
        fd, path = tempfile.mkstemp(suffix=".npz", prefix="smoke9topo")
        os.close(fd)
        np.savez(path, neighbors=topo.neighbors, outbound=topo.outbound,
                 reverse_slot=topo.reverse_slot, degree=topo.degree)
        return path

    def phase_multirank(self, topo, topo_churn):
        """9a/9b: two run_multihost ranks of the headline on kernels 1-4,
        of the headline under the halo route and its starved control, and
        of churn_50k on kernels 4-6; each leg's per-tick digests and final
        state against the single-process card run of the same keys, and a
        checked tick whose every kernel call is held against its plain
        version on the rank's own inputs."""
        import dataclasses

        from go_libp2p_pubsub_tpu_torch.sim import build_headline, scenarios
        from go_libp2p_pubsub_tpu_torch.sim.invariants import \
            FLAG_HALO_OVERFLOW
        tfile = self._save_topology(topo)
        cfile = self._save_topology(topo_churn)
        halo = {"edge_gather_mode": "sort", "sharded_route": "halo",
                "hop_mode": "xla"}
        legs = [
            ("9a", "headline", "headline", {"n_peers": self.n}, {}, 8,
             tfile, ("edge_table", "hop", "iwant_resolve", "emit")),
            ("9b", "headline halo", "headline", {"n_peers": self.n}, halo,
             4, tfile, ()),
            ("9b", "churn_50k pallas", "churn_50k", {"n_peers": N_CHURN},
             {"hop_mode": "xla", "edge_gather_mode": "pallas"}, 4, cfile,
             ("edge_table", "gather_words", "permutation_gather")),
        ]
        try:
            for leg, label, scen, kw, over, ticks, tf, kernels in legs:
                t0 = time.perf_counter()
                d, stats = self._ranks(leg, [
                    "--scenario", scen, "--kwargs", json.dumps(kw),
                    "--cfg", json.dumps(over), "--topology-file", tf,
                    "--ticks", str(ticks), "--digests", "{d}/d.json",
                    "--dump-state", "{d}/f"]
                    + (["--check-kernels"] if kernels else []))
                ranks_s = time.perf_counter() - t0
                self._rank_report(f"{leg} [{label}]", stats,
                                  f"{leg} {label}" if kernels else None)
                for st in stats:
                    missing = [k for k in kernels
                               if not st["launches"][k]
                               or not st["checked_calls"].get(k)]
                    if missing:
                        raise AssertionError(
                            f"phase {leg} [{label}] rank {st['rank']}: "
                            f"kernels {missing} not launched or not "
                            "checked on the rank's rows")
                topo_l = topo if tf == tfile else topo_churn
                if scen == "headline":
                    cfg, tp, st0 = build_headline(self.n, device=self.dev,
                                                  topo=topo_l)
                else:
                    cfg, tp, st0 = scenarios.churn_50k(
                        n_peers=N_CHURN, device=self.dev, topo=topo_l)
                cfg = dataclasses.replace(cfg, **over)
                want, digests = self._single_digests(cfg, tp, st0, ticks)
                overflow = self._same_run(f"{leg} [{label}]", d, digests,
                                          want)
                if overflow:
                    raise AssertionError(f"phase {leg} [{label}]: "
                                         f"halo_overflow {overflow}")
                print(f"phase {leg} [{label}]: {cfg.n_peers} peers, "
                      f"{ticks} ticks on two ranks ({ranks_s:.1f} s with "
                      "start-up): the per-tick digests and the gathered "
                      "final state equal the single-process card run in "
                      "every field, halo_overflow 0", flush=True)
                del want, st0
            # the starved control: one-slot buckets overflow, counted and
            # flagged on every rank
            d, stats = self._ranks("9b", [
                "--scenario", "headline", "--kwargs",
                json.dumps({"n_peers": self.n}), "--cfg",
                json.dumps({**halo, "halo_bucket_capacity": 1}),
                "--topology-file", tfile, "--ticks", "1",
                "--digests", "{d}/d.json", "--dump-state", "{d}/f"])
            import numpy as np
            with np.load(os.path.join(d, "f.npz")) as z:
                ovf = int(z["halo_overflow"])
                flags = int(z["fault_flags"])
            if ovf <= 0 or not flags & FLAG_HALO_OVERFLOW:
                raise AssertionError(f"phase 9b: the starved control "
                                     f"ended with halo_overflow {ovf}, "
                                     f"fault_flags 0x{flags:x}")
            print(f"phase 9b [starved control]: halo_bucket_capacity=1 "
                  f"sets halo_overflow {ovf} and the halo-overflow bit "
                  f"(fault_flags 0x{flags:08x})", flush=True)
        finally:
            os.remove(tfile)
            os.remove(cfile)

    def phase_bucketed_ranks(self, topo):
        """9d: two run_multihost ranks of heavytail_eclipse (131,072 peers,
        compact, ``"bucket"`` draws) on the row-sharded bucketed step, 10
        ticks; the gathered final state equals the single-process card
        run of the same keys leaf for leaf, with the eclipse bit set."""
        import numpy as np
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.sim import bucketed, scenarios
        from go_libp2p_pubsub_tpu_torch.sim.invariants import (
            FAULT_ECLIPSE, VIOLATION_MASK)
        tfile = self._save_topology(topo)
        ticks = 10
        try:
            t0 = time.perf_counter()
            d, stats = self._ranks("9d", [
                "--engine", "bucketed", "--scenario", "heavytail_eclipse",
                "--kwargs", json.dumps({"n_peers": N_POWERLAW_100K}),
                "--topology-file", tfile, "--ticks", str(ticks),
                "--unsupervised", "--dump-state", "{d}/f"])
            ranks_s = time.perf_counter() - t0
        finally:
            os.remove(tfile)
        self._rank_report("9d [heavytail_eclipse]", stats)
        cfg, tp, bs = scenarios.heavytail_eclipse(device=self.dev,
                                                  topo=topo)
        keys = rng.split(rng.PRNGKey(0, device=self.dev), ticks)
        for i in range(ticks):
            bs = bucketed.bucketed_step(bs, cfg, tp, keys[i],
                                        device=self.dev)
        want = bucketed.bucketed_state_to_numpy(bs)
        with np.load(os.path.join(d, "f.npz")) as z:
            bad = [k for k in want if not np.array_equal(z[k], want[k])]
            flags = int(z["g.fault_flags"])
        if bad:
            raise AssertionError(f"phase 9d: the gathered bucketed state "
                                 f"differs in {bad[:8]}")
        if not flags & FAULT_ECLIPSE or flags & VIOLATION_MASK:
            raise AssertionError(f"phase 9d: fault_flags 0x{flags:x}")
        print(f"phase 9d [heavytail_eclipse]: {cfg.n_peers} peers in "
              f"buckets {list(cfg.degree_buckets)}, {ticks} ticks on two "
              f"ranks ({ranks_s:.1f} s with start-up): the gathered state "
              f"equals the single-process card run in every leaf; "
              f"fault_flags 0x{flags:08x} (the eclipse bit)", flush=True)

    def phase_mh_resilience(self):
        """9c: mh_supervisor runs two ranks of single_topic_1k(1024), 16
        ticks in chunks of 8 with a checkpoint at each; GRAFT_CHAOS kills
        rank 1 at tick 8; the group relaunches from the checkpoint, and
        its final state equals the uninterrupted single-process run."""
        import numpy as np
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.sim import run, scenarios, \
            state_to_numpy
        t0 = time.perf_counter()
        d, out = self._ranks("9c", [
            "--scenario", "single_topic_1k", "--kwargs",
            json.dumps({"n_peers": 1024}), "--ticks", "16",
            "--chunk-ticks", "8", "--dump-state", "{d}/f",
            "--backoff-base-s", "0.5"], module="mh_supervisor",
            env_extra={"GRAFT_CHAOS": "kill@1:8"})
        secs = time.perf_counter() - t0
        lines = [json.loads(x) for x in out.splitlines()
                 if x.startswith("{")]
        steps = [x["mh"] for x in lines]
        if steps != ["launch", "failure", "launch", "done"] \
                or lines[2].get("ckpt_tick") != 8:
            raise AssertionError(f"phase 9c: the relaunch went {lines}")
        cfg, tp, st = scenarios.single_topic_1k(1024, device=self.dev)
        want = state_to_numpy(run(st, cfg, tp, rng.PRNGKey(0,
                                                           device=self.dev),
                                  16, device=self.dev))
        with np.load(os.path.join(d, "f.npz")) as z:
            bad = [f for f in want if not np.array_equal(z[f], want[f])]
        if bad:
            raise AssertionError(f"phase 9c: the relaunched run differs "
                                 f"from the uninterrupted one in {bad}")
        print(f"phase 9c [mh_supervisor]: rank 1 SIGKILLed at tick 8 "
              f"({lines[1]['why']}), the group relaunched from the tick-8 "
              f"checkpoint, 16 ticks equal the uninterrupted card run in "
              f"every field ({secs:.1f} s)", flush=True)

    # ---- phase 10: the host tools (trace files, encoder, sweep, dispatch) --
    def phase_sweep(self):
        """10a on the card: ``sweep_scores.run_sweep`` over
        SWEEP_SCENARIOS x SWEEP_VARIANTS (512 peers, 2 seeds, 40 ticks or
        the attack's own), killed when its second scenario's fleet
        completes, before those rows reach the journal; then run again on
        the journal: the first scenario's rows come from it (no fleet),
        equal to the rows the killed run emitted, and the second
        scenario's members equal the killed run's. Kernels 1-4 launched;
        aggregate member-ticks/s by the host clock. The rows and every
        member's fingerprint wait for the CPU run (:meth:`check_sweep`)."""
        import tempfile

        import numpy as np
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch.ops import cudalib
        from go_libp2p_pubsub_tpu_torch.parallel import compile_plan
        from go_libp2p_pubsub_tpu_torch.sim import scenarios
        first, second = SWEEP_SCENARIOS
        d = tempfile.mkdtemp(prefix="smoke10a")
        journal = os.path.join(d, "sweep.jsonl")
        digests, lines = {}, []
        compile_plan.clear_caches()
        self.sync()
        cudalib.reset_launches()
        t0 = time.perf_counter()
        try:
            _sweep(self.dev, digests, lines, journal=journal, kill_at=second)
        except _Killed:
            pass
        else:
            raise AssertionError("phase 10a: the kill did not fire")
        self.sync()
        killed_s = time.perf_counter() - t0
        launches = dict(cudalib.LAUNCHES)
        print(f"phase 10a [score sweep] launches: {json.dumps(launches)}",
              flush=True)
        self.check_launches("score sweep", launches, scenarios.sybil_small(
            n_peers=512, device=self.dev)[0])
        with open(journal) as f:
            recorded = [json.loads(x) for x in f]
        if [(r["scenario"], r["variant"]) for r in recorded] != \
                [(first, v) for v in SWEEP_VARIANTS]:
            raise AssertionError(f"phase 10a: the killed sweep journaled "
                                 f"{[r['scenario'] for r in recorded]}")
        killed_done = [x for x in lines if x.get("info") == "fleet done"]
        killed_rows = [x for x in lines if "info" not in x]
        killed_ticks = sum(x["member_ticks"] for x in killed_done)
        rerun_digests, lines = {}, []
        t0 = time.perf_counter()
        rows = _sweep(self.dev, rerun_digests, lines, journal=journal)
        self.sync()
        rerun_s = time.perf_counter() - t0
        skips = [(x["scenario"], x["variant"]) for x in lines
                 if x.get("info") == "journal skip"]
        done = [x for x in lines if x.get("info") == "fleet done"]
        if skips != [(first, v) for v in SWEEP_VARIANTS] \
                or [x["scenario"] for x in done] != [second]:
            raise AssertionError(f"phase 10a: the rerun skipped {skips} and "
                                 f"ran {[x['scenario'] for x in done]}")
        if rows[:len(SWEEP_VARIANTS)] != killed_rows:
            raise AssertionError("phase 10a: the journaled rows differ from "
                                 "the killed run's")
        for name, fp in rerun_digests.items():
            same = all(np.array_equal(fp[f], digests[name][f])
                       if isinstance(fp[f], np.ndarray)
                       else fp[f] == digests[name][f] for f in fp)
            if not same:
                raise AssertionError(f"phase 10a: member {name} of the rerun "
                                     "differs from the killed run's")
        rerun_ticks = sum(x["member_ticks"] for x in done)
        fleets = [(x["scenario"], x["members"], x["groups"],
                   x["member_ticks"], x["seconds"])
                  for x in killed_done + done]
        self.sweep = (rows, digests)
        fleet_s = sum(x["seconds"] for x in killed_done)
        rerun_fleet_s = sum(x["seconds"] for x in done)
        print(f"phase 10a [score sweep]: {len(SWEEP_SCENARIOS)} scenarios x "
              f"{len(SWEEP_VARIANTS)} variants x 2 seeds at 512 peers; the "
              f"killed run's fleets: {killed_ticks} member-ticks in "
              f"{fleet_s:.3f} s = {killed_ticks / fleet_s:.1f} member-ticks/s"
              f" aggregate (host clock around supervised_fleet_run, graph "
              f"captures included; the whole killed run {killed_s:.3f} s "
              f"with scenario builds and fingerprints); the rerun took "
              f"{len(skips)} rows from the journal and its one fleet ran "
              f"{rerun_ticks} member-ticks in {rerun_fleet_s:.3f} s = "
              f"{rerun_ticks / rerun_fleet_s:.1f} member-ticks/s on the "
              f"killed run's graphs (rerun {rerun_s:.3f} s in all), its "
              f"members equal the killed run's; fleets (scenario, members, "
              f"groups, member-ticks, s) {fleets}", flush=True)
        for r in rows:
            print(f"phase 10a row: {json.dumps(r)}", flush=True)
        compile_plan.clear_caches()
        torch.cuda.empty_cache()

    def check_sweep(self, cpu):
        """10a against the CPU: every row equal to the CPU run's, and every
        member's final state (float32 planes to rtol 1e-6, the rest by
        digest)."""
        rows, digests = self.sweep
        want_rows, want_digests = cpu
        if rows != want_rows:
            raise AssertionError(f"phase 10a: rows {rows} against the CPU's "
                                 f"{want_rows}")
        if sorted(digests) != sorted(want_digests):
            raise AssertionError("phase 10a: the members differ from the "
                                 "CPU run's")
        for name, want in want_digests.items():
            _same_fingerprint(f"phase 10a [{name}]", digests[name], want)
        print(f"phase 10a [against the CPU]: {len(rows)} rows and "
              f"{len(digests)} members' final states equal the CPU run of "
              f"the port", flush=True)

    def phase_trace_files(self):
        """10b: phase 7d's events after the JOIN preamble through a
        ``PBTracer`` file and a ``JSONTracer`` file; the PBTracer file's
        feed from the native tensorizer (``trace.native.tensorize_file``
        and ``replay.tensorize_trace_file``) equal array for array to the
        Python tensorizer of the same file and of the events in memory, the
        JSON file equal to the events; the file's feed replayed on the card
        equal in every field to 7d's replay of the events. Native and
        Python tensorize MB/s (host clock, the best of 3 each)."""
        import tempfile

        import numpy as np
        from go_libp2p_pubsub_tpu_torch.pb.codec import read_trace_file
        from go_libp2p_pubsub_tpu_torch.trace import (JSONTracer, PBTracer,
                                                      native,
                                                      tensorize_trace,
                                                      tensorize_trace_file)
        cfg, tp, topo, events, want = self.trace
        pre, index = _trace_preamble()
        kw = dict(msg_window=cfg.msg_window, t_end=float(TRACE_TICKS))
        if not native.available():
            raise AssertionError("phase 10b: the native codec did not build")

        def best(fn):
            out, secs = None, []
            for _ in range(3):
                t0 = time.perf_counter()
                out = fn()
                secs.append(time.perf_counter() - t0)
            return out, min(secs)
        with tempfile.TemporaryDirectory() as d:
            pb_path = os.path.join(d, "trace.pb")
            js_path = os.path.join(d, "trace.json")
            t0 = time.perf_counter()
            pb, js = PBTracer(pb_path), JSONTracer(js_path)
            for e in pre + events:
                pb.trace(e)
                js.trace(e)
            pb.close()
            js.close()
            write_s = time.perf_counter() - t0
            size = os.path.getsize(pb_path)
            feed, native_s = best(lambda: native.tensorize_file(
                pb_path, index, {"t0": 0}, **kw))
            feed_py, python_s = best(lambda: tensorize_trace(
                read_trace_file(pb_path), index, {"t0": 0}, **kw))
            entry = tensorize_trace_file(pb_path, index, {"t0": 0}, **kw)
            with open(js_path) as f:
                js_events = [json.loads(x) for x in f]
        if js_events != json.loads(json.dumps(pre + events)):
            raise AssertionError("phase 10b: the JSONTracer file differs "
                                 "from the events")
        mem = tensorize_trace(pre + events, index, {"t0": 0}, **kw)
        for label, other in (("python, file", feed_py), ("in memory", mem),
                             ("tensorize_trace_file", entry)):
            bad = [f for f in ("op", "a", "b", "c")
                   if not np.array_equal(getattr(feed, f),
                                         getattr(other, f))]
            if bad or feed.mid_slot != other.mid_slot:
                raise AssertionError(f"phase 10b: the native feed differs "
                                     f"from the {label} one in "
                                     f"{bad or 'mid_slot'}")
        rep, n_ops, secs = _replay_trace(cfg, tp, topo, None, self.dev,
                                         feed=entry)
        bad = self.differ(want, rep)
        if bad:
            raise AssertionError(f"phase 10b: the file's replay differs from "
                                 f"7d's in {bad}")
        mb = size / 1e6
        print(f"phase 10b [trace files]: {len(pre) + len(events)} events "
              f"written to a PBTracer file ({size} bytes) and a JSONTracer "
              f"file in {write_s:.3f} s; tensorize of the file: native "
              f"{native_s * 1e3:.3f} ms = {mb / native_s:.1f} MB/s, Python "
              f"(read_trace_file + tensorize_trace) {python_s * 1e3:.3f} ms "
              f"= {mb / python_s:.2f} MB/s ({python_s / native_s:.1f}x; host "
              f"clock, best of 3); {len(feed.op)} ops equal array for array "
              f"to the Python and in-memory feeds; the JSON file equals the "
              f"events; the file's replay ({n_ops} ops, {secs:.3f} s on the "
              f"card) equals 7d's replay in every field", flush=True)

    def phase_native_encoder(self, topo):
        """10c: 8 ticks of the headline on the telemetry lane streamed
        through ``HealthJournal``: the chunk's encoder ``"native"``, its
        rows read back equal to the Python encoder's rows of the same
        records; then us per row of both encoders on the chunk's matrix
        tiled to ENCODE_ROWS rows (host clock, the best of 3 each)."""
        import tempfile

        import numpy as np
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.sim import (build_headline, run_keys,
                                                    telemetry)
        cfg, tp, st = build_headline(self.n, device=self.dev, topo=topo)
        keys = rng.split(rng.PRNGKey(0, device=self.dev), 8)
        _, rec = run_keys(st, cfg, tp, keys, telemetry=True, device=self.dev)
        self.sync()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "health.jsonl")
            with telemetry.HealthJournal(path) as j:
                j.header(cfg, scenario="headline")
                n_rows = j.append_records(rec, lo=0, hi=8)
                encoder = j.encoder
            got = telemetry.read_journal(path)
        mat, cols = telemetry.records_to_rows(rec)
        want = [json.loads(x) for x in
                telemetry.encode_rows_py(mat, cols).splitlines()]
        if encoder != "native" or [c["encoder"] for c in got["chunks"]] \
                != ["native"] or got["rows"] != want:
            raise AssertionError(f"phase 10c: encoder {encoder}, rows equal "
                                 f"{got['rows'] == want}")
        big = np.tile(mat, (ENCODE_ROWS // mat.shape[0], 1))

        def best(prefer_native):
            secs = []
            for _ in range(3):
                t0 = time.perf_counter()
                payload, how = telemetry.encode_rows(big, cols, prefer_native)
                secs.append(time.perf_counter() - t0)
            return payload, how, min(secs)
        fast, how, native_s = best(True)
        slow, _, python_s = best(False)
        if how != "native" or [json.loads(x) for x in fast.splitlines()] != \
                [json.loads(x) for x in slow.splitlines()]:
            raise AssertionError("phase 10c: the tiled rows do not parse "
                                 "equal")
        print(f"phase 10c [native encoder]: headline {cfg.n_peers} peers, "
              f"{n_rows} rows of {len(cols)} columns through HealthJournal, "
              f"encoder 'native', read back equal to the Python encoder's "
              f"rows; {big.shape[0]} rows: native "
              f"{native_s / big.shape[0] * 1e6:.3f} us a row, Python "
              f"{python_s / big.shape[0] * 1e6:.3f} us a row "
              f"({python_s / native_s:.1f}x; host clock, best of 3)",
              flush=True)

    def phase_calibrate(self, topologies):
        """10d: ``calibrate_dispatch.calibrate`` at CALIBRATE_SHAPES on the
        underlays already built, CALIBRATE_REPEATS repeats, every kernel
        formulation raising its kernel's launch count (the calibrator
        fails otherwise) and no formulation failing; the table written to
        a temporary path and loaded through GRAFT_DISPATCH_TABLE, where
        ``dispatch.explain`` returns the measured ms; each op's winner at
        each shape printed beside the shipped table's choice."""
        import tempfile
        from go_libp2p_pubsub_tpu_torch import calibrate_dispatch
        from go_libp2p_pubsub_tpu_torch.ops import cudalib, dispatch
        shipped = {}
        with tempfile.TemporaryDirectory() as d:
            out = os.path.join(d, "dispatch_table.json")
            lines = []
            cudalib.reset_launches()
            t0 = time.perf_counter()
            table = calibrate_dispatch.calibrate(
                CALIBRATE_SHAPES, out, repeats=CALIBRATE_REPEATS,
                device=self.dev, topologies=topologies, emit=lines.append)
            secs = time.perf_counter() - t0
            launches = dict(cudalib.LAUNCHES)
            recs = [json.loads(x) for x in lines]
            recs = [r for r in recs if "op" in r]
            failed = [(r["op"], r["form"], r["error"]) for r in recs
                      if "error" in r]
            if failed:
                raise AssertionError(f"phase 10d: formulations failed on "
                                     f"the card: {failed}")
            entry = table["platforms"][self.dev.type]
            buckets = {}
            for r in recs:
                buckets.setdefault((r["op"], json.dumps(
                    r["shape"], sort_keys=True)), {})[r["form"]] = r["ms"]
            for (op, shape), ms in buckets.items():
                shipped[(op, shape)] = dispatch.choose(op, **json.loads(
                    shape))[0]
            old = os.environ.get("GRAFT_DISPATCH_TABLE")
            os.environ["GRAFT_DISPATCH_TABLE"] = out
            dispatch.clear_table_cache()
            try:
                for (op, shape), ms in buckets.items():
                    costs = dispatch.explain(op, backend=self.dev.type,
                                             **json.loads(shape))
                    quarantined = set(entry["quarantined"].get(op, ()))
                    if set(costs) != set(ms) - quarantined or any(
                            costs[f] != ms[f] for f in costs):
                        raise AssertionError(
                            f"phase 10d: explain({op}, {shape}) gives "
                            f"{costs}, measured {ms}, quarantined "
                            f"{sorted(quarantined)}")
            finally:
                if old is None:
                    os.environ.pop("GRAFT_DISPATCH_TABLE")
                else:
                    os.environ["GRAFT_DISPATCH_TABLE"] = old
                dispatch.clear_table_cache()
        print(f"phase 10d [dispatch calibration]: {len(recs)} measurements "
              f"at {[list(s) for s in CALIBRATE_SHAPES]}, "
              f"{CALIBRATE_REPEATS} repeats each (device ms by CUDA events "
              f"behind a spin kernel, the median), in {secs:.1f} s; "
              f"fingerprint {json.dumps(entry['fingerprint'])}; launches "
              f"{json.dumps(launches)}; explain under "
              f"GRAFT_DISPATCH_TABLE returns the measured ms; quarantined "
              f"(>= 3x the best at every shape) "
              f"{json.dumps(entry['quarantined'], sort_keys=True)}",
              flush=True)
        for (op, shape), ms in sorted(buckets.items()):
            win = min(ms, key=ms.get)
            print(f"phase 10d winner {op} {shape}: {win} {ms[win]} ms; the "
                  f"shipped table's choice {shipped[(op, shape)]} "
                  f"{ms.get(shipped[(op, shape)])} ms; all "
                  f"{json.dumps(ms)}", flush=True)

    # ---- phase 11: the functional runtime and its bridges -----------------
    def phase_live_trace(self):
        """11a: the port's live routers (128 hosts, scoring) traced through
        a ``PBTracer`` file, the file tensorized by the native codec and
        replayed on the card into a fresh state over ``from_hosts``: every
        node's mesh exact, the P2/P3/P3b/P4 counters within 1e-3 of the
        routers', and the card's state equal to the CPU replay of the same
        feed."""
        import importlib
        import tempfile

        import numpy as np
        from go_libp2p_pubsub_tpu_torch.sim import (SimConfig, init_state,
                                                    state_to_numpy, topology)
        from go_libp2p_pubsub_tpu_torch.trace import PBTracer, native
        rp = importlib.import_module("go_libp2p_pubsub_tpu_torch.trace.replay")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "live.pb")
            pb = _CountingTracer(PBTracer(path))
            t0 = time.perf_counter()
            nodes, hosts = _live_swarm(pb)
            pb.inner.close()
            swarm_s = time.perf_counter() - t0
            n_bytes = os.path.getsize(path)
            topo, peer_index = topology.from_hosts(hosts, K_LIVE)
            if int(topo.degree.max()) >= K_LIVE:
                raise AssertionError("phase 11a: from_hosts truncated the "
                                     "live swarm's edges")
            kw = dict(msg_window=LIVE_WINDOW, decay_interval=1.0,
                      dup_window=[LIVE_DUP_WINDOW], t_end=LIVE_T_END)
            t0 = time.perf_counter()
            feed = native.tensorize_file(path, peer_index, {LIVE_TOPIC: 0},
                                         **kw)
            tens_s = time.perf_counter() - t0
        cfg = SimConfig(n_peers=N_LIVE, k_slots=K_LIVE, n_topics=1,
                        msg_window=LIVE_WINDOW, scoring_enabled=True)
        outs = {}
        for dev in (self.dev, "cpu"):
            tp = rp.replay_topic_params([_live_tsp()], device=dev)
            st = init_state(cfg, topo, subscribed=np.zeros((N_LIVE, 1), bool),
                            device=dev)
            self.sync()
            t0 = time.perf_counter()
            out = rp.replay_feed(st, cfg, tp, feed)
            if str(dev) != "cpu":
                self.sync()
            outs[str(dev)] = (out, time.perf_counter() - t0)
        card, replay_s = outs[str(self.dev)]
        _same_fingerprint("phase 11a [card replay against the CPU's]",
                          _fingerprint(state_to_numpy(card)),
                          _fingerprint(state_to_numpy(outs["cpu"][0])))
        got = state_to_numpy(card)
        mesh = got["mesh"]
        for i, x in enumerate(nodes):
            want = {peer_index[p] for p in x.rt.mesh.get(LIVE_TOPIC, set())}
            have = {int(topo.neighbors[i, k]) for k in range(K_LIVE)
                    if mesh[i, 0, k]}
            if have != want:
                raise AssertionError(f"phase 11a: node {i} replayed mesh "
                                     f"{sorted(have)} against the router's "
                                     f"{sorted(want)}")
        slot_of = [{int(j): k for k, j in enumerate(topo.neighbors[i])
                    if j >= 0} for i in range(N_LIVE)]
        fields = ("first_message_deliveries", "mesh_message_deliveries",
                  "mesh_failure_penalty", "invalid_message_deliveries")
        worst = dict.fromkeys(fields, 0.0)
        checked = 0
        for i, x in enumerate(nodes):
            for pid, pstats in x.rt.score.peer_stats.items():
                ts = pstats.topics.get(LIVE_TOPIC)
                if ts is None:
                    continue
                k = slot_of[i][peer_index[pid]]
                for f in fields:
                    err = abs(float(got[f][i, 0, k]) - getattr(ts, f))
                    worst[f] = max(worst[f], err)
                    if err > 1e-3:
                        raise AssertionError(
                            f"phase 11a: {f} at observer {i} slot {k}: "
                            f"{got[f][i, 0, k]} against the router's "
                            f"{getattr(ts, f)}")
                checked += 1
        if checked <= N_LIVE or len(feed.mid_slot) != LIVE_PUBS:
            raise AssertionError(f"phase 11a: {checked} counters checked, "
                                 f"{len(feed.mid_slot)} messages")
        n_ops = len(feed.op)
        print(f"phase 11a [live routers -> trace file -> replay]: "
              f"{N_LIVE} hosts, dense_connect degree {LIVE_DEGREE}, "
              f"{LIVE_PUBS} publishes, T_END {LIVE_T_END} s; swarm "
              f"{swarm_s:.3f} s wall; {pb.n} events, PBTracer file "
              f"{n_bytes} bytes; "
              f"native tensorize {tens_s:.4f} s = "
              f"{n_bytes / tens_s / 1e6:.1f} MB/s; {n_ops} ops replayed on "
              f"the card in {replay_s:.3f} s = {n_ops / replay_s:.1f} ops/s "
              f"(CPU {outs['cpu'][1]:.3f} s); mesh exact on every node, "
              f"{checked} (observer, peer) counters, worst |diff| "
              f"{json.dumps(worst)}; the card equals the CPU replay; "
              f"{self.smi_line()}", flush=True)

    def phase_cross_half(self, cpu):
        """11b: the functional half (a child process, the port's runtime
        at 512 hosts) against the batched half on the card over the same
        underlay: the statistical-parity bands, kernels 1-4 launched, and
        the card's state equal to the CPU run after every tick."""
        import numpy as np
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.ops import cudalib
        from go_libp2p_pubsub_tpu_torch.sim import (delivery_fraction,
                                                    mesh_degrees,
                                                    delivery_latency_ticks,
                                                    run, state_to_numpy, step)
        from go_libp2p_pubsub_tpu_torch.sim.topology import Topology
        topo = Topology(*cpu["topo"])
        cfg, tp, st0 = parity_case(topo, self.dev)
        key = rng.PRNGKey(0, device=self.dev)
        self.sync()
        cudalib.reset_launches()
        t0 = time.perf_counter()
        out = run(st0, cfg, tp, key, PARITY_TICKS, device=self.dev)
        self.sync()
        secs = time.perf_counter() - t0
        launches = dict(cudalib.LAUNCHES)
        print(f"phase 11b launches: {json.dumps(launches)}", flush=True)
        self.check_launches("cross-half", launches, cfg)
        keys = rng.split(key, PARITY_TICKS)
        st = st0
        for i in range(PARITY_TICKS):
            st = step(st, cfg, tp, keys[i], device=self.dev)
            _same_fingerprint(f"phase 11b tick {i}",
                              _fingerprint(state_to_numpy(st)),
                              cpu["ticks"][i])
        _same_fingerprint("phase 11b [run against the stepped ticks]",
                          _fingerprint(state_to_numpy(out)),
                          cpu["ticks"][-1])
        deg_b = mesh_degrees(out).cpu().numpy()
        if deg_b.ndim == 2:
            deg_b = deg_b[:, 0]
        deg_f = np.asarray(cpu["degrees"])
        ks = parity_bands(deg_f, deg_b, cpu["frac"], cpu["latencies"])
        frac_b = float(delivery_fraction(out, cfg))
        lat_b = float(delivery_latency_ticks(out, cfg))
        print(f"phase 11b [cross-half]: {N_PARITY} hosts, degree "
              f"{PARITY_DEGREE}, K {K_PARITY}; functional half "
              f"{cpu['secs']:.3f} s in its child process, delivery "
              f"{cpu['frac']:.6f}, mean latency "
              f"{float(np.mean(cpu['latencies'])):.4f} s, mean mesh degree "
              f"{deg_f.mean():.4f}; batched half {PARITY_TICKS} ticks on "
              f"the card in {secs:.3f} s = {PARITY_TICKS / secs:.2f} hb/s, "
              f"delivery {frac_b:.6f}, latency {lat_b:.4f} ticks, mean "
              f"mesh degree {deg_b.mean():.4f}; KS {ks:.4f}; the bands "
              f"hold; equal to the CPU run after every tick; "
              f"{self.smi_line()}", flush=True)

    def phase_injector(self):
        """11c: one fault plan (a partition into 2 on ticks [2, 6), an
        outage on [8, 11)) installed by the port's ``HostFaultInjector``
        on a 128-host swarm and run by the batched engine on the card over
        that swarm's ``from_hosts`` underlay: at a tick inside each window
        and one after the heal, the connections the injector has cut,
        mapped through ``peer_index``, are the slots the card run has
        down; ``fault_flags`` is exactly the plan's bits."""
        import numpy as np
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.api import LAX_NO_SIGN, PubSub
        from go_libp2p_pubsub_tpu_torch.net import Network
        from go_libp2p_pubsub_tpu_torch.ops import cudalib
        from go_libp2p_pubsub_tpu_torch.routers.gossipsub import (
            GossipSubRouter)
        from go_libp2p_pubsub_tpu_torch.sim import (SimConfig, init_state,
                                                    scenarios, step,
                                                    topology)
        from go_libp2p_pubsub_tpu_torch.sim.faults import (FaultPlan,
                                                           HostFaultInjector)
        from go_libp2p_pubsub_tpu_torch.sim.invariants import (
            FAULT_OUTAGE, FAULT_PARTITION)
        net = Network()
        nodes = [PubSub(net.add_host(), GossipSubRouter(),
                        sign_policy=LAX_NO_SIGN) for _ in range(N_INJECT)]
        hosts = [p.host for p in nodes]
        net.dense_connect(hosts, degree=INJECT_DEGREE)
        for p in nodes:
            p.join(LIVE_TOPIC).subscribe()
        topo, peer_index = topology.from_hosts(hosts, K_INJECT)
        plan = FaultPlan.parse(INJECT_PLAN)
        inj = HostFaultInjector(net, hosts, plan)
        cfg = SimConfig(n_peers=N_INJECT, k_slots=K_INJECT, n_topics=1,
                        msg_window=64, publishers_per_tick=2,
                        fault_plan=plan, hop_mode="pallas",
                        edge_gather_mode="pallas")
        st = init_state(cfg, topo, subscribed=np.ones((N_INJECT, 1), bool),
                        device=self.dev)
        tp = scenarios.default_topic_params(1, device=self.dev)
        keys = rng.split(rng.PRNGKey(0, device=self.dev), INJECT_TICKS)
        nb = topo.neighbors
        slot = [{int(j): k for k, j in enumerate(nb[i]) if j >= 0}
                for i in range(N_INJECT)]
        self.sync()
        cudalib.reset_launches()
        counts = []
        for t in range(INJECT_TICKS):
            st = step(st, cfg, tp, keys[t], device=self.dev)
            net.scheduler.run_until(t + 0.5)
            if t not in INJECT_CHECKS:
                continue
            cut = np.zeros((N_INJECT, K_INJECT), bool)
            for a, b in inj._severed:
                i, j = peer_index[a.peer_id], peer_index[b.peer_id]
                cut[i, slot[i][j]] = cut[j, slot[j][i]] = True
            absent = np.array([[nb[i, k] >= 0 and hosts[nb[i, k]].peer_id
                                not in hosts[i].conns for k in range(K_INJECT)]
                               for i in range(N_INJECT)])
            down = ~st.connected.cpu().numpy() & (nb >= 0)
            if not (cut == absent).all() or not (cut == down).all():
                raise AssertionError(
                    f"phase 11c tick {t}: the injector cut {int(cut.sum())} "
                    f"slots ({int(absent.sum())} absent on the hosts), the "
                    f"card has {int(down.sum())} down, "
                    f"{int((cut != down).sum())} differ")
            counts.append((t, int(cut.sum())))
        self.sync()
        launches = dict(cudalib.LAUNCHES)
        flags = int(st.fault_flags) & 0xFFFFFFFF
        if flags != FAULT_PARTITION | FAULT_OUTAGE:
            raise AssertionError(f"phase 11c: fault_flags 0x{flags:08x}, "
                                 f"the plan's bits are 0x"
                                 f"{FAULT_PARTITION | FAULT_OUTAGE:08x}")
        if not counts[0][1] or not counts[1][1] or counts[2][1]:
            raise AssertionError(f"phase 11c: cut slots by tick {counts}")
        print(f"phase 11c launches: {json.dumps(launches)}", flush=True)
        self.check_launches("injector", launches, cfg)
        print(f"phase 11c [fault injector on both halves]: {N_INJECT} hosts, "
              f"plan {INJECT_PLAN!r}; (tick, cut slots) {counts}: the host "
              f"cuts through peer_index equal the card's down slots; "
              f"fault_flags 0x{flags:08x}; {self.smi_line()}", flush=True)

    # ---- phase 12: the RPC wire codec, the probe and the operator tools ---
    def phase_operator_tools(self, cpu):
        """12a-12d; the probe and its CPU-mesh child run on threads beside
        12b-12d, and are read last."""
        from concurrent.futures import ThreadPoolExecutor
        from go_libp2p_pubsub_tpu_torch.utils import platform_probe

        def probe():
            t0 = time.perf_counter()
            info = platform_probe.probe_default_platform_info()
            return info, time.perf_counter() - t0

        def cpu_mesh_child():
            code = ("import sys; sys.path.insert(0, %r); import torch\n"
                    "from go_libp2p_pubsub_tpu_torch.utils.platform_probe "
                    "import forced_cpu_device_count\n"
                    "print(torch.cuda.is_available(), torch.cuda."
                    "device_count(), forced_cpu_device_count())\n") % REPO
            res = subprocess.run(
                [sys.executable, "-c", code], capture_output=True, text=True,
                timeout=300, env=platform_probe.cpu_mesh_env(os.environ, 2))
            return res.returncode, res.stdout.split(), res.stderr[-800:]

        with ThreadPoolExecutor(max_workers=2) as ex:
            fut_probe = ex.submit(probe)
            fut_mesh = ex.submit(cpu_mesh_child)
            t0 = time.perf_counter()
            self.phase_rpc_codec(cpu)
            print(f"phase 12b: {time.perf_counter() - t0:.1f} s", flush=True)
            t0 = time.perf_counter()
            self.phase_supervisor_drill(cpu)
            print(f"phase 12c: {time.perf_counter() - t0:.1f} s", flush=True)
            t0 = time.perf_counter()
            self.phase_tools_without_jax()
            print(f"phase 12d: {time.perf_counter() - t0:.1f} s", flush=True)
            (alive, n, platform), probe_s = fut_probe.result()
            rc, mesh, err = fut_mesh.result()
        if (alive, n, platform) != (True, 1, "gpu"):
            raise AssertionError(f"phase 12a: the probe gave "
                                 f"{(alive, n, platform)}")
        if rc != 0 or mesh != ["False", "0", "2"]:
            raise AssertionError(f"phase 12a: the cpu_mesh_env child saw "
                                 f"{mesh} (rc {rc}): {err}")
        print(f"phase 12a [platform probe]: probe_default_platform_info() = "
              f"{(alive, n, platform)} in {probe_s:.3f} s (a child process: "
              f"import torch, one op on cuda checked on the host), on "
              f"{self.smi_line()}; a child under cpu_mesh_env(env, 2) saw "
              f"cuda available {mesh[0]}, {mesh[1]} devices, "
              f"forced_cpu_device_count() {mesh[2]}", flush=True)

    def phase_rpc_codec(self, cpu):
        """12b: the native RPC scanner built by g++ on the card's host, its
        scan of the child's seeded stream equal to ``scan_bytes_python``
        array for array, both refusing a truncated tail and an oversize
        frame; the child's ``read_frames`` re-framed to the same bytes."""
        import numpy as np
        from go_libp2p_pubsub_tpu_torch.pb import codec, native_rpc
        t0 = time.perf_counter()
        built = native_rpc.available()
        build_s = time.perf_counter() - t0
        lib = native_rpc.lib_path()
        if not built or os.path.dirname(lib) != os.path.join(
                REPO, "go_libp2p_pubsub_tpu_torch", "_build"):
            raise AssertionError(f"phase 12b: csrc/rpc_codec.cpp did not "
                                 f"build into _build/ ({lib})")
        with open(cpu["stream"], "rb") as f:
            data = f.read()
        native_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = native_rpc.scan_bytes(data)
            native_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        want = native_rpc.scan_bytes_python(data)
        plain_s = time.perf_counter() - t0
        for name, g, w in zip(("stats", "msgs"), got, want):
            if g.dtype != np.int64 or not np.array_equal(g, w):
                raise AssertionError(f"phase 12b: native {name} differs "
                                     f"from scan_bytes_python")
        if got[2] != want[2]:
            raise AssertionError("phase 12b: native topics differ")
        stats, msgs, topics = got
        seqnos = msgs[:, 3]
        if stats.shape[0] != cpu["frames"] or (stats.sum(axis=0) == 0).any() \
                or not (msgs[:, 1] == -1).any() or not (seqnos < 0).any() \
                or seqnos.min() != -(1 << 63) or not cpu["reframed"]:
            raise AssertionError(
                f"phase 12b: the stream lacks a frame kind or did not "
                f"round-trip: frames {stats.shape[0]}/{cpu['frames']}, "
                f"column sums {stats.sum(axis=0).tolist()}, re-framed "
                f"{cpu['reframed']}")
        # the refusals, on a prefix of whole frames
        pos = 0
        sizes = []
        for _ in range(RPC_PREFIX_FRAMES):
            ln, body = codec.read_uvarint(data, pos)
            pos = body + ln
            sizes.append(ln)
        prefix = data[:pos]
        refused = []
        for label, bad, max_frame in (("truncated tail", prefix[:-3], 0),
                                      ("oversize", prefix, max(sizes) - 1)):
            for scan in (native_rpc.scan_bytes, native_rpc.scan_bytes_python):
                try:
                    scan(bad, max_frame)
                except ValueError:
                    continue
                raise AssertionError(f"phase 12b: {scan.__name__} took a "
                                     f"{label} stream")
            refused.append(label)
        mb = len(data) / 1e6
        print(f"phase 12b [RPC codec]: g++ built {os.path.basename(lib)} in "
              f"{build_s:.2f} s; a {len(data)}-byte seeded stream "
              f"({stats.shape[0]} frames, {msgs.shape[0]} publishes, "
              f"{len(topics)} topics, {int((seqnos < 0).sum())} seqnos "
              f"over 2^63 - 1 stored wrapped) made in {cpu['gen_s']:.2f} s "
              f"by the child; native scan {min(native_s):.4f} s = "
              f"{mb / min(native_s):.1f} MB/s, scan_bytes_python "
              f"{plain_s:.3f} s = {mb / plain_s:.2f} MB/s (host CPU), "
              f"arrays equal; read_frames re-framed byte-equal "
              f"({cpu['roundtrip_s']:.2f} s in the child); refused by both "
              f"scans: {refused}", flush=True)

    def phase_supervisor_drill(self, cpu):
        """12c: ``supervisor_smoke.run_smoke(device="cuda")``, every stage
        passing, the chunk rung on the card, the kernels counted, and the
        final states equal to the child's CPU drill field by field."""
        from go_libp2p_pubsub_tpu_torch import supervisor_smoke
        from go_libp2p_pubsub_tpu_torch.ops import cudalib
        from go_libp2p_pubsub_tpu_torch.parallel import compile_plan
        from go_libp2p_pubsub_tpu_torch.sim import state_to_numpy
        lines, finals = [], {}
        compile_plan.clear_caches()
        cudalib.reset_launches()
        self.sync()
        t0 = time.perf_counter()
        rc = supervisor_smoke.run_smoke(os.path.join(self.work, "smoke"),
                                        emit=lines.append, device=self.dev,
                                        finals=finals)
        self.sync()
        secs = time.perf_counter() - t0
        launches = dict(cudalib.LAUNCHES)
        print(f"phase 12c [supervisor drill] launches: "
              f"{json.dumps(launches)}", flush=True)
        stages = [json.loads(ln) for ln in lines]
        for st in stages:
            print(f"phase 12c stage: {json.dumps(st)}", flush=True)
        names = [st["stage"] for st in stages]
        if rc != 0 or cpu["smoke_rc"] != 0 or names != [
                json.loads(ln)["stage"] for ln in cpu["smoke_lines"]] or \
                len(names) != 4:
            raise AssertionError(f"phase 12c: the drill failed on the card "
                                 f"(rc {rc}: {names}) or on the CPU (rc "
                                 f"{cpu['smoke_rc']})")
        first = stages[0]
        if (first["device"], first["rung"]) != ("cuda", "chunk"):
            raise AssertionError(f"phase 12c: the card's degraded rung: "
                                 f"{first}")
        must, must_not = SMOKE_KERNELS
        zero = sorted(k for k in must if launches[k] == 0)
        stray = sorted(k for k in must_not if launches[k] != 0)
        if zero or stray:
            raise AssertionError(f"phase 12c: kernels never launched "
                                 f"{zero}, launched outside the path "
                                 f"{stray}")
        if sorted(finals) != sorted(cpu["finals"]):
            raise AssertionError(f"phase 12c: final states {sorted(finals)}"
                                 f" against {sorted(cpu['finals'])}")
        for name, st in finals.items():
            _same_fingerprint(f"phase 12c {name}",
                              _fingerprint(state_to_numpy(st)),
                              cpu["finals"][name])
        compile_plan.clear_caches()
        print(f"phase 12c [supervisor drill]: every stage ok on the card in "
              f"{secs:.2f} s (deadline {first['deadline_s']} s from the "
              f"plain run; the {first['rung']} rung: {first['degrades']}; "
              f"retries {first['retries']}); final states of "
              f"{sorted(finals)} equal to the CPU drill's field by field",
              flush=True)

    def phase_tools_without_jax(self):
        """12d: in a child where neither JAX nor the JAX package can be
        imported, the dashboard renders phase 7c's journal (flags by name,
        the contract verdicts 7c read), the producer copies 7c's stream
        line for line and writes the eclipse_censor scenario as
        ``write_stream`` does here."""
        from go_libp2p_pubsub_tpu_torch import directive_producer
        from go_libp2p_pubsub_tpu_torch.sim import commands, invariants
        p7 = self.phase7c
        if p7 is None:
            raise AssertionError("phase 12d: phase 7c left no journal")
        copy = os.path.join(self.work, "copy.ndjson")
        scen = os.path.join(self.work, "scenario.ndjson")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-c", JAX_FREE_TOOLS, REPO, p7["journal"],
             p7["stream"], copy, scen], capture_output=True, text=True,
            timeout=300)
        secs = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"phase 12d: the child failed: "
                                 f"{res.stderr[-1500:]}")
        out = json.loads(res.stdout.strip().splitlines()[-1])
        snap = out["snapshot"]
        names = snap.get("fault_flag_names") or []
        want_names = invariants.decode_flags(int(p7["fault_flags"]))
        contracts = [{k: c.get(k) for k in ("kind", "status", "detail",
                                            "tick")}
                     for c in snap.get("contracts", [])]
        if out["rc"] != [0, 0, 0] or out["leaked"]:
            raise AssertionError(f"phase 12d: exit codes {out['rc']}, "
                                 f"imported {out['leaked']}")
        if not p7["fault_flags"] or names != want_names or any(
                n.startswith("0x") for n in names):
            raise AssertionError(f"phase 12d: flags {p7['fault_flags']} "
                                 f"rendered as {names}")
        if contracts != p7["contracts"] or any(
                c.get("source") != "journal"
                for c in snap.get("contracts", [])):
            raise AssertionError(f"phase 12d: verdicts {contracts} against "
                                 f"7c's {p7['contracts']}")
        with open(p7["stream"]) as a, open(copy) as b:
            src_lines, copy_lines = a.readlines(), b.readlines()
        want_scen = os.path.join(self.work, "scenario_want.ndjson")
        commands.write_stream(
            want_scen, directive_producer.scenario_directives(
                "eclipse_censor", at=4, region=8, attackers=8, bursts=3))
        with open(scen) as a, open(want_scen) as b:
            scen_lines, want_lines = a.readlines(), b.readlines()
        if copy_lines != src_lines or scen_lines != want_lines:
            raise AssertionError("phase 12d: the producer's copy or "
                                 "scenario stream differs")
        kinds = [(c["kind"], c["status"]) for c in contracts]
        print(f"phase 12d [tools without JAX]: python -m "
              f"go_libp2p_pubsub_tpu_torch.dashboard on 7c's journal --once "
              f"--json: tick {snap.get('tick')}, flags {snap['fault_flags']}"
              f" = {names}, verdicts {kinds} as 7c read them; "
              f"directive_producer --stream copied "
              f"{len(copy_lines)} lines, --scenario eclipse_censor wrote "
              f"{len(scen_lines)} lines equal to write_stream's; the child "
              f"imported nothing of JAX; {secs:.2f} s", flush=True)

    def kernels_line(self):
        rows = []
        for name, cases in self.results.items():
            # the main path's case is the first (T=1, its own B / budget;
            # the churn path's N=51200 for the gathers)
            main = cases[0]
            by_path = {p: c[name] for p, c in self.path_launches.items()
                       if c[name]}
            rows.append(dict(
                name=name, route="cuda",
                source=f"go_libp2p_pubsub_tpu_torch/csrc/{name}.cu",
                replaces=REPLACES[name],
                launches=sum(by_path.values()),
                launches_by_path=by_path,
                max_abs_err=max(c["max_abs_err"] for c in cases),
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"],
                cases=[{kk: c[kk] for kk in ("case", "ms", "plain_ms",
                                             "library_ms", "bound_ms",
                                             "bound_by")}
                       for c in cases]))
        return json.dumps({"kernels": rows})


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import go_libp2p_pubsub_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})",
              file=sys.stderr)
        return 1
    smoke = Smoke()

    # the five underlays build in child processes while the kernels are
    # built and checked
    ctx = mp.get_context("spawn")
    topo_jobs = {}
    for shape in ((smoke.n, K, 12), (N_CHURN, K, 12), (N_OUTAGE, K, 12),
                  (N_BEACON, K_BEACON, 16), (N_FRONTIER, K, 8)):
        parent, child = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=_build_topology, args=(child, *shape),
                           daemon=True)
        proc.start()
        child.close()
        topo_jobs[shape] = (parent, proc)
    # the power-law underlays of phase 8
    powerlaw_jobs = {}
    for n in (N_POWERLAW_1M, N_POWERLAW_100K):
        parent, child = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=_build_powerlaw, args=(child, n),
                           daemon=True)
        proc.start()
        child.close()
        powerlaw_jobs[n] = (parent, proc)
    # phase 8a's CPU runs
    cpu8_parent, child = ctx.Pipe(duplex=False)
    cpu8_proc = ctx.Process(target=_phase8_cpu, args=(child,), daemon=True)
    cpu8_proc.start()
    child.close()
    # phase 4's CPU trajectories, beside the builds
    cpu4_parent, child = ctx.Pipe(duplex=False)
    cpu4_proc = ctx.Process(target=_phase4_cpu, args=(child,), daemon=True)
    cpu4_proc.start()
    child.close()
    cpu4 = {}
    # phase 10a's CPU sweep, beside the builds
    cpu10_parent, child = ctx.Pipe(duplex=False)
    cpu10_proc = ctx.Process(target=_phase10_cpu, args=(child,), daemon=True)
    cpu10_proc.start()
    child.close()
    # phase 7's CPU runs of the port, beside the builds
    cpu7_parent, child = ctx.Pipe(duplex=False)
    cpu7_proc = ctx.Process(target=_phase7_cpu, args=(child,), daemon=True)
    cpu7_proc.start()
    child.close()
    cpu7 = {}
    # phase 11b's functional half and its CPU batched run, beside the builds
    cpu11_parent, child = ctx.Pipe(duplex=False)
    cpu11_proc = ctx.Process(target=_phase11_cpu, args=(child,), daemon=True)
    cpu11_proc.start()
    child.close()
    # phase 12's stream and CPU drill, beside the builds
    cpu12_parent, child = ctx.Pipe(duplex=False)
    cpu12_proc = ctx.Process(target=_phase12_cpu, args=(child, smoke.work),
                             daemon=True)
    cpu12_proc.start()
    child.close()

    def phase12_cpu():
        out = cpu12_parent.recv()
        cpu12_proc.join()
        return out

    def phase11_cpu():
        out = cpu11_parent.recv()
        cpu11_proc.join()
        return out

    def phase7_cpu():
        if not cpu7:
            cpu7.update(cpu7_parent.recv())
            cpu7_proc.join()
        return cpu7

    def phase8_cpu():
        out = cpu8_parent.recv()
        cpu8_proc.join()
        return out

    def phase4_cpu():
        if not cpu4:
            cpu4.update(cpu4_parent.recv())
            cpu4_proc.join()
        return cpu4

    def phase10_cpu():
        out = cpu10_parent.recv()
        cpu10_proc.join()
        return out

    powerlaw_topos = {}

    def powerlaw_of(n):
        if n not in powerlaw_topos:
            from go_libp2p_pubsub_tpu_torch.sim.topology import Topology
            parent, proc = powerlaw_jobs.pop(n)
            powerlaw_topos[n] = Topology(*parent.recv())
            proc.join()
        return powerlaw_topos[n]

    topos = {}

    def topology_of(n, k=K, degree=12):
        shape = (n, k, degree)
        if shape not in topos:
            from go_libp2p_pubsub_tpu_torch.sim.topology import Topology
            parent, proc = topo_jobs[shape]
            topos[shape] = Topology(*parent.recv())
            proc.join()
        return topos[shape]

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {label}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    try:
        t_start = time.perf_counter()
        print(smoke.smi_line(), flush=True)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)}", flush=True)
        from go_libp2p_pubsub_tpu_torch.ops import cudalib
        t0 = time.perf_counter()
        report = cudalib.build_all()
        print(f"build: {len(report)} CUDA libraries in "
              f"{time.perf_counter() - t0:.1f} s (one nvcc per source, "
              "in parallel)", flush=True)
        for name, r in sorted(report.items()):
            print(f"build {name}: {r['ptxas']}", flush=True)
        timed("2 (fused kernels)", smoke.phase_kernels)
        timed("2 (gather kernels)", smoke.phase_gather_kernels)
        timed("2 (select_rows)", smoke.phase_select_kernels)
        print(LIBRARY_NOTE, flush=True)
        # the 1024-peer fleet phases run while the underlays build
        timed("6b (fleet_256x1k)", smoke.phase_fleet)
        timed("6c (supervised fleet)", smoke.phase_supervised_fleet)
        timed("10a (score sweep, killed and resumed)", smoke.phase_sweep)
        # phases that need no big underlay, while the underlays build
        timed("3c (wide window)", smoke.phase_wide)
        timed("9c (multi-process resilience)", smoke.phase_mh_resilience)
        timed("3 (main path)", lambda: smoke.phase_main(
            topology_of(smoke.n)))
        timed("3b (churn path)", lambda: smoke.phase_churn(
            topology_of(N_CHURN)))
        timed("3d (data plane)", lambda: smoke.phase_dataplane(
            topology_of(smoke.n), topology_of(N_CHURN),
            topology_of(N_OUTAGE)))
        timed("3e (BASELINE configs)", lambda: smoke.phase_baseline(
            topology_of(smoke.n), topology_of(N_BEACON, K_BEACON, 16)))
        timed("3f (frontier_1m, sort path, formulations)",
              lambda: smoke.phase_frontier(topology_of(N_FRONTIER, K, 8),
                                           topology_of(smoke.n)))
        timed("3g (compact storage, telemetry, checkpoint)",
              lambda: smoke.phase_compact(topology_of(smoke.n),
                                          topology_of(N_FRONTIER, K, 8)))
        timed("5 (captured chunks)", smoke.phase_captured)
        timed("6a (supervised headline)", lambda: smoke.phase_supervised(
            topology_of(smoke.n)))
        timed("7a (attack families)",
              lambda: smoke.phase_families(phase7_cpu()))
        timed("7b (eclipse_50k, flashcrowd_50k)",
              lambda: smoke.phase_bench_families(topology_of(N_CHURN)))
        timed("7c (supervised eclipse with commands)",
              lambda: smoke.phase_supervised_eclipse(topology_of(N_CHURN)))
        timed("7d (trace loop)", lambda: smoke.phase_trace(phase7_cpu()))
        timed("10b (trace files)", smoke.phase_trace_files)
        timed("8a (bucketed trajectories)",
              lambda: smoke.phase_bucketed_trajectory(phase8_cpu()))
        timed("8b (powerlaw_1m)", lambda: smoke.phase_powerlaw_1m(
            powerlaw_of(N_POWERLAW_1M)))
        timed("8c (heavytail_eclipse)", lambda: smoke.phase_heavytail(
            powerlaw_of(N_POWERLAW_100K)))
        timed("9a/9b (two ranks on one card)", lambda: smoke.phase_multirank(
            topology_of(smoke.n), topology_of(N_CHURN)))
        timed("9d (row-sharded heavytail_eclipse)",
              lambda: smoke.phase_bucketed_ranks(
                  powerlaw_of(N_POWERLAW_100K)))
        timed("10a (score sweep against the CPU)",
              lambda: smoke.check_sweep(phase10_cpu()))
        timed("10c (native encoder)", lambda: smoke.phase_native_encoder(
            topology_of(smoke.n)))
        timed("10d (dispatch calibration)", lambda: smoke.phase_calibrate({
            (smoke.n, K): topology_of(smoke.n),
            (N_OUTAGE, K): topology_of(N_OUTAGE)}))
        timed("11a (live routers, trace file, replay)",
              smoke.phase_live_trace)
        timed("11b (cross-half parity)",
              lambda: smoke.phase_cross_half(phase11_cpu()))
        timed("11c (fault injector on both halves)", smoke.phase_injector)
        timed("4 (trajectory)", smoke.phase_trajectory, phase4_cpu())
        timed("4 (compact trajectory)", smoke.phase_compact_trajectory)
        for gather in ("pallas", "mxu"):
            timed(f"4b (churn trajectory, {gather})", smoke.phase_trajectory,
                  phase4_cpu(), "churn", gather)
        for case in DATAPLANE_CASES:
            timed(f"4c (data-plane trajectory, {case})",
                  smoke.phase_trajectory, phase4_cpu(), case)
        for case in BASELINE_CASES:
            timed(f"4d (BASELINE trajectory, {case})",
                  smoke.phase_trajectory, phase4_cpu(), case)
        timed("4d (fold_in schedule, run_window chunks)", smoke.phase_fold_in)
        timed("4d (run_checked)", smoke.phase_checked)
        for case in FORMULATION_CASES:
            timed(f"4e (formulation trajectory, {case})",
                  smoke.phase_trajectory, phase4_cpu(), case)
        timed("12 (RPC codec, probe, operator tools)",
              lambda: smoke.phase_operator_tools(phase12_cpu()))
        print(smoke.kernels_line(), flush=True)
        print(f"chip_smoke: all phases passed in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
    finally:
        for proc in [p for _, p in topo_jobs.values()] + [
                p for _, p in powerlaw_jobs.values()] + [
                    cpu4_proc, cpu7_proc, cpu8_proc, cpu10_proc,
                    cpu11_proc, cpu12_proc]:
            if proc.is_alive():
                proc.terminate()
                proc.join()
        shutil.rmtree(smoke.work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
