"""The chunk executables of the engine and fleet planes (port of
parallel/compile_plan.py: ``engine_chunk``, ``engine_window``,
``fleet_chunk`` and ``donated_param_count``, compile_plan.py:55-125 and
:326-337).

The reference AOT-compiles one chunk of its engine scan and caches the
executable, in a donated flavour (the carried state aliases in place) and
a plain one. On the card the counterpart of that executable is a CUDA
graph: C ticks of ``engine._step`` captured once over static state,
topic-parameter and key buffers, then replayed. A tick reads nothing on
the host (the heartbeat's blocks and the hop loops run ungated), so the
whole chunk is one graph:

- :func:`engine_chunk` replays C ticks under the ``[C, 2]`` key rows it is
  called with (``run_keys``): ``exe(state, tp, keys_chunk)``;
- :func:`engine_window` replays C ticks under the ``key_schedule=
  "fold_in"`` keys, ``fold_in(key, state.tick)`` folded on the device from
  the master key and the carried tick (``run_window``): ``exe(state, tp,
  key)``. Chained chunks draw fresh numbers because the tick advances.

With ``telemetry=True`` the graph also records the C ticks' health
records (sim/telemetry.py) and a call returns ``(state, HealthRecord)``,
the ``[C]``-stacked records copied out of the graph's static outputs.
A compact config (``state_precision="compact"``) captures as an f32 one:
the graph decodes at each tick's entry and encodes at its exit, and its
static buffers hold the stored layout.

Each is cached per (schedule, config, chunk length, key dtype, telemetry,
donation, device), as the reference's ``_ENGINE_AOT``: the same key gives
the same object, a tail chunk its own entry.

Donation. ``donate=True``: the executable consumes the caller's state;
the graph writes the final state back into its static input buffers and
returns them, so a chain of chunks fed each other's results copies
nothing in. ``donate=False``: the call copies the state in and returns
clones, and the caller's state stays valid. :func:`donated_param_count`
reports how many state tensors an executable consumes.

Building an executable on a CUDA state runs ``WARMUP_TICKS`` ticks
eagerly on a side stream (every kernel the config resolves to is built
and loaded there, before capture), empties the allocator's cache (the
graph's private pool then takes the eager run's place) and captures. On
a CPU state the executable runs the same ticks eagerly through the same
interface. There is no fallback: a capture that fails raises, and a CUDA
executable never replays eagerly.

:func:`fleet_chunk` is the fleet plane's executable of one window: B
stacked members advance C ticks under ``[C, B, 2]`` key rows
(sim/fleet.py). On the card it owns one ``engine_chunk``-style graph of
one member's C ticks and replays it member after member, copying each
member's final state (and records) into its slice of the ``[B, ...]``
result: one graph per (config, C), whatever B, so compaction to fewer
members captures nothing new. On the CPU the same ticks run eagerly,
member after member. The executable captures at its first call, not at
lookup, so the fleet plane runs a first use under its compile deadline.

An executable's ``calls`` counts its calls. The result of a donated CUDA
``engine_chunk``/``engine_window`` executable is its static state, which
its next call overwrites: a
caller that keeps such a result stamps it with :meth:`stamp` and checks
:func:`live` before reusing it. :func:`retire` drops an executable from
the cache and marks every result it handed out stale (a retry after a
watchdog deadline, whose abandoned attempt may still load or replay
it, then captures afresh).

The sharded plans (:func:`sharded_step_plan`, :func:`sharded_chunk_plan`,
compile_plan.py:143-260, and :func:`bucketed_chunk_plan`, :262-314) run a
rank's rows of the step inside
:func:`~.kernel_context.kernel_mesh` over a :class:`~.sharding.PeerMesh`.
They run EAGERLY: the step's cross-rank reads are gloo or NCCL
collectives, which this build does not record into a CUDA graph, so a
sharded chunk launches its ticks one by one under the group. Capturing
the segments between collectives is later speed work. ``run``,
``run_keys``, ``run_window`` and ``sim.fleet.fleet_run_keys`` stay eager;
they are the yardstick the replays are held to.
"""

from __future__ import annotations

import time

import torch

from ..ops import cudalib, selection
from ..sim.config import SimConfig, TopicParams
from ..sim.engine import _folded, _plain, _rows, _ticks, check_slice
from ..sim.state import SimState
from ..sim.telemetry import HealthRecord

WARMUP_TICKS = 2

_ENGINE_PLANS: dict = {}
_FLEET_PLANS: dict = {}
_FLEET_SEEN: set = set()


class EngineExecutable:
    """C ticks of the engine as one callable: a replayed CUDA graph on the
    card, the eager ticks on the CPU. ``launches`` holds the kernel
    launches recorded into the graph (counted at capture time, once;
    every replay repeats them), empty on the CPU."""

    def __init__(self, schedule: str, cfg: SimConfig, state: SimState,
                 tp: TopicParams, keys: torch.Tensor, n_ticks: int,
                 telemetry: bool, donate: bool):
        self.schedule = schedule              # "engine" or "window"
        self.cfg = cfg
        self.n_ticks = n_ticks
        self.telemetry = telemetry
        self.donate = donate
        self.device = state.tick.device
        self.launches: dict = {}
        self.calls = 0
        self.graph = None
        self.capture_s = 0.0
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            self._capture(state, tp, keys)
            self.capture_s = time.perf_counter() - t0

    @property
    def donated(self) -> int:
        """State tensors the executable consumes: every field donated, or
        none."""
        return len(SimState._fields) if self.donate else 0

    def stamp(self):
        """What :func:`live` needs to tell whether this executable's last
        result still holds: ``(self, calls)`` when that result is the
        graph's static state (a donated CUDA executable), else None."""
        return (self, self.calls) if self.donate and self.graph is not None \
            else None

    def _key_of(self, keys: torch.Tensor):
        return _rows(keys) if self.schedule == "engine" else _folded(keys)

    def _ticks(self, state: SimState, tp: TopicParams, keys: torch.Tensor):
        return _ticks(state, self.cfg, tp, self.n_ticks, self._key_of(keys),
                      False, self.telemetry)

    def _check(self, state: SimState, keys: torch.Tensor) -> None:
        if state.tick.device != self.device:
            raise ValueError(f"the executable was built for {self.device}; "
                             f"the state lies on {state.tick.device}")
        want = (self.n_ticks, 2) if self.schedule == "engine" else (2,)
        if tuple(keys.shape) != want:
            raise ValueError(f"keys of shape {tuple(keys.shape)}; this "
                             f"executable takes {want}")

    def _capture(self, state: SimState, tp: TopicParams,
                 keys: torch.Tensor) -> None:
        dev = self.device
        self._state = SimState(*(x.clone() for x in state))
        self._tp = TopicParams(*(x.to(dev).clone() for x in tp))
        self._keys = keys.to(dev).clone()
        # warm-up: first use builds and loads every kernel of the path,
        # and the library handles PyTorch creates lazily, off the capture
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        key_of = self._key_of(self._keys)
        with torch.cuda.stream(side):
            warm = _ticks(SimState(*(x.clone() for x in self._state)),
                          self.cfg, self._tp, WARMUP_TICKS,
                          lambda i, st: key_of(i % self.n_ticks, st), False,
                          self.telemetry)
        torch.cuda.current_stream(dev).wait_stream(side)
        del warm
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        before = dict(cudalib.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self._ticks(self._state, self._tp, self._keys)
            if self.telemetry:
                out, self._records = out
            _check_no_partial_alias(out, self._state)
            if self.donate:
                # the final state lands in the static inputs; a field the
                # chunk left as it was is the input itself (copy_ skips it)
                for dst, src in zip(self._state, out):
                    dst.copy_(src)
        self.launches = {k: cudalib.LAUNCHES[k] - before[k]
                         for k in cudalib.LAUNCHES
                         if cudalib.LAUNCHES[k] != before[k]}
        self._out = self._state if self.donate else out
        self.graph = graph

    def _replay(self, state: SimState, tp: TopicParams,
                keys: torch.Tensor):
        """Load the inputs and replay: the graph's static state and records
        (None without telemetry), which the next call overwrites."""
        self._check(state, keys)
        self.calls += 1
        for dst, src in ((self._keys, keys), *zip(self._tp, tp),
                         *zip(self._state, state)):
            _load(dst, src)
        self.graph.replay()
        return self._out, (self._records if self.telemetry else None)

    def __call__(self, state: SimState, tp: TopicParams,
                 keys: torch.Tensor):
        """The chunk's final state, and with telemetry its records."""
        if self.graph is None:
            self._check(state, keys)
            self.calls += 1
            return self._ticks(state, tp, keys.to(self.device))
        out, records = self._replay(state, tp, keys)
        out = SimState(*(out if self.donate else (x.clone() for x in out)))
        if self.telemetry:
            return out, HealthRecord(*(x.clone() for x in records))
        return out


def _load(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy ``src`` into the static buffer ``dst`` (nothing when ``src`` is
    that buffer: a donated chunk's own result)."""
    if src is dst:
        return
    if src.shape != dst.shape or src.dtype != dst.dtype:
        raise ValueError(f"a {src.dtype} {tuple(src.shape)} input for the "
                         f"static {dst.dtype} {tuple(dst.shape)} buffer")
    dst.copy_(src)


def _check_no_partial_alias(out: SimState, static: SimState) -> None:
    """Each output field is its own static input or shares no memory with
    any static input, so writing the outputs back cannot read a field
    already overwritten."""
    spans = [(x.data_ptr(), x.data_ptr() + x.numel() * x.element_size())
             for x in static]
    for f, x, same in zip(SimState._fields, out, static):
        if x is same:
            continue
        lo, hi = x.data_ptr(), x.data_ptr() + x.numel() * x.element_size()
        if any(lo < b and a < hi for a, b in spans):
            raise RuntimeError(f"captured chunk: output field {f} overlaps "
                               "a static input buffer")


def _plan(schedule: str, exec_cfg: SimConfig, state: SimState,
          tp: TopicParams, keys: torch.Tensor, n_ticks: int,
          telemetry: bool, donate: bool) -> EngineExecutable:
    what = "engine_chunk" if schedule == "engine" else "engine_window"
    _plain(exec_cfg, what)
    if selection.CHECK_COUNT_BOUND:
        raise ValueError(
            f"{what} under ops.selection.CHECK_COUNT_BOUND: the debugging "
            "check reads every iterative selection's counts on the host, "
            "which a captured chunk cannot do; run the eager entry points "
            "with it")
    check_slice(exec_cfg)
    cache_key = (schedule, exec_cfg, int(n_ticks), str(keys.dtype),
                 telemetry, donate, str(state.tick.device))
    exe = _ENGINE_PLANS.get(cache_key)
    if exe is None:
        exe = EngineExecutable(schedule, exec_cfg, state, tp, keys,
                               int(n_ticks), telemetry, donate)
        _ENGINE_PLANS[cache_key] = exe
    return exe


def engine_chunk(exec_cfg: SimConfig, state: SimState, tp: TopicParams,
                 keys_chunk: torch.Tensor, *, telemetry: bool = False,
                 donate: bool = False) -> EngineExecutable:
    """The executable of one chunk of ``run_keys``: one tick per row of
    ``keys_chunk`` ([C, 2]). Call as ``exe(state, tp, keys_chunk)``;
    ``donate=True`` consumes ``state``; ``telemetry=True`` returns
    ``(state, HealthRecord)``."""
    return _plan("engine", exec_cfg, state, tp, keys_chunk,
                 keys_chunk.shape[0], telemetry, donate)


def engine_window(exec_cfg: SimConfig, state: SimState, tp: TopicParams,
                  key: torch.Tensor, n_ticks: int, *,
                  telemetry: bool = False,
                  donate: bool = False) -> EngineExecutable:
    """The executable of one chunk of ``run_window``: ``n_ticks`` ticks
    under ``fold_in(key, state.tick)``. Call as ``exe(state, tp, key)``."""
    return _plan("window", exec_cfg, state, tp, key, n_ticks, telemetry,
                 donate)


class FleetExecutable:
    """One fleet window: B stacked members advance C ticks, member i under
    the key rows ``keys[:, i]``, for any B. On the card, one graph of one
    member's C ticks (``member_exe``, an :class:`EngineExecutable` of its
    own, captured at the first call) replayed member after member, each
    member's final state and records copied into slice i of the result.
    On the CPU, the eager ticks member after member. ``launches`` holds
    one member's recorded kernel launches (every member's replay repeats
    them), ``capture_s`` the capture's seconds."""

    donated = 0                 # the fleet never donates (fleet.py)

    def __init__(self, cfg: SimConfig, n_ticks: int, telemetry: bool,
                 device: torch.device):
        self.cfg = cfg
        self.n_ticks = n_ticks
        self.telemetry = telemetry
        self.device = device
        self.calls = 0
        self.member_exe: EngineExecutable | None = None

    @property
    def launches(self) -> dict:
        return dict(self.member_exe.launches) if self.member_exe else {}

    @property
    def capture_s(self) -> float:
        return self.member_exe.capture_s if self.member_exe else 0.0

    def _check(self, states: SimState, keys: torch.Tensor) -> None:
        if states.tick.device != self.device:
            raise ValueError(f"the executable was built for {self.device}; "
                             f"the states lie on {states.tick.device}")
        want = (self.n_ticks, int(states.tick.shape[0]), 2)
        if tuple(keys.shape) != want:
            raise ValueError(f"keys of shape {tuple(keys.shape)} for "
                             f"{want[1]} members; this executable takes "
                             f"{want}")

    def _member(self, states: SimState, tps: TopicParams,
                keys: torch.Tensor, i: int):
        """Member ``i``'s ticks, eagerly, from a clone of its slice."""
        st = SimState(*(x[i].clone() for x in states))
        tp = TopicParams(*(x[i].clone() for x in tps))
        return _ticks(st, self.cfg, tp, self.n_ticks,
                      lambda t, s: keys[t, i], False, self.telemetry)

    def _eager(self, states: SimState, tps: TopicParams,
               keys: torch.Tensor):
        outs, recs = [], []
        for i in range(int(states.tick.shape[0])):
            out = self._member(states, tps, keys, i)
            if self.telemetry:
                out, rec = out
                recs.append(rec)
            outs.append(out)
        out = SimState(*(torch.stack(xs) for xs in zip(*outs)))
        if self.telemetry:
            return out, HealthRecord(*(torch.stack(xs, dim=1)
                                       for xs in zip(*recs)))
        return out

    def __call__(self, states: SimState, tps: TopicParams,
                 keys: torch.Tensor):
        """The members' final states (``[B, ...]``, new tensors), and with
        telemetry their ``[C, B]`` records."""
        self._check(states, keys)
        self.calls += 1
        keys = keys.to(self.device)
        tps = TopicParams(*(x.to(self.device) for x in tps))
        if self.device.type != "cuda":
            return self._eager(states, tps, keys)
        b = int(states.tick.shape[0])
        out = SimState(*(torch.empty_like(x) for x in states))
        records = None
        for i in range(b):
            st = SimState(*(x[i] for x in states))
            tp = TopicParams(*(x[i] for x in tps))
            if self.member_exe is None:
                self.member_exe = EngineExecutable(
                    "engine", self.cfg, st, tp, keys[:, i], self.n_ticks,
                    self.telemetry, False)
            res, rec = self.member_exe._replay(st, tp, keys[:, i])
            for dst, src in zip(out, res):
                dst[i].copy_(src)
            if rec is not None:
                if records is None:
                    records = HealthRecord(*(
                        torch.empty((self.n_ticks, b, *x.shape[1:]),
                                    dtype=x.dtype, device=self.device)
                        for x in rec))
                for dst, src in zip(records, rec):
                    dst[:, i].copy_(src)
        return (out, records) if self.telemetry else out


def fleet_chunk(exec_cfg: SimConfig, states: SimState, tps: TopicParams,
                keys: torch.Tensor, *, telemetry: bool = False,
                mark: bool = True):
    """The executable of one fleet window and whether this (config, C, key
    dtype, telemetry, device) is a first use (compile_plan.py:104-125,
    whose cache also keys on B; here one executable serves any B): call
    it as ``exe(states, tps, keys)`` on ``[B, ...]`` states and topic
    parameters and ``[C, B, 2]`` keys. A first use captures (the port's
    compile), so the fleet plane runs it under its compile deadline.
    ``mark=False`` only queries: the fleet plane marks a shape on
    confirmation, so a window that dies in its capture keeps the compile
    deadline on its retry."""
    _plain(exec_cfg, "fleet_chunk")
    if selection.CHECK_COUNT_BOUND:
        raise ValueError(
            "fleet_chunk under ops.selection.CHECK_COUNT_BOUND: the "
            "debugging check reads every iterative selection's counts on "
            "the host, which a captured window cannot do")
    check_slice(exec_cfg)
    cache_key = ("fleet", exec_cfg, int(keys.shape[0]), str(keys.dtype),
                 telemetry, str(states.tick.device))
    exe = _FLEET_PLANS.get(cache_key)
    if exe is None:
        exe = FleetExecutable(exec_cfg, int(keys.shape[0]), telemetry,
                              states.tick.device)
        _FLEET_PLANS[cache_key] = exe
    first_use = cache_key not in _FLEET_SEEN
    if mark:
        _FLEET_SEEN.add(cache_key)
    return exe, first_use


def donated_param_count(exe) -> int:
    """How many state tensors ``exe`` consumes: every field of the state
    for a donated executable, 0 for a plain one (the donation audit)."""
    return exe.donated


def live(stamp) -> bool:
    """Whether a result stamped with ``exe.stamp()`` still holds: no stamp
    (the result owns its tensors), or no call of its executable since."""
    return stamp is None or stamp[0].calls == stamp[1]


def retire(exe) -> None:
    """Drop ``exe`` from the caches and mark every result it handed out
    stale, so the next request of its shape builds a new executable with
    buffers of its own (a fleet executable's member graph is its own, and
    goes with it)."""
    exe.calls += 1
    for cache in (_ENGINE_PLANS, _FLEET_PLANS):
        for key in [k for k, v in cache.items() if v is exe]:
            del cache[key]
            _FLEET_SEEN.discard(key)


def cache_sizes() -> dict:
    """How many executables each cache holds (each holds its graph and
    static buffers until :func:`retire` or :func:`clear_caches`)."""
    return {"engine": len(_ENGINE_PLANS), "fleet": len(_FLEET_PLANS)}


def clear_caches() -> None:
    """Drop every cached executable (its graph and static buffers)."""
    _ENGINE_PLANS.clear()
    _FLEET_PLANS.clear()
    _FLEET_SEEN.clear()


# ---------------------------------------------------------------------------
# the sharded plane (compile_plan.py:143-260): eager ticks on a rank's rows


def _sharded_prelude(mesh, cfg: SimConfig) -> None:
    if cfg.sharded_route not in ("replicated", "halo"):
        raise ValueError(f"unknown sharded_route {cfg.sharded_route!r}; "
                         "expected 'replicated' or 'halo'")
    if cfg.degree_buckets is not None:
        raise ValueError(
            "sharded dense plan: cfg.degree_buckets is set — heavy-tailed "
            "configs take the row-sharded bucketed plane (parallel/"
            "sharding.make_sharded_bucketed_run / compile_plan."
            "bucketed_chunk_plan), not the dense-padded step")
    from .sharding import state_shardings
    state_shardings(mesh, cfg)
    check_slice(cfg)


def _group_ctx(mesh, cfg: SimConfig, recorder: list | None = None):
    from .kernel_context import kernel_mesh
    return kernel_mesh(cfg.n_peers, mesh.group, route=cfg.sharded_route,
                       capacity_factor=cfg.halo_capacity_factor,
                       bucket_capacity=cfg.halo_bucket_capacity,
                       recorder=recorder)


def sharded_step_plan(mesh, cfg: SimConfig, tp: TopicParams):
    """The step on this rank's rows of ``mesh``: ``fn(state, key)`` with
    ``state`` this rank's shard (parallel/sharding.shard_state). Every rank
    of the group calls it with the same key. ``fn.recorder``, when set to
    a list, collects each collective's ``(op, dtype, elements)``."""
    from ..sim.engine import _step

    _sharded_prelude(mesh, cfg)

    def sharded_step(state: SimState, key: torch.Tensor) -> SimState:
        with _group_ctx(mesh, cfg, sharded_step.recorder):
            return _step(state, cfg, tp, key.to(state.tick.device))[0]

    sharded_step.recorder = None
    return sharded_step


def sharded_chunk_plan(mesh, cfg: SimConfig, tp: TopicParams,
                       telemetry: bool = False):
    """C ticks of the sharded step over ``[C, 2]`` tick keys, the same key
    discipline as ``engine.run_keys`` (a chunked run lands on the
    single-process trajectory): ``fn(state, keys, tp_arg=None)``.
    ``telemetry=True`` returns ``(state, HealthRecord)``, each tick's
    record taken from the whole state gathered on every rank, so every
    rank holds the replicated ``[C]`` records and rank 0 can journal them.
    An eager chunk consumes nothing of its input (the reference's
    ``donate`` has no counterpart)."""
    from ..sim.engine import _step
    from ..sim.telemetry import health_record, stack_records
    from .sharding import gather_full

    _sharded_prelude(mesh, cfg)

    def sharded_run_keys(state: SimState, keys: torch.Tensor,
                         tp_arg: TopicParams | None = None):
        tpa = tp if tp_arg is None else tp_arg
        keys = keys.to(state.tick.device)
        records = []
        for i in range(keys.shape[0]):
            with _group_ctx(mesh, cfg, sharded_run_keys.recorder):
                state = _step(state, cfg, tpa, keys[i])[0]
            if telemetry:
                records.append(health_record(
                    gather_full(state, cfg, mesh.group), cfg, tpa))
        return (state, stack_records(records)) if telemetry else state

    sharded_run_keys.recorder = None
    return sharded_run_keys


def bucketed_chunk_plan(mesh, cfg: SimConfig, tp: TopicParams,
                        telemetry: bool = False):
    """C ticks of the degree-bucketed step on this rank's windows of every
    bucket (parallel/sharding.shard_bucketed_state), eagerly under the
    group's bucket-major layout, with the flat reverse-edge exchange on
    ``halo.route_bucketed_flat`` under ``sharded_route="halo"``:
    ``fn(bs, keys, tp_arg=None)``, the key discipline of
    :func:`sharded_chunk_plan` (a chunked sharded bucketed run lands on the
    single-process one, and under ``bucketed_rng="dense"`` on the dense
    engine's). Telemetry is refused (health_record reads the dense [N, K]
    planes), as the reference refuses it."""
    from ..sim.bucketed import _bucketed_tick, check_bucketable
    from .kernel_context import kernel_mesh
    from .sharding import bucketed_state_shardings

    check_bucketable(cfg)
    if telemetry:
        raise ValueError(
            "bucketed_chunk_plan: telemetry is not bucketed — "
            "sim/telemetry.health_record reads the dense [N, K] planes")
    if cfg.sharded_route not in ("replicated", "halo"):
        raise ValueError(f"unknown sharded_route {cfg.sharded_route!r}; "
                         "expected 'replicated' or 'halo'")
    bucketed_state_shardings(mesh, cfg)

    def bucketed_run_keys(bs, keys: torch.Tensor,
                          tp_arg: TopicParams | None = None):
        tpa = tp if tp_arg is None else tp_arg
        keys = keys.to(bs.g.tick.device)
        with kernel_mesh(cfg.n_peers, mesh.group, route=cfg.sharded_route,
                         capacity_factor=cfg.halo_capacity_factor,
                         bucket_capacity=cfg.halo_bucket_capacity,
                         recorder=bucketed_run_keys.recorder,
                         buckets=cfg.degree_buckets):
            for i in range(keys.shape[0]):
                bs = _bucketed_tick(bs, cfg, tpa, keys[i])
        return bs

    bucketed_run_keys.recorder = None
    return bucketed_run_keys
