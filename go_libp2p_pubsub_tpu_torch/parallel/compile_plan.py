"""The engine plane's chunk executables (port of parallel/compile_plan.py:
``engine_chunk``, ``engine_window`` and ``donated_param_count``,
compile_plan.py:55-97 and :326-337).

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

Not here: ``fleet_chunk`` (ROADMAP Queue 1 item 6) and the sharded plans
(item 7). ``run``, ``run_keys`` and ``run_window`` stay eager; they are
the yardstick the replay is held to.
"""

from __future__ import annotations

import torch

from ..ops import cudalib, selection
from ..sim.config import SimConfig, TopicParams
from ..sim.engine import _folded, _plain, _rows, _ticks, check_slice
from ..sim.state import SimState

WARMUP_TICKS = 2

_ENGINE_PLANS: dict = {}


class EngineExecutable:
    """C ticks of the engine as one callable: a replayed CUDA graph on the
    card, the eager ticks on the CPU. ``launches`` holds the kernel
    launches recorded into the graph (counted at capture time, once;
    every replay repeats them), empty on the CPU."""

    def __init__(self, schedule: str, cfg: SimConfig, state: SimState,
                 tp: TopicParams, keys: torch.Tensor, n_ticks: int,
                 donate: bool):
        self.schedule = schedule              # "engine" or "window"
        self.cfg = cfg
        self.n_ticks = n_ticks
        self.donate = donate
        self.device = state.tick.device
        self.launches: dict = {}
        self.graph = None
        if self.device.type == "cuda":
            self._capture(state, tp, keys)

    @property
    def donated(self) -> int:
        """State tensors the executable consumes: every field donated, or
        none."""
        return len(SimState._fields) if self.donate else 0

    def _key_of(self, keys: torch.Tensor):
        return _rows(keys) if self.schedule == "engine" else _folded(keys)

    def _ticks(self, state: SimState, tp: TopicParams,
               keys: torch.Tensor) -> SimState:
        return _ticks(state, self.cfg, tp, self.n_ticks, self._key_of(keys),
                      False)

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
                          lambda i, st: key_of(i % self.n_ticks, st), False)
        torch.cuda.current_stream(dev).wait_stream(side)
        del warm
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        before = dict(cudalib.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self._ticks(self._state, self._tp, self._keys)
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

    def __call__(self, state: SimState, tp: TopicParams,
                 keys: torch.Tensor) -> SimState:
        self._check(state, keys)
        if self.graph is None:
            return self._ticks(state, tp, keys.to(self.device))
        for dst, src in ((self._keys, keys), *zip(self._tp, tp),
                         *zip(self._state, state)):
            _load(dst, src)
        self.graph.replay()
        if self.donate:
            return SimState(*self._state)
        return SimState(*(x.clone() for x in self._out))


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
    if telemetry:
        raise NotImplementedError(
            f"{what}(telemetry=True): the health records of "
            "sim/telemetry.py are not ported yet (ROADMAP.md, Queue 1 "
            "item 5)")
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
                               int(n_ticks), donate)
        _ENGINE_PLANS[cache_key] = exe
    return exe


def engine_chunk(exec_cfg: SimConfig, state: SimState, tp: TopicParams,
                 keys_chunk: torch.Tensor, *, telemetry: bool = False,
                 donate: bool = False) -> EngineExecutable:
    """The executable of one chunk of ``run_keys``: one tick per row of
    ``keys_chunk`` ([C, 2]). Call as ``exe(state, tp, keys_chunk)``;
    ``donate=True`` consumes ``state``."""
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


def donated_param_count(exe: EngineExecutable) -> int:
    """How many state tensors ``exe`` consumes: every field of the state
    for a donated executable, 0 for a plain one (the donation audit)."""
    return exe.donated


def clear_caches() -> None:
    """Drop every cached executable (its graph and static buffers)."""
    _ENGINE_PLANS.clear()
