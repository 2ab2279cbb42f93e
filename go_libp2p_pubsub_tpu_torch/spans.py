"""The port's own spans: named ranges at its layer boundaries.

``with span(name):`` marks one stage of the work. While a
``torch.profiler`` session is on, the span is a ``record_function`` range
on the profiler's clock, so it lands on the same timeline as the device's
kernels: each stage's launches, and each idle gap of the device, carry the
span the host was in. With no profiler on, a span costs a flag test and
records nothing. Spans run in Python, so a replayed CUDA graph repeats
none of them.

Device time per stage inside a captured chunk. While a recorder is
installed on the calling thread (:func:`timing`; a ContextVar, as
parallel/kernel_context keeps its group), every span also calls its
``open()`` at entry and its ``close(name, token)`` at exit. A
:class:`StageTimer` records a timing event on the current stream at each.
parallel/compile_plan installs one around the capture of a
``stage_timing=True`` chunk: the events are created ``external=True``, so
the capture turns each record into an event-record node of the graph,
every replay records them again, and :meth:`StageTimer.stage_ms` reads the
device milliseconds of each span name, summed over the chunk's ticks, once
a replay has been synchronized. No timer is installed anywhere else: a
plain capture records no event.

The span names, and what each covers, are :data:`NAMES`. A name is the
layer and the stage; nested spans keep their own names
(``heartbeat.select`` inside ``engine.heartbeat``), so their totals are
kept apart. A profiler session sees the spans of the thread it was
started on (and of every thread with ``profile_all_threads``); the
supervisor's chunk dispatch runs on the calling thread unless a deadline
is set.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.autograd import profiler as _profiler

NAMES = {
    # sim/engine.py: one tick, in its order
    "engine.codec": "decode_state at a tick's entry, encode_state at its "
                    "exit (identities under state_precision='f32')",
    "engine.faults": "apply_faults: the fault plan's cuts, heals and draws",
    "engine.keys": "the tick key's split into its stages' keys",
    "engine.sub_churn": "churn_subscriptions: the topic Join/Leave round",
    "engine.publish": "choose_publishers, publish and the censor mask",
    "engine.gater": "gater_decay: the peer gater's counters decay",
    "engine.heartbeat": "heartbeat (the IWANT answer table it carries "
                        "included); floodsub and randomsub fill zeros",
    "engine.forward": "forward_tick: IWANT resolve, the hops, IHAVE emit",
    "engine.churn": "churn_edges: connection churn and PX reconnects",
    "engine.flags": "the halo-overflow drain and tick_flags",
    "engine.telemetry": "health_record of the tick's post-step state",
    # ops/heartbeat.py: parts of engine.heartbeat
    "heartbeat.score": "the active latch and compute_scores",
    "heartbeat.select": "each select_random, select_top and masked_median",
    "heartbeat.exchange": "each edge_gather_packed exchange",
    # sim/supervisor.py, the thread that calls supervised_run
    "supervisor.setup": "run start to the first dispatch: resume, journal "
                        "header, the writer thread",
    "supervisor.dispatch": "a chunk's whole dispatch: executable lookup, "
                           "the deadline thread's spawn and join",
    "supervisor.capture": "a first use of a chunk shape: warm-up and "
                          "capture",
    "supervisor.launch": "the chunk's call: input loads, graph.replay() "
                         "and output clones",
    "supervisor.confirm": "blocked until the chunk's event completes",
    "supervisor.process": "folding a confirmed chunk in: journal rows, "
                          "verdicts, the boundary",
    "supervisor.boundary": "a boundary's anchor and checkpoint hand-off",
    "supervisor.writer_blocked": "submitting to a full writer queue",
    "supervisor.drain": "the terminal note, the writer's drain and close",
    # sim/supervisor.py, the writer thread
    "writer.task": "one writer task and the journal flush after it",
}

_recorder: contextvars.ContextVar = \
    contextvars.ContextVar("span_recorder", default=None)


def _profiling() -> bool:
    # the process-wide flag torch.profiler sets while a session is on
    return getattr(_profiler, "_is_profiler_enabled", True)


class span:
    """``with span(name):`` (a name of :data:`NAMES`): a profiler range
    while a profiler session is on, the installed recorder's ``open`` and
    ``close`` while there is one, else nothing."""

    __slots__ = ("name", "_range", "_rec", "_token")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rec = _recorder.get()
        self._token = self._rec.open() if self._rec is not None else None
        self._range = None
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        if self._rec is not None:
            self._rec.close(self.name, self._token)
        return False


def _timing_event():
    return torch.cuda.Event(enable_timing=True, external=True)


class StageTimer:
    """A recorder of the timing events of every span opened while it is
    installed: a start event recorded at the span's entry and an end event
    at its exit, on the current stream. ``event()`` makes one event (a
    CUDA timing event by default)."""

    def __init__(self, event=_timing_event):
        self._event = event
        self.marks: list = []       # (name, start, end), in exit order

    def open(self):
        ev = self._event()
        ev.record()
        return ev

    def close(self, name: str, start) -> None:
        end = self._event()
        end.record()
        self.marks.append((name, start, end))

    def stage_ms(self) -> dict:
        """Milliseconds between each span's events, summed per name; read
        after the work that recorded them has been synchronized."""
        out: dict = {}
        for name, start, end in self.marks:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out


@contextlib.contextmanager
def timing(recorder):
    """Install ``recorder`` (a :class:`StageTimer`, or any object with
    ``open() -> token`` and ``close(name, token)``) on this thread for the
    block."""
    token = _recorder.set(recorder)
    try:
        yield recorder
    finally:
        _recorder.reset(token)
