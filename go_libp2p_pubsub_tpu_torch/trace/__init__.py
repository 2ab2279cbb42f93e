"""Trace interop (port of trace/): the tracer contracts, the trace sinks
(in-memory, NDJSON, PBTracer file, remote batches), the native host codec
(trace/native.py) and the replay of recorded trace events into the batched
engine's state."""

from .events import RawTracer, RawTracerBase  # noqa: F401
from .replay import (  # noqa: F401
    ReplayFeed,
    replay,
    replay_feed,
    replay_topic_params,
    tensorize_trace,
    tensorize_trace_file,
)
from .sinks import (  # noqa: F401
    JSONTracer,
    MemoryTracer,
    PBTracer,
    RemoteTracer,
)
