"""Trace interop (port of trace/): the tracer contracts and the replay of
recorded trace events into the batched engine's state. The reference's
host-runtime sinks (JSON/pb/remote tracers) serve its pure-Python runtime
and are not part of the port."""

from .events import RawTracer, RawTracerBase  # noqa: F401
from .replay import (  # noqa: F401
    ReplayFeed,
    replay,
    replay_feed,
    replay_topic_params,
    tensorize_trace,
)
