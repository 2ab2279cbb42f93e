"""Trace sinks (port of trace/sinks.py; tracer.go:79-303): an in-memory
collector, an NDJSON file, a length-delimited binary (PBTracer) file, and a
batching "remote" sink.

The file and remote sinks share the buffered, lossy writer discipline of
go-libp2p-pubsub's ``basicTracer`` (64k buffer, drop-when-full for the
lossy remote sink, tracer.go:23,42-60); the owner calls ``flush``
instead of a writer goroutine. ``hard_flush`` is the failure path: the
supervisor (sim/supervisor.py, ``SupervisorConfig.sinks``) calls it on
every failure. The remote sink opens no socket of its own: it writes
through the ``send`` or ``open_stream`` callable its caller passes.
"""

from __future__ import annotations

import gzip
import json
import os
import zlib
from typing import Callable

from ..pb import codec

TRACE_BUFFER_SIZE = 1 << 16  # tracer.go:23
MIN_TRACE_BATCH_SIZE = 16    # tracer.go:24


class _BufferedTracer:
    def __init__(self, lossy: bool):
        self.buf: list[dict] = []
        self.lossy = lossy
        self.dropped = 0
        self.closed = False

    def trace(self, evt: dict) -> None:
        if self.closed:
            return
        if self.lossy and len(self.buf) >= TRACE_BUFFER_SIZE:
            self.dropped += 1
            return
        self.buf.append(evt)

    def hard_flush(self) -> None:
        """Flush buffered events AND fsync the backing file (when there is
        one): the supervisor's failure path (sim/supervisor.py) calls this
        so a crashed run leaves a readable partial trace on disk rather
        than a page-cache-resident truncation. Batch-size gates do not
        apply — everything buffered goes out."""
        if self.closed:
            return
        self.flush()
        fh = getattr(self, "_fh", None)
        if fh is not None and not fh.closed:
            fh.flush()
            os.fsync(fh.fileno())


class MemoryTracer:
    """In-memory event collector. Shared across all nodes of an in-process
    network it yields the true global emission order, the canonical event
    order for trace replay (trace/replay.py)."""

    def __init__(self):
        self.events: list[dict] = []

    def trace(self, evt: dict) -> None:
        self.events.append(evt)


class JSONTracer(_BufferedTracer):
    """NDJSON file sink (tracer.go:79-129)."""

    def __init__(self, path: str):
        super().__init__(lossy=False)
        self.path = path
        self._fh = open(path, "w")

    def flush(self) -> None:
        for evt in self.buf:
            self._fh.write(json.dumps(evt) + "\n")
        self.buf.clear()
        self._fh.flush()

    def close(self) -> None:
        self.flush()
        self.closed = True
        self._fh.close()


class PBTracer(_BufferedTracer):
    """Length-delimited binary file sink (tracer.go:132-181). Uses the pb
    layer's TraceEvent encoding (uvarint length prefix + protobuf bytes)."""

    def __init__(self, path: str):
        super().__init__(lossy=False)
        self.path = path
        self._fh = open(path, "wb")

    def flush(self) -> None:
        for evt in self.buf:
            payload = codec.encode_trace_event(evt)
            self._fh.write(codec.write_uvarint(len(payload)) + payload)
        self.buf.clear()
        self._fh.flush()

    def close(self) -> None:
        self.flush()
        self.closed = True
        self._fh.close()


class RemoteTracer(_BufferedTracer):
    """Remote collector sink (tracer.go:186-303): lossy buffering,
    MIN_TRACE_BATCH_SIZE-gated flushing, and gzip'd delimited
    ``TraceEventBatch`` frames — the reference's exact wire unit
    (tracer.go:211-239) — written to a persistent stream.

    ``open_stream`` is the substrate's NewStream analogue: a zero-arg
    callable returning a write callable, raising on dial failure. A write
    failure resets the stream and reopens it once per flush
    (tracer.go:268-276 ``s.Reset()`` + ``openStream``); if the reopen or the
    retry also fails the batch is dropped (the sink is lossy by contract).
    Passing a plain write callable models a stream that never fails.
    Divergence from tracer.go, kept from the reference's sink: gzip is
    per-batch rather than one stream-long gzip writer, so each batch is
    independently decompressible (no gzip state rides the stream)."""

    def __init__(self, send: Callable[[bytes], None] | None = None, *,
                 open_stream: Callable[[], Callable[[bytes], None]] | None
                 = None):
        super().__init__(lossy=True)
        if (send is None) == (open_stream is None):
            raise ValueError("pass exactly one of send / open_stream")
        self._open = open_stream if open_stream is not None \
            else (lambda: send)
        self._stream: Callable[[bytes], None] | None = None

    def flush(self) -> None:
        if len(self.buf) < MIN_TRACE_BATCH_SIZE:
            return
        self._write_batch()

    def hard_flush(self) -> None:
        # failure path: the min-batch gate yields to getting the events out
        if not self.closed and self.buf:
            self._write_batch()

    def _write_batch(self) -> None:
        batch, self.buf = self.buf, []
        body = codec.encode_trace_event_batch(batch)
        payload = gzip.compress(codec.write_uvarint(len(body)) + body)
        for _attempt in range(2):
            if self._stream is None:
                try:
                    self._stream = self._open()
                except Exception:
                    break               # collector unreachable: drop batch
            try:
                self._stream(payload)
                return
            except Exception:
                self._stream = None     # reset + reopen once, then give up
        self.dropped += len(batch)

    def close(self) -> None:
        if self.buf:
            self._write_batch()
        self.closed = True

    @staticmethod
    def decode_batch(payload: bytes) -> list[dict]:
        data = zlib.decompress(payload, wbits=31)
        events: list[dict] = []
        pos = 0
        while pos < len(data):
            ln, pos = codec.read_uvarint(data, pos)
            events.extend(codec.decode_trace_event_batch(data[pos:pos + ln]))
            pos += ln
        return events
