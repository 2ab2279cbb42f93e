"""ctypes binding of the native host codec (port of trace/native.py).

``csrc/trace_codec.cpp`` is host C++, not a CUDA kernel: the trace
tensorizer (a uvarint-delimited TraceEvent file straight to a
:class:`~.replay.ReplayFeed`, with no Python object per event) and the
health journal's NDJSON row encoder (sim/telemetry.py). It is built at
first use, never at import, into ``go_libp2p_pubsub_tpu_torch/_build/``
by ``hostlib.build`` (a name carrying the source's hash, safe across
processes that build at once). Where no compiler is found :func:`load`
returns None and the callers take the Python paths
(``replay.tensorize_trace``, ``telemetry.encode_rows_py``).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .. import hostlib
from .replay import ReplayFeed

SRC = os.path.join(hostlib.CSRC, "trace_codec.cpp")
BUILD_DIR = hostlib.BUILD_DIR

_lock = threading.Lock()
_lib = None
_tried = False


def lib_path() -> str:
    """The library's path, named by the hash of its source."""
    return hostlib.lib_path(SRC, "libtracecodec", BUILD_DIR)


def load():
    """The loaded library, built at first use; None where it cannot be
    built (the first answer holds for the process)."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = lib_path()
        if not os.path.exists(path) and not hostlib.build(SRC, path):
            return None
        lib = ctypes.CDLL(path)
        lib.trace_codec_tensorize.restype = ctypes.c_int
        lib.trace_codec_tensorize.argtypes = [
            ctypes.c_char_p, ctypes.c_long,          # buf, len
            ctypes.c_char_p, ctypes.c_long,          # peers blob, n
            ctypes.c_char_p, ctypes.c_long,          # topics blob, n
            ctypes.POINTER(ctypes.c_double),         # dup_window
            ctypes.c_double, ctypes.c_double,        # decay_interval, t_end
            ctypes.c_int, ctypes.c_long,             # has_t_end, msg_window
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.trace_codec_free.restype = None
        lib.trace_codec_free.argtypes = [ctypes.c_void_p]
        lib.trace_codec_health_json.restype = ctypes.c_int
        lib.trace_codec_health_json.argtypes = [
            ctypes.POINTER(ctypes.c_double),         # vals [rows*cols]
            ctypes.c_long, ctypes.c_long,            # n_rows, n_cols
            ctypes.c_char_p, ctypes.c_long,          # names blob, len
            ctypes.c_char_p,                         # is_int per col
            ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
            ctypes.POINTER(ctypes.c_long),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _blob(names) -> bytes:
    """Length-prefixed, binary-safe names (uint32 LE length + raw bytes;
    peer ids are raw multihash bytes carried through surrogateescape)."""
    out = bytearray()
    for s in names:
        raw = s.encode("utf-8", "surrogateescape")
        out += len(raw).to_bytes(4, "little") + raw
    return bytes(out)


def tensorize_bytes(data: bytes, peer_index: dict, topic_index: dict, *,
                    msg_window: int, decay_interval: float = 1.0,
                    dup_window=None, t_end: float | None = None) -> ReplayFeed:
    """Native twin of ``replay.tensorize_trace`` over encoded TraceEvent
    bytes (the Python tensorizer where the library cannot be built).
    ``peer_index`` / ``topic_index`` map contiguous indices 0..n-1, the
    contract ``tensorize_trace`` relies on. Raises ValueError for a window
    overflow or a malformed stream."""
    lib = load()
    if lib is None:
        from ..pb.codec import decode_trace_bytes
        from .replay import tensorize_trace
        return tensorize_trace(decode_trace_bytes(data), peer_index,
                               topic_index, msg_window=msg_window,
                               decay_interval=decay_interval,
                               dup_window=dup_window, t_end=t_end)

    t_count = len(topic_index)
    if dup_window is None:
        dw = [0.0] * t_count
    elif np.isscalar(dup_window):
        dw = [float(dup_window)] * t_count
    else:
        dw = [float(x) for x in dup_window]

    out = ctypes.POINTER(ctypes.c_int32)()
    out_events = ctypes.c_long()
    mids_p = ctypes.POINTER(ctypes.c_char)()
    n_mids = ctypes.c_long()
    dw_arr = (ctypes.c_double * t_count)(*dw)
    rc = lib.trace_codec_tensorize(
        data, len(data),
        _blob(sorted(peer_index, key=peer_index.get)), len(peer_index),
        _blob(sorted(topic_index, key=topic_index.get)), t_count, dw_arr,
        decay_interval, t_end if t_end is not None else 0.0,
        1 if t_end is not None else 0, msg_window,
        ctypes.byref(out), ctypes.byref(out_events),
        ctypes.byref(mids_p), ctypes.byref(n_mids))
    try:
        if rc != 0:
            raise ValueError(f"native tensorize failed (rc={rc}): msg_window "
                             "too small or a malformed stream")
        n = out_events.value
        arr = np.ctypeslib.as_array(out, shape=(n, 4)).copy()
        mid_slot: dict = {}
        base = ctypes.addressof(mids_p.contents) if n_mids.value else 0
        off = 0
        for i in range(n_mids.value):
            ln = int.from_bytes(ctypes.string_at(base + off, 4), "little")
            off += 4
            mid_slot[ctypes.string_at(base + off, ln).decode("latin-1")] = i
            off += ln
    finally:
        lib.trace_codec_free(out)
        lib.trace_codec_free(mids_p)
    return ReplayFeed(op=np.ascontiguousarray(arr[:, 0]),
                      a=np.ascontiguousarray(arr[:, 1]),
                      b=np.ascontiguousarray(arr[:, 2]),
                      c=np.ascontiguousarray(arr[:, 3]),
                      mid_slot=mid_slot)


def tensorize_file(path: str, peer_index: dict, topic_index: dict,
                   **kw) -> ReplayFeed:
    """:func:`tensorize_bytes` of a PBTracer file's bytes."""
    with open(path, "rb") as f:
        return tensorize_bytes(f.read(), peer_index, topic_index, **kw)


def encode_health_json(matrix, columns) -> bytes | None:
    """A telemetry row matrix (``[n_rows, n_cols]`` float64) as NDJSON
    ``health`` lines in one native call; ``columns`` is the ordered
    ``(name, is_int)`` schema. Non-finite values encode as null. Returns
    None where the library cannot be built (the caller takes the Python
    encoder, whose rows parse to the same values)."""
    lib = load()
    if lib is None:
        return None
    mat = np.ascontiguousarray(matrix, np.float64)
    if mat.ndim != 2 or mat.shape[1] != len(columns):
        raise ValueError(f"encode_health_json: matrix {mat.shape} does not "
                         f"match {len(columns)} columns")
    if mat.shape[0] == 0:
        return b""
    blob = _blob(name for name, _is_int in columns)
    is_int = bytes(1 if i else 0 for _n, i in columns)
    out = ctypes.POINTER(ctypes.c_char)()
    out_len = ctypes.c_long()
    rc = lib.trace_codec_health_json(
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        mat.shape[0], mat.shape[1], blob, len(blob), is_int,
        ctypes.byref(out), ctypes.byref(out_len))
    try:
        if rc != 0:
            return None
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.trace_codec_free(out)
