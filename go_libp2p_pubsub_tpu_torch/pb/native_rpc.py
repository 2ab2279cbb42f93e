"""ctypes binding of the native RPC wire scanner (port of pb/native_rpc.py).

Bulk host-side RPC streams (interop captures, adversarial load fixtures,
differential-test corpora) are framed as go-libp2p-pubsub frames them on
the wire (a uvarint length prefix per RPC, comm.go:157-171). Scanning them
frame by frame through :mod:`.codec` builds a Python object per message;
``csrc/rpc_codec.cpp`` walks the stream natively and returns three arrays:

  stats  [F, 8] int64: per frame, subscriptions, publish count, publish
         data bytes, IHAVE ids, IWANT ids, GRAFTs, PRUNEs, PX records
  msgs   [M, 4] int64: per publish message, frame index, topic id, data
         length, big-endian seqno (the first 8 bytes, wrapped to int64)
  topics list[str]: topic id -> topic name, in first-seen order

The library is host C++, built by ``hostlib.build`` at first use, never at
import, into ``go_libp2p_pubsub_tpu_torch/_build/``. :func:`scan_bytes`
takes the Python scan where no compiler runs (same contract);
:func:`scan_bytes_python` is the plain twin the native scan is held to.

An 8-byte seqno is any value a peer chooses, so its top bit is set half
the time: both scans store it as int64, two's-complement wrapped, and
neither raises for it.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .. import hostlib

SRC = os.path.join(hostlib.CSRC, "rpc_codec.cpp")
BUILD_DIR = hostlib.BUILD_DIR

_lock = threading.Lock()
_lib = None
_tried = False


def lib_path() -> str:
    """The library's path, named by the hash of its source."""
    return hostlib.lib_path(SRC, "librpccodec", BUILD_DIR)


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
        lib.rpc_codec_scan.restype = ctypes.c_int
        lib.rpc_codec_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.rpc_codec_free.restype = None
        lib.rpc_codec_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _int64(v: int) -> int:
    """An unsigned 64-bit value as the int64 the native scan stores."""
    return v - (1 << 64) if v >= 1 << 63 else v


def scan_bytes_python(data: bytes, max_frame: int = 0):
    """The plain twin of the native scan, through :func:`.codec.decode_rpc`.
    Raises ValueError for a frame past the end of ``data`` (a truncated
    tail), a truncated length prefix, or a frame over ``max_frame`` bytes
    (0: no limit)."""
    from .codec import decode_rpc, read_uvarint

    stats, msgs, topics, topic_ids = [], [], [], {}
    pos, frame = 0, 0
    while pos < len(data):
        try:
            flen, pos = read_uvarint(data, pos)
        except IndexError:
            raise ValueError("malformed frame: truncated length") from None
        if flen > len(data) - pos:
            raise ValueError("malformed frame")
        if max_frame and flen > max_frame:
            raise ValueError("oversize frame")
        try:
            rpc = decode_rpc(data[pos:pos + flen])
        except IndexError:
            raise ValueError("malformed frame: truncated field") from None
        pos += flen
        st = [0] * 8
        st[0] = len(rpc.subscriptions)
        st[1] = len(rpc.publish)
        for m in rpc.publish:
            tid = topic_ids.get(m.topic)
            if tid is None and m.topic:
                tid = len(topics)
                topics.append(m.topic)
                topic_ids[m.topic] = tid
            data_len = len(m.data or b"")
            st[2] += data_len
            seqno = _int64(int.from_bytes((m.seqno or b"")[:8], "big"))
            msgs.append([frame, tid if tid is not None else -1,
                         data_len, seqno])
        c = rpc.control
        if c is not None:
            st[3] = sum(len(ih.message_ids) for ih in c.ihave)
            st[4] = sum(len(iw.message_ids) for iw in c.iwant)
            st[5] = len(c.graft)
            st[6] = len(c.prune)
            st[7] = sum(len(pr.peers) for pr in c.prune)
        stats.append(st)
        frame += 1
    return (np.asarray(stats, np.int64).reshape(-1, 8),
            np.asarray(msgs, np.int64).reshape(-1, 4), topics)


def scan_bytes(data: bytes, max_frame: int = 0):
    """Scan an RPC frame stream -> ``(stats [F, 8], msgs [M, 4], topics)``
    natively (the Python scan where the library cannot be built). Raises
    ValueError for a malformed stream or a frame over ``max_frame``."""
    lib = load()
    if lib is None:
        return scan_bytes_python(data, max_frame)
    stats_p = ctypes.POINTER(ctypes.c_int64)()
    msgs_p = ctypes.POINTER(ctypes.c_int64)()
    topics_p = ctypes.POINTER(ctypes.c_char)()
    n_frames = ctypes.c_long()
    n_msgs = ctypes.c_long()
    topics_bytes = ctypes.c_long()
    rc = lib.rpc_codec_scan(
        data, len(data), max_frame,
        ctypes.byref(stats_p), ctypes.byref(n_frames),
        ctypes.byref(msgs_p), ctypes.byref(n_msgs),
        ctypes.byref(topics_p), ctypes.byref(topics_bytes))
    if rc != 0:
        raise ValueError(f"native rpc scan failed (rc={rc}): "
                         + ("oversize frame" if rc == 3 else "malformed"))
    try:
        stats = np.ctypeslib.as_array(
            stats_p, shape=(n_frames.value, 8)).copy() \
            if n_frames.value else np.zeros((0, 8), np.int64)
        msgs = np.ctypeslib.as_array(
            msgs_p, shape=(n_msgs.value, 4)).copy() \
            if n_msgs.value else np.zeros((0, 4), np.int64)
        raw = ctypes.string_at(topics_p, topics_bytes.value) \
            if topics_bytes.value else b""
    finally:
        lib.rpc_codec_free(stats_p)
        lib.rpc_codec_free(msgs_p)
        lib.rpc_codec_free(topics_p)
    topics, off = [], 0
    while off < len(raw):
        ln = int.from_bytes(raw[off:off + 4], "little")
        off += 4
        topics.append(raw[off:off + ln].decode("utf-8"))
        off += ln
    return stats.astype(np.int64), msgs.astype(np.int64), topics
