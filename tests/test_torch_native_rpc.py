"""Parity of the port's native RPC scanner (csrc/rpc_codec.cpp through
go_libp2p_pubsub_tpu_torch/pb/native_rpc.py) with its plain twin and with
the JAX package's native scanner, on the CPU.

- the port's native scan, its plain scan (``scan_bytes_python``) and the
  reference's native scan give equal ``stats``, ``msgs`` and ``topics`` on
  the randomized stream of tests/test_native_codec.py, on publishes whose
  topic field is present but empty, and on an empty stream; all three
  refuse an oversize frame (``max_frame``), a truncated tail and a
  truncated length prefix;
- an 8-byte seqno of 2**63 or more: the port's two scans store it wrapped
  to int64, as the reference's native scan does, while the reference's
  ``scan_bytes_python`` raises OverflowError for it;
- processes that build the library at once all load a whole one, and one
  library and no temporary file remain in the build directory, which is
  the port's ``_build/`` by default.
"""

from __future__ import annotations

import os
import random
import subprocess
import sys
import time

import numpy as np
import pytest

from go_libp2p_pubsub_tpu.pb import codec as jcodec
from go_libp2p_pubsub_tpu.pb import native_rpc as jnative
from go_libp2p_pubsub_tpu_torch.core import types as T
from go_libp2p_pubsub_tpu_torch.pb import codec, native_rpc
import test_native_codec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCANS = {
    "port native": native_rpc.scan_bytes,
    "port plain": native_rpc.scan_bytes_python,
    "reference native": jnative.scan_bytes,
}


def _scan_all(data: bytes, max_frame: int = 0) -> dict:
    assert native_rpc.available() and jnative.available()
    return {name: scan(data, max_frame) for name, scan in SCANS.items()}


def _assert_equal(results: dict) -> None:
    want_s, want_m, want_t = results["reference native"]
    for name, (s, m, t) in results.items():
        assert s.dtype == np.int64 and m.dtype == np.int64, name
        np.testing.assert_array_equal(s, want_s, err_msg=name)
        np.testing.assert_array_equal(m, want_m, err_msg=name)
        assert t == want_t, name


def _frame(payload: bytes) -> bytes:
    return codec.write_uvarint(len(payload)) + payload


def _random_stream(seed: int = 7, frames: int = 60) -> bytes:
    return test_native_codec.TestNativeRpcScanner()._random_stream(
        seed=seed, frames=frames)


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_random_stream_scans_equal(seed):
    data = _random_stream(seed)
    got = _scan_all(data)
    _assert_equal(got)
    s, m, _t = got["port native"]
    assert s.shape[0] == 60 and s[:, 1].sum() == m.shape[0] > 0
    assert (s[:, 3:].sum(axis=0) > 0).all()     # every control kind drawn


def test_empty_topics_scan_equal():
    """A publish whose topic field is present but empty keeps topic id -1
    in every scan, beside one whose topic is interned."""
    msg_empty = codec._bytes_field(2, b"xx") + codec._str_field(4, "")
    msg_named = codec._bytes_field(2, b"y") + codec._str_field(4, "t0")
    data = _frame(codec._bytes_field(2, msg_empty)
                  + codec._bytes_field(2, msg_named))
    got = _scan_all(data)
    _assert_equal(got)
    _s, m, t = got["port plain"]
    assert m[:, 1].tolist() == [-1, 0] and t == ["t0"]


def test_empty_stream_scans_equal():
    got = _scan_all(b"")
    _assert_equal(got)
    s, m, t = got["port native"]
    assert s.shape == (0, 8) and m.shape == (0, 4) and t == []


def _oversize() -> bytes:
    rpc = T.RPC(publish=[T.Message(data=b"x" * 4096, topic="t")])
    return _random_stream(frames=5) + codec.frame_rpc(rpc)


@pytest.mark.parametrize("case", ["oversize", "truncated tail",
                                  "truncated length"])
def test_malformed_streams_refused_by_every_scan(case):
    data = _random_stream(frames=10)
    max_frame = 0
    if case == "oversize":
        data, max_frame = _oversize(), 1024
        # under no limit the same stream scans, equal in every scan
        _assert_equal(_scan_all(data))
    elif case == "truncated tail":
        data = data[:-3]
    else:
        data = data + b"\x80"           # a length varint cut short
    for name, scan in SCANS.items():
        with pytest.raises(ValueError):
            scan(data, max_frame)


def _seqno_stream() -> bytes:
    """Publishes whose 8-byte seqnos span the whole 64-bit range, the top
    bit set in half of them, and the edge values."""
    gen = random.Random(11)
    values = [0, 1, (1 << 63) - 1, 1 << 63, (1 << 63) + 1, (1 << 64) - 1]
    values += [gen.getrandbits(64) for _ in range(58)]
    out = bytearray()
    for i in range(0, len(values), 4):
        rpc = T.RPC(publish=[T.Message(data=b"d", topic=f"t{v % 3}",
                                       seqno=v.to_bytes(8, "big"))
                             for v in values[i:i + 4]])
        out += codec.frame_rpc(rpc)
    return bytes(out)


def test_seqnos_over_2_63_wrap_to_int64():
    data = _seqno_stream()
    got = _scan_all(data)
    _assert_equal(got)
    seqnos = got["port plain"][1][:, 3]
    assert seqnos[3] == -(1 << 63) and seqnos[5] == -1
    assert (seqnos < 0).sum() > 10
    # the reference's plain scan cannot store them (its finding, pinned)
    with pytest.raises(OverflowError):
        jnative.scan_bytes_python(data)
    assert jcodec.frame_rpc(codec.read_frames(data)[0]) == \
        codec.frame_rpc(codec.read_frames(data)[0])


def test_the_library_builds_into_the_ports_build_dir():
    assert native_rpc.available()
    path = native_rpc.lib_path()
    assert os.path.dirname(path) == os.path.join(
        REPO, "go_libp2p_pubsub_tpu_torch", "_build")
    assert os.path.basename(path).startswith("librpccodec-")
    assert os.path.exists(path)


_BUILD_CHILD = """
import os, sys, time
sys.path.insert(0, {repo!r})
sys.modules["jax"] = None
sys.modules["go_libp2p_pubsub_tpu"] = None
from go_libp2p_pubsub_tpu_torch.pb import native_rpc
native_rpc.BUILD_DIR = sys.argv[1]
while not os.path.exists(sys.argv[2]):
    time.sleep(0.005)
ok = native_rpc.available()
stats, msgs, topics = native_rpc.scan_bytes(bytes.fromhex(sys.argv[3]))
print(ok, native_rpc.lib_path(), stats.tolist(), msgs.tolist(), topics)
"""


def test_concurrent_first_builds_all_load(tmp_path):
    """Processes that find no library build it at once; each loads a whole
    one, and one library and no temporary file remain."""
    build = tmp_path / "_build"
    go = tmp_path / "go"
    data = codec.frame_rpc(T.RPC(publish=[T.Message(
        data=b"abc", topic="t", seqno=(1 << 63).to_bytes(8, "big"))]))
    code = _BUILD_CHILD.format(repo=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build),
                               str(go), data.hex()], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    time.sleep(0.5)
    go.write_text("")
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    name = os.path.basename(native_rpc.lib_path())
    want = (f"True {build}/{name} [[0, 1, 3, 0, 0, 0, 0, 0]] "
            f"[[0, 0, 3, {-(1 << 63)}]] ['t']")
    assert {o.strip() for o, _ in outs} == {want}
    assert os.listdir(build) == [name]
