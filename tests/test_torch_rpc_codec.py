"""Parity of the port's RPC wire codec (the RPC half of
go_libp2p_pubsub_tpu_torch/pb/codec.py) with the JAX package's, on the CPU.

- every test of tests/test_subsystems.py ``TestCodec`` runs twice, once as
  written and once with its runtime and codec imports pointed at the port
  (its own assertions hold on both), ``test_wire_compat_with_protoc``
  included: the port's frames parse under protoc-generated code and
  protoc's bytes decode under the port;
- seeded random RPCs (hypothesis, derandomized) built from one plain
  description in both packages' types give byte-equal ``encode_rpc`` and
  ``frame_rpc`` output and equal decodes; compat messages likewise;
- ``read_frames`` of a concatenated stream of them is equal in both
  packages, and re-framing it gives the stream back byte for byte.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import importlib
import inspect
import pathlib
import re
import shutil
import types

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

REF, PORT = "go_libp2p_pubsub_tpu", "go_libp2p_pubsub_tpu_torch"
TESTS = pathlib.Path(__file__).resolve().parent
_IMPORT = re.compile(
    r"\bgo_libp2p_pubsub_tpu\.(api|core|net|pb|routers|trace|utils)\b")


@functools.lru_cache(maxsize=None)
def load_test_module(name: str, pkg: str) -> types.ModuleType:
    """tests/<name>.py executed as a fresh module whose runtime and codec
    imports name ``pkg``."""
    path = TESTS / f"{name}.py"
    src = path.read_text()
    if pkg == PORT:
        src = _IMPORT.sub(PORT + r".\1", src)
    mod = types.ModuleType(f"_{name}__{pkg}")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def _codec_tests() -> list:
    tree = ast.parse((TESTS / "test_subsystems.py").read_text())
    cls = next(n for n in tree.body
               if isinstance(n, ast.ClassDef) and n.name == "TestCodec")
    return [m.name for m in cls.body
            if isinstance(m, ast.FunctionDef) and m.name.startswith("test")]


def codec(pkg):
    return importlib.import_module(f"{pkg}.pb.codec")


def T(pkg):
    return importlib.import_module(f"{pkg}.core.types")


@pytest.mark.parametrize("name", _codec_tests())
def test_reference_codec_test_holds_on_both(name, tmp_path):
    if name == "test_wire_compat_with_protoc" and \
            shutil.which("protoc") is None:
        pytest.skip("protoc missing")
    for pkg in (REF, PORT):
        mod = load_test_module("test_subsystems", pkg)
        fn = getattr(mod.TestCodec(), name)
        kw = {}
        if "tmp_path" in inspect.signature(fn).parameters:
            kw["tmp_path"] = tmp_path / pkg
            kw["tmp_path"].mkdir()
        fn(**kw)
    # the test module's own fixture frame, byte for byte
    want = codec(REF).frame_rpc(load_test_module("test_subsystems",
                                                 REF).full_rpc())
    got = codec(PORT).frame_rpc(load_test_module("test_subsystems",
                                                 PORT).full_rpc())
    assert got == want


# --- seeded random RPCs ------------------------------------------------------

_text = st.text(alphabet=st.characters(blacklist_categories=("Cs",)),
                max_size=12)
_mid = st.text(alphabet=st.characters(min_codepoint=0, max_codepoint=255),
               max_size=12)
_opt_bytes = st.none() | st.binary(max_size=24)
_message = st.fixed_dictionaries({
    "from_peer": st.none() | _text, "data": st.binary(max_size=48),
    "seqno": st.none() | st.binary(min_size=8, max_size=8)
    | st.binary(max_size=10),
    "topic": _text, "signature": _opt_bytes, "key": _opt_bytes})
_prune = st.fixed_dictionaries({
    "topic": _text,
    "peers": st.lists(st.tuples(_text, _opt_bytes), max_size=3),
    "backoff": st.integers(0, 1 << 40)})
_control = st.none() | st.fixed_dictionaries({
    "ihave": st.lists(st.tuples(_text, st.lists(_mid, max_size=5)),
                      max_size=3),
    "iwant": st.lists(st.lists(_mid, max_size=5), max_size=2),
    "graft": st.lists(_text, max_size=3),
    "prune": st.lists(_prune, max_size=2)})
_rpc = st.fixed_dictionaries({
    "subscriptions": st.lists(st.tuples(st.booleans(), _text), max_size=3),
    "publish": st.lists(_message, max_size=3),
    "control": _control})


def build_message(pkg, d):
    return T(pkg).Message(**d)


def build_rpc(pkg, d):
    """The RPC ``d`` describes, in package ``pkg``'s types."""
    t = T(pkg)
    ctl = None
    if d["control"] is not None:
        c = d["control"]
        ctl = t.ControlMessage(
            ihave=[t.ControlIHave(topic=tp, message_ids=list(m))
                   for tp, m in c["ihave"]],
            iwant=[t.ControlIWant(message_ids=list(m)) for m in c["iwant"]],
            graft=[t.ControlGraft(topic=tp) for tp in c["graft"]],
            prune=[t.ControlPrune(
                topic=p["topic"], backoff=float(p["backoff"]),
                peers=[t.PeerInfo(peer_id=i, signed_peer_record=r)
                       for i, r in p["peers"]]) for p in c["prune"]])
    return t.RPC(subscriptions=[t.SubOpts(s, tp)
                                for s, tp in d["subscriptions"]],
                 publish=[build_message(pkg, m) for m in d["publish"]],
                 control=ctl)


def plain(obj):
    """A decoded dataclass tree as plain data, comparable across the two
    packages' types."""
    return dataclasses.asdict(obj) if obj is not None else None


RANDOM = settings(max_examples=150, derandomize=True, deadline=None,
                  database=None)


@RANDOM
@given(_rpc)
def test_random_rpcs_frame_and_decode_equal(d):
    want = codec(REF).encode_rpc(build_rpc(REF, d))
    got = codec(PORT).encode_rpc(build_rpc(PORT, d))
    assert got == want
    assert codec(PORT).frame_rpc(build_rpc(PORT, d)) == \
        codec(REF).frame_rpc(build_rpc(REF, d))
    assert plain(codec(PORT).decode_rpc(want)) == \
        plain(codec(REF).decode_rpc(want))
    # and the port's decode re-encodes to the same frame
    assert codec(PORT).encode_rpc(codec(PORT).decode_rpc(want)) == \
        codec(REF).encode_rpc(codec(REF).decode_rpc(want))


@RANDOM
@given(_message, st.none() | st.lists(_text, max_size=4))
def test_random_compat_messages_equal(d, topics):
    want = codec(REF).encode_compat_message(build_message(REF, d), topics)
    got = codec(PORT).encode_compat_message(build_message(PORT, d), topics)
    assert got == want
    (pm, pt), (rm, rt) = (codec(PORT).decode_compat_message(want),
                          codec(REF).decode_compat_message(want))
    assert (plain(pm), pt) == (plain(rm), rt)
    assert plain(codec(PORT).decode_message(want)) == \
        plain(codec(REF).decode_message(want))
    assert codec(PORT).encode_message(build_message(PORT, d)) == \
        codec(REF).encode_message(build_message(REF, d))


@settings(max_examples=25, derandomize=True, deadline=None, database=None)
@given(st.lists(_rpc, max_size=8))
def test_read_frames_of_a_stream_equal(ds):
    stream = b"".join(codec(REF).frame_rpc(build_rpc(REF, d)) for d in ds)
    got = codec(PORT).read_frames(stream)
    want = codec(REF).read_frames(stream)
    assert [plain(r) for r in got] == [plain(r) for r in want]
    assert b"".join(codec(PORT).frame_rpc(r) for r in got) == stream
