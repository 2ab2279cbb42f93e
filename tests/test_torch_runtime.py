"""Parity of the port's functional runtime (go_libp2p_pubsub_tpu_torch/api,
net, routers, utils, core/types.py, trace/bus.py) with the JAX package's on
the CPU.

Every test of tests/test_functional_runtime.py (``TestFloodSub`` through
``TestPublishReadiness``) and tests/test_adversarial_runtime.py
(``TestIWantRetransmissionCutoff`` through ``TestSybilCrossCheck``) is one
case: the test's source runs twice in this process, once as written and
once with its runtime imports pointed at the port, so both runs build the
same swarm and drive it through the same calls (its own assertions hold
on both). While each run lasts, every ``PubSub`` gets a tee on its event
tracer, every subscription delivery and every ``PeerScore`` is recorded;
after it:

- each node's event stream (the ``MemoryTracer`` dicts) is equal;
- each subscription's delivered messages are equal, in order;
- each gossipsub router's ``mesh``, ``fanout`` and ``backoff`` are equal;
- ``PeerScore.score`` of every (scorer, peer) is exactly equal: both sides
  are Python floats doing the same arithmetic.

Both runs share one process because a node seeds its RNG from
``hash(peer_id)`` (api/pubsub.py), and str hashes are salted per process.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import enum
import functools
import importlib
import pathlib
import re
import types

import pytest

REF, PORT = "go_libp2p_pubsub_tpu", "go_libp2p_pubsub_tpu_torch"
TESTS = pathlib.Path(__file__).resolve().parent

# the runtime's subpackages: a reference test's imports of these are the
# ones pointed at the port (its other imports stay where they are)
_RUNTIME_IMPORT = re.compile(
    r"\bgo_libp2p_pubsub_tpu\.(api|core|net|routers|trace|utils)\b")

try:
    import cryptography  # noqa: F401
    HAVE_CRYPTO = True
except ImportError:
    HAVE_CRYPTO = False


def M(pkg: str, mod: str) -> types.ModuleType:
    """Module ``mod`` of package ``pkg`` (``M(PORT, "sim.faults")``)."""
    return importlib.import_module(f"{pkg}.{mod}")


@functools.lru_cache(maxsize=None)
def load_test_module(name: str, pkg: str) -> types.ModuleType:
    """tests/<name>.py executed as a fresh module whose runtime imports
    name ``pkg`` (the source as written for the reference)."""
    path = TESTS / f"{name}.py"
    src = path.read_text()
    if pkg == PORT:
        src = _RUNTIME_IMPORT.sub(PORT + r".\1", src)
    mod = types.ModuleType(f"_{name}__{pkg}")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def collect_cases(name: str, classes: tuple[str, ...] | None = None,
                  crypto: tuple[str, ...] = ()) -> list:
    """``(module, class or None, function)`` of every test in
    tests/<name>.py (of the named classes only, when given), read from the
    source; those of the classes in ``crypto`` skip without the
    ``cryptography`` package."""
    tree = ast.parse((TESTS / f"{name}.py").read_text())
    out = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name.startswith("test") \
                and classes is None:
            out.append(pytest.param(name, None, node.name,
                                    id=f"{name}::{node.name}"))
        if not isinstance(node, ast.ClassDef) or not node.name.startswith(
                "Test") or (classes is not None and node.name not in classes):
            continue
        marks = [pytest.mark.skipif(
            not HAVE_CRYPTO, reason="needs the optional 'cryptography' "
            "package (ed25519)")] if node.name in crypto else []
        for m in node.body:
            if isinstance(m, ast.FunctionDef) and m.name.startswith("test"):
                out.append(pytest.param(name, node.name, m.name, marks=marks,
                                        id=f"{name}::{node.name}::{m.name}"))
    return out


# --- the observables --------------------------------------------------------

def plain(x):
    """``x`` as plain data that compares equal across the two packages: a
    dataclass as its class name and fields, an enum as its name, a set
    sorted, other containers element by element, and any other object
    (a callable, a node) as its type name."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if isinstance(x, (str, bytes, int, float, type(None))):
        return x
    if isinstance(x, dict):
        return [(plain(k), plain(v)) for k, v in x.items()]
    if isinstance(x, (set, frozenset)):
        return sorted((plain(v) for v in x), key=repr)
    if isinstance(x, (list, tuple)) or type(x).__name__ == "deque":
        return [plain(v) for v in x]
    return type(x).__name__


class _Tee:
    """An event tracer that records every event and passes it on to the
    tracer the test gave the node, if any."""

    def __init__(self, inner, events: list):
        self.inner = inner
        self.events = events

    def trace(self, evt: dict) -> None:
        self.events.append(evt)
        if self.inner is not None:
            self.inner.trace(evt)


class Recording:
    """What one run of a scenario built: its nodes (with their event
    streams), their subscriptions' deliveries and the score engines."""

    def __init__(self):
        self.nodes: list = []
        self.events: list[list] = []
        self.deliveries: list = []
        self.scores: list = []

    def observe(self) -> dict:
        routers = []
        for ps in self.nodes:
            rt = ps.rt
            routers.append({a: plain(getattr(rt, a)) for a in
                            ("mesh", "fanout", "backoff") if hasattr(rt, a)})
        scores = [[(p, sc.score(p)) for p in sorted(sc.peer_stats)]
                  for sc in self.scores]
        return {"nodes": [ps.pid for ps in self.nodes],
                "events": [plain(e) for e in self.events],
                "deliveries": _renumber_subs(self.deliveries),
                "routers": routers,
                "scores": scores}


@contextlib.contextmanager
def recording(pkg: str):
    """Record what the runtime of package ``pkg`` builds while the block
    runs (patches its classes, restored after)."""
    pubsub = M(pkg, "api.pubsub").PubSub
    sub = M(pkg, "api.subscription").Subscription
    score = M(pkg, "routers.score").PeerScore
    rec = Recording()
    ps_init, deliver, sc_init = pubsub.__init__, sub._deliver, score.__init__

    def _ps_init(self, host, router, *args, **kw):
        events: list = []
        kw["event_tracer"] = _Tee(kw.get("event_tracer"), events)
        rec.nodes.append(self)
        rec.events.append(events)
        ps_init(self, host, router, *args, **kw)

    def _deliver(self, msg):
        rec.deliveries.append((self.topic_handle.p.pid, self.topic, id(self),
                               plain(msg)))
        deliver(self, msg)

    def _sc_init(self, *args, **kw):
        rec.scores.append(self)
        sc_init(self, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pubsub, "__init__", _ps_init)
        mp.setattr(sub, "_deliver", _deliver)
        mp.setattr(score, "__init__", _sc_init)
        yield rec


def _renumber_subs(deliveries: list) -> list:
    """Subscription identities (``id()``) as their order of first
    delivery, so two runs' lists compare."""
    seen: dict = {}
    return [(pid, topic, seen.setdefault(sid, len(seen)), msg)
            for pid, topic, sid, msg in deliveries]


def run_case(name: str, cls: str | None, fn: str, pkg: str) -> dict:
    """Run one test of tests/<name>.py against package ``pkg`` and return
    what its swarm did."""
    mod = load_test_module(name, pkg)
    call = getattr(getattr(mod, cls)(), fn) if cls else getattr(mod, fn)
    with recording(pkg) as rec:
        call()
    return rec.observe()


def assert_same(want: dict, got: dict, where: str = "") -> None:
    """Equal observables, with the first difference named."""
    assert got["nodes"] == want["nodes"], where
    for key in ("events", "deliveries", "routers", "scores"):
        a, b = want[key], got[key]
        assert len(b) == len(a), (where, key, len(b), len(a))
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                if isinstance(x, list) and isinstance(y, list):
                    j = next((j for j, (u, v) in enumerate(zip(x, y))
                              if u != v), min(len(x), len(y)))
                    raise AssertionError(
                        f"{where}: {key}[{i}] differs at item {j} "
                        f"(lengths {len(y)} vs {len(x)}): port "
                        f"{y[j] if j < len(y) else None!r} vs reference "
                        f"{x[j] if j < len(x) else None!r}")
                raise AssertionError(f"{where}: {key}[{i}]: port {y!r} vs "
                                     f"reference {x!r}")


def check_differential(name: str, cls: str | None, fn: str) -> dict:
    want = run_case(name, cls, fn, REF)
    got = run_case(name, cls, fn, PORT)
    assert_same(want, got, f"{cls}.{fn}" if cls else fn)
    return want


RUNTIME_CASES = (
    collect_cases("test_functional_runtime",
               crypto=("TestSigning", "TestInvalidAuthor"))
    + collect_cases("test_adversarial_runtime"))


@pytest.mark.parametrize("name,cls,fn", RUNTIME_CASES)
def test_runtime_scenario_matches_reference(name, cls, fn):
    # a case that builds no node (a validation-pipeline lens) is held by
    # its own assertions, which run on both packages
    check_differential(name, cls, fn)


def test_case_list_covers_the_reference_classes():
    """The parametrisation spans the reference files' first to last class
    (a renamed or added class shows up here)."""
    ids = [p.id for p in RUNTIME_CASES]
    assert len(ids) == len(set(ids)) == 84
    classes = {i.split("::")[1] for i in ids}
    for c in ("TestFloodSub", "TestPublishReadiness",
              "TestIWantRetransmissionCutoff", "TestSybilCrossCheck"):
        assert c in classes


def test_rewritten_module_drives_the_port():
    """The rewritten test module really drives the port: its ``PubSub``,
    ``Network`` and router classes come from go_libp2p_pubsub_tpu_torch."""
    mod = load_test_module("test_functional_runtime", PORT)
    for obj in (mod.PubSub, mod.Network, mod.GossipSubRouter,
                mod.FloodSubRouter, mod.RandomSubRouter):
        assert obj.__module__.startswith(PORT + "."), obj
    ref = load_test_module("test_functional_runtime", REF)
    assert ref.PubSub.__module__.startswith(REF + ".api")
