"""The port's operator tools against the JAX side's, on the CPU:
go_libp2p_pubsub_tpu_torch/dashboard.py, directive_producer.py and
supervisor_smoke.py.

- the reference's dashboard tests (tests/test_telemetry.py's
  ``TestDashboard`` and live-tailer test, test_resilience.py's
  ``TestDashboardLiveness``, test_commands.py's ``TestDashboardIngest``,
  test_adversary.py's attack/contract render and test_verdict_plane.py's
  ``TestDashboardVerdicts``) run with their dashboard pointed at the port's:
  in process at a tee that returns the port's ``snapshot``/``render`` after
  holding them equal to the reference's on the same journal (one clock for
  both), and as ``python -m go_libp2p_pubsub_tpu_torch.dashboard`` where
  they run the script. Their journals are the reference's runs';
- journals the port's own ``supervised_run(device="cpu")`` wrote, a
  finished run, a paused window and a crashed run: the port's snapshot
  equals the reference's and its text equals the reference's but for the
  replay command, which names the port's ``replay_crash``; the module CLI,
  in a child where neither JAX nor the JAX package can be imported, prints
  the same snapshot;
- ``scenario_directives`` and ``--scenario`` streams equal the reference's,
  and ``--stream --from-offset`` copies equal the reference script's over
  a torn output tail;
- ``supervisor_smoke.run_smoke(device="cpu")`` passes every stage (the
  twin of tests/test_supervisor.py's ``test_full_ladder_smoke``).
"""

from __future__ import annotations

import ast
import contextlib
import functools
import importlib
import inspect
import json
import os
import pathlib
import re
import subprocess
import sys
import time
import types

import pytest

from go_libp2p_pubsub_tpu_torch import dashboard, directive_producer, rng
from go_libp2p_pubsub_tpu_torch import supervisor_smoke
from go_libp2p_pubsub_tpu_torch.sim import commands, scenarios
from go_libp2p_pubsub_tpu_torch.sim.supervisor import (SupervisorConfig,
                                                       SupervisorCrash,
                                                       supervised_run)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = pathlib.Path(__file__).resolve().parent
REF_REPLAY = "python scripts/replay_crash.py"
JAX_FREE = ("import runpy, sys; sys.modules['jax'] = None; "
            "sys.modules['go_libp2p_pubsub_tpu'] = None; "
            "sys.path.insert(0, %r); sys.argv[0] = 'dashboard'; "
            "runpy.run_module('go_libp2p_pubsub_tpu_torch.dashboard', "
            "run_name='__main__')")


def ref_dashboard():
    return importlib.import_module("scripts.dashboard")


@contextlib.contextmanager
def one_clock():
    """Both dashboards read one wall clock (heartbeat ages)."""
    now, real = time.time(), time.time
    time.time = lambda: now
    try:
        yield
    finally:
        time.time = real


def same_snapshot(path: str) -> dict:
    """The port's snapshot of ``path``, held equal to the reference's."""
    with one_clock():
        got = dashboard.snapshot(path)
        want = ref_dashboard().snapshot(path)
    assert got == want
    return got


def same_render(snap: dict) -> str:
    """The port's text of ``snap``, held equal to the reference's but for
    the replay command, which names the port's tool."""
    got = dashboard.render(snap)
    want = ref_dashboard().render(snap)
    assert got == want.replace(REF_REPLAY, dashboard.REPLAY_CMD)
    return got


def _tee() -> types.ModuleType:
    tee = types.ModuleType("_port_dashboard_tee")
    tee.__dict__.update({k: v for k, v in vars(dashboard).items()
                         if not k.startswith("__")})
    tee.snapshot = same_snapshot
    tee.render = same_render

    def decode_flags(flags, version=None):
        got = dashboard._decode_flags(flags, version)
        assert got == ref_dashboard()._decode_flags(flags, version)
        return got
    tee._decode_flags = decode_flags
    return tee


TEE = _tee()
sys.modules[TEE.__name__] = TEE

_LOADED = re.compile(
    r'(\w+) = importlib\.util\.spec_from_file_location\(\s*"graft_dashboard",'
    r'\s*os\.path\.join\(REPO, "scripts",\s*"dashboard\.py"\)\)\s*\n\s*'
    r'(\w+) = importlib\.util\.module_from_spec\(\1\)\s*\n\s*'
    r'\1\.loader\.exec_module\(\2\)')
_SCRIPT = re.compile(r'os\.path\.join\(REPO, "scripts",\s*"dashboard\.py"\)')


@functools.lru_cache(maxsize=None)
def load_on_port(name: str) -> types.ModuleType:
    """tests/<name>.py executed as a fresh module whose dashboard is the
    port's: the tee in process, the port's module CLI in a subprocess."""
    path = TESTS / f"{name}.py"
    src = _LOADED.sub(r"\2 = _PORT_DASHBOARD", path.read_text())
    src = re.sub(r"^(\s*)import dashboard$", r"\1dashboard = _PORT_DASHBOARD",
                 src, flags=re.M)
    src = src.replace("from scripts.dashboard import",
                      f"from {TEE.__name__} import")
    src = _SCRIPT.sub('"-m", "go_libp2p_pubsub_tpu_torch.dashboard"', src)
    assert "dashboard.py\"" not in src and "scripts.dashboard" not in src
    mod = types.ModuleType(f"_{name}__port_dashboard")
    mod.__file__ = str(path)
    mod._PORT_DASHBOARD = TEE
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


# the reference's dashboard tests: file -> class (None: module level) ->
# test names (None: every test of the class)
REFERENCE_TESTS = {
    "test_telemetry": {"TestDashboard": None, "TestEncodersAndJournal":
                       ("test_live_tailer_matches_full_read",)},
    "test_resilience": {"TestDashboardLiveness": None},
    "test_commands": {"TestDashboardIngest": None},
    "test_adversary": {"TestAttackTelemetry":
                       ("test_dashboard_renders_attacks_and_contracts",)},
    "test_verdict_plane": {"TestDashboardVerdicts": None},
}


def _reference_cases() -> list:
    out = []
    for name, classes in REFERENCE_TESTS.items():
        tree = ast.parse((TESTS / f"{name}.py").read_text())
        for node in tree.body:
            if not isinstance(node, ast.ClassDef) or node.name not in classes:
                continue
            wanted = classes[node.name]
            for m in node.body:
                if isinstance(m, ast.FunctionDef) and m.name.startswith(
                        "test") and (wanted is None or m.name in wanted):
                    out.append(pytest.param(
                        name, node.name, m.name,
                        id=f"{name}::{node.name}::{m.name}"))
    return out


@pytest.mark.parametrize("name,cls,test", _reference_cases())
def test_reference_dashboard_test_on_the_port(name, cls, test, tmp_path):
    mod = load_on_port(name)
    fn = getattr(getattr(mod, cls)(), test)
    kw = {"tmp_path": tmp_path} if "tmp_path" in inspect.signature(
        fn).parameters else {}
    fn(**kw)


def test_every_named_reference_test_was_found():
    names = {p.values[2] for p in _reference_cases()}
    assert len(names) == 15 and "test_live_tailer_matches_full_read" in names


# --- journals the port's supervised runs wrote -------------------------------

def _tiny():
    cfg, tp, st = scenarios.single_topic_1k(n_peers=64, k_slots=16,
                                            degree=6, device="cpu")
    return cfg, tp, st, rng.PRNGKey(0, device="cpu")


def _cli_snapshot(path: str) -> dict:
    """``python -m go_libp2p_pubsub_tpu_torch.dashboard PATH --once --json``
    in a child where JAX and the JAX package cannot be imported."""
    res = subprocess.run(
        [sys.executable, "-c", JAX_FREE % REPO, path, "--once", "--json"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stderr[-1500:]
    return json.loads(res.stdout)


@pytest.fixture(scope="module")
def port_journals(tmp_path_factory):
    """A finished run, a paused window and a crashed run of the port, each
    journaled by ``supervised_run(device="cpu")``."""
    d = tmp_path_factory.mktemp("journals")
    cfg, tp, st, key = _tiny()
    out = {}
    out["finished"] = str(d / "finished.jsonl")
    supervised_run(st, cfg, tp, key, 6, SupervisorConfig(
        chunk_ticks=3, health_path=out["finished"],
        scenario="single_topic_1k"), device="cpu")
    out["paused"] = str(d / "paused.jsonl")
    supervised_run(st, cfg, tp, key, 6, SupervisorConfig(
        chunk_ticks=3, health_path=out["paused"], max_chunks=1,
        checkpoint_dir=str(d / "ck"), scenario="single_topic_1k"),
        device="cpu")
    out["crashed"] = str(d / "crashed.jsonl")

    def boom(info):
        if info["chunk_start"] >= 3:
            raise RuntimeError("injected permanent failure")
    with pytest.raises(SupervisorCrash):
        supervised_run(st, cfg, tp, key, 6, SupervisorConfig(
            chunk_ticks=3, health_path=out["crashed"], max_retries=0,
            sleep=lambda s: None, crash_dir=str(d / "crash"),
            scenario="single_topic_1k"), device="cpu", _chunk_hook=boom)
    return out


@pytest.mark.parametrize("kind", ["finished", "paused", "crashed"])
def test_port_journal_renders_as_the_reference(port_journals, kind):
    path = port_journals[kind]
    snap = same_snapshot(path)
    text = same_render(snap)
    assert snap["run"]["scenario"] == "single_topic_1k"
    assert snap["fault_flags"] == 0 and snap["fault_flag_names"] == []
    assert 0.0 <= snap["delivery_frac"] <= 1.0
    if kind == "finished":
        assert snap["tick"] == 5 and snap["rows"] == 6 and snap["done"]
        assert "[ENDED]" in text and "mesh degree" in text
    elif kind == "paused":
        assert snap["paused"] and not snap["done"] and snap["tick"] == 2
        assert "PAUSED (resumable)" in text
    else:
        (crash,) = snap["crashes"]
        assert crash["tick"] == 3 and crash["dump"]
        assert f"replay: {dashboard.REPLAY_CMD} {crash['dump']}" in text
        assert "scripts/" not in text
    assert _cli_snapshot(path) == json.loads(json.dumps(snap))


def test_decoded_flags_are_names(port_journals, tmp_path):
    """A poisoned row's health word decodes to names, as the reference's."""
    lines = open(port_journals["finished"]).read().splitlines()
    rows = [json.loads(ln) for ln in lines]
    last = max(i for i, r in enumerate(rows) if r.get("kind") == "health")
    rows[last]["fault_flags"] = (1 << 0) | (1 << 16)
    path = tmp_path / "poisoned.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    snap = same_snapshot(str(path))
    names = snap["fault_flag_names"]
    assert names and not any(n.startswith("0x") for n in names)
    assert " ".join(names) in same_render(snap)
    assert _cli_snapshot(str(path))["fault_flag_names"] == names


# --- the directive producer --------------------------------------------------

def ref_producer():
    return importlib.import_module("scripts.directive_producer")


PRODUCER_CASES = [("eclipse_censor", dict(at=4, region=8, attackers=8,
                                          bursts=3)),
                  ("eclipse_censor", dict(at=0, region=1, attackers=1,
                                          bursts=1)),
                  ("storm_red", dict(at=4, region=8, attackers=32,
                                     bursts=3)),
                  ("storm_red", dict(at=9, region=2, attackers=5,
                                     bursts=1))]


@pytest.mark.parametrize("name,kw", PRODUCER_CASES)
def test_scenario_directives_equal_the_reference(name, kw, tmp_path):
    from go_libp2p_pubsub_tpu.sim import commands as jcmds
    want = ref_producer().scenario_directives(name, **kw)
    assert directive_producer.scenario_directives(name, **kw) == want
    out = tmp_path / "port.ndjson"
    args = ["--scenario", name, "--out", str(out)]
    for k, v in kw.items():
        args += [f"--{k}", str(v)]
    assert directive_producer.main(args) == 0
    jcmds.write_stream(str(tmp_path / "ref.ndjson"), want, end=True)
    assert out.read_bytes() == (tmp_path / "ref.ndjson").read_bytes()
    # and the port's queue parses it
    q = commands.CommandQueue(str(out), n_peers=64, n_topics=1,
                              msg_window=64, stall_timeout_s=5.0).start(0)
    try:
        frame = q.frame_for(0, kw["at"] + kw["bursts"] + 1)
    finally:
        q.close()
    assert frame.count > 0


def test_unknown_scenario_refused():
    with pytest.raises(ValueError, match="storm_red"):
        directive_producer.scenario_directives("nope", at=0, region=0,
                                               attackers=0, bursts=0)


@pytest.mark.parametrize("offset_lines,torn", [(0, b""), (3, b""),
                                               (3, b'{"op": "pub')])
def test_stream_copy_equals_the_reference_script(tmp_path, offset_lines,
                                                 torn):
    """``--stream`` from an offset over an output holding a torn tail:
    the port's copy and the reference script's are byte-equal, and equal
    to the input."""
    src = tmp_path / "in.ndjson"
    commands.write_stream(str(src), [
        {"op": "publish", "tick": t, "peer": t, "topic": 0}
        for t in range(8)])
    lines = src.read_bytes().splitlines(keepends=True)
    offset = sum(len(x) for x in lines[:offset_lines])
    outs = {}
    for who in ("port", "ref"):
        out = tmp_path / f"{who}.ndjson"
        out.write_bytes(b"".join(lines[:offset_lines]) + torn)
        args = ["--stream", str(src), "--out", str(out),
                "--from-offset", str(offset)]
        if who == "port":
            assert directive_producer.main(args) == 0
        else:
            res = subprocess.run(
                [sys.executable, os.path.join(REPO, "scripts",
                                              "directive_producer.py")]
                + args, capture_output=True, text=True, timeout=120)
            assert res.returncode == 0, res.stderr[-800:]
        outs[who] = out.read_bytes()
    assert outs["port"] == outs["ref"] == src.read_bytes()


# --- the supervised ladder ---------------------------------------------------

def test_full_ladder_smoke(tmp_path):
    lines, finals = [], {}
    assert supervisor_smoke.run_smoke(str(tmp_path), emit=lines.append,
                                      device="cpu", finals=finals) == 0
    stages = [json.loads(ln) for ln in lines]
    assert [s["stage"] for s in stages] == [
        "deadline_backoff_degrade", "checkpoint_resume",
        "crash_dump_replay", "chaos_stall_recovery"]
    assert all(s["status"] == "ok" for s in stages)
    assert stages[0]["device"] == "cpu" and stages[0]["rung"] == "mode"
    assert sorted(finals) == ["chaos_stall_recovery", "checkpoint_resume",
                              "deadline_backoff_degrade", "plain"]
    assert int(finals["plain"].tick) == supervisor_smoke.N_TICKS
