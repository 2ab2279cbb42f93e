"""Replay a supervisor crash dump: re-run the exact failing tick window
from the last-good checkpoint with invariants raised (port of
scripts/replay_crash.py).

    python -m go_libp2p_pubsub_tpu_torch.replay_crash CRASH_DIR
        [--scenario NAME] [--kwargs '{"n_peers": 512}'] [--record]
        [--member I]

A dump (sim/supervisor.py ``_write_crash_dump``) holds the last-good
state, the failing window's per-tick keys, the config fingerprint and the
decoded health word. :func:`replay` restores the state, swaps
``invariant_mode="raise"`` into the config and drives
``engine.run_checked_keys`` over the recorded keys: a deterministic
re-run of precisely the ticks that killed the run, each violation raised
on the host with its flags. Fleet dumps (sim/fleet.py, ``crash_fleet_*``)
carry a ``[B]``-batched last-good state and ``[C, B_active]`` keys;
:func:`replay_fleet` restores one member (by INPUT index) and replays its
window alone. A dump either package wrote replays in the other: the
``.npz`` checkpoints, the config fingerprint and the keys' uint32 words
are the reference's.

:func:`replay` and :func:`replay_fleet` take the member's ``like``/
``cfg``/``tp`` objects, or :func:`replay` rebuilds them from the scenario
the supervisor stamped into crash.json (a ``sim.scenarios.SCENARIOS``
name and its keyword arguments). ``--scenario``/``--kwargs`` override the
stamp; fleet dumps stamp none, so ``--member`` needs ``--scenario``.
Exit status: 0 clean replay, 3 the invariant trip reproduced, 1 usage or
config errors.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

def load_meta(crash_dir: str) -> dict:
    with open(os.path.join(crash_dir, "crash.json")) as f:
        return json.load(f)


def _check_flags_version(meta: dict, crash_dir: str) -> None:
    """Refuse BY NAME to replay a dump recorded under another fault_flags
    bit layout (sim/invariants.FLAGS_VERSION); dumps from before
    versioning pass."""
    from .sim.invariants import FLAGS_VERSION
    ver = meta.get("flags_version")
    if ver is not None and int(ver) != FLAGS_VERSION:
        raise SystemExit(
            f"crash dump {crash_dir!r} was recorded under flags_version="
            f"{int(ver)} but this build decodes flags_version="
            f"{FLAGS_VERSION} — the fault_flags bit layouts differ; "
            "replay it with the build that wrote it instead of "
            "misreading its bits")


def build_scenario(name: str, kwargs: dict | None, device=None) -> tuple:
    """``(cfg, tp, like)`` of the ``SCENARIOS`` entry ``name`` on
    ``device``; an unknown name raises SystemExit naming the known ones."""
    from .sim import scenarios
    if name not in scenarios.SCENARIOS:
        raise SystemExit(f"unknown scenario {name!r}; known: "
                         f"{sorted(scenarios.SCENARIOS)}")
    return scenarios.SCENARIOS[name](**(kwargs or {}), device=device)


def _keys(data, device):
    import numpy as np
    import torch
    words = np.asarray(data, dtype=np.uint32).astype(np.int64)
    return torch.from_numpy(words).to(device)


def _run_window(state, cfg, tp, keys, invariant_mode: str, device,
                result: dict) -> dict:
    import numpy as np

    from .sim.engine import run_checked_keys, run_keys
    from .sim.hostio import fetch_local
    from .sim.invariants import InvariantViolation, decode_flags
    replay_cfg = dataclasses.replace(cfg, invariant_mode=invariant_mode)
    try:
        if invariant_mode == "raise":
            out = run_checked_keys(state, replay_cfg, tp, keys,
                                   device=device)
        else:
            out = run_keys(state, replay_cfg, tp, keys, device=device)
        flags = int(fetch_local(out.fault_flags, np.uint32))
        result.update(tripped=False, fault_flags=flags,
                      fault_flag_names=decode_flags(flags))
    except InvariantViolation as e:
        result.update(tripped=True, error=str(e)[:500])
    return result


def replay(crash_dir: str, like=None, cfg=None, tp=None,
           invariant_mode: str = "raise", device=None) -> dict:
    """Re-run the dump's failing window on ``device`` (cuda unless the
    caller passes ``device="cpu"``); returns a record with ``tripped``
    (did the invariant trip reproduce), the final ``fault_flags`` when it
    did not, and the window bounds. ``like`` (a state of the run's shape,
    on ``device``), ``cfg`` and ``tp`` describe the run; without them they
    are rebuilt from the scenario stamped into crash.json."""
    from .sim import checkpoint

    meta = load_meta(crash_dir)
    _check_flags_version(meta, crash_dir)
    if cfg is None or like is None or tp is None:
        name = meta.get("scenario")
        if not name:
            raise SystemExit(
                "crash.json carries no scenario metadata; pass --scenario "
                "(and --kwargs) or call replay() with like/cfg/tp objects")
        cfg, tp, like = build_scenario(name, meta.get("scenario_kwargs"),
                                       device)
    want = meta.get("config_fingerprint")
    got = checkpoint.config_fingerprint(cfg)
    if want and got != want:
        raise SystemExit(
            f"config fingerprint {got[:12]}… does not match the dump's "
            f"{want[:12]}… — wrong scenario/kwargs; replaying under a "
            "drifted config would not reproduce the crash")
    state = checkpoint.restore(os.path.join(crash_dir, "last_good"), like,
                               cfg=cfg)
    keys = _keys(meta["window_key_data"], state.tick.device)
    result = {"crash_dir": crash_dir, "tick_start": meta["tick_start"],
              "tick_end": meta["tick_end"], "ticks": int(keys.shape[0]),
              "invariant_mode": invariant_mode,
              "original_error": meta.get("error", "")[:200]}
    return _run_window(state, cfg, tp, keys, invariant_mode, device, result)


def is_fleet_dump(meta: dict) -> bool:
    return "fleet_size" in meta


def replay_fleet(crash_dir: str, member: int, like=None, cfg=None, tp=None,
                 invariant_mode: str = "raise", device=None) -> dict:
    """Restore member ``member`` (its INPUT index, as the dump's
    ``member_ids`` name it) out of a fleet crash dump's batched last-good
    state and re-run its slice of the failing window. ``like``/``cfg``/
    ``tp`` describe ONE member (what its ``FleetMember`` carried); the
    fleet-axis bound fingerprint is checked against its config as the
    member executed it (raise-mode members run ``"record"``)."""
    from .sim import checkpoint
    from .sim.fleet import _exec_cfg, member_state, stack_states

    meta = load_meta(crash_dir)
    _check_flags_version(meta, crash_dir)
    if not is_fleet_dump(meta):
        raise SystemExit(f"{crash_dir!r} is not a fleet dump; run without "
                         "--member")
    if like is None or cfg is None or tp is None:
        raise SystemExit(
            "fleet dumps carry no scenario metadata (members may mix "
            "configs); pass --scenario/--kwargs or call replay_fleet() "
            "with like/cfg/tp objects for the member being replayed")
    b = int(meta["fleet_size"])
    ids = meta.get("member_ids")
    if ids is not None:
        if member not in ids:
            raise SystemExit(
                f"--member {member} is not in this dump's config group "
                f"(member_ids: {ids}, names: {meta.get('member_names')}) — "
                "a mixed-config fleet writes one dump per group")
        gpos = ids.index(member)
    else:
        gpos = member
    if not 0 <= gpos < b:
        raise SystemExit(f"--member {member} outside fleet of {b} "
                         f"(members: {meta.get('member_names')})")
    group_cfg = _exec_cfg(cfg)
    want = meta.get("config_fingerprint")
    got = checkpoint.config_fingerprint(group_cfg, fleet=b)
    if want and got != want:
        raise SystemExit(
            f"fleet config fingerprint {got[:12]}… does not match the "
            f"dump's {want[:12]}… — replaying under a drifted config "
            "would not reproduce the crash")
    full = checkpoint.restore(os.path.join(crash_dir, "last_good"),
                              stack_states([like] * b), cfg=group_cfg)
    state = member_state(full, gpos)
    active = meta.get("active_members", list(range(b)))
    if gpos not in active:
        raise SystemExit(
            f"member {member} was not active in the failing window "
            f"(active group positions: {active}) — it had finished or was "
            "retired; its keys are not in the dump")
    keys = _keys(meta["window_key_data"], state.tick.device)[
        :, active.index(gpos)]
    result = {"crash_dir": crash_dir, "member": member,
              "member_name": (meta.get("member_names") or [None] * b)[gpos],
              "tick_start": meta.get("window_start"),
              "tick_end": meta.get("window_end"),
              "ticks": int(keys.shape[0]),
              "invariant_mode": invariant_mode,
              "original_error": meta.get("error", "")[:200]}
    return _run_window(state, group_cfg, tp, keys, invariant_mode, device,
                       result)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("crash_dir")
    ap.add_argument("--scenario", default=None,
                    help="sim.scenarios.SCENARIOS key (default: from dump)")
    ap.add_argument("--kwargs", default=None,
                    help="JSON dict of scenario builder kwargs")
    ap.add_argument("--device", default=None,
                    help="where to replay (default: cuda)")
    ap.add_argument("--record", action="store_true",
                    help="replay in record mode (collect flags, no raise)")
    ap.add_argument("--member", type=int, default=None,
                    help="fleet dumps: which member (input index) to "
                         "restore and replay")
    args = ap.parse_args(argv)
    mode = "record" if args.record else "raise"
    meta = load_meta(args.crash_dir)
    if is_fleet_dump(meta) and args.member is None:
        print(json.dumps({
            "error": "fleet crash dump: pass --member to pick the lane",
            "fleet_size": meta.get("fleet_size"),
            "member_names": meta.get("member_names"),
            "active_members": meta.get("active_members")}), flush=True)
        return 1
    from .sim import scenarios
    if args.scenario and args.scenario not in scenarios.SCENARIOS:
        print(json.dumps({"error": f"unknown scenario {args.scenario!r}",
                          "known": sorted(scenarios.SCENARIOS)}), flush=True)
        return 1
    kwargs = json.loads(args.kwargs) if args.kwargs else {}
    try:
        if args.member is not None:
            if not args.scenario:
                print(json.dumps({"error": "--member needs --scenario (fleet "
                                  "dumps carry no scenario metadata)"}),
                      flush=True)
                return 1
            cfg, tp, like = build_scenario(args.scenario, kwargs, args.device)
            result = replay_fleet(args.crash_dir, args.member, like=like,
                                  cfg=cfg, tp=tp, invariant_mode=mode,
                                  device=args.device)
        elif args.scenario:
            # the command line overrides the dump's stamp (the dump itself
            # is never changed)
            cfg, tp, like = build_scenario(args.scenario, kwargs, args.device)
            result = replay(args.crash_dir, like=like, cfg=cfg, tp=tp,
                            invariant_mode=mode, device=args.device)
        else:
            result = replay(args.crash_dir, invariant_mode=mode,
                            device=args.device)
    except SystemExit as e:
        print(json.dumps({"error": str(e)}), flush=True)
        return 1
    print(json.dumps(result), flush=True)
    return 3 if result.get("tripped") else 0


if __name__ == "__main__":
    sys.exit(main())
