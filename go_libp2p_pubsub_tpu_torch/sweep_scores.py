"""Peer-score / gater parameter sweep: delivery against attack resistance
(port of scripts/sweep_scores.py).

    python -m go_libp2p_pubsub_tpu_torch.sweep_scores [--device cpu]
        [--n 512] [--ticks 40] [--seeds 2]
        [--scenarios sybil_small,eclipse_small] [--variants baseline,...]
        [--journal PATH] [--table PATH]

A grid of score-weight VARIANTS x small-N attack scenarios x seeds, where
every cell is a fleet member (sim/fleet.py) and each scenario's cells run
as one ``supervised_fleet_run``: the P1-P4 variants share a config and
batch into one fleet group; the P5-P7 and gater variants change the
config and land in their own groups.

Each (scenario, variant) cell reports:

- ``delivery``: settled delivery fraction over the whole run (the attack
  window included: the damage the attack did),
- ``resistance``: for sybil, 1 - (share of honest peers' mesh slots held
  by sybils); for the fault families, the settled delivery of messages
  published after the plan's last window ends (None when that census is
  empty),
- the fault_flags union of its members, and for the adversary families
  (sim/adversary.py) how many member-contract pairs failed and of which
  kinds, judged on each member's telemetry rows.

The sweep resumes from a journal: each completed scenario's rows are
fsync-appended to ``--journal`` with the env fingerprint (grid knobs and
the device type) and the variant's spec, and a rerun takes every matching
row from it instead of running its fleet. A CPU journal never stands in
for a card run. ``--table PATH`` writes the Pareto table (``render_table``)
between markers in the file the user names. Runs on the card unless the
caller passes ``--device cpu``.

Env fallbacks: SWEEP_N, SWEEP_TICKS, SWEEP_SEEDS, SWEEP_SCENARIOS,
SWEEP_VARIANTS, SWEEP_JOURNAL.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np

# variant spec: keys in sim.config.SCORE_WEIGHT_KEYS ride with_score_weights
# (p1..p4: TopicParams rows, one fleet group; p5..p7: SimConfig floats, a
# group of their own); everything else is a plain SimConfig override
VARIANTS = {
    "baseline": {},
    "p1_off": {"p1": 0.0},
    "p2_heavy": {"p2": 4.0},
    "p3_off": {"p3": 0.0, "p3b": 0.0},
    "p4_harsh": {"p4": -40.0},
    "p6_harsh": {"p6": -200.0},
    "p7_harsh": {"p7": -40.0},
    "gater_on": {"gater_enabled": True, "validation_queue_cap": 64},
}

SCENARIO_NAMES = ("sybil_small", "partition_small", "outage_small")
# the adversary families (sim/adversary.py): their cells also evaluate the
# scenario's behavior contracts per member
ATTACK_SCENARIOS = ("eclipse_small", "censor_small", "flashcrowd_small",
                    "slowlink_small", "diurnal_small")
SEED_KEY_BASE = 271828

TABLE_BEGIN = "<!-- sweep_scores:frontier:begin -->"
TABLE_END = "<!-- sweep_scores:frontier:end -->"


def apply_variant(cfg, tp, spec: dict):
    """Split a variant spec into score-weight overrides (P1-P7 via
    ``with_score_weights``) and plain SimConfig overrides; apply both."""
    from .sim.config import SCORE_WEIGHT_KEYS, with_score_weights
    weights = {k: v for k, v in spec.items() if k in SCORE_WEIGHT_KEYS}
    extra = {k: v for k, v in spec.items() if k not in SCORE_WEIGHT_KEYS}
    if weights:
        tp, cfg = with_score_weights(tp, cfg=cfg, **weights)
    if extra:
        cfg = dataclasses.replace(cfg, **extra)
    return cfg, tp


def _sybil_mesh_share(state) -> float:
    """Share of honest peers' mesh slots held by malicious neighbors: the
    eviction metric, which scoring that works drives to ~0."""
    n = state.neighbors.shape[0]
    nbr_mal = state.malicious[state.neighbors.clamp(0, n - 1).long()] \
        & (state.neighbors >= 0)                            # [N, K]
    honest_mesh = state.mesh & (~state.malicious)[:, None, None]
    bad = honest_mesh & nbr_mal[:, None, :]
    return float(bad.sum() / honest_mesh.sum().clamp(min=1))


def _recovery_fraction(state, cfg, heal_tick: int) -> float | None:
    """Settled delivery over messages published at or after ``heal_tick``;
    None when that census is empty (the run ended before heal + settle: a
    silent 0.0 would read as no recovery)."""
    from .sim.state import unpack_have
    age = state.tick - state.msg_publish_tick
    alive = (age < cfg.history_length) & (age >= 2) \
        & (state.msg_publish_tick >= heal_tick)
    t_m = state.msg_topic.clamp(0, cfg.n_topics - 1).long()
    should = state.subscribed[:, t_m] \
        & (alive & (state.msg_topic >= 0))[None, :]
    denom = int(should.sum())
    if denom == 0:
        return None
    have = unpack_have(state, cfg.msg_window)
    return float((have & should).sum() / denom)


def _heal_tick(cfg) -> int:
    """The tick the member's own FaultPlan ends its last window
    (``faults.attack_end_tick``; 0 for window-free plans, which makes the
    recovery census the whole settled run)."""
    from .sim.faults import attack_end_tick
    return attack_end_tick(cfg.fault_plan)


def cell_metrics(scenario: str, res, cfg) -> dict:
    from .sim.engine import delivery_fraction
    delivery = float(delivery_fraction(res.state, cfg, min_age_ticks=2))
    if scenario == "sybil_small":
        resistance = 1.0 - _sybil_mesh_share(res.state)
    else:
        resistance = _recovery_fraction(res.state, cfg, _heal_tick(cfg))
    return {"delivery": round(delivery, 4),
            "resistance": None if resistance is None
            else round(resistance, 4)}


def _env_fingerprint(n: int, ticks: int, seeds: int, device) -> dict:
    return {"n": n, "ticks": ticks, "seeds": seeds,
            "platform": device.type}


def _journal_load(path: str | None, env: dict) -> dict:
    """{(scenario, variant): row} of the records whose env and variant spec
    match this run (torn tail lines are skipped: their cells run again)."""
    recs: dict = {}
    if path and os.path.exists(path):
        with open(path) as f:
            for ln in f:
                try:
                    r = json.loads(ln)
                except json.JSONDecodeError:
                    continue
                if r.get("env") == env and "row" in r \
                        and r.get("spec") == VARIANTS.get(r.get("variant")):
                    recs[(r["scenario"], r["variant"])] = r["row"]
    return recs


def _journal_append(path: str | None, scenario: str, variant: str,
                    env: dict, row: dict) -> None:
    if not path:
        return
    with open(path, "a") as f:
        f.write(json.dumps({"scenario": scenario, "variant": variant,
                            "spec": VARIANTS.get(variant), "env": env,
                            "row": row}) + "\n")
        f.flush()
        os.fsync(f.fileno())


def run_sweep(scenario_names=None, variant_names=None, *, n: int = 512,
              ticks: int = 40, seeds: int = 2, journal: str | None = None,
              emit=print, sup=None, device=None, on_fleet=None) -> list:
    """Run the grid's missing cells, one ``supervised_fleet_run`` per
    scenario on ``device`` (cuda unless the caller passes ``"cpu"``), each
    scenario's rows journaled as soon as its fleet completes, and return
    the rows in (scenario, variant) order. A kill mid-sweep loses at most
    the scenario in flight. ``on_fleet(scenario, members, results)``, when
    given, sees each fleet's members and results before their rows are
    made."""
    from . import rng
    from .device import resolve_device
    from .sim import adversary
    from .sim import scenarios as scen_mod
    from .sim.fleet import FleetMember, supervised_fleet_run
    from .sim.invariants import decode_flags
    from .sim.supervisor import SupervisorConfig

    dev = resolve_device(device)
    scenario_names = list(scenario_names or SCENARIO_NAMES)
    variant_names = list(variant_names or VARIANTS)
    env = _env_fingerprint(n, ticks, seeds, dev)
    recorded = _journal_load(journal, env)

    rows = []
    for scen in scenario_names:
        # the adversary families carry behavior contracts: their fleets run
        # on the telemetry lane, for at least the attack's own n_ticks (the
        # contracts' decision ticks may lie past the grid's default)
        scen_ticks = ticks
        contracts = ()
        if scen in adversary.ATTACKS:
            attack = adversary.ATTACKS[scen](n_peers=n, device=dev)
            contracts = attack.contracts
            scen_ticks = max(ticks, attack.n_ticks)

        members, cells, cfgs = [], [], {}
        for var in variant_names:
            if (scen, var) in recorded:
                emit(json.dumps({"info": "journal skip", "scenario": scen,
                                 "variant": var}))
                continue
            cfg, tp, st = scen_mod.SCENARIOS[scen](n_peers=n, device=dev)
            cfg, tp = apply_variant(cfg, tp, VARIANTS[var])
            cfgs[var] = cfg
            for s in range(seeds):
                members.append(FleetMember(
                    cfg, tp, st, rng.PRNGKey(SEED_KEY_BASE + s, device=dev),
                    scen_ticks, name=f"{scen}/{var}/s{s}"))
                cells.append(var)

        by_cell: dict = {}
        if members:
            t0 = time.perf_counter()
            results, report = supervised_fleet_run(
                members, sup or SupervisorConfig.from_env(),
                collect_health=bool(contracts), device=dev)
            groups = next((len(e["sizes"]) for e in report.events
                           if e["event"] == "fleet_plan"), 0)
            emit(json.dumps({"info": "fleet done", "scenario": scen,
                             "members": len(members), "groups": groups,
                             "member_ticks": report.ticks_run,
                             "seconds": round(time.perf_counter() - t0, 3)}))
            if on_fleet is not None:
                on_fleet(scen, members, results)
            for var, res in zip(cells, results):
                by_cell.setdefault(var, []).append(res)

        for var in variant_names:
            if (scen, var) in recorded:
                rows.append(recorded[(scen, var)])
                emit(json.dumps(recorded[(scen, var)]))
                continue
            cell_res = by_cell[var]
            mets = [cell_metrics(scen, r, cfgs[var]) for r in cell_res]
            flags = int(np.bitwise_or.reduce(np.asarray(
                [r.fault_flags for r in cell_res], np.uint32)))
            resist = [m["resistance"] for m in mets]
            row = {
                "scenario": scen, "variant": var,
                "delivery": round(float(np.mean(
                    [m["delivery"] for m in mets])), 4),
                "resistance": None if any(r is None for r in resist)
                else round(float(np.mean(resist)), 4),
                "fault_flags": flags,
                "fault_flag_names": decode_flags(flags),
                "tripped": any(r.tripped for r in cell_res),
                "seeds": seeds, "n": n, "ticks": scen_ticks,
            }
            if contracts:
                failed = []
                for r in cell_res:
                    for c in adversary.evaluate_contracts(
                            contracts, r.health_rows or [], final=True):
                        if not c.passed:
                            failed.append(c.kind)
                row["contracts"] = len(contracts) * len(cell_res)
                row["contracts_failed"] = len(failed)
                row["contracts_failed_kinds"] = sorted(set(failed))
            rows.append(row)
            emit(json.dumps(row))
            _journal_append(journal, scen, var, env, row)
    return rows


def _pareto(rows: list) -> set:
    """Indices of the non-dominated (delivery, resistance) points; rows
    with an empty resistance census (None) are out of the running."""
    out = set()
    comp = [r for r in rows if r["resistance"] is not None]
    for i, a in enumerate(rows):
        if a["resistance"] is None:
            continue
        dominated = any(
            (b["delivery"] >= a["delivery"]
             and b["resistance"] >= a["resistance"]
             and (b["delivery"] > a["delivery"]
                  or b["resistance"] > a["resistance"]))
            for b in comp)
        if not dominated:
            out.add(i)
    return out


def render_table(rows: list, platform: str) -> str:
    """The rows as a markdown table, the Pareto points of each scenario
    marked; ``platform`` names the device type the rows ran on."""
    if not rows:
        return "(no sweep rows)"
    meta = rows[0]
    lines = [
        f"Grid: {meta['seeds']} seed(s) x {meta['ticks']} ticks at "
        f"N={meta['n']} per member, platform={platform} "
        "(`python -m go_libp2p_pubsub_tpu_torch.sweep_scores`). `frontier` "
        "marks the Pareto-optimal (delivery, resistance) points per "
        "scenario.",
        "",
        "| scenario | variant | delivery | resistance | frontier | flags |",
        "|---|---|---|---|---|---|",
    ]
    for scen in dict.fromkeys(r["scenario"] for r in rows):
        sub = [r for r in rows if r["scenario"] == scen]
        front = _pareto(sub)
        for i, r in enumerate(sub):
            flg = ",".join(r.get("fault_flag_names", [])) or "-"
            res = "n/a" if r["resistance"] is None \
                else f"{r['resistance']:.4f}"
            lines.append(
                f"| {scen} | {r['variant']} | {r['delivery']:.4f} | "
                f"{res} | {'*' if i in front else ''} | {flg} |")
    return "\n".join(lines)


def write_table(rows: list, path: str, platform: str) -> None:
    """Write the table between the sweep markers in ``path``: replace the
    block where the markers exist, else append it (a new file holds the
    block alone). The file is replaced atomically."""
    block = f"{TABLE_BEGIN}\n{render_table(rows, platform)}\n{TABLE_END}"
    text = ""
    if os.path.exists(path):
        with open(path) as f:
            text = f.read()
    if TABLE_BEGIN in text and TABLE_END in text:
        head, rest = text.split(TABLE_BEGIN, 1)
        _, tail = rest.split(TABLE_END, 1)
        text = head + block + tail
    elif text:
        text = text.rstrip("\n") + "\n\n" + block + "\n"
    else:
        text = block + "\n"
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int,
                    default=int(os.environ.get("SWEEP_N", 512)))
    ap.add_argument("--ticks", type=int,
                    default=int(os.environ.get("SWEEP_TICKS", 40)))
    ap.add_argument("--seeds", type=int,
                    default=int(os.environ.get("SWEEP_SEEDS", 2)))
    ap.add_argument("--scenarios",
                    default=os.environ.get("SWEEP_SCENARIOS", ""))
    ap.add_argument("--variants",
                    default=os.environ.get("SWEEP_VARIANTS", ""))
    ap.add_argument("--journal",
                    default=os.environ.get("SWEEP_JOURNAL", ""))
    ap.add_argument("--table", default="",
                    help="write the frontier table into this file")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from .device import resolve_device
    dev = resolve_device(args.device)
    rows = run_sweep(
        [s for s in args.scenarios.split(",") if s] or None,
        [v for v in args.variants.split(",") if v] or None,
        n=args.n, ticks=args.ticks, seeds=args.seeds,
        journal=args.journal or None, device=dev)
    if args.table:
        write_table(rows, args.table, dev.type)
        print(json.dumps({"info": "table written", "path": args.table,
                          "rows": len(rows)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
