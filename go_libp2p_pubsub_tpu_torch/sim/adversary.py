"""Adversary & workload library: attack scenarios with enforced behaviour
contracts (port of sim/adversary.py).

Five scenario families, each a constructor returning an
:class:`AttackScenario`: ``(cfg, tp, state)`` exactly like a
``sim.scenarios`` builder, plus the machine-checkable behaviour contracts
the run must satisfy and the recommended run length. The attack schedules
ride ``sim.faults``' ``FaultPlan`` families:

- :func:`eclipse`: sybil mesh takeover of a target peer region
  (``FaultPlan.eclipses``). Contracts: network delivery floor during the
  attack, recovery ceiling after the heal, sybils graylisted and honest
  peers not.
- :func:`censorship`: score-gamed IWANT starvation of a victim publisher
  (``FaultPlan.censorships`` plus a victim-centred publish storm).
  Contracts: the victim's topic keeps a delivery floor and the censors
  are graylisted while honest peers are not.
- :func:`flash_crowd`: a hot-topic publish storm with a skewed publisher
  distribution (``FaultPlan.storms``). Contracts: delivery floor under
  load, recovery ceiling after the storm.
- :func:`slow_link`: heterogeneous per-edge delay/drop classes
  (``FaultPlan.slowlinks``). Contracts: delivery floor, and no honest peer
  graylisted.
- :func:`diurnal`: scheduled join/leave waves (``FaultPlan.waves``).
  Contracts: delivery floor across the waves, recovery ceiling after the
  last.

**Contracts** are declarative and JSON-serialisable (journal headers; the
port's dashboard, ``python -m go_libp2p_pubsub_tpu_torch.dashboard``, reads
them from a journal of either package), and are evaluated from the per-tick
telemetry rows (sim/telemetry.py): in a batch (:func:`evaluate_contracts`,
:func:`run_with_contracts`) or folded one row at a time by
:class:`ContractMonitors` (the supervisor's live verdicts), bit-exact
against the batch at every prefix of a tick-monotone stream.
The contracts and monitors are host code, copied from the reference.

The builders take the port's ``device=`` (cuda unless the caller passes
``device="cpu"``) and ``topo=`` (a prebuilt
``topology.sparse(n_peers, k_slots, degree=degree, seed=SEED)``; ``None``
builds exactly the reference's underlay).

Positive control: :class:`ScoreResponse` fails when scoring is disabled.
"""

from __future__ import annotations

import base64
import dataclasses
import json

import numpy as np
import torch

from .config import SimConfig, TopicParams
from .faults import (
    CensorWindow,
    ChurnWave,
    EclipseWindow,
    FaultPlan,
    SlowLinkClass,
    StormWindow,
    attack_end_tick,
)
from .scenarios import SEED, _topology, default_topic_params
from .state import SimState, init_state

# ---------------------------------------------------------------------------
# contracts


@dataclasses.dataclass(frozen=True)
class ContractResult:
    """One contract's verdict over a row stream. ``status`` is ``"pass"``
    / ``"fail"`` / ``"pending"`` (pending = the stream hasn't reached the
    contract's decision tick yet — only possible with ``final=False``,
    the live-dashboard mode; a FINAL stream that never reaches the
    decision tick fails by name, so a too-short run can't silently
    pass)."""

    kind: str
    status: str
    detail: str
    measured: dict

    @property
    def passed(self) -> bool:
        return self.status == "pass"


def _row_delivery(row: dict, topic) -> float:
    if topic is not None:
        return row.get(f"delivery_frac_t{topic}", 0.0)
    vals, t = [], 0
    while f"delivery_frac_t{t}" in row:
        vals.append(row[f"delivery_frac_t{t}"])
        t += 1
    return sum(vals) / len(vals) if vals else 0.0


@dataclasses.dataclass(frozen=True)
class DeliveryFloor:
    """Delivery fraction must stay >= ``floor`` at EVERY tick of
    ``[start, end)`` (end None = stream end). ``topic`` restricts the
    census to one topic column (the censorship contract watches the
    victim's topic); None averages the per-topic columns."""

    floor: float
    start: int = 0
    end: int | None = None
    topic: int | None = None
    kind: str = dataclasses.field(default="delivery_floor", repr=False)

    def evaluate(self, rows: list, final: bool = True) -> ContractResult:
        end = self.end if self.end is not None else (1 << 30)
        win = [r for r in rows if self.start <= r["tick"] < end]
        if not win:
            last = max((r["tick"] for r in rows), default=-1)
            if not final and last < self.start:
                return ContractResult(self.kind, "pending",
                                      "census window not reached", {})
            return ContractResult(
                self.kind, "fail",
                f"no rows in census window [{self.start}, {end})",
                {"rows": len(rows)})
        vals = [(_row_delivery(r, self.topic), r["tick"]) for r in win]
        worst, at = min(vals)
        status = "pass" if worst >= self.floor else "fail"
        if status == "pass" and not final and self.end is not None \
                and max(r["tick"] for r in rows) < self.end - 1:
            status = "pending"
        return ContractResult(
            self.kind, status,
            f"min delivery {worst:.4f} @ tick {at} vs floor {self.floor}"
            + (f" (topic {self.topic})" if self.topic is not None else ""),
            {"min_delivery": round(worst, 4), "at_tick": at,
             "floor": self.floor})


@dataclasses.dataclass(frozen=True)
class RecoveryCeiling:
    """After the attack ends at tick ``after``, delivery must climb back
    to >= ``floor`` within ``within`` ticks — the recovery-time ceiling.
    A final stream that ends before ``after + within`` without recovering
    FAILS (the run was too short to prove recovery)."""

    after: int
    within: int
    floor: float = 0.95
    topic: int | None = None
    kind: str = dataclasses.field(default="recovery_ceiling", repr=False)

    def evaluate(self, rows: list, final: bool = True) -> ContractResult:
        post = sorted((r["tick"], _row_delivery(r, self.topic))
                      for r in rows if r["tick"] >= self.after)
        rec = next((t for t, v in post if v >= self.floor), None)
        last = max((r["tick"] for r in rows), default=-1)
        m = {"after": self.after, "within": self.within, "floor": self.floor,
             "recovered_at": rec}
        if rec is not None and rec - self.after <= self.within:
            return ContractResult(
                self.kind, "pass",
                f"recovered to >= {self.floor} at tick {rec} "
                f"({rec - self.after} ticks after heal)", m)
        if last < self.after + self.within and not final:
            return ContractResult(self.kind, "pending",
                                  "recovery window still open", m)
        worst = f"never (last tick {last})" if rec is None \
            else f"tick {rec} ({rec - self.after} > {self.within})"
        return ContractResult(
            self.kind, "fail",
            f"no recovery to >= {self.floor} within {self.within} ticks "
            f"of {self.after}: {worst}", m)


@dataclasses.dataclass(frozen=True)
class ScoreResponse:
    """The scoring machinery must RESPOND: by tick ``by``, at least
    ``attacker_frac`` of the connected attacker edges (telemetry's
    ``attacker_graylisted / attacker_edges``, attackers =
    faults.attacker_mask — sybils + censor cohorts) are below the
    graylist threshold, while honest collateral stays bounded
    (``honest_graylisted <= honest_max_frac * honest edges`` at every
    tick from ``start``). ``attacker_frac=0`` drops the attacker leg —
    the slow-link contract's shape, where the assertion is purely "no
    honest peer gets graylisted for being slow". This contract is the
    POSITIVE CONTROL of the library: with ``scoring_enabled=False``
    nothing is ever graylisted and the attacker leg must fail
    (tests/test_torch_adversary.py pins it)."""

    by: int
    attacker_frac: float = 0.5
    honest_max_frac: float = 0.05
    start: int = 0
    kind: str = dataclasses.field(default="score_response", repr=False)

    def evaluate(self, rows: list, final: bool = True) -> ContractResult:
        resp = None
        honest_bad = []
        for r in sorted(rows, key=lambda r: r["tick"]):
            att = r.get("attacker_edges", 0)
            if resp is None and att > 0 and \
                    r.get("attacker_graylisted", 0) >= self.attacker_frac * att:
                resp = r["tick"]
            honest_edges = max(r.get("connected_edges", 0) - att, 1)
            if r["tick"] >= self.start and \
                    r.get("honest_graylisted", 0) > \
                    self.honest_max_frac * honest_edges:
                honest_bad.append(r["tick"])
        last = max((r["tick"] for r in rows), default=-1)
        m = {"by": self.by, "attacker_frac": self.attacker_frac,
             "responded_at": resp, "honest_violations": honest_bad[:8]}
        if honest_bad:
            return ContractResult(
                self.kind, "fail",
                f"honest graylisting above {self.honest_max_frac:.2%} of "
                f"honest edges at tick(s) {honest_bad[:8]}", m)
        if self.attacker_frac <= 0.0:
            return ContractResult(self.kind, "pass",
                                  "no honest peer graylisted", m)
        if resp is not None and resp <= self.by:
            return ContractResult(
                self.kind, "pass",
                f">= {self.attacker_frac:.0%} of attacker edges "
                f"graylisted by tick {resp} (<= {self.by})", m)
        if last < self.by and not final:
            return ContractResult(self.kind, "pending",
                                  "response window still open", m)
        return ContractResult(
            self.kind, "fail",
            f"attackers not graylisted to {self.attacker_frac:.0%} "
            f"by tick {self.by} (responded_at={resp})", m)


CONTRACT_KINDS = {"delivery_floor": DeliveryFloor,
                  "recovery_ceiling": RecoveryCeiling,
                  "score_response": ScoreResponse}


def contract_to_json(c) -> dict:
    d = dataclasses.asdict(c)
    d["kind"] = c.kind
    return d


# field-level validation schema for contract_from_json: name ->
# (allow_none, lo, hi, int_only). Bounds are inclusive; None disables
# that edge. Kept declarative so the fuzz surface (wrong types,
# out-of-range windows, unknown kinds/fields) is refused BY NAME, never
# a crash — the same discipline the directive parser applies.
_CONTRACT_FIELDS = {
    "delivery_floor": {"floor": (False, 0.0, 1.0, False),
                       "start": (False, 0, None, True),
                       "end": (True, 0, None, True),
                       "topic": (True, 0, None, True)},
    "recovery_ceiling": {"after": (False, 0, None, True),
                         "within": (False, 1, None, True),
                         "floor": (False, 0.0, 1.0, False),
                         "topic": (True, 0, None, True)},
    "score_response": {"by": (False, 0, None, True),
                       "attacker_frac": (False, 0.0, 1.0, False),
                       "honest_max_frac": (False, 0.0, 1.0, False),
                       "start": (False, 0, None, True)},
}


def contract_from_json(d: dict):
    if not isinstance(d, dict):
        raise ValueError(f"contract spec must be a JSON object, "
                         f"got {type(d).__name__}")
    d = dict(d)
    kind = d.pop("kind", None)
    if not isinstance(kind, str) or kind not in CONTRACT_KINDS:
        raise ValueError(f"unknown contract kind {kind!r}; "
                         f"known: {sorted(CONTRACT_KINDS)}")
    schema = _CONTRACT_FIELDS[kind]
    unknown = sorted(set(d) - set(schema))
    if unknown:
        raise ValueError(f"contract {kind!r}: unknown field(s) {unknown}; "
                         f"known: {sorted(schema)}")
    for name, (allow_none, lo, hi, int_only) in schema.items():
        if name not in d:
            continue
        v = d[name]
        if v is None:
            if allow_none:
                continue
            raise ValueError(f"contract {kind!r}: field {name!r} "
                             f"must not be null")
        if isinstance(v, bool) or \
                not isinstance(v, int if int_only else (int, float)):
            raise ValueError(
                f"contract {kind!r}: field {name!r} must be "
                f"{'an integer' if int_only else 'a number'}, got {v!r}")
        if (lo is not None and v < lo) or (hi is not None and v > hi):
            raise ValueError(f"contract {kind!r}: field {name!r} "
                             f"out of range ({v!r} not in "
                             f"[{lo}, {'inf' if hi is None else hi}])")
    end, start = d.get("end"), d.get("start", 0)
    if kind == "delivery_floor" and end is not None and end <= start:
        raise ValueError(f"contract {kind!r}: empty census window "
                         f"[{start}, {end})")
    return CONTRACT_KINDS[kind](**d)


def contracts_to_json(contracts) -> list:
    return [contract_to_json(c) for c in contracts]


def contracts_from_json(items) -> tuple:
    return tuple(contract_from_json(d) for d in items)


def evaluate_contracts(contracts, rows: list, final: bool = True) -> list:
    """Evaluate every contract against one member's row stream (plain
    dict rows, sim/telemetry.py schema)."""
    return [c.evaluate(rows, final=final) for c in contracts]


def member_rows(rows: list, member: int) -> list:
    """One fleet member's rows out of a mixed journal/fleet row stream
    (unbatched runs carry member == -1)."""
    return [r for r in rows if r.get("member", -1) == member]


def contracts_from_schedule(windows: list) -> tuple:
    """Default contracts derived from a stamped attack schedule (the
    journal-header ``attack_windows`` list) — the dashboard's fallback
    when the run didn't stamp its scenario contracts explicitly.
    Deliberately lenient: schedule-only defaults can't know the
    scenario's tuned floors."""
    out: list = []
    ends = [w["end"] for w in windows if w.get("end") is not None]
    if ends:
        out.append(RecoveryCeiling(after=max(ends), within=15, floor=0.9))
    if any(w["kind"] in ("eclipse", "censor") for w in windows):
        out.append(ScoreResponse(by=max(ends) + 5 if ends else 1 << 30,
                                 attacker_frac=0.25, honest_max_frac=0.1))
    return tuple(out)


# ---------------------------------------------------------------------------
# streaming contract monitors: O(1)-state incremental
# evaluators, bit-exact vs the batch evaluate() at EVERY prefix of a
# tick-monotone row stream (status, detail string, measured dict — the
# parity pins in tests/test_torch_adversary.py). Monitor state is
# JSON-serializable so checkpoint sidecars can carry it next to
# stream_offset and a SIGKILL→relaunch resumes verdict evaluation
# exactly-once. fold() never builds a ContractResult; status() is the
# per-row fast path (a few comparisons) and result() is built lazily
# only when a status transition fires.


class DeliveryFloorMonitor:
    """Streaming DeliveryFloor: running (min, argmin) over the census
    window plus the row/tick counters the batch detail strings read."""

    def __init__(self, contract: DeliveryFloor):
        self.c = contract
        self.n_rows = 0
        self.n_win = 0
        self.min_v: float | None = None
        self.min_at = -1
        self.last = -1

    def fold(self, row: dict) -> None:
        c = self.c
        self.n_rows += 1
        t = row["tick"]
        if t > self.last:
            self.last = t
        end = c.end if c.end is not None else (1 << 30)
        if c.start <= t < end:
            v = _row_delivery(row, c.topic)
            if self.min_v is None or (v, t) < (self.min_v, self.min_at):
                self.min_v, self.min_at = v, t
            self.n_win += 1

    def status(self, final: bool = False) -> str:
        c = self.c
        if self.n_win == 0:
            return "pending" if (not final and self.last < c.start) \
                else "fail"
        if self.min_v < c.floor:
            return "fail"
        if not final and c.end is not None and self.last < c.end - 1:
            return "pending"
        return "pass"

    def result(self, final: bool = False) -> ContractResult:
        c = self.c
        end = c.end if c.end is not None else (1 << 30)
        if self.n_win == 0:
            if not final and self.last < c.start:
                return ContractResult(c.kind, "pending",
                                      "census window not reached", {})
            return ContractResult(
                c.kind, "fail",
                f"no rows in census window [{c.start}, {end})",
                {"rows": self.n_rows})
        worst, at = self.min_v, self.min_at
        return ContractResult(
            c.kind, self.status(final),
            f"min delivery {worst:.4f} @ tick {at} vs floor {c.floor}"
            + (f" (topic {c.topic})" if c.topic is not None else ""),
            {"min_delivery": round(worst, 4), "at_tick": at,
             "floor": c.floor})

    def state(self) -> dict:
        return {"n_rows": self.n_rows, "n_win": self.n_win,
                "min_v": self.min_v, "min_at": self.min_at,
                "last": self.last}

    def load(self, s: dict) -> None:
        self.n_rows, self.n_win = int(s["n_rows"]), int(s["n_win"])
        self.min_v = None if s["min_v"] is None else float(s["min_v"])
        self.min_at, self.last = int(s["min_at"]), int(s["last"])


class RecoveryCeilingMonitor:
    """Streaming RecoveryCeiling: earliest post-heal tick that cleared
    the floor, plus the last tick seen."""

    def __init__(self, contract: RecoveryCeiling):
        self.c = contract
        self.rec: int | None = None
        self.last = -1

    def fold(self, row: dict) -> None:
        c = self.c
        t = row["tick"]
        if t > self.last:
            self.last = t
        if t >= c.after and _row_delivery(row, c.topic) >= c.floor:
            if self.rec is None or t < self.rec:
                self.rec = t

    def status(self, final: bool = False) -> str:
        c = self.c
        if self.rec is not None and self.rec - c.after <= c.within:
            return "pass"
        if self.last < c.after + c.within and not final:
            return "pending"
        return "fail"

    def result(self, final: bool = False) -> ContractResult:
        c = self.c
        rec = self.rec
        m = {"after": c.after, "within": c.within, "floor": c.floor,
             "recovered_at": rec}
        if rec is not None and rec - c.after <= c.within:
            return ContractResult(
                c.kind, "pass",
                f"recovered to >= {c.floor} at tick {rec} "
                f"({rec - c.after} ticks after heal)", m)
        if self.last < c.after + c.within and not final:
            return ContractResult(c.kind, "pending",
                                  "recovery window still open", m)
        worst = f"never (last tick {self.last})" if rec is None \
            else f"tick {rec} ({rec - c.after} > {c.within})"
        return ContractResult(
            c.kind, "fail",
            f"no recovery to >= {c.floor} within {c.within} ticks "
            f"of {c.after}: {worst}", m)

    def state(self) -> dict:
        return {"rec": self.rec, "last": self.last}

    def load(self, s: dict) -> None:
        self.rec = None if s["rec"] is None else int(s["rec"])
        self.last = int(s["last"])


class ScoreResponseMonitor:
    """Streaming ScoreResponse: earliest qualifying response tick plus
    the first 8 honest-collateral violation ticks (the batch evaluator
    only ever exposes ``honest_bad[:8]``, so 8 slots ARE the full
    state for a tick-monotone stream)."""

    def __init__(self, contract: ScoreResponse):
        self.c = contract
        self.resp: int | None = None
        self.honest_bad: list = []
        self.last = -1

    def fold(self, row: dict) -> None:
        c = self.c
        t = row["tick"]
        if t > self.last:
            self.last = t
        att = row.get("attacker_edges", 0)
        if att > 0 and row.get("attacker_graylisted", 0) \
                >= c.attacker_frac * att:
            if self.resp is None or t < self.resp:
                self.resp = t
        honest_edges = max(row.get("connected_edges", 0) - att, 1)
        if t >= c.start and row.get("honest_graylisted", 0) \
                > c.honest_max_frac * honest_edges \
                and len(self.honest_bad) < 8:
            self.honest_bad.append(t)

    def status(self, final: bool = False) -> str:
        c = self.c
        if self.honest_bad:
            return "fail"
        if c.attacker_frac <= 0.0:
            return "pass"
        if self.resp is not None and self.resp <= c.by:
            return "pass"
        if self.last < c.by and not final:
            return "pending"
        return "fail"

    def result(self, final: bool = False) -> ContractResult:
        c = self.c
        m = {"by": c.by, "attacker_frac": c.attacker_frac,
             "responded_at": self.resp,
             "honest_violations": list(self.honest_bad)}
        if self.honest_bad:
            return ContractResult(
                c.kind, "fail",
                f"honest graylisting above {c.honest_max_frac:.2%} of "
                f"honest edges at tick(s) {self.honest_bad}", m)
        if c.attacker_frac <= 0.0:
            return ContractResult(c.kind, "pass",
                                  "no honest peer graylisted", m)
        if self.resp is not None and self.resp <= c.by:
            return ContractResult(
                c.kind, "pass",
                f">= {c.attacker_frac:.0%} of attacker edges "
                f"graylisted by tick {self.resp} (<= {c.by})", m)
        if self.last < c.by and not final:
            return ContractResult(c.kind, "pending",
                                  "response window still open", m)
        return ContractResult(
            c.kind, "fail",
            f"attackers not graylisted to {c.attacker_frac:.0%} "
            f"by tick {c.by} (responded_at={self.resp})", m)

    def state(self) -> dict:
        return {"resp": self.resp, "honest_bad": list(self.honest_bad),
                "last": self.last}

    def load(self, s: dict) -> None:
        self.resp = None if s["resp"] is None else int(s["resp"])
        self.honest_bad = [int(t) for t in s["honest_bad"]]
        self.last = int(s["last"])


MONITOR_KINDS = {"delivery_floor": DeliveryFloorMonitor,
                 "recovery_ceiling": RecoveryCeilingMonitor,
                 "score_response": ScoreResponseMonitor}


def monitor_for(contract):
    return MONITOR_KINDS[contract.kind](contract)


class ContractMonitors:
    """A contract set folded one row at a time, emitting VERDICT
    TRANSITION events — the journaled ``contract_verdict`` stream. Each
    event carries a deterministic id (contract index, transition seq,
    status, decided tick); the tick is a pure function of the row
    stream, NOT of chunking, so a relaunch that re-folds rows past its
    checkpoint re-derives byte-identical events and read-side dedup
    (telemetry.read_journal / the dashboard tailer) absorbs any note
    journaled before the crash — exactly-once without a write-side
    transaction."""

    STATE_VERSION = 1

    def __init__(self, contracts):
        self.contracts = tuple(contracts)
        self.monitors = [monitor_for(c) for c in self.contracts]
        self.statuses = ["pending"] * len(self.monitors)
        self.seqs = [0] * len(self.monitors)
        self.finalized = False

    def fold_rows(self, rows) -> list:
        """Fold rows in stream order; return the transition events they
        produced (possibly none), in firing order."""
        events = []
        for row in rows:
            t = row["tick"]
            for i, mon in enumerate(self.monitors):
                mon.fold(row)
                st = mon.status(final=False)
                if st != self.statuses[i]:
                    self.statuses[i] = st
                    self.seqs[i] += 1
                    events.append(self._event(i, mon.result(final=False),
                                              t))
        return events

    def finalize(self) -> list:
        """The true-run-end pass: resolve every still-pending contract
        with ``final=True`` semantics (a too-short stream fails by
        name). Idempotent across a relaunch — re-finalizing re-derives
        the same ids, which read-side dedup absorbs."""
        self.finalized = True
        events = []
        for i, mon in enumerate(self.monitors):
            st = mon.status(final=True)
            if st != self.statuses[i]:
                self.statuses[i] = st
                self.seqs[i] += 1
                events.append(self._event(i, mon.result(final=True),
                                          mon.last, final=True))
        return events

    def _event(self, i: int, res: ContractResult, tick, final=False):
        seq = self.seqs[i]
        return {"contract": i, "kind": res.kind, "seq": seq,
                "status": res.status, "detail": res.detail,
                "measured": res.measured, "tick": int(tick),
                "final": bool(final),
                "id": f"c{i}.s{seq}.{res.status}@{int(tick)}"}

    def results(self, final: bool = False) -> list:
        return [m.result(final=final) for m in self.monitors]

    @property
    def any_failed(self) -> bool:
        return "fail" in self.statuses

    # -- checkpoint-sidecar serialization ---------------------------------
    # sidecar values must be whitespace-free (checkpoint.sidecar_meta
    # splits the file on whitespace), hence the base64url token form

    def to_state(self) -> dict:
        return {"v": self.STATE_VERSION,
                "contracts": contracts_to_json(self.contracts),
                "statuses": list(self.statuses),
                "seqs": list(self.seqs),
                "finalized": self.finalized,
                "monitors": [m.state() for m in self.monitors]}

    @classmethod
    def from_state(cls, state: dict, contracts=None) -> "ContractMonitors":
        cs = contracts_from_json(state["contracts"])
        if contracts is not None and tuple(contracts) != cs:
            raise ValueError(
                "checkpointed monitor state does not match the active "
                "contract set; refusing a silent verdict reset")
        self = cls(cs)
        self.statuses = [str(s) for s in state["statuses"]]
        self.seqs = [int(s) for s in state["seqs"]]
        self.finalized = bool(state.get("finalized", False))
        for mon, s in zip(self.monitors, state["monitors"]):
            mon.load(s)
        return self

    def state_token(self) -> str:
        raw = json.dumps(self.to_state(),
                         separators=(",", ":")).encode("utf-8")
        return base64.urlsafe_b64encode(raw).decode("ascii")

    @classmethod
    def from_token(cls, token: str, contracts=None) -> "ContractMonitors":
        raw = base64.urlsafe_b64decode(token.encode("ascii"))
        return cls.from_state(json.loads(raw.decode("utf-8")),
                              contracts=contracts)


# ---------------------------------------------------------------------------
# the scenario families


class AttackScenario(tuple):
    """``(cfg, tp, state, contracts, n_ticks, name)``: the first three
    elements are exactly a ``sim.scenarios`` builder's return (so
    ``scenario[:3]`` drops into every existing runner), ``contracts`` is
    the tuple of behaviour contracts the run must satisfy over
    ``n_ticks`` ticks."""

    __slots__ = ()

    def __new__(cls, cfg, tp, state, contracts, n_ticks, name):
        return tuple.__new__(cls, (cfg, tp, state, contracts, n_ticks, name))

    cfg = property(lambda s: s[0])
    tp = property(lambda s: s[1])
    state = property(lambda s: s[2])
    contracts = property(lambda s: s[3])
    n_ticks = property(lambda s: s[4])
    name = property(lambda s: s[5])


def _attack_cfg(n_peers: int, k_slots: int, n_topics: int, plan: FaultPlan,
                **overrides) -> SimConfig:
    """The shared adversarial config shape: full scoring with the
    sybil_100k-style shallow thresholds (attacks must be able to move the
    graylist census within a small-N, tens-of-ticks run), PX + churn so
    cut edges have a reconnect path, score retention covering the attack
    windows, and the plan itself (``fault_plan`` is owned here, so a
    caller can never build an attack config that drops its attack)."""
    base = dict(
        n_peers=n_peers, k_slots=k_slots, n_topics=n_topics, msg_window=64,
        publishers_per_tick=8, prop_substeps=8,
        scoring_enabled=True, behaviour_penalty_weight=-10.0,
        behaviour_penalty_threshold=2.0, behaviour_penalty_decay=0.99,
        gossip_threshold=-10.0, publish_threshold=-50.0,
        graylist_threshold=-100.0,
        churn_disconnect_prob=0.01, churn_reconnect_prob=0.2,
        px_enabled=True, accept_px_threshold=-5.0, retain_score_ticks=600)
    base["fault_plan"] = plan
    base.update(overrides)
    return SimConfig(**base)


def eclipse(n_peers: int = 512, k_slots: int = 16, degree: int = 6,
            sybil_fraction: float = 0.25, target_fraction: float = 0.12,
            start: int = 10, end: int = 25, n_ticks: int = 40,
            n_sybil_ips: int = 8, device=None, topo=None,
            **cfg_kw) -> AttackScenario:
    """Eclipse: a sybil population (invalid publishes, IHAVE floods,
    unanswered IWANTs) plus an :class:`~.faults.EclipseWindow` cutting the
    target region's honest edges for ticks [start, end). During the window
    the targets' meshes fill with sybils; scoring must graylist them (P4 +
    P7 + P6) and the heal must restore delivery."""
    rng = np.random.default_rng(SEED)
    malicious = rng.random(n_peers) < sybil_fraction
    # the target region is id-contiguous (faults.py eclipse semantics):
    # keep it honest so the cut has honest edges to cut
    n_tgt = max(1, int(np.ceil(target_fraction * n_peers)))
    malicious[:n_tgt] = False
    ip_group = np.arange(n_peers, dtype=np.int32)
    ip_group[malicious] = n_peers + rng.integers(
        0, n_sybil_ips, int(malicious.sum())).astype(np.int32)
    _, ip_group = np.unique(ip_group, return_inverse=True)
    ip_group = ip_group.astype(np.int32)
    plan = FaultPlan(eclipses=(EclipseWindow(start, end,
                                             fraction=target_fraction),))
    cfg = _attack_cfg(n_peers, k_slots, 1, plan,
                      ip_colocation_factor_weight=-50.0,
                      ip_colocation_factor_threshold=4,
                      n_ip_groups=int(ip_group.max()) + 1, **cfg_kw)
    state = init_state(cfg, _topology(topo, n_peers, k_slots, degree),
                       malicious=malicious, ip_group=ip_group, device=device)
    contracts = (
        # the network at large must ride out the regional cut
        DeliveryFloor(floor=0.70, start=start, end=end),
        # and the heal must restore near-full delivery quickly
        RecoveryCeiling(after=end, within=10, floor=0.95),
        # sybils graylisted by the time the window closes, honest spared
        ScoreResponse(by=end, attacker_frac=0.5, honest_max_frac=0.05),
    )
    return AttackScenario(cfg, default_topic_params(1, device=device), state,
                          contracts, n_ticks, "eclipse")


def censorship(n_peers: int = 512, k_slots: int = 16, degree: int = 6,
               censor_fraction: float = 0.4, victim: int = 0,
               start: int = 8, end: int = 30, n_ticks: int = 40,
               skew: float = 0.8, device=None, topo=None,
               **cfg_kw) -> AttackScenario:
    """Censorship: a censor cohort starves the victim publisher's
    messages (:class:`~.faults.CensorWindow`) while a victim-centred
    :class:`~.faults.StormWindow` gives the starvation real traffic to
    starve (hot=1: the victim publishes ``skew`` of the window's traffic).
    The honest mesh must route around the censors and the censors must
    pay: every unanswered pull is a P7 broken promise."""
    if victim != 0:
        # the victim-centred storm publishes from the HOT set = the lowest
        # peer ids (StormWindow semantics), and hot=1 makes that exactly
        # peer 0: a victim elsewhere would be censored while peer 0
        # carries the storm, measuring the wrong peer
        raise ValueError(
            "censorship(): the victim-centered storm (StormWindow hot=1) "
            "publishes from peer 0, so victim must be 0; relabel peers "
            "instead of moving the victim")
    # the cohort must be large enough to own eager paths: a message is
    # missed eagerly only when every mesh sender on it censors, and only a
    # miss sends the IWANT whose unanswered promise prices the attack
    plan = FaultPlan(
        censorships=(CensorWindow(start, end, fraction=censor_fraction,
                                  victim=victim),),
        storms=(StormWindow(start, end, hot=1, skew=skew, topic=0),))
    # shallow thresholds + zero P7 activation: a censor's price is a few
    # broken promises per asking edge, so the graylist line must sit where
    # that price can reach it
    kw = dict(behaviour_penalty_threshold=0.0, gossip_threshold=-10.0,
              publish_threshold=-20.0, graylist_threshold=-30.0)
    kw.update(cfg_kw)
    cfg = _attack_cfg(n_peers, k_slots, 1, plan, **kw)
    state = init_state(cfg, _topology(topo, n_peers, k_slots, degree),
                       device=device)
    # P3 prices this attack (score.go:949-981 mesh delivery deficit): with
    # the victim at `skew` of the window's traffic, a censor's
    # mesh-delivery credit runs at ~(1-skew) of an honest peer's, so a
    # deliveries threshold between the two rates puts every censoring mesh
    # edge in squared deficit while honest edges keep full margin
    from ..core.params import TopicScoreParams
    tp = TopicParams.from_topic_params([TopicScoreParams(
        topic_weight=1.0, time_in_mesh_weight=0.01,
        time_in_mesh_quantum=1.0, time_in_mesh_cap=3600.0,
        first_message_deliveries_weight=1.0,
        first_message_deliveries_decay=0.5,
        first_message_deliveries_cap=100.0,
        mesh_message_deliveries_weight=-10.0,
        mesh_message_deliveries_decay=0.5,
        mesh_message_deliveries_cap=100.0,
        mesh_message_deliveries_threshold=6.0,
        mesh_message_deliveries_window=0.01,
        mesh_message_deliveries_activation=5.0,
        mesh_failure_penalty_weight=-10.0, mesh_failure_penalty_decay=0.5,
        invalid_message_deliveries_weight=-10.0,
        invalid_message_deliveries_decay=0.9,
    )], device=device)
    contracts = (
        # the victim's topic keeps delivering despite the censors
        DeliveryFloor(floor=0.85, start=start, end=end, topic=0),
        # censors graylisted (P3 deficit -> heartbeat eviction), honest
        # spared entirely; the bar is the synchronized deficit spike a few
        # ticks after activation, not a steady majority
        ScoreResponse(by=end, attacker_frac=0.10, honest_max_frac=0.01,
                      start=start),
    )
    return AttackScenario(cfg, tp, state, contracts, n_ticks, "censorship")


def flash_crowd(n_peers: int = 512, k_slots: int = 16, degree: int = 6,
                start: int = 10, end: int = 25, hot: int = 8,
                skew: float = 0.95, n_ticks: int = 40, device=None,
                topo=None, **cfg_kw) -> AttackScenario:
    """Flash crowd: a hot-topic publish storm from a skewed publisher set
    (:class:`~.faults.StormWindow`) at double the ambient publish rate.
    The mesh must absorb the load (delivery floor) and settle back once
    the crowd disperses (recovery ceiling)."""
    plan = FaultPlan(storms=(StormWindow(start, end, hot=hot, skew=skew,
                                         topic=0),))
    cfg = _attack_cfg(n_peers, k_slots, 2, plan,
                      publishers_per_tick=16, **cfg_kw)
    rng = np.random.default_rng(SEED)
    subscribed = np.ones((n_peers, 2), dtype=bool)
    subscribed[:, 1] = rng.random(n_peers) < 0.4   # a bystander subnet
    state = init_state(cfg, _topology(topo, n_peers, k_slots, degree),
                       subscribed=subscribed, device=device)
    # Eth2-style per-topic tuning: only the HOT topic carries the
    # mesh-delivery-deficit penalty (P3); an idle bystander topic with an
    # MMD threshold would penalize its whole mesh into mutual pruning
    base = default_topic_params(2, device=device)
    hot_only = torch.tensor([1.0, 0.0], dtype=torch.float32,
                            device=base.topic_weight.device)
    tp = base._replace(
        mesh_message_deliveries_weight=(
            base.mesh_message_deliveries_weight * hot_only),
        mesh_failure_penalty_weight=(
            base.mesh_failure_penalty_weight * hot_only))
    contracts = (
        DeliveryFloor(floor=0.90, start=start, end=end),
        RecoveryCeiling(after=end, within=8, floor=0.97),
    )
    return AttackScenario(cfg, tp, state, contracts, n_ticks, "flash_crowd")


def slow_link(n_peers: int = 512, k_slots: int = 16, degree: int = 6,
              fraction: float = 0.3, period: int = 3, drop: float = 0.05,
              n_ticks: int = 40, device=None, topo=None,
              **cfg_kw) -> AttackScenario:
    """Slow links: a heterogeneous link model
    (:class:`~.faults.SlowLinkClass`: a third of the edges open their data
    plane 1-in-``period`` ticks and drop ``drop`` even then). The gossip
    pull path must compensate (delivery floor), and peers behind slow links
    must not end up graylisted: latency is not misbehaviour."""
    plan = FaultPlan(slowlinks=(SlowLinkClass(fraction=fraction,
                                              period=period, drop=drop),))
    cfg = _attack_cfg(n_peers, k_slots, 1, plan, **cfg_kw)
    state = init_state(cfg, _topology(topo, n_peers, k_slots, degree),
                       device=device)
    contracts = (
        DeliveryFloor(floor=0.90, start=10),
        # no attacker leg (attacker_frac=0): the whole assertion is that
        # heterogeneous RTT produces no honest graylisting
        ScoreResponse(by=0, attacker_frac=0.0, honest_max_frac=0.02),
    )
    return AttackScenario(cfg, default_topic_params(1, device=device), state,
                          contracts, n_ticks, "slow_link")


def diurnal(n_peers: int = 512, k_slots: int = 16, degree: int = 6,
            period: int = 15, duty: int = 5, until: int = 51,
            fraction: float = 0.25, phase: int = 6, n_ticks: int = 55,
            device=None, topo=None, **cfg_kw) -> AttackScenario:
    """Diurnal churn: the same quarter of the network leaves for the first
    ``duty`` ticks of every ``period``-tick cycle and rejoins through the
    churn/backoff/retention path (:class:`~.faults.ChurnWave`). The mesh
    must re-knit around each wave (delivery floor over the schedule) and
    recover fully after the last wave."""
    plan = FaultPlan(waves=(ChurnWave(period=period, duty=duty,
                                      until=until, fraction=fraction,
                                      phase=phase),))
    cfg = _attack_cfg(n_peers, k_slots, 1, plan, **cfg_kw)
    state = init_state(cfg, _topology(topo, n_peers, k_slots, degree),
                       device=device)
    last_end = attack_end_tick(plan)
    contracts = (
        # the dark cohort's own undelivered rows are the dip being bounded:
        # the floor sits under 1 - fraction with catch-up margin
        DeliveryFloor(floor=0.45, start=phase),
        RecoveryCeiling(after=last_end, within=10, floor=0.95),
    )
    return AttackScenario(cfg, default_topic_params(1, device=device), state,
                          contracts, n_ticks, "diurnal")


# name -> constructor; the *_small names sim/scenarios.py registers are
# thin wrappers over these (scenario[:3])
FAMILIES = {
    "eclipse": eclipse,
    "censorship": censorship,
    "flash_crowd": flash_crowd,
    "slow_link": slow_link,
    "diurnal": diurnal,
}

# the sweep/test registry: scenario-registry name -> AttackScenario
# builder (same names as sim/scenarios.SCENARIOS entries)
ATTACKS = {
    "eclipse_small": eclipse,
    "censor_small": censorship,
    "flashcrowd_small": flash_crowd,
    "slowlink_small": slow_link,
    "diurnal_small": diurnal,
}


# ---------------------------------------------------------------------------
# running + evaluating


@dataclasses.dataclass
class AttackReport:
    """One scenario run's outcome: final state, the telemetry row stream
    the contracts were judged on, and the per-contract results."""

    name: str
    state: SimState
    rows: list
    results: list
    fault_flags: int

    @property
    def passed(self) -> bool:
        return all(r.passed for r in self.results)

    def summary(self) -> dict:
        return {"scenario": self.name, "passed": self.passed,
                "fault_flags": self.fault_flags,
                "contracts": [{"kind": r.kind, "status": r.status,
                               "detail": r.detail} for r in self.results]}


def run_with_contracts(scn: AttackScenario, key=None,
                       n_ticks: int | None = None,
                       device=None) -> AttackReport:
    """Run one scenario end to end on the telemetry lane
    (``engine.run_keys(telemetry=True)`` on ``rng.split(key, n_ticks)``,
    the key schedule of ``engine.run``) on ``device`` (cuda unless the
    caller passes ``device="cpu"``; the scenario's state must lie there),
    and evaluate its contracts on the resulting rows."""
    from .. import rng
    from ..device import check_on
    from . import telemetry
    from .engine import run_keys
    from .hostio import fetch_local

    dev = check_on(scn.state.tick.device, device)
    key = rng.PRNGKey(0, device=dev) if key is None else key.to(dev)
    ticks = n_ticks if n_ticks is not None else scn.n_ticks
    keys = rng.split(key, ticks)
    state, health = run_keys(scn.state, scn.cfg, scn.tp, keys,
                             telemetry=True, device=dev)
    mat, cols = telemetry.records_to_rows(health)
    rows = telemetry.rows_to_dicts(mat, cols)
    results = evaluate_contracts(scn.contracts, rows, final=True)
    return AttackReport(scn.name, state, rows, results,
                        int(fetch_local(state.fault_flags, np.uint32)))
