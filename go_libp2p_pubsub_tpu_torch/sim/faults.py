"""Declarative fault injection, the batched half (port of sim/faults.py).

A ``FaultPlan`` describes what goes wrong and when; ``engine.step`` applies
it every tick (sim/faults.py module docstring):

- **link drop** (``link_drop_prob``): each tick each directed edge loses
  its DATA plane with this probability (control still flows); a pull
  answer the link ate is still a broken promise (P7);
- **link duplication** (``link_dup_prob``): a duplicating mesh edge
  re-offers its recent deliveries on hop 0 (seen-cache hits: P3 credit and
  gater duplicates);
- **partitions**: peers split by ``peer_id % components``; cross-component
  edges go down with RemovePeer semantics and redial at the window's end;
- **outages**: a hash-chosen ``fraction`` of peers goes dark for the
  window, then returns through the churn/retention path;
- **corruption** (``corrupt_prob``): an honest publish is corrupted in
  flight, so honest receivers REJECT it and charge P4;
- **eclipse**: edges between honest targets (ids below
  ``ceil(fraction * N)``) and honest non-targets are cut for the window;
- **censorship**: a hash-chosen cohort withholds the victim's messages
  (no IHAVE answer, no forward) while still receiving them;
- **storms**: publisher slots redraw from the ``hot`` lowest ids;
- **slow links**: a hash-chosen class of edges opens its data plane only
  every ``period``-th tick and drops with ``drop`` while open;
- **churn waves**: a hash-chosen cohort goes dark for ``duty`` ticks of
  every ``period``.

Every draw is keyed off the step key, with the reference's splits: a plan
adds its own split, slow links a fourth, storms one in
``choose_publishers``, so a plan-free config keeps its exact stream. The
peer choices hash peer ids with the reference's 32-bit finalizer, done
here in int64 lanes masked to 32 bits; the host helpers (``*_host``) give
the same choices on plain ints. Which faults fired lands in
``SimState.fault_flags`` (sim/invariants.py).

:func:`attack_schedule` and :func:`attack_end_tick` describe a plan's
windows on the host (the health journal's run header stamps the first).
:class:`HostFaultInjector` installs the same plan on the functional
runtime's discrete-event network (net/network.py): the connection-layer
families cut and re-knit host connections, the link-layer ones ride
``Network.link_fault``, and its peer choices are the ``*_host`` helpers'.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..ops.bits import I32, pack_bool
from ..parallel import kernel_context as pg
from .invariants import (FAULT_CENSOR, FAULT_ECLIPSE, FAULT_LINK_DROP,
                         FAULT_LINK_DUP, FAULT_OUTAGE, FAULT_PARTITION,
                         FAULT_SLOWLINK, FAULT_STORM, FAULT_WAVE)

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# the plan


@dataclasses.dataclass(frozen=True)
class PartitionWindow:
    """Split the network into ``components`` (peer_id % components) for
    ticks ``start <= tick < end``; heal (redial the cut edges) at
    ``end``."""

    start: int
    end: int
    components: int = 2


@dataclasses.dataclass(frozen=True)
class OutageWindow:
    """A ``fraction`` of peers goes completely dark for ticks
    ``start <= tick < end``, returning at ``end`` through the reconnect
    path. Peer choice is :func:`outage_peers_host` (shared across
    halves)."""

    start: int
    end: int
    fraction: float = 0.1


@dataclasses.dataclass(frozen=True)
class EclipseWindow:
    """Edges between an honest TARGET (peer id < ceil(fraction*N)) and an
    honest non-target go down for ticks ``start <= tick < end``, leaving
    the targets only their ``malicious`` neighbors; the cut redials at
    ``end``."""

    start: int
    end: int
    fraction: float = 0.1


@dataclasses.dataclass(frozen=True)
class CensorWindow:
    """For ticks ``start <= tick < end`` a hash-chosen ``fraction`` of
    peers (never the victim) stop advertising, answering IWANTs for and
    forwarding messages peer ``victim`` published, while still receiving
    them."""

    start: int
    end: int
    fraction: float = 0.2
    victim: int = 0


@dataclasses.dataclass(frozen=True)
class StormWindow:
    """For ticks ``start <= tick < end`` each publisher slot redraws with
    probability ``skew`` from the ``hot`` lowest peer ids and publishes to
    ``topic``."""

    start: int
    end: int
    hot: int = 4
    skew: float = 0.9
    topic: int = 0


@dataclasses.dataclass(frozen=True)
class SlowLinkClass:
    """A permanent link class: a symmetric edge hash assigns ``fraction``
    of all edges; a member edge's data plane opens only every
    ``period``-th tick (hash-derived phase) and drops with probability
    ``drop`` while open."""

    fraction: float
    period: int = 4
    drop: float = 0.0


@dataclasses.dataclass(frozen=True)
class ChurnWave:
    """A hash-chosen cohort (``fraction``) is dark for the first ``duty``
    ticks of every ``period``-tick cycle starting at ``phase``, with no new
    cycle at or after ``until`` (:func:`wave_windows`)."""

    period: int
    duty: int
    until: int
    fraction: float = 0.25
    phase: int = 0


def wave_windows(w: ChurnWave) -> list:
    """The explicit (start, end) dark windows a :class:`ChurnWave`
    expands to."""
    out = []
    s = w.phase
    while s < w.until:
        out.append((s, s + w.duty))
        s += w.period
    return out


# parse syntax per plan key (the named-error message)
_SYNTAX = {
    "drop": "drop=PROB",
    "dup": "dup=PROB",
    "corrupt": "corrupt=PROB",
    "seed": "seed=INT",
    "partition": "partition=COMPONENTS@START:END",
    "outage": "outage=FRACTION@START:END",
    "eclipse": "eclipse=FRACTION@START:END",
    "censor": "censor=FRACTION[xVICTIM]@START:END",
    "storm": "storm=HOT[xSKEW[xTOPIC]]@START:END",
    "slowlink": "slowlink=FRACTION@PERIOD[:DROP]",
    "wave": "wave=FRACTION@PERIOD:DUTY:UNTIL[:PHASE]",
}

# the plan's windowed fields and their element types
_FAMILIES = {"partitions": PartitionWindow, "outages": OutageWindow,
             "eclipses": EclipseWindow, "censorships": CensorWindow,
             "storms": StormWindow, "slowlinks": SlowLinkClass,
             "waves": ChurnWave}


def _window(v: str) -> tuple:
    """``AMT@S:E`` -> (amt_str, start, end), validated."""
    amt, sep, win = v.partition("@")
    s, sep2, e = win.partition(":")
    if not sep or not sep2:
        raise ValueError("missing @START:END window")
    start, end = int(s), int(e)
    if end <= start:
        raise ValueError(f"empty window [{start}, {end})")
    return amt, start, end


def _frac(v: str, what: str = "fraction") -> float:
    f = float(v)
    if not 0.0 <= f <= 1.0:
        raise ValueError(f"{what} {f} outside [0, 1]")
    return f


def _parse_item(k: str, v: str, kw: dict) -> None:
    """One ``key=value`` item of a plan spec into ``kw``."""
    if k in ("partition", "outage", "eclipse"):
        amt, s, e = _window(v)
        if k == "partition":
            kw["partitions"].append(PartitionWindow(s, e, components=int(amt)))
        elif k == "outage":
            kw["outages"].append(OutageWindow(s, e, fraction=_frac(amt)))
        else:
            kw["eclipses"].append(EclipseWindow(s, e, fraction=_frac(amt)))
    elif k == "censor":
        amt, s, e = _window(v)
        parts = amt.split("x")
        if len(parts) > 2:
            raise ValueError("too many x-separated fields")
        victim = int(parts[1]) if len(parts) == 2 else 0
        kw["censorships"].append(CensorWindow(
            s, e, fraction=_frac(parts[0]), victim=victim))
    elif k == "storm":
        amt, s, e = _window(v)
        parts = amt.split("x")
        if len(parts) > 3:
            raise ValueError("too many x-separated fields")
        hot = int(parts[0])
        if hot < 1:
            raise ValueError(f"hot={hot} must be >= 1")
        skew = _frac(parts[1], "skew") if len(parts) > 1 else 0.9
        topic = int(parts[2]) if len(parts) > 2 else 0
        kw["storms"].append(StormWindow(s, e, hot=hot, skew=skew, topic=topic))
    elif k == "slowlink":
        amt, _, rest = v.partition("@")
        if not rest:
            raise ValueError("missing @PERIOD")
        p, _, d = rest.partition(":")
        period = int(p)
        if period < 1:
            raise ValueError(f"period={period} must be >= 1")
        kw["slowlinks"].append(SlowLinkClass(
            fraction=_frac(amt), period=period,
            drop=_frac(d, "drop") if d else 0.0))
    elif k == "wave":
        amt, _, rest = v.partition("@")
        parts = rest.split(":") if rest else []
        if len(parts) not in (3, 4):
            raise ValueError("expected PERIOD:DUTY:UNTIL[:PHASE] after @")
        period, duty, until = int(parts[0]), int(parts[1]), int(parts[2])
        phase = int(parts[3]) if len(parts) == 4 else 0
        if period < 1 or not 0 < duty <= period:
            raise ValueError(f"need period >= 1 and 0 < duty <= period "
                             f"(got period={period}, duty={duty})")
        if (until - phase) > 100_000 * period:
            raise ValueError("wave expands to > 100000 cycles")
        kw["waves"].append(ChurnWave(period=period, duty=duty, until=until,
                                     fraction=_frac(amt), phase=phase))
    elif k == "seed":
        kw["seed"] = int(v)
    else:
        field = {"drop": "link_drop_prob", "dup": "link_dup_prob",
                 "corrupt": "corrupt_prob"}[k]
        kw[field] = _frac(v, "prob")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Fault schedule (module docstring). All-defaults is the null plan;
    ``SimConfig.fault_plan=None`` skips the fault pass entirely (the
    plan-free RNG stream)."""

    link_drop_prob: float = 0.0
    link_dup_prob: float = 0.0
    corrupt_prob: float = 0.0
    partitions: tuple = ()          # tuple[PartitionWindow, ...]
    outages: tuple = ()             # tuple[OutageWindow, ...]
    eclipses: tuple = ()            # tuple[EclipseWindow, ...]
    censorships: tuple = ()         # tuple[CensorWindow, ...]
    storms: tuple = ()              # tuple[StormWindow, ...]
    slowlinks: tuple = ()           # tuple[SlowLinkClass, ...]
    waves: tuple = ()               # tuple[ChurnWave, ...]
    seed: int = 0

    def active(self) -> bool:
        return (self.link_drop_prob > 0.0 or self.link_dup_prob > 0.0
                or self.corrupt_prob > 0.0
                or any(getattr(self, f) for f in _FAMILIES))

    @staticmethod
    def parse(spec: str) -> "FaultPlan":
        """Parse the plan syntax: comma-separated ``key=value`` items,
        repeatable for windows and classes (faults.py:281-386)::

            drop=0.05,dup=0.01,corrupt=0.1,seed=7
            partition=2@10:30          # 2 components, ticks [10, 30)
            outage=0.2@10:30           # 20% of peers dark, ticks [10, 30)
            eclipse=0.1@10:30          # 10% target region eclipsed
            censor=0.2x5@10:30         # 20% censors starve peer 5's msgs
            storm=8x0.9x1@10:20        # 8 hot publishers, skew .9, topic 1
            slowlink=0.3@4:0.05        # 30% of edges open 1-in-4, drop 5%
            wave=0.25@20:5:60          # 25% dark 5 ticks per 20, until 60

        A malformed item raises a ValueError quoting the item and its
        syntax; ``FaultPlan.parse(plan.format()) == plan``."""
        kw: dict = {f: [] for f in _FAMILIES}
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            k, _, v = item.partition("=")
            if k not in _SYNTAX:
                raise ValueError(f"unknown fault-plan item {item!r}; "
                                 f"known keys: {sorted(_SYNTAX)}")
            try:
                _parse_item(k, v, kw)
            except ValueError as err:
                raise ValueError(
                    f"malformed fault-plan item {item!r} (expected "
                    f"{_SYNTAX[k]}): {err}") from err
        for f in _FAMILIES:
            kw[f] = tuple(kw[f])
        return FaultPlan(**kw)

    def format(self) -> str:
        """The canonical spec string: zero-valued knobs omitted, window
        fields fully qualified."""
        items = []
        if self.link_drop_prob:
            items.append(f"drop={self.link_drop_prob!r}")
        if self.link_dup_prob:
            items.append(f"dup={self.link_dup_prob!r}")
        if self.corrupt_prob:
            items.append(f"corrupt={self.corrupt_prob!r}")
        for w in self.partitions:
            items.append(f"partition={w.components}@{w.start}:{w.end}")
        for w in self.outages:
            items.append(f"outage={w.fraction!r}@{w.start}:{w.end}")
        for w in self.eclipses:
            items.append(f"eclipse={w.fraction!r}@{w.start}:{w.end}")
        for w in self.censorships:
            items.append(
                f"censor={w.fraction!r}x{w.victim}@{w.start}:{w.end}")
        for w in self.storms:
            items.append(f"storm={w.hot}x{w.skew!r}x{w.topic}"
                         f"@{w.start}:{w.end}")
        for c in self.slowlinks:
            items.append(f"slowlink={c.fraction!r}@{c.period}:{c.drop!r}")
        for w in self.waves:
            items.append(f"wave={w.fraction!r}@{w.period}:{w.duty}"
                         f":{w.until}:{w.phase}")
        if self.seed:
            items.append(f"seed={self.seed}")
        return ",".join(items)

    @staticmethod
    def from_dict(d: dict) -> "FaultPlan":
        """The plan from its ``dataclasses.asdict`` form (how a reference
        config carries over: ``SimConfig(**dataclasses.asdict(cfg))``)."""
        kw = dict(d)
        for f, cls in _FAMILIES.items():
            kw[f] = tuple(w if isinstance(w, cls) else cls(**w)
                          for w in kw.get(f, ()))
        return FaultPlan(**kw)


def as_plan(plan) -> FaultPlan | None:
    """``SimConfig.fault_plan`` as the port's own :class:`FaultPlan`: None,
    a FaultPlan, or its ``dataclasses.asdict`` form (how a reference
    config carries over, nested plan included)."""
    if plan is None or isinstance(plan, FaultPlan):
        return plan
    if isinstance(plan, dict):
        return FaultPlan.from_dict(plan)
    raise TypeError(f"fault_plan must be a FaultPlan or its dict form, got "
                    f"{type(plan).__module__}.{type(plan).__name__}")


# ---------------------------------------------------------------------------
# schedule introspection (faults.py:551-601): journal headers, recovery
# censuses


def attack_schedule(plan) -> list:
    """The plan's attack and workload windows as plain dicts, sorted by
    start then kind: windowed families carry ``start``/``end``; slow-link
    classes are permanent (``end`` None)."""
    out: list = []
    if plan is None:
        return out
    for w in plan.partitions:
        out.append({"kind": "partition", "start": w.start, "end": w.end,
                    "components": w.components})
    for w in plan.outages:
        out.append({"kind": "outage", "start": w.start, "end": w.end,
                    "fraction": w.fraction})
    for w in plan.eclipses:
        out.append({"kind": "eclipse", "start": w.start, "end": w.end,
                    "fraction": w.fraction})
    for w in plan.censorships:
        out.append({"kind": "censor", "start": w.start, "end": w.end,
                    "fraction": w.fraction, "victim": w.victim})
    for w in plan.storms:
        out.append({"kind": "storm", "start": w.start, "end": w.end,
                    "hot": w.hot, "skew": w.skew, "topic": w.topic})
    for c in plan.slowlinks:
        out.append({"kind": "slowlink", "start": 0, "end": None,
                    "fraction": c.fraction, "period": c.period,
                    "drop": c.drop})
    for i, w in enumerate(plan.waves):
        for s, e in wave_windows(w):
            out.append({"kind": "wave", "start": s, "end": e, "wave": i,
                        "fraction": w.fraction})
    return sorted(out, key=lambda d: (d["start"], d["kind"]))


def attack_end_tick(plan) -> int:
    """The tick the plan's last window closes (0 for a plan without
    windows): the heal tick a recovery census anchors on. Permanent
    slow-link classes do not move it."""
    if plan is None:
        return 0
    ends = [w.end for fam in (plan.partitions, plan.outages, plan.eclipses,
                              plan.censorships, plan.storms) for w in fam]
    for w in plan.waves:
        wins = wave_windows(w)
        if wins:
            ends.append(wins[-1][1])
    return max(ends) if ends else 0


# ---------------------------------------------------------------------------
# deterministic peer choice (faults.py:425-552): a 32-bit finalizer


def _mix32_host(x: int) -> int:
    """32-bit integer finalizer (murmur3-style), host ints."""
    x &= _M32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    return x ^ (x >> 16)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """:func:`_mix32_host` on an int64 tensor of uint32 values; every
    product is masked back to 32 bits (the reference's uint32 wrap)."""
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    return x ^ (x >> 16)


def _outage_salt(plan_seed: int, widx: int) -> int:
    return (plan_seed * 0x9E3779B9 + widx * 0x85EBCA6B) & _M32


# per-family salt streams (outage keeps base 0)
_FAMILY_SALTS = {
    "outage": (0x85EBCA6B, 0x00000000),
    "censor": (0xC2B2AE35, 0x9E3779B9),
    "wave": (0x27D4EB2F, 0x3C6EF372),
    "slowlink": (0x165667B1, 0xDAA66D2B),
}


def _family_salt(plan_seed: int, family: str, idx: int) -> int:
    mult, base = _FAMILY_SALTS[family]
    return (plan_seed * 0x9E3779B9 + idx * mult + base) & _M32


def _thr32(fraction: float) -> int:
    return min(int(fraction * 4294967296.0), _M32)


def _hash_mask_host(n: int, salt: int, fraction: float) -> list[bool]:
    thr = _thr32(fraction)
    return [_mix32_host(i ^ salt) < thr for i in range(n)]


def _hash_mask(n: int, salt: int, fraction: float, device) -> torch.Tensor:
    """[N] bool: peer i is chosen iff mix32(i ^ salt) < fraction * 2**32."""
    x = torch.arange(n, dtype=torch.int64, device=device) ^ salt
    return _mix32(x) < _thr32(fraction)


def outage_peers_host(n: int, widx: int, plan: FaultPlan) -> list[bool]:
    """Peer i is dark in outage window ``widx`` iff
    hash(i, seed, widx) < fraction * 2**32."""
    return _hash_mask_host(n, _outage_salt(plan.seed, widx),
                           plan.outages[widx].fraction)


def outage_peers(n: int, widx: int, plan: FaultPlan,
                 device=None) -> torch.Tensor:
    return _hash_mask(n, _outage_salt(plan.seed, widx),
                      plan.outages[widx].fraction, device)


def censor_peers_host(n: int, widx: int, plan: FaultPlan) -> list[bool]:
    """Censor cohort of censorship window ``widx`` (never the victim)."""
    w = plan.censorships[widx]
    mask = _hash_mask_host(n, _family_salt(plan.seed, "censor", widx),
                           w.fraction)
    if 0 <= w.victim < n:
        mask[w.victim] = False
    return mask


def censor_peers(n: int, widx: int, plan: FaultPlan,
                 device=None) -> torch.Tensor:
    w = plan.censorships[widx]
    mask = _hash_mask(n, _family_salt(plan.seed, "censor", widx), w.fraction,
                      device)
    return mask & (torch.arange(n, device=device) != w.victim)


def wave_peers_host(n: int, widx: int, plan: FaultPlan) -> list[bool]:
    """The cohort of wave ``widx``, the same peers every cycle."""
    return _hash_mask_host(n, _family_salt(plan.seed, "wave", widx),
                           plan.waves[widx].fraction)


def wave_peers(n: int, widx: int, plan: FaultPlan,
               device=None) -> torch.Tensor:
    return _hash_mask(n, _family_salt(plan.seed, "wave", widx),
                      plan.waves[widx].fraction, device)


def eclipse_targets_host(n: int, widx: int, plan: FaultPlan,
                         malicious=None) -> list[bool]:
    """Target region of eclipse window ``widx``: honest peers with ids in
    [0, ceil(fraction*N))."""
    w = plan.eclipses[widx]
    lim = max(1, int(math.ceil(w.fraction * n)))
    return [i < lim and not (malicious is not None and malicious[i])
            for i in range(n)]


def _slow_edge_hash_host(i: int, j: int, salt: int) -> int:
    a, b = (i, j) if i < j else (j, i)
    return _mix32_host(((a * 0x9E3779B1) ^ b ^ salt) & _M32)


def slow_edge_hash(neighbors: torch.Tensor, salt: int, row_start: int = 0,
                   n_global: int | None = None) -> torch.Tensor:
    """[N, K] int64 symmetric per-edge hash (both directions of an edge
    hash alike: min/max endpoint order), equal to
    :func:`_slow_edge_hash_host` bit for bit. ``row_start``/``n_global``
    locate a row slice of a larger graph (a degree-bucket view,
    sim/bucketed.py): row r is peer ``row_start + r`` and neighbor ids are
    global, so each edge hashes as in the whole graph (faults.py:527-545)."""
    rows, k = neighbors.shape
    n = n_global if n_global is not None else rows
    i = (row_start + torch.arange(rows, dtype=torch.int64,
                                  device=neighbors.device))[:, None]
    i = i.expand(rows, k)
    j = neighbors.clamp(0, n - 1).to(torch.int64)
    a, b = torch.minimum(i, j), torch.maximum(i, j)
    return _mix32((((a * 0x9E3779B1) & _M32) ^ b ^ salt) & _M32)


# ---------------------------------------------------------------------------
# the per-tick fault pass


class FaultTick(NamedTuple):
    """What engine.step threads through the rest of the tick."""

    want_down: torch.Tensor         # [N, K] bool: edges the plan holds down
    link_ok: torch.Tensor | None    # [N, K] bool data admission, or None
    dup_edges: torch.Tensor | None  # [N, K] bool duplicating edges, or None
    corrupt: torch.Tensor | None    # [P] bool corrupted publishes, or None
    injected: torch.Tensor          # int32 scalar: fault bits fired this tick


def _bit(cond: torch.Tensor, bit: int) -> torch.Tensor:
    return torch.where(cond, bit, 0).to(I32)


def edge_cut_mask(plan: FaultPlan, tick: torch.Tensor,
                  neighbors: torch.Tensor, reverse_slot: torch.Tensor,
                  disconnect_tick: torch.Tensor | None = None,
                  malicious: torch.Tensor | None = None,
                  row_start: int = 0, n_global: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(want_down [N,K], heal_mask [N,K], injected int32) for this tick's
    partition/outage/eclipse/wave schedule (faults.py:618-709).
    ``heal_mask`` covers exactly the edges the plan took down: an edge
    counts as plan-downed iff some window that cuts it was active at its
    ``disconnect_tick`` (true everywhere when no stamps are passed). Every
    cut set is a function of peer ids, so the masks are edge-symmetric.
    ``malicious`` gates the eclipse cut and is required by eclipse plans.

    ``row_start``/``n_global`` locate a row slice of a larger graph (a
    degree-bucket view, sim/bucketed.py): row r is peer ``row_start + r``,
    neighbor ids and ``malicious`` are global, so the slices' masks
    concatenate into the whole graph's."""
    nrows, k = neighbors.shape
    n = n_global if n_global is not None else nrows
    dev = neighbors.device
    known = (neighbors >= 0) & (reverse_slot >= 0)
    nbr = neighbors.clamp(0, n - 1).long()

    def rsl(a):
        """The slice's rows of a global [N] peer predicate."""
        return a[row_start:row_start + nrows]

    wins = []                   # (start, end, cut set, injected bit)
    for w in plan.partitions:
        comp = torch.arange(n, dtype=I32, device=dev) % w.components
        cross = (rsl(comp)[:, None] != comp[nbr]) & known
        wins.append((w.start, w.end, cross, FAULT_PARTITION))
    for i, w in enumerate(plan.outages):
        dark = outage_peers(n, i, plan, dev)
        wins.append((w.start, w.end,
                     (rsl(dark)[:, None] | dark[nbr]) & known, FAULT_OUTAGE))
    if plan.eclipses and malicious is None:
        raise ValueError("edge_cut_mask: a plan with eclipse windows "
                         "needs the malicious mask (sybil edges are the "
                         "ones the eclipse leaves standing)")
    for w in plan.eclipses:
        lim = max(1, int(math.ceil(w.fraction * n)))
        tgt = (torch.arange(n, device=dev) < lim) & ~malicious
        honest2 = rsl(~malicious)[:, None] & ~malicious[nbr]
        cross = (rsl(tgt)[:, None] ^ tgt[nbr]) & honest2 & known
        wins.append((w.start, w.end, cross, FAULT_ECLIPSE))
    for i, w in enumerate(plan.waves):
        dark = wave_peers(n, i, plan, dev)
        cut = (rsl(dark)[:, None] | dark[nbr]) & known
        for s, e in wave_windows(w):
            wins.append((s, e, cut, FAULT_WAVE))

    cut = torch.zeros((nrows, k), dtype=torch.bool, device=dev)
    heal = torch.zeros_like(cut)
    inj = torch.zeros((), dtype=I32, device=dev)
    if disconnect_tick is None:
        plan_downed = torch.ones_like(cut)
    else:
        plan_downed = torch.zeros_like(cut)
        for s, e, cs, _ in wins:
            plan_downed = plan_downed | \
                (cs & (disconnect_tick >= s) & (disconnect_tick < e))
    for s, e, cs, bit in wins:
        act = (tick >= s) & (tick < e)
        cut = cut | (act & cs)
        heal = heal | ((tick == e) & cs & plan_downed)
        inj = inj | _bit(act, bit)
    return cut, heal, inj


def apply_faults(state, cfg, tp, key: torch.Tensor):
    """The start-of-tick fault pass (faults.py:712-803): partition, outage,
    eclipse and wave transitions (down with RemovePeer semantics, up
    through the reconnect/retention path), then this tick's link, slow-link,
    duplication and corruption draws. Returns ``(state, FaultTick)``."""
    from .. import rng
    from ..ops.churn import bring_edges_up, take_edges_down

    plan = cfg.fault_plan
    n, k = state.neighbors.shape
    # inside a peer group: this rank's rows of the global cut sets, and the
    # injected bits of every rank's draws
    r0, ng = pg.row0(), pg.global_rows(n)
    mal_all = pg.replicate(state.malicious) if plan.eclipses \
        else state.malicious
    if plan.slowlinks:
        # the fourth split exists only under a slow-link plan
        kd, kdup, kc, kslow = rng.split(key, 4)
    else:
        kd, kdup, kc = rng.split(key, 3)
        kslow = None

    if plan.partitions or plan.outages or plan.eclipses or plan.waves:
        # want_down from the pre-cut state; heal_mask reads the disconnect
        # stamps as they stand at the window's end
        want_down, heal_mask, inj = edge_cut_mask(
            plan, state.tick, state.neighbors, state.reverse_slot,
            disconnect_tick=state.disconnect_tick,
            malicious=mal_all, row_start=r0, n_global=ng)
        state = take_edges_down(state, cfg, tp, state.connected & want_down)
        # heal redials exactly the ending windows' own cuts
        come_up = heal_mask & ~state.connected & ~want_down
        state = bring_edges_up(state, cfg, come_up)
    else:
        want_down, _, inj = edge_cut_mask(
            plan, state.tick, state.neighbors, state.reverse_slot,
            malicious=mal_all, row_start=r0, n_global=ng)

    # storms and censorships act elsewhere; their active windows are
    # recorded here
    for fam, bit in ((plan.storms, FAULT_STORM),
                     (plan.censorships, FAULT_CENSOR)):
        for w in fam:
            inj = inj | _bit((state.tick >= w.start) & (state.tick < w.end),
                             bit)

    valid = state.connected
    link_ok = dup_edges = corrupt = None
    if plan.link_drop_prob > 0.0:
        link_ok = rng.uniform(kd, (n, k), row0=r0) >= plan.link_drop_prob
        inj = inj | _bit((~link_ok & valid).any(), FAULT_LINK_DROP)
    if plan.slowlinks:
        # a member edge's data plane opens every period-th tick and drops
        # with cl.drop while open, folded into link_ok
        kss = rng.split(kslow, len(plan.slowlinks))
        lk = torch.ones((n, k), dtype=torch.bool, device=valid.device)
        stalled = torch.zeros((), dtype=torch.bool, device=valid.device)
        known = state.neighbors >= 0
        for ci, cl in enumerate(plan.slowlinks):
            h = slow_edge_hash(state.neighbors,
                               _family_salt(plan.seed, "slowlink", ci),
                               row_start=r0, n_global=ng)
            member = (h < _thr32(cl.fraction)) & known
            phase = (h % cl.period).to(I32)
            open_now = ((state.tick + phase) % cl.period) == 0
            ok = open_now
            if cl.drop > 0.0:
                ok = ok & (rng.uniform(kss[ci], (n, k), row0=r0)
                           >= cl.drop)
            lk = lk & (~member | ok)
            stalled = stalled | (member & ~open_now & valid).any()
        link_ok = lk if link_ok is None else (link_ok & lk)
        inj = inj | _bit(stalled, FAULT_SLOWLINK)
    if plan.link_dup_prob > 0.0:
        dup_edges = (rng.uniform(kdup, (n, k), row0=r0)
                     < plan.link_dup_prob) & valid
        inj = inj | _bit(dup_edges.any(), FAULT_LINK_DUP)
    if plan.corrupt_prob > 0.0:
        # FAULT_CORRUPT is set by engine.step from the effective corruption
        corrupt = rng.uniform(kc, (cfg.publishers_per_tick,)) \
            < plan.corrupt_prob
    return state, FaultTick(want_down=want_down, link_ok=link_ok,
                            dup_edges=dup_edges, corrupt=corrupt,
                            injected=pg.por(inj))


# ---------------------------------------------------------------------------
# the hooks engine.step consumes


def storm_publishers(state, cfg, peers: torch.Tensor, topics: torch.Tensor,
                     key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply the plan's active storm windows to this tick's publisher draw:
    with probability ``skew`` a slot redraws from the ``hot`` lowest ids
    and publishes to the storm's topic (faults.py:810-826)."""
    from .. import rng

    for w in cfg.fault_plan.storms:
        key, kh, ks = rng.split(key, 3)
        active = (state.tick >= w.start) & (state.tick < w.end)
        hot = rng.randint(kh, tuple(peers.shape), 0, min(w.hot, cfg.n_peers))
        use = active & (rng.uniform(ks, tuple(peers.shape)) < w.skew)
        peers = torch.where(use, hot, peers)
        topics = torch.where(use, torch.full_like(topics, w.topic), topics)
    return peers, topics


def censor_word_mask(state, cfg) -> torch.Tensor | None:
    """[W, N] packed words of the message slots peer ``n`` suppresses this
    tick under the plan's active censor windows, or None without
    censorships (faults.py:829-848). Built after publish, so the victim's
    new messages are covered the tick they appear."""
    plan = cfg.fault_plan
    if plan is None or not plan.censorships:
        return None
    n = state.neighbors.shape[0]
    dev = state.neighbors.device
    mine = pg.row_ids(n, dev)
    zero = torch.zeros((), dtype=I32, device=dev)
    mask = None
    for i, w in enumerate(plan.censorships):
        active = (state.tick >= w.start) & (state.tick < w.end)
        vic = pack_bool(((state.msg_publisher == w.victim)
                         & (state.msg_topic >= 0))[None, :])[0]     # [W]
        cens = censor_peers(pg.global_rows(n), i, plan, dev)[mine]  # [N]
        mw = torch.where(active & cens[None, :], vic[:, None], zero)
        mask = mw if mask is None else (mask | mw)
    return mask


def attacker_mask(state, cfg) -> torch.Tensor:
    """[N] bool: sybil actors (``state.malicious``) plus every censor
    cohort of the plan, window-independent (faults.py:851-863)."""
    att = state.malicious
    plan = getattr(cfg, "fault_plan", None)
    if plan is not None:
        n = att.shape[0]
        mine = pg.row_ids(n, att.device)
        for i in range(len(plan.censorships)):
            att = att | censor_peers(pg.global_rows(n), i, plan,
                                     att.device)[mine]
    return att


# ---------------------------------------------------------------------------
# host half: the same plan on the discrete-event runtime


class HostFaultInjector:
    """Install a :class:`FaultPlan` on a functional-runtime swarm.

    Mirrors the batched semantics on net/network.py primitives: partitions
    and outages DISCONNECT the affected host pairs at window start
    (notifiee fan-out fires RemovePeer in every PubSub, pubsub.go:711-757)
    and re-``connect`` them at window end; link drop/duplication ride the
    ``Network.link_fault`` hook consulted by ``Host.send``. One tick of
    the batched engine corresponds to one second of scheduler time (the
    1 tick == 1 s == 1 heartbeat quantization, SURVEY.md §7 "Time").

    ``corrupt_prob`` has no host-side hook here: on the runtime, corrupt
    traffic is expressed through topic validators (go-libp2p-pubsub's own
    mechanism, api/validation.py). The same applies
    to ``censorships`` and ``storms``: on the host half a censor is a
    router/validator behavior and a storm is the scenario's own publish
    schedule, so the injector carries only the CONNECTION-layer families
    (partitions, outages, eclipses, waves) and the LINK-layer ones
    (drop/dup/slowlink).

    ORDERING CONTRACT: ``hosts`` must be in engine row order — list
    position i IS peer row i of the batched half (partition components
    are ``i % components``, outage/wave peers hash the row id, and
    eclipse targets are the low-id region on both sides). Build the swarm
    the way topology.from_hosts expects and pass the same list; any other
    order silently picks different cut/dark sets than the batched run of
    the same plan. ``malicious`` (row-ordered bools) is required when the
    plan has eclipse windows — the eclipse leaves sybil edges standing.
    """

    def __init__(self, network, hosts, plan: FaultPlan, malicious=None):
        import random as _random

        plan = as_plan(plan)
        self.network = network
        self.hosts = list(hosts)
        self.plan = plan
        self.malicious = list(malicious) if malicious is not None else None
        if plan.eclipses and self.malicious is None:
            raise ValueError("HostFaultInjector: a plan with eclipse "
                             "windows needs the malicious list (engine "
                             "row order)")
        self.rng = _random.Random(plan.seed)
        self.index = {h.peer_id: i for i, h in enumerate(self.hosts)}
        self._partitions_live: list[PartitionWindow] = []
        self._eclipse_targets: dict = {}     # widx -> [bool] target rows
        self._dark: dict = {}                # (family, widx) -> set(peer ids)
        self._severed: list = []             # [(host_a, host_b)]
        network.link_fault = self._link_fault
        sched = network.scheduler
        now = sched.now()
        for w in plan.partitions:
            sched.call_at(max(now, float(w.start)),
                          lambda w=w: self._partition_start(w))
            sched.call_at(max(now, float(w.end)),
                          lambda w=w: self._partition_end(w))
        for i, w in enumerate(plan.outages):
            sched.call_at(max(now, float(w.start)),
                          lambda i=i, w=w: self._outage_start(i, w))
            sched.call_at(max(now, float(w.end)),
                          lambda i=i: self._outage_end(i))
        for i, w in enumerate(plan.eclipses):
            sched.call_at(max(now, float(w.start)),
                          lambda i=i, w=w: self._eclipse_start(i, w))
            sched.call_at(max(now, float(w.end)),
                          lambda i=i: self._eclipse_end(i))
        for i, w in enumerate(plan.waves):
            # one scheduled (start, end) pair per expanded cycle — the
            # batched half's wave_windows expansion, mirrored exactly
            for s, e in wave_windows(w):
                sched.call_at(max(now, float(s)),
                              lambda i=i: self._wave_start(i))
                sched.call_at(max(now, float(e)),
                              lambda i=i: self._wave_end(i))

    # -- the one cut predicate (all transitions and the link hook agree) --

    def _is_dark(self, pid) -> bool:
        return any(pid in dark for dark in self._dark.values())

    def _is_cut(self, i: int, j: int) -> bool:
        for w in self._partitions_live:
            if i % w.components != j % w.components:
                return True
        for tgt in self._eclipse_targets.values():
            if (tgt[i] != tgt[j]) and not (
                    self.malicious[i] or self.malicious[j]):
                return True
        return self._is_dark(self.hosts[i].peer_id) \
            or self._is_dark(self.hosts[j].peer_id)

    # -- link hook (Host.send) --

    def _link_fault(self, src, dst, has_data: bool = True) -> str:
        i, j = self.index.get(src), self.index.get(dst)
        if i is None or j is None:
            return "ok"
        if self._is_cut(i, j):
            return "drop"             # cut/dark link: nothing crosses
        # slow-link classes: a member edge's DATA plane opens only every
        # period-th scheduler second ((tick + phase) % period == 0, the
        # batched half's formula on the same symmetric edge hash) and
        # drops with cl.drop even when open — control always flows
        if self.plan.slowlinks and has_data:
            tick = int(self.network.scheduler.now())
            for ci, cl in enumerate(self.plan.slowlinks):
                h = _slow_edge_hash_host(
                    i, j, _family_salt(self.plan.seed, "slowlink", ci))
                if h >= _thr32(cl.fraction):
                    continue
                if (tick + h % cl.period) % cl.period != 0:
                    return "drop_data"
                if cl.drop > 0.0 and self.rng.random() < cl.drop:
                    return "drop_data"
        # lossy links shed the DATA plane only (batched-half parity:
        # forward_tick masks link_ok into data_ok, control still flows),
        # so the drop draw is only spent on data-bearing frames
        if self.plan.link_drop_prob > 0.0 and has_data \
                and self.rng.random() < self.plan.link_drop_prob:
            return "drop_data"
        # duplication likewise only models retransmitted DATA frames (the
        # batched dup_offer re-offers recent deliveries on mesh edges);
        # doubling a control frame (GRAFT handled twice) would be a fault
        # class the batched half cannot mirror
        if self.plan.link_dup_prob > 0.0 and has_data \
                and self.rng.random() < self.plan.link_dup_prob:
            return "dup"
        return "ok"

    # -- window transitions --

    def _sever_cut(self) -> None:
        """Disconnect every currently-connected pair the cut predicate now
        covers (called after a window opens)."""
        for a in self.hosts:
            ia = self.index[a.peer_id]
            for pid in list(a.conns):
                ib = self.index.get(pid)
                if ib is not None and self._is_cut(ia, ib):
                    a.disconnect(pid)
                    self._severed.append((a, self.hosts[ib]))

    def _reknit(self) -> None:
        """Reconnect severed pairs no longer covered by ANY active window
        (called after a window closes); pairs another window still cuts
        stay severed until that window too ends — matching the batched
        half's per-window heal_mask & ~want_down semantics."""
        keep = []
        for a, b in self._severed:
            if self._is_cut(self.index[a.peer_id], self.index[b.peer_id]):
                keep.append((a, b))
            else:
                a.connect(b)
        self._severed = keep

    def _partition_start(self, w: PartitionWindow) -> None:
        self._partitions_live.append(w)
        self._sever_cut()

    def _partition_end(self, w: PartitionWindow) -> None:
        if w in self._partitions_live:
            self._partitions_live.remove(w)
        self._reknit()

    def _outage_start(self, widx: int, w: OutageWindow) -> None:
        dark_mask = outage_peers_host(len(self.hosts), widx, self.plan)
        self._dark[("outage", widx)] = \
            {h.peer_id for h, d in zip(self.hosts, dark_mask) if d}
        self._sever_cut()

    def _outage_end(self, widx: int) -> None:
        self._dark.pop(("outage", widx), None)
        self._reknit()

    def _eclipse_start(self, widx: int, w: EclipseWindow) -> None:
        self._eclipse_targets[widx] = eclipse_targets_host(
            len(self.hosts), widx, self.plan, malicious=self.malicious)
        self._sever_cut()

    def _eclipse_end(self, widx: int) -> None:
        self._eclipse_targets.pop(widx, None)
        self._reknit()

    def _wave_start(self, widx: int) -> None:
        dark_mask = wave_peers_host(len(self.hosts), widx, self.plan)
        self._dark[("wave", widx)] = \
            {h.peer_id for h, d in zip(self.hosts, dark_mask) if d}
        self._sever_cut()

    def _wave_end(self, widx: int) -> None:
        self._dark.pop(("wave", widx), None)
        self._reknit()
