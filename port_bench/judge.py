"""The comparison that decides ``correct``: the program's states and
journal rows against the reference's, as numbers each held to a limit.

- ``*_mismatch``: elements (or row cells) of integer and boolean planes
  that differ; exact, limit 0.
- ``float_gap``: the widest gap of a float32 plane or row column,
  ``|program - reference| / max(|reference|, 1)``; two non-finite values
  that are equal count as no gap, any other non-finite pair as the
  largest float (``NO_MATCH``, so the result line stays valid JSON).
"""

from __future__ import annotations

import json
import math

import torch

NO_MATCH = 1.7976931348623157e308      # sys.float_info.max

# journal columns that hold integers (sim/telemetry.py's row schema)
INT_COLUMNS = frozenset({
    "tick", "member", "mesh_deg_min", "mesh_deg_max", "backoff_count",
    "graylist_count", "connected_edges", "attacker_edges",
    "attacker_graylisted", "honest_graylisted", "published_window",
    "halo_overflow", "fault_flags"})
SCALAR_FIELDS = (
    "mesh_deg_min", "mesh_deg_mean", "mesh_deg_max", "backoff_count",
    "graylist_count", "connected_edges", "attacker_edges",
    "attacker_graylisted", "honest_graylisted", "score_mean", "score_min",
    "published_window", "delivered_total", "halo_overflow", "fault_flags")


def float_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Widest ``|a - b| / max(|b|, 1)`` of two float tensors (b the
    reference)."""
    a, b = a.double(), b.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    finite = torch.isfinite(a) & torch.isfinite(b)
    if bool((~same & ~finite).any()):
        return NO_MATCH
    gap = torch.where(same, torch.zeros_like(a),
                      (a - b).abs() / b.abs().clamp(min=1.0))
    return float(gap.max()) if gap.numel() else 0.0


def state_gaps(prog, ref) -> tuple[int, float, str]:
    """(mismatched integer/boolean elements, widest float gap, the field
    of the first mismatch or the widest gap) of two states in the f32
    layout, field by field (``prog`` and ``ref`` are namedtuples of the
    same fields; the program's tensors may lie elsewhere than the
    reference's)."""
    mismatch, gap, where = 0, 0.0, ""
    for f in ref._fields:
        a = getattr(prog, f).to(getattr(ref, f).device)
        b = getattr(ref, f)
        if a.shape != b.shape:
            mismatch += max(a.numel(), b.numel())
            where = where or f"{f} shape"
            continue
        if b.is_floating_point():
            g = float_gap(a.to(b.dtype), b)
            if g > gap:
                gap, where = g, where or f
            continue
        n = int((a.to(b.dtype) != b).sum())
        if n and not mismatch:
            where = f
        mismatch += n
    return mismatch, gap, where


def record_rows(records, t_topics: int) -> dict:
    """A stacked HealthRecord ([C] leaves) as journal rows keyed by tick."""
    leaves = {f: getattr(records, f).cpu() for f in records._fields}
    rows = {}
    for i in range(leaves["tick"].shape[0]):
        row = {"tick": int(leaves["tick"][i]), "member": -1}
        for j in range(t_topics):
            row[f"delivery_frac_t{j}"] = float(leaves["delivery_frac"][i, j])
        for f in SCALAR_FIELDS:
            v = leaves[f][i]
            if f == "fault_flags":
                row[f] = int(v) & 0xFFFFFFFF
            elif f in INT_COLUMNS:
                row[f] = int(v)
            else:
                row[f] = float(v)
        rows[row["tick"]] = row
    return rows


def row_gaps(journal: dict, want: dict) -> tuple[int, float, str]:
    """(mismatched integer cells plus every cell of a missing row, widest
    float gap, where) of the journal's rows against the reference's rows
    for the same ticks."""
    mismatch, gap, where = 0, 0.0, ""
    for tick, ref in want.items():
        got = journal.get(tick)
        if got is None:
            mismatch += len(ref)
            where = where or f"tick {tick} missing"
            continue
        for col, b in ref.items():
            a = got.get(col)
            if col in INT_COLUMNS:
                if a is None or int(a) != int(b):
                    mismatch += 1
                    where = where or f"tick {tick} {col}"
                continue
            if a is None and not math.isfinite(b):
                continue            # the journal writes a non-finite as null
            a = math.nan if a is None else float(a)
            if a == b:
                continue
            g = abs(a - b) / max(abs(b), 1.0) \
                if math.isfinite(a) and math.isfinite(b) else NO_MATCH
            if g > gap:
                gap, where = g, where or f"tick {tick} {col}"
    return mismatch, gap, where


def journal_rows(path: str) -> dict:
    """The ``health`` rows of an NDJSON journal, keyed by tick (a torn
    line is skipped; a later row of a tick replaces an earlier one)."""
    rows = {}
    with open(path, "rb") as f:
        for raw in f:
            try:
                d = json.loads(raw)
            except ValueError:
                continue
            if d.get("kind") == "health":
                rows[int(d["tick"])] = d
    return rows
