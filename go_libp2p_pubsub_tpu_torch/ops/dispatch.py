"""Cost-model dispatch: one shape + platform -> formulation chooser (port of
ops/dispatch.py).

Every engine seam with competing formulations (the [N, K] payload permute,
the [W, N] words gathers, the packed edge exchange, the forwarding hop, the
gossip emit and the masked selection) resolves ``"auto"`` through ONE
table-driven chooser:

    choose(op, backend, **shape) -> ranked candidate formulations

The ranking is the reference's: analytic cost models parameterized by
per-platform coefficients, overridden by measured timings where the table
holds a record near the shape, with quarantined formulations left out of
``"auto"`` (an explicit request still takes any formulation). The cost
formulas are the reference's operation for operation, so the port ranks
exactly as the reference does under the same table.

The table is ``ops/dispatch_table.json`` (the reference's ``cpu``, ``tpu``
and ``default`` entries verbatim, and a ``cuda`` entry of the port's own),
or the file ``GRAFT_DISPATCH_TABLE`` names. The port's resolvers rank under
the ``"cuda"`` entry on every device, the CPU included (:data:`BACKEND`), so
the CPU runs the formulation the card runs; ``explain``/``choose`` take any
``backend=``. The resolvers keep their feasibility gates: dispatch ranks,
the resolver walks the ranking and takes the first executable formulation.
"""

from __future__ import annotations

import json
import math
import os

# canonical formulation order per op; doubles as the deterministic
# tie-break (earlier wins on exact cost ties)
OPS: dict = {
    "edge_permute": ("scalar", "rows", "sort", "pallas", "mxu"),
    "words": ("scalar", "rows", "sort", "pallas", "mxu"),
    "edge_packed": ("scalar", "rows", "sort", "pallas", "mxu"),
    "hop": ("xla", "pallas", "pallas-mxu"),
    "emit": ("xla", "pallas", "pallas-mxu"),
    "selection": ("iter", "sort", "ranks"),
}

# the table entry the port's resolvers rank under, on every device
BACKEND = "cuda"

DEFAULT_TABLE_PATH = os.path.join(os.path.dirname(__file__),
                                  "dispatch_table.json")

_COEFF_KEYS = (
    "mem_gbps",             # effective memory bandwidth
    "gather_ns_per_index",  # library gather cost per index
    "sort_ns_per_elem",     # sort comparator cost per element
    "mxu_gflops",           # usable matmul rate for the one-hot selects
    "onehot_streamed",      # bool: price the one-hot operand as streamed
    "pallas_overhead",      # multiplier on hand-kernel estimates
    "sel_elem_ns",          # selection elementwise cost per element
    "sel_sort_factor",      # sort-threshold work multiplier
    "sel_ranks_factor",     # O(K^2) comparison-rank work multiplier
    "sel_serial_us",        # per-sequential-pass latency (iter argmax)
)

_TABLE_CACHE: dict = {}


class DispatchTableError(ValueError):
    """The dispatch table failed to parse or misses required keys."""


def clear_table_cache() -> None:
    """Drop cached tables (for callers that change GRAFT_DISPATCH_TABLE)."""
    _TABLE_CACHE.clear()


def _validate(table: dict, path: str) -> dict:
    if not isinstance(table, dict) or "platforms" not in table:
        raise DispatchTableError(f"{path}: no 'platforms' mapping")
    if int(table.get("version", 0)) < 1:
        raise DispatchTableError(f"{path}: missing/zero 'version'")
    for plat, entry in table["platforms"].items():
        coeff = entry.get("coefficients", {})
        missing = [k for k in _COEFF_KEYS if k not in coeff]
        if missing:
            raise DispatchTableError(
                f"{path}: platform {plat!r} misses coefficients {missing}")
        for op in entry.get("quarantined", {}):
            if op not in OPS:
                raise DispatchTableError(
                    f"{path}: platform {plat!r} quarantines unknown op "
                    f"{op!r}")
    return table


def load_table(path: str | None = None) -> dict:
    """The active dispatch table: ``path``, else the ``GRAFT_DISPATCH_TABLE``
    file, else the shipped one. Cached per path."""
    path = path or os.environ.get("GRAFT_DISPATCH_TABLE") \
        or DEFAULT_TABLE_PATH
    cached = _TABLE_CACHE.get(path)
    if cached is not None:
        return cached
    with open(path) as f:
        table = _validate(json.load(f), path)
    _TABLE_CACHE[path] = table
    return table


def platform_fingerprint(device=None) -> dict:
    """What a calibrated table is stamped with: the device measured
    (``device``, else the first CUDA device, else the CPU), its name and
    the torch version."""
    import torch
    if device is not None:
        dev = torch.device(device)
        platform = dev.type
        kind = torch.cuda.get_device_name(dev) if platform == "cuda" else ""
    elif torch.cuda.is_available():
        platform, kind = "cuda", torch.cuda.get_device_name(0)
    else:
        platform, kind = "cpu", ""
    return {"platform": platform, "device_kind": kind,
            "torch": torch.__version__}


def _entry(table: dict, backend: str) -> dict:
    plats = table["platforms"]
    return plats.get(backend) or plats.get("default") or plats["cpu"]


# --- analytic per-formulation cost models (milliseconds per call) ---------
# The reference's formulas, operation for operation (float sums in the same
# order), so that costs and exact ties come out equal to the last bit.

def _t_mem(nbytes: float, c: dict) -> float:
    return nbytes / (c["mem_gbps"] * 1e9) * 1e3


def _t_gather(indices: float, c: dict) -> float:
    return indices * c["gather_ns_per_index"] * 1e-6


def _t_sort(elems: float, lanes: int, c: dict) -> float:
    # a sort carries extra payload lanes almost free; 15% a lane covers
    # the extra payload moves
    return elems * c["sort_ns_per_elem"] * 1e-6 * (1 + 0.15 * max(0, lanes - 1))


def _t_mxu(model: dict, c: dict) -> float:
    t = model["flops"] / (c["mxu_gflops"] * 1e9) * 1e3
    t += _t_mem(model["table_bytes"] + model["out_bytes"]
                + model.get("select_bytes", 0), c)
    if c.get("onehot_streamed"):
        t += _t_mem(model["onehot_bytes"] + model["lane_bytes"], c)
    return t


def _cost_edge_permute(form: str, c: dict, n: int, k: int,
                       itemsize: int = 4, have_sort_key: bool = True,
                       **_: object) -> float:
    from .mxutake import cost_model_payload
    r = n * k
    if form == "scalar":
        return _t_gather(r, c) + _t_mem(r * (2 * itemsize + 8), c)
    if form == "rows":
        # the row fetch is still an r-index gather, plus the [N, K, K]
        # temporary
        return _t_gather(r, c) \
            + _t_mem(n * k * k * itemsize * 2 + r * (itemsize + 8), c)
    if form == "sort":
        if not have_sort_key:
            return math.inf
        return _t_sort(r, 1, c) + _t_mem(r * (itemsize + 4) * 2, c)
    if form == "pallas":
        return (_t_mem(n * k * itemsize * 3, c)
                + _t_gather(r, c) * 0.2) * c["pallas_overhead"]
    if form == "mxu":
        if itemsize != 4:
            return math.inf
        return _t_mxu(cost_model_payload(n, k), c)
    return math.inf


def _cost_words(form: str, c: dict, w: int, n: int, k: int,
                itemsize: int = 4, have_sort_key: bool = True,
                **_: object) -> float:
    from .mxutake import cost_model
    r = n * k
    m = 32 * w
    if form == "scalar":
        return _t_gather(w * r, c) + _t_mem(w * r * itemsize * 2, c)
    if form == "rows":
        # row gather + [N, M] bool planes + the [N, K, M] row temporary
        return _t_gather(r, c) \
            + _t_mem(n * m + n * k * m * 2 + w * r * itemsize, c)
    if form == "sort":
        if not have_sort_key:
            return math.inf
        return _t_sort(r, w, c) + _t_mem(w * r * itemsize * 2, c)
    if form == "pallas":
        return _t_mem(w * n * itemsize + w * r * itemsize, c) \
            * c["pallas_overhead"]
    if form == "mxu":
        if itemsize != 4:
            return math.inf
        return _t_mxu(cost_model(n, r, w), c)
    return math.inf


def _cost_edge_packed(form: str, c: dict, n: int, k: int, b: int,
                      **_: object) -> float:
    from .mxutake import cost_model
    r = n * k
    n_groups = (b + 31) // 32
    wb = (b * k + 31) // 32
    if form in ("scalar", "rows"):
        return n_groups * _cost_edge_permute(form, c, n, k, itemsize=4)
    if form == "sort":
        # the packed exchange always computes its own destination keys
        return _t_sort(r, n_groups, c) + _t_mem(n_groups * r * 8, c)
    if form == "pallas":
        return _t_mem(n * wb * 4 * 3, c) * c["pallas_overhead"]
    if form == "mxu":
        # one wb-word take + the bit-extract passes
        return _t_mxu(cost_model(n, r, wb), c) + _t_mem(b * r / 2, c)
    return math.inf


def _cost_hop(form: str, c: dict, w: int, n: int, k: int,
              **_: object) -> float:
    from .mxutake import cost_model
    r = n * k
    if form == "xla":
        # the best words gather + the K-prefix scan and the bit-set
        # accumulators
        gather = min(_cost_words(f, c, w, n, k) for f in
                     ("scalar", "rows", "sort"))
        return gather + _t_mem(9 * w * k * n * 4, c)
    if form == "pallas":
        return (_t_mem(w * n * 4 + w * r, c) + _t_gather(r, c) * 0.2) \
            * c["pallas_overhead"]
    if form == "pallas-mxu":
        return (_t_mxu(cost_model(n, r, w), c) + _t_mem(w * n * 4, c)) \
            * c["pallas_overhead"]
    return math.inf


def _cost_emit(form: str, c: dict, w: int, n: int, k: int,
               **_: object) -> float:
    from .mxutake import cost_model
    r = n * k
    if form == "xla":
        gather = min(_cost_words(f, c, w, n, k) for f in
                     ("scalar", "rows", "sort"))
        return gather + _t_mem(3 * k * w * n * 4, c)
    if form == "pallas":
        return (_t_mem(w * n * 4 + w * r, c) + _t_gather(r, c) * 0.2) \
            * c["pallas_overhead"]
    if form == "pallas-mxu":
        return (_t_mxu(cost_model(n, r, w), c) + _t_mem(w * n * 4, c)) \
            * c["pallas_overhead"]
    return math.inf


# nominal row count for selection ranking: the resolver does not know its
# caller's row count, so dispatch stays a pure function of (table, k,
# max_count)
_SEL_ROWS = 4096


def _cost_selection(form: str, c: dict, k: int,
                    max_count: int | None = None, **_: object) -> float:
    e = c["sel_elem_ns"] * 1e-6
    if form == "iter":
        if max_count is None or max_count >= k:
            return math.inf
        return max_count * k * _SEL_ROWS * e \
            + max_count * c["sel_serial_us"] * 1e-3
    if form == "sort":
        return (k * k / 2) * _SEL_ROWS * e * c["sel_sort_factor"]
    if form == "ranks":
        return k * k * _SEL_ROWS * e * c["sel_ranks_factor"]
    return math.inf


_COST_FNS = {
    "edge_permute": _cost_edge_permute,
    "words": _cost_words,
    "edge_packed": _cost_edge_packed,
    "hop": _cost_hop,
    "emit": _cost_emit,
    "selection": _cost_selection,
}


def _measured_ms(entry: dict, op: str, shape: dict) -> dict:
    """Measured per-formulation timings of the closest recorded shape, or
    {}. A record matches only when every shared numeric dim is within 2x;
    the closest (least sum of |log ratio|) wins."""
    best, best_d = {}, math.inf
    for rec in entry.get("measured", ()):
        if rec.get("op") != op:
            continue
        rshape = rec.get("shape", {})
        d = 0.0
        ok = True
        for dim, val in rshape.items():
            have = shape.get(dim)
            if not isinstance(val, (int, float)) or have in (None, 0) \
                    or val <= 0:
                continue
            ratio = have / val
            if ratio > 2.0 or ratio < 0.5:
                ok = False
                break
            d += abs(math.log(ratio))
        if ok and d < best_d:
            best, best_d = rec.get("ms", {}), d
    return best


def cost_ms(op: str, form: str, coeff: dict, **shape) -> float:
    """Analytic cost estimate (ms) of one ``form`` call of ``op`` at
    ``shape`` under the platform coefficients ``coeff``."""
    return _COST_FNS[op](form, coeff, **shape)


def explain(op: str, backend: str | None = None,
            table: dict | None = None, **shape) -> dict:
    """{formulation: estimated or measured ms} for every candidate of
    ``op`` the ``backend`` entry does not quarantine (default backend:
    :data:`BACKEND`)."""
    backend = backend or BACKEND
    table = table or load_table()
    entry = _entry(table, backend)
    quarantined = set(entry.get("quarantined", {}).get(op, ()))
    measured = _measured_ms(entry, op, shape)
    out = {}
    for form in OPS[op]:
        if form in quarantined:
            continue
        ms = measured.get(form)
        out[form] = float(ms) if ms is not None \
            else cost_ms(op, form, entry["coefficients"], **shape)
    return out


def choose(op: str, backend: str | None = None,
           table: dict | None = None, **shape) -> list:
    """Ranked formulation candidates for ``op`` at ``shape``, cheapest
    first; exact ties break toward the canonical :data:`OPS` order."""
    costs = explain(op, backend, table, **shape)
    order = {f: i for i, f in enumerate(OPS[op])}
    ranked = sorted(costs, key=lambda f: (costs[f], order[f]))
    return ranked or list(OPS[op])


def explain_bucketed(op: str, buckets, backend: str | None = None,
                     table: dict | None = None, **shape) -> dict:
    """{formulation: ms} of a degree-bucketed edge pass: the sum of its
    per-bucket costs at each bucket's ``(n_rows, k_ceil)``."""
    totals: dict = {}
    for n_b, k_b in buckets:
        per = explain(op, backend, table,
                      **{**shape, "n": n_b, "k": k_b})
        for form, ms in per.items():
            totals[form] = totals.get(form, 0.0) + ms
    return totals


def choose_bucketed(op: str, buckets, backend: str | None = None,
                    table: dict | None = None, **shape) -> list:
    """Ranked candidates of a bucketed edge pass, by
    :func:`explain_bucketed`'s summed costs."""
    costs = explain_bucketed(op, buckets, backend, table, **shape)
    order = {f: i for i, f in enumerate(OPS[op])}
    ranked = sorted(costs, key=lambda f: (costs[f], order[f]))
    return ranked or list(OPS[op])


def resolved_formulations(cfg) -> dict:
    """The concrete formulation every seam runs under ``cfg``, ``"auto"``
    resolved through the table. The hop and the emit read ``"pallas"``
    (the fused kernels, under any of the reference's two fused modes) or
    ``"xla"`` (the non-fused path)."""
    import torch

    from .hopkernel import resolve_emit_mode, resolve_hop_mode
    from .permgather import (resolve_edge_packed_mode, resolve_mode,
                             resolve_words_mode)
    from .selection import resolve_selection_mode

    n, k, t = cfg.n_peers, cfg.k_slots, cfg.n_topics
    w = (cfg.msg_window + 31) // 32
    mode = cfg.edge_gather_mode

    def seams(n_rows, k_rows):
        return {
            "edge_permute": resolve_mode(mode, torch.int32, n_rows, k_rows,
                                         have_sort_key=True),
            "words": resolve_words_mode(mode, w, n_rows, k_rows,
                                        have_sort_key=True),
            "edge_packed": resolve_edge_packed_mode(mode, n_rows, k_rows,
                                                    2 * t),
        }

    out = {**seams(n, k),
           "hop": resolve_hop_mode(cfg),
           "emit": resolve_emit_mode(cfg),
           "selection": resolve_selection_mode(cfg.selection_mode, k,
                                               max_count=cfg.dhi)}
    if getattr(cfg, "degree_buckets", None):
        out["bucketed"] = {
            f"b{i}:{n_b}x{k_b}": {
                **seams(n_b, k_b),
                "selection": resolve_selection_mode(
                    cfg.selection_mode, k_b, max_count=min(cfg.dhi, k_b)),
            } for i, (n_b, k_b) in enumerate(cfg.degree_buckets)}
    return out
