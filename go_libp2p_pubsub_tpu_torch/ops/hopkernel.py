"""The fused forwarding-hop, IWANT-resolve and IHAVE-emit kernels (port of
ops/hopkernel.py).

Each function has a plain PyTorch version (``*_plain``) that repeats the
reference Pallas kernel's arithmetic on whole tensors, and a CUDA kernel
(csrc/hop.cu, csrc/iwant_resolve.cu, csrc/emit.cu). The wrapper takes the
plain version for CPU tensors and launches the kernel for CUDA tensors;
anything else raises.

Packed tables are int32 holding uint32 bits ([W, N], word-major,
peer-minor); bool planes arrive as uint8; per-(topic, slot) counters are
[T, K, N] uint8 and wrap as the reference's uint8 adds do. ``nbr`` is the
[N, K] int32 neighbour table pre-clipped to [0, N).

The TPU-only eligibility gate ``_hop_shape_ok`` (VMEM and lane alignment)
has no Hopper meaning and is not ported. Its place is taken by
:func:`_fused_shape_ok`, the shapes the Hopper kernels take: the fused and
XLA hops are bit-identical in the reference, so routing a shape to either
changes no result.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..parallel import kernel_context as kc
from . import cudalib
from .bits import I32, exclusive_prefix_or, pack_words, popcount, \
    prefix_count_words, reduce_or, unpack_words

U8 = torch.uint8
_MAXW = 8          # csrc/*.cu MAXW: packed words per row held in registers
# csrc/iwant_resolve.cu TILE_MAX: the bytes of a block's count tile, which
# holds (2T+1) * K uint8 counts per receiver, at least one receiver's
_RESOLVE_TILE_MAX = 32 * 1024


def _fused_shape_ok(w: int, t: int, k: int) -> bool:
    """The shapes the fused hop and IWANT-resolve kernels take: W packed
    words per row in registers, and one receiver's (2T+1) * K counts in the
    resolve's tile. The wrappers refuse the rest from the same constants."""
    return w <= _MAXW and (2 * t + 1) * k <= _RESOLVE_TILE_MAX


def emit_slot_bytes(k: int) -> int:
    """Bytes of a slot in csrc/emit.cu's shared-memory choice tile: the
    narrowest signed type that holds K - 1 (int8, int16, int32)."""
    return 1 if k <= 128 else 2 if k <= 1 << 15 else 4


class HopOut(NamedTuple):
    new_valid: torch.Tensor   # [W, N] next frontier (validated new arrivals)
    have: torch.Tensor        # [W, N] updated seen set
    dlv: torch.Tensor         # [W, N] updated delivered set
    dlv_new: torch.Tensor     # [W, N] deliveries accumulated this tick
    nv: torch.Tensor          # [T, K, N] uint8 first-delivery counts
    ni: torch.Tensor          # [T, K, N] uint8 invalid (P4) counts
    dup: torch.Tensor         # [T, K, N] uint8 mesh-duplicate counts


class ResolveOut(NamedTuple):
    got_any: torch.Tensor       # [W, N] pulled (seen) this tick
    got_valid_any: torch.Tensor  # [W, N] pulled AND delivered
    nv: torch.Tensor            # [T, K, N] uint8 first-delivery seed counts
    ni: torch.Tensor            # [T, K, N] uint8 invalid seed counts
    broken: torch.Tensor        # [K, N] uint8 broken-promise counts (P7)


def _hop_config_ok(cfg) -> bool:
    """Config eligibility shared by both Pallas hop variants."""
    return not (cfg.gater_enabled or cfg.record_provenance
                or cfg.edge_queue_cap > 0 or cfg.validation_queue_cap > 0
                or (cfg.flood_publish and cfg.router == "gossipsub")
                or cfg.count_dtype != "uint8"
                # link duplication ORs an extra hop-0 offer table the
                # fused kernel has no input for; link drop needs the
                # split broken-promise accounting (a link-eaten answer IS
                # broken, a graylist/gater drop is not — propagate.py
                # resolve step), which the fused resolve kernel's single
                # data_ok plane cannot express
                or (cfg.fault_plan is not None
                    and (cfg.fault_plan.link_dup_prob > 0
                         or cfg.fault_plan.link_drop_prob > 0
                         # slow-link classes fold into link_ok (same
                         # split-accounting need as link drop); the
                         # censorship per-sender frontier mask has no
                         # fused-kernel input at all (propagate.py)
                         or getattr(cfg.fault_plan, "slowlinks", ())
                         or getattr(cfg.fault_plan, "censorships", ()))))


_HOP_MODES = ("auto", "xla", "pallas", "pallas-mxu")


def _words(cfg) -> int:
    return (cfg.msg_window + 31) // 32


def _fused(cfg, op: str, feasible: bool) -> str:
    """``"pallas"`` (the fused kernels) or ``"xla"`` for ``op`` ("hop" or
    "emit"): ``"auto"`` walks ops/dispatch.py's ranking and takes the first
    candidate that can run (``"xla"`` always can, the two fused modes when
    ``feasible``); ``"pallas"`` and ``"pallas-mxu"`` take the kernels when
    ``feasible``; ``"xla"`` never does."""
    mode = cfg.hop_mode
    if mode not in _HOP_MODES:
        raise ValueError(f"unknown hop_mode {mode!r}")
    if mode == "auto":
        from .dispatch import choose
        w, n, k = _words(cfg), cfg.n_peers, cfg.k_slots
        for cand in choose(op, w=w, n=n, k=k):
            if cand == "xla" or feasible:
                return "xla" if cand == "xla" else "pallas"
        return "xla"
    return "pallas" if mode != "xla" and feasible else "xla"


def resolve_hop_mode(cfg) -> str:
    """The forwarding hop and IWANT resolve: ``"pallas"`` (the fused
    kernels) or ``"xla"`` (the non-fused data path of ops/propagate.py),
    from the config alone, never the device, so the CPU runs the
    formulation the card runs (hopkernel.py:112-140). The kernels can run
    when :func:`_hop_config_ok` holds and the config's shapes fit them
    (:func:`_fused_shape_ok` of W = ceil(msg_window / 32), n_topics and
    k_slots); ``"auto"`` ranks through ops/dispatch.py, whose ``"cuda"``
    entry quarantines ``"xla"``, so it takes the kernels wherever they can
    run. The two paths are bit-identical (hopkernel.py:15-17).
    ``"pallas-mxu"`` differs from ``"pallas"`` in the reference only by the
    in-kernel gather formulation, so it runs the same kernels."""
    return _fused(cfg, "hop", _hop_config_ok(cfg) and _fused_shape_ok(
        _words(cfg), cfg.n_topics, cfg.k_slots))


def resolve_emit_mode(cfg) -> str:
    """The IHAVE->IWANT chooser (hopkernel.py:143-169): the fused
    :func:`emit` kernel can run wherever W = ceil(msg_window / 32) fits its
    registers (M <= 32 W always holds), whatever the rest of the config;
    the modes resolve as for :func:`resolve_hop_mode`."""
    return _fused(cfg, "emit", _words(cfg) <= _MAXW)


def _expand_topic(planes_u8: torch.Tensor, tb: torch.Tensor) -> torch.Tensor:
    """[N, T, K] uint8 bool planes + [T, W] topic message sets -> [W, N, K]
    packed words (topic sets are disjoint, so OR == sum)."""
    n, t, k = planes_u8.shape
    out = torch.zeros((tb.shape[1], n, k), dtype=I32, device=tb.device)
    zero = torch.zeros((), dtype=I32, device=tb.device)
    for ti in range(t):
        out = out | torch.where((planes_u8[:, ti, :] != 0)[None],
                                tb[ti][:, None, None], zero)
    return out


def _add_u8(acc: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """uint8 accumulate with wrap-around (JAX's uint8 add)."""
    return ((acc.to(I32) + cnt.to(I32)) & 0xFF).to(U8)


def _counts(events: torch.Tensor, tb: torch.Tensor) -> torch.Tensor:
    """[W, N, K] event words -> [T, K, N] per-topic popcounts (int32)."""
    return torch.stack([
        popcount(events & tb[ti][:, None, None]).sum(0).T
        for ti in range(tb.shape[0])]).to(I32)


# --- the fused forwarding hop (hopkernel.py:hop_pallas) ---------------------

def hop_plain(frontier, have, dlv, dlv_new, vm, inv_n, window_old, valid_msg,
              nbr, fwd_u8, mesh_u8, topic_bits, nv, ni, dup) -> HopOut:
    """Plain PyTorch version of :func:`hop` (new tensors; inputs untouched)."""
    g = frontier[:, nbr.long()]                           # [W, N, K]
    off = g & _expand_topic(fwd_u8, topic_bits)
    mesh_eb = _expand_topic(mesh_u8, topic_bits)
    excl = exclusive_prefix_or(off, axis=2)               # lower slots' offers
    nf = off & ~excl & ~have[:, :, None]                  # lowest-slot winners
    nv_out = _add_u8(nv, _counts(nf & vm[:, :, None], topic_bits))
    ni_out = _add_u8(ni, _counts(nf & inv_n[:, :, None], topic_bits))
    new_any = reduce_or(off, axis=2) & ~have
    new_valid = new_any & vm
    # mesh-duplicate eligibility uses the WHOLE hop's new deliveries
    elig = (window_old | dlv_new | new_valid) & valid_msg
    dup_out = _add_u8(dup, _counts(off & mesh_eb & elig[:, :, None],
                                   topic_bits))
    return HopOut(new_valid, have | new_any, dlv | new_valid,
                  dlv_new | new_valid, nv_out, ni_out, dup_out)


def hop(frontier, have, dlv, dlv_new, vm, inv_n, window_old, valid_msg,
        nbr, fwd_u8, mesh_u8, topic_bits, nv, ni, dup) -> HopOut:
    """One fused forwarding hop.

    frontier/have/dlv/dlv_new/vm/inv_n/window_old: [W, N] int32 packed
    tables (receiver-indexed except frontier, which is sender-indexed).
    valid_msg: [W, 1]. nbr: [N, K] int32 pre-clipped. fwd_u8/mesh_u8:
    [N, T, K] uint8. topic_bits: [T, W]. nv/ni/dup: [T, K, N] uint8.

    On CUDA, have/dlv/dlv_new/nv/ni/dup are updated IN PLACE (as the Pallas
    kernel's aliases) and returned; new_valid is a new buffer. Callers must
    not reuse those inputs. Inside a peer group the frontier is this
    rank's columns, replicated here (the kernel reads the whole table and
    runs this rank's receiver rows)."""
    frontier = kc.replicate(frontier, dim=1)
    args = (frontier, have, dlv, dlv_new, vm, inv_n, window_old, valid_msg,
            nbr, fwd_u8, mesh_u8, topic_bits, nv, ni, dup)
    if not cudalib.use_kernel("hop", *args):
        return hop_plain(*args)
    w, n_src = frontier.shape
    n, k = nbr.shape
    t = topic_bits.shape[0]
    if w > _MAXW:
        raise ValueError(f"hop: W={w} words exceed the kernel's {_MAXW}")
    frontier_ptr = frontier.data_ptr()
    if any(x.data_ptr() == frontier_ptr for x in (have, dlv, dlv_new)):
        raise ValueError("hop: frontier must not alias have/dlv/dlv_new")
    wn, tkn, ntk = (w, n), (t, k, n), (n, t, k)
    cudalib.check_args("hop", [
        ("frontier", frontier, I32, (w, n_src)), ("have", have, I32, wn),
        ("dlv", dlv, I32, wn), ("dlv_new", dlv_new, I32, wn),
        ("vm", vm, I32, wn), ("inv_n", inv_n, I32, wn),
        ("window_old", window_old, I32, wn),
        ("valid_msg", valid_msg, I32, (w, 1)), ("nbr", nbr, I32, (n, k)),
        ("fwd_u8", fwd_u8, U8, ntk), ("mesh_u8", mesh_u8, U8, ntk),
        ("topic_bits", topic_bits, I32, (t, w)), ("nv", nv, U8, tkn),
        ("ni", ni, U8, tkn), ("dup", dup, U8, tkn)])
    new_valid = torch.empty_like(have)
    # the kernel reads the frontier n-major: one row per lookup
    cudalib.launch("hop", frontier.T.contiguous(), have, dlv, dlv_new, vm,
                   inv_n, window_old, valid_msg, nbr, fwd_u8, mesh_u8,
                   topic_bits, nv, ni, dup, new_valid, n, k, t, w)
    return HopOut(new_valid, have, dlv, dlv_new, nv, ni, dup)


# --- fused IWANT resolution (hopkernel.py:iwant_resolve_pallas) -------------

def iwant_resolve_plain(pend, answers, have, vm, inv_n, alive, data_ok_u8,
                        topic_bits, nbr, m) -> ResolveOut:
    """Plain PyTorch version of :func:`iwant_resolve`."""
    n, k = nbr.shape
    t = topic_bits.shape[0]
    ans = answers[:, nbr.long()]                          # [W, N, K]
    got_any = torch.zeros_like(have)
    got_valid_any = torch.zeros_like(have)
    nv, ni, bk = [], [], []
    for ki in range(k):
        asked = pack_words(pend == ki) & alive            # [W, N]
        ans_k = ans[:, :, ki]
        adm = torch.where(data_ok_u8[:, ki] != 0, -1, 0).to(I32)[None, :]
        got = asked & ans_k & ~have & adm
        gv = got & vm
        got_any = got_any | got
        got_valid_any = got_valid_any | gv
        bk.append(popcount(asked & ~ans_k).sum(0))
        nv.append([popcount(gv & topic_bits[ti][:, None]).sum(0)
                   for ti in range(t)])
        ni.append([popcount(got & inv_n & topic_bits[ti][:, None]).sum(0)
                   for ti in range(t)])

    def u8(x):
        return (x & 0xFF).to(U8)

    nv = u8(torch.stack([torch.stack([nv[ki][ti] for ki in range(k)])
                         for ti in range(t)]))
    ni = u8(torch.stack([torch.stack([ni[ki][ti] for ki in range(k)])
                         for ti in range(t)]))
    return ResolveOut(got_any, got_valid_any, nv, ni, u8(torch.stack(bk)))


def iwant_resolve(pend, answers, have, vm, inv_n, alive, data_ok_u8,
                  topic_bits, nbr, m) -> ResolveOut:
    """Fused IWANT resolution (gossipsub.go:698-739 + the broken-promise
    accounting of gossip_tracer.go:79-115).

    pend: [N, M] int32 pending-pull slot per message (-1 none); answers:
    [W, N] sender answer table (malicious columns zeroed); have/vm/inv_n:
    [W, N] receiver tables; alive: [W, 1]; data_ok_u8: [N, K] uint8
    graylist admission; topic_bits: [T, W]; nbr pre-clipped. The kernel
    takes W <= 8 and any K up to its tile of counts, (2T+1) * K <= 32768
    (:func:`_fused_shape_ok`); other shapes and M > 32 W are refused here,
    before any launch. Inside a peer group ``answers`` is this rank's
    columns, replicated here."""
    answers = kc.replicate(answers, dim=1)
    args = (pend, answers, have, vm, inv_n, alive, data_ok_u8, topic_bits,
            nbr)
    if not cudalib.use_kernel("iwant_resolve", *args):
        return iwant_resolve_plain(*args, m)
    w, n_src = answers.shape
    n, k = nbr.shape
    t = topic_bits.shape[0]
    if not _fused_shape_ok(w, t, k) or m > 32 * w:
        raise ValueError(f"iwant_resolve: W={w}, M={m}, T={t}, K={k} outside "
                         f"the kernel's W<={_MAXW}, M<=32W, (2T+1)K<="
                         f"{_RESOLVE_TILE_MAX}")
    wn = (w, n)
    cudalib.check_args("iwant_resolve", [
        ("pend", pend, I32, (n, m)), ("answers", answers, I32, (w, n_src)),
        ("have", have, I32, wn), ("vm", vm, I32, wn),
        ("inv_n", inv_n, I32, wn), ("alive", alive, I32, (w, 1)),
        ("data_ok_u8", data_ok_u8, U8, (n, k)),
        ("topic_bits", topic_bits, I32, (t, w)), ("nbr", nbr, I32, (n, k))])
    dev = answers.device
    got_any = torch.empty((w, n), dtype=I32, device=dev)
    got_valid_any = torch.empty((w, n), dtype=I32, device=dev)
    nv = torch.empty((t, k, n), dtype=U8, device=dev)
    ni = torch.empty((t, k, n), dtype=U8, device=dev)
    broken = torch.empty((k, n), dtype=U8, device=dev)
    # the kernel reads the answer table n-major: one row per lookup
    cudalib.launch("iwant_resolve", pend, answers.T.contiguous(), have, vm,
                   inv_n, alive, data_ok_u8, topic_bits, nbr, got_any,
                   got_valid_any, nv, ni, broken, n, k, t, w, m)
    return ResolveOut(got_any, got_valid_any, nv, ni, broken)


# --- fused IHAVE -> IWANT chooser (hopkernel.py:emit_pallas) ----------------

def emit_plain(window, have, gossip_u8, topic_bits, nbr, m,
               budget) -> torch.Tensor:
    """Plain PyTorch version of :func:`emit`."""
    n, k = nbr.shape
    off = window[:, nbr.long()] & _expand_topic(gossip_u8, topic_bits)
    assigned = have
    pend = torch.full((n, m), -1, dtype=I32, device=window.device)
    for ki in range(k):
        masked = off[:, :, ki] & ~assigned                # [W, N]
        off_u = unpack_words(masked, m)                   # [N, M]
        # inclusive prefix count: the first `budget` offers are taken
        take = off_u & (prefix_count_words(masked.T, m) <= budget)
        pend = torch.where(take, torch.full_like(pend, ki), pend)
        assigned = assigned | pack_words(take)
    return pend


def emit(window, have, gossip_u8, topic_bits, nbr, m, budget) -> torch.Tensor:
    """Fused IHAVE->IWANT chooser (gossipsub.go:654-676).

    window: [W, N] sender gossip-window table; have: [W, N] receiver seen
    sets; gossip_u8: [N, T, K] uint8 receiver-view gossip-edge planes
    (valid-slot and gossip-threshold masking applied); topic_bits: [T, W];
    nbr pre-clipped; budget: the per-sender iasked cap. Returns
    iwant_pending [N, M] int32 (chosen slot per message, -1 none). Inside
    a peer group ``window`` is this rank's columns, replicated here."""
    window = kc.replicate(window, dim=1)
    args = (window, have, gossip_u8, topic_bits, nbr)
    if not cudalib.use_kernel("emit", *args):
        return emit_plain(*args, m, budget)
    w, n_src = window.shape
    n, k = nbr.shape
    t = topic_bits.shape[0]
    if w > _MAXW or m > 32 * w:
        raise ValueError(f"emit: W={w}, M={m} outside the kernel's "
                         f"W<={_MAXW}, M<=32W")
    cudalib.check_args("emit", [
        ("window", window, I32, (w, n_src)), ("have", have, I32, (w, n)),
        ("gossip_u8", gossip_u8, U8, (n, t, k)),
        ("topic_bits", topic_bits, I32, (t, w)), ("nbr", nbr, I32, (n, k))])
    out = torch.empty((n, m), dtype=I32, device=window.device)
    # the kernel reads the window n-major: one row per lookup
    cudalib.launch("emit", window.T.contiguous(), have, gossip_u8,
                   topic_bits, nbr, out, n, k, t, w, m, int(budget),
                   emit_slot_bytes(k))
    return out
