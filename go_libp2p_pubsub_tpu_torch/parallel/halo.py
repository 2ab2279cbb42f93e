"""The halo route: each rank routes its own edge slots, and the values
that cross ranks travel in one all-to-all (port of parallel/halo.py).

Inside a peer group (parallel/kernel_context.py) the ``"replicated"``
route reads a sender-side [N, K] payload from its all-gathered whole,
N K elements a rank. ``sharded_route="halo"`` moves only what crosses:

1. each rank sorts its VALID source slots by (destination rank,
   destination slot), so the traffic to each rank is one contiguous
   bucket; invalid slots stay home as the identity;
2. each bucket is padded to a fixed capacity and the buckets are
   exchanged in one ``all_to_all_single`` (the capacity-factor pattern: a
   bucket that overflows POISONS the routed keys, so a trajectory test
   fails loudly, and the overflow count is summed over the group into
   ``SimState.halo_overflow`` by ``engine.step``);
3. each rank sorts the pairs it received together with its own invalid
   slots' identities by global destination key: ascending keys within
   one rank's rows are that rank's flat order.

The edge map is an involution, so pushing each slot's value to its
partner equals gathering from the partner: the result is bit-equal to
the replicated route's on every valid slot, and an invalid slot keeps its
own value (which every caller masks).

The capacity rule, :func:`required_capacity_factor` and
:func:`required_bucket_capacity` are the reference's (host-side numpy).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import kernel_context as kc

_BIG = 2 ** 31 - 1
_I32 = torch.int32


def _bucket_capacity(ld: int, n_dev: int) -> int:
    """The per-(src, dst) bucket capacity: the group's exact
    ``bucket_capacity`` when set, else ``capacity_factor`` times the
    uniform mean ``ceil(ld / n_dev)``, at most ``ld``."""
    ctx = kc.current_kernel_mesh()
    exact = ctx.bucket_capacity if ctx is not None else 0
    if exact > 0:
        return min(ld, exact)
    factor = ctx.capacity_factor if ctx is not None else 4
    return min(ld, factor * (-(-ld // n_dev)))


def required_capacity_factor(neighbors, reverse_slot, n_dev: int) -> int:
    """The smallest integer capacity factor that fits every (src, dst)
    bucket of this underlay on an ``n_dev``-way peer split (host-side;
    assignable to ``SimConfig.halo_capacity_factor``)."""
    nbr = np.asarray(neighbors)
    rks = np.asarray(reverse_slot)
    n, k = nbr.shape
    if n_dev <= 0 or n % n_dev:
        raise ValueError(
            f"required_capacity_factor: n_peers={n} must divide evenly "
            f"over n_dev={n_dev} (the peer sharding asserts the same)")
    nl = n // n_dev
    valid = (nbr >= 0) & (rks >= 0)
    src_dev = np.repeat(np.arange(n) // nl, k).reshape(n, k)
    dest_dev = np.clip(nbr, 0, n - 1) // nl
    pair = (src_dev * n_dev + dest_dev)[valid]
    counts = np.bincount(pair, minlength=n_dev * n_dev)
    mean_cap = -(-nl * k // n_dev)                  # ceil(Ld / D)
    return math.ceil(int(counts.max()) / mean_cap) if mean_cap else 0


def required_bucket_capacity(neighbors, reverse_slot, n_dev: int,
                             buckets=None) -> int:
    """The exact worst (src, dst) bucket population of this underlay on an
    ``n_dev``-way peer split (assignable to
    ``SimConfig.halo_bucket_capacity``). With ``buckets`` (a
    ``cfg.degree_buckets`` partition whose every bucket's rows divide by
    ``n_dev``) the price is for the degree-bucketed flat exchange:
    sources at each bucket's own K ceiling, destinations flat reverse
    slots of the concatenated bucket space (halo.py:117-182)."""
    nbr = np.asarray(neighbors)
    rks = np.asarray(reverse_slot)
    n, k = nbr.shape
    if n_dev <= 0 or n % n_dev:
        raise ValueError(
            f"required_bucket_capacity: n_peers={n} must divide evenly "
            f"over n_dev={n_dev} (the peer sharding asserts the same)")
    if buckets is None:
        nl = n // n_dev
        valid = (nbr >= 0) & (rks >= 0)
        src_dev = np.repeat(np.arange(n) // nl, k).reshape(n, k)
        dest_dev = np.clip(nbr, 0, n - 1) // nl
        pair = (src_dev * n_dev + dest_dev)[valid]
        counts = np.bincount(pair, minlength=n_dev * n_dev)
        return int(counts.max()) if counts.size else 0
    bks = [(int(r), int(kb)) for r, kb in buckets]
    if sum(r for r, _ in bks) != n:
        raise ValueError(
            f"required_bucket_capacity: buckets cover "
            f"{sum(r for r, _ in bks)} rows but the underlay has {n}")
    for b, (r, kb) in enumerate(bks):
        if r % n_dev:
            raise ValueError(
                f"required_bucket_capacity: bucket {b} ({r} rows x k_ceil "
                f"{kb}) does not tile the {n_dev}-device mesh — realign "
                "the partition with topology.align_degree_buckets")
    starts = np.cumsum([0] + [r for r, _ in bks])[:-1]
    kbs = np.array([kb for _, kb in bks], np.int64)
    nbl = np.array([r // n_dev for r, _ in bks], np.int64)
    bases = np.cumsum([0] + [r * kb for r, kb in bks])[:-1].astype(np.int64)
    seg = nbl * kbs
    rows = np.arange(n)
    rb = np.searchsorted(starts, rows, side="right") - 1
    src_dev = ((rows - starts[rb]) // nbl[rb])[:, None]
    in_width = np.arange(k)[None, :] < kbs[rb][:, None]
    valid = (nbr >= 0) & (rks >= 0) & in_width
    jn = np.clip(nbr, 0, n - 1)
    cb = np.searchsorted(starts, jn, side="right") - 1
    flat = bases[cb] + (jn - starts[cb]) * kbs[cb] + np.clip(rks, 0, None)
    dest_dev = (flat - bases[cb]) // seg[cb]
    pair = (src_dev * n_dev + dest_dev)[valid]
    counts = np.bincount(pair, minlength=n_dev * n_dev)
    return int(counts.max()) if counts.size else 0


def _route_local(keys, dest_dev, valid, vals, ld: int, n_dev: int):
    """keys [Ld] int64: each local source slot's global destination key
    (a valid slot: its partner; an invalid one: its own global index,
    both bijective). ``vals``: [Ld] payloads of 4-byte dtypes. Returns
    (payloads in this rank's destination-flat order, the group's count of
    overflowed buckets as an int32 scalar)."""
    dev = keys.device
    cap = _bucket_capacity(ld, n_dev)
    dd_ext = torch.where(valid, dest_dev, n_dev)              # invalid: tail
    order = torch.sort(dd_ext * (2 ** 32) + keys, stable=True).indices
    dd_s, keys_s = dd_ext[order], keys[order]
    counts = torch.zeros(n_dev + 1, dtype=torch.int64, device=dev) \
        .index_add_(0, dd_s, torch.ones_like(dd_s))[:n_dev]   # valid only
    offsets = torch.cumsum(counts, 0) - counts
    idx = offsets[:, None] + torch.arange(cap, device=dev)[None, :]
    in_bucket = torch.arange(cap, device=dev)[None, :] < counts[:, None]
    overflow = (counts > cap).any()
    idx_c = idx.clamp(0, ld - 1).reshape(-1)
    send_keys = torch.where(in_bucket & ~overflow,
                            keys_s[idx_c].reshape(n_dev, cap), -1)
    # every payload moves as int32 bits, all in one exchange with the keys
    words = [v.view(_I32) if v.dtype != _I32 else v for v in vals]
    send = torch.stack([send_keys.to(_I32)] + [
        torch.where(in_bucket, w[order][idx_c].reshape(n_dev, cap), 0)
        for w in words], dim=1)                               # [D, 1+P, CAP]
    recv = kc.all_to_all(send.contiguous())
    recv_keys = recv[:, 0].reshape(-1).long()
    # merge: received pairs + the local invalid identities (key BIG for
    # padding and for local valid slots, which arrived by the exchange)
    mk = torch.where(recv_keys < 0, _BIG, recv_keys)
    lk = torch.where(valid, _BIG, keys)
    merged = torch.sort(torch.cat([mk, lk]), stable=True).indices[:ld]
    outs = []
    for i, (v, w) in enumerate(zip(vals, words)):
        o = torch.cat([recv[:, 1 + i].reshape(-1), w])[merged]
        outs.append(o.view(v.dtype) if v.dtype != _I32 else o)
    n_over = kc.psum((counts > cap).sum().to(_I32))
    return outs, n_over


def _check_ctx(what: str):
    ctx = kc.current_kernel_mesh()
    if ctx is None:
        # outside a group there is no rank to exchange with
        raise ValueError(f"{what} outside a kernel_mesh context")
    return ctx


def route_words_halo(x_w: torch.Tensor, neighbors: torch.Tensor,
                     reverse_slot: torch.Tensor) -> torch.Tensor:
    """``out[w, k, n] = x_w[w, neighbors[n, k]]`` for this rank's rows
    (k-major destination layout): ``x_w`` [W, nl] is this rank's columns,
    ``neighbors``/``reverse_slot`` [nl, K] its rows with global ids
    (halo.py:238-274)."""
    ctx = _check_ctx("route_words_halo")
    w, nl = x_w.shape
    k = neighbors.shape[1]
    n, n_dev, r0 = ctx.n, ctx.world, ctx.r0
    dev = x_w.device
    valid = ((neighbors >= 0) & (reverse_slot >= 0)).reshape(-1)
    jn = neighbors.clamp(0, n - 1).long()
    rk = reverse_slot.clamp(0, k - 1).long()
    own = (torch.arange(k, device=dev)[None, :] * n
           + (r0 + torch.arange(nl, device=dev))[:, None])    # k-major self
    keys = torch.where(valid.reshape(nl, k), rk * n + jn, own).reshape(-1)
    dest = (keys % n) // nl
    vals = [x_w[i][:, None].expand(nl, k).reshape(-1) for i in range(w)]
    outs, ovf = _route_local(keys, dest, valid, vals, nl * k, n_dev)
    kc.note_halo_overflow(ovf)
    return torch.stack([o.reshape(k, nl) for o in outs])


def route_payloads_halo(payloads: list, neighbors: torch.Tensor,
                        reverse_slot: torch.Tensor) -> list:
    """``out[n, k] = payload[jn[n, k], rk[n, k]]`` for each [nl, K]
    payload of this rank's rows (n-major destination layout), all riding
    one exchange (halo.py:277-309). Payloads are of 4-byte dtypes."""
    ctx = _check_ctx("route_payloads_halo")
    nl, k = neighbors.shape
    n, n_dev, r0 = ctx.n, ctx.world, ctx.r0
    dev = neighbors.device
    valid = ((neighbors >= 0) & (reverse_slot >= 0)).reshape(-1)
    jn = neighbors.clamp(0, n - 1).long()
    rk = reverse_slot.clamp(0, k - 1).long()
    own = ((r0 + torch.arange(nl, device=dev))[:, None] * k
           + torch.arange(k, device=dev)[None, :])            # n-major self
    keys = torch.where(valid.reshape(nl, k), jn * k + rk, own).reshape(-1)
    dest = (keys // k) // nl
    vals = [p.reshape(-1) for p in payloads]
    outs, ovf = _route_local(keys, dest, valid, vals, nl * k, n_dev)
    kc.note_halo_overflow(ovf)
    return [o.reshape(nl, k) for o in outs]


def route_bucketed_flat(payloads: list, revs: list) -> list:
    """The degree-bucketed flat reverse-edge exchange of this rank's rows
    (halo.py:312-386; sim/bucketed._exchange_flat under the halo route):
    ``payloads[b]``/``revs[b]`` are this rank's [Nb/P, Kb] window of
    bucket b at its own ceiling, ``revs`` the flat reverse indices into
    the whole ΣD space (an invalid slot points at itself). Each rank
    pushes its valid slots' payloads to the rank owning the reverse slot;
    the involution makes that the gather from the reverse slot, bit-equal
    to the replicated ``concat + flat[rev]``. Ascending flat keys within
    one rank's windows are its bucket-major local order."""
    ctx = _check_ctx("route_bucketed_flat")
    n_dev, rank = ctx.world, ctx.rank
    if len({p.dtype for p in payloads}) > 1:
        raise ValueError(
            "route_bucketed_flat: all bucket payloads must share one dtype "
            f"(got {[str(p.dtype) for p in payloads]}) — they concatenate "
            "into one flat exchange vector")
    shapes = [tuple(int(x) for x in p.shape) for p in payloads]
    seg = [nl * kb for nl, kb in shapes]                 # per rank
    bases = np.cumsum([0] + [n_dev * s for s in seg]).astype(np.int64)
    if bases[-1] > _BIG:
        raise ValueError(
            f"route_bucketed_flat: flat edge space of {int(bases[-1])} "
            "slots exceeds the int32 key range")
    dev = payloads[0].device
    jb = torch.from_numpy(bases[:-1]).to(dev)
    js = torch.tensor(seg, dtype=torch.int64, device=dev)
    own = torch.cat([int(bases[b]) + rank * seg[b]
                     + torch.arange(seg[b], device=dev)
                     for b in range(len(payloads))])
    keys = torch.cat([r.reshape(-1).long() for r in revs])
    valid = keys != own
    cbk = torch.searchsorted(jb, keys, right=True) - 1
    dest = (keys - jb[cbk]) // js[cbk]
    vals = [torch.cat([p.reshape(-1) for p in payloads])]
    outs, ovf = _route_local(keys, dest, valid, vals, sum(seg), n_dev)
    kc.note_halo_overflow(ovf)
    res, off = [], 0
    for (nl, kb), sg in zip(shapes, seg):
        res.append(outs[0][off:off + sg].reshape(nl, kb))
        off += sg
    return res
