"""The reverse-edge permutation and neighbour gathers (port of
ops/permgather.py).

Three kernels, each a wrapper that takes its plain PyTorch version for CPU
tensors and launches its CUDA kernel for CUDA tensors; anything else
raises:

- :func:`edge_table` (``_edge_table_pallas``, csrc/edge_table.cu): the
  bit-table edge exchange. ``out[n, k]`` bit ``b % 32`` of group ``b // 32``
  is table bit ``b * K + rk[n, k]`` of row ``jn[n, k]``: B sender-side bool
  planes over K slots, packed b-major / slot-minor into one
  ``[N, ceil(B*K/32)]`` word table, routed through the (sender, slot) ->
  (receiver, reverse_slot) permutation. It carries the heartbeat's packed
  exchanges (ops/heartbeat.edge_gather_packed) under ``"pallas"``.
- :func:`gather_words` (``_gather_words_pallas``, csrc/gather_words.cu):
  ``out[w, k, n] = x_w[w, nbr[n, k]]``, the non-fused data path's
  neighbour gather of a packed message table.
- :func:`permutation_gather` (``_gather_pallas``,
  csrc/permutation_gather.cu): ``out[n, k] = payload[jn[n, k], rk[n, k]]``
  for a 4-byte payload, behind churn's symmetric exchanges and flood
  publish's sender-side planes.

``edge_gather_mode`` picks one of the reference's five formulations for
each seam (:func:`resolve_mode`, :func:`resolve_words_mode`,
:func:`resolve_edge_packed_mode`; ``"auto"`` ranks them through
ops/dispatch.py under its ``"cuda"`` entry, which takes the kernels above):

- ``"pallas"``: the three kernels;
- ``"mxu"``: the flat take of ops/mxutake.py (the reference's
  ``take_words_twolevel``) for every words, bit-table and payload gather,
  with the bit extraction of :func:`_edge_table_mxu` as plain tensor ops;
- ``"scalar"``: the direct advanced-index gather;
- ``"rows"``: whole neighbour rows gathered, then the reverse slot (or the
  message bits) picked from them, through [N, K, K] and [N, K, M]
  temporaries;
- ``"sort"``: the (sender, slot) -> (receiver, reverse_slot) map is an
  involution of the N*K edge slots, so routing per-slot values to their
  receivers applies a permutation: ONE ``torch.sort`` of the destination
  keys (:func:`edge_sort_key`) gives it, and every payload lane of a call
  takes that same permutation (:func:`sort_permutation`), as the
  reference's one variadic ``lax.sort`` carries many lanes.

The formulations agree at every valid slot; at invalid slots (no
neighbour) ``scalar``/``rows`` read ``payload[clip(jn), clip(rk)]`` and
``sort`` leaves the source's own value, which every caller masks.

Eligibility follows the port's kernels, not the reference's TPU VMEM
budgets: the Hopper kernels take every shape the paths run, so an explicit
``"pallas"`` does not degrade to ``"rows"`` at large N as the reference's
does (permgather.py:353-367). The output is the same either way.
"""

from __future__ import annotations

import torch

from ..parallel import kernel_context as kc
from . import cudalib
from .bits import I32


_FORMS = ("scalar", "rows", "sort", "pallas", "mxu")


def _known(mode: str) -> None:
    if mode not in ("auto",) + _FORMS:
        raise ValueError(f"unknown edge_gather_mode {mode!r}")


def _payload_eligible(mode: str, itemsize: int, have_sort_key: bool) -> str:
    """``mode`` if it can run a payload of ``itemsize`` bytes, else the
    formulation it degrades to (permgather.py:485-505 without the VMEM
    gates): the flat take and the kernel move 4-byte words."""
    if mode == "mxu" and (itemsize != 4
                          or kc.current_kernel_mesh() is not None):
        # the flat payload take needs the whole table; inside a peer
        # group the reference's resolver sends it to scalar
        # (permgather.py:484-491)
        return "scalar"
    if mode == "sort" and not have_sort_key:
        return "scalar"
    if mode == "pallas" and itemsize < 4:
        return "rows"
    return mode


def resolve_mode(mode: str, payload_dtype, n: int, k: int,
                 have_sort_key: bool = False) -> str:
    """The payload permute's formulation (permgather.py:508-532): ``"auto"``
    walks ops/dispatch.py's ranking and takes the first eligible one."""
    _known(mode)
    itemsize = payload_dtype.itemsize
    if mode == "auto":
        from .dispatch import choose
        for cand in choose("edge_permute", n=n, k=k, itemsize=itemsize,
                           have_sort_key=have_sort_key):
            if _payload_eligible(cand, itemsize, have_sort_key) == cand:
                return cand
        return "scalar"
    return _payload_eligible(mode, itemsize, have_sort_key)


def _words_eligible(mode: str, itemsize: int, have_sort_key: bool) -> str:
    if mode == "sort" and not have_sort_key:
        return "rows"
    if mode in ("mxu", "pallas") and itemsize != 4:
        return "rows"
    return mode


def resolve_words_mode(mode: str, w: int, n: int, k: int,
                       itemsize: int = 4,
                       have_sort_key: bool = False) -> str:
    """The words gather's formulation (permgather.py:407-427): ``"auto"``
    walks ops/dispatch.py's ranking and takes the first eligible one; a
    ``"sort"`` without the caller's keys degrades to ``"rows"``."""
    _known(mode)
    if mode == "auto":
        from .dispatch import choose
        for cand in choose("words", w=w, n=n, k=k, itemsize=itemsize,
                           have_sort_key=have_sort_key):
            if _words_eligible(cand, itemsize, have_sort_key) == cand:
                return cand
        return "scalar"
    return _words_eligible(mode, itemsize, have_sort_key)


def resolve_edge_packed_mode(mode: str, n: int, k: int,
                             b_planes: int) -> str:
    """The packed edge exchange's formulation (permgather.py:370-390):
    ``"auto"`` takes ops/dispatch.py's first candidate (every formulation
    takes every shape here, so the reference's ride-along width
    ``extra_w``, which prices its VMEM gate, has no counterpart)."""
    _known(mode)
    if mode == "auto":
        from .dispatch import choose
        return choose("edge_packed", n=n, k=k, b=b_planes)[0]
    return mode


# --- the sort formulation (permgather.py:87-126) ----------------------------

def edge_sort_key(neighbors: torch.Tensor, reverse_slot: torch.Tensor,
                  k_major: bool) -> torch.Tensor:
    """Destination key of each SOURCE edge slot for the sort routes
    (permgather.py:87-118), flat n-major over the [N, K] slots.

    A valid slot (n, k) sends to its receiver's slot (jn, rk); an invalid
    one keeps its own index, so the keys stay a bijection of [0, N*K) (the
    edge map is an involution: valid slots map valid <-> valid) and the
    sort never sees a duplicate key. ``k_major``: True -> destination flat
    order ``k * N + n`` (for [W, K, N] outputs), False -> ``n * K + k``
    (for [N, K] outputs). int32 while N*K < 2**31, else int64.

    Inside a peer group (parallel/kernel_context.py) ``neighbors`` holds
    this rank's rows and the keys are those rows' keys in the whole
    network: global destinations and global own indices. The involution
    makes a slot's key also the source of that slot as a destination, so
    :func:`sort_permutation` of a rank's keys is the keys themselves."""
    nl, k = neighbors.shape
    n = kc.global_rows(nl)
    dt = I32 if n * k < 2 ** 31 else torch.int64
    dev = neighbors.device
    valid = (neighbors >= 0) & (reverse_slot >= 0)
    jn = neighbors.clamp(0, n - 1).to(dt)
    rk = reverse_slot.clamp(0, k - 1).to(dt)
    ar_n = (torch.arange(nl, dtype=dt, device=dev) + kc.row0())[:, None]
    ar_k = torch.arange(k, dtype=dt, device=dev)[None, :]
    if k_major:
        dest, own = rk * n + jn, ar_k * n + ar_n
    else:
        dest, own = jn * k + rk, ar_n * k + ar_k
    return torch.where(valid, dest, own).reshape(-1)


def sort_permutation(sort_key: torch.Tensor) -> torch.Tensor:
    """The permutation one sort of the destination keys gives:
    ``out_flat[d] = in_flat[perm[d]]`` moves every source slot's value to
    its destination. The keys are distinct, so any sort gives this
    order; the reference's ``lax.sort`` gives the same. Inside a peer
    group a rank's own destinations are its own slots, and the source of
    each is its n-major key (:func:`edge_sort_key`): no sort runs, and the
    payload the result indexes is the replicated one."""
    if kc.current_kernel_mesh() is not None:
        return sort_key.long()
    return torch.sort(sort_key, stable=True).indices


def _gather_sort(payload, sort_key):
    """``out_flat[dest] = payload_flat[src]`` by the sort's permutation,
    n-major destination keys -> [N, K]."""
    k = payload.shape[1]
    return payload.reshape(-1)[sort_permutation(sort_key)].reshape(-1, k)


def _gather_scalar(payload, jn, rk):
    return payload[jn.long(), rk.long()]


def _gather_rows(payload, jn, rk):
    rows = payload[jn.long()]                              # [N, K, K] rows
    return torch.gather(rows, -1, rk.long()[..., None])[..., 0]


# --- the bit-table edge exchange (permgather.py:_edge_table_pallas) ---------

def _check(table, jn, rk, b_planes):
    n, wb = table.shape
    nr, k = jn.shape
    if rk.shape != (nr, k):
        raise ValueError(f"edge_table: jn {tuple(jn.shape)} and rk "
                         f"{tuple(rk.shape)} differ")
    if wb * 32 < b_planes * k:
        raise ValueError(f"edge_table: table width {wb} words cannot hold "
                         f"{b_planes} planes x {k} slots")
    for name, x in (("table", table), ("jn", jn), ("rk", rk)):
        if x.dtype != I32:
            raise TypeError(f"edge_table: {name} must be int32, got {x.dtype}")
    return n, wb, nr, k, (b_planes + 31) // 32


def _extract_bits(rows, rk, b_planes, k, n_groups):
    """Bit ``b * K + rk`` of each fetched row, packed 32 planes per group
    (rows: [..., WB] int32 per edge, rk: [...] int32)."""
    accs = [torch.zeros(rk.shape, dtype=I32, device=rk.device)
            for _ in range(n_groups)]
    for b in range(b_planes):
        pos = (rk + b * k).long()
        word = torch.gather(rows, -1, (pos // 32)[..., None])[..., 0]
        bit = (word >> (pos % 32).to(I32)) & 1
        accs[b // 32] = accs[b // 32] | (bit << (b % 32))
    return accs


def edge_table_plain(table: torch.Tensor, jn: torch.Tensor, rk: torch.Tensor,
                     b_planes: int) -> list[torch.Tensor]:
    """Plain PyTorch version: one ``[N, K]`` int32 word per 32-plane group."""
    _, _, _, k, n_groups = _check(table, jn, rk, b_planes)
    return _extract_bits(table[jn.long()], rk, b_planes, k, n_groups)


def edge_table_row_words(wb: int) -> int:
    """The row width csrc/edge_table.cu reads a [N, WB] table at: WB for
    WB <= 2, else WB rounded up to a multiple of 4 words, so that a row is
    aligned to its vector width and spans no more 32-byte sectors than its
    bytes need."""
    return wb if wb <= 2 else -(-wb // 4) * 4


def edge_table(table: torch.Tensor, jn: torch.Tensor, rk: torch.Tensor,
               b_planes: int) -> list[torch.Tensor]:
    """Bit-table edge exchange: ``table`` [N, WB] int32 (uint32 bits), ``jn``
    and ``rk`` [N, K] int32 pre-clipped to valid range. Returns
    ``ceil(b_planes/32)`` tensors of [N, K] int32. On the card a table
    whose rows are not :func:`edge_table_row_words` wide is padded here,
    and one at an address that is no multiple of 16 bytes is copied."""
    table = kc.replicate(table)          # the table whole, rows local
    if not cudalib.use_kernel("edge_table", table, jn, rk):
        return edge_table_plain(table, jn, rk, b_planes)
    n, wb, nr, k, n_groups = _check(table, jn, rk, b_planes)
    cudalib.check_args("edge_table", [("table", table, I32, (n, wb)),
                                      ("jn", jn, I32, (nr, k)),
                                      ("rk", rk, I32, (nr, k))])
    pw = edge_table_row_words(wb)
    if pw != wb:
        table = torch.nn.functional.pad(table, (0, pw - wb))
    elif table.data_ptr() % 16:
        table = table.clone()           # the kernel reads 16-byte aligned
    out = torch.empty((n_groups, nr, k), dtype=I32, device=table.device)
    cudalib.launch("edge_table", table, jn, rk, out, nr, k, pw, b_planes)
    return list(out.unbind(0))


def _edge_table_mxu(table: torch.Tensor, jn: torch.Tensor, rk: torch.Tensor,
                    b_planes: int, extra_words=()):
    """The bit-table exchange under ``edge_gather_mode="mxu"``
    (permgather.py:303-350): every edge's table row, with the rows of the
    ``extra_words`` tables ([W_i, N] int32) concatenated beside it, fetched
    by ONE :func:`~.mxutake.take_rows` at n-major ``idx = jn.reshape(-1)``
    (the reference concatenates word-major and takes ``[WB + ΣW_i, N]``);
    the bit extraction is plain tensor ops. Returns ``(groups, extras)``:
    one [N, K] int32 word per 32-plane group, and each extra table's
    receiver view ``out[w, k, n] = tab[w, jn[n, k]]`` as a [W_i, K, N]
    (transposed) view."""
    from .mxutake import take_rows

    _, wb, nr, k, n_groups = _check(table, jn, rk, b_planes)
    tabs = kc.replicate(torch.cat([table, *(e.T for e in extra_words)],
                                  dim=1))
    rows_all = take_rows(tabs, jn.reshape(-1)).reshape(nr, k, tabs.shape[1])
    groups = _extract_bits(rows_all[..., :wb], rk, b_planes, k, n_groups)
    extras, ofs = [], wb
    for tab in extra_words:
        wt = tab.shape[0]
        extras.append(rows_all[..., ofs:ofs + wt].permute(2, 1, 0))
        ofs += wt                                           # [W_i, K, N]
    return groups, extras


# --- the words gather (permgather.py:_gather_words_pallas) ------------------

def _check_words(x_w, nbr):
    for name, x in (("x_w", x_w), ("nbr", nbr)):
        if x.dtype != I32 or x.dim() != 2:
            raise TypeError(f"gather_words: {name} must be a 2-D int32 "
                            f"tensor, got {x.dtype} {tuple(x.shape)}")


def gather_words_plain(x_w: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`gather_words`."""
    _check_words(x_w, nbr)
    return x_w[:, nbr.T.long()]


def gather_words(x_w: torch.Tensor, nbr: torch.Tensor,
                 mode: str = "pallas", m: int | None = None,
                 sort_key: torch.Tensor | None = None) -> torch.Tensor:
    """``out[w, k, n] = x_w[w, nbr[n, k]]``: ``x_w`` [W, N_src] int32 packed
    words, ``nbr`` [N, K] int32 pre-clipped to [0, N_src); returns the
    k-major receiver view [W, K, N] in the formulation ``mode`` resolves to
    (:func:`resolve_words_mode`; permgather.py:430-481).

    ``"pallas"``: the kernel. On the card it reads the table interleaved
    into n-major rows (``x_w.T.contiguous()``, 0.4 MB at [2, 51200]), a
    source's W words in one 32-byte L2 sector, and stages ``nbr`` in
    chunks of slots, so it takes any K. ``"mxu"``: the flat take at
    k-major ``idx = nbr.T.reshape(-1)``. ``"scalar"``: one indexed gather
    per word. ``"rows"``: the window unpacked to [N_src, m] bools (``m``
    messages, default 32 W), whole rows gathered, repacked. ``"sort"``:
    each source's words carried along its K slots by the permutation of
    the k-major ``sort_key`` (:func:`edge_sort_key`; needs N_src = N)."""
    _check_words(x_w, nbr)
    n, k = nbr.shape
    mode = resolve_words_mode(mode, x_w.shape[0], kc.global_rows(n), k,
                              x_w.element_size(),
                              have_sort_key=sort_key is not None)
    x_w = kc.replicate(x_w, dim=1)       # the table whole, rows local
    w, n_src = x_w.shape
    if mode == "sort" and kc.current_kernel_mesh() is not None:
        # a rank's destination (n, k) reads the source row its k-major
        # key names (edge_sort_key): jn, or n itself for an invalid slot
        return x_w[:, (sort_key.long() % n_src).reshape(n, k).T]
    if mode == "sort":
        # source slot s = n * K + k carries x_w[:, n]; out[:, d] takes the
        # slot the permutation brings to d
        src = torch.div(sort_permutation(sort_key), k, rounding_mode="floor")
        return x_w[:, src].reshape(w, k, n)
    if mode == "scalar":
        return x_w[:, nbr.T.long()]
    if mode == "rows":
        from .bits import pack_bool, unpack_words
        planes = unpack_words(x_w, 32 * w if m is None else m)
        rows = planes[nbr.long()]                          # [N, K, M]
        return pack_bool(rows).permute(2, 1, 0)            # [W, K, N]
    if mode == "mxu":
        from .mxutake import take_words
        return take_words(x_w, nbr.T.reshape(-1)).reshape(w, k, n)
    if not cudalib.use_kernel("gather_words", x_w, nbr):
        return gather_words_plain(x_w, nbr)
    cudalib.check_args("gather_words", [("x_w", x_w, I32, (w, n_src)),
                                        ("nbr", nbr, I32, (n, k))])
    rows = x_w.T.contiguous()                              # [N_src, W]
    out = torch.empty((w, k, n), dtype=I32, device=x_w.device)
    cudalib.launch("gather_words", rows, nbr, out, n, k, w)
    return out


# --- the payload permute (permgather.py:_gather_pallas) ---------------------

def _check_payload(payload, jn, rk):
    if payload.dim() != 2 or payload.element_size() != 4 \
            or payload.dtype.is_complex:
        raise TypeError(f"permutation_gather: payload must be a 2-D tensor "
                        f"of a 4-byte dtype, got {payload.dtype} "
                        f"{tuple(payload.shape)}")
    if jn.dtype != I32 or rk.dtype != I32 or jn.shape != rk.shape \
            or jn.dim() != 2:
        raise TypeError(f"permutation_gather: jn and rk must be [N, K] "
                        f"int32, got {jn.dtype} {tuple(jn.shape)} and "
                        f"{rk.dtype} {tuple(rk.shape)}")


def permutation_gather_plain(payload: torch.Tensor, jn: torch.Tensor,
                             rk: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`permutation_gather`."""
    _check_payload(payload, jn, rk)
    return payload[jn.long(), rk.long()]


def permutation_gather(payload: torch.Tensor, jn: torch.Tensor,
                       rk: torch.Tensor, mode: str = "pallas",
                       sort_key: torch.Tensor | None = None) -> torch.Tensor:
    """``out[n, k] = payload[jn[n, k], rk[n, k]]``; ``jn``/``rk`` [N, K]
    int32 pre-clipped to valid range (callers mask invalid slots on the
    result), in the formulation ``mode`` resolves to
    (:func:`resolve_mode`; permgather.py:535-569). ``"pallas"``: the
    kernel, for a [N_src, K_src] payload of any 4-byte dtype, whose bits it
    moves as int32 (a float32 payload comes back bit for bit). ``"mxu"``:
    :func:`~.mxutake.take_payload`. ``"scalar"``, ``"rows"``: the indexed
    and the row gathers, any dtype. ``"sort"``: the permutation of the
    n-major ``sort_key`` (:func:`edge_sort_key`) applied to an [N, K]
    payload."""
    mode = resolve_mode(mode, payload.dtype,
                        kc.global_rows(payload.shape[0]), payload.shape[1],
                        have_sort_key=sort_key is not None)
    payload = kc.replicate(payload)      # the payload whole, rows local
    if mode == "sort":
        return _gather_sort(payload, sort_key)
    if mode == "scalar":
        return _gather_scalar(payload, jn, rk)
    if mode == "rows":
        return _gather_rows(payload, jn, rk)
    if mode == "mxu":
        from .mxutake import take_payload
        return take_payload(payload, jn, rk)
    if not cudalib.use_kernel("permutation_gather", payload, jn, rk):
        return permutation_gather_plain(payload, jn, rk)
    _check_payload(payload, jn, rk)
    n_src, k_src = payload.shape
    n, k = jn.shape
    words = payload.view(I32)
    cudalib.check_args("permutation_gather", [
        ("payload", words, I32, (n_src, k_src)), ("jn", jn, I32, (n, k)),
        ("rk", rk, I32, (n, k))])
    out = torch.empty((n, k), dtype=I32, device=payload.device)
    cudalib.launch("permutation_gather", words, jn, rk, out, n, k, k_src)
    return out.view(payload.dtype)
