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
  (receiver, reverse_slot) permutation. It carries the heartbeat's three
  packed exchanges (ops/heartbeat.edge_gather_packed).
- :func:`gather_words` (``_gather_words_pallas``, csrc/gather_words.cu):
  ``out[w, k, n] = x_w[w, nbr[n, k]]``, the non-fused data path's
  neighbour gather of a packed message table.
- :func:`permutation_gather` (``_gather_pallas``,
  csrc/permutation_gather.cu): ``out[n, k] = payload[jn[n, k], rk[n, k]]``
  for a 4-byte payload, behind churn's symmetric exchanges.

``edge_gather_mode`` picks the formulation (:func:`resolve_gather_mode`):
``"auto"`` and ``"pallas"`` mean the three kernels above; ``"mxu"`` routes
every words, bit-table and payload gather through the flat take of
ops/mxutake.py (the reference's ``take_words_twolevel``), with the bit
extraction of :func:`_edge_table_mxu` as plain tensor ops. The reference's
scalar, rows and sort formulations, its sort keys and its VMEM gates are
not ported.
"""

from __future__ import annotations

import torch

from . import cudalib
from .bits import I32

def resolve_gather_mode(mode: str) -> str:
    """The port's formulation for ``SimConfig.edge_gather_mode``: ``"auto"``
    and ``"pallas"`` -> ``"pallas"`` (kernels 4-6), ``"mxu"`` -> ``"mxu"``
    (the flat take, kernel 7). The reference's other formulations raise."""
    if mode in ("auto", "pallas"):
        return "pallas"
    if mode == "mxu":
        return "mxu"
    if mode in ("scalar", "rows", "sort"):
        raise NotImplementedError(
            f"edge_gather_mode={mode!r} is not ported yet: the port has the "
            "pallas and mxu formulations only (ROADMAP.md, Queue 1 item 3)")
    raise ValueError(f"unknown edge_gather_mode {mode!r}")


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
    tabs = torch.cat([table, *(e.T for e in extra_words)], dim=1)
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
                 mode: str = "pallas") -> torch.Tensor:
    """``out[w, k, n] = x_w[w, nbr[n, k]]``: ``x_w`` [W, N_src] int32 packed
    words, ``nbr`` [N, K] int32 pre-clipped to [0, N_src); returns the
    k-major receiver view [W, K, N]. On the card the kernel reads the table
    interleaved into n-major rows (``x_w.T.contiguous()``, 0.4 MB at [2,
    51200]), a source's W words in one 32-byte L2 sector, and stages
    ``nbr`` in chunks of slots, so it takes any K. ``mode="mxu"``
    routes it through the flat take at k-major ``idx = nbr.T.reshape(-1)``
    (permgather.py:462-470)."""
    if mode == "mxu":
        from .mxutake import take_words
        _check_words(x_w, nbr)
        n, k = nbr.shape
        return take_words(x_w, nbr.T.reshape(-1)).reshape(x_w.shape[0], k, n)
    if mode != "pallas":
        raise ValueError(f"gather_words: unknown mode {mode!r}")
    if not cudalib.use_kernel("gather_words", x_w, nbr):
        return gather_words_plain(x_w, nbr)
    _check_words(x_w, nbr)
    w, n_src = x_w.shape
    n, k = nbr.shape
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
                       rk: torch.Tensor, mode: str = "pallas") -> torch.Tensor:
    """``out[n, k] = payload[jn[n, k], rk[n, k]]`` for a [N_src, K_src]
    payload of any 4-byte dtype; ``jn``/``rk`` [N, K] int32 pre-clipped to
    valid range (callers mask invalid slots on the result). The kernel moves
    the payload's bits as int32, so a float32 payload comes back bit for
    bit. ``mode="mxu"`` takes :func:`~.mxutake.take_payload`."""
    if mode == "mxu":
        from .mxutake import take_payload
        return take_payload(payload, jn, rk)
    if mode != "pallas":
        raise ValueError(f"permutation_gather: unknown mode {mode!r}")
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
