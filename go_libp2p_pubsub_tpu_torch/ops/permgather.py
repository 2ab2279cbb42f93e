"""The bit-table edge exchange (port of ops/permgather.py's
``_edge_table_pallas``).

``out[n, k]`` bit ``b % 32`` of group ``b // 32`` is table bit
``b * K + rk[n, k]`` of row ``jn[n, k]``: B sender-side bool planes over K
slots, packed b-major / slot-minor into one ``[N, ceil(B*K/32)]`` word table,
routed through the (sender, slot) -> (receiver, reverse_slot) permutation.
This carries the heartbeat's three packed exchanges
(ops/heartbeat.edge_gather_packed).

:func:`edge_table` takes the plain PyTorch version for CPU tensors and
launches the CUDA kernel (csrc/edge_table.cu) for CUDA tensors; anything
else raises. The reference's other formulations (scalar, rows, sort, mxu)
and its VMEM gates are TPU artefacts the port does not carry.
"""

from __future__ import annotations

import torch

from . import cudalib
from .bits import I32


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


def edge_table_plain(table: torch.Tensor, jn: torch.Tensor, rk: torch.Tensor,
                     b_planes: int) -> list[torch.Tensor]:
    """Plain PyTorch version: one ``[N, K]`` int32 word per 32-plane group."""
    _, _, nr, k, n_groups = _check(table, jn, rk, b_planes)
    rows = table[jn.long()]                                # [N, K, WB]
    accs = [torch.zeros((nr, k), dtype=I32, device=table.device)
            for _ in range(n_groups)]
    for b in range(b_planes):
        pos = (rk + b * k).long()
        word = torch.gather(rows, 2, (pos // 32)[..., None])[..., 0]
        bit = (word >> (pos % 32).to(I32)) & 1
        accs[b // 32] = accs[b // 32] | (bit << (b % 32))
    return accs


def edge_table(table: torch.Tensor, jn: torch.Tensor, rk: torch.Tensor,
               b_planes: int) -> list[torch.Tensor]:
    """Bit-table edge exchange: ``table`` [N, WB] int32 (uint32 bits), ``jn``
    and ``rk`` [N, K] int32 pre-clipped to valid range. Returns
    ``ceil(b_planes/32)`` tensors of [N, K] int32."""
    if not cudalib.use_kernel("edge_table", table, jn, rk):
        return edge_table_plain(table, jn, rk, b_planes)
    n, wb, nr, k, n_groups = _check(table, jn, rk, b_planes)
    cudalib.check_args("edge_table", [("table", table, I32, (n, wb)),
                                      ("jn", jn, I32, (nr, k)),
                                      ("rk", rk, I32, (nr, k))])
    out = torch.empty((n_groups, nr, k), dtype=I32, device=table.device)
    cudalib.launch("edge_table", table, jn, rk, out, nr, k, wb, b_planes)
    return list(out.unbind(0))
