"""csrc/edge_table.cu, the bit-table edge exchange. Arguments as
``ops/permgather.edge_table`` launches them: the [N, PW] table (padded to
the kernel's row width), jn, rk, the output words, then nr, k, pw and the
plane count. The caller's table of ceil(B K / 32) words a row, jn and rk
read once, the output written once."""

from __future__ import annotations

from ._bytes import tensor_bytes

KERNEL = "edge_table_kernel"


def nbytes(args) -> int:
    table, jn, rk, out, nr, k, pw, b_planes = args
    words = (b_planes * k + 31) // 32
    return table[1][0] * words * 4 + tensor_bytes(jn) + tensor_bytes(rk) \
        + tensor_bytes(out)
