"""csrc/emit.cu, the IHAVE -> IWANT chooser. Arguments as
``ops/hopkernel.emit`` launches them: window rows, have, gossip planes,
topic_bits, nbr, the [N, M] output, then n, k, t, w, m, budget and the
slot bytes. Every input read once, the output written once."""

from __future__ import annotations

from ._bytes import all_tensor_bytes

KERNEL = "emit_kernel"


def nbytes(args) -> int:
    return all_tensor_bytes(args)
