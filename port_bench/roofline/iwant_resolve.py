"""csrc/iwant_resolve.cu, the IWANT resolution. Arguments as
``ops/hopkernel.iwant_resolve`` launches them: pend, answer rows, have,
vm, inv_n, alive, data_ok, topic_bits, nbr, got_any, got_valid_any, nv,
ni, broken, then n, k, t, w, m.

The kernel reads a receiver's nbr and data_ok rows and its have, vm and
inv_n words only where an alive message is pending from a slot, and the
answer table only where some slot is asked: that part depends on the
data, which a captured launch does not show. Counted here is what every
launch needs whatever the data: the pend rows, alive, the topic words
read, and every output written. The bound is a lower bound, so the share
of it is too."""

from __future__ import annotations

from ._bytes import tensor_bytes

KERNEL = "iwant_resolve_kernel"
ALWAYS = (0, 5, 7, 9, 10, 11, 12, 13)


def nbytes(args) -> int:
    return sum(tensor_bytes(args[i]) for i in ALWAYS)
