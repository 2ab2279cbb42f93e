"""csrc/hop.cu, one forwarding hop. Arguments as ``ops/hopkernel.hop``
launches them: frontier rows, have, dlv, dlv_new, vm, inv_n, window_old,
valid_msg, nbr, fwd, mesh, topic_bits, nv, ni, dup, new_valid, then n, k,
t, w. Every input read once; have, dlv, dlv_new, nv, ni and dup are
written back in place and new_valid is written, so those count twice."""

from __future__ import annotations

from ._bytes import all_tensor_bytes, tensor_bytes

KERNEL = "hop_kernel"
IN_PLACE = (1, 2, 3, 12, 13, 14)


def nbytes(args) -> int:
    return all_tensor_bytes(args) + sum(tensor_bytes(args[i])
                                        for i in IN_PLACE)
