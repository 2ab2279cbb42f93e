"""csrc/permutation_gather.cu, the payload permute. Arguments as
``ops/permgather.permutation_gather`` launches them: the payload words,
jn, rk, the output, then n, k, k_src. Every input read once, the output
written once."""

from __future__ import annotations

from ._bytes import all_tensor_bytes

KERNEL = "permutation_gather_kernel"


def nbytes(args) -> int:
    return all_tensor_bytes(args)
