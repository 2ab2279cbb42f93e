"""csrc/gather_words.cu, the words gather. Arguments as
``ops/permgather.gather_words`` launches them: the n-major rows, nbr, the
[W, K, N] output, then n, k, w. Every input read once, the output
written once."""

from __future__ import annotations

from ._bytes import all_tensor_bytes

KERNEL = "gather_words_kernel"


def nbytes(args) -> int:
    return all_tensor_bytes(args)
