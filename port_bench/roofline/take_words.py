"""csrc/take_words.cu, the two-level take. Arguments as
``ops/mxutake._take`` launches them: the n-major table, idx, the output,
then r, w and the output strides. Every input read once, the output
written once."""

from __future__ import annotations

from ._bytes import all_tensor_bytes

KERNEL = "take_words_kernel"


def nbytes(args) -> int:
    return all_tensor_bytes(args)
