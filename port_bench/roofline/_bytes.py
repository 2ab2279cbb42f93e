"""Shared arithmetic of the roofline files: the bytes of a recorded
launch argument. A tensor is recorded as ``("t", shape, itemsize)``, an
int as itself."""

from __future__ import annotations

import math


def tensor_bytes(arg) -> int:
    return math.prod(arg[1]) * arg[2] if isinstance(arg, tuple) else 0


def all_tensor_bytes(args) -> int:
    return sum(tensor_bytes(a) for a in args)
