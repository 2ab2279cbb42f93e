"""One file per hand-written kernel: ``KERNEL``, the substring of its name
in a profiler trace, and ``nbytes(args)``, the bytes one launch moves at
its least (each input read once, each output written once), from the
launch's recorded arguments. ``peaks.json`` holds the card's peak rates.
A file's name is the kernel's label in ``ops/cudalib.KERNELS``."""

from __future__ import annotations

import importlib
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def peaks() -> dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


def modules() -> dict:
    """label -> module, for every kernel file here."""
    out = {}
    for fn in sorted(os.listdir(HERE)):
        if fn.endswith(".py") and not fn.startswith("_"):
            out[fn[:-3]] = importlib.import_module(f"{__name__}.{fn[:-3]}")
    return out


def kernel_us(device_us: dict, kernel: str) -> float:
    """Device us of the trace's kernels whose name holds ``kernel``."""
    return sum(us for name, us in device_us.items() if kernel in name)
