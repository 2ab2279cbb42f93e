"""The process settings of every command here, made before torch is
imported: every cache the program or PyTorch builds goes under
``.bench_cache/`` in the checkout, at a fixed path, so that only a
checkout's first run builds; one host thread for tensor work
(``OMP_NUM_THREADS``), since nothing on the host path computes in
parallel and idle worker threads only take cores from the thread that
launches the card's work; ``USE_FLAX=0``, so that no library loads flax by
itself."""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def prepare() -> None:
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
