"""The check that a run loaded no JAX: the top-level name of every module
in ``sys.modules`` (the part before the first dot), compared whole, so the
port ``go_libp2p_pubsub_tpu_torch`` passes and the JAX package
``go_libp2p_pubsub_tpu`` does not."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "go_libp2p_pubsub_tpu"})


def forbidden_loaded(modules=None) -> list:
    """Sorted top-level names of ``modules`` (default ``sys.modules``)
    that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
