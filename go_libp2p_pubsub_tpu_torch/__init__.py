"""go_libp2p_pubsub_tpu_torch: the batched gossipsub engine in PyTorch/CUDA.

The PyTorch counterpart of ``go_libp2p_pubsub_tpu``'s batched simulation
engine (``sim/``, ``ops/``), for an NVIDIA H100. The JAX package stays the
reference: every ported function is held to its JAX counterpart on the CPU
(tests/test_torch_*.py), and every hand-written CUDA kernel (``csrc/``) to
its plain PyTorch twin on the card (chip_smoke.py).

Layout mirrors the JAX package (``core/``, ``sim/``, ``ops/``). The package
imports torch and numpy only. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; with no GPU and no such argument they raise.
"""

__version__ = "0.1.0"

from .core.params import (  # noqa: F401
    GossipSubParams,
    PeerScoreThresholds,
    TopicScoreParams,
)
from .device import resolve_device  # noqa: F401
