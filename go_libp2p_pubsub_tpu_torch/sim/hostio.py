"""Host-transfer helpers shared by every plane that fetches device values
(port of sim/hostio.py).

The reference needs them for JAX's multi-process global arrays and typed
keys. Their torch meaning:

- :func:`fetch_local`: the host copy of a tensor, in the reference's
  dtype where the port holds unsigned bits in a signed tensor;
- :func:`key_data`: the uint32 values of the port's keys (``rng``'s int64
  tensors holding uint32 values);
- :func:`is_deleted`: whether a tensor of a state has released its
  storage.
"""

from __future__ import annotations

import numpy as np
import torch


def fetch_local(x, dtype=None) -> np.ndarray:
    """Host copy of ``x`` (a tensor on any device, or an array-like).
    ``dtype`` views the copy as another dtype of the same item size: the
    reference's uint32 / uint16 for the port's int32 / int16 bits."""
    if isinstance(x, torch.Tensor):
        a = x.detach().to("cpu", copy=True).numpy()
    else:
        a = np.array(x)
    return a if dtype is None else a.view(dtype)


def key_data(keys) -> np.ndarray:
    """The uint32 key words of a key (``[2]``) or of a key array
    (``[C, 2]``)."""
    return fetch_local(keys).astype(np.uint32)


def is_deleted(tree) -> bool:
    """True when any tensor of ``tree`` (a tensor or a NamedTuple / list
    of them, nested) has released its storage (``untyped_storage().
    resize_(0)``), so it can no longer be read."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() > 0 and tree.untyped_storage().nbytes() == 0
    if isinstance(tree, (tuple, list)):
        return any(is_deleted(leaf) for leaf in tree)
    return False
