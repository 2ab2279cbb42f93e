"""Device policy: entry points run on ``cuda`` unless the caller asks for the
CPU. There is no silent fallback: with no GPU and no ``device`` argument an
entry point raises instead of running on the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; ``None`` means ``cuda``, which must be
    present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} requested but CUDA is not "
                           "available")
    return dev


def check_on(state_device: torch.device, device) -> torch.device:
    """Resolve ``device`` and require the state to lie on it."""
    dev = resolve_device(device)
    if state_device.type != dev.type:
        raise RuntimeError(
            f"state lies on {state_device} but the run was asked for {dev}; "
            "move the state or pass the matching device")
    return dev
