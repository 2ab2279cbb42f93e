"""The single-device forms of the peer-group helpers the step calls: every
helper is the identity, the one device holds every row."""

from __future__ import annotations

import torch


def current_kernel_mesh():
    return None


def drain_halo_overflow() -> list:
    return []


def global_rows(n_local: int) -> int:
    return n_local


def row0() -> int:
    return 0


def row_ids(n_local: int, device) -> torch.Tensor:
    return torch.arange(n_local, device=device)


def own_rows(idx: torch.Tensor, n_local: int) -> torch.Tensor:
    return idx


def scratch_row(x: torch.Tensor) -> torch.Tensor:
    return x


def replicate(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return x


def owner_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x[idx.long()]


def psum(x: torch.Tensor) -> torch.Tensor:
    return x


def por(x: torch.Tensor) -> torch.Tensor:
    return x


def pany(x: torch.Tensor) -> torch.Tensor:
    return x
