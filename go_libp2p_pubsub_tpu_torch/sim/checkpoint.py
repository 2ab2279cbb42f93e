"""Exact network checkpoints: save and restore the whole SimState or
degree-bucketed BucketedState (port of sim/checkpoint.py, its ``.npz``
form; the reference's orbax form needs JAX).

A checkpoint is one compressed ``.npz`` of every field, in the
reference's dtypes (``state.state_to_numpy``: uint32 words, uint16 bf16
patterns), so a checkpoint either package saved restores in the other,
bit for bit, in either storage layout. A BucketedState's arrays are keyed
as the reference keys them (``g.<field>``, ``e<b>.<field>``, ``rev<b>``;
``bucketed.named_leaves``). Resuming from it lands on the uninterrupted
trajectory.

- ``save(path, state, cfg=...)`` also writes a ``<path>.fingerprint``
  sidecar: the config's digest (:func:`config_fingerprint`, the
  reference's ``sha256(repr(cfg))``), then ``fleet=``,
  ``state_precision=``, ``degree_buckets=`` (the bucket partition, under
  a bucketed config), ``processes=`` and caller-supplied ``extra`` lines
  in clear (:func:`sidecar_meta`).
- Crash atomicity: payload and sidecar each go to a temp path and are
  renamed into place, payload first, so an interrupted save leaves the
  previous checkpoint or nothing at ``path``. A torn payload raises
  :class:`CheckpointCorrupt` (a ValueError).
- ``restore(path, like, cfg=...)`` checks every field against ``like``
  and raises ``ValueError`` naming the field on a shape or dtype
  mismatch; a field missing from the file restores from ``like``. With
  ``cfg`` the digest is compared, and a mismatch of the bucket
  partition, of the fleet axis or of the storage precision is refused by
  name.
"""

from __future__ import annotations

import glob
import hashlib
import os

import numpy as np
import torch

from .bucketed import BucketedState, EdgePlanes, named_leaves
from .hostio import fetch_local
from .state import SimState, field_from_reference, reference_dtype


class CheckpointCorrupt(ValueError):
    """The checkpoint payload is unreadable (torn write, truncation,
    missing file), as distinct from a mismatched checkpoint (a plain
    ValueError)."""


def config_fingerprint(cfg, fleet: int | None = None) -> str:
    """sha256 of the config's repr (every field in definition order, the
    fault plan included): byte for byte the reference's digest of the
    same config. ``fleet`` folds a leading fleet axis of B member states
    into the digest."""
    base = repr(cfg)
    if fleet is not None:
        base += f"|fleet_axis B={int(fleet)}"
    return hashlib.sha256(base.encode()).hexdigest()


def fleet_axis(state) -> int | None:
    """Leading fleet axis of a SimState (its ``tick`` is ``[B]``), or None
    for a single simulation (a scalar ``tick``)."""
    tick = state.tick
    return int(tick.shape[0]) if tick.dim() >= 1 else None


def _sidecar(path: str) -> str:
    return path + ".fingerprint"


def _named_leaves(state) -> list:
    """``[(name, tensor, reference dtype), ...]`` of a checkpointable
    state, in the reference's order (checkpoint.py:91-111): a SimState
    names its fields, a BucketedState ``g.<field>``, ``e<b>.<field>``,
    ``rev<b>``."""
    if isinstance(state, SimState):
        return [(f, v, reference_dtype(state, f))
                for f, v in zip(SimState._fields, state)]
    if isinstance(state, BucketedState):
        return named_leaves(state)
    raise TypeError(
        f"checkpoint: unsupported state type {type(state).__name__}; "
        "expected SimState or BucketedState")


def _bucket_string(cfg) -> str:
    """The sidecar's clear form of a degree-bucket partition:
    ``"512x64,512x32,..."`` (rows x k_ceil, hubs first), "" when dense."""
    bks = cfg.degree_buckets
    if bks is None:
        return ""
    return ",".join(f"{int(r)}x{int(k)}" for r, k in bks)


def _unflatten(like, values: list):
    """A state of ``like``'s kind from its leaves' values in
    :func:`_named_leaves` order."""
    if isinstance(like, SimState):
        return SimState(*values)
    nf, ne = len(SimState._fields), len(EdgePlanes._fields)
    nb = len(like.e)
    g = SimState(*values[:nf])
    e = tuple(EdgePlanes(*values[nf + b * ne:nf + (b + 1) * ne])
              for b in range(nb))
    return BucketedState(g=g, e=e, rev=tuple(values[nf + nb * ne:]))


def _process_count() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def save(path: str, state, cfg=None, processes=None,
         extra: dict | None = None) -> None:
    """Write ``path`` (``.npz`` added when missing) and, with ``cfg``, its
    fingerprint sidecar. ``processes`` is the process count the state was
    gathered at (default: the ``torch.distributed`` world size, else 1),
    written in clear and never a refusal; ``extra`` adds ``key=value``
    lines."""
    leaves = _named_leaves(state)
    path = os.path.abspath(path)
    tmp = f"{path}.tmp{os.getpid()}"
    # stale temps of killed saves, of any pid (one writer per path)
    for stale in glob.glob(f"{path}.tmp*") + \
            glob.glob(f"{_sidecar(path)}.tmp*"):
        try:
            os.remove(stale)
        except OSError:
            pass
    arrs = {name: fetch_local(v, dt) for name, v, dt in leaves}
    final = path if path.endswith(".npz") else path + ".npz"
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **arrs)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, final)
    if cfg is None:
        return
    fleet = fleet_axis(state)
    side_tmp = f"{_sidecar(path)}.tmp{os.getpid()}"
    with open(side_tmp, "w") as f:
        f.write(config_fingerprint(cfg, fleet=fleet) + "\n")
        if fleet is not None:
            f.write(f"fleet={fleet}\n")
        f.write(f"state_precision={cfg.state_precision}\n")
        bks = _bucket_string(cfg)
        if bks:
            f.write(f"degree_buckets={bks}\n")
        p = _process_count() if processes is None else int(processes)
        f.write(f"processes={p}\n")
        for k, v in (extra or {}).items():
            f.write(f"{k}={v}\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(side_tmp, _sidecar(path))


def sidecar_meta(path: str) -> dict:
    """A checkpoint's sidecar as ``{"fingerprint": <digest>, <key>:
    <value>, ...}``; ``{}`` when there is none."""
    side = _sidecar(os.path.abspath(path))
    if not os.path.exists(side):
        return {}
    with open(side) as f:
        lines = f.read().split()
    out: dict = {}
    if lines:
        out["fingerprint"] = lines[0]
    out.update(ln.split("=", 1) for ln in lines[1:] if "=" in ln)
    return out


def _check_fingerprint(path: str, like, cfg) -> None:
    meta = sidecar_meta(path)
    if not meta:
        return                           # an older checkpoint: no sidecar
    stamped = meta.get("fingerprint", "")
    fleet = fleet_axis(like)
    want = config_fingerprint(cfg, fleet=fleet)
    if stamped == want:
        return
    saved_bks = meta.get("degree_buckets", "")
    want_bks = _bucket_string(cfg)
    if saved_bks != want_bks:
        def _part(s):
            return f"buckets [{s}]" if s else "the dense layout"
        raise ValueError(
            f"checkpoint {path!r} bucket-partition mismatch: saved under "
            f"{_part(saved_bks)} but this run expects {_part(want_bks)} — a "
            "bucketed checkpoint only resumes under its own bucket "
            "partition (realign with topology.align_degree_buckets BEFORE "
            "the first run, not between resumes)")
    saved_fleet = meta.get("fleet")
    if saved_fleet != (None if fleet is None else str(fleet)):
        def _axis(b):
            return "an unbatched state" if b is None else f"B={b}"
        raise ValueError(
            f"checkpoint {path!r} fleet-axis mismatch: saved with "
            f"{_axis(saved_fleet)} but this run expects {_axis(fleet)} — a "
            "fleet journal can only resume at its own batch size")
    saved_prec = meta.get("state_precision")
    if saved_prec is not None and saved_prec != cfg.state_precision:
        raise ValueError(
            f"checkpoint {path!r} state_precision mismatch: saved under "
            f"{saved_prec!r} but this run expects {cfg.state_precision!r} — "
            "the storage layouts differ (sim/state.py codecs); resume under "
            "the saved precision, or round-trip through decode_state/"
            "encode_state explicitly")
    raise ValueError(
        f"checkpoint {path!r} was saved under a different config "
        f"(fingerprint {stamped[:12]}… != {want[:12]}…); restoring it under "
        "this config would silently mis-resume")


def _validate(field: str, got: np.ndarray, shape: tuple,
              dtype: np.dtype) -> None:
    if tuple(got.shape) != shape or got.dtype != dtype:
        raise ValueError(
            f"checkpoint field {field!r}: restored {got.dtype}"
            f"{list(got.shape)} does not match expected {dtype}"
            f"{list(shape)} — the checkpoint was written under a different "
            "config (peer count / slot capacity / topic count / msg "
            "window); pass the matching `like` state or re-run from scratch")


def restore(path: str, like, cfg=None):
    """Load a checkpoint onto ``like``'s device (a SimState or a
    BucketedState). ``like`` gives every leaf's shape and dtype (the
    module docstring's validation); a leaf the file lacks is ``like``'s
    own."""
    leaves = _named_leaves(like)
    path = os.path.abspath(path)
    if cfg is not None:
        _check_fingerprint(path, like, cfg)
    npz_path = path if path.endswith(".npz") else path + ".npz"
    try:
        npz = np.load(npz_path)
    except Exception as e:
        raise CheckpointCorrupt(
            f"checkpoint {npz_path!r} is unreadable (torn or incomplete "
            f"write): {type(e).__name__}: {e}") from e
    out = []
    with npz:
        for name, want, dtype in leaves:
            if name not in npz.files:
                out.append(want)
                continue
            try:
                arr = npz[name]
            except Exception as e:           # member truncated mid-archive
                raise CheckpointCorrupt(
                    f"checkpoint {npz_path!r} field {name!r} is unreadable "
                    f"(torn write): {type(e).__name__}: {e}") from e
            _validate(name, arr, tuple(want.shape), dtype)
            out.append(field_from_reference(name.split(".")[-1], arr,
                                            want.device))
    return _unflatten(like, out)
