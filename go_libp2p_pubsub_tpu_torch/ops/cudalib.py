"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C launcher (and may include the
shared headers ``csrc/*.cuh``) and is compiled by
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into its own shared library, loaded with ``ctypes``. Every source gets its
own ``nvcc`` process and all of them start together. Libraries land in
``go_libp2p_pubsub_tpu_torch/_build/`` under a name carrying the content
hash of the source and the headers, so an edited source or header rebuilds
and an unchanged one loads as is.
The build happens at first use (or through :func:`build_all`), never at
import: the CPU tests import every module on a machine with no ``nvcc``.

A launcher takes device pointers and the stream as ``void*`` and ints as
``int``, launches on the given stream, allocates nothing, and returns
``cudaGetLastError()``; :func:`launch` raises if that is not 0 and then
adds one to the kernel's count in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# kernel name -> (source file, C launcher, argument kinds: p=pointer, i=int)
KERNELS = {
    "edge_table": ("edge_table.cu", "edge_table_launch", "p" * 4 + "i" * 4 + "p"),
    "hop": ("hop.cu", "hop_launch", "p" * 16 + "i" * 4 + "p"),
    "iwant_resolve": ("iwant_resolve.cu", "iwant_resolve_launch",
                      "p" * 14 + "i" * 5 + "p"),
    "emit": ("emit.cu", "emit_launch", "p" * 6 + "i" * 7 + "p"),
    "gather_words": ("gather_words.cu", "gather_words_launch",
                     "p" * 3 + "i" * 3 + "p"),
    "permutation_gather": ("permutation_gather.cu",
                           "permutation_gather_launch", "p" * 4 + "i" * 3 + "p"),
    "take_words": ("take_words.cu", "take_words_launch", "p" * 3 + "i" * 4 + "p"),
    "select_rows": ("select_rows.cu", "select_rows_launch",
                    "p" * 5 + "i" * 6 + "p"),
}

# launches per kernel, counted only where a wrapper launches its kernel
LAUNCHES = {name: 0 for name in KERNELS}

_LIBS: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> str:
    """The library's path, named by the hash of its source and of every
    shared header in csrc/ (``*.cuh``), which a source may include."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for src in [KERNELS[name][0], *headers]:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names=None) -> dict:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all in parallel. Returns name -> {"seconds", "ptxas"} for the
    libraries it built (``ptxas``: the compiler's register/spill report)."""
    names = list(KERNELS if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, os.path.join(CSRC, KERNELS[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0,
                        "ptxas": " ".join(
                            ln.strip() for ln in log.splitlines()
                            if "registers" in ln or "spill" in ln)}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def _lib(name: str):
    fn = _LIBS.get(name)
    if fn is None:
        build_all([name])
        lib = ctypes.CDLL(_lib_path(name))
        fn = getattr(lib, KERNELS[name][1])
        kinds = KERNELS[name][2]
        fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int
                       for c in kinds]
        fn.restype = ctypes.c_int
        _LIBS[name] = fn
    return fn


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` on the current stream. ``args`` are tensors
    (passed as device pointers) and ints, in the launcher's order; the
    stream is appended here."""
    fn = _lib(name)
    stream = torch.cuda.current_stream().cuda_stream
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
              for a in args] + [stream]
    err = fn(*c_args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[name] += 1


def use_kernel(name: str, *tensors) -> bool:
    """A wrapper's route: False (the plain version) when every tensor lies
    on the CPU, True (the kernel) when every one lies on CUDA; raises for a
    mix or any other device. There is no fallback between the two."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"}:
        return True
    raise ValueError(f"{name}: tensors on unsupported or mixed devices "
                     f"{sorted(types)}")


def check_args(name: str, specs) -> None:
    """A kernel's input check before any pointer is passed: every tensor on
    one CUDA device, contiguous, of the dtype and shape the kernel reads.
    ``specs`` holds (label, tensor, dtype, shape) tuples."""
    dev = specs[0][1].device
    for label, t, dtype, shape in specs:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: {label} lies on {t.device}, not on the "
                             f"CUDA device {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {label} is {t.dtype} "
                             f"{tuple(t.shape)}, expected {dtype} "
                             f"{tuple(shape)}")
