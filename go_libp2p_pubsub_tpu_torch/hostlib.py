"""g++ builds of the port's host C++ libraries (``csrc/*.cpp``).

The host codecs (``csrc/trace_codec.cpp`` behind ``trace/native.py``,
``csrc/rpc_codec.cpp`` behind ``pb/native_rpc.py``) are plain C++ bound
with ctypes, not CUDA kernels. Each is compiled at first use, never at
import, by ``g++ -O2 -shared -fPIC -std=c++17`` into
``go_libp2p_pubsub_tpu_torch/_build/`` under a name that carries the hash
of its source, as ``ops/cudalib.py`` names the kernels' libraries, so an
edited source rebuilds and an unchanged one loads as is.

The build is safe across processes: each process that builds compiles to a
name of its own and ``os.replace``s it into place, so processes that build
at once each load a whole library (the last rename wins; every candidate
is the same build of the same source).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading

PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(PKG, "csrc")
BUILD_DIR = os.path.join(PKG, "_build")


def lib_path(src: str, stem: str, build_dir: str = BUILD_DIR) -> str:
    """``build_dir/<stem>-<hash of src>.so``."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(build_dir, f"{stem}-{digest}.so")


def build(src: str, out: str) -> bool:
    """Compile ``src`` to a temporary name beside ``out`` and rename it
    into place; False where no compiler runs or the build fails."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src,
                        "-o", tmp], check=True, capture_output=True,
                       timeout=300)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
