"""Hang-proof probing of the default device (port of utils/platform_probe.py).

The port's entry points run on ``cuda`` unless the caller asks for the CPU
(device.py), so the default platform is the card. A CUDA stack that hangs
or a card that has fallen off the bus can block CUDA's first call in the
process that makes it, so the probe runs in a child process with a time
limit: a wedged card costs the timeout, not a hang. The fallback is a
child whose environment hides the card (:func:`cpu_mesh_env`), with the
rank count the port's launchers read.
"""

from __future__ import annotations

import os
import subprocess
import sys

# the child: one small op on the card, checked on the host, then the count
PROBE_CODE = (
    "import torch; "
    "x = torch.ones((8, 8), device='cuda'); "
    "assert float(x.sum().cpu()) == 64.0; "
    "print('NDEV', torch.cuda.device_count(), 'gpu')")

# the rank count parallel/multihost.py and the launchers read
ENV_NUM_PROCESSES = "GRAFT_NUM_PROCESSES"


def probe_default_platform(timeout: int | None = None) -> tuple[bool, int]:
    """``(alive, n_devices)`` of the default device, measured in a child
    process with a time limit."""
    alive, n, _ = probe_default_platform_info(timeout)
    return alive, n


def probe_default_platform_info(
        timeout: int | None = None) -> tuple[bool, int, str]:
    """Like :func:`probe_default_platform`, with the platform of the
    devices: ``(True, n, "gpu")`` where the child ran its op on the card,
    ``(False, 0, "")`` where it hung past ``timeout`` seconds, failed, or
    found no CUDA device. The timeout defaults to ``$GRAFT_PROBE_TIMEOUT``,
    else ``$BENCH_PROBE_TIMEOUT``, else 120 s."""
    timeout = timeout if timeout is not None else int(
        os.environ.get("GRAFT_PROBE_TIMEOUT",
                       os.environ.get("BENCH_PROBE_TIMEOUT", 120)))
    try:
        res = subprocess.run([sys.executable, "-c", PROBE_CODE],
                             capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return False, 0, ""
    if res.returncode != 0:
        return False, 0, ""
    for line in res.stdout.splitlines():
        if line.startswith("NDEV "):
            parts = line.split()
            return True, int(parts[1]), parts[2]
    return False, 0, ""


def cpu_mesh_env(env: dict, n_devices: int | None = None) -> dict:
    """A copy of ``env`` for a child that must not touch the card
    (``CUDA_VISIBLE_DEVICES`` empty). With ``n_devices``, also the rank
    count of a CPU group of that many processes (``GRAFT_NUM_PROCESSES``,
    which the launchers read)."""
    env = dict(env)
    env["CUDA_VISIBLE_DEVICES"] = ""
    if n_devices is not None:
        env[ENV_NUM_PROCESSES] = str(int(n_devices))
    return env


def forced_cpu_device_count(env: dict | None = None) -> int:
    """The rank count :func:`cpu_mesh_env` set in ``env`` (default
    ``os.environ``), 1 where none is set."""
    env = env if env is not None else os.environ
    value = env.get(ENV_NUM_PROCESSES, "")
    return int(value) if value.strip() else 1
