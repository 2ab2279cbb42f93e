"""The port's hang-proof device probe (go_libp2p_pubsub_tpu_torch/utils/
platform_probe.py), on the CPU.

- the cases of tests/test_platform_probe.py's ``TestCpuMeshEnv`` and
  ``TestForcedCpuDeviceCount``, carried over to the port's variables: the
  card hidden by ``CUDA_VISIBLE_DEVICES=""``, the CPU group's rank count in
  ``GRAFT_NUM_PROCESSES`` (the one the port's launchers read);
- a child started with ``cpu_mesh_env`` sees no CUDA device and reads the
  rank count back;
- on this machine, which has no CUDA device, the probe answers
  ``(False, 0, "")``;
- a child that hangs costs the timeout, not a hang.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

from go_libp2p_pubsub_tpu_torch.parallel import multihost
from go_libp2p_pubsub_tpu_torch.utils import platform_probe
from go_libp2p_pubsub_tpu_torch.utils.platform_probe import (
    cpu_mesh_env,
    forced_cpu_device_count,
    probe_default_platform,
    probe_default_platform_info,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestCpuMeshEnv:
    def test_hides_the_card_and_keeps_the_rest(self):
        env = cpu_mesh_env({"CUDA_VISIBLE_DEVICES": "0", "OTHER": "1"})
        assert env["CUDA_VISIBLE_DEVICES"] == ""
        assert env["OTHER"] == "1"
        assert "GRAFT_NUM_PROCESSES" not in env   # no count requested

    def test_device_count_set(self):
        env = cpu_mesh_env({"OTHER": "1"}, 8)
        assert env["GRAFT_NUM_PROCESSES"] == "8"
        assert env["OTHER"] == "1"
        # the variable the launchers read
        assert platform_probe.ENV_NUM_PROCESSES == multihost.ENV_NUM_PROCESSES

    def test_does_not_mutate_input(self):
        src = {"CUDA_VISIBLE_DEVICES": "0"}
        cpu_mesh_env(src, 4)
        assert src == {"CUDA_VISIBLE_DEVICES": "0"}


class TestForcedCpuDeviceCount:
    def test_default_is_one(self):
        assert forced_cpu_device_count({}) == 1
        assert forced_cpu_device_count({"GRAFT_NUM_PROCESSES": ""}) == 1

    def test_parses_count(self):
        assert forced_cpu_device_count({"GRAFT_NUM_PROCESSES": "8"}) == 8

    def test_the_last_setting_wins(self):
        env = cpu_mesh_env(cpu_mesh_env({}, 4), 16)
        assert forced_cpu_device_count(env) == 16


def test_child_under_cpu_mesh_env_sees_no_card():
    code = ("import sys; sys.path.insert(0, %r); import torch\n"
            "from go_libp2p_pubsub_tpu_torch.utils.platform_probe import "
            "forced_cpu_device_count\n"
            "print(torch.cuda.is_available(), torch.cuda.device_count(), "
            "forced_cpu_device_count())\n") % REPO
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=cpu_mesh_env(os.environ, 2))
    assert res.returncode == 0, res.stderr[-800:]
    assert res.stdout.split() == ["False", "0", "2"]


def test_probe_finds_no_card_here():
    assert probe_default_platform_info(120) == (False, 0, "")


def test_hung_child_costs_the_timeout(monkeypatch):
    monkeypatch.setattr(platform_probe, "PROBE_CODE",
                        "import time; time.sleep(60)")
    t0 = time.perf_counter()
    assert probe_default_platform_info(1) == (False, 0, "")
    assert time.perf_counter() - t0 < 20


def test_timeout_read_from_the_environment(monkeypatch):
    monkeypatch.setattr(platform_probe, "PROBE_CODE",
                        "import time; time.sleep(60)")
    monkeypatch.setenv("GRAFT_PROBE_TIMEOUT", "1")
    monkeypatch.setenv("BENCH_PROBE_TIMEOUT", "100")
    t0 = time.perf_counter()
    assert probe_default_platform_info() == (False, 0, "")
    assert time.perf_counter() - t0 < 20
    monkeypatch.delenv("GRAFT_PROBE_TIMEOUT")
    monkeypatch.setenv("BENCH_PROBE_TIMEOUT", "1")
    t0 = time.perf_counter()
    assert probe_default_platform() == (False, 0)
    assert time.perf_counter() - t0 < 20


def test_a_probe_that_answers_is_read(monkeypatch):
    """The parent's side of a live card: the child's NDEV line read back
    (the card itself answers only on the chip, chip_smoke.py phase 12a)."""
    monkeypatch.setattr(platform_probe, "PROBE_CODE",
                        "print('warming'); print('NDEV', 1, 'gpu')")
    assert probe_default_platform_info(60) == (True, 1, "gpu")
    monkeypatch.setattr(platform_probe, "PROBE_CODE",
                        "raise SystemExit(3)")
    assert probe_default_platform_info(60) == (False, 0, "")
