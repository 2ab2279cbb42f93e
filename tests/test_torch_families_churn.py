"""The port's slow-link and diurnal-churn families against the JAX
package's on the CPU, as tests/test_torch_families.py holds the other
three (its module docstring)."""

import pytest
import torch

from test_torch_families import check_family


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs (the
    suite runs in several worker processes; see
    tests/test_torch_engine_modes.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["slowlink_small", "diurnal_small"])
def test_family_trajectory_and_contracts_equal_the_reference(name):
    check_family(name)
