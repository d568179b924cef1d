"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
root of the repository.  On the CPU they check the references, the work
reckoning, the trace reduction, the layout and a rehearsal of the loop
through the kernels' plain versions; tests marked ``cuda`` need the card
and skip without one."""

import pytest
import torch


def pytest_configure(config):
    torch.set_num_threads(1)    # several workers share the CPU
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda", 0)
