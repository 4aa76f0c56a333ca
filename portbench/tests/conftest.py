"""CPU tests of the benchmark; run from the repository root with
``python -m pytest portbench/tests -q``. Tests marked ``card`` need a CUDA
card and skip without one (decided in the ``cuda_device`` fixture)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench.core import common  # noqa: E402

# one thread for the host's math libraries, as a run sets it: several test
# workers, each with a spinning thread pool per library and the Loader's
# threads, would oversubscribe the cores many times over
common.set_environment()


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
