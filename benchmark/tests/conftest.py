"""The benchmark's own tests: CPU only, at small sizes; tests that need
the card are marked `gpu` and skip without one. Imports no JAX.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")
