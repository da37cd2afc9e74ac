"""Pytest settings shared by the test files: registers the ``cuda`` marker.

``@pytest.mark.cuda`` marks a test that needs an NVIDIA GPU (it launches the
hand-written CUDA kernels of ``repro_torch``).  Such a test takes the
``cuda_device`` fixture, which skips it where there is no GPU; whether there
is one is decided inside the fixture, never at import or collection time, so
every worker collects the same tests.  Run them on a GPU machine with
``PYTHONPATH=src python -m pytest -q -m cuda tests/``.
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skipped where there is none)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")
