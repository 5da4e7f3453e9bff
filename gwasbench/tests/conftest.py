import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "needs_cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """Skips the test without a CUDA card (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
