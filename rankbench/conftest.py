import pytest


def pytest_configure(config):
    # the benchmark's tests that need an NVIDIA card; each skips (from
    # inside the test) when torch sees none
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture(autouse=True)
def _two_threads():
    """The benchmark's CPU runs use two of torch's threads, so that they
    leave the cores to the other test files running beside them."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
