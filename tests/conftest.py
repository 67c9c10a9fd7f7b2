"""Shared pytest settings of the repository's tests."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's kernels run only there); "
        "skips without one")
