"""Shared pytest settings: registers the markers the suite uses."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card (CUDA kernels); skips without "
        "one")
