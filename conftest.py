"""Root pytest settings: registers the marker of tests that need a CUDA
card. Such tests skip without one; on a machine with a card run them with
``python -m pytest tests/test_torch_*.py -m cuda``."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")
