"""pytest settings shared by the test files: marker registration only."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips (inside the test) without "
                   "one. Run on the card with `-m gpu`.")
