"""The benchmark's own tests (``python -m pytest h100bench -q``).  Tests
marked ``card`` need a CUDA device; each decides inside itself whether one
is present and skips without it."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (run on the card)")
