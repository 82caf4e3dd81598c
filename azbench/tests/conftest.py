"""The benchmark's tests: CPU tests at tiny sizes, and tests marked
``cuda`` that skip where there is no card (run them on the card with
``python -m pytest azbench/tests -m cuda``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips where there is none)")
