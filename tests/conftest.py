"""Registers the ``cuda`` marker for tests that need an NVIDIA card.

Such tests skip on a machine without one (each decides inside a fixture,
never at import) and run on the card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips on machines without one")
