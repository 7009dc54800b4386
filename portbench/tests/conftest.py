"""The benchmark's own tests: `python -m pytest portbench/tests -q` from
the repository root.  Tests marked `card` need a CUDA device and skip
without one (each decides inside the test)."""


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'card: needs a CUDA device; skips without one')
