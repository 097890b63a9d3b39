"""Settings of the benchmark's own tests: ``pytest bench_port/tests`` from the root of
a checkout. Tests marked ``cuda`` need a CUDA card and skip, deciding inside the test,
where there is none."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")
