"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests and benches see
the real single CPU device; only dryrun.py forces 512 host devices."""
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _isolated_tune_cache(tmp_path, monkeypatch):
    """Point the tuning cache (and the machine-peaks lookup) at a fresh
    per-test directory: tests must never read or pollute the user's
    ~/.cache/repro-tune, and with no persisted peaks file the cost model
    falls back to its documented default constants — which keeps every
    predicted_us in IR dumps and byte-pinned goldens machine-independent."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "repro-tune"))
    yield


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the torch port's kernels); "
                   "skips where torch sees none")
