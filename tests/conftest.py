import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.graph import generate  # noqa: E402


@pytest.fixture(scope="session")
def rmat_graph():
    return generate.rmat(512, 4096, seed=7)


@pytest.fixture(scope="session")
def clustered_graph():
    return generate.clustered(600, 6000, num_clusters=4, p_cross=0.03, seed=3)


@pytest.fixture(scope="session")
def uniform_graph():
    return generate.uniform(512, 4096, seed=11)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skipped without one")
