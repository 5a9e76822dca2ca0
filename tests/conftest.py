import os
import sys

import numpy as np
import pytest

# make tests/_hyp_compat.py importable from nested test dirs
sys.path.insert(0, os.path.dirname(__file__))

# real hypothesis when installed, the deterministic shim otherwise — the
# shim's register_profile/load_profile are no-ops, so this is unconditional
from _hyp_compat import settings  # noqa: E402

# CI profile: small example counts, no deadline (CPU-only container)
settings.register_profile("ci", max_examples=20, deadline=None)
settings.load_profile("ci")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test without one")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
