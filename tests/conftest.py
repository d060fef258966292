import os
import sys

import pytest

# tests must see ONE cpu device (the dry-run sets its own flag in a fresh
# process); keep jax quiet and deterministic
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# Property tests use `hypothesis`; when it is not installed (the hermetic CI
# container cannot pip-install), register the deterministic stub under the
# same module name BEFORE test modules import it, so all modules collect.
try:
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(__file__))
    import _hypothesis_stub

    _stub = type(sys)("hypothesis")
    _stub.given = _hypothesis_stub.given
    _stub.settings = _hypothesis_stub.settings
    _stub.strategies = _hypothesis_stub
    sys.modules["hypothesis"] = _stub
    sys.modules["hypothesis.strategies"] = _hypothesis_stub


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: multi-second integration tests")
    config.addinivalue_line(
        "markers",
        "tier1: fast in-process suite — the ROADMAP verify gate "
        "(auto-applied to every test not marked subprocess)")
    config.addinivalue_line(
        "markers",
        "subprocess: spawns fresh interpreters (8-fake-device runners); "
        "runs in its own CI leg, excluded from -m tier1")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels); skips without "
        "one")


def pytest_collection_modifyitems(config, items):
    # the two tiers partition the suite: a test is tier1 IFF it is not a
    # subprocess test, so `-m tier1` + `-m subprocess` covers everything
    for item in items:
        if item.get_closest_marker("subprocess") is None:
            item.add_marker(pytest.mark.tier1)
