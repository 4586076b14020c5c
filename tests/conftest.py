import os
import pathlib
import sys

import numpy as np
import pytest

# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
# single real CPU device; only launch/dryrun.py forces 512 fake devices.

_SRC = str(pathlib.Path(__file__).resolve().parent.parent / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

try:
    import hypothesis

    # "ci": fully deterministic property testing for the gate — fixed
    # example sequence (derandomize), no wall-clock deadline (shared
    # runners stall unpredictably), and print the falsifying example
    # verbosely. Selected via HYPOTHESIS_PROFILE=ci in the workflow; local
    # runs keep hypothesis defaults unless the env var says otherwise.
    hypothesis.settings.register_profile(
        "ci", deadline=None, derandomize=True, print_blob=True)
    _profile = os.environ.get("HYPOTHESIS_PROFILE")
    if _profile:
        hypothesis.settings.load_profile(_profile)
except ModuleNotFoundError:
    # hermetic containers may lack hypothesis; install the API-compatible
    # deterministic fallback so property tests still run (the fallback is
    # always derandomized — examples derive from the test's name)
    from repro.compat.hypothesis_fallback import install
    install()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips itself without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
