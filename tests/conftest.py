# Give tests a small multi-device CPU topology (sharding / collective tests
# need >1 device). Must run before any jax import. The dry-run sets its own
# 512-device count in a separate process; benches see the default.
import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked @pytest.mark.slow (long integration sims)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running integration sims; skipped by default so the "
        "tier-1 run (`PYTHONPATH=src python -m pytest -x -q`) has "
        "`-m 'not slow'` semantics. Opt in with --runslow or -m slow.")
    config.addinivalue_line("markers", "gpu: runs only with a CUDA device")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    # An explicit -m expression mentioning `slow` means the user is
    # selecting on the marker themselves; don't override their choice.
    if "slow" in (config.getoption("-m") or ""):
        return
    skip_slow = pytest.mark.skip(reason="slow: opt in with --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)
