"""Root test hooks.

Tier-1 runs `pytest -m 'not slow'`. A command-line `-m` replaces the
`addopts` filter `-m "not quality and not e2e"` of pytest.ini, so without
this hook the CLI end-to-end tier (`e2e`) and the end-metric quality gates
(`quality`) would be collected into Tier-1. The hook marks both `slow`, which
restores the split pytest.ini intends under either filter.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running; set on every quality and e2e test")


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.get_closest_marker("quality") or item.get_closest_marker("e2e"):
            item.add_marker(pytest.mark.slow)
