"""The tensor-parallel serving tests of ``test_torch_tp_serving.py`` on a
world of 4 ranks (tp 4, the trunk at 8 q / 4 kv heads) against the JAX
engines on a CPU mesh of 4 devices."""

import pytest

from test_torch_tp_serving import *  # noqa: F401,F403 — the same tests, on the world below
from test_torch_tp_serving import _world


@pytest.fixture(scope="module")
def world():
    return _world(4)
