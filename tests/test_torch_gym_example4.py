"""Port-vs-reference ``gym()`` parity on the example4 query (default config).

Kept in its own file so its JAX compile time runs on its own test worker;
the comparison itself is ``test_torch_gym.assert_gym_parity``."""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from repro.relational.spmd import SPMD  # noqa: E402
from test_torch_gym import _data, assert_gym_parity  # noqa: E402


def test_gym_parity_example4():
    q, data = _data("example4")
    led = assert_gym_parity(q, data, p=4, ref_spmd=SPMD(4), seed=3)
    assert led.rounds >= 1
