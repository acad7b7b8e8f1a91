"""``GymConfig(strategy="grid")`` on the triangle-chain and Example-4
queries of ``test_torch_gym.py``: reference parity and fused == unfused,
as ``test_torch_gym_grid.py``."""
from __future__ import annotations

import random

import pytest

pytest.importorskip("torch")

from repro.relational.spmd import SPMD  # noqa: E402
from test_torch_gym import QUERIES, rand_data  # noqa: E402
from test_torch_gym_grid import check_grid_query  # noqa: E402

_REF = SPMD(4)


@pytest.mark.parametrize("qname", ["tc2", "example4"])
def test_grid_strategy_matches_reference(qname):
    q = QUERIES[qname]()
    data = rand_data(q, random.Random(hash(("grid", qname)) & 0xFFFF))
    led = check_grid_query(q, data, _REF)
    assert led.rounds >= 1
