"""The port's ``gym_loggta`` against the reference on Figure 6's TC_15:
Log-GTA of the width-2 triangle-chain GHD, whose bags hold up to three
atoms.  Exact parity, as ``test_torch_gym_loggta.py``."""
from __future__ import annotations

import random

import pytest

pytest.importorskip("torch")

from repro.core.queries import triangle_chain_ghd, triangle_chain_query  # noqa: E402
from test_torch_gym import rand_data  # noqa: E402
from test_torch_gym_loggta import assert_entry_parity  # noqa: E402


def test_loggta_tc15_matches_reference():
    """Figure 6's TC_15: Log-GTA of the width-2 triangle-chain GHD."""
    q = triangle_chain_query(5)
    data = rand_data(q, random.Random(11), dom=3, rows=6)
    _, led = assert_entry_parity("gym_loggta", q, data, p=4, ghd=triangle_chain_ghd(5), seed=1)
    assert led.rounds >= 1
