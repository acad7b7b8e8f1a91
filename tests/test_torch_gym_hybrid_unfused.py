"""The hybrid engine unfused and with ``calibrate_shuffle=False``, which
the engine must override: the port against the reference on the planted
heavy-key S_8 at p = 4 (rows in order, schema, every ``RoundRecord``,
retries, dispatches), then the unfused run against the fused one (rows,
``comm_tuples`` and rounds equal; only dispatches may differ)."""
from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.gym import GymConfig, gym  # noqa: E402
from repro.relational.spmd import SPMD  # noqa: E402
from test_skew_hybrid import _planted_star  # noqa: E402
from test_torch_gym_hybrid import P, assert_same_run, port_run  # noqa: E402

UNFUSED = dict(strategy="hybrid", fused=False, calibrate_shuffle=False)


@pytest.fixture(scope="module")
def ref_unfused():
    q, g, data = _planted_star()
    return gym(q, data, ghd=g, p=P, spmd=SPMD(P), config=GymConfig(seed=3, **UNFUSED))


def test_unfused_uncalibrated_hybrid_matches_reference(ref_unfused):
    q, g, data = _planted_star()
    assert_same_run(port_run(q, g, data, **UNFUSED), ref_unfused)
    assert ref_unfused[2].heavy_tuples > 0  # the forced pre-pass still routes


def test_unfused_hybrid_equals_fused():
    q, g, data = _planted_star()
    urows, _, uled = port_run(q, g, data, **UNFUSED)
    rows, _, led = port_run(q, g, data, strategy="hybrid")
    np.testing.assert_array_equal(urows, rows)
    assert (uled.comm_tuples, uled.rounds, uled.retries) == (led.comm_tuples, led.rounds, led.retries)
    assert uled.heavy_tuples == led.heavy_tuples
    assert uled.measured_dispatches >= led.measured_dispatches
