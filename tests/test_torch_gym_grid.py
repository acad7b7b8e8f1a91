"""``GymConfig(strategy="grid")`` — the paper's Lemmas 8/10 engine — in
the port against the reference, end to end.

Rows (order included), schema, every ``RoundRecord``, retries and output
tuples must be equal (all data is int32, so exact).  The unfused run
(``fused=False``, one dispatch per physical op) must give the fused run's
rows, comm and rounds.  The queries of ``test_torch_gym.py`` are split
over this file and ``test_torch_gym_grid_tc.py`` so the reference's JAX
compile time spreads over test workers.
"""
from __future__ import annotations

import random

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.queries import chain_query  # noqa: E402
from repro.relational.spmd import SPMD  # noqa: E402
from test_torch_gym import QUERIES, assert_gym_parity, rand_data, to_port_query  # noqa: E402

from repro_torch.core.gym import GymConfig as TGymConfig  # noqa: E402
from repro_torch.core.gym import gym as tgym  # noqa: E402

_REF = SPMD(4)


def check_grid_query(q, data, ref_spmd, *, p=4, seed=3):
    """Reference parity of the fused grid run, then the unfused port run
    against the fused one."""
    led = assert_gym_parity(q, data, p=p, ref_spmd=ref_spmd, seed=seed, strategy="grid")
    rows, _, tled = tgym(to_port_query(q), data, p=p, device="cpu", config=TGymConfig(seed=seed, strategy="grid"))
    urows, _, uled = tgym(
        to_port_query(q), data, p=p, device="cpu",
        config=TGymConfig(seed=seed, strategy="grid", fused=False),
    )
    np.testing.assert_array_equal(urows, rows)
    assert (uled.comm_tuples, uled.rounds) == (tled.comm_tuples, tled.rounds)
    assert uled.measured_dispatches >= tled.measured_dispatches
    return led


@pytest.mark.parametrize("qname", ["chain4", "star4", "selfjoin"])
def test_grid_strategy_matches_reference(qname):
    q = QUERIES[qname]()
    data = rand_data(q, random.Random(hash(("grid", qname)) & 0xFFFF))
    led = check_grid_query(q, data, _REF)
    assert led.rounds >= 1


def test_grid_strategy_skew_case_matches_reference():
    """Every tuple shares one key value: hash co-partitioning would funnel
    them to one reducer; the grid bounds every reducer by position."""
    n = 32
    data = {
        "R1": np.stack([np.arange(n, dtype=np.int32), np.zeros(n, np.int32)], axis=1),
        "R2": np.stack([np.zeros(n, np.int32), np.arange(n, dtype=np.int32)], axis=1),
    }
    led = check_grid_query(chain_query(2), data, _REF)
    assert led.output_tuples == n * n


def test_hybrid_strategy_names_its_roadmap_item():
    """``"hybrid"`` once raised, naming its ROADMAP item; the engine is now
    registered, forces calibration on and runs (its parity with the
    reference is in ``test_torch_gym_hybrid*.py``)."""
    from repro_torch.core.physical import ENGINES

    assert TGymConfig(strategy="hybrid").strategy == "hybrid"
    assert ENGINES["hybrid"].requires_measure
    rows, _, led = tgym(
        to_port_query(chain_query(2)), {"R1": np.array([[0, 1], [2, 1]], np.int32),
                         "R2": np.array([[1, 5]], np.int32)},
        p=4, device="cpu", config=TGymConfig(strategy="hybrid", calibrate_shuffle=False),
    )
    assert sorted(map(tuple, rows.tolist())) == [(0, 1, 5), (2, 1, 5)]
    assert led.measure_dispatches > 0  # the count pre-pass ran anyway
    with pytest.raises(ValueError, match="registered engines"):
        TGymConfig(strategy="nope")
