"""``GymConfig(strategy="hybrid")`` — the heavy-hitter engine — in the
port against the reference, end to end.

Rows (order included), schema, every ``RoundRecord`` (dispatches and the
heavy/light split included), retries and output tuples must be equal
(all data is int32, so exact).  Two instances at p = 4: the reference's
planted heavy-key S_8 (``tests/test_skew_hybrid.py::_planted_star``),
where the engine must route heavy keys, ship fewer padded slots than the
hash engine and make no retry; and a uniform S_5, where it must be the
hash engine bit for bit.  The reference's runs are made once per module
(``ref_runs``) and shared by the tests.  The unfused case and the p = 8
bench families are in ``test_torch_gym_hybrid_unfused.py`` and
``test_torch_gym_hybrid_p8.py`` so the reference's JAX compile time
spreads over test workers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.gym import GymConfig, gym  # noqa: E402
from repro.core.queries import star_ghd, star_query  # noqa: E402
from repro.data.synthetic import star_data_sparse  # noqa: E402
from repro.relational.spmd import SPMD  # noqa: E402
from test_skew_hybrid import _planted_star  # noqa: E402
from test_torch_gym import to_port_query  # noqa: E402

from repro_torch.core.gym import GymConfig as TGymConfig  # noqa: E402
from repro_torch.core.gym import GymDriver  # noqa: E402
from repro_torch.core.gym import gym as tgym  # noqa: E402
from repro_torch.core.physical import ENGINES, HybridEngine  # noqa: E402
from repro_torch.interop import ghd_from_dict  # noqa: E402
from repro_torch.relational.spmd import SPMD as TSPMD  # noqa: E402

P = 4
CASES = {
    "planted": _planted_star,
    "uniform": lambda: (star_query(5), star_ghd(5), star_data_sparse(5, seed=9)),
}


def port_run(q, g, data, p=P, seed=3, **cfg):
    return tgym(
        to_port_query(q), data, ghd=ghd_from_dict(g.to_dict()), p=p,
        config=TGymConfig(seed=seed, **cfg), device="cpu",
    )


def assert_same_run(port, ref):
    (trows, tschema, tled), (rows, schema, led) = port, ref
    assert tuple(tschema) == tuple(schema)
    assert trows.dtype == np.asarray(rows).dtype
    np.testing.assert_array_equal(trows, np.asarray(rows))
    assert [dataclasses.asdict(r) for r in tled.records] == [
        dataclasses.asdict(r) for r in led.records
    ]
    assert (tled.retries, tled.output_tuples) == (led.retries, led.output_tuples)
    assert tled.measured_dispatches == led.measured_dispatches


@pytest.fixture(scope="module")
def ref_runs():
    spmd = SPMD(P)
    out = {}
    for name, make in CASES.items():
        q, g, data = make()
        out[name] = gym(q, data, ghd=g, p=P, spmd=spmd,
                        config=GymConfig(strategy="hybrid", seed=3))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_hybrid_gym_matches_reference(ref_runs, name):
    q, g, data = CASES[name]()
    assert_same_run(port_run(q, g, data, strategy="hybrid"), ref_runs[name])


def test_planted_star_routes_heavy_keys_and_beats_hash(ref_runs):
    """The reference's acceptance pin, on the port: rows equal to the
    hash and grid engines', zero retries, heavy tuples, and fewer padded
    wire slots than hash."""
    q, g, data = _planted_star()
    rows, _, led = port_run(q, g, data, strategy="hybrid")
    hrows, _, hled = port_run(q, g, data, strategy="hash")
    grows, _, _ = port_run(q, g, data, strategy="grid")
    key = lambda r: sorted(map(tuple, r))  # noqa: E731
    assert key(rows) == key(hrows) == key(grows)
    assert led.retries == 0 and led.heavy_tuples > 0
    assert led.padded_slots < hled.padded_slots
    assert led.light_tuples == led.shuffle_tuples - led.heavy_tuples


def test_uniform_star_is_the_hash_engine(ref_runs):
    """No heavy key: the hybrid engine's run is the hash engine's, bit for
    bit — rows, every record, padded slots and dispatches."""
    q, g, data = CASES["uniform"]()
    hyb = port_run(q, g, data, strategy="hybrid")
    hsh = port_run(q, g, data, strategy="hash")
    np.testing.assert_array_equal(hyb[0], hsh[0])
    assert [dataclasses.asdict(r) for r in hyb[2].records] == [
        dataclasses.asdict(r) for r in hsh[2].records
    ]
    assert hyb[2].heavy_tuples == 0 == ref_runs["uniform"][2].heavy_tuples


def test_hybrid_engine_registered_with_calibration_forced():
    assert ENGINES["hybrid"] is HybridEngine
    assert HybridEngine.requires_measure and HybridEngine.hybrid_measure
    q, g, data = _planted_star()
    drv = GymDriver(
        to_port_query(q), ghd_from_dict(g.to_dict()), data, TSPMD(P, device="cpu"),
        TGymConfig(strategy="hybrid", seed=3, calibrate_shuffle=False),
    )
    assert drv.executor.engine.name == "hybrid" and drv.executor.calibrate
