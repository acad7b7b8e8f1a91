"""The packed wire under a planted heavy key: the reference's planted
S_8 (``tests/test_skew_hybrid.py::_planted_star``) at p = 4, where the
hybrid engine routes heavy keys through its spread and broadcast
exchanges — packed — and the hash engine, both in the port against the
reference's packed runs (see ``test_torch_gym_packed.py`` for what is
compared).  The reference's runs are made once per module.
"""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from repro.relational.spmd import SPMD  # noqa: E402
from test_skew_hybrid import _planted_star  # noqa: E402
from test_torch_gym_hybrid import assert_same_run  # noqa: E402
from test_torch_gym_packed import P, port_run, ref_run  # noqa: E402

ENGINES = ("hash", "hybrid")


@pytest.fixture(scope="module")
def ref_runs():
    spmd = SPMD(P)
    return {e: ref_run(spmd, *_planted_star(), strategy=e, wire_format="packed") for e in ENGINES}


@pytest.mark.parametrize("engine", ENGINES)
def test_packed_planted_star_matches_reference(ref_runs, engine):
    assert_same_run(port_run(*_planted_star(), strategy=engine, wire_format="packed"),
                    ref_runs[engine])


def test_packed_hybrid_routes_heavy_keys_and_ships_fewer_bytes():
    q, g, data = _planted_star()
    packed = port_run(q, g, data, strategy="hybrid", wire_format="packed")
    dense = port_run(q, g, data, strategy="hybrid")
    assert sorted(map(tuple, packed[0])) == sorted(map(tuple, dense[0]))
    assert packed[2].heavy_tuples > 0 and packed[2].retries == 0
    assert packed[2].comm_tuples == dense[2].comm_tuples
    assert packed[2].useful_bytes == dense[2].useful_bytes
    assert packed[2].payload_bytes < dense[2].payload_bytes
