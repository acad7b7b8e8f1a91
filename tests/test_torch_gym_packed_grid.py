"""``GymConfig(strategy="grid", wire_format="packed")`` — the grid engine
on the packed wire — in the port against the reference's packed run, on
``test_wire_format.py``'s chain, star and triangle-chain at p = 4, fused
and calibrated (see ``test_torch_gym_packed.py`` for what is compared).
The reference's runs are made once per module and shared by the tests.
"""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from repro.relational.spmd import SPMD  # noqa: E402
from test_torch_gym_hybrid import assert_same_run  # noqa: E402
from test_torch_gym_packed import (  # noqa: E402
    P,
    assert_packed_keeps_dense_invariants,
    port_run,
    ref_run,
)
from test_wire_format import CASES  # noqa: E402


@pytest.fixture(scope="module")
def ref_runs():
    spmd = SPMD(P)
    return {
        name: ref_run(spmd, *CASES[name](), strategy="grid", wire_format="packed")
        for name in sorted(CASES)
    }


@pytest.mark.parametrize("name", sorted(CASES))
def test_packed_grid_gym_matches_reference(ref_runs, name):
    q, g, data = CASES[name]()
    assert_same_run(port_run(q, g, data, strategy="grid", wire_format="packed"), ref_runs[name])


@pytest.mark.parametrize("name", sorted(CASES))
def test_packed_grid_keeps_dense_invariants(name):
    q, g, data = CASES[name]()
    assert_packed_keeps_dense_invariants(q, g, data, (name, "grid"), strategy="grid")
