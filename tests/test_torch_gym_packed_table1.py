"""The packed wire on the Table-1 families S_8, C_8 and TC_9 at the sizes
of ``benchmarks/bench_shuffle.py`` (p = 8, seed 23), fused and
calibrated, under the hash, grid and hybrid engines, in the port against
the reference's packed runs (see ``test_torch_gym_packed.py`` for what is
compared).  Marked slow: the JAX side alone compiles for tens of seconds
per family and engine."""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from repro.relational.spmd import SPMD  # noqa: E402
from test_torch_gym_hybrid import assert_same_run  # noqa: E402
from test_torch_gym_packed import assert_packed_keeps_dense_invariants, port_run, ref_run  # noqa: E402
from test_torch_table1 import FAMILIES  # noqa: E402

ENGINES = ("hash", "grid", "hybrid")


@pytest.mark.slow
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_packed_table1_family_matches_reference(family, engine):
    q, g, data = FAMILIES[family]()
    ref = ref_run(SPMD(8), q, g, data, p=8, seed=23, strategy=engine, wire_format="packed")
    port = port_run(q, g, data, p=8, seed=23, strategy=engine, wire_format="packed")
    assert_same_run(port, ref)
    assert port[2].output_tuples > 0
    assert_packed_keeps_dense_invariants(q, g, data, (family, engine), p=8, seed=23,
                                         strategy=engine)
