"""Port-vs-reference ``gym()`` parity on the Table-1 families S_8, C_8 and
TC_9 at the sizes of ``benchmarks/bench_shuffle.py`` (p=8, seed=23, the
default calibrated dense configuration, under the hash engine and under
``strategy="grid"``).  Marked slow: the JAX side alone
compiles for tens of seconds per family."""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from repro.core.queries import (  # noqa: E402
    chain_ghd,
    chain_query,
    star_ghd,
    star_query,
    triangle_chain_ghd,
    triangle_chain_query,
)
from repro.data.synthetic import (  # noqa: E402
    chain_data_sparse,
    star_data_sparse,
    tc_data_sparse,
)
from repro.relational.spmd import SPMD  # noqa: E402
from test_torch_gym import assert_gym_parity  # noqa: E402

FAMILIES = {
    "S_8": lambda: (
        star_query(8),
        star_ghd(8),
        star_data_sparse(8, domain=64, hub_rows=256, spoke_extra=64, seed=21),
    ),
    "C_8": lambda: (
        chain_query(8),
        chain_ghd(8),
        chain_data_sparse(8, domain=256, ident=64, extra=192, seed=24),
    ),
    "TC_9": lambda: (
        triangle_chain_query(3),
        triangle_chain_ghd(3),
        tc_data_sparse(3, domain=128, ident=32, extra=96, seed=22),
    ),
}


@pytest.mark.slow
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_table1_family_parity(family):
    q, g, data = FAMILIES[family]()
    led = assert_gym_parity(
        q, data, p=8, ref_spmd=SPMD(8), ghd=g, strategy="hash", seed=23
    )
    assert led.output_tuples > 0


@pytest.mark.slow
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_table1_family_grid_parity(family):
    q, g, data = FAMILIES[family]()
    led = assert_gym_parity(
        q, data, p=8, ref_spmd=SPMD(8), ghd=g, strategy="grid", seed=23
    )
    assert led.output_tuples > 0
