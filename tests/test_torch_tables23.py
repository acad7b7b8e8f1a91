"""The paper's Table 2 (S_5) and Table 3 (TC_12) comparisons in the port
against the reference: Shares, GYM, GYM(Log-GTA) and ACQ-MR on the data
of ``benchmarks/bench_table2.py`` / ``bench_table3.py`` at p=8.  Every
algorithm's rows, rounds and comm must equal the reference's.  Marked
slow: the JAX side compiles for minutes."""
from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import acq_mr as JA  # noqa: E402
from repro.core import gym as JG  # noqa: E402
from repro.core import shares as JS  # noqa: E402
from repro.core.queries import (  # noqa: E402
    star_ghd,
    star_query,
    triangle_chain_ghd,
    triangle_chain_query,
)
from repro.data.synthetic import star_data_sparse, tc_data_sparse  # noqa: E402
from repro.relational.spmd import SPMD  # noqa: E402
from test_torch_gym import to_port_query  # noqa: E402

from repro_torch.core import acq_mr as TA  # noqa: E402
from repro_torch.core import gym as TG  # noqa: E402
from repro_torch.core import shares as TS  # noqa: E402
from repro_torch.interop import ghd_from_dict  # noqa: E402

TABLES = {
    "table2": lambda: (star_query(5), star_ghd(5), star_data_sparse(5, seed=1), 2),
    "table3": lambda: (triangle_chain_query(4), triangle_chain_ghd(4), tc_data_sparse(4, seed=3), 4),
}


@pytest.mark.slow
@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("alg", ["shares", "gym", "gym_loggta", "acq_mr"])
def test_table_comparison_matches_reference(table, alg):
    q, g, data, seed = TABLES[table]()
    tq, tg = to_port_query(q), ghd_from_dict(g.to_dict())
    ref = SPMD(8)
    if alg == "shares":
        want = JS.shares_join(q, data, p=8, spmd=ref)
        got = TS.shares_join(tq, data, p=8, device="cpu")
    else:
        jfn = JG.gym if alg == "gym" else getattr(JA, alg)
        tfn = TG.gym if alg == "gym" else getattr(TA, alg)
        want = jfn(q, data, ghd=g, p=8, spmd=ref, config=JG.GymConfig(seed=seed))
        got = tfn(tq, data, ghd=tg, p=8, config=TG.GymConfig(seed=seed), device="cpu")
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert tuple(got[1]) == tuple(want[1])
    assert (got[2].rounds, got[2].comm_tuples, got[2].retries) == (
        want[2].rounds, want[2].comm_tuples, want[2].retries,
    )
