"""The port's log-depth path against the reference, end to end.

``gym_loggta`` (GYM on Log-GTA(D)) and ``acq_mr`` (GYM on Log-GTA'(D))
under the default ``GymConfig``: their plans have 3-atom bags, some of
them cross products of projections (pi_A4(R4) x pi_A6(R6) x pi_A8(R8) in
Log-GTA(C_8)), which the hash engine materializes with the Lemma 8 grid
multiway join.  Rows (order included), schema, every ``RoundRecord``,
retries and output tuples must be equal; all data is int32, so exact.
Figure 6's TC_15 is in ``test_torch_gym_loggta_tc15.py`` (the JAX
compile time spreads over test workers by file).
"""
from __future__ import annotations

import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import acq_mr as JA  # noqa: E402
from repro.core.gym import GymConfig  # noqa: E402
from repro.core.queries import chain_query  # noqa: E402
from repro.relational.oracle import canon, np_query_answer, reorder  # noqa: E402
from repro.relational.spmd import SPMD  # noqa: E402
from test_torch_gym import rand_data, to_port_query  # noqa: E402

from repro_torch.core import acq_mr as TA  # noqa: E402
from repro_torch.core.gym import GymConfig as TGymConfig  # noqa: E402
from repro_torch.interop import ghd_from_dict  # noqa: E402

_REF = SPMD(4)


def assert_entry_parity(name, q, data, *, p, ghd=None, **cfg):
    rows, schema, led = getattr(JA, name)(
        q, data, ghd=ghd, p=p, spmd=_REF, config=GymConfig(**cfg)
    )
    trows, tschema, tled = getattr(TA, name)(
        to_port_query(q), data, p=p, config=TGymConfig(**cfg), device="cpu",
        ghd=None if ghd is None else ghd_from_dict(ghd.to_dict()),
    )
    assert tuple(tschema) == tuple(schema)
    np.testing.assert_array_equal(trows, np.asarray(rows))
    assert [dataclasses.asdict(r) for r in tled.records] == [
        dataclasses.asdict(r) for r in led.records
    ]
    assert (tled.retries, tled.output_tuples) == (led.retries, led.output_tuples)
    return trows, tled


@pytest.mark.parametrize("name", ["gym_loggta", "acq_mr"])
def test_log_depth_chain8_matches_reference(name):
    """Log-GTA(C_8) / Log-GTA'(C_8) at a small domain, so the cross bags
    are dense and the chain has answers."""
    q = chain_query(8)
    data = rand_data(q, random.Random(5), dom=4, rows=10)
    rows, led = assert_entry_parity(name, q, data, p=4, seed=3)
    want, schema = np_query_answer([(a.alias, a.attrs) for a in q.atoms], data)
    want = canon(reorder(want, schema, q.output_attrs))
    assert canon(rows) == want
    assert led.output_tuples == len(want) > 0

