"""The port's Shares baseline (``repro_torch.core.shares``) against the
reference: the optimized shares, rows, schema and the one-round ledger
(comm, retries, output tuples) must be equal; all data is int32, so
exact."""
from __future__ import annotations

import dataclasses
import random

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import shares as JS  # noqa: E402
from repro.core.queries import chain_query, star_query, triangle_chain_query  # noqa: E402
from repro.relational.spmd import SPMD  # noqa: E402
from test_torch_gym import rand_data, to_port_query  # noqa: E402

from repro_torch.core import shares as TS  # noqa: E402

_REF = SPMD(8)
QUERIES = {
    "chain3": lambda: chain_query(3),
    "star3": lambda: star_query(3),
    "tc1": lambda: triangle_chain_query(1),
}


@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_shares_join_matches_reference(qname):
    q = QUERIES[qname]()
    data = rand_data(q, random.Random(hash(("shares", qname)) & 0xFFFF), dom=5, rows=16)
    tq = to_port_query(q)
    sizes = {a.alias: len(np.unique(data[a.rel], axis=0)) for a in q.atoms}
    assert TS.optimize_shares(tq, sizes, 8) == JS.optimize_shares(q, sizes, 8)
    assert TS.replication_cost(tq, sizes, {"A1": 2}) == JS.replication_cost(q, sizes, {"A1": 2})
    rows, schema, led = JS.shares_join(q, data, p=8, spmd=_REF, seed=4)
    trows, tschema, tled = TS.shares_join(tq, data, p=8, seed=4, device="cpu")
    assert tuple(tschema) == tuple(schema)
    np.testing.assert_array_equal(trows, np.asarray(rows))
    assert [dataclasses.asdict(r) for r in tled.records] == [
        dataclasses.asdict(r) for r in led.records
    ]
    assert (tled.retries, tled.output_tuples) == (led.retries, led.output_tuples)
    assert tled.rounds == 1


def test_shares_join_retries_like_the_reference():
    """A tight first capacity forces the abort-and-retry loop."""
    q = chain_query(3)
    full = np.array([[a, b] for a in range(3) for b in range(3)], np.int32)
    data = {a.rel: full for a in q.atoms}  # 81 answers over 8 cells
    rows, _, led = JS.shares_join(q, data, p=8, spmd=_REF, out_cap=4)
    trows, _, tled = TS.shares_join(to_port_query(q), data, p=8, out_cap=4, device="cpu")
    np.testing.assert_array_equal(trows, np.asarray(rows))
    assert tled.retries == led.retries > 0
    assert tled.comm_tuples == led.comm_tuples
    assert tled.output_tuples == led.output_tuples == 81
