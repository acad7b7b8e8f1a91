"""The PyTorch port's ``gym()`` against the JAX reference, end to end.

Same query, GHD and data (made from a seed) through ``repro.core.gym.gym``
and ``repro_torch.core.gym.gym(device="cpu")``; rows (order included),
schema, every ``RoundRecord``, retries and output tuples must be equal.
The tolerance is exact: all data is int32 or bool.

The JAX side compiles one XLA program per distinct operator shape, so each
test file shares one reference ``SPMD`` (its compile cache) across its
tests; the queries are spread over ``test_torch_gym*.py`` files so the
compile time spreads over test workers.
"""
from __future__ import annotations

import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.decompose import ghd_for  # noqa: E402
from repro.core.gym import GymConfig, gym  # noqa: E402
from repro.core.hypergraph import Atom, Query  # noqa: E402
from repro.core.queries import (  # noqa: E402
    chain_query,
    example4_query,
    star_query,
    triangle_chain_query,
)
from repro.relational.spmd import SPMD  # noqa: E402

from repro_torch.core.gym import GymConfig as TGymConfig  # noqa: E402
from repro_torch.core.gym import gym as tgym  # noqa: E402
from repro_torch.interop import ghd_from_dict, query_from_atoms  # noqa: E402

QUERIES = {
    "chain4": lambda: chain_query(4),
    "star4": lambda: star_query(4),
    "tc2": lambda: triangle_chain_query(2),
    "example4": example4_query,
    "selfjoin": lambda: Query(
        [Atom("R1", "R", ("A", "B")), Atom("R2", "R", ("B", "C"))],
        name="SelfJoin",
    ),
}


def rand_data(query, rng: random.Random, dom: int = 6, rows: int = 12):
    """Random relation contents over a small shared domain (as in
    ``tests/test_gym_engine.py``), so joins really match."""
    out = {}
    for atom in query.atoms:
        n = rng.randint(1, rows)
        out[atom.rel] = np.array(
            [[rng.randint(0, dom - 1) for _ in atom.attrs] for _ in range(n)],
            dtype=np.int32,
        )
    return out


def to_port_query(q):
    return query_from_atoms([(a.alias, a.rel, a.attrs) for a in q.atoms], name=q.name)


def assert_gym_parity(q, data, *, p, ref_spmd, ghd=None, **cfg):
    """Run both packages on one plan and dataset; require exact equality."""
    g = ghd if ghd is not None else ghd_for(q)
    rows, schema, led = gym(q, data, ghd=g, p=p, spmd=ref_spmd, config=GymConfig(**cfg))
    trows, tschema, tled = tgym(
        to_port_query(q), data, ghd=ghd_from_dict(g.to_dict()), p=p,
        config=TGymConfig(**cfg), device="cpu",
    )
    assert tuple(tschema) == tuple(schema)
    assert trows.dtype == np.asarray(rows).dtype
    np.testing.assert_array_equal(trows, np.asarray(rows))
    assert [dataclasses.asdict(r) for r in tled.records] == [
        dataclasses.asdict(r) for r in led.records
    ]
    assert tled.retries == led.retries
    assert tled.output_tuples == led.output_tuples
    return tled


_REF = SPMD(4)


def _data(qname):
    q = QUERIES[qname]()
    return q, rand_data(q, random.Random(hash(("hash", qname)) & 0xFFFF))


@pytest.mark.parametrize("qname", ["chain4", "selfjoin"])
def test_gym_parity_default_config(qname):
    q, data = _data(qname)
    led = assert_gym_parity(q, data, p=4, ref_spmd=_REF, seed=3)
    assert led.rounds >= 1


@pytest.mark.parametrize("knob", ["fused", "calibrate_shuffle"])
def test_gym_parity_knob_off(knob):
    q, data = _data("chain4")
    assert_gym_parity(q, data, p=4, ref_spmd=_REF, seed=3, **{knob: False})
