"""``GymConfig(wire_format="packed")`` in the port against the reference's
packed run, end to end.

The reference is the JAX package's own packed ``gym()``: the port must
equal it in rows (order included), schema, every ``RoundRecord``
(``payload_bytes``, ``padded_slots`` and ``measured_dispatches`` included),
retries and output tuples.  A packed run is held against the packed
reference, never against the port's dense run: packing changes the
control flow too (the join pre-count's keys guess, and so the fallback
dispatches and their padded slots).  Against the port's own dense run a
packed run keeps ``tests/test_wire_format.py::_assert_parity``'s
invariants: equal rows, comm, shuffle tuples, rounds and useful bytes, no
retry, and fewer payload bytes.

Cases: ``test_wire_format.py``'s chain, star and triangle-chain at p = 4,
fused and calibrated, under the hash and hybrid engines here; the grid
engine, the planted heavy key, the sequential and fixed-capacity runs and
the Table-1 families are in ``test_torch_gym_packed_*.py``, so the
reference's JAX compile time spreads over test workers.  The reference's
runs are made once per module and shared by the tests.
"""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from repro.core.gym import GymConfig, gym  # noqa: E402
from repro.relational.spmd import SPMD  # noqa: E402
from test_torch_gym import to_port_query  # noqa: E402
from test_torch_gym_hybrid import assert_same_run  # noqa: E402
from test_wire_format import CASES, _assert_parity  # noqa: E402

from repro_torch.core.gym import GymConfig as TGymConfig  # noqa: E402
from repro_torch.core.gym import gym as tgym  # noqa: E402
from repro_torch.interop import ghd_from_dict  # noqa: E402

P = 4
ENGINES = ("hash", "hybrid")


def ref_run(spmd, q, g, data, p=P, seed=3, **cfg):
    return gym(q, data, ghd=g, p=p, spmd=spmd, config=GymConfig(seed=seed, **cfg))


def port_run(q, g, data, p=P, seed=3, **cfg):
    return tgym(
        to_port_query(q), data, ghd=ghd_from_dict(g.to_dict()), p=p,
        config=TGymConfig(seed=seed, **cfg), device="cpu",
    )


def assert_packed_keeps_dense_invariants(q, g, data, key, p=P, seed=3, **cfg):
    """The port's packed run against the port's dense run."""
    packed = port_run(q, g, data, p=p, seed=seed, wire_format="packed", **cfg)
    dense = port_run(q, g, data, p=p, seed=seed, wire_format="dense", **cfg)
    _assert_parity(
        (sorted(map(tuple, packed[0])), packed[2]),
        (sorted(map(tuple, dense[0])), dense[2]),
        key,
    )
    return packed, dense


@pytest.fixture(scope="module")
def ref_runs():
    spmd = SPMD(P)
    out = {}
    for name in sorted(CASES):
        q, g, data = CASES[name]()
        for engine in ENGINES:
            out[name, engine] = ref_run(spmd, q, g, data, strategy=engine, wire_format="packed")
    return out


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_packed_gym_matches_reference(ref_runs, name, engine):
    q, g, data = CASES[name]()
    assert_same_run(
        port_run(q, g, data, strategy=engine, wire_format="packed"), ref_runs[name, engine]
    )


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_packed_keeps_dense_invariants(name, engine):
    q, g, data = CASES[name]()
    packed, _ = assert_packed_keeps_dense_invariants(q, g, data, (name, engine), strategy=engine)
    assert packed[2].payload_bytes > 0


def test_packed_engine_carries_the_policy():
    """``GymDriver`` derives the policy from the deduped base relations and
    hands it to the engine only for a packed run."""
    from repro_torch.core.gym import GymDriver
    from repro_torch.relational.spmd import SPMD as TSPMD

    q, g, data = CASES["chain"]()
    drv = GymDriver(to_port_query(q), ghd_from_dict(g.to_dict()), data,
                    TSPMD(P, device="cpu"), TGymConfig(wire_format="packed"))
    pol = drv.executor.engine.wire_policy
    assert pol is not None and pol == drv._wire_policy
    assert all(1 <= b <= 32 for _, b in pol.attr_bits)
    dense = GymDriver(to_port_query(q), ghd_from_dict(g.to_dict()), data,
                      TSPMD(P, device="cpu"), TGymConfig())
    assert dense.executor.engine.wire_policy is None
    with pytest.raises(ValueError, match="wire_format"):
        TGymConfig(wire_format="sparse")
