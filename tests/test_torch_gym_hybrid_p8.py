"""The hybrid engine on two families of ``benchmarks/bench_skew.py`` at
p = 8, seed 23 and ``max_cap_tuples=1<<18``: the planted heavy key
``S_8_heavy`` and the zipf(1.1) chain ``C_8_z11``.  The port against the
reference (rows in order, schema, every ``RoundRecord``, retries,
dispatches), then the bench's own bar on the port's run: zero retries,
and on ``S_8_heavy`` heavy tuples and fewer padded slots than hash."""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from repro.core.gym import GymConfig, gym  # noqa: E402
from repro.core.queries import chain_ghd, chain_query, star_ghd, star_query  # noqa: E402
from repro.data.synthetic import chain_data_zipf, star_data_heavy  # noqa: E402
from repro.relational.spmd import SPMD  # noqa: E402
from test_torch_gym_hybrid import assert_same_run  # noqa: E402
from test_torch_gym_hybrid import port_run as _port_run  # noqa: E402

P = 8
CFG = dict(seed=23, max_cap_tuples=1 << 18)
FAMILIES = {
    "S_8_heavy": lambda: (
        star_query(8), star_ghd(8),
        star_data_heavy(8, domain=64, hub_rows=256, heavy_share=0.8, spoke_extra=16, seed=5),
    ),
    "C_8_z11": lambda: (
        chain_query(8), chain_ghd(8),
        chain_data_zipf(8, domain=96, rows=192, s=1.1, seed=34),
    ),
}


def port_run(q, g, data, strategy):
    return _port_run(q, g, data, p=P, strategy=strategy, **CFG)


@pytest.fixture(scope="module")
def ref_runs():
    spmd = SPMD(P)
    out = {}
    for name, make in FAMILIES.items():
        q, g, data = make()
        out[name] = gym(q, data, ghd=g, p=P, spmd=spmd, config=GymConfig(strategy="hybrid", **CFG))
    return out


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_bench_skew_family_matches_reference(ref_runs, name):
    q, g, data = FAMILIES[name]()
    run = port_run(q, g, data, "hybrid")
    assert_same_run(run, ref_runs[name])
    assert run[2].retries == 0 and run[2].heavy_tuples > 0
    if name == "S_8_heavy":
        hled = port_run(q, g, data, "hash")[2]
        assert run[2].padded_slots < hled.padded_slots
