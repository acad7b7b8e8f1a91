"""The keyword arguments of the grid operators and of Shares that the
reference accepts — ``grid_semijoin(out_cap=)``, ``tree_dedup(cap_recv=)``,
``grid_multiway_join(c_out=, cap_recv=, sizes=)`` and
``shares_join(shares=, max_retries=)`` — each at a non-default value,
against the reference.  Outputs are compared whole (data and valid
planes) with their stats, or as rows and ledger; all data is int32, so
exact."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import shares as JS  # noqa: E402
from repro.core.queries import chain_query  # noqa: E402
from repro.relational import grid as JG  # noqa: E402
from repro.relational.spmd import SPMD  # noqa: E402
from repro.relational.table import DTable  # noqa: E402
from test_torch_grid import SHARING, _port, _same_table, _tables  # noqa: E402
from test_torch_gym import to_port_query  # noqa: E402

from repro_torch.core import shares as TS  # noqa: E402
from repro_torch.relational import grid as TG  # noqa: E402
from repro_torch.relational.spmd import SPMD as TSPMD  # noqa: E402

P = 4


@pytest.fixture(scope="module")
def spmds():
    return SPMD(P), TSPMD(P, device="cpu")


@pytest.mark.parametrize("out_cap", [96, 8])
def test_grid_semijoin_out_cap(spmds, out_cap):
    """``out_cap=96`` as ``benchmarks/bench_lemmas.py`` passes it; 8 is
    below the marked rows, so the dedup's receive drops, equally."""
    ref, tsp = spmds
    s, r = _tables(11, [("A", "B", "C"), ("B", "D")], P, n=20, cap=8)
    jo, js, jr = JG.grid_semijoin(ref, s, r, out_cap=out_cap, seed=5)
    to, tst, tr = TG.grid_semijoin(tsp, *_port([s, r]), out_cap=out_cap, seed=5)
    _same_table(to, jo)
    assert (tst, tr) == (js, jr)
    assert to.cap == out_cap
    assert (tst["dropped"] > 0) == (out_cap == 8)


@pytest.mark.parametrize("cap_recv", [64, 6])
def test_tree_dedup_cap_recv(spmds, cap_recv):
    ref, tsp = spmds
    rows = np.tile(np.array([[1, 2], [3, 4], [1, 2], [0, 0]], np.int32), (6, 1))
    d = DTable.scatter_numpy(rows, ("A", "B"), P, cap=8)
    jo, js, jr = JG.tree_dedup(ref, d, fan=2, seed=9, cap_recv=cap_recv)
    to, tst, tr = TG.tree_dedup(tsp, _port([d])[0], fan=2, seed=9, cap_recv=cap_recv)
    _same_table(to, jo)
    assert (tst, tr) == (js, jr)
    assert to.cap == cap_recv


@pytest.mark.parametrize(
    "kw",
    [
        dict(c_out=16, cap_recv=32),
        dict(c_out=2, cap_recv=32),
        dict(sizes=[64, 8, 8]),
        dict(sizes=[8, 8, 64], calibrate=True),
        dict(c_out=16, calibrate=True),  # fixed caps switch calibrate off
    ],
)
def test_grid_multiway_join_caps_and_sizes(spmds, kw):
    ref, tsp = spmds
    ts = _tables(5, SHARING, P)
    jo, js = JG.grid_multiway_join(ref, ts, out_cap=64, **kw)
    to, tst = TG.grid_multiway_join(tsp, _port(ts), out_cap=64, **kw)
    _same_table(to, jo)
    assert tst == js


def test_shares_join_shares_and_max_retries(spmds):
    q = chain_query(3)
    full = np.array([[a, b] for a in range(3) for b in range(3)], np.int32)
    data = {a.rel: full for a in q.atoms}  # 81 answers
    tq = to_port_query(q)
    ref = SPMD(8)
    shares = {"A1": 1, "A2": 4, "A3": 2, "A4": 1}  # not the optimizer's pick
    assert JS.optimize_shares(q, {a.alias: 9 for a in q.atoms}, 8) != shares
    rows, schema, led = JS.shares_join(q, data, p=8, spmd=ref, shares=shares, out_cap=4, max_retries=20)
    trows, tschema, tled = TS.shares_join(tq, data, p=8, shares=shares, out_cap=4, max_retries=20, device="cpu")
    assert tuple(tschema) == tuple(schema)
    np.testing.assert_array_equal(trows, np.asarray(rows))
    assert [dataclasses.asdict(r) for r in tled.records] == [
        dataclasses.asdict(r) for r in led.records
    ]
    assert tled.retries == led.retries > 0
    # fewer retries allowed than the tight capacity needs: both refuse
    with pytest.raises(AssertionError, match="too many retries"):
        JS.shares_join(q, data, p=8, spmd=ref, shares=shares, out_cap=4, max_retries=led.retries)
    with pytest.raises(AssertionError, match="too many retries"):
        TS.shares_join(tq, data, p=8, shares=shares, out_cap=4, max_retries=tled.retries, device="cpu")
