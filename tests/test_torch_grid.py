"""The port's grid operators (``repro_torch.relational.grid``, the grid
paths of ``batched`` and ``ops.hypercube_partition`` /
``local_multiway_join``) against the reference on the same tables.

Outputs are compared whole — data and valid planes, padding included —
and stats dicts and every ``GroupMeasure`` figure must be equal.  The
tolerance is exact: all data is int32 or bool.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.relational import batched as JB  # noqa: E402
from repro.relational import grid as JG  # noqa: E402
from repro.relational import ops as JO  # noqa: E402
from repro.relational.spmd import SPMD  # noqa: E402
from repro.relational.table import DTable  # noqa: E402

from repro_torch.interop import dtable_from_numpy  # noqa: E402
from repro_torch.relational import batched as TB  # noqa: E402
from repro_torch.relational import grid as TG  # noqa: E402
from repro_torch.relational import ops as TO  # noqa: E402
from repro_torch.relational.spmd import SPMD as TSPMD  # noqa: E402

_REF = {4: SPMD(4), 8: SPMD(8)}
SHARING = [("A", "B"), ("B", "C"), ("C", "D")]
DISJOINT = [("A",), ("B",), ("C",)]


def _tables(seed, schemas, p, n=14, dom=4, cap=4):
    rng = np.random.default_rng(seed)
    out = []
    for s in schemas:
        rows = np.unique(rng.integers(0, dom, (n, len(s))).astype(np.int32), axis=0)
        out.append(DTable.scatter_numpy(rows, s, p, cap=cap))
    return out


def _port(ts):
    return [dtable_from_numpy(np.asarray(t.data), np.asarray(t.valid), t.schema) for t in ts]


def _same_table(t, j):
    assert tuple(t.schema) == tuple(j.schema)
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))


def _same_measure(tm, jm):
    for f in ("out_recv", "out_need", "padded", "wire_bytes", "n_heavy"):
        assert getattr(tm, f) == getattr(jm, f), f
    for side in ("lhs", "rhs"):
        a, b = getattr(tm, side), getattr(jm, side)
        assert (a.c_out, a.cap_recv) == (b.c_out, b.cap_recv), side


@pytest.mark.parametrize("p", [1, 3, 4, 7, 8, 16, 64])
def test_grid_geometry_matches(p):
    for sizes in ([8], [8, 8], [16, 4], [4, 64, 8], [32, 32, 32], [5, 7, 11, 13], [2**20, 3, 2**10]):
        assert TG._grid_shares(sizes, p) == JG._grid_shares(sizes, p)
        assert TG._grid_geometry(sizes, p) == JG._grid_geometry(sizes, p)


@pytest.mark.parametrize("p", [4, 8])
def test_grid_multiway_count_matches(p):
    groups = [
        _tables(1, SHARING, p),
        _tables(2, DISJOINT, p, cap=8),
        _tables(3, [("A", "B"), ("B", "C")], p),
    ]
    want = JG.grid_multiway_count(_REF[p], groups)
    got = TG.grid_multiway_count(TSPMD(p, device="cpu"), [_port(g) for g in groups])
    assert got == want


@pytest.mark.parametrize("p", [4, 8])
@pytest.mark.parametrize("shape", ["sharing", "disjoint"])
@pytest.mark.parametrize("path", ["calibrate", "cals", "fixed"])
def test_grid_multiway_join_matches(p, shape, path):
    ts = _tables(5, SHARING if shape == "sharing" else DISJOINT, p)
    ref, tsp = _REF[p], TSPMD(p, device="cpu")
    kw = {"calibrate": True} if path == "calibrate" else {}
    if path == "cals":
        kw["cals"] = JG.grid_multiway_count(ref, [ts])[0][0]
    out_cap = 64 if shape == "sharing" else 128
    jo, js = JG.grid_multiway_join(ref, ts, out_cap=out_cap, **kw)
    to, tst = TG.grid_multiway_join(tsp, _port(ts), out_cap=out_cap, backend="torch", **kw)
    _same_table(to, jo)
    assert tst == js
    if path == "fixed":
        assert tst["dropped"] == 0  # the worst-case capacities hold everything


def test_grid_multiway_join_refuses_packed_wire():
    """The grid multiway join once refused wire formats (``fmts``); with
    the packed wire ported it ships each relation's send packed and equals
    the reference's packed join, stats (``wire_bytes``) included."""
    from repro.relational.wire import WireFormat as JWireFormat

    from repro_torch.relational.wire import WireFormat as TWireFormat

    ts = _tables(5, SHARING, 4)
    bits = [(2, 2), (2, 3), (3, 2)]
    jo, js = JG.grid_multiway_join(_REF[4], ts, out_cap=64, calibrate=True,
                                   fmts=[JWireFormat(b) for b in bits])
    to, tst = TG.grid_multiway_join(TSPMD(4, device="cpu"), _port(ts), out_cap=64,
                                    calibrate=True, backend="torch",
                                    fmts=[TWireFormat(b) for b in bits])
    _same_table(to, jo)
    assert tst == js
    dense = TG.grid_multiway_join(TSPMD(4, device="cpu"), _port(ts), out_cap=64,
                                  calibrate=True, backend="torch")
    _same_table(dense[0], jo)
    assert tst["wire_bytes"] < dense[1]["wire_bytes"]


@pytest.mark.parametrize("p", [4, 8])
def test_hypercube_partition_and_local_multiway_join_match(p):
    ts = _tables(7, SHARING, p)
    shares = {"B": 2, "C": 2, "A": 1, "D": 1} if p == 4 else {"B": 2, "C": 4, "A": 1, "D": 1}
    order = sorted(shares, key=lambda a: -shares[a])
    ref, tsp = _REF[p], TSPMD(p, device="cpu")
    jparts, tparts = [], []
    for j, t in zip(ts, _port(ts)):
        jp, jst = JO.hypercube_partition(ref, j, shares, order, seed=2**32 - 3, c_out=16, cap_recv=32)
        tp, tst = TO.hypercube_partition(tsp, t, shares, order, seed=2**32 - 3, c_out=16, cap_recv=32)
        _same_table(tp, jp)
        assert tst == jst
        jparts.append(jp)
        tparts.append(tp)
    jo, js = JO.local_multiway_join(ref, jparts, out_caps=(64, 64))
    to, tst = TO.local_multiway_join(tsp, tparts, out_caps=(64, 64), backend="torch")
    _same_table(to, jo)
    assert tst == js
    # a cap too small for the cells: the overflow is reported, equal
    jo, js = JO.local_multiway_join(ref, jparts, out_caps=(4, 4))
    to, tst = TO.local_multiway_join(tsp, tparts, out_caps=(4, 4), backend="torch")
    _same_table(to, jo)
    assert tst == js and tst["dropped"] > 0


@pytest.mark.parametrize("p", [4, 8])
def test_sequential_grid_join_semijoin_and_tree_dedup_match(p):
    s, r = _tables(11, [("A", "B", "C"), ("B", "D")], p, cap=8)
    ref, tsp = _REF[p], TSPMD(p, device="cpu")
    (ts_, tr), tsp_ = _port([s, r]), tsp
    jo, js = JG.grid_join(ref, s, r, out_cap=64)
    to, tst = TG.grid_join(tsp_, ts_, tr, out_cap=64, backend="torch")
    _same_table(to, jo)
    assert tst == js
    jo, js, jr = JG.grid_semijoin(ref, s, r, seed=5)
    to, tst, tr_ = TG.grid_semijoin(tsp_, ts_, tr, seed=5, backend="torch")
    _same_table(to, jo)
    assert (tst, tr_) == (js, jr)
    # many duplicates: every row repeated on several shards
    rows = np.tile(np.array([[1, 2], [3, 4], [1, 2], [0, 0]], np.int32), (6, 1))
    d = DTable.scatter_numpy(rows, ("A", "B"), p, cap=8)
    jo, js, jr = JG.tree_dedup(ref, d, fan=2, seed=9)
    to, tst, tr_ = TG.tree_dedup(tsp_, _port([d])[0], fan=2, seed=9)
    _same_table(to, jo)
    assert (tst, tr_) == (js, jr)


@pytest.mark.parametrize("p", [4, 8])
def test_batched_grid_ops_and_measures_match(p):
    ss = _tables(13, [("A", "B", "C"), ("B", "A", "D")], p, cap=8)
    rs = _tables(14, [("B", "E"), ("A", "E")], p, cap=8)
    ref, tsp = _REF[p], TSPMD(p, device="cpu")
    tss, trs = _port(ss), _port(rs)
    jm = JB.measure_grid_semijoin_many(ref, ss, rs)
    tm = TB.measure_grid_semijoin_many(tsp, tss, trs)
    _same_measure(tm, jm)
    kw = dict(c_out=(tm.lhs.c_out, tm.rhs.c_out), cap_recv=(tm.lhs.cap_recv, tm.rhs.cap_recv))
    jo, js = JB.grid_semijoin_many(ref, ss, rs, seeds=[3, 2**32 - 9], out_cap=16, **kw)
    to, tst = TB.grid_semijoin_many(tsp, tss, trs, seeds=[3, 2**32 - 9], out_cap=16, backend="torch", **kw)
    for t, j in zip(to, jo):
        _same_table(t, j)
    assert tst == js
    as_ = _tables(15, [("A", "B"), ("C", "B")], p, cap=8)
    bs = _tables(16, [("B", "C"), ("B", "D")], p, cap=8)
    tas, tbs = _port(as_), _port(bs)
    jm = JB.measure_grid_join_many(ref, as_, bs)
    tm = TB.measure_grid_join_many(tsp, tas, tbs)
    _same_measure(tm, jm)
    for kw in ({}, dict(c_out=(tm.lhs.c_out, tm.rhs.c_out), cap_recv=(tm.lhs.cap_recv, tm.rhs.cap_recv))):
        jo, js = JB.grid_join_many(ref, as_, bs, out_cap=64, **kw)
        to, tst = TB.grid_join_many(tsp, tas, tbs, out_cap=64, backend="torch", **kw)
        for t, j in zip(to, jo):
            _same_table(t, j)
        assert tst == js
    # the combined round pre-pass: both grid tags in ONE dispatch
    jc = JB.RoundCounts(ref, [JB.grid_rkeys_measure_spec(ref, ss, rs), JB.grid_pair_measure_spec(ref, as_, bs)])
    tc = TB.RoundCounts(
        tsp, [TB.grid_rkeys_measure_spec(tsp, tss, trs), TB.grid_pair_measure_spec(tsp, tas, tbs)],
        backend="torch",
    )
    for t, j in zip(tc.measures(), jc.measures()):
        _same_measure(t, j)
