"""The port's fused operators and calibration pre-passes
(``repro_torch.relational.batched``) against ``repro.relational.batched``
on the same stacked groups, seeds and capacities: outputs, per-instance
stats and every ``GroupMeasure`` figure must be equal.  Tables cross over
through ``repro_torch.interop.dtable_from_numpy``."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.relational import batched as JB  # noqa: E402
from repro.relational.spmd import SPMD  # noqa: E402
from repro.relational.table import DTable  # noqa: E402

from repro_torch.interop import dtable_from_numpy  # noqa: E402
from repro_torch.relational import batched as TB  # noqa: E402
from repro_torch.relational.spmd import SPMD as TSPMD  # noqa: E402

P = 4
SEEDS = [7919, 2**32 - 5]
_REF = SPMD(P)


def _tables(seed, schemas, n=20, dom=5):
    rng = np.random.default_rng(seed)
    out = []
    for s in schemas:
        rows = np.unique(rng.integers(0, dom, (n, len(s))).astype(np.int32), axis=0)
        out.append(DTable.scatter_numpy(rows, s, P, cap=8))
    return out


def _port(ts):
    return [dtable_from_numpy(np.asarray(t.data), np.asarray(t.valid), t.schema) for t in ts]


def _same_measure(tm, jm):
    for f in ("out_recv", "out_need", "padded", "wire_bytes", "n_heavy"):
        assert getattr(tm, f) == getattr(jm, f), f
    for side in ("lhs", "rhs"):
        a, b = getattr(tm, side), getattr(jm, side)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.c_out, a.cap_recv) == (b.c_out, b.cap_recv), side


def _same_outputs(touts, tstats, jouts, jstats):
    assert tstats == jstats
    for t, j in zip(touts, jouts):
        assert t.schema == j.schema
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
        np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))


def test_interop_table_matches_port_scatter():
    rows = np.array([[3, 1], [0, 2], [5, 5], [1, 1], [2, 9]], np.int32)
    j = DTable.scatter_numpy(rows, ("A", "B"), P, cap=4)
    t = dtable_from_numpy(np.asarray(j.data), np.asarray(j.valid), j.schema)
    from repro_torch.relational.table import DTable as TDTable

    u = TDTable.scatter_numpy(rows, ("A", "B"), P, cap=4)
    assert torch.equal(t.data, u.data) and torch.equal(t.valid, u.valid)
    np.testing.assert_array_equal(t.to_numpy(), j.to_numpy())


def test_semijoin_and_join_groups_match():
    ss = _tables(1, [("A", "B", "C"), ("B", "A", "D")])
    rs = _tables(2, [("B", "E"), ("A", "E")])
    ts = TSPMD(P, device="cpu")
    jm = JB.measure_semijoin_many(_REF, ss, rs, seeds=SEEDS)
    tm = TB.measure_semijoin_many(ts, _port(ss), _port(rs), seeds=SEEDS, backend="torch")
    _same_measure(tm, jm)
    kw = dict(seeds=SEEDS, c_out=(tm.lhs.c_out, tm.rhs.c_out), cap_recv=(32, tm.rhs.cap_recv))
    jo, js = JB.dist_semijoin_many(_REF, ss, rs, **kw)
    to, tst = TB.dist_semijoin_many(ts, _port(ss), _port(rs), backend="torch", **kw)
    _same_outputs(to, tst, jo, js)

    as_ = _tables(3, [("A", "B"), ("C", "B")])
    bs = _tables(4, [("B", "C"), ("B", "D")])
    jm = JB.measure_join_many(_REF, as_, bs, seeds=SEEDS)
    tm = TB.measure_join_many(ts, _port(as_), _port(bs), seeds=SEEDS, backend="torch")
    _same_measure(tm, jm)
    for c_out, cap_recv in (((tm.lhs.c_out, tm.rhs.c_out), (tm.lhs.cap_recv, tm.rhs.cap_recv)), (None, None)):
        kw = dict(seeds=SEEDS, out_cap=16, c_out=c_out, cap_recv=cap_recv)
        jo, js = JB.dist_join_many(_REF, as_, bs, **kw)
        to, tst = TB.dist_join_many(ts, _port(as_), _port(bs), backend="torch", **kw)
        _same_outputs(to, tst, jo, js)


def test_intersect_and_dedup_groups_match():
    ts = TSPMD(P, device="cpu")
    as_ = _tables(5, [("A", "B"), ("A", "B")], dom=3)
    bs = _tables(6, [("B", "A"), ("A", "B")], dom=3)
    jm = JB.measure_intersect_many(_REF, as_, bs, seeds=SEEDS)
    tm = TB.measure_intersect_many(ts, _port(as_), _port(bs), seeds=SEEDS, backend="torch")
    _same_measure(tm, jm)
    kw = dict(seeds=SEEDS, cap_recv=(16, 32))
    jo, js = JB.dist_intersect_many(_REF, as_, bs, **kw)
    to, tst = TB.dist_intersect_many(ts, _port(as_), _port(bs), backend="torch", **kw)
    _same_outputs(to, tst, jo, js)

    jm = JB.measure_dedup_many(_REF, as_, seeds=SEEDS)
    tm = TB.measure_dedup_many(ts, _port(as_), seeds=SEEDS, backend="torch")
    _same_measure(tm, jm)
    jo, js = JB.dist_dedup_many(_REF, as_, seeds=SEEDS, cap_recv=8, c_out=2)
    to, tst = TB.dist_dedup_many(ts, _port(as_), seeds=SEEDS, cap_recv=8, c_out=2, backend="torch")
    _same_outputs(to, tst, jo, js)  # c_out=2 forces drops: counted alike


def test_round_counts_match():
    """One combined pre-pass over pair, join_pair and single specs."""
    ts = TSPMD(P, device="cpu")
    ss = _tables(7, [("A", "B", "C"), ("B", "A", "D")])
    rs = _tables(8, [("B", "E"), ("A", "E")])
    as_ = _tables(9, [("A", "B"), ("C", "B")])
    bs = _tables(10, [("B", "C"), ("B", "D")])
    keys = lambda xs, ys: (  # noqa: E731
        [x.cols([c for c in x.schema if c in y.schema]) for x, y in zip(xs, ys)],
        [y.cols([c for c in x.schema if c in y.schema]) for x, y in zip(xs, ys)],
    )
    sk, rk = keys(ss, rs)
    ak, bk = keys(as_, bs)

    def specs(mod, spmd, conv):
        return [
            mod.pair_measure_spec(spmd, conv(ss), conv(rs), sk, rk, SEEDS, dedup_b=True),
            mod.join_pair_measure_spec(spmd, conv(as_), conv(bs), ak, bk, SEEDS, g_a=2, g_b=8),
            mod.single_measure_spec(spmd, conv(as_), SEEDS),
        ]

    jms = JB.RoundCounts(_REF, specs(JB, _REF, list)).measures()
    tms = TB.RoundCounts(ts, specs(TB, ts, _port), backend="torch").measures()
    for tm, jm in zip(tms, jms):
        _same_measure(tm, jm)
    # the fallback exact join count for the group whose guess was too small
    jn = JB.join_need_many(_REF, [(as_, bs, SEEDS, jms[1])])
    tn = TB.join_need_many(ts, [(_port(as_), _port(bs), SEEDS, tms[1])], backend="torch")
    _same_measure(tn[0], jn[0])
