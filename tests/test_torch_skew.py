"""The port's heavy-hitter routing (``repro_torch.relational.skew``,
``routed_all_to_all(heavy=)``), the sequential operators
(``repartition``, ``measure_exchange``, ``dist_semijoin``,
``dist_intersect``) and the hybrid operators (the hybrid measures and
payloads of ``batched``, ``ops.dist_join_hybrid`` /
``dist_semijoin_hybrid``) against the reference on the same tables.

Outputs are compared whole — data and valid planes, padding included —
and stats dicts and every ``GroupMeasure`` field must be equal.  The
tolerance is exact: all data is int32 or bool.  The reference's results
are computed once per module (``ref_*`` fixtures) and shared by the
tests that compare against them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.relational import batched as JB  # noqa: E402
from repro.relational import ops as JO  # noqa: E402
from repro.relational import routed as JR  # noqa: E402
from repro.relational import skew as JS  # noqa: E402
from repro.relational.spmd import AXIS, SPMD  # noqa: E402
from repro.relational.table import DTable  # noqa: E402
from test_skew_hybrid import mk, planted_pair  # noqa: E402
from test_torch_grid import _port, _same_table  # noqa: E402

from repro_torch.relational import batched as TB  # noqa: E402
from repro_torch.relational import ops as TO  # noqa: E402
from repro_torch.relational import routed as TR  # noqa: E402
from repro_torch.relational import skew as TS  # noqa: E402
from repro_torch.relational.spmd import SPMD as TSPMD  # noqa: E402

P = 4


def _same_measure(tm, jm):
    """Every ``GroupMeasure`` field, the heavy flags included."""
    for f in dataclasses.fields(jm):
        a, b = getattr(tm, f.name), getattr(jm, f.name)
        if f.name in ("lhs", "rhs"):
            assert (a is None) == (b is None), f.name
            if b is not None:
                assert (a.c_out, a.cap_recv) == (b.c_out, b.cap_recv), f.name
        elif f.name == "heavy":
            assert (a is None) == (b is None)
            if b is not None:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        else:
            assert a == b, (f.name, a, b)


def _unskewed_pair(seed=4):
    rng = np.random.default_rng(seed)
    a = np.unique(rng.integers(0, 30, (20, 2)).astype(np.int32), axis=0)
    b = np.unique(rng.integers(0, 30, (20, 2)).astype(np.int32), axis=0)
    return mk(a, ("A", "B"), P, cap=8), mk(b, ("B", "C"), P, cap=8)


# -------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def spmds():
    return SPMD(P), TSPMD(P, device="cpu")


@pytest.fixture(scope="module")
def pairs():
    """name -> (reference pair, port pair); ``planted3_rev`` carries the
    planted heavy mass on the right operand."""
    out = {}
    for name, (a, b) in {
        "planted": planted_pair(seed=1),
        "planted_s2": planted_pair(seed=2),
        "unskewed": _unskewed_pair(),
    }.items():
        out[name] = ((a, b), tuple(_port([a, b])))
    a, b = planted_pair(seed=3)
    out["planted3"] = ((a, b), tuple(_port([a, b])))
    out["planted3_rev"] = ((b, a), tuple(_port([b, a])))
    return out


@pytest.fixture(scope="module")
def ref_join_measures(spmds, pairs):
    ref = spmds[0]
    return {
        (name, hybrid): JB.measure_join_many(
            ref, [pairs[name][0][0]], [pairs[name][0][1]], seeds=[11], hybrid=hybrid
        )
        for name in ("planted3", "planted3_rev", "unskewed")
        for hybrid in (False, True)
    }


# -------------------------------------------------------------- routing
def _ref_routes(dest, heavy, p):
    def shard(d, h):
        sd, sh = JS.split_dests(d, h, p)
        bd, bh = JS.bcast_dests(d, h, p)
        return sd, sh, bd, bh

    return jax.jit(jax.vmap(shard, axis_name=AXIS))(jnp.asarray(dest), jnp.asarray(heavy))


@pytest.mark.parametrize("p", [4, 8])
@pytest.mark.parametrize("k", [None, 3])
def test_split_and_bcast_dests_match(p, k):
    rng = np.random.default_rng(p * 10 + (k or 0))
    n = 23
    shape = (p, n) if k is None else (p, k, n)
    dest = rng.integers(0, p + 1, shape).astype(np.int32)  # p = dead
    flags = rng.random(shape[:-1] + (p,)) < 0.4
    flags[..., 0] = True  # at least one heavy destination
    got = [*TS.split_dests(torch.from_numpy(dest), torch.from_numpy(flags), p),
           *TS.bcast_dests(torch.from_numpy(dest), torch.from_numpy(flags), p)]
    if k is None:
        want = _ref_routes(dest, flags, p)
    else:  # one reference call per instance: the shard offset is per shard
        per = [_ref_routes(dest[:, i], flags[:, i], p) for i in range(k)]
        want = [np.stack([np.asarray(w[j]) for w in per], axis=1) for j in range(4)]
    for g, w in zip(got, want):
        assert g.dtype in (torch.int32, torch.bool)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the broadcast side's heavy rows go everywhere, its light rows once
    assert int(got[3].sum()) == int(got[1].sum())


@pytest.mark.parametrize("c_out,cap_recv", [(16, 64), (3, 64), (16, 7)])
def test_routed_all_to_all_heavy_matches(c_out, cap_recv):
    rng = np.random.default_rng(c_out * 100 + cap_recv)
    n, ar = 14, 3
    data = rng.integers(0, 9, (P, n, ar)).astype(np.int32)
    valid = rng.random((P, n)) < 0.8
    dest = np.where(rng.random((P, n)) < 0.6, 0, rng.integers(0, P, (P, n))).astype(np.int32)
    heavy = np.tile(np.array([True, False, False, True]), (P, 1))

    def shard(d, v, dst, h):
        return tuple(JR.routed_all_to_all(d, v, dst, p=P, c_out=c_out, cap_recv=cap_recv, heavy=h))

    want = jax.jit(jax.vmap(shard, axis_name=AXIS))(
        jnp.asarray(data), jnp.asarray(valid), jnp.asarray(dest), jnp.asarray(heavy)
    )
    got = TR.routed_all_to_all(
        torch.from_numpy(data), torch.from_numpy(valid), torch.from_numpy(dest),
        p=P, c_out=c_out, cap_recv=cap_recv, heavy=torch.from_numpy(heavy),
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got.heavy_sent.sum()) > 0
    # heavy=None: the plain hash exchange, heavy_sent all zero
    plain = TR.routed_all_to_all(
        torch.from_numpy(data), torch.from_numpy(valid), torch.from_numpy(dest),
        p=P, c_out=c_out, cap_recv=cap_recv,
    )
    assert int(plain.heavy_sent.abs().sum()) == 0


def test_route_policy_heavy_flags():
    counts = np.array([[18, 2, 2, 2], [18, 2, 2, 2]])
    pol = TR.RoutePolicy(skew_threshold=2.0)
    assert pol.heavy_flags(counts, P).tolist() == JS.heavy_dest_flags(counts, P, 2.0).tolist()
    many = np.zeros((2, 2, P), int)
    many[:, 0] = [20, 1, 1, 1]
    many[:, 1] = [5, 5, 5, 5]
    np.testing.assert_array_equal(
        pol.heavy_flags_many(many, P), JS.heavy_dest_flags_many(many, P, 2.0)
    )


# ------------------------------------------------ sequential operators
@pytest.mark.parametrize("seed", [5, 2**32 - 7])
def test_repartition_and_measure_exchange_match(spmds, pairs, seed):
    ref, tsp = spmds
    (a, _), (ta, _) = pairs["planted"]
    jo, js = JO.repartition(ref, a, ["B"], seed=seed, c_out=8, cap_recv=32)
    to, tst = TO.repartition(tsp, ta, ["B"], seed=seed, c_out=8, cap_recv=32)
    _same_table(to, jo)
    assert tst == js and tst["dropped"] > 0  # the planted key overflows c_out
    for dedup in (False, True):
        assert TO.measure_exchange(tsp, ta, ["B"], seed=seed, dedup=dedup) == JO.measure_exchange(
            ref, a, ["B"], seed=seed, dedup=dedup
        )


@pytest.mark.parametrize("caps", ["default", "tight"])
def test_dist_semijoin_and_intersect_match(spmds, pairs, caps):
    ref, tsp = spmds
    (a, b), (ta, tb) = pairs["planted"]
    kw = {} if caps == "default" else dict(c_out=(4, 4), cap_recv=(16, 8))
    jo, js = JO.dist_semijoin(ref, a, b, seed=7, **kw)
    to, tst = TO.dist_semijoin(tsp, ta, tb, seed=7, **kw)
    _same_table(to, jo)
    assert tst == js
    # intersect: the semijoin's output against A with its columns swapped
    a2 = DTable(jnp.asarray(np.asarray(a.data)[..., ::-1].copy()), a.valid, ("B", "A"))
    jo, js = JO.dist_intersect(ref, a, a2, seed=9, **kw)
    to, tst = TO.dist_intersect(tsp, ta, _port([a2])[0], seed=9, **kw)
    _same_table(to, jo)
    assert tst == js
    jo2, js2 = JO.dist_intersect(ref, jo, a, seed=2**32 - 1)
    to2, tst2 = TO.dist_intersect(tsp, to, ta, seed=2**32 - 1)
    _same_table(to2, jo2)
    assert tst2 == js2


# ------------------------------------------------------ hybrid measures
@pytest.mark.parametrize("name", ["planted3", "planted3_rev", "unskewed"])
@pytest.mark.parametrize("hybrid", [False, True])
def test_measure_join_many_matches(spmds, pairs, ref_join_measures, name, hybrid):
    _, (ta, tb) = pairs[name]
    tm = TB.measure_join_many(spmds[1], [ta], [tb], seeds=[11], hybrid=hybrid)
    _same_measure(tm, ref_join_measures[(name, hybrid)])


def test_measure_join_swaps_spread_to_the_heavy_side(ref_join_measures, spmds, pairs):
    """As the reference's own test: the measure spreads the side with the
    larger heavy mass, both ways, and the hybrid out_need stays at most
    the hash pile-up."""
    m_fwd = TB.measure_join_many(spmds[1], *([t] for t in pairs["planted3"][1]), seeds=[11], hybrid=True)
    m_rev = TB.measure_join_many(spmds[1], *([t] for t in pairs["planted3_rev"][1]), seeds=[11], hybrid=True)
    assert m_fwd.hybrid_routed and not m_fwd.swap_spread
    assert m_rev.hybrid_routed and m_rev.swap_spread
    assert m_fwd.lhs_heavy_rows > m_fwd.rhs_heavy_rows
    m_hash = ref_join_measures[("planted3_rev", False)]
    assert not m_hash.hybrid_routed and m_rev.out_need <= m_hash.out_need


@pytest.mark.parametrize("name", ["planted_s2", "unskewed"])
def test_measure_semijoin_many_matches(spmds, pairs, name):
    ref, tsp = spmds
    (a, b), (ta, tb) = pairs[name]
    for hybrid in (False, True):
        jm = JB.measure_semijoin_many(ref, [a], [b], seeds=[7], hybrid=hybrid)
        tm = TB.measure_semijoin_many(tsp, [ta], [tb], seeds=[7], hybrid=hybrid)
        _same_measure(tm, jm)
        assert tm.hybrid_routed == (hybrid and name != "unskewed")


# ----------------------------------------------------- hybrid operators
@pytest.mark.parametrize("name", ["planted", "unskewed"])
@pytest.mark.parametrize("out_cap", [None, 256])
def test_dist_join_hybrid_matches(spmds, pairs, name, out_cap):
    ref, tsp = spmds
    (a, b), (ta, tb) = pairs[name]
    jo, js = JO.dist_join_hybrid(ref, a, b, seed=5, out_cap=out_cap)
    to, tst = TO.dist_join_hybrid(tsp, ta, tb, seed=5, out_cap=out_cap)
    _same_table(to, jo)
    assert tst == js
    assert (tst["heavy"] > 0) == (name == "planted") and tst["dropped"] == 0
    if name == "unskewed":  # no heavy key: the hash join, tuple for tuple
        ho, hs = TO.dist_join(tsp, ta, tb, seed=5, out_cap=256)
        assert ho.to_set() == to.to_set() and hs["sent"] == tst["sent"]


def test_dist_join_hybrid_cross_join_matches(spmds):
    ref, tsp = spmds
    a = mk([[1], [2], [3]], ("A",), P, cap=2)
    b = mk([[7], [8]], ("B",), P, cap=2)
    jo, js = JO.dist_join_hybrid(ref, a, b, seed=1, out_cap=16)
    to, tst = TO.dist_join_hybrid(tsp, *_port([a, b]), seed=1, out_cap=16)
    _same_table(to, jo)
    assert tst == js and tst["heavy"] == 0


@pytest.mark.parametrize("name", ["planted_s2", "unskewed"])
@pytest.mark.parametrize("cap_recv", [None, 64])
def test_dist_semijoin_hybrid_matches(spmds, pairs, name, cap_recv):
    ref, tsp = spmds
    (a, b), (ta, tb) = pairs[name]
    jo, js = JO.dist_semijoin_hybrid(ref, a, b, seed=7, cap_recv=cap_recv)
    to, tst = TO.dist_semijoin_hybrid(tsp, ta, tb, seed=7, cap_recv=cap_recv)
    _same_table(to, jo)
    assert tst == js
    assert (tst["heavy"] > 0) == (name == "planted_s2") and tst["dropped"] == 0


def test_hybrid_many_two_instances_match(spmds, pairs):
    """A fused group of two instances with different flags and seeds:
    the combined pre-pass, the hybrid tails, the join-need pass and both
    hybrid payloads, each figure per instance."""
    ref, tsp = spmds
    (a1, b1), (ta1, tb1) = pairs["planted"]
    (a2, b2), (ta2, tb2) = pairs["planted_s2"]
    seeds = [3, 2**32 - 5]
    jspec = JB.join_pair_measure_spec(ref, [a1, a2], [b1, b2], [(1,), (1,)], [(0,), (0,)], seeds, g_a=8, g_b=8)
    tspec = TB.join_pair_measure_spec(tsp, [ta1, ta2], [tb1, tb2], [(1,), (1,)], [(0,), (0,)], seeds, g_a=8, g_b=8)
    (jm,) = JB.RoundCounts(ref, [jspec]).measures()
    (tm,) = TB.RoundCounts(tsp, [tspec], backend="torch").measures()
    _same_measure(tm, jm)
    jm = JB.hybridize_join_measure(ref, [a1, a2], [b1, b2], seeds, jm, hybrid=True)
    tm = TB.hybridize_join_measure(tsp, [ta1, ta2], [tb1, tb2], seeds, tm, hybrid=True)
    _same_measure(tm, jm)
    assert tm.hybrid_routed and tm.out_need is None
    (jm,) = JB.join_need_many(ref, [([a1, a2], [b1, b2], seeds, jm)])
    (tm,) = TB.join_need_many(tsp, [([ta1, ta2], [tb1, tb2], seeds, tm)])
    _same_measure(tm, jm)
    kw = dict(
        seeds=seeds, out_cap=tm.out_need, heavy=tm.heavy, swap=tm.swap_spread,
        c_out=(tm.lhs.c_out, tm.rhs.c_out), cap_recv=(tm.lhs.cap_recv, tm.rhs.cap_recv),
    )
    jo, js = JB.hybrid_join_many(ref, [a1, a2], [b1, b2], **kw)
    to, tst = TB.hybrid_join_many(tsp, [ta1, ta2], [tb1, tb2], backend="torch", **kw)
    for t, j in zip(to, jo):
        _same_table(t, j)
    assert tst == js and all(st["dropped"] == 0 for st in tst)
    # the flags are per instance: only the first instance's key routes heavy
    assert tst[0]["heavy"] > 0 and tst[1]["heavy"] == 0
    jm = JB.measure_semijoin_many(ref, [a1, a2], [b1, b2], seeds=seeds, hybrid=True)
    tm = TB.measure_semijoin_many(tsp, [ta1, ta2], [tb1, tb2], seeds=seeds, hybrid=True)
    _same_measure(tm, jm)
    kw = dict(
        seeds=seeds, heavy=tm.heavy,
        c_out=(tm.lhs.c_out, tm.rhs.c_out), cap_recv=(tm.lhs.cap_recv, tm.rhs.cap_recv),
    )
    jo, js = JB.hybrid_semijoin_many(ref, [a1, a2], [b1, b2], **kw)
    to, tst = TB.hybrid_semijoin_many(tsp, [ta1, ta2], [tb1, tb2], backend="torch", **kw)
    for t, j in zip(to, jo):
        _same_table(t, j)
    assert tst == js
