"""Multi-tenant join serving (``repro_torch.serve.join_server``) on the CPU.

The first twelve tests are ``tests/test_join_server.py``'s, run on the
port: served rows and ``comm_tuples`` equal standalone ``gym()`` runs, the
``ServerLedger`` is the per-tenant sum with real fusion savings, admission
is FIFO-with-aging under ``max_in_flight``, the shared ``CapsCache`` warms
across drivers without cross-contamination, interleaved drivers equal
isolated ones, and ``GymConfig`` rejects unknown registry knobs.

Then the port is held to the reference: one submission schedule through
both packages' servers must give each ticket the same rows, schema,
``RoundRecord``s and admit/finish ticks, the same merge keys tick by tick
(the backend name aside) and the same ``ServerLedger``; the merge key and
the measure merge agree on constructed inputs, packed and hybrid-routed
groups give no key; and every rider of a merged dispatch equals its solo
dispatch.  The tolerance is exact: all data is int32 or bool.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.gym import GymConfig as RGymConfig  # noqa: E402
from repro.core.physical import get_engine as r_get_engine  # noqa: E402
from repro.core.queries import chain_ghd, chain_query, star_ghd, star_query  # noqa: E402
from repro.data.synthetic import chain_data_sparse, star_data_sparse  # noqa: E402
from repro.relational import batched as RB  # noqa: E402
from repro.relational.spmd import SPMD as RSPMD  # noqa: E402
from repro.relational.table import DTable as RDTable  # noqa: E402
from repro.relational.wire import WirePolicy as RWirePolicy  # noqa: E402
from repro.serve.join_server import JoinServer as RJoinServer  # noqa: E402
from test_torch_gym import to_port_query  # noqa: E402

from repro_torch.core.caps_cache import CapsCache  # noqa: E402
from repro_torch.core.gym import GymConfig, GymDriver, gym  # noqa: E402
from repro_torch.core.physical import dispatch_merged, dispatch_work, get_engine  # noqa: E402
from repro_torch.interop import ghd_from_dict, wire_policy_from_tuple  # noqa: E402
from repro_torch.relational import batched as TB  # noqa: E402
from repro_torch.relational.batched import GroupMeasure, SideCaps  # noqa: E402
from repro_torch.relational.spmd import SPMD  # noqa: E402
from repro_torch.relational.table import DTable  # noqa: E402
from repro_torch.serve import JoinServer  # noqa: E402

P = 4


def _ref_star():
    return star_query(4), star_ghd(4), star_data_sparse(
        4, domain=32, hub_rows=64, spoke_extra=16, seed=7)


def _ref_chain():
    return chain_query(4), chain_ghd(4), chain_data_sparse(
        4, domain=64, ident=16, extra=48, seed=9)


def _port(case):
    q, g, data = case
    return to_port_query(q), ghd_from_dict(g.to_dict()), data


def star_case():
    return _port(_ref_star())


def chain_case():
    return _port(_ref_chain())


def cpu():
    return SPMD(P, device="cpu")


def rowset(rows) -> set:
    return {tuple(r) for r in np.asarray(rows)}


def standalone(q, g, data, seed=3):
    return gym(q, data, ghd=g, p=P, config=GymConfig(seed=seed), device="cpu")


# ------------------------------------------------------------- parity
def test_served_queries_bit_identical_to_standalone():
    sq, sg, sdata = star_case()
    cq, cg, cdata = chain_case()
    srv = JoinServer(cpu(), max_in_flight=4)
    t1 = srv.submit("alice", sq, sg, sdata, GymConfig(seed=3))
    t2 = srv.submit("bob", sq, sg, sdata, GymConfig(seed=3))
    t3 = srv.submit("carol", cq, cg, cdata, GymConfig(seed=3))
    led = srv.drain()
    assert t1.done and t2.done and t3.done

    rs, _, ls = standalone(sq, sg, sdata)
    rc, _, lc = standalone(cq, cg, cdata)
    assert rowset(t1.rows()) == rowset(rs)
    assert rowset(t2.rows()) == rowset(rs)
    assert rowset(t3.rows()) == rowset(rc)
    assert t1.ledger.comm_tuples == ls.comm_tuples
    assert t2.ledger.comm_tuples == ls.comm_tuples
    assert t3.ledger.comm_tuples == lc.comm_tuples
    assert led.retries == 0

    # cross-request fusion actually happened on the homogeneous pair
    assert led.fused_dispatches > 0
    assert led.fused_riders > led.fused_dispatches
    assert led.dispatches_saved > 0


def test_server_aggregate_is_tenant_sum():
    sq, sg, sdata = star_case()
    cq, cg, cdata = chain_case()
    srv = JoinServer(cpu(), max_in_flight=3)
    srv.submit("a", sq, sg, sdata, GymConfig(seed=1))
    srv.submit("a", cq, cg, cdata, GymConfig(seed=1))
    srv.submit("b", sq, sg, sdata, GymConfig(seed=1))
    led = srv.drain()
    tenants = [lg for leds in led.tenants.values() for lg in leds]
    assert led.queries == 3 and len(tenants) == 3
    assert led.comm_tuples == sum(lg.comm_tuples for lg in tenants)
    assert led.padded_slots == sum(lg.padded_slots for lg in tenants)
    assert led.payload_bytes == sum(lg.payload_bytes for lg in tenants)
    assert led.measured_dispatches == sum(lg.measured_dispatches for lg in tenants)
    ts = led.tenant_summary("a")
    assert ts["queries"] == 2
    s = led.summary()
    assert s["queries"] == 3 and set(s["tenants"]) == {"a", "b"}


# -------------------------------------------------- admission control
def test_max_in_flight_and_fifo_admission():
    sq, sg, sdata = star_case()
    srv = JoinServer(cpu(), max_in_flight=1)
    ts = [srv.submit(f"t{i}", sq, sg, sdata, GymConfig(seed=3)) for i in range(3)]
    while srv.step():
        assert srv.in_flight <= 1
    # equal priorities: admitted (and finished) in arrival order
    admits = [t.admit_tick for t in ts]
    assert admits == sorted(admits) and len(set(admits)) == 3
    finishes = [t.finish_tick for t in ts]
    assert finishes == sorted(finishes) and len(set(finishes)) == 3
    for t in ts:
        assert t.latency_ticks >= t.wait_ticks >= 0


def test_priority_and_aging():
    sq, sg, sdata = star_case()
    # urgent (lower value) newcomer beats a same-tick normal submission
    srv = JoinServer(cpu(), max_in_flight=1, aging=1.0)
    normal = srv.submit("n", sq, sg, sdata, GymConfig(seed=3))
    urgent = srv.submit("u", sq, sg, sdata, GymConfig(seed=3), priority=-5.0)
    srv.drain()
    assert urgent.admit_tick < normal.admit_tick

    # aging: a low-priority ticket that has waited long enough outranks a
    # fresh normal arrival — effective = priority - aging * wait_ticks
    srv2 = JoinServer(cpu(), max_in_flight=1, aging=1.0)
    straggler = srv2.submit("s", sq, sg, sdata, GymConfig(seed=3), priority=10.0)
    srv2.tick += 20  # the straggler has now waited 20 ticks
    fresh = srv2.submit("f", sq, sg, sdata, GymConfig(seed=3), priority=0.0)
    srv2.drain()
    assert straggler.admit_tick < fresh.admit_tick


def test_pending_groups_exposes_mergeable_buckets():
    sq, sg, sdata = star_case()
    srv = JoinServer(cpu(), max_in_flight=2)
    srv.submit("a", sq, sg, sdata, GymConfig(seed=3))
    srv.submit("b", sq, sg, sdata, GymConfig(seed=3))
    # step past materialization until both tickets suspend on round work
    for _ in range(20):
        if any(len(ws) > 1 for ws in srv.pending_groups().values()):
            break
        if not srv.step():
            break
    buckets = srv.pending_groups()
    assert any(
        key is not None and len(ws) > 1 for key, ws in buckets.items()
    ), "identical concurrent queries must expose a >1-rider merge bucket"
    srv.drain()


# ------------------------------------------------- shared caps cache
def test_shared_cache_warms_across_drivers():
    sq, sg, sdata = star_case()
    spmd = cpu()
    shared = CapsCache()
    d1 = GymDriver(sq, sg, sdata, spmd, GymConfig(seed=3), caps_cache=shared)
    d1.run()
    h1 = shared.hits
    d2 = GymDriver(sq, sg, sdata, spmd, GymConfig(seed=3), caps_cache=shared)
    out2 = d2.run()
    assert d1.executor.caps_cache is shared and d2.executor.caps_cache is shared
    # the second driver hits signatures the first confirmed
    assert shared.hits > h1
    # ... and computes exactly the standalone result
    solo = GymDriver(sq, sg, sdata, spmd, GymConfig(seed=3))
    out_solo = solo.run()
    assert rowset(out2.to_numpy()) == rowset(out_solo.to_numpy())
    assert d2.ledger.comm_tuples == solo.ledger.comm_tuples


def test_shared_cache_no_cross_contamination():
    sq, sg, sdata = star_case()
    cq, cg, cdata = chain_case()
    spmd = cpu()
    shared = CapsCache()
    ds = GymDriver(sq, sg, sdata, spmd, GymConfig(seed=3), caps_cache=shared)
    out_s = ds.run()
    dc = GymDriver(cq, cg, cdata, spmd, GymConfig(seed=3), caps_cache=shared)
    out_c = dc.run()
    solo_s = GymDriver(sq, sg, sdata, spmd, GymConfig(seed=3))
    solo_c = GymDriver(cq, cg, cdata, spmd, GymConfig(seed=3))
    assert rowset(out_s.to_numpy()) == rowset(solo_s.run().to_numpy())
    assert rowset(out_c.to_numpy()) == rowset(solo_c.run().to_numpy())
    assert ds.ledger.comm_tuples == solo_s.ledger.comm_tuples
    assert dc.ledger.comm_tuples == solo_c.ledger.comm_tuples
    assert ds.ledger.retries == 0 and dc.ledger.retries == 0


def test_interleaved_steps_bit_identical_to_isolated():
    sq, sg, sdata = star_case()
    cq, cg, cdata = chain_case()
    spmd = cpu()
    shared = CapsCache()
    a = GymDriver(sq, sg, sdata, spmd, GymConfig(seed=3), caps_cache=shared)
    b = GymDriver(cq, cg, cdata, spmd, GymConfig(seed=3), caps_cache=shared)
    more_a, more_b = True, True
    while more_a or more_b:  # strict alternation
        if more_a:
            more_a = a.step()
        if more_b:
            more_b = b.step()
    iso_a = GymDriver(sq, sg, sdata, spmd, GymConfig(seed=3))
    iso_b = GymDriver(cq, cg, cdata, spmd, GymConfig(seed=3))
    ra, rb = iso_a.run(), iso_b.run()
    assert rowset(a.result.to_numpy()) == rowset(ra.to_numpy())
    assert rowset(b.result.to_numpy()) == rowset(rb.to_numpy())
    assert a.ledger.comm_tuples == iso_a.ledger.comm_tuples
    assert b.ledger.comm_tuples == iso_b.ledger.comm_tuples


def test_caps_cache_merge_load_keeps_live_entries():
    c1 = CapsCache()

    def gm(c_out, cap_recv):
        return GroupMeasure(lhs=SideCaps(c_out, cap_recv))

    c1.store(("shared-sig",), gm(8, 16))
    c1.store(("shared-sig",), gm(8, 16))  # confirm
    snap = CapsCache()
    snap.store(("shared-sig",), gm(2, 2))
    snap.store(("other-sig",), gm(4, 4))
    # merge: the live confirmed entry survives, fresh signatures load
    c1.load_json(snap.to_json(), merge=True)
    assert c1.entry(("shared-sig",)).lhs == (8, 16)
    assert c1.entry(("other-sig",)) is not None
    # replace (default): the snapshot wins wholesale
    c1.load_json(snap.to_json())
    assert c1.entry(("shared-sig",)).lhs == (2, 2)


# ------------------------------------------------- config validation
def test_gymconfig_rejects_unknown_strategy():
    with pytest.raises(ValueError, match=r"unknown strategy.*'grid'"):
        GymConfig(strategy="quantum")


def test_gymconfig_rejects_unknown_wire_format():
    with pytest.raises(ValueError, match=r"unknown wire_format.*dense"):
        GymConfig(wire_format="zipped")


def test_gymconfig_rejects_unknown_local_backend():
    with pytest.raises(ValueError, match=r"unknown local_backend.*'torch'"):
        GymConfig(local_backend="jnp")


# ---------------------------------------------- against the reference
# (tenant, case, seed, priority) at max_in_flight=2: the urgent star jumps
# the queue and fuses with the first star; the second star and the chain
# follow
SCHEDULE = [("alice", "star", 3, 0.0), ("bob", "star", 3, 0.0),
            ("carol", "chain", 3, 0.0), ("dave", "star", 3, -1.0)]


def _serve(server_cls, spmd, cfg_cls, cases):
    """Drain SCHEDULE; returns the tickets and, per tick, each active
    ticket's pending merge keys (as text) before the tick runs."""
    srv = server_cls(spmd, max_in_flight=2)
    tickets = [srv.submit(t, *cases[c], cfg_cls(seed=s), priority=pr)
               for t, c, s, pr in SCHEDULE]
    keys = []
    while True:
        keys.append([[repr(w.merge_key) for w in t.works] for t in srv._active])
        if not srv.step():
            break
    return srv, tickets, keys


@pytest.fixture(scope="module")
def served():
    ref = _serve(RJoinServer, RSPMD(P), RGymConfig,
                 {"star": _ref_star(), "chain": _ref_chain()})
    port = _serve(JoinServer, cpu(), GymConfig, {"star": star_case(), "chain": chain_case()})
    return ref, port


def test_served_schedule_matches_reference(served):
    (rsrv, rts, _), (tsrv, tts, _) = served
    for rt, tt in zip(rts, tts):
        assert rt.done and tt.done
        assert tuple(tt.result.schema) == tuple(rt.result.schema)
        np.testing.assert_array_equal(tt.rows(), np.asarray(rt.rows()))
        assert [dataclasses.asdict(r) for r in tt.ledger.records] == [
            dataclasses.asdict(r) for r in rt.ledger.records
        ]
        assert (tt.ledger.retries, tt.ledger.output_tuples) == (
            rt.ledger.retries, rt.ledger.output_tuples)
        assert (tt.submit_tick, tt.admit_tick, tt.finish_tick) == (
            rt.submit_tick, rt.admit_tick, rt.finish_tick)
    assert [t.tenant for t in tsrv.completed] == [t.tenant for t in rsrv.completed]
    assert tsrv.ledger.fused_dispatches == rsrv.ledger.fused_dispatches > 0
    assert tsrv.ledger.fused_riders == rsrv.ledger.fused_riders
    assert tsrv.ledger.summary() == rsrv.ledger.summary()
    assert repr(tsrv.ledger) == repr(rsrv.ledger)


def test_merge_keys_match_reference(served):
    """Tick by tick, every pending group's merge key equals the
    reference's but for the backend name (so the server's ``repr`` order
    of buckets is the same too)."""
    (_, _, rkeys), (_, _, tkeys) = served
    want = [[[k.replace("'jnp'", "'torch'") for k in ks] for ks in tick] for tick in rkeys]
    assert tkeys == want
    assert any(k != "None" for tick in tkeys for ks in tick for k in ks)


def _key_inputs(port: bool, **kw):
    """A hash engine and one semijoin instance, S(A, B) against R(B, C),
    in the port (``port``) or the reference."""
    s_rows = np.array([[1, 2], [3, 4], [5, 6]], np.int32)
    r_rows = np.array([[2, 7], [4, 8]], np.int32)
    if port:
        eng = get_engine("hash", cpu(), local_backend="torch", **kw)
        scatter = lambda rows, sch, cap: DTable.scatter_numpy(  # noqa: E731
            rows, sch, P, cap=cap, device="cpu")
    else:
        eng = r_get_engine("hash", RSPMD(P), local_backend="jnp", **kw)
        scatter = lambda rows, sch, cap: RDTable.scatter_numpy(rows, sch, P, cap=cap)  # noqa: E731
    return eng, [scatter(s_rows, ("A", "B"), 4)], [scatter(r_rows, ("B", "C"), 2)]


def test_cross_request_key_matches_reference():
    reng, rl, rr = _key_inputs(False)
    teng, tl, tr = _key_inputs(True)
    for measured in (False, True):
        rm = RB.GroupMeasure(lhs=RB.SideCaps(2, 4), rhs=RB.SideCaps(1, 2), out_recv=4,
                             padded=9) if measured else None
        tm = GroupMeasure(lhs=SideCaps(2, 4), rhs=SideCaps(1, 2), out_recv=4,
                          padded=9) if measured else None
        rk = RB.cross_request_key("semijoin", reng, 8, rl, rr, rm)
        tk = TB.cross_request_key("semijoin", teng, 8, tl, tr, tm)
        assert rk[1] == "jnp" and tk[1] == "torch"
        assert repr(tk) == repr(rk).replace("'jnp'", "'torch'")
        assert tk[0] == "hash" and tk[-1] == 1  # one shared key column
    # packed wire formats are per query, hybrid-routed payloads carry
    # per-instance heavy flags: both dispatch solo (no key)
    pol = (("A", 3), ("B", 4), ("C", 4))
    rpk, _, _ = _key_inputs(False, wire_policy=RWirePolicy(pol))
    tpk, _, _ = _key_inputs(True, wire_policy=wire_policy_from_tuple(pol))
    assert RB.cross_request_key("semijoin", rpk, 8, rl, rr, None) is None
    assert TB.cross_request_key("semijoin", tpk, 8, tl, tr, None) is None
    hy = GroupMeasure(lhs=SideCaps(2, 4), rhs=SideCaps(1, 2), hybrid_routed=True)
    rhy = RB.GroupMeasure(lhs=RB.SideCaps(2, 4), rhs=RB.SideCaps(1, 2), hybrid_routed=True)
    assert TB.cross_request_key("semijoin", teng, 8, tl, tr, hy) is None
    assert RB.cross_request_key("semijoin", reng, 8, rl, rr, rhy) is None


def test_merge_measures_matches_reference():
    def ms(mod):
        return [
            mod.GroupMeasure(lhs=mod.SideCaps(2, 16), rhs=mod.SideCaps(8, 4), out_recv=16,
                             padded=5, wire_bytes=40),
            mod.GroupMeasure(lhs=mod.SideCaps(4, 8), rhs=mod.SideCaps(1, 32), out_recv=8,
                             out_need=64, padded=7, wire_bytes=56),
        ]

    got, want = TB.merge_measures(ms(TB)), RB.merge_measures(ms(RB))
    assert repr(got) == repr(want)
    assert got.lhs == SideCaps(4, 16) and got.rhs == SideCaps(8, 32)
    assert (got.out_recv, got.out_need, got.padded, got.wire_bytes) == (16, 64, 0, 0)
    one = ms(TB)[:1]
    assert TB.merge_measures(one) is one[0]
    assert TB.merge_measures([None, ms(TB)[0]]) is None
    assert RB.merge_measures([None, ms(RB)[0]]) is None
    with pytest.raises(AssertionError, match="hybrid"):
        TB.merge_measures([dataclasses.replace(ms(TB)[0], hybrid_routed=True)] * 2)


def test_dispatch_merged_equals_solo_dispatches():
    """Before every tick, each multi-rider bucket runs once merged and once
    per rider solo: each rider's outputs and stats must be equal, and the
    merged dispatch's deltas go to its first rider."""
    sq, sg, sdata = star_case()
    cq, cg, cdata = chain_case()
    srv = JoinServer(cpu(), max_in_flight=3)
    srv.submit("a", sq, sg, sdata, GymConfig(seed=3))
    srv.submit("b", sq, sg, sdata, GymConfig(seed=3))
    srv.submit("c", cq, cg, cdata, GymConfig(seed=3))
    compared = 0
    kinds = set()
    while True:
        for key, ws in srv.pending_groups().items():
            if key is None or len(ws) < 2:
                continue
            merged = dispatch_merged(ws)
            solo = [dispatch_work(w) for w in ws]
            assert [m.dispatches for m in merged] == [1] + [0] * (len(ws) - 1)
            for w, m, s in zip(ws, merged, solo):
                assert len(m.outs) == len(w.ops) and m.rounds == s.rounds
                assert m.stats == s.stats  # equal keys: equal measured caps
                for a, b in zip(m.outs, s.outs):
                    assert a.schema == b.schema
                    assert torch.equal(a.data, b.data) and torch.equal(a.valid, b.valid)
            compared += 1
            kinds.add(ws[0].kind)
        if not srv.step():
            break
    assert {"semijoin", "join", "intersect"} <= kinds
    assert srv.ledger.retries == 0
