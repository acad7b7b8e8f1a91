"""The cost-based plan advisor (``core/costs.py``, ``core/optimizer.py``,
``GymConfig(plan="auto")``) in the port against the JAX reference.

The advisor is pure Python and numpy on both sides; the port keeps its
own copy.  The same queries, GHDs and data (made from a seed) go through
both packages, and the candidate plans must be equal key for key, in
order, in every predicted field (exactly: the ranking breaks ties on
these floats), with ``explain()``'s text equal too.  A plan's
``local_backend`` is the one field that differs by design: the
reference's ``'jnp'`` against the port's None, the executing device's
default.  End to end, ``gym(plan=<Plan>)`` must equal the reference in
rows and ledger; ``gym(plan="auto")`` is held against the reference in
``test_torch_gym_auto*.py``.

Cases: ``tests/test_optimizer.py``'s S_8 and TC_9 and
``tests/test_skew_hybrid.py``'s skewed and uniform stars.  The
reference's snapshot tests of a chosen plan and of the packed wire
(``test_chosen_plan_round_trips_snapshot_resume``,
``test_snapshot_roundtrips_wire_format``) are held against the port in
``tests/test_torch_snapshot_packed_auto.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import costs as RC  # noqa: E402
from repro.core import optimizer as RO  # noqa: E402
from repro.core.gym import GymConfig, GymDriver  # noqa: E402
from repro.core.queries import star_ghd, star_query  # noqa: E402
from repro.data.synthetic import star_data_heavy, star_data_sparse  # noqa: E402
from repro.relational.spmd import SPMD  # noqa: E402
from test_optimizer import _cases  # noqa: E402
from test_torch_gym import to_port_query  # noqa: E402

from repro_torch.core import costs as TC  # noqa: E402
from repro_torch.core import optimizer as TO  # noqa: E402
from repro_torch.core.gym import GymConfig as TGymConfig  # noqa: E402
from repro_torch.core.gym import GymDriver as TGymDriver  # noqa: E402
from repro_torch.core.gym import gym as tgym  # noqa: E402
from repro_torch.interop import ghd_from_dict, plan_from_fields  # noqa: E402
from repro_torch.relational.spmd import SPMD as TSPMD  # noqa: E402


def _skew_cases():
    q, g = star_query(8), star_ghd(8)
    return [
        ("skewed", q, g, star_data_heavy(8, hub_rows=64, heavy_share=0.8, seed=5)),
        ("uniform", q, g, star_data_sparse(8, seed=21)),
    ]


CASES = {name: (q, g, d) for name, q, g, d in _cases() + _skew_cases()}


def _plan_fields(plan):
    d = {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}
    d.pop("local_backend")
    d["ghd"] = plan.ghd.to_dict()
    return d


def _both(name, fn, **kw):
    """fn over (reference module, port module) with each package's query,
    hand GHD and statistics."""
    q, g, data = CASES[name]
    ref = fn(RO, q, RO.stats_from_data(q, data), hand_ghd=g, **kw)
    tq = to_port_query(q)
    port = fn(TO, tq, TO.stats_from_data(tq, data), hand_ghd=ghd_from_dict(g.to_dict()), **kw)
    return ref, port


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("variant", ["plain", "skew", "calibrate_options", "packed_gain"])
def test_enumerate_plans_match_reference(name, variant):
    q, g, data = CASES[name]
    kw = dict(profile=None)
    if variant != "plain":
        kw["skew"] = RO.skew_from_data(q, data)
    if variant in ("calibrate_options", "packed_gain"):
        kw.update(calibrate_options=(True, False))
    if variant == "packed_gain":
        kw["wire_gain"] = 3.37

    def go(mod, query, stats, **k):
        prof = mod.MachineProfile(p=8, dispatch_overhead=RC.DEFAULT_DISPATCH_OVERHEAD_SLOTS
                                  if variant != "plain" else 0.0)
        return mod.enumerate_plans(query, stats, **{**k, "profile": prof})

    ref, port = _both(name, go, **kw)
    assert [p.key for p in port] == [p.key for p in ref]
    for rp, tp in zip(ref, port):
        assert _plan_fields(tp) == _plan_fields(rp), rp.key
        assert tp.local_backend is None and rp.local_backend == "jnp"


@pytest.mark.parametrize("name", sorted(CASES))
def test_explain_text_matches_reference(name):
    for fmt in ("text", "markdown"):
        ref, port = _both(name, lambda m, q, s, **k: m.explain(q, s, p=8, fmt=fmt, **k))
        assert port == ref
    ref, port = _both(name, lambda m, q, s, **k: m.explain(
        q, s, p=4, measured={m.choose_plan(q, s, profile=m.MachineProfile(p=4),
                                           hand_ghd=k["hand_ghd"]).key: 1234}, **k))
    assert port == ref and "meas_comm" in port


@pytest.mark.parametrize("name", sorted(CASES))
def test_candidate_ghds_and_statistics_match_reference(name):
    q, g, data = CASES[name]
    tq = to_port_query(q)
    ref = RO.candidate_ghds(q, hand_ghd=g)
    port = TO.candidate_ghds(tq, hand_ghd=ghd_from_dict(g.to_dict()))
    assert [(s, x.to_dict()) for s, x in port] == [(s, x.to_dict()) for s, x in ref]
    assert TO.stats_from_data(tq, data) == RO.stats_from_data(q, data)
    assert TO.skew_from_data(tq, data) == RO.skew_from_data(q, data)
    for a in q.atoms:
        assert TO.skew_share(data[a.rel]) == RO.skew_share(data[a.rel])


def test_choose_plan_picks_hybrid_on_skew_hash_on_uniform():
    for name, want in (("skewed", "hybrid"), ("uniform", "hash")):
        q, _, data = CASES[name]
        ref, port = _both(name, lambda m, q_, s, **k: m.choose_plan(
            q_, s, profile=m.MachineProfile(p=8), skew=m.skew_from_data(q_, data), **k))
        assert port.engine == ref.engine == want
        assert port.key == ref.key


def test_cost_model_and_calibration_match_reference():
    recs = [
        {"engine": "hash", "predicted_comm": 100.0, "measured_comm": 200.0},
        {"engine": "hash", "predicted_comm": 100.0, "measured_comm": 800.0},
        {"engine": "grid", "predicted_comm": 50.0, "measured_comm": 25.0},
        {"engine": "hybrid", "predicted_comm": 70.0, "measured_comm": 91.0},
        {"engine": "hash", "predicted_comm": 0.0, "measured_comm": 10.0},  # skipped
    ]
    rc, tc = RC.fit_calibration(recs), TC.fit_calibration(recs)
    assert tc.to_dict() == rc.to_dict() and tc.samples == rc.samples == 4
    assert TC.CostCalibration.from_dict(rc.to_dict()).to_dict() == rc.to_dict()
    for e in ("hash", "grid", "hybrid", "unknown"):
        assert tc.comm_factor(e) == rc.comm_factor(e)
        assert tc.apply(e, 10.0) == rc.apply(e, 10.0)
    assert TC.DEFAULT_DISPATCH_OVERHEAD_SLOTS == RC.DEFAULT_DISPATCH_OVERHEAD_SLOTS
    for p in (1, 4, 8, 31):
        for cal in (True, False):
            for gain in (1.0, 2.5, 7.0):
                assert TC.shuffle_pad_factor(p, cal, wire_gain=gain) == \
                    RC.shuffle_pad_factor(p, cal, wire_gain=gain)
        for share in (0.0, 0.05, 0.3, 0.8, 1.0):
            for th in (None, 1.5, 6.0):
                assert TC.skew_amplification(p, share, th) == RC.skew_amplification(p, share, th)
        for engine in ("hash", "grid", "hybrid"):
            for kind in ("semijoin", "join", "intersect"):
                args = (engine, kind, 10.0, 20.0, p, 0.1, 0.6)
                assert TC.engine_op_comm(*args) == RC.engine_op_comm(*args)
    assert TC.prediction_error(5.0, 7.0) == RC.prediction_error(5.0, 7.0)


def test_plan_to_config_keeps_the_device_default():
    name = "uniform"
    q, g, data = CASES[name]
    tq = to_port_query(q)
    plan = TO.choose_plan(tq, TO.stats_from_data(tq, data), profile=TO.MachineProfile(p=4),
                          hand_ghd=ghd_from_dict(g.to_dict()))
    cfg = plan.to_config(TGymConfig(seed=9, max_retries=7))
    assert (cfg.strategy, cfg.schedule, cfg.fused, cfg.plan) == (
        plan.engine, plan.schedule, plan.fused, plan.key)
    assert cfg.local_backend is None and cfg.seed == 9 and cfg.max_retries == 7
    pinned = dataclasses.replace(plan, local_backend="torch").to_config(TGymConfig())
    assert pinned.local_backend == "torch"


# ------------------------------------------------------------ end to end
def _ref_drive(q, g, data, p, given=None, **cfg):
    drv = GymDriver(q, g, data, SPMD(p), GymConfig(**cfg), plan=given)
    out = drv.run()
    return drv, (out.to_numpy(), out.schema, drv.ledger)


def _port_drive(q, g, data, p, given=None, **cfg):
    drv = TGymDriver(to_port_query(q), ghd_from_dict(g.to_dict()), data,
                     TSPMD(p, device="cpu"), TGymConfig(**cfg), plan=given)
    out = drv.run()
    return drv, (out.to_numpy(), out.schema, drv.ledger)


def _same(port, ref):
    from test_torch_gym_hybrid import assert_same_run

    assert_same_run(port, ref)


def test_explicit_plan_gym_matches_reference():
    """``gym(plan=<Plan>)``: the reference's second-ranked plan, carried
    across as plain fields, runs in the port as it runs in the reference."""
    q, g, data = CASES["uniform"]
    plans = RO.enumerate_plans(q, RO.stats_from_data(q, data), profile=RO.MachineProfile(p=4),
                               hand_ghd=g)
    rplan = next(p for p in plans[1:] if p.engine != plans[0].engine)
    tplan = plan_from_fields(
        {k: v for k, v in _plan_fields(rplan).items() if k != "ghd"}, rplan.ghd.to_dict()
    )
    assert _plan_fields(tplan) == _plan_fields(rplan)
    _, ref = _ref_drive(q, g, data, 4, given=rplan, seed=5)
    _, port = _port_drive(q, g, data, 4, given=tplan, seed=5)
    _same(port, ref)
    rows, schema, led = tgym(to_port_query(q), data, p=4, plan=tplan,
                             config=TGymConfig(seed=5), device="cpu")
    np.testing.assert_array_equal(rows, port[0])
    assert led.comm_tuples == port[2].comm_tuples
