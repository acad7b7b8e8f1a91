"""The resumable driver (``GymDriver.save`` / ``load`` / ``step_gen``) in
the port against the JAX reference.

Each case is one of the reference's snapshot tests: the same query, GHD,
data (made from a seed) and config run a few rounds in each package, the
driver snapshots, and a fresh driver — built with the case's resuming
config, which the snapshot's must override — loads it and finishes.  The
port's resumed driver must equal the reference's resumed driver exactly:
rows (order included), schema, every ``RoundRecord``, retries, output
tuples, capacities, the restored config (the backend name aside: the
reference pins ``'jnp'`` or ``'pallas'``, the port None or ``'torch'``)
and the caps cache's JSON.  A resumed run re-measures where the
uninterrupted one used a prefetch, so the resumed ledger is held to the
reference's resumed ledger, and only its rows to the uninterrupted run.

The reference's own snapshot is also converted with
``interop.snapshot_from_reference`` and resumed in the port: the file
layout is the same, so it must finish to the reference's resumed rows and
records.  The reference's runs are shared through a module-scoped
fixture (one compile cache); ``test_torch_snapshot_hybrid.py`` and
``test_torch_snapshot_packed_auto.py`` hold the other cases.
"""
from __future__ import annotations

import dataclasses
import json
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.decompose import ghd_for  # noqa: E402
from repro.core.gym import GymConfig, GymDriver  # noqa: E402
from repro.core.queries import (  # noqa: E402
    chain_query,
    star_ghd,
    star_query,
    triangle_chain_ghd,
    triangle_chain_query,
)
from repro.data.synthetic import star_data_sparse, tc_data_sparse  # noqa: E402
from repro.relational.spmd import SPMD  # noqa: E402
from test_gym_engine import rand_data  # noqa: E402
from test_skew_hybrid import _planted_star  # noqa: E402
from test_torch_gym import to_port_query  # noqa: E402
from test_wire_format import CASES as WIRE_CASES  # noqa: E402

from repro_torch.core.caps_cache import CapsCache as TCapsCache  # noqa: E402
from repro_torch.core.gym import GymConfig as TGymConfig  # noqa: E402
from repro_torch.core.gym import GymDriver as TGymDriver  # noqa: E402
from repro_torch.core.physical import dispatch_work  # noqa: E402
from repro_torch.interop import ghd_from_dict, snapshot_from_reference  # noqa: E402
from repro_torch.relational.spmd import SPMD as TSPMD  # noqa: E402

P = 4


def _small_chain(n: int, seed: int, rows: int, hi: int):
    """``tests/test_local_backend.py``'s chain data: ``rows`` random links
    over [0, hi] per relation."""
    rng = random.Random(seed)
    return {
        f"R{i}": np.asarray(
            [[rng.randint(0, hi), rng.randint(0, hi)] for _ in range(rows)], np.int32
        )
        for i in range(1, n + 1)
    }


def _case(name):
    """(query, ghd, data, config, steps before the snapshot, resuming
    config fields, reference backend) of each reference snapshot test."""
    if name == "driver":  # test_gym_engine.py::test_driver_snapshot_resume
        q = chain_query(5)
        return q, ghd_for(q), rand_data(q, random.Random(42)), dict(seed=1), 2, dict(seed=1), None
    if name == "caps_cache":  # test_caps_cache.py::test_snapshot_resume_keeps_cache_warm
        return (star_query(4), star_ghd(4), star_data_sparse(4, seed=7), dict(seed=11), 2,
                dict(seed=11), None)
    if name == "hybrid":  # test_skew_hybrid.py::test_hybrid_snapshot_resume_replays_heavy_decision
        q, g, data = _planted_star()
        return q, g, data, dict(strategy="hybrid", seed=3, skew_threshold=3.0), 2, dict(seed=3), None
    if name == "wire":  # test_wire_format.py::test_snapshot_roundtrips_wire_format
        q, g, data = WIRE_CASES["chain"]()
        cfg = dict(strategy="hash", seed=3, calibrate_shuffle=True, wire_format="packed")
        return q, g, data, cfg, 1, dict(cfg, wire_format="dense"), None
    if name == "plan_star":  # test_optimizer.py::test_chosen_plan_round_trips_snapshot_resume
        return (star_query(8), star_ghd(8), star_data_sparse(8, seed=21),
                dict(plan="auto", seed=2), 2, dict(plan="auto", seed=2), None)
    if name == "plan_tc":  # test_optimizer.py::test_snapshot_replays_plan_ghd_on_plain_driver
        return (triangle_chain_query(3), triangle_chain_ghd(3), tc_data_sparse(3, seed=22),
                dict(plan="auto", seed=3), 2, dict(seed=3), None)
    if name == "backend":  # test_local_backend.py::test_snapshot_roundtrips_local_backend
        q = chain_query(4)
        return q, ghd_for(q), _small_chain(4, 42, 10, 5), dict(seed=1), 2, dict(seed=1), "pallas"
    if name == "completed":  # test_local_backend.py::test_post_completion_snapshot_resume
        q = chain_query(3)
        return q, ghd_for(q), _small_chain(3, 7, 8, 4), dict(seed=1), None, dict(seed=1), None
    raise KeyError(name)


def _drive(drv, steps):
    """``steps`` rounds, or the whole query when None."""
    if steps is None:
        drv.run()
    else:
        for _ in range(steps):
            drv.step()


def _cache_json(drv):
    """The driver's caps cache as JSON text (None for an uncalibrated plan)."""
    cc = drv.executor.caps_cache
    return json.dumps(cc.to_json()) if cc is not None else None


def _state(drv):
    """What a resumed driver must agree on across packages."""
    out = drv.run()
    cfg = dataclasses.asdict(drv.config)
    cfg.pop("local_backend")
    cfg.pop("device", None)
    return dict(
        rows=np.asarray(out.to_numpy()), schema=tuple(out.schema),
        records=[dataclasses.asdict(r) for r in drv.ledger.records],
        retries=drv.ledger.retries, output_tuples=drv.ledger.output_tuples,
        caps=dict(drv.caps), config=cfg, ghd=drv.ghd.to_dict(),
        caps_cache=_cache_json(drv),
    )


def _assert_same(port, ref, what):
    assert port["schema"] == ref["schema"], what
    assert port["rows"].dtype == ref["rows"].dtype, what
    np.testing.assert_array_equal(port["rows"], ref["rows"], err_msg=what)
    for k in ("records", "retries", "output_tuples", "caps", "config", "ghd", "caps_cache"):
        assert port[k] == ref[k], (what, k)


_REF_SPMD = SPMD(P)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's resumed run of each case, computed once: its state,
    its snapshot's path, and the uninterrupted run's rows."""
    cache = {}

    def get(name):
        if name not in cache:
            q, g, data, cfg, steps, resume_cfg, be = _case(name)
            kw = {} if be is None else {"local_backend": be}
            drv = GymDriver(q, g, data, _REF_SPMD, GymConfig(**cfg, **kw))
            _drive(drv, steps)
            snap = str(tmp_path_factory.mktemp("ref") / f"{name}.npz")
            drv.save(snap)
            saved_cc = _cache_json(drv)
            full = np.asarray(drv.run().to_numpy())
            drv2 = GymDriver(q, g, data, _REF_SPMD, GymConfig(**resume_cfg))
            drv2.load(snap)
            if be is not None:
                assert drv2.config.local_backend == be
            loaded_cc = _cache_json(drv2)
            cache[name] = dict(state=_state(drv2), snap=snap, full=full,
                               saved_cc=saved_cc, loaded_cc=loaded_cc)
        return cache[name]

    return get


def _port_driver(name, cfg, caps_cache=None):
    q, g, data, *_ = _case(name)
    return TGymDriver(to_port_query(q), ghd_from_dict(g.to_dict()), data,
                      TSPMD(P, device="cpu"), TGymConfig(**cfg), caps_cache=caps_cache)


def check_resume(name, reference, tmp_path):
    """Snapshot the port mid-query, resume in a fresh driver built with the
    case's resuming config, and hold it to the reference's resumed run."""
    ref = reference(name)
    _, _, _, cfg, steps, resume_cfg, be = _case(name)
    kw = {} if be is None else {"local_backend": "torch"}
    drv = _port_driver(name, dict(cfg, **kw))
    _drive(drv, steps)
    snap = str(tmp_path / "port.npz")
    drv.save(snap)
    assert _cache_json(drv) == ref["saved_cc"]
    np.testing.assert_array_equal(drv.run().to_numpy(), ref["full"])
    drv2 = _port_driver(name, resume_cfg)
    drv2.load(snap)
    # the snapshot's config wins, and the cache comes back warm
    assert _cache_json(drv2) == ref["loaded_cc"]
    assert drv2.executor._pending is None
    if be is not None:
        assert drv2.config.local_backend == "torch"
        assert drv2.executor.local_backend == drv2.capman.local_backend == "torch"
    if name == "hybrid":
        assert drv2.executor.engine.name == "hybrid" and drv2.executor.calibrate
    if name == "wire":
        assert drv2.config.wire_format == "packed"
        assert drv2.executor.engine.wire_policy is not None
    if name.startswith("plan"):
        assert drv2.config.plan == drv.config.plan not in ("auto", "manual")
        assert drv2.plan is None and sorted(drv2.ghd.nodes()) == sorted(drv.ghd.nodes())
    state = _state(drv2)
    _assert_same(state, ref["state"], name)
    # the resumed rows are the uninterrupted run's
    np.testing.assert_array_equal(state["rows"], ref["full"])
    if name == "hybrid":
        assert drv2.ledger.heavy_tuples > 0
    if name == "completed":
        assert drv2.done and drv2.result is not None


def check_reference_snapshot(name, reference, tmp_path):
    """The reference's snapshot file, with only its backend name rewritten,
    resumes in the port to the reference's resumed rows and records."""
    ref = reference(name)
    dst = str(tmp_path / "converted.npz")
    snapshot_from_reference(ref["snap"], dst)
    drv = _port_driver(name, _case(name)[5])
    drv.load(dst)
    assert drv.config.local_backend is None and drv.local_backend == "torch"
    _assert_same(_state(drv), ref["state"], name)


# the cases are spread over test_torch_snapshot*.py so the reference's
# compile time spreads over test workers
@pytest.mark.parametrize("name", ["driver", "caps_cache", "backend", "completed"])
def test_resume_matches_reference(name, reference, tmp_path):
    check_resume(name, reference, tmp_path)


@pytest.mark.parametrize("name", ["driver", "completed"])
def test_reference_snapshot_resumes_in_port(name, reference, tmp_path):
    check_reference_snapshot(name, reference, tmp_path)


def test_step_gen_equals_step():
    """Every round driven through ``step_gen`` with ``dispatch_work`` (the
    serving layer's loop, one driver) equals ``step()`` record for record."""
    name = "caps_cache"
    a = _port_driver(name, _case(name)[3])
    a.run()
    b = _port_driver(name, _case(name)[3])
    yields = 0
    more = True
    while more:
        gen = b.step_gen()
        try:
            works = next(gen)
            while True:
                assert b.pending_groups() == works
                yields += 1
                works = gen.send([dispatch_work(w) for w in works])
        except StopIteration as stop:
            more = stop.value
        assert b.pending_groups() == []
    assert yields > 0 and b.done
    assert [dataclasses.asdict(r) for r in b.ledger.records] == [
        dataclasses.asdict(r) for r in a.ledger.records
    ]
    np.testing.assert_array_equal(b.result.to_numpy(), a.result.to_numpy())
    assert b.caps == a.caps


def test_snapshot_backend_resolves_on_resuming_device(tmp_path):
    """A snapshot pinning ``'cuda'`` cannot resume on the CPU (the same
    ValueError as the constructor's); one with no backend takes the
    resuming device's default."""
    name = "driver"
    drv = _port_driver(name, _case(name)[3])
    drv.step()
    snap = tmp_path / "s.npz"
    drv.save(str(snap))
    with np.load(snap) as z:
        meta = json.loads(str(z["meta"]))
        arrays = {k: z[k] for k in z.files if k != "meta"}
    assert meta["config"]["local_backend"] is None
    assert set(arrays) == {f"{p}_{k}" for p in ("data", "valid") for k in meta["schemas"]}
    assert all(a.dtype == np.int32 for k, a in arrays.items() if k.startswith("data"))
    assert all(a.dtype == bool for k, a in arrays.items() if k.startswith("valid"))
    meta["config"]["local_backend"] = "cuda"
    pinned = tmp_path / "pinned.npz"
    np.savez(pinned, meta=json.dumps(meta), **arrays)
    with pytest.raises(ValueError, match="cuda"):
        _port_driver(name, _case(name)[5]).load(str(pinned))
    resumed = _port_driver(name, dict(_case(name)[5], local_backend="torch"))
    resumed.load(str(snap))
    assert resumed.config.local_backend is None and resumed.local_backend == "torch"
    assert all(t.data.device.type == "cpu" for t in resumed.tables.values())
    assert not list(tmp_path.glob("*.tmp"))  # the atomic write left no temporary


def test_load_into_shared_cache_merges(tmp_path):
    """Restoring into a cache shared with other drivers keeps their
    entries (merge, not replace) and adds the snapshot's new signatures."""
    shared = TCapsCache()
    other = _port_driver("driver", _case("driver")[3], caps_cache=shared)
    assert other.executor.caps_cache is shared
    other.run()
    before = {json.dumps(k): e for k, e in shared.to_json()}
    assert before
    name = "caps_cache"
    drv = _port_driver(name, _case(name)[3])
    drv.step()
    drv.step()
    snap = str(tmp_path / "s.npz")
    drv.save(snap)
    snapped = {json.dumps(k) for k, _ in drv.executor.caps_cache.to_json()}
    resumed = _port_driver(name, _case(name)[5], caps_cache=shared)
    resumed.load(snap)
    assert resumed.executor.caps_cache is shared
    after = {json.dumps(k): e for k, e in shared.to_json()}
    assert set(after) == set(before) | snapped
    assert all(after[k] == e for k, e in before.items())
    np.testing.assert_array_equal(resumed.run().to_numpy(), drv.run().to_numpy())
