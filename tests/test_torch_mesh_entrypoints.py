"""Every gym entry point on the reducer mesh, ``SPMD(p, mesh=...)``, one
process per reducer.

One module-scoped ``spawn_reducers`` of 4 gloo ranks on the CPU runs every
case once, each rank making the same calls:

- ``shares_join`` on S_4, ``gym_loggta`` and ``acq_mr`` on C_8
  (``chain_data_sparse(8)``, whose Log-GTA plan holds a cross-product bag);
- a C_4 ``GymDriver`` stepped ``K`` times and saved on the mesh (a
  collective ``save``), finished, and that snapshot resumed by a fresh mesh
  driver; a simulation snapshot at the same cursor resumed on the mesh; a
  snapshot taken at p = 2 (its ``load`` must raise); a ``save`` whose
  writing rank fails (every rank must raise, and stay in step); the
  reference's own snapshot of C_4 at the same cursor, taken on its
  ``shard_map`` mesh;
- a 4-ticket, two-tenant ``JoinServer`` drain at ``max_in_flight=2``;
- ``int8_allreduce`` over the ranks' process group.

Every rank must equal the port's in-process simulation in rows, schema,
``RoundRecord``s and the seven ``Ledger`` figures; the mesh snapshot must
equal the simulation's array for array and in ``meta``, and resume in the
simulation; every ticket and the ``ServerLedger``'s counts must equal a
simulation server's; the all-reduce must equal the leading-axis form bit
for bit.  The reference's ``shard_map`` path (4 forced host devices, one
subprocess started beside the ranks) runs ``shares_join`` on S_4, which
the ranks must equal, and writes the snapshot the ranks resume, whose
finish must equal the uninterrupted run (the simulation's, whose figures
are the reference mesh's as ``test_torch_mesh.py`` pins them).  The simulation
is held to the reference elsewhere (``test_torch_shares.py``,
``test_torch_gym_loggta.py``, ``test_torch_snapshot.py``,
``test_torch_join_server.py``, ``test_torch_train.py``).  Every collective
wait has ``launch/mesh.py``'s timeout, so ranks that stray from one another
fail.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import queries as TQ  # noqa: E402
from repro_torch.core.acq_mr import acq_mr, gym_loggta  # noqa: E402
from repro_torch.core.gym import GymConfig, GymDriver  # noqa: E402
from repro_torch.core.loggta import log_gta  # noqa: E402
from repro_torch.core.shares import shares_join  # noqa: E402
from repro_torch.data.synthetic import chain_data_sparse, star_data_sparse  # noqa: E402
from repro_torch.interop import snapshot_from_reference  # noqa: E402
from repro_torch.launch.mesh import spawn_reducers  # noqa: E402
from repro_torch.relational.spmd import SPMD  # noqa: E402
from repro_torch.serve import JoinServer  # noqa: E402
from repro_torch.train.compression import int8_allreduce  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
P = 4
K = 2  # the snapshots' cursor: materialization and one DYM round
REFERENCE_WAIT_S = 240
FIGURES = ("comm_tuples", "rounds", "retries", "measured_dispatches",
           "measure_dispatches", "padded_slots", "payload_bytes")
ENTRIES = ("S_4 shares_join", "C_8 gym_loggta", "C_8 acq_mr")
RESUMES = ("mesh -> mesh", "simulation -> mesh", "reference -> mesh")
NOT_A_DIRECTORY = "not-a-directory"
# (tenant, query, seed, priority): the urgent star jumps the queue
SCHEDULE = [("alice", "star", 3, 0.0), ("bob", "star", 3, 0.0),
            ("alice", "chain", 3, 0.0), ("bob", "star", 3, -1.0)]

# the JAX package's mesh path in a fresh process with 4 host devices: its
# snapshot of C_4 at cursor K (the ranks resume it), then ``shares_join``
# on S_4
REFERENCE = r"""
import json, sys
import jax
from repro.core.gym import GymConfig, GymDriver
from repro.core.queries import chain_ghd, chain_query, star_query
from repro.core.shares import shares_join
from repro.data.synthetic import chain_data_sparse, star_data_sparse
from repro.relational.spmd import SPMD
path, k, figures = sys.argv[1], int(sys.argv[2]), sys.argv[3].split(",")
mesh = jax.make_mesh((4,), ("r",))

def result(rows, schema, led):
    return dict(rows=sorted(map(list, rows.tolist())), schema=list(schema),
                **{f: int(getattr(led, f)) for f in figures})

drv = GymDriver(chain_query(4), chain_ghd(4), chain_data_sparse(4), SPMD(4, mesh=mesh), GymConfig())
for _ in range(k):
    drv.step()
drv.save(path)
out = {"S_4 shares_join": result(*shares_join(star_query(4), star_data_sparse(4), spmd=SPMD(4, mesh=mesh)))}
print(json.dumps(out))
"""


def _entry(name, spmd=None, device=None):
    if name == "S_4 shares_join":
        return shares_join(TQ.star_query(4), star_data_sparse(4), spmd=spmd, device=device)
    fn = gym_loggta if name == "C_8 gym_loggta" else acq_mr
    return fn(TQ.chain_query(8), chain_data_sparse(8), ghd=TQ.chain_ghd(8), spmd=spmd,
              device=device)


def _c4_driver(spmd) -> GymDriver:
    return GymDriver(TQ.chain_query(4), TQ.chain_ghd(4), chain_data_sparse(4), spmd, GymConfig())


def _figures(rows, schema, led) -> dict:
    return dict(
        rows=sorted(map(list, np.asarray(rows).tolist())), schema=list(schema),
        records=[dataclasses.asdict(r) for r in led.records],
        **{f: int(getattr(led, f)) for f in FIGURES},
    )


def _finish(drv: GymDriver) -> dict:
    out = drv.run()
    return _figures(out.to_numpy(drv.spmd), out.schema, drv.ledger)


def _serve(spmd):
    """Drain SCHEDULE; per ticket its result and ticks, and the server's
    counts."""
    cases = {
        "star": (TQ.star_query(4), TQ.star_ghd(4),
                 star_data_sparse(4, domain=32, hub_rows=64, spoke_extra=16, seed=7)),
        "chain": (TQ.chain_query(4), TQ.chain_ghd(4),
                  chain_data_sparse(4, domain=64, ident=16, extra=48, seed=9)),
    }
    srv = JoinServer(spmd, max_in_flight=2)
    tickets = [srv.submit(t, *cases[c], GymConfig(seed=s), priority=pr)
               for t, c, s, pr in SCHEDULE]
    srv.drain()
    return dict(
        tickets=[dict(_figures(t.rows(), t.result.schema, t.ledger),
                      ticks=(t.submit_tick, t.admit_tick, t.finish_tick)) for t in tickets],
        ledger=srv.ledger.summary(), tick=srv.tick,
    )


def _shards(seed: int = 5) -> np.ndarray:
    """The all-reduce's data-parallel shards, one row a rank."""
    return np.random.default_rng(seed).normal(size=(P, 1000)).astype(np.float32)


def _resume(path: str, spmd) -> dict:
    drv = _c4_driver(spmd)
    drv.load(path)
    return _finish(drv)


def _rank(mesh, tmp: str):
    """One reducer: every entry point, the snapshots, the server and the
    all-reduce; the reference's snapshot last (its process writes it)."""
    spmd = SPMD(P, mesh=mesh)
    out = {name: _figures(*_entry(name, spmd=SPMD(P, mesh=mesh))) for name in ENTRIES}
    drv = _c4_driver(SPMD(P, mesh=mesh))
    for _ in range(K):
        drv.step()
    drv.save(os.path.join(tmp, "mesh.npz"))
    out["C_4 uninterrupted"] = _finish(drv)
    out["mesh -> mesh"] = _resume(os.path.join(tmp, "mesh.npz"), SPMD(P, mesh=mesh))
    out["simulation -> mesh"] = _resume(os.path.join(tmp, "simulation.npz"), SPMD(P, mesh=mesh))
    try:
        _c4_driver(SPMD(P, mesh=mesh)).load(os.path.join(tmp, "p2.npz"))
        out["wrong p"] = "loaded"
    except ValueError as e:
        out["wrong p"] = str(e)
    try:  # rank 0 cannot create the directory: a file holds its name
        drv.save(os.path.join(tmp, NOT_A_DIRECTORY, "x.npz"))
        out["writer fails"] = "saved"
    except Exception as e:
        out["writer fails"] = type(e).__name__
    out["server"] = _serve(SPMD(P, mesh=mesh))
    x = torch.from_numpy(_shards()[spmd.rank])
    out["int8_allreduce"] = int8_allreduce(x, group=mesh).numpy()
    ref = os.path.join(tmp, "reference.npz")
    deadline = time.monotonic() + REFERENCE_WAIT_S
    while not os.path.exists(ref):  # published by an atomic rename
        assert time.monotonic() < deadline, "the reference's snapshot never came"
        time.sleep(0.05)
    mine = os.path.join(tmp, f"reference-port-{spmd.rank}.npz")
    snapshot_from_reference(ref, mine)
    out["reference -> mesh"] = _resume(mine, SPMD(P, mesh=mesh))
    return out


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh-entrypoints")


@pytest.fixture(scope="module")
def reference(workdir):
    """The reference's mesh runs, started first so that they run beside
    the port's ranks."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(workdir / "reference.npz"), str(K),
         ",".join(FIGURES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ranks(reference, workdir):
    (workdir / NOT_A_DIRECTORY).write_text("")
    for name, p in (("simulation.npz", P), ("p2.npz", 2)):
        drv = _c4_driver(SPMD(p, device="cpu"))
        for _ in range(K):
            drv.step()
        drv.save(str(workdir / name))
    return spawn_reducers(_rank, P, device_type="cpu", args=(str(workdir),))


@pytest.fixture(scope="module")
def simulation(workdir, ranks):
    """The simulation's runs; "C_4 resumed" is its own snapshot resumed in
    it (a resumed run re-measures what the uninterrupted one prefetched, so
    its padding figures may differ from the uninterrupted run's)."""
    out = {name: _figures(*_entry(name, device="cpu")) for name in ENTRIES}
    out["C_4 uninterrupted"] = _finish(_c4_driver(SPMD(P, device="cpu")))
    out["C_4 resumed"] = _resume(str(workdir / "simulation.npz"), SPMD(P, device="cpu"))
    out["server"] = _serve(SPMD(P, device="cpu"))
    return out


def _reference(proc) -> dict:
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-4000:]
    return json.loads(stdout.strip().splitlines()[-1])


def _npz(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", ENTRIES)
def test_entry_point_on_every_rank_equals_the_simulation(ranks, simulation, name):
    want = simulation[name]
    assert want["rows"], name
    for r, got in enumerate(ranks):
        assert got[name] == want, f"rank {r}: {name}"


def test_loggta_plan_of_c8_has_a_cross_product_bag():
    """What the C_8 cases put on the mesh: a bag whose atoms' projections
    share no attribute (the Lemma 8 grid join of a cross product)."""
    q = TQ.chain_query(8)
    plan = log_gta(TQ.chain_ghd(8).make_complete(q), q)
    atoms = {a.alias: a for a in q.atoms}
    cross = [v for v in plan.nodes() if len(plan.lam[v]) > 1 and all(
        not (set(atoms[a].attrs) & set(atoms[b].attrs) & plan.chi[v])
        for a in plan.lam[v] for b in plan.lam[v] if a < b)]
    assert cross


def test_shares_join_equals_the_reference_mesh(ranks, reference):
    ref = _reference(reference)["S_4 shares_join"]
    for r, got in enumerate(ranks):
        assert {k: v for k, v in got["S_4 shares_join"].items() if k != "records"} == ref, r


def test_mesh_snapshot_equals_the_simulations(ranks, workdir):
    mesh, sim = _npz(workdir / "mesh.npz"), _npz(workdir / "simulation.npz")
    assert sorted(mesh) == sorted(sim) and len(mesh) > 1
    assert json.loads(str(mesh.pop("meta"))) == json.loads(str(sim.pop("meta")))
    for k, a in sim.items():
        b = mesh[k]
        assert a.shape[0] == P and a.dtype == b.dtype and np.array_equal(a, b), k


def test_driver_stepped_and_saved_on_the_mesh_equals_the_uninterrupted_run(ranks, simulation):
    want = simulation["C_4 uninterrupted"]
    for r, got in enumerate(ranks):
        assert got["C_4 uninterrupted"] == want, f"rank {r}"


@pytest.mark.parametrize("how", RESUMES[:2])
def test_resumed_on_the_mesh_equals_the_simulations_resume(ranks, simulation, how):
    want = simulation["C_4 resumed"]
    assert want["rows"] == simulation["C_4 uninterrupted"]["rows"]
    for r, got in enumerate(ranks):
        assert got[how] == want, f"rank {r}: {how}"


def test_mesh_snapshot_resumes_in_the_simulation(ranks, simulation, workdir):
    assert _resume(str(workdir / "mesh.npz"), SPMD(P, device="cpu")) == simulation["C_4 resumed"]


def test_reference_snapshot_resumes_on_the_port_mesh(ranks, simulation):
    """The reference's snapshot, taken on its mesh, finishes on the port's
    ranks as C_4 runs uninterrupted: in the simulation, and on the
    reference's mesh (the figures ``test_torch_mesh.py`` pins there)."""
    want = simulation["C_4 uninterrupted"]
    assert (len(want["rows"]), want["comm_tuples"], want["rounds"], want["measured_dispatches"],
            want["measure_dispatches"], want["padded_slots"], want["payload_bytes"]) == (
        8, 220, 10, 25, 8, 5632, 26880)
    for r, got in enumerate(ranks):
        assert got["reference -> mesh"] == want, r


def test_snapshot_of_another_p_raises(ranks, workdir):
    for got in ranks:
        assert "2 reducers" in got["wrong p"] and "runs 4" in got["wrong p"], got["wrong p"]
    with pytest.raises(ValueError, match="runs 4"):
        _c4_driver(SPMD(P, device="cpu")).load(str(workdir / "p2.npz"))


def test_save_whose_writer_fails_raises_on_every_rank(ranks, workdir):
    """The writer's own error on rank 0, a ``RuntimeError`` on the others
    (none waits for a file that never comes), and the ranks go on in step:
    the server and the all-reduce after it held above."""
    got = [r["writer fails"] for r in ranks]
    assert got[0] in ("FileExistsError", "NotADirectoryError"), got
    assert got[1:] == ["RuntimeError"] * (P - 1), got
    assert not list(workdir.glob("*.tmp")), "a temporary file was left behind"


def test_join_server_on_every_rank_equals_the_simulation(ranks, simulation):
    want = simulation["server"]
    assert want["ledger"]["dispatches_saved"] > 0 and len(want["ledger"]["tenants"]) == 2
    for r, got in enumerate(ranks):
        assert got["server"] == want, f"rank {r}"


def test_int8_allreduce_over_the_group_is_bit_equal_to_the_leading_axis_form(ranks):
    want = int8_allreduce(torch.from_numpy(_shards())).numpy()
    for r, got in enumerate(ranks):
        assert got["int8_allreduce"].dtype == np.float32
        assert np.array_equal(got["int8_allreduce"].view(np.int32), want[r].view(np.int32)), r


def test_entry_points_refuse_a_p_that_is_not_the_spmds():
    s = SPMD(P, device="cpu")
    q, d = TQ.star_query(4), star_data_sparse(4)
    with pytest.raises(ValueError, match="p=2"):
        shares_join(q, d, p=2, spmd=s)
    with pytest.raises(ValueError, match="not both"):
        shares_join(q, d, spmd=s, device="cpu")
    with pytest.raises(ValueError, match="p=2"):
        gym_loggta(TQ.chain_query(4), chain_data_sparse(4), p=2, spmd=s)
