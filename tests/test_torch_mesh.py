"""The gym's production runtime: ``SPMD(p, mesh=...)`` over a
``torch.distributed`` device mesh, one process per reducer.

- ``spawn_reducers`` runs 4 gloo ranks on the CPU, once, over C_4 under
  the hash engine and S_4 under grid, packed and hybrid (the bench data
  ``chain_data_sparse(4)``, ``star_data_sparse(4)``).  Every rank's rows
  (as a sorted set), schema, ``RoundRecord``s and the seven ``Ledger``
  figures must equal one another and the port's in-process simulation.
- C_4 hash must also equal the JAX package's own mesh path (``shard_map``
  over 4 forced host devices) in a subprocess; the other three engines
  against it only under ``-m slow`` (13-15 s each).
- ``make_reducer_mesh`` under ``torchrun --standalone`` (2 CPU ranks, a
  rendezvous on localhost) gives every rank the simulation's C_4 answer.
- Unit cases: ``all_to_all`` and ``axis_index`` on random blocks equal
  their simulation forms; a mesh of the wrong size, an NCCL mesh with more
  ranks than cards, a default-device ``SPMD`` without a card and
  ``spawn_reducers`` without a card and without ``device_type="cpu"``
  raise, and so do ``gym`` given a ``p`` that is not its ``SPMD``'s,
  snapshots and the join server on a mesh (not ported there).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import queries as TQ  # noqa: E402
from repro_torch.core.gym import GymConfig as TGymConfig  # noqa: E402
from repro_torch.core.gym import gym as tgym  # noqa: E402
from repro_torch.data.synthetic import chain_data_sparse, star_data_sparse  # noqa: E402
from repro_torch.launch.mesh import spawn_reducers  # noqa: E402
from repro_torch.relational import spmd as TS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
P = 4
CASES = {
    "C_4 hash": ("chain", {}),
    "S_4 grid": ("star", dict(strategy="grid")),
    "S_4 packed": ("star", dict(wire_format="packed")),
    "S_4 hybrid": ("star", dict(strategy="hybrid")),
}
FIGURES = ("comm_tuples", "rounds", "retries", "measured_dispatches",
           "measure_dispatches", "padded_slots", "payload_bytes")
# (block shape, destination axis) of the unit collectives: the count
# vectors, the dense buckets and a packed segment of ``relational/routed.py``
A2A_SHAPES = (((P, 3, P), 2), ((P, 2, P, 5, 3), 2), ((P, P, 7), 1))

# the JAX package's mesh path, run in a fresh process with 4 host devices
REFERENCE = r"""
import json, sys
import jax
from repro.core.gym import GymConfig, gym
from repro.core.queries import chain_query, star_query
from repro.data.synthetic import chain_data_sparse, star_data_sparse
from repro.relational.spmd import SPMD
mesh = jax.make_mesh((4,), ("r",))
out = {}
for name, kind, cfg in json.loads(sys.argv[1]):
    q, d = (chain_query(4), chain_data_sparse(4)) if kind == "chain" else (star_query(4), star_data_sparse(4))
    rows, schema, led = gym(q, d, p=4, spmd=SPMD(4, mesh=mesh), config=GymConfig(**cfg))
    out[name] = dict(rows=sorted(map(list, rows.tolist())), schema=list(schema),
                     **{f: int(getattr(led, f)) for f in sys.argv[2].split(",")})
print(json.dumps(out))
"""


# what each rank of a ``torchrun`` launch runs: the README's recipe
TORCHRUN = r"""
import json, sys
import torch.distributed as dist
from repro_torch.core.gym import gym
from repro_torch.core.queries import chain_query
from repro_torch.data.synthetic import chain_data_sparse
from repro_torch.launch.mesh import make_reducer_mesh
from repro_torch.relational.spmd import SPMD
mesh = make_reducer_mesh(2, device_type="cpu")
rows, schema, led = gym(chain_query(4), chain_data_sparse(4), spmd=SPMD(2, mesh=mesh))
line = json.dumps(dict(rank=mesh.get_local_rank("r"), rows=sorted(map(list, rows.tolist())),
                      schema=list(schema), comm=led.comm_tuples, rounds=led.rounds))
sys.stdout.write(line + "\n")  # one write a rank: the two ranks share the pipe
sys.stdout.flush()
dist.destroy_process_group()
"""


def _case(name):
    kind, cfg = CASES[name]
    if kind == "chain":
        return TQ.chain_query(4), chain_data_sparse(4), cfg
    return TQ.star_query(4), star_data_sparse(4), cfg


def _figures(rows, schema, led) -> dict:
    return dict(
        rows=sorted(map(list, rows.tolist())), schema=list(schema),
        records=[dataclasses.asdict(r) for r in led.records],
        **{f: int(getattr(led, f)) for f in FIGURES},
    )


def _blocks(seed: int):
    """The unit collectives' global inputs, the same on every rank."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1000, size=s).astype(np.int64) for s, _ in A2A_SHAPES]


def _a2a_body(x, *, dst_dim):
    return TS.all_to_all(x, dst_dim), TS.axis_index(P, x)


def _rank(mesh):
    """One reducer: the four gym runs, the unit collectives, the size check."""
    from torch.distributed.device_mesh import init_device_mesh

    spmd = TS.SPMD(P, mesh=mesh)
    assert spmd.device.type == "cpu" and spmd.shards == 1
    out = {}
    for name in CASES:
        q, d, cfg = _case(name)
        out[name] = _figures(*tgym(q, d, p=P, spmd=TS.SPMD(P, mesh=mesh), config=TGymConfig(**cfg)))
    unit = []
    for x, (_, dst) in zip(_blocks(7), A2A_SHAPES):
        y, idx = spmd.run(_a2a_body, spmd.device_put(torch.from_numpy(x)), dst_dim=dst)
        unit.append((spmd.to_host(y), spmd.to_host(idx)))
    out["unit"] = unit
    # what is not ported to a mesh refuses one instead of answering for a block
    from repro_torch.core.gym import GymDriver
    from repro_torch.serve import JoinServer

    q, d, _ = _case("C_4 hash")
    drv = GymDriver(q, TQ.chain_ghd(4), d, TS.SPMD(P, mesh=mesh))
    refused = []
    for what in (lambda: drv.save("unused.npz"), lambda: drv.load("unused.npz"),
                 lambda: JoinServer(TS.SPMD(P, mesh=mesh))):
        try:
            what()
        except NotImplementedError:
            refused.append(True)
    out["refused"] = refused
    # the "r" dimension of a (2, 2) mesh holds 2 ranks, not 4
    half = init_device_mesh("cpu", (2, 2), mesh_dim_names=("x", "r"))["r"]
    try:
        TS.SPMD(P, mesh=half)
        out["wrong_size"] = "accepted"
    except ValueError as e:
        out["wrong_size"] = str(e)
    return out


@pytest.fixture(scope="module")
def reference_c4():
    """The reference's mesh run of C_4 hash, started first so that it runs
    beside the port's ranks; its output is read when a test needs it."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, json.dumps([("C_4 hash", "chain", {})]),
         ",".join(FIGURES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def torchrun_c4():
    """Two ranks launched by ``torchrun`` (started beside the spawned ranks)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "--no-python", sys.executable, "-c", TORCHRUN],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ranks(reference_c4, torchrun_c4):
    return spawn_reducers(_rank, P, device_type="cpu")


@pytest.fixture(scope="module")
def simulation():
    out = {}
    for name in CASES:
        q, d, cfg = _case(name)
        out[name] = _figures(*tgym(q, d, p=P, config=TGymConfig(**cfg), device="cpu"))
    return out


def _reference(proc) -> dict:
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-4000:]
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_equals_the_simulation(ranks, simulation, name):
    want = simulation[name]
    assert want["rows"], name
    for r, got in enumerate(ranks):
        assert got[name] == want, f"rank {r}: {name}"


def test_c4_hash_equals_the_reference_mesh(ranks, reference_c4):
    ref = _reference(reference_c4)["C_4 hash"]
    got = {k: v for k, v in ranks[0]["C_4 hash"].items() if k != "records"}
    assert got == ref
    assert (len(ref["rows"]), ref["comm_tuples"], ref["rounds"], ref["measured_dispatches"],
            ref["measure_dispatches"], ref["padded_slots"], ref["payload_bytes"]) == (
        8, 220, 10, 25, 8, 5632, 26880)


def test_make_reducer_mesh_under_torchrun(ranks, torchrun_c4):
    stdout, stderr = torchrun_c4.communicate(timeout=300)
    assert torchrun_c4.returncode == 0, stderr[-4000:]
    got = sorted((json.loads(line) for line in stdout.splitlines() if line.startswith("{")),
                 key=lambda r: r["rank"])
    q, d, _ = _case("C_4 hash")
    rows, schema, led = tgym(q, d, p=2, device="cpu")
    want = dict(rows=sorted(map(list, rows.tolist())), schema=list(schema),
                comm=led.comm_tuples, rounds=led.rounds)
    assert [r.pop("rank") for r in got] == [0, 1]
    assert got == [want, want]


@pytest.mark.slow
@pytest.mark.parametrize("name", ["S_4 grid", "S_4 packed", "S_4 hybrid"])
def test_engine_equals_the_reference_mesh(ranks, name):
    kind, cfg = CASES[name]
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-c", REFERENCE, json.dumps([(name, kind, cfg)]), ",".join(FIGURES)],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])[name]
    assert {k: v for k, v in ranks[0][name].items() if k != "records"} == ref


@pytest.mark.parametrize("i", range(len(A2A_SHAPES)))
def test_all_to_all_and_axis_index_equal_the_simulation(ranks, i):
    x = torch.from_numpy(_blocks(7)[i])
    dst = A2A_SHAPES[i][1]
    sim = TS.SPMD(P, device="cpu")
    want_y, want_idx = sim.run(_a2a_body, x, dst_dim=dst)
    for r, got in enumerate(ranks):
        y, idx = got["unit"][i]
        np.testing.assert_array_equal(y, want_y.numpy(), err_msg=f"rank {r}")
        np.testing.assert_array_equal(idx, want_idx.numpy(), err_msg=f"rank {r}")


def test_snapshots_and_the_join_server_refuse_a_mesh(ranks):
    assert all(got["refused"] == [True, True, True] for got in ranks)


def test_mesh_of_the_wrong_size_raises(ranks):
    for got in ranks:
        assert "size 4" in got["wrong_size"], got["wrong_size"]


def test_nccl_mesh_beyond_the_cards_raises():
    with pytest.raises(RuntimeError):
        spawn_reducers(_rank, torch.cuda.device_count() + 1, backend="nccl",
                       device_type="cuda")


def test_spawn_reducers_defaults_to_the_card(monkeypatch):
    """A mesh on the CPU must be asked for: with no ``device_type`` the
    ranks go to the card, and on a host without one ``spawn_reducers``
    raises before it starts a process."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        spawn_reducers(_rank, P)


def test_gym_refuses_a_p_that_is_not_the_spmds():
    q, d, _ = _case("C_4 hash")
    with pytest.raises(ValueError, match="p=2"):
        tgym(q, d, p=2, spmd=TS.SPMD(P, device="cpu"))
    rows, _, led = tgym(q, d, p=P, spmd=TS.SPMD(P, device="cpu"))
    want, _, wled = tgym(q, d, p=P, device="cpu")
    assert np.array_equal(rows, want) and led.records == wled.records


def test_default_device_spmd_needs_a_card():
    if torch.cuda.is_available():
        assert TS.SPMD(P).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            TS.SPMD(P)
