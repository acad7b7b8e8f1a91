"""LM training on placed state: the train step, checkpoints and
``launch/train.py`` on a ``torch.distributed`` DeviceMesh, on 4 gloo CPU
ranks (one ``spawn_reducers`` shared by every case), against the port's
single-process step and the reference's step (JAX on the CPU under
``jax.jit``), all from the reference's ``PRNGKey(0)`` params:

- reduced smollm-360m (AdamW, remat, ``accum=2``), reduced kimi-k2 (MoE
  with expert parallelism engaged, Adafactor, ``moe_metrics``, no remat,
  F6 on its shared expert), reduced grok-1 with ``n_experts`` 3 in both
  packages (no EP; ``compress_grads``, ``moe_metrics``) and reduced
  smollm-360m in bf16, each two steps on a ``(2, 2)`` ``("data",
  "model")`` mesh.  Loss, grad norm and MoE counts equal the single
  process' (loss rtol 1e-5, norm 1e-4, counts exactly, drops included: a
  rank's MoE capacity and arrival order are the whole batch's), the
  parameters too (``STEP_FEW``), and the first f32 step equals the
  reference's.  The bf16 case's single process takes the mesh's two data
  slices as its two microbatches (``SINGLE_ACCUM``): the mesh averages
  their gradients in f32, as accumulation does.  Between steps each rank
  holds only its shards, of the shapes ``launch/shardings.py`` gives, and
  the model's own parameters are empty;
- a ``(2, 2)`` checkpoint restores onto ``(4, 1)``, ``(1, 4)`` and one
  process bit for bit, and the step after it equals the uninterrupted
  run's; a reference checkpoint (``interop.checkpoint_from_reference``)
  restores onto the mesh bit for bit;
- a placed ``save`` or ``save_async`` whose writer (rank 0) fails raises
  on every rank, and the ranks go on in step;
- ``constrain`` on a DTensor; the MoE dispatch's four hints
  (``models/mlp.py::moe_hints``) on DTensors, bound without expert
  parallelism and left alone with it (no path gives the dispatch DTensor
  activations yet, so they are held here alone); ``make_production_mesh``
  on 4 ranks, and ``launch/train.py``'s ``main(argv)`` with ``--ckpt``
  then ``--resume`` on the mesh (rank 0 alone prints) against the single
  process' run.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# the JAX package is imported by the fixture alone: the ranks import this
# module to find ``_rank``, and need none of it
from repro_torch.configs import get_config, get_model, reduced_config  # noqa: E402
from repro_torch.interop import checkpoint_from_reference, train_state_from_numpy  # noqa: E402
from repro_torch.launch import shardings as SH  # noqa: E402
from repro_torch.launch.mesh import spawn_reducers  # noqa: E402
from repro_torch.train import OptConfig, TrainConfig, init_train_state, make_train_step  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.step import load_state_tree, state_tree  # noqa: E402

P = 4
LR = 1e-3
B, S = 8, 16
# the first AdamW step moves a parameter by about lr * g / |g|: a gradient
# near zero whose last bits differ (another summation order, a codec
# quantum) moves it by up to 2 lr; so all but 1e-3 of the elements are
# held to GRAD_TOL and every one to 2 lr (as ``test_torch_train.py``)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
STEP_FEW = (1e-3, 2 * LR + 1e-5)
STATS = ("routed", "dropped", "heavy")
# (arch, n_experts override, dtype override, train config)
CASES = {
    "smollm": ("smollm-360m", None, None, dict(opt=dict(kind="adamw"), accum=2)),
    "kimi": ("kimi-k2-1t-a32b", None, None, dict(opt=dict(kind="adafactor"), remat=False,
                                                 moe_metrics=True)),
    "grok": ("grok-1-314b", 3, None, dict(opt=dict(kind="adamw"), compress_grads=True,
                                          moe_metrics=True)),
    "smollm_bf16": ("smollm-360m", None, "bfloat16", dict(opt=dict(kind="adamw"))),
}
# the f32 cases the reference runs too
REFERENCE_CASES = ("smollm", "kimi", "grok")
# the single process' microbatches where they are the mesh's data slices
# (the (2, 2) mesh's "data" axis splits the batch in two)
SINGLE_ACCUM = {"smollm_bf16": 2}
# the MoE hints' test shapes: (t*k, d) pairs and outputs, (e, cap, d) buffers
HINT_D, HINT_CAP = 6, 2
RESTORE_MESHES = ((4, 1), (1, 4))


def _cfg(name, reduced=reduced_config, get=get_config):
    """The reduced config of case ``name`` (the reference's with its
    ``reduced_config`` and ``get_config``)."""
    arch, experts, dtype, _ = CASES[name]
    cfg = reduced(get(arch))
    cfg = dataclasses.replace(cfg, n_experts=experts) if experts else cfg
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def _tcfg(name, cls=TrainConfig, opt_cls=OptConfig, **over):
    kw = dict(CASES[name][3], **over)
    return cls(opt=opt_cls(lr=LR, warmup=1, **kw.pop("opt")), **kw)


def _batch(cfg, seed: int):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32) for k in ("tokens", "targets")}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _model(cfg, sd):
    model = get_model(cfg, "cpu")
    model.load_state_dict(sd)
    return model


def _floats(m):
    return {k: float(v) for k, v in m.items()}


def _gather(tree):
    """The whole leaves as numpy arrays (a bf16 leaf as f32, exactly)."""
    def one(v):
        v = SH.gather_full(v)
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy().copy()

    return {k: one(v) for k, v in ckpt._flatten_with_names(tree).items()}


def _rank(mesh, tmp: str):
    """Every case on this rank; returns what the tests read (the whole
    gathered states on rank 0 only)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
    from repro_torch.train import make_mesh_train_step, place_train_state
    from repro_torch.train.step import train_state_shardings

    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    rank = dist.get_rank()
    lead = rank == 0
    mesh = make_debug_mesh(2, 2, "cpu")
    out = {"cases": {}}
    for name in CASES:
        cfg = _cfg(name)
        tcfg = _tcfg(name)
        model = _model(cfg, inputs[name]["sd"])
        state = place_train_state(model, init_train_state(model, tcfg), mesh)
        where = ckpt._flatten_with_names(train_state_shardings(cfg, state, mesh))
        step = make_mesh_train_step(model, tcfg, mesh)
        res = {"metrics": [], "states": []}
        for i, batch in enumerate(inputs[name]["batches"]):
            res["metrics"].append(_floats(step(state, _tb(batch))))
            # between steps: the model's own parameters are empty, each
            # leaf is a DTensor whose local shard has its spec's shape
            flat = ckpt._flatten_with_names(state)
            shapes_ok = set(flat) == set(where) and all(
                isinstance(t, DTensor) and t.placements == where[k].placements
                and tuple(SH.local(t).shape) == _local_shape(t.shape, t.placements, mesh)
                for k, t in flat.items())
            res.setdefault("held", []).append(
                (shapes_ok, all(p.numel() == 0 for p in model.parameters()),
                 SH.resident_bytes(state)))
            whole = _gather(state)
            res["states"].append(whole if lead else None)
            if i == 0 and name == "smollm":
                ckpt.save(os.path.join(tmp, "mesh_ckpt"), 1, state, extra={"next_step": 1})
                out["writer fails"] = _failed_saves(state, os.path.join(tmp, "inputs.pkl", "ckpt"))
        out["cases"][name] = res
    # the (2, 2) checkpoint of smollm's first step, onto other meshes
    cfg = _cfg("smollm")
    tcfg = _tcfg("smollm")
    out["restored"] = {}
    for shape in RESTORE_MESHES:
        other = make_debug_mesh(*shape, "cpu")
        model = _model(cfg, inputs["smollm"]["sd"])
        like = place_train_state(model, init_train_state(model, tcfg), mesh)  # on (2, 2)
        state, extra = ckpt.restore(os.path.join(tmp, "mesh_ckpt"), like,
                                    placements=train_state_shardings(cfg, like, other))
        whole = _gather(state)
        placed = all(SH.is_placed(t) and t.device_mesh is other
                     for t in ckpt._flatten_with_names(state).values())
        m = make_mesh_train_step(model, tcfg, other)(state, _tb(inputs["smollm"]["batches"][1]))
        after = _gather(state)  # collective: every rank gathers, rank 0 keeps
        out["restored"][shape] = dict(whole=whole if lead else None, extra=extra, placed=placed,
                                      metrics=_floats(m), after=after if lead else None)
    # the reference's checkpoint, converted, onto the (2, 2) mesh
    model = _model(cfg, inputs["smollm"]["sd"])
    like = place_train_state(model, init_train_state(model, tcfg), mesh)
    state, _ = ckpt.restore(os.path.join(tmp, "ref_ckpt_port"), like)
    whole = _gather(state)
    out["from_reference"] = whole if lead else None
    # constrain on a DTensor of the (2, 2) mesh
    full = torch.arange(48.0).reshape(8, 6)
    x = DTensor.from_local(full.clone(), mesh, [Replicate(), Replicate()], run_check=False)
    y = SH.constrain(x, "data", "model")
    z = SH.constrain(x, ("pod", "data"), None)
    w = SH.constrain(DTensor.from_local(full[:, :3].clone(), mesh, [Replicate(), Replicate()],
                                        run_check=False), None, "model")  # 3 % 2: degrades
    out["constrain"] = dict(
        y=(tuple(y.placements) == (Shard(0), Shard(1)), torch.equal(SH.gather_full(y), full),
           tuple(SH.local(y).shape)),
        z=(tuple(z.placements) == (Shard(0), Replicate()), torch.equal(SH.gather_full(z), full)),
        w=w.placements == (Replicate(), Replicate()),
        same=SH.constrain(x, "pod") is x)
    out["hints"] = _hints(mesh)
    try:
        make_production_mesh(device_type="cpu")
        out["production"] = None
    except ValueError as e:
        out["production"] = str(e)
    # the training command line on the mesh: 2 steps with --ckpt, then --resume to 3
    argv = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "16", "--ckpt_every", "1",
            "--ckpt", os.path.join(tmp, "cli")]
    a = launch_train.main(argv + ["--steps", "2"])
    b = launch_train.main(argv + ["--steps", "3", "--resume"])
    out["cli"] = dict(first=a["losses"], resumed=(b["start"], b["losses"]),
                      mesh=tuple(a["opt_state"]["params"]["embed.table"].device_mesh.shape))
    return out


def _failed_saves(state, bad: str) -> dict:
    """``save`` and ``save_async`` + ``join()`` of the placed ``state`` to
    ``bad``, a path under a file, which rank 0 cannot make: the name of
    what each raised on this rank."""
    got = {}
    for how in ("save", "save_async"):
        try:
            if how == "save":
                ckpt.save(bad, 1, state)
            else:
                ckpt.save_async(bad, 1, state).join()
            got[how] = None
        except Exception as e:  # noqa: BLE001 -- the test reads its type
            got[how] = type(e).__name__
    return got


def _hints(mesh) -> dict:
    """``moe_hints`` at every site, on replicated DTensors of the (2, 2)
    mesh, for 3 experts (no EP) and 4 (EP), and on a plain tensor: each
    site's placements, its whole value, and whether it returned its input."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.models.mlp import _HINTS, moe_hints

    out = {}
    for e in (3, 4):
        shapes = {"src": (8, HINT_D), "disp": (e, HINT_CAP, HINT_D), "out": (e, HINT_CAP, HINT_D),
                  "combined": (8, HINT_D)}
        xf = DTensor.from_local(torch.zeros(8, HINT_D), mesh, [Replicate(), Replicate()],
                                run_check=False)
        C = moe_hints(xf, e)
        for site in _HINTS:
            full = torch.arange(float(np.prod(shapes[site]))).reshape(shapes[site])
            x = DTensor.from_local(full.clone(), mesh, [Replicate(), Replicate()], run_check=False)
            y = C(x, site)
            out[e, site] = (tuple(y.placements), torch.equal(SH.gather_full(y), full), y is x)
    plain = torch.zeros(8, HINT_D)
    out["plain"] = moe_hints(plain, 3)(plain, "src") is plain
    return out


def _local_shape(shape, placements, mesh):
    out = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] //= mesh.size(i)
    return tuple(out)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's params and steps, the inputs the ranks read, and
    the ranks' results (the ranks run while the reference compiles its
    MoE steps)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.configs import get_model as jget_model
    from repro.configs import reduced_config as jreduced
    from repro.train import TrainConfig as JTrainConfig
    from repro.train import checkpoint as jckpt
    from repro.train import make_train_step as jmake_train_step
    from repro.train import optim as joptim

    def np_tree(tree):
        return jax.tree_util.tree_map(np.asarray, tree)

    tmp = str(tmp_path_factory.mktemp("lm-mesh"))
    inputs, ref, models = {}, {}, {}
    for name in REFERENCE_CASES:
        jm = jget_model(_cfg(name, jreduced, jget_config))
        params = jax.jit(jm.init)(jax.random.PRNGKey(0))
        batches = [_batch(_cfg(name), seed) for seed in (1, 2)]
        tcfg = _tcfg(name, JTrainConfig, joptim.OptConfig)
        state0 = joptim.opt_init(tcfg.opt, params)
        sd, _ = train_state_from_numpy(_cfg(name), np_tree(params), np_tree(state0))
        inputs[name] = dict(sd=sd, batches=batches)
        models[name] = (jm, params, state0, tcfg)
    # the bf16 case: the f32 smollm's weights, each model casting them
    inputs["smollm_bf16"] = dict(inputs["smollm"])

    def reference(name):
        jm, params, state0, tcfg = models[name]
        batch = {k: jnp.asarray(v) for k, v in inputs[name]["batches"][0].items()}
        p1, s1, m1 = jax.jit(jmake_train_step(jm, tcfg))(params, state0, batch)
        ref[name] = (np_tree(p1), np_tree(s1), _floats(m1))
        if name == "smollm":
            jckpt.save(os.path.join(tmp, "ref_ckpt"), 1, {"params": p1, "opt": s1})
            checkpoint_from_reference(_cfg(name), os.path.join(tmp, "ref_ckpt"),
                                      os.path.join(tmp, "ref_ckpt_port"))

    reference("smollm")  # the ranks read its checkpoint
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    box = {}

    def ranks():
        try:
            box["ranks"] = spawn_reducers(_rank, P, device_type="cpu", args=(tmp,))
        except Exception as e:  # raised below, in the test's thread
            box["error"] = e

    spawner = threading.Thread(target=ranks)
    spawner.start()
    try:
        for name in REFERENCE_CASES:
            if name not in ref:
                reference(name)
    finally:
        spawner.join()
    if "error" in box:
        raise box["error"]
    return dict(tmp=tmp, inputs=inputs, ref=ref, ranks=box["ranks"])


@pytest.fixture(scope="module")
def single(world):
    """The port's single-process run of each case: metrics and states."""
    out = {}
    for name in CASES:
        cfg = _cfg(name)
        tcfg = _tcfg(name)
        if name in SINGLE_ACCUM:
            tcfg = _tcfg(name, accum=SINGLE_ACCUM[name])
        model = _model(cfg, world["inputs"][name]["sd"])
        opt = init_train_state(model, tcfg)
        step = make_train_step(model, tcfg)
        res = {"metrics": [], "states": [], "model": model, "opt": opt}
        for batch in world["inputs"][name]["batches"]:
            res["metrics"].append(_floats(step(opt, _tb(batch))))
            res["states"].append(_gather(state_tree(model, opt)))
        out[name] = res
    return out


def _close_states(got, want, few=STEP_FEW):
    assert set(got) == set(want)
    bad = total = 0
    for k in want:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        assert g.shape == w.shape, k
        bad += int((~np.isclose(g, w, **GRAD_TOL)).sum())
        total += g.size
        assert np.abs(g - w).max() <= few[1], k
    assert bad <= few[0] * total, (bad, total)


def _same_metrics(got, want):
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4)
    assert got["step"] == want["step"]
    for k in STATS:
        if f"moe_{k}" in want:
            assert got[f"moe_{k}"] == want[f"moe_{k}"], k


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_steps_match_the_single_process(world, single, name):
    """Both steps on every rank: the metrics of the single process (the
    MoE counts exactly), and the whole state after each step."""
    for rank in world["ranks"]:
        for got, want in zip(rank["cases"][name]["metrics"], single[name]["metrics"]):
            _same_metrics(got, want)
    for got, want in zip(world["ranks"][0]["cases"][name]["states"], single[name]["states"]):
        _close_states(got, want)


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_mesh_step_matches_the_reference(world, name):
    p1, s1, wm = world["ref"][name]
    cfg = _cfg(name)
    got = world["ranks"][0]["cases"][name]
    _same_metrics(got["metrics"][0], wm)
    want_p, want_s = train_state_from_numpy(cfg, p1, s1)
    want = _gather({"params": want_p, "opt": want_s})
    _close_states(got["states"][0], want)


def test_moe_drops_are_the_whole_batchs(world, single):
    """The MoE cases drop pairs (capacity 1.25 x the mean load), and every
    rank drops exactly the single process' count: each rank ranks its
    pairs after those of the slices before it, against the whole batch's
    capacity."""
    drops = [m["moe_dropped"] for n in ("kimi", "grok") for m in single[n]["metrics"]]
    assert sum(drops) > 0, drops
    for name in ("kimi", "grok"):
        for rank in world["ranks"]:
            assert [m["moe_dropped"] for m in rank["cases"][name]["metrics"]] == [
                m["moe_dropped"] for m in single[name]["metrics"]]


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_hold_only_their_shards(world, name):
    """Between steps every leaf is a DTensor of its rule's placements and
    shard shape, the model's parameters are empty, and a rank's resident
    bytes are below the whole state's (the model ranks split it)."""
    whole = sum(np.asarray(v).nbytes for v in world["ranks"][0]["cases"][name]["states"][0].values())
    for rank in world["ranks"]:
        for shapes_ok, empty, resident in rank["cases"][name]["held"]:
            assert shapes_ok and empty
            assert resident < whole


@pytest.mark.parametrize("shape", RESTORE_MESHES, ids=["4x1", "1x4"])
def test_checkpoint_restores_onto_another_mesh(world, single, shape):
    """The (2, 2) checkpoint after smollm's first step restores onto
    ``shape`` bit for bit, every leaf placed there, and the next step
    equals the uninterrupted (2, 2) run's second."""
    want = world["ranks"][0]["cases"]["smollm"]["states"][0]
    for rank in world["ranks"]:
        got = rank["restored"][shape]
        assert got["placed"] and got["extra"] == {"next_step": 1}
        _same_metrics(got["metrics"], world["ranks"][0]["cases"]["smollm"]["metrics"][1])
    got = world["ranks"][0]["restored"][shape]
    assert set(got["whole"]) == set(want)
    for k in want:
        assert np.array_equal(got["whole"][k], want[k]), k
    _close_states(got["after"], single["smollm"]["states"][1])


def test_checkpoint_restores_onto_one_process(world, single):
    """The (2, 2) checkpoint in a process of its own: plain tensors, bit
    for bit, and the next step equals the uninterrupted run's."""
    cfg = _cfg("smollm")
    tcfg = _tcfg("smollm")
    model = _model(cfg, world["inputs"]["smollm"]["sd"])
    opt = init_train_state(model, tcfg)
    tree, extra = ckpt.restore(os.path.join(world["tmp"], "mesh_ckpt"), state_tree(model, opt))
    assert extra == {"next_step": 1} and not any(
        SH.is_placed(t) for t in ckpt._flatten_with_names(tree).values())
    want = world["ranks"][0]["cases"]["smollm"]["states"][0]
    got = _gather(tree)
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    load_state_tree(model, opt, tree)
    m = make_train_step(model, tcfg)(opt, _tb(world["inputs"]["smollm"]["batches"][1]))
    _same_metrics(_floats(m), world["ranks"][0]["cases"]["smollm"]["metrics"][1])
    _close_states(_gather(state_tree(model, opt)), single["smollm"]["states"][1])


def test_reference_checkpoint_restores_onto_the_mesh(world):
    """The reference's checkpoint after its first step, converted by
    ``checkpoint_from_reference``, restores onto the (2, 2) mesh bit for
    bit."""
    cfg = _cfg("smollm")
    p1, s1, _ = world["ref"]["smollm"]
    want_p, want_s = train_state_from_numpy(cfg, p1, s1)
    want = _gather({"params": want_p, "opt": want_s})
    got = world["ranks"][0]["from_reference"]
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)


def test_constrain_on_a_dtensor(world):
    """``constrain`` redistributes a DTensor to the named axes it has,
    on dims they divide; ``"pod"`` is not on the mesh, and a dim of 3
    degrades to replicated; with nothing left it returns ``x`` itself."""
    for rank in world["ranks"]:
        c = rank["constrain"]
        assert c["y"] == (True, True, (4, 3))
        assert c["z"] == (True, True) and c["w"] and c["same"]


def test_save_whose_writer_fails_raises_on_every_rank(world):
    """The writer's own error on rank 0, a ``RuntimeError`` on the others
    (none waits for a file that never comes), for ``save`` and for
    ``save_async``'s ``join()``; the ranks then went on in step (every
    case after it held above)."""
    for how in ("save", "save_async"):
        got = [r["writer fails"][how] for r in world["ranks"]]
        assert got[0] in ("FileExistsError", "NotADirectoryError"), (how, got)
        assert got[1:] == ["RuntimeError"] * (P - 1), (how, got)


def test_moe_hints_bind_on_a_dtensor_without_expert_parallelism(world):
    """On the (2, 2) ``("data", "model")`` mesh: 3 experts cannot spread
    over ``"model"``, so each site takes its ``_HINTS`` spec (FSDP is
    ``"data"`` here; the expert dim of 3 degrades to replicated); 4 can, so
    every site returns its input; a plain tensor passes as it is."""
    from torch.distributed.tensor import Replicate, Shard

    R = Replicate()
    want = {"src": (Shard(0), Shard(1)), "disp": (Shard(2), R), "out": (R, Shard(2)),
            "combined": (Shard(0), Shard(1))}
    for rank in world["ranks"]:
        h = rank["hints"]
        assert h["plain"]
        for site, pl in want.items():
            assert h[3, site] == (pl, True, False), site
            assert h[4, site] == ((R, R), True, True), site


def test_production_mesh_needs_its_ranks(world):
    assert all("needs 256 ranks, the group has 4" in r["production"] for r in world["ranks"])


def test_train_cli_on_the_mesh(world):
    """``main(argv)`` on the ranks: ``make_debug_mesh(4, 1)``, 2 steps with
    a checkpoint each, then ``--resume`` from step 2 to 3; every rank's
    losses equal the single process' run of the same command."""
    from repro_torch.launch import train as launch_train

    tmp = os.path.join(world["tmp"], "cli-single")
    argv = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "16", "--ckpt_every", "1",
            "--ckpt", tmp]
    a = launch_train.main(argv + ["--steps", "2"])
    b = launch_train.main(argv + ["--steps", "3", "--resume"])
    for rank in world["ranks"]:
        cli = rank["cli"]
        assert cli["mesh"] == (4, 1)
        np.testing.assert_allclose(cli["first"], a["losses"], rtol=1e-5)
        assert cli["resumed"][0] == b["start"] == 2
        np.testing.assert_allclose(cli["resumed"][1], b["losses"], rtol=1e-5)
