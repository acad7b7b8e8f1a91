"""The reference's partitioned LM step on the port: per-layer gathers and
``"model"``-parallel compute (``launch/shardings.py``'s ``fetch``,
``col_product``, ``row_product``, ``to_model``, ``from_model``;
``models/``), the mesh train step on them (``train/step.py``), prefill and
decode on a mesh (``serve/mesh.py``) and the dry run's trace of one rank
of a mesh (``launch/dryrun.py::mesh_trace``).

One spawn of 4 gloo CPU ranks on a ``(2, 2)`` ``("data", "model")`` mesh
runs every case, beside a subprocess that runs the reference's jitted
steps under its own placements (``param_specs``, ``opt_state_specs``,
``batch_specs``, ``cache_specs``) on 4 forced host devices.  Its mesh has
the reference's names and sizes with GSPMD's automatic axes: under the
explicit axes that ``jax.make_mesh`` now defaults to, the reference's
embedding gather and cache update refuse batch-sharded operands (the
``ShardingTypeError`` of ``ROADMAP.md`` C).  The reference initializes
every model (``PRNGKey(0)``) and writes the parameters first; the ranks
start on them while it compiles.

- train, one step each: reduced smollm-360m with its 4 query heads over
  1 K/V head (query heads split, K/V computed whole), with 2 K/V heads
  (both split) and with 3 heads (not head-aligned: replicated); reduced
  grok-1 with 3 experts (each expert's FF split on ``"model"``) and
  reduced kimi-k2 (4 experts: expert parallelism, Adafactor).  Metrics
  and parameters equal the reference's and the single process' (loss
  rtol 1e-5, norm 1e-4, MoE counts exactly; parameters as
  ``test_torch_lm_mesh.py`` holds them), the dense cases' single process
  taking the mesh's two data slices as its microbatches;
- serving: reduced smollm-360m with 2 K/V heads (a cache split on heads)
  and with 1 (split on the sequence): prefill 4 x 12 tokens and 5 greedy
  tokens; tokens equal the reference's and the single process', logits
  within 1e-5 of the largest; one decode step moves the same collective
  bytes over a cache of 20 positions and of 40 (no cache byte crosses a
  collective);
- bf16: the query-split model's step in bf16 equals, bit for bit, the
  single process whose gated MLP products split on the mesh's model
  shards as the mesh splits them (``chip_smoke.split_products``): the
  shards' f32 products summed in f64 (``launch/shardings.py::_model_sum``)
  round the same whatever order the collective adds in;
- the counter: the bytes of each kind and axis that rank 0 counts in a
  train step, a prefill and a decode step equal those of the fake-PG
  ``meta`` trace of the same cell;
- a ``(2, 1)`` trace's per-device flops times 2 equal the one-card
  trace's flops; grok-1 at full width (2 of 64 layers, AdamW) on the
  production mesh holds a per-device peak below the whole parameters'
  bytes, which the step before gathered onto every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# the JAX package is imported by the reference's subprocess alone: the
# ranks import this module to find ``_rank``, and need none of it
from repro_torch.configs import get_config, get_model, reduced_config  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import shardings as SH  # noqa: E402
from repro_torch.launch.mesh import MeshShape, spawn_reducers  # noqa: E402
from repro_torch.serve import generate  # noqa: E402
from repro_torch.train import OptConfig, TrainConfig, init_train_state, make_train_step  # noqa: E402

P = 4
MESH = MeshShape(("data", "model"), (2, 2))
LR = 1e-3
B, S = 8, 16
# (arch, config overrides, optimizer)
TRAIN = {
    "q_split": ("smollm-360m", {}, "adamw"),
    "heads_split": ("smollm-360m", dict(n_kv_heads=2), "adamw"),
    "replicated": ("smollm-360m", dict(n_heads=3, n_kv_heads=1), "adamw"),
    "grok_ff": ("grok-1-314b", dict(n_experts=3), "adamw"),
    "kimi_ep": ("kimi-k2-1t-a32b", {}, "adafactor"),
}
# (arch, config overrides): the KV cache's split on "model"
SERVE = {"heads": ("smollm-360m", dict(n_kv_heads=2)), "seq": ("smollm-360m", {})}
SERVE_B, SERVE_S, STEPS, S_CACHE = 4, 12, 5, 20
# the bf16 case: (arch, config overrides, sequence), the hidden dim and
# the batch large enough that the one-product single process rounds some
# parameters differently
BF16 = ("smollm-360m", dict(d_ff=1024), 64)
STATS = ("routed", "dropped", "heavy")
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
STEP_FEW = (1e-3, 2 * LR + 1e-5)
LOGIT_REL = 1e-5
WAIT_S = 300

REFERENCE = r"""
import dataclasses, os, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec
from repro.configs import get_config, get_model, reduced_config
from repro.launch.shardings import batch_specs, cache_specs, named, opt_state_specs, param_specs
from repro.train import TrainConfig, make_train_step, optim

spec = pickle.load(open(sys.argv[1], "rb"))
tmp = sys.argv[2]
np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
cfgs, params = {}, {}
for name, (arch, over) in spec["models"].items():
    cfgs[name] = dataclasses.replace(reduced_config(get_config(arch)), **over)
    params[name] = jax.jit(get_model(cfgs[name]).init)(jax.random.PRNGKey(0))
with open(os.path.join(tmp, "params.tmp"), "wb") as f:
    pickle.dump({k: np_tree(v) for k, v in params.items()}, f)
os.replace(os.path.join(tmp, "params.tmp"), os.path.join(tmp, "params.pkl"))

mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
out = {"train": {}, "serve": {}}
for name, (model_name, opt, batch) in spec["train"].items():
    cfg, p0 = cfgs[model_name], params[model_name]
    model = get_model(cfg)
    tcfg = TrainConfig(opt=optim.OptConfig(lr=spec["lr"], warmup=1, kind=opt),
                       moe_metrics=bool(cfg.n_experts))
    state = optim.opt_init(tcfg.opt, p0)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    psp = named(mesh, param_specs(p0, mesh))
    osp = named(mesh, opt_state_specs(state, None, mesh))
    step = jax.jit(make_train_step(model, tcfg), in_shardings=(psp, osp, named(mesh, batch_specs(batch, mesh))),
                   out_shardings=(psp, osp, None))
    p1, _, m1 = step(p0, state, batch)
    out["train"][name] = dict(params=np_tree(p1), metrics={k: float(v) for k, v in m1.items()})
for name, (model_name, prompt) in spec["serve"].items():
    cfg, p0 = cfgs[model_name], params[model_name]
    model = get_model(cfg)
    prompt = jnp.asarray(prompt)
    pbytes = sum(l.size * l.dtype.itemsize for l in jax.tree_util.tree_leaves(p0))
    psp = named(mesh, param_specs(p0, mesh, serve_tp_only=pbytes // mesh.shape["model"] <= 8 << 30))
    pre = jax.jit(lambda p, b: model.prefill(p, b, spec["s_cache"]),
                  in_shardings=(psp, named(mesh, batch_specs({"tokens": prompt}, mesh))))
    logits, caches = pre(p0, {"tokens": prompt})
    csp = named(mesh, cache_specs(caches, mesh))
    tsp = named(mesh, batch_specs({"t": prompt[:, 0]}, mesh))["t"]
    dec = jax.jit(model.decode_step, in_shardings=(psp, csp, tsp), out_shardings=(None, csp))
    caches = jax.device_put(caches, csp)
    toks, lgts = [jnp.argmax(logits, -1)], [logits]
    for _ in range(spec["steps"] - 1):
        logits, caches = dec(p0, caches, jax.device_put(toks[-1], tsp))
        lgts.append(logits)
        toks.append(jnp.argmax(logits, -1))
    out["serve"][name] = dict(tokens=np.asarray(jnp.stack(toks, 1)), logits=np.asarray(jnp.stack(lgts, 1)))
with open(os.path.join(tmp, "reference.pkl"), "wb") as f:
    pickle.dump(out, f)
"""


def _cfg(arch, over):
    return dataclasses.replace(reduced_config(get_config(arch)), **over)


def _tcfg(name, **over):
    arch, _, opt = TRAIN[name]
    return TrainConfig(opt=OptConfig(lr=LR, warmup=1, kind=opt),
                       moe_metrics=arch != "smollm-360m", **over)


def _batch(cfg):
    rng = np.random.default_rng(1)
    return {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32) for k in ("tokens", "targets")}


def _prompt(cfg):
    return np.random.default_rng(2).integers(0, cfg.vocab, (SERVE_B, SERVE_S)).astype(np.int32)


def _models():
    """Each model the cases use, by name: (arch, overrides)."""
    out = {name: (arch, over) for name, (arch, over, _) in TRAIN.items()}
    out.update({f"serve_{name}": v for name, v in SERVE.items()})
    return out


def _load(tmp, name):
    path = os.path.join(tmp, name)
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > WAIT_S:
            raise TimeoutError(f"{path} did not come in {WAIT_S} s")
        time.sleep(0.1)
    with open(path, "rb") as f:
        return pickle.load(f)


def _model(name, params):
    arch, over = _models()[name]
    cfg = _cfg(arch, over)
    model = get_model(cfg, "cpu")
    model.load_state_dict(lm_params_from_numpy(cfg, params[name]))
    return cfg, model


def _floats(m):
    return {k: float(v) for k, v in m.items()}


def _bf16_steps(mesh, lead):
    """The bf16 case (see the module doc) on this rank: the mesh step's
    metrics, and on rank 0 the gathered parameters, the split single
    process' step and the one-product single process' (each from the same
    seeded weights, in this process)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    import chip_smoke

    from repro_torch.train import make_mesh_train_step, place_train_state

    cfg = _cfg(BF16[0], dict(BF16[1], dtype="bfloat16"))
    tcfg = TrainConfig(opt=OptConfig(lr=LR, warmup=1))
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, BF16[2])).astype(np.int32))
             for k in ("tokens", "targets")}

    def fresh():
        return get_model(cfg, "cpu", generator=torch.Generator().manual_seed(3))

    model = fresh()
    state = place_train_state(model, init_train_state(model, tcfg), mesh)
    out = dict(metrics=_floats(make_mesh_train_step(model, tcfg, mesh)(state, batch)))
    whole = SH.gather_tree(dict(state["params"]))
    if not lead:
        return out
    out["params"] = {k: v.float().numpy() for k, v in whole.items()}
    single = dataclasses.replace(tcfg, accum=MESH.shape["data"])
    for key, split in (("split", True), ("plain", False)):
        model = fresh()
        opt = init_train_state(model, single)
        with chip_smoke.split_products(MESH.shape["model"]) if split else contextlib.nullcontext():
            m = _floats(make_train_step(model, single)(opt, batch))
        out[key] = dict(metrics=m, params={k: p.detach().float().numpy()
                                           for k, p in model.named_parameters()})
    return out


def _rank(mesh, tmp: str):
    """Every case on this rank; the whole parameters on rank 0 only."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.serve.mesh import MeshServer
    from repro_torch.train import make_mesh_train_step, place_train_state

    params = _load(tmp, "params.pkl")
    lead = dist.get_rank() == 0
    mesh = make_debug_mesh(2, 2, "cpu")
    out = {"train": {}, "serve": {}}
    for name in TRAIN:
        cfg, model = _model(name, params)
        tcfg = _tcfg(name)
        state = place_train_state(model, init_train_state(model, tcfg), mesh)
        step = make_mesh_train_step(model, tcfg, mesh)
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
        with SH.counting() as coll:
            metrics = _floats(step(state, batch))
        whole = SH.gather_tree(dict(state["params"]))
        out["train"][name] = dict(metrics=metrics, coll=dict(coll.bytes),
                                  params={k: v.numpy() for k, v in whole.items()} if lead else None)
    out["bf16"] = _bf16_steps(mesh, lead)
    for name in SERVE:
        cfg, model = _model(f"serve_{name}", params)
        srv = MeshServer(model, mesh)
        prompt = torch.from_numpy(_prompt(cfg))
        toks, logits = srv.generate(prompt, steps=STEPS, s_cache=S_CACHE, return_logits=True)
        res = dict(tokens=toks.numpy(), logits=logits.numpy(), kv=srv.kv, coll={})
        for s_cache in (S_CACHE, 2 * S_CACHE):
            with SH.counting() as pre:
                _, caches = srv.prefill({"tokens": prompt}, s_cache)
            with SH.counting() as dec:
                srv.decode_step(caches, prompt[srv_slice(mesh, srv.dims), -1])
            res["coll"][s_cache] = (dict(pre.bytes), dict(dec.bytes))
        res["cache_bytes"] = sum(t.numel() * t.element_size() for c in caches["layers"]
                                 for t in c.values())
        out["serve"][name] = res
    return out


def srv_slice(mesh, dims):
    """This rank's rows of a batch split over the mesh dims ``dims``."""
    n, i = 1, 0
    coord = mesh.get_coordinate()
    for d in dims:
        n, i = n * mesh.size(d), i * mesh.size(d) + coord[d]
    rows = SERVE_B // n
    return slice(i * rows, (i + 1) * rows)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's results and the ranks' (run side by side)."""
    pytest.importorskip("jax")
    tmp = str(tmp_path_factory.mktemp("tp"))
    spec = {
        "models": _models(), "lr": LR, "s_cache": S_CACHE, "steps": STEPS,
        "train": {name: (name, opt, _batch(_cfg(arch, over)))
                  for name, (arch, over, opt) in TRAIN.items()},
        "serve": {name: (f"serve_{name}", _prompt(_cfg(*v))) for name, v in SERVE.items()},
    }
    with open(os.path.join(tmp, "spec.pkl"), "wb") as f:
        pickle.dump(spec, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, os.path.join(tmp, "spec.pkl"), tmp],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    box = {}

    def ranks():
        try:
            box["ranks"] = spawn_reducers(_rank, P, device_type="cpu", args=(tmp,))
        except Exception as e:  # raised below, in the test's thread
            box["error"] = e

    spawner = threading.Thread(target=ranks)
    spawner.start()
    try:
        _, err = ref.communicate(timeout=WAIT_S)
    finally:
        spawner.join()
    assert ref.returncode == 0, err[-4000:]
    if "error" in box:
        raise box["error"]
    return dict(tmp=tmp, params=_load(tmp, "params.pkl"), ref=_load(tmp, "reference.pkl"),
                ranks=box["ranks"])


@pytest.fixture(scope="module")
def single(world):
    """The port's single process: one train step of each case (the dense
    cases' two microbatches the mesh's data slices), each serving case's
    greedy tokens and logits."""
    out = {"train": {}, "serve": {}}
    for name in TRAIN:
        cfg, model = _model(name, world["params"])
        tcfg = _tcfg(name, accum=1 if cfg.n_experts else MESH.shape["data"])
        opt = init_train_state(model, tcfg)
        m = _floats(make_train_step(model, tcfg)(opt, {k: torch.from_numpy(v)
                                                       for k, v in _batch(cfg).items()}))
        out["train"][name] = dict(metrics=m, params={k: p.detach().numpy().copy()
                                                     for k, p in model.named_parameters()})
    for name in SERVE:
        cfg, model = _model(f"serve_{name}", world["params"])
        toks, logits = generate(model, torch.from_numpy(_prompt(cfg)), steps=STEPS,
                                s_cache=S_CACHE, return_logits=True)
        out["serve"][name] = dict(tokens=toks.numpy(), logits=logits.numpy())
    return out


def _same_metrics(got, want):
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4)
    assert got["step"] == want["step"]
    for k in STATS:
        if f"moe_{k}" in want:
            assert got[f"moe_{k}"] == want[f"moe_{k}"], k


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


@pytest.mark.parametrize("name", list(TRAIN))
def test_partitioned_step_matches_the_reference_and_the_single_process(world, single, name):
    """Every rank's metrics equal the reference's sharded step's and the
    single process'; rank 0's gathered parameters equal both."""
    arch, over, _ = TRAIN[name]
    want_ref = world["ref"]["train"][name]
    ref_params = {k: v.numpy() for k, v in
                  lm_params_from_numpy(_cfg(arch, over), want_ref["params"]).items()}
    for rank in world["ranks"]:
        got = rank["train"][name]["metrics"]
        _same_metrics(got, single["train"][name]["metrics"])
        _same_metrics(got, want_ref["metrics"])
    got = world["ranks"][0]["train"][name]["params"]
    _close_states(got, single["train"][name]["params"])
    _close_states(got, ref_params)


def test_bf16_step_equals_the_split_single_process(world):
    """In bf16 the mesh's row-parallel products sum in another order than
    the single process' one product a weight, which rounds some of the
    first step's parameters 2 lr the other way.  The single process whose
    gated MLP products split on the mesh's two model shards as the mesh
    splits them (``chip_smoke.split_products``) takes the same step: every
    rank's metrics and rank 0's parameters equal, bit for bit."""
    ranks = world["ranks"]
    want = ranks[0]["bf16"]["split"]
    for rank in ranks:
        assert rank["bf16"]["metrics"] == want["metrics"]
    got = ranks[0]["bf16"]["params"]
    assert set(got) == set(want["params"])
    for k, v in want["params"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    plain = ranks[0]["bf16"]["plain"]["params"]
    assert any(not np.array_equal(got[k], v) for k, v in plain.items())


def test_moe_layouts_drop_the_whole_batchs_pairs(world, single):
    """Both MoE layouts drop pairs, and exactly the single process' count
    (grok's FF split and kimi's expert parallelism alike)."""
    for name in ("grok_ff", "kimi_ep"):
        want = single["train"][name]["metrics"]
        for rank in world["ranks"]:
            assert rank["train"][name]["metrics"]["moe_dropped"] == want["moe_dropped"]
    assert sum(single["train"][n]["metrics"]["moe_dropped"] for n in ("grok_ff", "kimi_ep")) > 0


@pytest.mark.parametrize("name", list(SERVE))
def test_mesh_generate_matches_the_reference_and_the_single_process(world, single, name):
    """Greedy tokens of the whole batch on every rank equal the
    reference's sharded prefill and decode and the single process';
    logits within ``LOGIT_REL`` of the largest."""
    want = world["ref"]["serve"][name]
    mine = single["serve"][name]
    assert world["ranks"][0]["serve"][name]["kv"] == ("heads" if name == "heads" else ("seq", S_CACHE))
    for rank in world["ranks"]:
        got = rank["serve"][name]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["tokens"], mine["tokens"])
        for other in (want["logits"], mine["logits"]):
            assert np.abs(got["logits"] - other).max() <= LOGIT_REL * np.abs(other).max()


@pytest.mark.parametrize("name", list(SERVE))
def test_decode_moves_no_cache_bytes(world, name):
    """A decode step's collectives (and a prefill's) are the same over a
    cache twice as long, and their bytes are under one rank's cache."""
    for rank in world["ranks"]:
        coll = rank["serve"][name]["coll"]
        assert coll[S_CACHE] == coll[2 * S_CACHE]
        assert sum(coll[S_CACHE][1].values()) < rank["serve"][name]["cache_bytes"]


def test_counter_equals_the_fake_pg_trace(world):
    """Rank 0's collective bytes by kind and axis in a train step (every
    case), a prefill and a decode step equal those of rank 0's ``meta``
    trace of the same cell under a fake process group."""
    ranks = world["ranks"]
    for name, (arch, over, _) in TRAIN.items():
        t = D.mesh_trace(arch, "train_4k", MESH, dict(cfg=_cfg(arch, over), batch=B, seq=S,
                                                       tcfg=_tcfg(name)))
        assert t["coll"].bytes == ranks[0]["train"][name]["coll"], name
    for name, (arch, over) in SERVE.items():
        cfg = _cfg(arch, over)
        pre, dec = ranks[0]["serve"][name]["coll"][S_CACHE]
        t = D.mesh_trace(arch, "prefill_32k", MESH, dict(cfg=cfg, batch=SERVE_B, seq=SERVE_S))
        assert t["coll"].bytes == pre, name
        t = D.mesh_trace(arch, "decode_32k", MESH, dict(cfg=cfg, batch=SERVE_B, seq=S_CACHE))
        assert t["coll"].bytes == dec, name


def test_data_only_trace_flops_are_the_one_card_flops_split():
    """On ``(2, 1)`` each rank's flops are half the one-card step's for a
    dense model.  A MoE layer's experts run the whole batch's capacity on
    every data rank (its capacity and drops are the whole batch's), so
    grok's two ranks count more than the one card."""
    flops = {}
    for name in ("q_split", "grok_ff"):
        arch, over, _ = TRAIN[name]
        ov = dict(cfg=_cfg(arch, over), batch=B, seq=S, tcfg=_tcfg(name))
        one = D.run_cell(arch, "train_4k", dict(ov), max_batch=False)["cost"]["flops"]
        t = D.mesh_trace(arch, "train_4k", MeshShape(("data", "model"), (2, 1)), dict(ov))
        flops[name] = (t["flops"] * 2, one)
    assert flops["q_split"][0] == flops["q_split"][1]
    assert flops["grok_ff"][0] > flops["grok_ff"][1]


def test_per_device_peak_is_below_the_whole_parameters():
    """grok-1 at full width, 2 of its 64 layers, AdamW, 16 x 128 tokens,
    on the production ``(16, 16)`` mesh: rank 0's reckoned peak against
    the whole parameters' bytes that the step before gathered onto every
    rank (``pytest -s`` prints both)."""
    cfg = dataclasses.replace(get_config("grok-1-314b"), n_layers=2)
    tcfg = TrainConfig(opt=OptConfig(kind="adamw", moments_dtype="bfloat16"), remat=True)
    rec = D.mesh_cell("grok-1-314b", "train_4k", "single",
                      dict(cfg=cfg, batch=16, seq=128, tcfg=tcfg))
    whole = sum(p.numel() * p.element_size() for p in get_model(cfg, "meta").parameters())
    peak = rec["memory"]["peak_bytes_per_device"]
    print(f"\ngrok-1 (2 layers) per-device peak {peak} bytes; whole parameters {whole} bytes")
    assert rec["status"] == "ok" and 0 < peak < whole
    assert rec["roofline"]["collective_s"] > 0
