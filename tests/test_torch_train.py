"""The port's LM training path on the CPU against the JAX package.

Reduced configurations in f32 (``reduced_config`` is f32 already), the
reference's ``DecoderLM.init`` params carried into the port by
``interop.lm_params_from_numpy``, batches made with numpy from a seed:

- ``DecoderLM.loss`` and every parameter's gradient against
  ``jax.value_and_grad(model.loss)`` (loss rtol 1e-5; grads atol 1e-5,
  rtol 1e-4: f32 on both sides, products and reductions in another order);
- AdamW (f32 and bf16 moments) and Adafactor fed the same numpy
  gradients: parameters and state after three updates within 1e-6 with
  f32 moments; with bf16 moments a moment on a bf16 rounding boundary may
  round one bf16 ulp apart (a relative 2**-7), which then moves its
  parameter by up to lr x that, so those are held to one ulp and 1e-5;
- ``schedule``, ``clip_by_global_norm``, ``codec_roundtrip`` and
  ``int8_allreduce`` against the reference (1e-6);
- whole train steps: accum 1 and 4 and ``compress_grads`` against the
  reference's step (the grads' tolerance on all but 1e-3 of the
  elements: see ``STEP_LR``), ``accum=4`` against ``accum=1`` in the port
  (the reference test's own tolerance), a moe-metrics step;
- ``fit_batch_to_world`` and ``HeartbeatMonitor`` equal to the reference's;
- checkpoints written by each package and restored by the other
  (``interop.checkpoint_from_reference`` / ``checkpoint_to_reference``)
  bit for bit, then one more step as a whole step is held; bf16 leaves by
  their bits both ways;
- ``launch/train.py --reduced --device cpu`` with ``--ckpt`` and
  ``--resume``.

The reference's params and steps are shared through module-scoped
fixtures.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_model as jget_model  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train import elastic as jelastic  # noqa: E402
from repro.train import optim as joptim  # noqa: E402

from repro_torch.configs import get_config, get_model, reduced_config  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    checkpoint_from_reference,
    checkpoint_to_reference,
    lm_params_from_numpy,
    train_state_from_numpy,
)
from repro_torch.train import OptConfig, TrainConfig, init_train_state, make_train_step  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import compression as comp  # noqa: E402
from repro_torch.train import elastic  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.step import load_state_tree, state_tree  # noqa: E402

LOSS_TOL = dict(rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
OPT_TOL = dict(atol=1e-6, rtol=1e-6)
# whole steps, at the reference accumulation test's rate: a first AdamW
# step moves each parameter by about lr * g / (|g| + eps), so a gradient
# element near zero, whose last bits differ between the packages, moves
# its parameter by up to 2 lr; and the int8 codec sends a gradient on a
# rounding boundary one quantum (max |g| / 127) either way.  So a step is
# held to GRAD_TOL on all but 1e-3 of the elements (parameters and state
# together; one or two in ~6e4 here), and those to 2 lr
STEP_LR = 1e-3
STEP_FEW = (1e-3, 2 * STEP_LR + 1e-5)
B, S = 4, 16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, seed: int, b: int = B, s: int = S):
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, cfg.vocab, (b, s)).astype(np.int32) for k in ("tokens", "targets")}
    if cfg.rope == "mrope":
        text = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
        batch["pos"] = np.stack([text, rng.integers(0, 6, (b, s)), rng.integers(0, 6, (b, s))]
                                ).astype(np.int32)
    return batch


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


class Ref:
    """One reduced architecture in both packages, from the same params."""

    def __init__(self, arch: str):
        self.jcfg = jreduced(jget_config(arch))
        self.cfg = reduced_config(get_config(arch))
        self.jm = jget_model(self.jcfg)
        self.params = self.jm.init(jax.random.PRNGKey(0))
        self.tree = _np(self.params)

    def port(self):
        model = get_model(self.cfg, "cpu")
        model.load_state_dict(lm_params_from_numpy(self.cfg, self.tree))
        return model


@pytest.fixture(scope="module")
def refs():
    return {a: Ref(a) for a in ("smollm-360m", "gemma2-9b", "qwen2-vl-2b")}


def _assert_state(model, opt_state, ptree, stree, cfg, tol, few=None):
    """Parameters and optimizer state against the reference's trees.
    ``few = (share, bound)``: all but ``share`` of the elements within
    ``tol``, and those within ``bound`` (see STEP_LR)."""
    want_p, want_s = train_state_from_numpy(cfg, ptree, stree)
    assert int(opt_state["step"]) == int(want_s["step"])
    flat = ckpt._flatten_with_names({k: v for k, v in opt_state.items() if k != "step"})
    want = ckpt._flatten_with_names({k: v for k, v in want_s.items() if k != "step"})
    assert set(flat) == set(want)
    pairs = [(k, p.detach(), want_p[k]) for k, p in model.named_parameters()]
    pairs += [(k, flat[k], want[k]) for k in flat]
    bad = total = 0
    for k, got, exp in pairs:
        got, exp = got.float().numpy(), exp.float().numpy()
        if few is None:
            np.testing.assert_allclose(got, exp, err_msg=k, **tol)
            continue
        bad += int((~np.isclose(got, exp, **tol)).sum())
        total += got.size
        assert np.abs(got - exp).max() <= few[1], k
    if few is not None:
        assert bad <= few[0] * total, (bad, total)


# ------------------------------------------------------------- loss, grads
@pytest.mark.parametrize("arch,remat", [("smollm-360m", True), ("gemma2-9b", False),
                                        ("qwen2-vl-2b", True)])
def test_loss_and_grads_match_reference(refs, arch, remat):
    r = refs[arch]
    batch = _batch(r.cfg, seed=5)
    want_l, want_g = jax.value_and_grad(r.jm.loss)(r.params, _jb(batch), remat=remat)
    want_g = lm_params_from_numpy(r.cfg, _np(want_g))
    model = r.port()
    model.requires_grad_(True)
    loss = model.loss(_tb(batch), remat=remat)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    np.testing.assert_allclose(loss.item(), float(want_l), **LOSS_TOL)
    for k, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want_g[k].numpy(), err_msg=k, **GRAD_TOL)
    # remat changes no value; loss_and_stats adds zero MoE counts
    model.zero_grad(set_to_none=True)
    l2, stats = model.loss_and_stats(_tb(batch), remat=not remat)
    assert l2.item() == pytest.approx(loss.item(), rel=1e-6)
    assert {k: int(v) for k, v in stats.items()} == {"routed": 0, "dropped": 0, "heavy": 0}


# -------------------------------------------------------------- optimizers
@pytest.mark.parametrize("kind,moments", [("adamw", "float32"), ("adamw", "bfloat16"),
                                          ("adafactor", "float32")])
def test_optimizer_matches_reference(refs, kind, moments):
    """gemma2's reduced config has two segments of two layers each, so the
    stacked-leaf rules (weight decay and Adafactor factoring of the
    layers' norm gains, one RMS clip over a segment's leaf) are met."""
    r = refs["gemma2-9b"]
    kw = dict(kind=kind, moments_dtype=moments, lr=1e-2, warmup=1)
    jcfg, cfg = joptim.OptConfig(**kw), OptConfig(**kw)
    model = r.port()
    params = dict(model.named_parameters())
    state = optim.opt_init(cfg, params, model.param_leaves())
    jp, js = r.params, joptim.opt_init(jcfg, r.params)
    jupd = jax.jit(lambda g, s, p: joptim.opt_update(jcfg, g, s, p))
    rng = np.random.default_rng(7)
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32), r.tree)
        jp, js = jupd(g, js, jp)
        optim.opt_update(cfg, lm_params_from_numpy(r.cfg, g), state, params,
                         model.param_leaves())
    stree = jax.tree_util.tree_map(
        lambda a: np.asarray(a) if a.dtype == jnp.int32 else np.asarray(a, np.float32), js)
    if moments == "float32":
        _assert_state(model, state, _np(jp), stree, r.cfg, OPT_TOL)
    else:
        _assert_state(model, state, _np(jp), stree, r.cfg, dict(atol=1e-5, rtol=2**-7))


def test_schedule_clip_codec_allreduce_match_reference():
    cfg = OptConfig(lr=3e-3, warmup=10, decay_steps=100)
    jcfg = joptim.OptConfig(lr=3e-3, warmup=10, decay_steps=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        got = optim.schedule(cfg, torch.tensor(step, dtype=torch.int32)).item()
        want = float(joptim.schedule(jcfg, jnp.int32(step)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step
    rng = np.random.default_rng(3)
    tree = {"a": (rng.standard_normal((64, 32)) * 0.3).astype(np.float32),
            "b": (rng.standard_normal((4, 7, 5)) * 2.0).astype(np.float32),
            "c": (rng.standard_normal((9,)) * 0.01).astype(np.float32)}
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    for max_norm in (1.0, 1e3):
        got, gn = optim.clip_by_global_norm(tt, max_norm)
        want, wn = joptim.clip_by_global_norm({k: jnp.asarray(v) for k, v in tree.items()},
                                              max_norm)
        assert gn.item() == pytest.approx(float(wn), rel=1e-6)
        for k in tree:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **OPT_TOL)
    # the codec, one scale per tensor; then one scale over a stacked leaf
    got = comp.codec_roundtrip(tt)
    want = jcomp.codec_roundtrip({k: jnp.asarray(v) for k, v in tree.items()})
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **OPT_TOL)
    parts = {f"l{i}": torch.from_numpy(tree["b"][i]) for i in range(4)}
    got = comp.codec_roundtrip(parts, leaves=[(tuple(parts), True)])
    want = np.asarray(jcomp.codec_roundtrip({"b": jnp.asarray(tree["b"])})["b"])
    for i in range(4):
        np.testing.assert_allclose(got[f"l{i}"].numpy(), want[i], **OPT_TOL)
    q, scale = comp.quantize_int8(tt["a"])
    jq, jscale = jcomp.quantize_int8(jnp.asarray(tree["a"]))
    assert np.array_equal(q.numpy(), np.asarray(jq)) and scale.item() == pytest.approx(float(jscale))
    g = torch.Generator().manual_seed(0)
    qs, _ = comp.quantize_int8(tt["a"], generator=g)  # stochastic rounding: floor or ceil
    assert ((qs.float() - tt["a"] / scale).abs() <= 1.0).all()
    # int8 all-reduce over 8 shards on the leading axis, against the
    # reference's named-axis vmap
    xs = (rng.standard_normal((8, 128)) * 0.1).astype(np.float32)
    got = comp.int8_allreduce(torch.from_numpy(xs))
    want = jax.vmap(lambda x: jcomp.int8_allreduce(x, "dp"), axis_name="dp")(jnp.asarray(xs))
    assert got.shape == xs.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OPT_TOL)
    assert float((got[0] - torch.from_numpy(xs.mean(0))).abs().max()) < np.abs(xs).max() / 60


# -------------------------------------------------------------- train step
@pytest.fixture(scope="module")
def ref_steps(refs):
    """The reference's one step from its init on smollm's reduced config,
    per train config, and the batch."""
    r = refs["smollm-360m"]
    batch = _batch(r.cfg, seed=11)
    out = {}
    for name, kw in (("accum1", {}), ("accum4", dict(accum=4)),
                     ("compress", dict(compress_grads=True))):
        tcfg = JTrainConfig(opt=joptim.OptConfig(lr=STEP_LR, warmup=1), **kw)
        step = jax.jit(jmake_train_step(r.jm, tcfg))
        p, s, m = step(r.params, joptim.opt_init(tcfg.opt, r.params), _jb(batch))
        out[name] = (_np(p), _np(s), {k: float(v) for k, v in m.items()})
    return r, batch, out


@pytest.mark.parametrize("name", ["accum1", "accum4", "compress"])
def test_train_step_matches_reference(ref_steps, name):
    r, batch, out = ref_steps
    kw = {"accum1": {}, "accum4": dict(accum=4), "compress": dict(compress_grads=True)}[name]
    tcfg = TrainConfig(opt=OptConfig(lr=STEP_LR, warmup=1), **kw)
    model = r.port()
    state = init_train_state(model, tcfg)
    m = make_train_step(model, tcfg)(state, _tb(batch))
    ptree, stree, wm = out[name]
    assert m["loss"].item() == pytest.approx(wm["loss"], rel=1e-5)
    assert m["grad_norm"].item() == pytest.approx(wm["grad_norm"], rel=1e-4)
    assert int(m["step"]) == wm["step"] == 1
    _assert_state(model, state, ptree, stree, r.cfg, GRAD_TOL, STEP_FEW)


def test_accumulation_equivalence_and_moe_metrics(refs):
    """accum=4 against accum=1 in the port, at the reference test's
    tolerance (``test_train_substrate.py``); moe_metrics adds zero counts."""
    r = refs["qwen2-vl-2b"]  # (3, B, S) M-RoPE positions split on axis 1
    batch = _tb(_batch(r.cfg, seed=2))
    runs = []
    for accum, moe in ((1, False), (4, True)):
        tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup=1), accum=accum, moe_metrics=moe)
        model = r.port()
        state = init_train_state(model, tcfg)
        m = make_train_step(model, tcfg)(state, batch)
        runs.append((model, m))
    (m1, r1), (m4, r4) = runs
    np.testing.assert_allclose(r1["loss"].item(), r4["loss"].item(), rtol=1e-5)
    for (k, a), (_, b) in zip(m1.named_parameters(), m4.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=2e-5, rtol=2e-4,
                                   err_msg=k)
    assert {k: int(r4[f"moe_{k}"]) for k in ("routed", "dropped", "heavy")} == {
        "routed": 0, "dropped": 0, "heavy": 0}
    # eight steps on one fixed batch lower the loss (the reference test)
    model = r.port()
    tcfg = TrainConfig(opt=OptConfig(kind="adafactor", lr=1e-2, warmup=1))
    state = init_train_state(model, tcfg)
    step = make_train_step(model, tcfg)
    losses = [step(state, batch)["loss"].item() for _ in range(8)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_train_state_shapes_on_meta():
    from repro_torch.train import init_train_state_shapes

    cfg = get_config("smollm-360m")
    params, state = init_train_state_shapes(cfg, TrainConfig())
    assert sum(p.numel() for p in params.values()) == 361821120
    assert all(p.device.type == "meta" for p in params.values())
    assert state["m"]["embed.table"].shape == (cfg.vocab, cfg.d_model)
    assert state["step"].dtype == torch.int32


# --------------------------------------------------------------- elastic
def test_elastic_matches_reference(monkeypatch):
    for gb in (8, 64, 256, 96):
        for world in (1, 2, 4, 8, 16):
            for per in (1, 3, 4, 32):
                if gb % world:
                    with pytest.raises(ValueError):
                        elastic.fit_batch_to_world(gb, world, per)
                    continue
                got = elastic.fit_batch_to_world(gb, world, per)
                assert dataclasses.asdict(got) == dataclasses.asdict(
                    jelastic.fit_batch_to_world(gb, world, per))
    # the same clock for both monitors: ten 1 s steps, then a 5 s one
    ticks = iter([t for i in range(22) for t in (float(i), float(i) + (5.0 if i == 10 else 1.0))])
    clock = {"t": 0.0}
    monkeypatch.setattr("time.monotonic", lambda: clock["t"])
    mons = (elastic.HeartbeatMonitor(factor=2.0), jelastic.HeartbeatMonitor(factor=2.0))
    flags = ([], [])
    for _ in range(11):
        start, stop = next(ticks), next(ticks)
        for mon, fl in zip(mons, flags):
            clock["t"] = start
            mon.start()
            clock["t"] = stop
            fl.append(mon.stop())
    assert flags[0] == flags[1] and flags[0][-1] == (5.0, True) and not any(f for _, f in flags[0][:-1])
    with pytest.raises(RuntimeError):
        elastic.HeartbeatMonitor().stop()


# ------------------------------------------------------------ checkpoints
def test_checkpoint_from_reference_resumes(ref_steps, tmp_path):
    """The reference trains a step and saves; the port restores that
    checkpoint and takes the next step, which must equal the reference's
    next step."""
    r, batch, out = ref_steps
    tcfg = JTrainConfig(opt=joptim.OptConfig(lr=STEP_LR, warmup=1))
    step = jax.jit(jmake_train_step(r.jm, tcfg))
    p1, s1, _ = step(r.params, joptim.opt_init(tcfg.opt, r.params), _jb(batch))
    src, dst = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.save(src, 1, {"params": p1, "opt": s1}, extra={"next_step": 1})
    assert checkpoint_from_reference(r.cfg, src, dst) == 1
    model = get_model(r.cfg, "cpu")
    ptcfg = TrainConfig(opt=OptConfig(lr=STEP_LR, warmup=1))
    state = init_train_state(model, ptcfg)
    restored, extra = ckpt.restore(dst, state_tree(model, state))
    load_state_tree(model, state, restored)
    assert extra == {"next_step": 1} and ckpt.latest_step(dst) == 1
    _assert_state(model, state, _np(p1), _np(s1), r.cfg, dict(atol=0, rtol=0))
    batch2 = _batch(r.cfg, seed=12)
    p2, s2, m2 = step(p1, s1, _jb(batch2))
    m = make_train_step(model, ptcfg)(state, _tb(batch2))
    assert m["loss"].item() == pytest.approx(float(m2["loss"]), rel=1e-5)
    _assert_state(model, state, _np(p2), _np(s2), r.cfg, GRAD_TOL, STEP_FEW)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_checkpoint_to_reference_resumes(refs, tmp_path, kind):
    """The port trains a step and saves; the reference restores it (after
    ``checkpoint_to_reference``) and takes the next step, which must equal
    the port's next step.  gemma2's two segments stack back."""
    r = refs["gemma2-9b"]
    batch, batch2 = _batch(r.cfg, seed=21), _batch(r.cfg, seed=22)
    tcfg = TrainConfig(opt=OptConfig(kind=kind, lr=STEP_LR, warmup=1))
    model = r.port()
    state = init_train_state(model, tcfg)
    step = make_train_step(model, tcfg)
    step(state, _tb(batch))
    src, dst = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save(src, 1, state_tree(model, state), extra={"next_step": 1})
    assert checkpoint_to_reference(r.cfg, src, dst) == 1
    jt = JTrainConfig(opt=joptim.OptConfig(kind=kind, lr=STEP_LR, warmup=1))
    like = {"params": r.params, "opt": joptim.opt_init(jt.opt, r.params)}
    restored, extra = jckpt.restore(dst, like)
    assert extra == {"next_step": 1}
    _assert_state(model, state, _np(restored["params"]), _np(restored["opt"]), r.cfg,
                  dict(atol=0, rtol=0))
    p2, s2, m2 = jax.jit(jmake_train_step(r.jm, jt))(restored["params"], restored["opt"],
                                                     _jb(batch2))
    m = step(state, _tb(batch2))
    assert m["loss"].item() == pytest.approx(float(m2["loss"]), rel=1e-5)
    _assert_state(model, state, _np(p2), _np(s2), r.cfg, GRAD_TOL, STEP_FEW)


def test_checkpoint_bf16_leaves_by_their_bits(tmp_path):
    """bf16 both ways: the reference's bf16 leaves (saved through
    ml_dtypes) restore in the port bit for bit, and the port's bf16 file
    holds the reference's bytes.  The reference cannot restore a bf16 leaf
    at all, its own included (numpy has no cast from the stored two-byte
    void to bfloat16): a reference fault (ROADMAP C), pinned here."""
    jcfg = dataclasses.replace(jreduced(jget_config("smollm-360m")), dtype="bfloat16")
    cfg = dataclasses.replace(reduced_config(get_config("smollm-360m")), dtype="bfloat16")
    params = jget_model(jcfg).init(jax.random.PRNGKey(0))
    st = joptim.opt_init(joptim.OptConfig(moments_dtype="bfloat16"), params)
    st = jax.tree_util.tree_map(lambda a: a + jnp.asarray(0.5, a.dtype) if a.ndim else a, st)
    src, dst = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.save(src, 3, {"params": params, "opt": st})
    checkpoint_from_reference(cfg, src, dst)
    model = get_model(cfg, "cpu", generator=torch.Generator().manual_seed(1))
    state = optim.opt_init(OptConfig(moments_dtype="bfloat16"), dict(model.named_parameters()))
    restored, _ = ckpt.restore(dst, state_tree(model, state))
    want_p, want_s = train_state_from_numpy(
        cfg, jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)), params),
        jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)) if a.ndim else
                               np.asarray(a), st))
    for k, t in restored["params"].items():
        assert t.dtype == torch.bfloat16 and torch.equal(t.float(), want_p[k]), k
    for k, t in restored["opt"]["m"].items():
        assert t.dtype == torch.bfloat16 and torch.equal(t.float(), want_s["m"][k]), k
    # the port's bf16 file: the same bytes as the reference's, dtype named
    load_state_tree(model, state, restored)
    out = str(tmp_path / "port2")
    ckpt.save(out, 3, state_tree(model, state))
    back = str(tmp_path / "ref2")
    checkpoint_to_reference(cfg, out, back)
    with np.load(os.path.join(src, "step_00000003", "arrays.npz")) as a, \
            np.load(os.path.join(back, "step_00000003", "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes() and a[k].shape == b[k].shape, k
    with open(os.path.join(out, "step_00000003", "manifest.json")) as f:
        assert json.load(f)["dtypes"]["params/embed.table"] == "bfloat16"
    with pytest.raises(ValueError, match="cast"):
        jckpt.restore(src, {"params": params, "opt": st})


# ----------------------------------------------------------------- launch
def test_train_cli_checkpoints_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train

    d = str(tmp_path / "run")
    base = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "16", "--ckpt", d]
    first = train.main(base + ["--steps", "3", "--ckpt_every", "2"])
    assert ckpt.latest_step(d) == 3 and os.path.isdir(os.path.join(d, "step_00000002"))
    again = train.main(base + ["--steps", "5", "--resume"])
    assert again["start"] == 3 and len(again["losses"]) == 2
    out = capsys.readouterr().out
    assert "[resume] from step 3" in out and out.count("[done]") == 2
    assert "step     4 loss" in out and "gnorm" in out and "ms" in out
    assert all(np.isfinite(first["losses"] + again["losses"]))
    # the resumed run's parameters are the checkpoint's plus two steps
    fresh = get_model(first["model"].cfg, "cpu")
    st = init_train_state(fresh, TrainConfig())
    restored, extra = ckpt.restore(d, state_tree(fresh, st))
    assert extra == {"next_step": 5}
    for k, p in again["model"].named_parameters():
        assert torch.equal(p.detach(), restored["params"][k]), k
