"""The port's Mamba2 block (chunked SSD) and zamba2's hybrid model on the
CPU against the JAX package.

Reduced zamba2-7b (two Mamba2 layers, then the shared attention block at
two positions; d_in 128 in two heads of 64, state 16, chunk 16) in f32:
the reference's ``DecoderLM.init`` params go through
``interop.lm_params_from_numpy`` into the port, and the same numpy inputs
go through both.  Tolerance 1e-4 abs + 1e-4 rel (f32 on both sides, the
products and reductions in another order), gradients 1e-5 abs + 1e-4 rel
as ``tests/test_torch_train.py``.

- ``ssd_chunked`` with and without ``init_state`` at S = 37 (padded to
  three chunks), and one ``mamba_decode`` step from a nonzero state;
- full logits at S = 37; a 30-token prefill and four teacher-forced
  ``decode_step``s with every cache leaf (``conv``, ``ssm``, ``k``,
  ``v``); eight greedy ``generate`` tokens, equal exactly;
- the loss and every gradient, the shared block's summed over its
  positions; one AdamW train step against the reference's (the shared
  block's leaf unstacked); checkpoints both ways;
- the shared block held once; the full-width models' parameter counts;
- the reference's own teacher-forced consistency check
  (``tests/test_arch_smoke.py``) on the port;
- a prompt shorter than the conv's tail: the reference's next decode
  raises, the port's equals decoding the prompt a token at a time;
- ``launch/serve.py --arch zamba2-7b``.

The reference's results are computed once (module-scoped fixture).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_model as jget_model  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serve.decode import generate as jgenerate  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro.train import optim as joptim  # noqa: E402

from repro_torch.configs import get_config, get_model, make_smoke_batch, reduced_config  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    checkpoint_from_reference, checkpoint_to_reference, lm_params_from_numpy,
    train_state_from_numpy,
)
from repro_torch.models import ssm  # noqa: E402
from repro_torch.serve.decode import generate  # noqa: E402
from repro_torch.train import OptConfig, TrainConfig, init_train_state, make_train_step  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.step import load_state_tree, state_tree  # noqa: E402

ARCH = "zamba2-7b"
TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
STEP_LR = 1e-3
STEP_FEW = (1e-3, 2 * STEP_LR + 1e-5)  # tests/test_torch_train.py's step rule
B, S, P, STEPS = 2, 37, 30, 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(cfg, seed, b=B, s=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def ref_layer_caches(cfg, caches):
    """The reference's caches (one stacked dict a segment) as one dict of
    numpy arrays a layer, in the port's layer order."""
    out = []
    for (_, count), seg in zip(cfg.segments(), caches["segments"]):
        out += [{k: np.asarray(v[i]) for k, v in seg.items()} for i in range(count)]
    return out


def assert_caches(cfg, got, want_caches):
    want = ref_layer_caches(cfg, want_caches)
    assert len(got["layers"]) == len(want) == cfg.n_layers
    assert got["len"] == int(want_caches["len"])
    for j, (g, w) in enumerate(zip(got["layers"], want)):
        assert set(g) == set(w), (j, set(g), set(w))
        for key in w:
            np.testing.assert_allclose(g[key].numpy(), w[key], err_msg=f"layer {j} {key}", **TOL)


@pytest.fixture(scope="module")
def zamba():
    """Reduced zamba2: the reference's params, logits, prefill and decode
    caches, greedy tokens, gradients and one AdamW step."""
    jcfg, cfg = jreduced(jget_config(ARCH)), reduced_config(get_config(ARCH))
    assert cfg.pattern == jcfg.pattern == ("mamba", "mamba", "shared_attn", "shared_attn")
    jm = jget_model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    out = {"jcfg": jcfg, "cfg": cfg, "jm": jm, "params": params, "tree": _np(params)}
    toks = _tokens(cfg, seed=1)
    out["tokens"] = toks
    out["logits"] = np.asarray(jax.jit(jm.logits)(params, jnp.asarray(toks)))
    lg, c = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :P])}, s_cache=S)
    steps = [(np.asarray(lg), _np(c))]
    step = jax.jit(jm.decode_step)
    for t in range(4):
        lg, c = step(params, c, jnp.asarray(toks[:, P + t]))
        steps.append((np.asarray(lg), _np(c)))
    out["steps"] = steps
    prompt = toks[:, :P]  # the prefill's shapes: its op-by-op compiles are reused
    jt, jl = jgenerate(jm, params, jnp.asarray(prompt), steps=STEPS, s_cache=S,
                       return_logits=True)
    out["gen"] = (prompt, np.asarray(jt), np.asarray(jl))
    batch = {"tokens": _tokens(cfg, seed=3, s=32), "targets": _tokens(cfg, seed=4, s=32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(params, jb)
    out["batch"], out["grads"] = batch, (float(loss), _np(grads))
    opt = joptim.OptConfig(lr=STEP_LR, warmup=1)
    p1, s1, m = jax.jit(jmake_train_step(jm, JTrainConfig(opt=opt)))(
        params, joptim.opt_init(opt, params), jb)
    out["step"] = (p1, s1, {k: float(v) for k, v in m.items()})
    return out


def _port(z, cfg=None):
    cfg = cfg or z["cfg"]
    model = get_model(cfg, "cpu")
    model.load_state_dict(lm_params_from_numpy(cfg, z["tree"]))
    return model


def _load(p, tree):
    """Copy a reference parameter subtree into a port ``ParameterDict``."""
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(np.array(tree[name])))
    return p


# ------------------------------------------------------------- the block
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(with_state):
    """S = 37 at chunk 16 (padded to 48), with and without a carried state."""
    rng = np.random.default_rng(5)
    b, s, h, p, n = 2, S, 3, 8, 5
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = (-np.exp(0.5 * rng.standard_normal(h))).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    st = rng.standard_normal((b, h, p, n)).astype(np.float32) if with_state else None
    wy, ws = jax.jit(jssm.ssd_chunked, static_argnums=5)(
        *(jnp.asarray(t) for t in (x, dt, a, bm, cm)), 16, None if st is None else jnp.asarray(st))
    gy, gs = ssm.ssd_chunked(*(torch.from_numpy(t) for t in (x, dt, a, bm, cm)), 16,
                             None if st is None else torch.from_numpy(st))
    assert gy.shape == (b, s, h, p) and gs.shape == (b, h, p, n)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)


def test_mamba_decode_from_a_nonzero_state(zamba):
    cfg, jcfg = zamba["cfg"], zamba["jcfg"]
    jp = jax.jit(jssm.init_mamba, static_argnums=1)(jax.random.PRNGKey(7), jcfg)
    p = _load(ssm.init_mamba(torch.Generator().manual_seed(0), cfg), _np(jp))
    rng = np.random.default_rng(8)
    d_in, h, hp, n = ssm._dims(cfg)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    st = {"conv": rng.standard_normal((B, cfg.conv_kernel - 1, d_in + 2 * n)).astype(np.float32),
          "ssm": rng.standard_normal((B, h, hp, n)).astype(np.float32)}
    wy, ws = jax.jit(jssm.mamba_decode, static_argnums=3)(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()}, jcfg)
    gy, gs = ssm.mamba_decode(p, torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in st.items()},
                              cfg)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **TOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(gs[k].numpy(), np.asarray(ws[k]), err_msg=k, **TOL)
    assert (h, hp, n) == (2, 64, 16)


def test_init_constants_and_dtypes_match_reference():
    """Every leaf's shape and dtype in a bf16 model as the reference's
    (``a_log``, ``dt_bias``, ``d_skip`` stay f32), and those three equal to
    the reference's constants."""
    jcfg = dataclasses.replace(jreduced(jget_config(ARCH)), dtype="bfloat16")
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)), dtype="bfloat16")
    jp = jax.jit(jssm.init_mamba, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    p = ssm.init_mamba(torch.Generator().manual_seed(0), cfg)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in p.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in jp.items()}
    for k in ("a_log", "dt_bias", "d_skip"):
        assert p[k].dtype == torch.float32, k
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp[k]), err_msg=k)


# ------------------------------------------------------------- the model
def test_full_logits_match_reference(zamba):
    model = _port(zamba)
    got = model.logits(torch.from_numpy(zamba["tokens"]))
    np.testing.assert_allclose(got.numpy(), zamba["logits"], **TOL)


def test_prefill_and_teacher_forced_decode_match_reference(zamba):
    """Logits and every cache leaf after the 30-token prefill and each of
    four decode steps."""
    cfg, toks = zamba["cfg"], zamba["tokens"]
    model = _port(zamba)
    lg, c = model.prefill({"tokens": torch.from_numpy(toks[:, :P])}, s_cache=S)
    for t, (want_l, want_c) in enumerate(zamba["steps"]):
        if t:
            lg, c = model.decode_step(c, torch.from_numpy(toks[:, P + t - 1]))
        np.testing.assert_allclose(lg.numpy(), want_l, err_msg=f"step {t}", **TOL)
        assert_caches(cfg, c, want_c)
    assert c["len"] == P + 4
    assert tuple(c["layers"][0]["conv"].shape) == (B, 3, 2 * 64 + 2 * 16)
    assert tuple(c["layers"][3]["k"].shape) == (B, cfg.n_kv_heads, S, cfg.hd)
    # teacher-forced decode reproduces the full forward
    np.testing.assert_allclose(lg.numpy(), zamba["logits"][:, P + 3], **TOL)


def test_greedy_generate_matches_reference(zamba):
    prompt, want_t, want_l = zamba["gen"]
    toks, lg = generate(_port(zamba), torch.from_numpy(prompt), steps=STEPS, s_cache=S,
                        return_logits=True)
    np.testing.assert_array_equal(toks.numpy(), want_t)
    np.testing.assert_allclose(lg.numpy(), want_l, **TOL)


def test_loss_and_grads_match_reference(zamba):
    """Every gradient, the shared block's the sum over its two positions."""
    want_l, want_g = zamba["grads"]
    want_g = lm_params_from_numpy(zamba["cfg"], want_g)
    model = _port(zamba)
    model.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in zamba["batch"].items()}
    loss = model.loss(batch)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    np.testing.assert_allclose(loss.item(), want_l, rtol=1e-5)
    assert set(names) == set(want_g)
    for k, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want_g[k].numpy(), err_msg=k, **GRAD_TOL)
    assert float(dict(zip(names, grads))["shared_attn.attn.wq"].abs().max()) > 0


def _assert_step(model, state, ptree, stree, cfg):
    """Parameters and AdamW state against the reference's trees: all but
    ``STEP_FEW[0]`` of the elements within GRAD_TOL, those within
    ``STEP_FEW[1]``."""
    want_p, want_s = train_state_from_numpy(cfg, ptree, stree)
    assert int(state["step"]) == int(want_s["step"])
    pairs = [(k, p.detach(), want_p[k]) for k, p in model.named_parameters()]
    for part in ("m", "v"):
        assert set(state[part]) == set(want_s[part])
        pairs += [(k, state[part][k], want_s[part][k]) for k in want_s[part]]
    bad = total = 0
    for k, got, exp in pairs:
        got, exp = got.float().numpy(), exp.float().numpy()
        bad += int((~np.isclose(got, exp, **GRAD_TOL)).sum())
        total += got.size
        assert np.abs(got - exp).max() <= STEP_FEW[1], k
    assert bad <= STEP_FEW[0] * total, (bad, total)


def test_adamw_train_step_matches_reference(zamba):
    """The shared block is one unstacked leaf, as in the reference: its
    norm gains take no weight decay though the block has two positions."""
    p1, s1, wm = zamba["step"]
    tcfg = TrainConfig(opt=OptConfig(lr=STEP_LR, warmup=1))
    model = _port(zamba)
    leaves = dict((names[0], (names, st)) for names, st in model.param_leaves())
    assert leaves["shared_attn.attn.ln"] == (("shared_attn.attn.ln",), False)
    assert leaves["layers.0.mamba.a_log"] == (("layers.0.mamba.a_log", "layers.1.mamba.a_log"), True)
    state = init_train_state(model, tcfg)
    batch = {k: torch.from_numpy(v) for k, v in zamba["batch"].items()}
    m = make_train_step(model, tcfg)(state, batch)
    assert m["loss"].item() == pytest.approx(wm["loss"], rel=1e-5)
    assert m["grad_norm"].item() == pytest.approx(wm["grad_norm"], rel=1e-4)
    _assert_step(model, state, _np(p1), _np(s1), zamba["cfg"])


def test_checkpoint_from_reference_gives_the_same_logits(zamba, tmp_path):
    """The reference's step-1 state restores in the port bit for bit and
    gives the reference's logits."""
    cfg, jm = zamba["cfg"], zamba["jm"]
    p1, s1, _ = zamba["step"]
    src, dst = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.save(src, 1, {"params": p1, "opt": s1}, extra={"next_step": 1})
    assert checkpoint_from_reference(cfg, src, dst) == 1
    model = get_model(cfg, "cpu")
    state = init_train_state(model, TrainConfig(opt=OptConfig(lr=STEP_LR, warmup=1)))
    restored, extra = ckpt.restore(dst, state_tree(model, state))
    load_state_tree(model, state, restored)
    assert extra == {"next_step": 1}
    want_p, want_s = train_state_from_numpy(cfg, _np(p1), _np(s1))
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), want_p[k]), k
        assert torch.equal(state["v"][k], want_s["v"][k]), k
    toks = zamba["tokens"]
    want = np.asarray(jax.jit(jm.logits)(p1, jnp.asarray(toks)))
    np.testing.assert_allclose(model.logits(torch.from_numpy(toks)).numpy(), want, **TOL)


def test_checkpoint_to_reference_restores(zamba, tmp_path):
    """The port's state after a step, through ``checkpoint_to_reference``,
    restores in the reference bit for bit (the shared block as its one
    subtree, the placeholder segments keyless) and gives the port's
    logits there."""
    cfg = zamba["cfg"]
    tcfg = TrainConfig(opt=OptConfig(lr=STEP_LR, warmup=1))
    model = _port(zamba)
    state = init_train_state(model, tcfg)
    make_train_step(model, tcfg)(state, {k: torch.from_numpy(v) for k, v in zamba["batch"].items()})
    src, dst = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save(src, 1, state_tree(model, state), extra={"next_step": 1})
    assert checkpoint_to_reference(cfg, src, dst) == 1
    params = zamba["params"]
    like = {"params": params, "opt": joptim.opt_init(joptim.OptConfig(), params)}
    restored, extra = jckpt.restore(dst, like)
    assert extra == {"next_step": 1}
    want_p, want_s = train_state_from_numpy(cfg, _np(restored["params"]), _np(restored["opt"]))
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), want_p[k]), k
        assert torch.equal(state["m"][k], want_s["m"][k]), k
    toks = zamba["tokens"]
    want = np.asarray(jax.jit(zamba["jm"].logits)(restored["params"], jnp.asarray(toks)))
    np.testing.assert_allclose(model.logits(torch.from_numpy(toks)).numpy(), want, **TOL)


def test_placeholder_segment_inside_the_pattern(tmp_path):
    """A shared segment between two Mamba2 segments hides its layer count
    from a checkpoint's keys: ``checkpoint_from_reference`` maps every
    layer from the config, both ways."""
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)),
                              pattern=("mamba", "shared_attn", "mamba", "shared_attn"))
    jcfg = dataclasses.replace(jreduced(jget_config(ARCH)), pattern=cfg.pattern)
    params = jax.jit(jget_model(jcfg).init)(jax.random.PRNGKey(3))
    src = str(tmp_path / "ref")
    jckpt.save(src, 1, {"params": params})
    assert checkpoint_from_reference(cfg, src, str(tmp_path / "port")) == 1
    model = get_model(cfg, "cpu")
    restored, _ = ckpt.restore(str(tmp_path / "port"), {"params": model.state_dict()})
    want = lm_params_from_numpy(cfg, _np(params))
    assert set(restored["params"]) == set(want)
    assert all(torch.equal(restored["params"][k], want[k]) for k in want)
    assert "layers.2.mamba.w_in" in want and "layers.1.mamba.w_in" not in want
    model.load_state_dict(want)
    ckpt.save(str(tmp_path / "port2"), 1, {"params": model.state_dict()})
    checkpoint_to_reference(cfg, str(tmp_path / "port2"), str(tmp_path / "ref2"))
    back, _ = jckpt.restore(str(tmp_path / "ref2"), {"params": params})
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                 jax.tree_util.tree_flatten_with_path(params)[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


def test_the_shared_block_is_held_once(zamba):
    model = _port(zamba)
    names = [k for k, _ in model.named_parameters()]
    assert names == list(model.state_dict())
    shared = [k for k in names if k.startswith("shared_attn.")]
    assert sorted(shared) == sorted(f"shared_attn.{k}" for k in
                                    ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "attn.ln",
                                     "mlp.wi", "mlp.wg", "mlp.wo", "mlp.ln"))
    assert not any(k.startswith(("layers.2.", "layers.3.")) for k in names)
    assert model.layers[2].block is model.layers[3].block is model.shared_attn
    with torch.no_grad():  # one tensor: a change shows at every position
        model.shared_attn.mlp["wo"].zero_()
    assert float(model.layers[3].block.mlp["wo"].abs().max()) == 0.0


@pytest.mark.parametrize("arch,count", [("zamba2-7b", 6168027248), ("xlstm-125m", 147896904)])
def test_full_width_parameter_counts(arch, count):
    """On the meta device (no storage), equal to the reference's own."""
    model = get_model(get_config(arch), "meta")
    shapes = jax.eval_shape(lambda: jget_model(jget_config(arch)).init(jax.random.PRNGKey(0)))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == want == count


def test_teacher_forced_consistency_on_the_port():
    """``tests/test_arch_smoke.py::test_prefill_decode_consistency`` run
    on the port: its own init, batch 1, 12 tokens."""
    cfg = reduced_config(get_config(ARCH))
    model = get_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    toks = make_smoke_batch(cfg, torch.Generator().manual_seed(1), b=1, s=12)["tokens"]
    full = model.logits(toks)
    lg, c = model.prefill({"tokens": toks[:, :10]}, s_cache=14)
    np.testing.assert_allclose(lg.numpy(), full[:, 9].numpy(), rtol=2e-3, atol=2e-3)
    lg, c = model.decode_step(c, toks[:, 10])
    np.testing.assert_allclose(lg.numpy(), full[:, 10].numpy(), rtol=2e-3, atol=2e-3)


def test_short_prompt_keeps_a_zero_padded_conv_tail(zamba):
    """A 2-token prompt (the conv's tail is 3 rows): the reference's next
    decode raises; the port's equals decoding all three tokens one at a
    time from ``init_caches``, in the port and in the reference."""
    jm, params, cfg = zamba["jm"], zamba["params"], zamba["cfg"]
    toks = zamba["tokens"][:, :3]
    _, jc = jax.jit(jm.prefill, static_argnames="s_cache")(
        params, {"tokens": jnp.asarray(toks[:, :2])}, s_cache=8)
    assert np.asarray(jc["segments"][0]["conv"]).shape[2] == 2  # too few rows
    step = jax.jit(jm.decode_step)
    with pytest.raises((TypeError, ValueError)):
        step(params, jc, jnp.asarray(toks[:, 2]))
    jc = jm.init_caches(B, 8, 0)
    for t in range(3):
        want, jc = step(params, jc, jnp.asarray(toks[:, t]))
    model = _port(zamba)
    lg, c = model.prefill({"tokens": torch.from_numpy(toks[:, :2])}, s_cache=8)
    assert tuple(c["layers"][0]["conv"].shape) == (B, 3, 160)
    assert not c["layers"][0]["conv"][:, 0].any()  # the row before the prompt
    got, _ = model.decode_step(c, torch.from_numpy(toks[:, 2]))
    c = model.init_caches(B, 8, 0)
    for t in range(3):
        one, c = model.decode_step(c, torch.from_numpy(toks[:, t]))
    np.testing.assert_allclose(got.numpy(), one.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_serve_cli_on_zamba2(capsys):
    from repro_torch.launch import serve

    toks = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt", "10", "--steps", "3"])
    assert tuple(toks.shape) == (2, 3)
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "tok/s" in out and "prefill 2x10" in out
