"""The port's mLSTM and sLSTM blocks and xlstm-125m on the CPU against
the JAX package.

Reduced xlstm-125m (two mLSTM layers, then two sLSTM layers; d_model 64,
4 heads, chunk 16) in f32: the reference's ``DecoderLM.init`` params go
through ``interop.lm_params_from_numpy`` into the port, and the same
numpy inputs go through both.  Tolerance 1e-4 abs + 1e-4 rel (f32 on both
sides, the products and reductions in another order), gradients too: the
mLSTM's exponential input gate has no stabilizer, and the backward through
it amplifies f32 rounding (the largest difference, 5.04e-5 on a 1.47
gradient in the embedding table, is more the reference's than the port's:
an f64 run of the port sits 2.4e-5 from the port's f32 and 7.5e-5 from the
reference's), so the 1e-5 abs of ``tests/test_torch_train.py`` is too
tight here.

- ``mlstm_chunked`` at S = 48 (three chunks); 40 sLSTM cell steps; one
  ``mlstm_decode`` and one ``slstm_decode`` step from a nonzero state;
- full logits at S = 48; a 32-token prefill and four teacher-forced
  ``decode_step``s with every cache leaf (``c``, ``n``, ``h``, ``m``);
  eight greedy ``generate`` tokens, equal exactly;
- the loss and every gradient; one Adafactor train step against the
  reference's clip and update on those gradients (the sLSTM's stacked
  ``r`` is 4-D and factored), since the reference's own train step
  cannot run Adafactor here (a name clash, pinned below);
- the reference's own teacher-forced consistency check
  (``tests/test_arch_smoke.py``) on the port;
- a sequence longer than the chunk and off it: the reference raises (its
  gate padding), the port pads the gates and equals the reference run
  at a chunk that divides the sequence (S = 40 against chunk 8, and
  S = 37 in one chunk);
- ``launch/serve.py --arch xlstm-125m``.

S = 48 rather than a padded length against the reference, because the
reference cannot pad (above).  The reference's results are computed once
(module-scoped fixture).
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
from repro.models import xlstm as jxlstm  # noqa: E402
from repro.serve.decode import generate as jgenerate  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro.train import optim as joptim  # noqa: E402

from repro_torch.configs import get_config, get_model, make_smoke_batch, reduced_config  # noqa: E402
from repro_torch.interop import lm_params_from_numpy, train_state_from_numpy  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402
from repro_torch.serve.decode import generate  # noqa: E402
from repro_torch.train import OptConfig, TrainConfig, init_train_state, make_train_step  # noqa: E402
from repro_torch.train import optim  # noqa: E402

ARCH = "xlstm-125m"
TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
STEP_LR = 1e-3
STEP_FEW = (1e-3, 2 * STEP_LR + 1e-5)  # tests/test_torch_train.py's step rule
B, S, P, STEPS = 2, 48, 32, 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(cfg, seed, b=B, s=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _load(p, tree):
    """Copy a reference parameter subtree into a port ``ParameterDict``."""
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(np.array(tree[name])))
    return p


@pytest.fixture(scope="module")
def xl():
    """Reduced xlstm: the reference's params, logits, prefill and decode
    caches, greedy tokens, gradients and one Adafactor step."""
    jcfg, cfg = jreduced(jget_config(ARCH)), reduced_config(get_config(ARCH))
    assert cfg.pattern == jcfg.pattern == ("mlstm", "mlstm", "slstm", "slstm")
    jm = jget_model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    out = {"jcfg": jcfg, "cfg": cfg, "jm": jm, "params": params, "tree": _np(params)}
    toks = _tokens(cfg, seed=1)
    out["tokens"] = toks
    out["logits"] = np.asarray(jax.jit(jm.logits)(params, jnp.asarray(toks)))
    lg, c = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :P])})
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
    # the reference's Adafactor step: its train step's clip and update on
    # those gradients, with the sLSTM's "r" renamed (see _rename)
    opt = joptim.OptConfig(kind="adafactor", lr=STEP_LR, warmup=1)
    g, gnorm = joptim.clip_by_global_norm(grads, opt.grad_clip)
    out["clipped"] = _np(g)
    p1, s1 = jax.jit(lambda g, s, p: joptim.opt_update(opt, g, s, p))(
        _rename(g), joptim.opt_init(opt, _rename(params)), _rename(params))
    out["step"] = (_np(_rename(p1, back=True)), _np(_rename(s1, back=True)),
                   {"loss": float(loss), "grad_norm": float(gnorm)})
    return out


def _rename(tree, back=False):
    """The sLSTM's recurrent weight ``r`` under another name.  The
    reference's ``adafactor_update`` flattens its state with any dict
    holding an ``"r"`` key as a leaf (``src/repro/train/optim.py:131-133``),
    which the sLSTM's parameter dict is, so its own train step cannot run
    Adafactor on xLSTM (``test_reference_adafactor_step_fails_on_slstm``);
    the update itself is per leaf and does not read the names."""
    a, b = ("r_rec", "r") if back else ("r", "r_rec")
    if not isinstance(tree, dict):
        return [_rename(t, back) for t in tree] if isinstance(tree, list) else tree
    out = {k: _rename(v, back) for k, v in tree.items()}
    if "slstm" in out:
        out["slstm"] = {(b if k == a else k): v for k, v in out["slstm"].items()}
    return out


def _port(x):
    model = get_model(x["cfg"], "cpu")
    model.load_state_dict(lm_params_from_numpy(x["cfg"], x["tree"]))
    return model


def _qkv_gates(rng, b, s, h, p):
    q, k, v = (rng.standard_normal((b, s, h, p)).astype(np.float32) for _ in range(3))
    li = rng.standard_normal((b, s, h)).astype(np.float32)
    lf = np.log(1 / (1 + np.exp(-(2 + rng.standard_normal((b, s, h)))))).astype(np.float32)
    return q, k, v, li, lf


def _chunked_pair(args, chunk_ref, chunk_port):
    wy, wc, wn = jax.jit(jxlstm._mlstm_chunked, static_argnums=5)(
        *(jnp.asarray(a) for a in args), chunk_ref)
    gy, gc, gn = xlstm.mlstm_chunked(*(torch.from_numpy(a) for a in args), chunk_port)
    for got, want, what in ((gy, wy, "y"), (gc, wc, "C"), (gn, wn, "n")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what, **TOL)


# ------------------------------------------------------------ the blocks
def test_mlstm_chunked_matches_reference():
    _chunked_pair(_qkv_gates(np.random.default_rng(5), B, S, 3, 8), 16, 16)


@pytest.mark.parametrize("s,chunk_ref", [(40, 8), (37, 64)])
def test_mlstm_gate_padding(s, chunk_ref):
    """Off the chunk: the reference's padding raises, the port's (input
    gate -1e30, forget gate 0 on the padded steps) gives the reference's
    result at a chunk that needs no padding."""
    args = _qkv_gates(np.random.default_rng(6), B, s, 3, 8)
    with pytest.raises(ValueError, match="pad_width"):
        jxlstm._mlstm_chunked(*(jnp.asarray(a) for a in args), 16)
    _chunked_pair(args, chunk_ref, 16)


def test_slstm_cell_40_steps_match_reference(xl):
    cfg, jcfg = xl["cfg"], xl["jcfg"]
    jp = jax.jit(jxlstm.init_slstm, static_argnums=1)(jax.random.PRNGKey(7), jcfg)
    p = _load(xlstm.init_slstm(torch.Generator().manual_seed(0), cfg), _np(jp))
    xg = 2 * np.random.default_rng(8).standard_normal((40, B, 4 * cfg.d_model)).astype(np.float32)
    jst, st = jxlstm.slstm_init_state(jcfg, B), xlstm.slstm_init_state(cfg, B)
    cell = jax.jit(lambda s, x: jxlstm._slstm_cell(jp, jcfg, x, s))
    for t in range(40):
        jst = cell(jst, jnp.asarray(xg[t]))
        st = xlstm.slstm_cell(p, cfg, torch.from_numpy(xg[t]), st)
    for k in ("c", "n", "h", "m"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_step_from_a_nonzero_state(xl, kind):
    cfg, jcfg = xl["cfg"], xl["jcfg"]
    jinit = getattr(jxlstm, f"init_{kind}")
    jp = jax.jit(jinit, static_argnums=1)(jax.random.PRNGKey(9), jcfg)
    p = _load(getattr(xlstm, f"init_{kind}")(torch.Generator().manual_seed(0), cfg), _np(jp))
    rng = np.random.default_rng(10)
    shapes = {k: v.shape for k, v in getattr(jxlstm, f"{kind}_init_state")(jcfg, B).items()}
    st = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    if kind == "slstm":
        st["n"] = np.abs(st["n"]) + 0.5
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    wy, ws = jax.jit(getattr(jxlstm, f"{kind}_decode"), static_argnums=3)(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()}, jcfg)
    gy, gs = getattr(xlstm, f"{kind}_decode")(
        p, torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in st.items()}, cfg)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **TOL)
    assert set(gs) == set(ws)
    for k in ws:
        np.testing.assert_allclose(gs[k].numpy(), np.asarray(ws[k]), err_msg=k, **TOL)


def test_init_shapes_dtypes_and_constants_match_reference():
    """Every leaf's shape and dtype in a bf16 model as the reference's
    (``w_if``, ``b_if``, ``r`` and ``b`` stay f32); ``b_if`` is h zeros
    then h threes; the sLSTM state starts with m = -1e30."""
    jcfg = dataclasses.replace(jreduced(jget_config(ARCH)), dtype="bfloat16")
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)), dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    for kind, f32 in (("mlstm", ("w_if", "b_if")), ("slstm", ("r", "b"))):
        jp = jax.eval_shape(lambda k=kind: getattr(jxlstm, f"init_{k}")(jax.random.PRNGKey(0), jcfg))
        p = getattr(xlstm, f"init_{kind}")(gen, cfg)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in p.items()} == {
            k: (v.shape, str(v.dtype)) for k, v in jp.items()}
        assert all((v.dtype == torch.float32) == (k in f32) for k, v in p.items()), kind
    want = jax.jit(jxlstm.init_mlstm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)["b_if"]
    np.testing.assert_array_equal(xlstm.init_mlstm(gen, cfg)["b_if"].numpy(), np.asarray(want))
    st = xlstm.slstm_init_state(cfg, 2)
    assert float(st["m"].max()) == float(np.float32(-1e30)) and not st["c"].any()


# ------------------------------------------------------------- the model
def test_full_logits_match_reference(xl):
    got = _port(xl).logits(torch.from_numpy(xl["tokens"]))
    np.testing.assert_allclose(got.numpy(), xl["logits"], **TOL)


def test_prefill_and_teacher_forced_decode_match_reference(xl):
    """Logits and every state leaf after the 32-token prefill (two full
    chunks) and each of four decode steps."""
    cfg, toks = xl["cfg"], xl["tokens"]
    model = _port(xl)
    lg, c = model.prefill({"tokens": torch.from_numpy(toks[:, :P])})
    layer_order = [(s, i) for s, (_, count) in enumerate(cfg.segments()) for i in range(count)]
    for t, (want_l, want_c) in enumerate(xl["steps"]):
        if t:
            lg, c = model.decode_step(c, torch.from_numpy(toks[:, P + t - 1]))
        np.testing.assert_allclose(lg.numpy(), want_l, err_msg=f"step {t}", **TOL)
        assert c["len"] == int(want_c["len"])
        for j, (s, i) in enumerate(layer_order):
            want = want_c["segments"][s]
            assert set(c["layers"][j]) == set(want)
            for k, v in want.items():
                np.testing.assert_allclose(c["layers"][j][k].numpy(), v[i],
                                           err_msg=f"step {t} layer {j} {k}", **TOL)
    assert set(c["layers"][0]) == {"c", "n"} and set(c["layers"][3]) == {"c", "n", "h", "m"}
    np.testing.assert_allclose(lg.numpy(), xl["logits"][:, P + 3], **TOL)


def test_greedy_generate_matches_reference(xl):
    prompt, want_t, want_l = xl["gen"]
    toks, lg = generate(_port(xl), torch.from_numpy(prompt), steps=STEPS, s_cache=S,
                        return_logits=True)
    np.testing.assert_array_equal(toks.numpy(), want_t)
    np.testing.assert_allclose(lg.numpy(), want_l, **TOL)


def test_loss_and_grads_match_reference(xl):
    want_l, want_g = xl["grads"]
    want_g = lm_params_from_numpy(xl["cfg"], want_g)
    model = _port(xl)
    model.requires_grad_(True)
    loss = model.loss({k: torch.from_numpy(v) for k, v in xl["batch"].items()})
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    np.testing.assert_allclose(loss.item(), want_l, rtol=1e-5)
    assert set(names) == set(want_g)
    for k, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want_g[k].numpy(), err_msg=k, **TOL)
    g = dict(zip(names, grads))
    assert float(g["layers.2.slstm.r"].abs().max()) > 0
    for k in ("layers.2.slstm.b", "layers.3.slstm.b"):  # the input gates' biases: 0
        for t in (g[k], want_g[k]):
            assert float(t[1::4].abs().max()) <= 1e-7 * float(t.abs().max()) + 1e-8, k


def _state_pairs(model, state, ptree, stree, cfg):
    """(name, port tensor, reference tensor) of every parameter and every
    Adafactor statistic."""
    want_p, want_s = train_state_from_numpy(cfg, ptree, stree)
    assert int(state["step"]) == int(want_s["step"])
    pairs = [(k, p.detach(), want_p[k]) for k, p in model.named_parameters()]
    assert set(state["f"]) == set(want_s["f"])
    for k, f in want_s["f"].items():
        assert set(state["f"][k]) == set(f), k
        pairs += [(f"{k}/{j}", state["f"][k][j], t) for j, t in f.items()]
    return [(k, got.float().numpy(), exp.float().numpy()) for k, got, exp in pairs]


def test_adafactor_update_on_xlstm_leaves_matches_reference(xl):
    """Adafactor fed the reference's clipped gradients: the sLSTM's ``r``
    is ``(2, h, hd, 4 hd)`` stacked and factored per layer on its last two
    axes, the stacked vectors' column statistic spans the layers;
    parameters and state within 1e-6."""
    ptree, stree, _ = xl["step"]
    cfg = xl["cfg"]
    opt = OptConfig(kind="adafactor", lr=STEP_LR, warmup=1)
    model = _port(xl)
    params = dict(model.named_parameters())
    state = optim.opt_init(opt, params, model.param_leaves())
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    assert tuple(state["f"]["layers.2.slstm.r"]["r"].shape) == (h, hd)
    assert tuple(state["f"]["layers.2.slstm.r"]["c"].shape) == (h, 4 * hd)
    optim.opt_update(opt, lm_params_from_numpy(cfg, xl["clipped"]), state, params,
                     model.param_leaves())
    for k, got, exp in _state_pairs(model, state, ptree, stree, cfg):
        assert got.shape == exp.shape, k
        np.testing.assert_allclose(got, exp, atol=1e-6, rtol=1e-6, err_msg=k)


def test_adafactor_train_step_matches_reference(xl):
    """The whole step from the batch: loss and gradient norm, then every
    parameter and statistic by the step rule, but for the sLSTM's
    input-gate biases.  Their exact gradient is 0 (a bias shifts every
    step's input gate alike, which scales c and n alike, and h = o c / n
    does not see that: ``test_loss_and_grads_match_reference``), so what
    both packages hold there is f32 noise, which Adafactor's factored
    normalization turns into moves of the order of lr with arbitrary
    signs.  The update itself is held exactly above."""
    ptree, stree, wm = xl["step"]
    cfg = xl["cfg"]
    tcfg = TrainConfig(opt=OptConfig(kind="adafactor", lr=STEP_LR, warmup=1))
    model = _port(xl)
    state = init_train_state(model, tcfg)
    m = make_train_step(model, tcfg)(state, {k: torch.from_numpy(v) for k, v in xl["batch"].items()})
    assert m["loss"].item() == pytest.approx(wm["loss"], rel=1e-5)
    assert m["grad_norm"].item() == pytest.approx(wm["grad_norm"], rel=1e-4)
    bad = total = 0
    for k, got, exp in _state_pairs(model, state, ptree, stree, cfg):
        if k.endswith(".slstm.b"):  # (4 d,) interleaved per unit: gate 1 is the input gate
            keep = np.arange(got.shape[-1]) % 4 != 1
            got, exp = got[..., keep], exp[..., keep]
        bad += int((~np.isclose(got, exp, **GRAD_TOL)).sum())
        total += got.size
        assert np.abs(got - exp).max() <= STEP_FEW[1], k
    assert bad <= STEP_FEW[0] * total, (bad, total)


def test_reference_adafactor_step_fails_on_slstm(xl):
    """The reference's own train step under Adafactor raises on xLSTM: its
    state flattening takes the sLSTM's parameter dict (which holds ``r``)
    for a factored-moment leaf.  The port's step runs (above)."""
    opt = joptim.OptConfig(kind="adafactor", lr=STEP_LR, warmup=1)
    jb = {k: jnp.asarray(v) for k, v in xl["batch"].items()}
    step = jmake_train_step(xl["jm"], JTrainConfig(opt=opt))
    with pytest.raises(TypeError, match="dict"):
        jax.jit(step)(xl["params"], joptim.opt_init(opt, xl["params"]), jb)


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


def test_model_off_the_chunk(xl):
    """S = 37 at chunk 16: the reference's model raises; the port's logits
    equal the reference's model at chunk 64 (one 37-step chunk), and a
    30-token prefill (padded) then seven decodes reproduce them."""
    jm, params = xl["jm"], xl["params"]
    toks = xl["tokens"][:, :37]
    with pytest.raises(ValueError, match="pad_width"):
        jax.jit(jm.logits)(params, jnp.asarray(toks))
    jwide = jget_model(dataclasses.replace(xl["jcfg"], chunk=64))
    want = np.asarray(jax.jit(jwide.logits)(params, jnp.asarray(toks)))
    model = _port(xl)
    np.testing.assert_allclose(model.logits(torch.from_numpy(toks)).numpy(), want, **TOL)
    lg, c = model.prefill({"tokens": torch.from_numpy(toks[:, :30])})
    for t in range(30, 37):
        np.testing.assert_allclose(lg.numpy(), want[:, t - 1], err_msg=str(t), **TOL)
        lg, c = model.decode_step(c, torch.from_numpy(toks[:, t]))
    np.testing.assert_allclose(lg.numpy(), want[:, 36], **TOL)


def test_serve_cli_on_xlstm(capsys):
    from repro_torch.launch import serve

    toks = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt", "20", "--steps", "3"])
    assert tuple(toks.shape) == (2, 3)
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "tok/s" in out and "prefill 2x20" in out
