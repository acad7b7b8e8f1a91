"""The port's Whisper encoder-decoder on the CPU against the JAX package.

Reduced whisper-small (2 encoder + 2 decoder layers, d_model 64, 4 heads
of 16, f32): the reference's ``WhisperModel.init`` params go through
``interop.lm_params_from_numpy`` into the port, and the same numpy frames
and tokens go through both.  Tolerance 1e-4 abs + 1e-4 rel (f32 on both
sides, the products and reductions in another order); gradients 1e-5 abs
+ 1e-4 rel and a whole AdamW step under ``tests/test_torch_train.py``'s
rule (all but 1e-3 of the elements within the gradients' tolerance,
those within 2 lr).

- ``sinusoid`` (f32 within 1e-5; bf16 within one bf16 ulp at |x| <= 1,
  4e-3, as a one-ulp f32 difference may round the other way), ``encode``, ``cross_kv`` and
  ``cross_attn_forward`` (at 1 and 5 queries);
- ``prefill``'s logits and every cache (cross K/V, self K/V, ``len``),
  then 8 teacher-forced ``decode_step``s, whose logits also equal the
  port's full forward over the same tokens;
- ``generate_whisper``'s greedy tokens equal to the reference's;
- the loss and every gradient; one AdamW ``make_train_step`` step on the
  reference's ``make_smoke_batch`` encoder-decoder batch;
- ``input_specs`` equal to the reference's shapes and dtypes on every
  cell of ``cells()``, on the meta device; the full-width model's
  parameter count; every family of ``CONFIGS`` builds;
- checkpoints both ways, and ``launch/serve.py --ckpt`` serving a
  converted reference checkpoint;
- F4: past its self cache the reference's decode clamps (it reuses the
  last position row and overwrites the last slot), the port raises.

The reference's results are computed once (module-scoped fixture), its
calls under ``jax.jit``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import CONFIGS as JCONFIGS  # noqa: E402
from repro.configs import cells as jcells  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_model as jget_model  # noqa: E402
from repro.configs import input_specs as jinput_specs  # noqa: E402
from repro.configs import make_smoke_batch as jmake_smoke_batch  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro.serve.decode import generate_whisper as jgenerate_whisper  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro.train import optim as joptim  # noqa: E402

from repro_torch.configs import (  # noqa: E402
    CONFIGS, SHAPES, cell_enabled, cells, get_config, get_model, input_specs, make_smoke_batch,
    reduced_config,
)
from repro_torch.interop import (  # noqa: E402
    checkpoint_from_reference, checkpoint_to_reference, lm_params_from_numpy,
    train_state_from_numpy,
)
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.models.whisper import WhisperModel, sinusoid  # noqa: E402
from repro_torch.serve import generate_whisper  # noqa: E402
from repro_torch.train import OptConfig, TrainConfig, init_train_state, make_train_step  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.step import load_state_tree, state_tree  # noqa: E402

ARCH = "whisper-small"
TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
STEP_LR = 1e-3
STEP_FEW = (1e-3, 2 * STEP_LR + 1e-5)  # tests/test_torch_train.py's step rule
B, FRAMES, DEC_CACHE, STEPS = 2, 32, 12, 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref():
    """Reduced whisper-small: the reference's params, encoder output,
    prefill and decode caches, greedy tokens, gradients and one step."""
    jcfg, cfg = jreduced(jget_config(ARCH)), reduced_config(get_config(ARCH))
    assert (cfg.enc_layers, cfg.n_layers, cfg.d_model) == (jcfg.enc_layers, jcfg.n_layers, 64) == (2, 2, 64)
    jm = jget_model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((B, FRAMES, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (STEPS, B)).astype(np.int32)
    out = {"jcfg": jcfg, "cfg": cfg, "jm": jm, "params": params, "tree": _np(params),
           "frames": frames, "toks": toks}
    jf = jnp.asarray(frames)
    out["mem"] = np.array(jax.jit(jm.encode)(params, jf))
    lg, c = jax.jit(jm.prefill, static_argnums=2)(params, {"frames": jf}, DEC_CACHE)
    steps = [(np.asarray(lg), _np(c))]
    step = jax.jit(jm.decode_step)
    for t in toks:
        lg, c = step(params, c, jnp.asarray(t))
        steps.append((np.asarray(lg), _np(c)))
    out["steps"] = steps
    out["gen"] = np.asarray(jgenerate_whisper(jm, params, jf, steps=STEPS, dec_cache=DEC_CACHE))
    batch = _np(jmake_smoke_batch(jcfg, jax.random.PRNGKey(3)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(params, jb)
    out["batch"], out["grads"] = batch, (float(loss), _np(grads))
    opt = joptim.OptConfig(lr=STEP_LR, warmup=1)
    p1, s1, m = jax.jit(jmake_train_step(jm, JTrainConfig(opt=opt)))(
        params, joptim.opt_init(opt, params), jb)
    out["step"] = (p1, s1, {k: float(v) for k, v in m.items()})
    return out


def _port(r) -> WhisperModel:
    model = get_model(r["cfg"], "cpu")
    model.load_state_dict(lm_params_from_numpy(r["cfg"], r["tree"]))
    return model


def _assert_caches(got, want):
    assert got["len"] == int(want["len"])
    for part in ("cross", "self"):
        for k in ("k", "v"):
            assert tuple(got[part][k].shape) == want[part][k].shape, (part, k)
            np.testing.assert_allclose(got[part][k].numpy(), want[part][k], err_msg=f"{part} {k}",
                                       **TOL)


# -------------------------------------------------------------- the parts
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sinusoid_matches_reference(dtype):
    want = np.asarray(jwhisper.sinusoid(37, 64, getattr(jnp, dtype)).astype(jnp.float32))
    got = sinusoid(37, 64, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (37, 64)
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-5 if dtype == "float32" else 4e-3)


def test_encode_matches_reference(ref):
    got = _port(ref).encode(torch.from_numpy(ref["frames"]), False)
    np.testing.assert_allclose(got.detach().numpy(), ref["mem"], **TOL)


@pytest.mark.parametrize("sq", [1, 5])
def test_cross_kv_and_cross_attention_match_reference(ref, sq):
    """Decoder layer 1's cross block on the encoder output: ``cross_kv``
    applies no norm, ``cross_attn_forward`` norms x for q only."""
    cfg, jp = ref["cfg"], jax.tree_util.tree_map(lambda a: a[1], ref["params"]["dec"]["cross"])
    p = _port(ref).dec[1].cross
    mem = ref["mem"]
    x = np.random.default_rng(sq).standard_normal((B, sq, cfg.d_model)).astype(np.float32)
    jkv = jax.jit(jattn.cross_kv, static_argnums=2)(jp, jnp.asarray(mem), ref["jcfg"])
    kv = attention.cross_kv(p, torch.from_numpy(mem), cfg)
    for k in ("k", "v"):
        assert kv[k].shape == (B, cfg.n_kv_heads, FRAMES, cfg.hd) and kv[k].is_contiguous()
        np.testing.assert_allclose(kv[k].detach().numpy(), np.asarray(jkv[k]), **TOL)
    want = jax.jit(jattn.cross_attn_forward, static_argnums=3)(jp, jnp.asarray(x), jkv, ref["jcfg"])
    got = attention.cross_attn_forward(p, torch.from_numpy(x), kv, cfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


# -------------------------------------------------------------- the model
def test_prefill_and_teacher_forced_decode_match_reference(ref):
    """The BOS step's logits and every cache after the prefill, then after
    each of 8 decode steps; the steps' logits are also the port's full
    forward over BOS and the same tokens."""
    model = _port(ref)
    lg, c = model.prefill({"frames": torch.from_numpy(ref["frames"])}, s_cache=DEC_CACHE)
    cross = c["cross"]["k"]
    logits = []
    for t, (want_l, want_c) in enumerate(ref["steps"]):
        if t:
            lg, c = model.decode_step(c, torch.from_numpy(ref["toks"][t - 1]))
        np.testing.assert_allclose(lg.numpy(), want_l, err_msg=f"step {t}", **TOL)
        _assert_caches(c, want_c)
        logits.append(lg)
    assert c["len"] == STEPS + 1 and c["cross"]["k"] is cross  # built once, never recomputed
    seq = np.concatenate([np.zeros((B, 1), np.int32), ref["toks"].T], axis=1)
    full = model.logits(torch.from_numpy(ref["frames"]), torch.from_numpy(seq))
    np.testing.assert_allclose(torch.stack(logits, 1).numpy(), full.numpy(), **TOL)


def test_greedy_generate_whisper_matches_reference(ref):
    stats = {}
    toks, lg = generate_whisper(_port(ref), torch.from_numpy(ref["frames"]), steps=STEPS,
                                dec_cache=DEC_CACHE, return_logits=True, stats=stats)
    np.testing.assert_array_equal(toks.numpy(), ref["gen"])
    assert lg.shape == (B, STEPS, ref["cfg"].vocab) and torch.equal(lg.argmax(-1), toks)
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0


def test_loss_and_grads_match_reference(ref):
    want_l, want_g = ref["grads"]
    want_g = lm_params_from_numpy(ref["cfg"], want_g)
    model = _port(ref)
    model.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    names = [k for k, _ in model.named_parameters()]
    loss = model.loss(batch)
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    np.testing.assert_allclose(loss.item(), want_l, rtol=1e-5)
    assert set(names) == set(want_g)
    for k, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want_g[k].numpy(), err_msg=k, **GRAD_TOL)
    # remat changes nothing but the memory
    model.zero_grad(set_to_none=True)
    again = model.loss(batch, remat=False)
    assert again.item() == pytest.approx(loss.item(), rel=1e-6)


def test_adamw_train_step_matches_reference(ref):
    """One step on the reference's ``make_smoke_batch`` batch; the stacked
    norm gains take weight decay as the reference's (L, d) leaves do, the
    two final norms do not."""
    p1, s1, wm = ref["step"]
    cfg = ref["cfg"]
    tcfg = TrainConfig(opt=OptConfig(lr=STEP_LR, warmup=1))
    model = _port(ref)
    leaves = dict((names[0], (names, st)) for names, st in model.param_leaves())
    assert leaves["enc_ln"] == (("enc_ln",), False)
    assert leaves["dec.0.cross.ln"] == (("dec.0.cross.ln", "dec.1.cross.ln"), True)
    assert sum(len(n) for n, _ in model.param_leaves()) == len(list(model.parameters()))
    state = init_train_state(model, tcfg)
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    m = make_train_step(model, tcfg)(state, batch)
    assert m["loss"].item() == pytest.approx(wm["loss"], rel=1e-5)
    assert m["grad_norm"].item() == pytest.approx(wm["grad_norm"], rel=1e-4)
    want_p, want_s = train_state_from_numpy(cfg, _np(p1), _np(s1))
    assert int(state["step"]) == int(want_s["step"]) == 1
    pairs = [(k, p.detach(), want_p[k]) for k, p in model.named_parameters()]
    for part in ("m", "v"):
        pairs += [(k, state[part][k], want_s[part][k]) for k in want_s[part]]
    bad = total = 0
    for k, got, exp in pairs:
        got, exp = got.float().numpy(), exp.float().numpy()
        bad += int((~np.isclose(got, exp, **GRAD_TOL)).sum())
        total += got.size
        assert np.abs(got - exp).max() <= STEP_FEW[1], k
    assert bad <= STEP_FEW[0] * total, (bad, total)


def test_smoke_batch_has_the_reference_shapes(ref):
    got = make_smoke_batch(ref["cfg"], torch.Generator().manual_seed(0))
    want = ref["batch"]
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
        k: (v.shape, torch.float32 if k == "frames" else torch.int64) for k, v in want.items()}
    assert tuple(got["tokens"].shape) == (2, 4)  # max(4, 32 // dec_ratio)


# ----------------------------------------------------- shapes, the full model
def _spec(t):
    """(shape, dtype name) of a reference ShapeDtypeStruct, a port meta
    tensor, or the port's int cache length (the reference's int32 ())."""
    if isinstance(t, int):
        return (), "int32"
    if isinstance(t, torch.Tensor):
        assert t.device.type == "meta", t.device  # no storage
        return tuple(t.shape), str(t.dtype).split(".")[-1]
    return tuple(t.shape), str(t.dtype)


def _port_in_reference_layout(cfg, spec):
    """A decoder's per-layer caches as the reference's stacked segments."""
    if cfg.encdec or "caches" not in spec:
        return spec
    caches, first, segs = spec["caches"], 0, []
    for _, count in cfg.segments():
        one = caches["layers"][first]
        segs.append({k: torch.empty((count,) + tuple(t.shape), dtype=t.dtype, device="meta")
                     for k, t in one.items()})
        first += count
    return dict(spec, caches={"segments": segs, "len": caches["len"]})


@pytest.mark.parametrize("arch,shape", jcells())
def test_input_specs_match_reference(arch, shape):
    cfg = get_config(arch)
    assert cell_enabled(arch, shape) and SHAPES[shape] == (
        {"train_4k": (4096, 256, "train"), "prefill_32k": (32768, 32, "prefill"),
         "decode_32k": (32768, 128, "decode"), "long_500k": (524288, 1, "decode")}[shape])
    got = _port_in_reference_layout(cfg, input_specs(cfg, shape))
    want = jinput_specs(JCONFIGS[arch], shape)
    flat = lambda tree, f: {jax.tree_util.keystr(p): f(v) for p, v in  # noqa: E731
                            jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert flat(got, _spec) == flat(want, _spec)


def test_cells_match_reference():
    assert cells() == jcells() and len(cells()) == 10 * 3 + 2
    assert set(CONFIGS) == set(JCONFIGS)


def test_full_width_whisper_small_on_meta():
    """294683904 parameters (the reference's own count), no storage."""
    model = get_model(get_config(ARCH), "meta")
    assert isinstance(model, WhisperModel)
    shapes = jax.eval_shape(lambda: jget_model(jget_config(ARCH)).init(jax.random.PRNGKey(0)))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == want == 294683904
    assert all(p.device.type == "meta" and p.dtype == torch.bfloat16 for p in model.parameters())


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_every_family_builds(arch):
    """No family is refused any more: each config builds its model."""
    model = get_model(reduced_config(get_config(arch)), "cpu")
    assert isinstance(model, WhisperModel if get_config(arch).encdec else DecoderLM)


def test_decoder_lm_refuses_an_encoder_decoder():
    with pytest.raises(ValueError, match="get_model"):
        DecoderLM(reduced_config(get_config(ARCH)), "cpu")
    with pytest.raises(ValueError, match="get_model"):
        WhisperModel(reduced_config(get_config("smollm-360m")), "cpu")
    cfg = reduced_config(get_config("smollm-360m"))
    with pytest.raises(ValueError, match="unknown family"):
        get_model(dataclasses.replace(cfg, family="video"), "cpu")
    with pytest.raises(ValueError, match="unknown block kind"):
        get_model(dataclasses.replace(cfg, pattern=("attn", "conv")), "cpu")


# ------------------------------------------------------------ checkpoints
def test_checkpoint_round_trip_and_serve_from_reference(ref, tmp_path, capsys):
    """The reference's step-1 state restores in the port bit for bit;
    the port's state restores in the reference bit for bit; and
    ``launch/serve.py --ckpt`` serves the converted reference checkpoint."""
    cfg = ref["cfg"]
    p1, s1, _ = ref["step"]
    src, dst = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.save(src, 1, {"params": p1, "opt": s1}, extra={"next_step": 1})
    assert checkpoint_from_reference(cfg, src, dst) == 1
    model = get_model(cfg, "cpu")
    tcfg = TrainConfig(opt=OptConfig(lr=STEP_LR, warmup=1))
    state = init_train_state(model, tcfg)
    restored, extra = ckpt.restore(dst, state_tree(model, state))
    load_state_tree(model, state, restored)
    assert extra == {"next_step": 1}
    want_p, want_s = train_state_from_numpy(cfg, _np(p1), _np(s1))
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), want_p[k]), k
        assert torch.equal(state["m"][k], want_s["m"][k]), k
    back = str(tmp_path / "back")
    assert checkpoint_to_reference(cfg, dst, back) == 1
    like = {"params": ref["params"], "opt": joptim.opt_init(joptim.OptConfig(), ref["params"])}
    again, _ = jckpt.restore(back, like)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(again)[0],
                                 jax.tree_util.tree_flatten_with_path({"params": p1, "opt": s1})[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))

    from repro_torch.launch import serve

    toks = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt", "8", "--steps", "3", "--ckpt", dst])
    frames = np.random.default_rng(0).standard_normal((2, 8, cfg.d_model), dtype=np.float32)
    assert torch.equal(toks, generate_whisper(model, torch.from_numpy(frames), steps=3, dec_cache=7))
    assert "tok/s" in capsys.readouterr().out


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve

    toks = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
    assert tuple(toks.shape) == (4, 16)
    out = capsys.readouterr().out
    assert "arch=whisper-small" in out and "tok/s" in out and "ms/step" in out


# ------------------------------------------------------------------ F4
def test_decode_past_the_cache_clamps_in_the_reference_and_raises_here(ref):
    """The reference's ``dynamic_slice`` / ``dynamic_update_slice`` clamp
    their start: at ``len == dec_cache`` a step reads the last position
    row and overwrites the last self-cache slot, giving what a step at
    ``len - 1`` gives, and ``generate_whisper`` past its cache returns
    without a word.  The port raises, naming the cache's length."""
    jm, params = ref["jm"], ref["params"]
    _, c = ref["steps"][STEPS]  # after the prefill and 8 steps: len 9
    n = STEPS + 1
    full = dict(c, self={k: v[:, :, :, :n] for k, v in c["self"].items()})  # 9 of 9 positions
    tok = jnp.asarray(ref["toks"][0])
    step = jax.jit(jm.decode_step)
    over_l, over_c = step(params, jax.tree_util.tree_map(jnp.asarray, full), tok)
    last_l, last_c = step(params, dict(jax.tree_util.tree_map(jnp.asarray, full),
                                       len=jnp.int32(n - 1)), tok)
    np.testing.assert_array_equal(np.asarray(over_l), np.asarray(last_l))
    np.testing.assert_array_equal(np.asarray(over_c["self"]["k"]), np.asarray(last_c["self"]["k"]))
    assert int(over_c["len"]) == n + 1
    model = _port(ref)
    with pytest.raises(ValueError, match=f"of {n} positions"):
        model.decode_step({"cross": {k: torch.from_numpy(v) for k, v in full["cross"].items()},
                           "self": {k: torch.from_numpy(np.array(v)) for k, v in full["self"].items()},
                           "len": n}, torch.from_numpy(ref["toks"][0]))
    jt = jgenerate_whisper(jm, params, jnp.asarray(ref["frames"]), steps=DEC_CACHE + 1,
                           dec_cache=DEC_CACHE)
    assert jt.shape == (B, DEC_CACHE + 1)
    with pytest.raises(ValueError, match=f"of {DEC_CACHE} positions"):
        generate_whisper(model, torch.from_numpy(ref["frames"]), steps=DEC_CACHE + 1,
                         dec_cache=DEC_CACHE)
    toks = generate_whisper(model, torch.from_numpy(ref["frames"]), steps=DEC_CACHE,
                            dec_cache=DEC_CACHE)  # the last slot is the last step's
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt)[:, :DEC_CACHE])


def test_attn_decode_past_the_cache_raises():
    """Every decoder's ``attn_decode`` (``attention.py:100-101`` in the
    reference clamps the same way)."""
    cfg = reduced_config(get_config("smollm-360m"))
    p = attention.init_attn(torch.Generator().manual_seed(0), cfg)
    cache = {k: torch.zeros((1, cfg.n_kv_heads, 4, cfg.hd)) for k in ("k", "v")}
    x = torch.randn((1, 1, cfg.d_model))
    attention.attn_decode(p, x, cache, 3, cfg)
    with pytest.raises(ValueError, match="cache of 4 positions"):
        attention.attn_decode(p, x, cache, 4, cfg)
    model = get_model(cfg, "cpu")
    c = model.init_caches(1, 4, 4)
    with pytest.raises(ValueError, match="cache full"):
        model.decode_step(c, torch.zeros((1,), dtype=torch.long))
