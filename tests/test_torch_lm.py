"""The port's LM serving path on the CPU against the JAX package.

For the reduced configurations of gemma2-9b (local + global blocks,
window 8, attention and final-logit softcaps), qwen3-8b (qk-norm),
qwen2-vl-2b (M-RoPE), smollm-360m (GQA with one kv head) and
starcoder2-7b, all in f32:
the reference's ``DecoderLM.init`` params go through
``interop.lm_params_from_numpy`` into the port's ``DecoderLM``, and the
same numpy prompts go through both.  Prefill logits and caches and four
teacher-forced ``decode_step`` logits agree within 1e-4 abs + 1e-4 rel
(f32 on both sides; the products and reductions run in another order),
and eight greedy ``generate`` tokens are equal exactly.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.models.transformer import DecoderLM as JDecoderLM  # noqa: E402
from repro.serve.decode import generate as jgenerate  # noqa: E402

from repro_torch.configs import get_config, get_model, reduced_config  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.serve.decode import generate  # noqa: E402

ARCHS = ["gemma2-9b", "qwen3-8b", "qwen2-vl-2b", "smollm-360m", "starcoder2-7b"]
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, STEPS = 2, 12, 8


def _pair(arch):
    """(reference model, its params, port model with the same weights)."""
    jcfg = jreduced(jget_config(arch))
    cfg = reduced_config(get_config(arch))
    assert cfg.pattern == jcfg.pattern and cfg.window == jcfg.window
    jm = JDecoderLM(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = get_model(cfg, "cpu")
    model.load_state_dict(lm_params_from_numpy(cfg, tree, "cpu"))
    return jm, params, model


def _prompt(cfg, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jm, params, model = _pair(arch)
    cfg = model.cfg
    prompt = _prompt(cfg, seed=len(arch))
    s_cache = S + 6
    jlog, jc = jm.prefill(params, {"tokens": jnp.asarray(prompt)}, s_cache=s_cache)
    log, c = model.prefill({"tokens": torch.from_numpy(prompt)}, s_cache=s_cache)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    assert c["len"] == int(jc["len"]) == S
    layer = 0
    for (kind, count), seg in zip(cfg.segments(), jc["segments"]):
        for i in range(count):
            for key in ("k", "v"):
                got = c["layers"][layer + i][key]
                assert got.shape == (B, cfg.n_kv_heads, s_cache, cfg.hd)
                np.testing.assert_allclose(got.numpy(), np.asarray(seg[key][i]), **TOL)
        layer += count
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (4, B)).astype(np.int32)
    step = jax.jit(jm.decode_step)
    for t in toks:
        jlog, jc = step(params, jc, jnp.asarray(t))
        log, c = model.decode_step(c, torch.from_numpy(t))
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    assert c["len"] == int(jc["len"]) == S + 4


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch):
    jm, params, model = _pair(arch)
    prompt = _prompt(model.cfg, seed=7)
    jtok, jlog = jgenerate(jm, params, jnp.asarray(prompt), steps=STEPS, return_logits=True)
    stats = {}
    tok, log = generate(
        model, torch.from_numpy(prompt), steps=STEPS, return_logits=True, stats=stats
    )
    assert tok.shape == (B, STEPS) and log.shape == (B, STEPS, model.cfg.vocab)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0


def test_init_caches_then_decode_matches_reference():
    jm, params, model = _pair("gemma2-9b")
    jc = jm.init_caches(B, 10, 3)
    c = model.init_caches(B, 10, 3)
    assert c["len"] == 3 and len(c["layers"]) == model.cfg.n_layers
    t = np.array([5, 77], np.int32)
    jlog, _ = jm.decode_step(params, jc, jnp.asarray(t))
    log, c = model.decode_step(c, torch.from_numpy(t))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    assert c["len"] == 4


def test_full_forward_matches_reference():
    jm, params, model = _pair("gemma2-9b")
    tokens = _prompt(model.cfg, seed=3)
    want = np.asarray(jm.logits(params, jnp.asarray(tokens)))
    np.testing.assert_allclose(model.logits(torch.from_numpy(tokens)).numpy(), want, **TOL)


def test_sampling_uses_the_generator():
    _, _, model = _pair("smollm-360m")
    prompt = torch.from_numpy(_prompt(model.cfg, seed=2))
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(11)
        outs.append(generate(model, prompt, steps=5, temperature=1.0, generator=g))
    assert torch.equal(outs[0], outs[1])
    assert outs[0].min() >= 0 and outs[0].max() < model.cfg.vocab


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve

    toks = serve.main(["--arch", "gemma2-9b", "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt", "10", "--steps", "3"])
    assert tuple(toks.shape) == (2, 3)
    out = capsys.readouterr().out
    assert "tok/s" in out and "prefill 2x10" in out and "ms/step" in out



def test_serve_cli_from_a_training_checkpoint(tmp_path, capsys):
    """``--ckpt``, once refused, serves the parameters of a checkpoint that
    ``launch/train.py`` wrote: the greedy tokens are those of the trained
    model, not of the random init."""
    from repro_torch.launch import serve, train

    d = str(tmp_path / "run")
    trained = train.main(["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
                          "--seq", "16", "--lr", "3e-2", "--ckpt", d])["model"]
    args = ["--reduced", "--device", "cpu", "--batch", "2", "--prompt", "6", "--steps", "4"]
    toks = serve.main(args + ["--ckpt", d])
    fresh = serve.main(args)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, trained.cfg.vocab, (2, 6)))
    assert torch.equal(toks, generate(trained, prompt, steps=4))
    assert not torch.equal(toks, fresh)
    assert "tok/s" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        serve.main(args + ["--ckpt", str(tmp_path / "none")])


def test_backends_and_devices():
    cfg = reduced_config(get_config("gemma2-9b"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            get_model(cfg)  # no device means the card
    model = get_model(cfg, "cpu", backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):  # the kernel refuses CPU tensors
        model.prefill({"tokens": torch.zeros((1, 4), dtype=torch.long)})
    with pytest.raises(ValueError, match="backend"):
        get_model(cfg, "cpu", backend="jnp")
