"""bf16 in a deep random Mamba2 stack: the reference and the port on the
same weights (CPU).

zamba2-7b's layer pattern at full depth (81 layers: 75 Mamba2, the shared
attention block at 6 positions) at d_model 256, chunk 32, vocab 512, from
the reference's ``init``; the port loads the same tree (its bf16 model
rounds the f32 leaves, as the reference's bf16 ``init`` does).  Two
figures, each in both packages and both dtypes:

- the prefill-then-decode gap of ``chip_smoke.py``'s (c): prefill
  ``P - T`` tokens, decode ``T`` teacher-forced, and hold the last
  logits to the ``P``-token prefill's (max |d| / max |logit|);
- the bf16 model's ``P``-token prefill logits against the f32 model's.

In f32 the first is ~1e-5 in both packages.  In bf16 both are 0.1-0.2 in
the reference's own arithmetic: random weights amplify a bf16 rounding
layer by layer, so a gap of that size at full width (zamba2-7b on the
card) does not by itself point at the port.  The port's bf16 figures must
be of the reference's order (within a factor ``ORDER``); what holds the
port's bf16 blocks tightly is ``chip_smoke.py``'s gate (g), layer by
layer.  ``pytest -s`` prints the figures.
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

from repro_torch.configs import get_config, get_model  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402

ARCH = "zamba2-7b"
D, CHUNK, VOCAB, P, T = 256, 32, 512, 128, 16
F32_GAP = 1e-4  # f32: the paths differ in summation order only
BF16_GAP = 0.05  # the reference's bf16 gaps are 0.14-0.17 here
ORDER = 4.0  # the port's bf16 gaps against the reference's


def _narrow(cfg):
    return dataclasses.replace(cfg, d_model=D, n_heads=D // 64, n_kv_heads=D // 64, d_ff=4 * D,
                               chunk=CHUNK, vocab=VOCAB)


def _gap(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def figures():
    """{(package, dtype): (prefill-then-decode gap, P-token prefill logits)}."""
    jcfg, cfg = _narrow(jget_config(ARCH)), _narrow(get_config(ARCH))
    assert jcfg.n_layers == cfg.n_layers == 81 and cfg.blocks().count("shared_attn") == 6
    toks = np.random.default_rng(1).integers(0, VOCAB, (2, P)).astype(np.int32)
    tree = None
    out = {}
    for dt in ("float32", "bfloat16"):
        jm = jget_model(dataclasses.replace(jcfg, dtype=dt))
        params = jax.jit(jm.init)(jax.random.PRNGKey(0))
        if tree is None:
            tree = jax.tree_util.tree_map(np.asarray, params)
        prefill = jax.jit(lambda p, t, jm=jm: jm.prefill(p, {"tokens": t}, s_cache=P))
        want, _ = prefill(params, jnp.asarray(toks))
        lg, c = prefill(params, jnp.asarray(toks[:, :P - T]))
        step = jax.jit(jm.decode_step)
        for t in range(P - T, P):
            lg, c = step(params, c, jnp.asarray(toks[:, t]))
        out["reference", dt] = (_gap(lg, want), np.asarray(want, np.float32))

        model = get_model(dataclasses.replace(cfg, dtype=dt), "cpu")
        model.load_state_dict(lm_params_from_numpy(cfg, tree))
        tt = torch.from_numpy(toks)
        want, _ = model.prefill({"tokens": tt}, s_cache=P)
        lg, c = model.prefill({"tokens": tt[:, :P - T]}, s_cache=P)
        for t in range(P - T, P):
            lg, c = model.decode_step(c, tt[:, t])
        out["port", dt] = (_gap(lg.numpy(), want.numpy()), want.float().numpy())
    for pkg in ("reference", "port"):
        print(f"\n{pkg}: prefill {P - T} + {T} decodes vs a {P} prefill: f32 "
              f"{out[pkg, 'float32'][0]:.4g}, bf16 {out[pkg, 'bfloat16'][0]:.4g}; bf16 vs f32 "
              f"prefill logits {_gap(out[pkg, 'bfloat16'][1], out[pkg, 'float32'][1]):.4g}")
    return out


def test_reference_bf16_stack_amplifies(figures):
    """The reference's own bf16 gap is thousands of times its f32 gap."""
    assert figures["reference", "float32"][0] < F32_GAP
    assert figures["reference", "bfloat16"][0] > BF16_GAP
    f32, bf16 = figures["reference", "float32"][1], figures["reference", "bfloat16"][1]
    assert _gap(bf16, f32) > BF16_GAP


def test_port_bf16_gaps_are_the_references_order(figures):
    """The port's f32 model is the reference's at depth; its bf16 gaps are
    of the reference's order."""
    np.testing.assert_allclose(figures["port", "float32"][1], figures["reference", "float32"][1],
                               atol=1e-4, rtol=1e-4)
    assert figures["port", "float32"][0] < F32_GAP
    ref, got = figures["reference", "bfloat16"][0], figures["port", "bfloat16"][0]
    assert ref / ORDER < got < ref * ORDER
    ref = _gap(figures["reference", "bfloat16"][1], figures["reference", "float32"][1])
    got = _gap(figures["port", "bfloat16"][1], figures["port", "float32"][1])
    assert ref / ORDER < got < ref * ORDER
