"""The port's flash attention on the CPU: its plain version (what a CPU
tensor takes, and the oracle the CUDA kernel is held to on the card)
against the JAX package's Pallas kernel in interpret mode and against
``repro.kernels.ref.attention_ref``, on the same numpy inputs.

Tolerances: f32 1e-5 abs + 1e-5 rel (both sides compute in f32 and differ
only in summation order and in exp/tanh ulps); bf16 one bf16 ulp of the
output (2**-7 rel, 1e-2 abs floor: both round an f32 result once, and
f32 values that straddle a rounding boundary may land one ulp apart).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pl_flash  # noqa: E402

from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain  # noqa: E402

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=1e-2, rtol=2**-7)}

# (b, h, kvh, sq, sk, d, causal, window, softcap, dtype)
CASES = [
    (2, 2, 2, 40, 40, 16, True, 0, 0.0, "float32"),      # group 1, causal
    (1, 4, 2, 40, 40, 16, True, 0, 0.0, "float32"),      # group 2
    (1, 4, 1, 33, 33, 32, False, 0, 0.0, "float32"),     # group 4, non-causal
    (1, 4, 2, 48, 48, 16, True, 8, 0.0, "float32"),      # sliding window
    (1, 4, 2, 48, 48, 16, True, 0, 5.0, "float32"),      # softcap
    (1, 4, 2, 48, 48, 16, True, 8, 5.0, "float32"),      # window + softcap
    (1, 2, 1, 24, 40, 16, True, 0, 0.0, "float32"),      # Sq < Skv (top-left causal)
    (1, 2, 1, 40, 24, 16, False, 6, 0.0, "float32"),     # Sq > Skv, window
    (1, 2, 2, 20, 37, 16, False, 0, 2.0, "float32"),     # Skv not a block multiple
    (1, 2, 2, 16, 1, 16, False, 0, 0.0, "float32"),      # Skv = 1
    (1, 4, 2, 40, 40, 16, True, 8, 5.0, "bfloat16"),     # bf16
    # bf16 at the widths of the tensor-core kernel, Sq and Skv off its
    # 128-row block and 64-key tile
    (1, 2, 1, 130, 130, 64, True, 0, 50.0, "bfloat16"),  # group 2, softcap
    (1, 2, 2, 70, 200, 128, True, 5, 0.0, "bfloat16"),   # Sq < Skv, window < a tile
    (1, 4, 1, 200, 70, 256, False, 0, 50.0, "bfloat16"), # Sq > Skv, group 4
]


def _inputs(case, seed):
    b, h, kvh, sq, sk, d = case[:6]
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, sq, d)) * 2).astype(np.float32)
    k = rng.standard_normal((b, kvh, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, sk, d)).astype(np.float32)
    return q, k, v


def _visible_rows(sq, sk, causal, window):
    rows = np.arange(sq)[:, None]
    cols = np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= cols > rows - window
    return mask.any(axis=1)


def _to_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_vs_pallas_and_reference(case):
    b, h, kvh, sq, sk, d, causal, window, softcap, dtype = case
    q, k, v = _inputs(case, seed=sq * 7 + sk)
    kw = dict(causal=causal, window=window, softcap=softcap)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))

    got = flash_attention_plain(tq, tk, tv, **kw, blk_k=16)
    assert got.dtype == tdt and got.shape == (b, h, sq, d)
    got = got.float().numpy()
    want_ref = _to_np(ref.attention_ref(jq, jk, jv, **kw))
    np.testing.assert_allclose(got, want_ref, **TOL[dtype])
    # the Pallas kernel, on the rows it gets right (every row that sees a key)
    pallas = _to_np(pl_flash(jq, jk, jv, **kw, blk_q=16, blk_k=16, interpret=True))
    vis = _visible_rows(sq, sk, causal, window)
    np.testing.assert_allclose(got[:, :, vis], pallas[:, :, vis], **TOL[dtype])
    # the wrapper and the ops switch take the plain version for CPU tensors
    np.testing.assert_array_equal(
        flash_attention(tq, tk, tv, **kw).float().numpy(),
        flash_attention_plain(tq, tk, tv, **kw).float().numpy(),
    )
    np.testing.assert_array_equal(
        K.attention(tq, tk, tv, **kw).float().numpy(),
        flash_attention_plain(tq, tk, tv, **kw).float().numpy(),
    )
    np.testing.assert_allclose(
        tref.attention_ref(tq, tk, tv, **kw).float().numpy(), want_ref, **TOL[dtype]
    )


@pytest.mark.parametrize("blk_k", [1, 7, 16, 512])
def test_plain_block_size_does_not_change_the_result(blk_k):
    case = (1, 4, 2, 30, 45, 16, True, 9, 3.0, "float32")
    q, k, v = (torch.from_numpy(x) for x in _inputs(case, seed=5))
    kw = dict(causal=True, window=9, softcap=3.0)
    np.testing.assert_allclose(
        flash_attention_plain(q, k, v, **kw, blk_k=blk_k).numpy(),
        tref.attention_ref(q, k, v, **kw).numpy(), atol=1e-5, rtol=1e-5,
    )


def test_fully_masked_rows_are_zero():
    """A row that sees no key is 0 in the port, as in ``attention_ref``.

    The Pallas kernel disagrees here, a fault of the reference (ROADMAP
    C): inside a wholly masked kv tile its running max is still the
    -1e30 fill, so every masked entry gets weight exp(0) = 1 and such a
    row comes out as the mean of V over the masked keys."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 2, 64, 16)).astype(np.float32)
    k = rng.standard_normal((1, 1, 16, 16)).astype(np.float32)
    v = rng.standard_normal((1, 1, 16, 16)).astype(np.float32)
    for causal in (True, False):
        kw = dict(causal=causal, window=8)
        got = flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), **kw).numpy()
        dead = ~_visible_rows(64, 16, causal, 8)
        assert dead.sum() == 41  # rows 23..63 see no key of 0..15
        assert np.all(got[:, :, dead] == 0.0)
        want = _to_np(ref.attention_ref(*(jnp.asarray(x) for x in (q, k, v)), **kw))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        pallas = _to_np(pl_flash(*(jnp.asarray(x) for x in (q, k, v)), **kw,
                                 blk_q=16, blk_k=16, interpret=True))
        assert np.abs(pallas[:, :, dead]).max() > 0.1  # the reference-side fault
        np.testing.assert_allclose(got[:, :, ~dead], pallas[:, :, ~dead], atol=1e-5, rtol=1e-5)


def test_use_cuda_on_cpu_tensors_raises():
    q = torch.zeros((1, 2, 4, 16))
    k = torch.zeros((1, 1, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        K.attention(q, k, k, use_cuda=True)
    # impl="chunked", once refused, runs the chunked scan: it matches the
    # plain version ("dense")
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 2, 40, 16), (1, 1, 40, 16), (1, 1, 40, 16)))
    np.testing.assert_allclose(K.attention(q, k, v, impl="chunked").numpy(),
                               K.attention(q, k, v, impl="dense").numpy(), atol=3e-5, rtol=3e-5)


def test_kernel_refuses_autograd_before_the_device_check():
    """The flash kernel has no backward: with autograd recording it raises
    instead of returning a result that carries no gradient.  On CPU
    tensors the refusal comes before the device check (a RuntimeError
    about autograd, not the ValueError about CUDA tensors), and
    ``refuse_autograd`` guards the wrapper itself.  Under no_grad, or with
    inputs that need no grad, the device check speaks as before."""
    from repro_torch.kernels.flash_attention import refuse_autograd

    q = torch.zeros((1, 2, 4, 16), requires_grad=True)
    k = torch.zeros((1, 1, 4, 16))
    for kw in (dict(use_cuda=True), dict(impl="pallas")):
        with pytest.raises(RuntimeError, match="no backward.*impl='chunked'"):
            K.attention(q, k, k, **kw)
    with pytest.raises(RuntimeError, match="no backward"):
        refuse_autograd(k, k, q)
    with torch.no_grad():
        refuse_autograd(q, k, k)
        with pytest.raises(ValueError, match="CUDA"):
            K.attention(q, k, k, use_cuda=True)
    with pytest.raises(ValueError, match="CUDA"):
        K.attention(q.detach(), k, k, use_cuda=True)
    # the model's loss with the 'cuda' backend named reaches the kernel
    from repro_torch.configs import get_config, get_model, reduced_config

    model = get_model(reduced_config(get_config("smollm-360m")), "cpu", backend="cuda")
    model.requires_grad_(True)
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.long),
             "targets": torch.zeros((1, 8), dtype=torch.long)}
    with pytest.raises(RuntimeError, match="no backward"):
        model.loss(batch)
    model.backend = "torch"
    assert torch.isfinite(model.loss(batch))


def test_shape_checks():
    q = torch.zeros((1, 3, 4, 16))
    k = torch.zeros((1, 2, 4, 16))
    with pytest.raises(ValueError, match="multiple of KVH"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros((1, 3, 4, 16)), torch.zeros((1, 3, 5, 16)))
