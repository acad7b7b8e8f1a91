"""The port's chunked attention (``kernels/chunked.py``) and the
``impl`` switch of ``kernels/ops.py::attention`` on the CPU against the
JAX package.

Forward and q/k/v gradients against ``repro.kernels.chunked.chunked_attention``
(GQA, causal and not, window, softcap, a ragged last chunk, Sq != Skv),
within the reference's own tolerances (``tests/test_chunked_attention.py``:
3e-5 forward, 2e-4 gradients; f32 on both sides).  A row that sees no key
is 0 in the port (as in its flash kernel); the reference's scan gives the
mean of V there (ROADMAP C), and that is pinned on both sides.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.chunked import chunked_attention as jchunked  # noqa: E402

from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.chunked import chunked_attention  # noqa: E402

FWD = dict(atol=3e-5, rtol=3e-5)
GRAD = dict(atol=2e-4, rtol=2e-4)

CASES = [
    # b, h, kvh, sq, sk, d, causal, window, softcap, chunk
    (1, 4, 2, 96, 96, 16, True, 0, 0.0, 32),
    (2, 6, 2, 80, 80, 8, True, 16, 0.0, 32),  # window, GQA g=3, 80 off the chunk
    (1, 4, 4, 64, 64, 16, True, 8, 10.0, 16),  # window + softcap
    (1, 2, 1, 48, 72, 8, False, 0, 20.0, 32),  # Sq != Skv, ragged last chunk
    (1, 4, 1, 40, 40, 16, True, 0, 0.0, 64),  # one chunk wider than Skv
]


def _inputs(case, seed):
    b, h, kvh, sq, sk, d = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, sq, d), (b, kvh, sk, d), (b, kvh, sk, d))]


@pytest.mark.parametrize("case", CASES, ids=[f"case{i}" for i in range(len(CASES))])
def test_chunked_forward_and_grads_match_reference(case):
    causal, window, softcap, chunk = case[6:]
    kw = dict(causal=causal, window=window, softcap=softcap)
    q, k, v = _inputs(case, seed=sum(case[:6]))
    w = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        return (jchunked(q, k, v, chunk=chunk, **kw) * w).sum()

    want_o = np.asarray(jchunked(*(jnp.asarray(x) for x in (q, k, v)), chunk=chunk, **kw))
    want_g = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    got = chunked_attention(tq, tk, tv, chunk=chunk, **kw)
    np.testing.assert_allclose(got.detach().numpy(), want_o, **FWD)
    grads = torch.autograd.grad((got * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for name, g, wg in zip("qkv", grads, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), err_msg=name, **GRAD)
    # without autograd the same values (no recompute)
    with torch.no_grad():
        again = chunked_attention(tq, tk, tv, chunk=chunk, **kw)
    assert torch.equal(again, got.detach())


def test_fully_masked_rows_are_zero():
    """Causal, window 8, 64 queries over 16 keys: rows 23..63 see no key.
    The port gives 0 there, with finite gradients; the reference's scan the
    mean of V (a fault of the reference, ROADMAP C).  Elsewhere they agree."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 2, 64, 16)).astype(np.float32)
    k = rng.standard_normal((1, 1, 16, 16)).astype(np.float32)
    v = rng.standard_normal((1, 1, 16, 16)).astype(np.float32)
    kw = dict(causal=True, window=8, chunk=8)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    got = chunked_attention(tq, tk, tv, **kw)
    dead = np.arange(64) >= 23
    assert torch.all(got[:, :, dead] == 0)
    grads = torch.autograd.grad(got.sum(), (tq, tk, tv))
    assert all(torch.isfinite(g).all() for g in grads)
    assert torch.all(grads[0][:, :, dead] == 0)
    want = np.asarray(jchunked(*(jnp.asarray(x) for x in (q, k, v)), **kw))
    np.testing.assert_allclose(want[:, :, dead], np.broadcast_to(v.mean(2, keepdims=True),
                                                                 want[:, :, dead].shape),
                               atol=1e-5)  # the reference-side fault
    np.testing.assert_allclose(got.detach().numpy()[:, :, ~dead], want[:, :, ~dead], **FWD)
    dense = K.attention(tq, tk, tv, causal=True, window=8, impl="dense")
    np.testing.assert_allclose(got.detach().numpy(), dense.detach().numpy(), **FWD)


def test_impl_switch_picks_chunked_under_autograd(monkeypatch):
    """impl=None: the reference's off-TPU rule under autograd (chunked at
    Skv >= CHUNKED_MIN_KV, dense below), dense without autograd on the
    CPU; 'dense' is the plain version of the flash kernel."""
    calls = []
    orig = K._chunked
    monkeypatch.setattr(K, "_chunked", lambda *a, **kw: calls.append("chunked") or orig(*a, **kw))
    monkeypatch.setattr(K, "CHUNKED_MIN_KV", 32)
    q, k, v = (torch.from_numpy(x) for x in _inputs(CASES[0], seed=4))
    leaf = q.clone().requires_grad_(True)
    K.attention(leaf, k, v)  # Skv 96 >= 32, recorded
    assert calls == ["chunked"]
    with torch.no_grad():
        out = K.attention(leaf, k, v)
    assert calls == ["chunked"]
    assert torch.equal(out, ref.flash_attention_ref(q, k, v))
    K.attention(leaf[:, :, :16], k[:, :, :16], v[:, :, :16])  # Skv 16 < 32: dense
    assert calls == ["chunked"]
    got = K.attention(leaf, k, v, impl="chunked")
    dense = K.attention(leaf, k, v, impl="dense")
    np.testing.assert_allclose(got.detach().numpy(), dense.detach().numpy(), **FWD)
    ga = torch.autograd.grad(got.sum(), leaf)[0]
    gb = torch.autograd.grad(dense.sum(), leaf)[0]
    np.testing.assert_allclose(ga.numpy(), gb.numpy(), **GRAD)
    with pytest.raises(ValueError, match="impl"):
        K.attention(q, k, v, impl="flash")
    with pytest.raises(ValueError, match="multiple of KVH"):
        chunked_attention(q, k[:, :1].expand(1, 3, 96, 16), v[:, :1].expand(1, 3, 96, 16))
