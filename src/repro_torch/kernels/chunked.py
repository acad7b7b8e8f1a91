"""Chunked attention: an online-softmax scan over KV chunks in plain
PyTorch (counterpart of ``repro/kernels/chunked.py``, which the reference
computes in XLA, not in a Pallas kernel).

It is the training path for long sequences (``kernels/ops.py``'s
``impl="chunked"``, the default under autograd at ``Skv >=
CHUNKED_MIN_KV``).  Each chunk's step runs under
``torch.utils.checkpoint``: the forward keeps only the carry
``(m, l, acc)`` between chunks, and the backward recomputes each chunk's
scores, so peak activation memory is O(Sq x C) instead of O(Sq x Skv).

GQA groups the query heads as ``(b, kvh, g, sq, d)`` instead of repeating
the keys; scores, the softmax and the output accumulate in f32, and the
output has q's dtype.  Masks and softcap follow ``kernels/flash_attention.py``.
A masked entry contributes exactly 0 and a row with no visible key is 0,
as in the port's flash kernel.  The reference's scan differs on such a
row: it fills masked scores with -1e30, so where a row sees nothing its
running max is still -1e30, every masked entry gets weight exp(0) = 1,
and the row comes out as the mean of V (ROADMAP C).  A row that sees a
key in a later chunk is the same in both: its first visible chunk
rescales the earlier sums by exp(-1e30 - m) = 0.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

NEG = -1e30


def _chunk_step(m, l, acc, qg, kj, vj, j0: int, causal: bool, window: int, softcap: float,
                scale: float):
    """One chunk of the scan: the carry ``(m, l, acc)`` after keys
    ``j0 .. j0 + C``.  ``kj``/``vj`` are ``(b, kvh, C, d)``."""
    s = (qg @ kj.float().unsqueeze(2).transpose(-1, -2)) * scale  # (b,kvh,g,sq,C)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    sq, c = s.shape[-2], s.shape[-1]
    rows = torch.arange(sq, device=s.device)[:, None]
    cols = j0 + torch.arange(c, device=s.device)[None, :]
    mask = torch.ones((sq, c), dtype=torch.bool, device=s.device)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= cols > rows - window
    s = s.masked_fill(~mask, NEG)
    m2 = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.where(mask, torch.exp(s - m2), 0.0)
    corr = torch.exp(m - m2)
    l2 = corr * l + p.sum(dim=-1, keepdim=True)
    acc2 = corr * acc + p @ vj.float().unsqueeze(2)
    return m2, l2, acc2


def chunked_attention(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, KVH, Skv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
    chunk: int = 1024,
) -> torch.Tensor:
    """Attention of q over k/v in chunks of ``chunk`` keys -> ``(B, H, Sq, D)``.

    When autograd records, each chunk is recomputed in the backward."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or kvh == 0 or h % kvh:
        raise ValueError(
            f"chunked_attention: q (B,H,Sq,D), k/v (B,KVH,Skv,D) with H a multiple "
            f"of KVH expected, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    g = h // kvh
    scale = float(scale) if scale is not None else float(d) ** -0.5
    c = max(1, min(chunk, sk))
    qg = q.float().reshape(b, kvh, g, sq, d)
    m = torch.full((b, kvh, g, sq, 1), NEG, device=q.device)
    l = torch.zeros((b, kvh, g, sq, 1), device=q.device)
    acc = torch.zeros((b, kvh, g, sq, d), device=q.device)
    recompute = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    for j0 in range(0, sk, c):
        # the last chunk is ragged; its columns past Skv do not exist, so
        # unlike the reference nothing is padded
        args = (m, l, acc, qg, k[:, :, j0:j0 + c], v[:, :, j0:j0 + c], j0, causal, int(window),
                float(softcap), scale)
        if recompute:
            m, l, acc = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            m, l, acc = _chunk_step(*args)
    out = acc / torch.where(l == 0.0, 1.0, l)
    return out.reshape(b, h, sq, d).to(q.dtype)
