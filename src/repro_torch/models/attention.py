"""Attention block: GQA, RoPE/M-RoPE, qk-norm, softcap, sliding window,
cross-attention and KV-cache decode (counterpart of
``repro/models/attention.py``).

Prefill runs through ``kernels.ops.attention``: the Hopper flash kernel
with the ``'cuda'`` backend, its plain version with ``'torch'``; the
training forward passes ``impl`` (the chunked scan or the plain version:
the kernel has no backward).  Self-attention decode attends one query per
sequence to the cache in plain torch, as the reference does outside any
Pallas kernel.  Cross-attention (the Whisper decoder's, against K/V that
``cross_kv`` projects once from the encoder's output) calls
``kernels.ops.attention`` as prefill does, in decode too, where the
reference reaches its Pallas kernel with one query a sequence: under
``'cuda'`` and no autograd it is the flash kernel at Sq = 1.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..kernels import ops as kops
from .common import (
    ArchConfig, apply_mrope, apply_rope, gen_device, init_norm, rms_norm, scaled_init,
)


def init_attn(gen: torch.Generator, cfg: ArchConfig) -> nn.ParameterDict:
    d, hd = cfg.d_model, cfg.hd
    h, kv = cfg.n_heads, cfg.n_kv_heads
    dt, dev = cfg.torch_dtype, gen_device(gen)
    p = nn.ParameterDict({
        "wq": scaled_init(gen, (d, h * hd), 0, dt),
        "wk": scaled_init(gen, (d, kv * hd), 0, dt),
        "wv": scaled_init(gen, (d, kv * hd), 0, dt),
        "wo": scaled_init(gen, (h * hd, d), 0, dt),
        "ln": init_norm(d, dt, dev),
    })
    if cfg.qk_norm:
        p["qn"] = init_norm(hd, dt, dev)
        p["kn"] = init_norm(hd, dt, dev)
    return p


def _project_qkv(p, x: torch.Tensor, cfg: ArchConfig, pos: torch.Tensor):
    """x (B,S,D) -> q (B,H,S,hd), k/v (B,KV,S,hd), normed and rotated."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).view(b, s, h, hd).transpose(1, 2)
    k = (x @ p["wk"]).view(b, s, kv, hd).transpose(1, 2)
    v = (x @ p["wv"]).view(b, s, kv, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(q, p["qn"], cfg.norm_eps)
        k = rms_norm(k, p["kn"], cfg.norm_eps)
    if cfg.rope == "rope":
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    elif cfg.rope == "mrope":
        q = apply_mrope(q, pos, cfg.rope_theta)
        k = apply_mrope(k, pos, cfg.rope_theta)
    return q.contiguous(), k.contiguous(), v.contiguous()


def attn_prefill(
    p, x: torch.Tensor, cfg: ArchConfig, *, pos: torch.Tensor, causal: bool = True,
    window: int = 0, use_cuda: Optional[bool] = False, impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention x (B,S,D) -> (B,S,D), plus the KV cache
    ``{"k", "v"}`` (B, KV, S, hd).  ``use_cuda`` and ``impl`` go to
    ``kernels.ops.attention``."""
    b, s, _ = x.shape
    xin = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = _project_qkv(p, xin, cfg, pos)
    o = kops.attention(
        q, k, v, causal=causal, window=window, softcap=cfg.attn_softcap,
        use_cuda=use_cuda, impl=impl,
    )
    o = o.transpose(1, 2).reshape(b, s, -1)
    return x + (o @ p["wo"]).to(x.dtype), {"k": k, "v": v}


def attn_forward(
    p, x: torch.Tensor, cfg: ArchConfig, *, pos: torch.Tensor, causal: bool = True,
    window: int = 0, use_cuda: Optional[bool] = False, impl: Optional[str] = None,
) -> torch.Tensor:
    """Full-sequence attention (train / prefill) without the cache."""
    return attn_prefill(
        p, x, cfg, pos=pos, causal=causal, window=window, use_cuda=use_cuda, impl=impl
    )[0]


def attn_decode(
    p,
    x: torch.Tensor,  # (B, 1, D) current token activations
    cache: Dict[str, torch.Tensor],  # k/v (B, KV, S_cache, hd)
    cache_len: int,  # valid prefix length
    cfg: ArchConfig,
    *,
    window: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode: write (k, v) at ``cache_len`` and attend to the
    prefix.  Unlike the reference, which returns updated copies, the
    cache tensors are written in place (one row per layer instead of a
    copy of the whole cache) and returned."""
    b = x.shape[0]
    kc, vc = cache["k"], cache["v"]
    kvh, s_cache, hd = kc.shape[1], kc.shape[2], kc.shape[3]
    if not 0 <= cache_len < s_cache:
        # the reference's dynamic_update_slice clamps the start: past the
        # end it would overwrite the last slot without a word
        raise ValueError(f"attn_decode: cache_len {cache_len} outside a cache of {s_cache} positions")
    xin = rms_norm(x, p["ln"], cfg.norm_eps)
    posv = torch.full((b, 1), cache_len, dtype=torch.long, device=x.device)
    if cfg.rope == "mrope":
        posv = posv[None].expand(3, b, 1)
    q, k, v = _project_qkv(p, xin, cfg, posv)
    kc[:, :, cache_len] = k[:, :, 0].to(kc.dtype)
    vc[:, :, cache_len] = v[:, :, 0].to(vc.dtype)
    g = cfg.n_heads // kvh
    # head h = kv * g + i reads kv-head kv: group the query heads instead
    # of repeating the cache
    qg = q.float().view(b, kvh, g, hd)
    s = (qg @ kc.float().transpose(-1, -2)) * float(cfg.hd) ** -0.5  # (B,KV,g,S)
    if cfg.attn_softcap > 0.0:
        s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
    idx = torch.arange(s_cache, device=x.device)
    mask = idx <= cache_len
    if window and window > 0:
        mask &= idx > cache_len - window
    pr = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    o = (pr @ vc.float()).to(x.dtype)  # (B,KV,g,hd)
    o = o.reshape(b, 1, -1)
    return x + (o @ p["wo"]).to(x.dtype), {"k": kc, "v": vc}


# ------------------------------------------------------- cross attention
def init_cross_attn(gen: torch.Generator, cfg: ArchConfig) -> nn.ParameterDict:
    """The parameters of ``init_attn`` (``wk``/``wv`` project the encoder's
    output, ``ln`` norms the decoder's stream for q only)."""
    return init_attn(gen, cfg)


def cross_kv(p, mem: torch.Tensor, cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """Encoder-side K/V for cross-attention: ``mem`` (B, S, D), already
    normed by the encoder, projected with no norm -> k/v (B, KV, S, hd)."""
    b, s, _ = mem.shape
    kv, hd = cfg.n_kv_heads, cfg.hd
    k = (mem @ p["wk"]).view(b, s, kv, hd).transpose(1, 2)
    v = (mem @ p["wv"]).view(b, s, kv, hd).transpose(1, 2)
    return {"k": k.contiguous(), "v": v.contiguous()}


def cross_attn_forward(
    p, x: torch.Tensor, mem_kv: Dict[str, torch.Tensor], cfg: ArchConfig, *,
    use_cuda: Optional[bool] = False, impl: Optional[str] = None,
) -> torch.Tensor:
    """Decoder cross-attention of x (B, S, D) against ``mem_kv`` (``cross_kv``),
    non-causal; ``use_cuda`` and ``impl`` go to ``kernels.ops.attention``."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    xin = rms_norm(x, p["ln"], cfg.norm_eps)
    q = (xin @ p["wq"]).view(b, s, h, hd).transpose(1, 2).contiguous()
    o = kops.attention(
        q, mem_kv["k"], mem_kv["v"], causal=False, softcap=cfg.attn_softcap,
        use_cuda=use_cuda, impl=impl,
    )
    o = o.transpose(1, 2).reshape(b, s, -1)
    return x + (o @ p["wo"]).to(x.dtype)
