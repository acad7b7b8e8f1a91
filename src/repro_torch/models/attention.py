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

Under a partition (``launch.shardings.partitioned``, a step on a mesh)
every block takes its parameters through ``fetch``, and where the
``"model"`` split is head-aligned (``n_heads % m == 0``) a rank computes
its own query heads: ``wq`` column-parallel on them, ``wk``/``wv`` too
when ``n_kv_heads % m == 0`` (else gathered, each local query head
reading its own K/V head), ``wo`` row-parallel, then the sum over
``"model"`` (Megatron's f, folded into each column-parallel product, and
g: ``col_product``, ``from_model``).  The sums run in f32 and round once,
so a bf16 layer rounds where the single process' does.  A split
that is not head-aligned gathers every weight and computes the block
replicated.  Decode reads a cache split on heads the same way; one split
on the sequence (``Partition.kv``) is attended chunk by chunk, each model
rank over its own, the partial max, sum and output gathered over
``"model"`` and combined: no cache byte crosses a collective.  There
the projections run on each rank's ``"model"`` columns and their
one-token outputs are gathered, and ``wo`` on its rows, so decode
gathers no attention weight.
"""
from __future__ import annotations

import dataclasses

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..kernels import ops as kops
from ..launch import shardings as SH
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


def _proj(x: torch.Tensor, p, name: str, cols) -> torch.Tensor:
    """``x @ p[name]``; for a name in ``cols`` (its columns this rank's
    ``"model"`` shard) a column-parallel product
    (``launch.shardings.col_product``)."""
    return SH.col_product(x, p[name]) if name in cols else x @ p[name]


def _gathered(x: torch.Tensor, p, names) -> list:
    """``x @ p[name]`` for each of ``names``, whose columns are this rank's
    ``"model"`` shard, each product's columns gathered over ``"model"`` in
    one all-gather (serving: one token's activations, not the weights)."""
    mine = [x @ p[n] for n in names]
    widths = [y.shape[-1] for y in mine]
    every = SH.gather_model(torch.cat(mine, dim=-1)[None], 0)  # (m, ..., sum(widths))
    return [part.movedim(0, -2).reshape(part.shape[1:-1] + (-1,))
            for part in every.split(widths, dim=-1)]


def _project_qkv(p, x: torch.Tensor, cfg: ArchConfig, pos: torch.Tensor, cols=(), gather=()):
    """x (B,S,D) -> q (B,H,S,hd), k/v (B,KV,S,hd), normed and rotated;
    ``cols``: the column-parallel projections (``_proj``); ``gather``: the
    projections on this rank's ``"model"`` columns whose outputs are
    gathered (``_gathered``)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    names = ("wq", "wk", "wv")
    got = dict(zip(gather, _gathered(x, p, gather))) if gather else {}
    y = {n: got[n] if n in got else _proj(x, p, n, cols) for n in names}
    q = y["wq"].view(b, s, h, hd).transpose(1, 2)
    k = y["wk"].view(b, s, kv, hd).transpose(1, 2)
    v = y["wv"].view(b, s, kv, hd).transpose(1, 2)
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


def _heads_plan(p, cfg: ArchConfig):
    """This rank's share of a layer's attention under the current
    partition: ``(local config, kv heads split?, the K/V head of each local
    query head)``, or None where the layer computes replicated (no
    partition, one model rank, or a split that is not head-aligned)."""
    part = SH.current_partition()
    if part is None or part.m == 1:
        return None
    m, i = part.m, part.rank_in_model
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if h % m or part.model_dim(p["wq"]) != 1 or part.model_dim(p["wo"]) != 0:
        return None
    kv_split = kv % m == 0 and part.model_dim(p["wk"]) == 1 and part.model_dim(p["wv"]) == 1
    hl = h // m
    lcfg = dataclasses.replace(cfg, n_heads=hl, n_kv_heads=kv // m if kv_split else kv,
                               head_dim=cfg.hd)
    sel = None if kv_split else [j // (h // kv) for j in range(i * hl, (i + 1) * hl)]
    return lcfg, kv_split, sel


def _tp_modes(kv_split: bool) -> Dict[str, str]:
    """``fetch`` modes of a head-aligned layer: ``wq``/``wo`` (and
    ``wk``/``wv`` where the K/V heads split) on this rank's shard; whole
    ``wk``/``wv`` otherwise compute the same K/V on every model rank."""
    kvm = "local" if kv_split else "replicated"
    return {"wq": "local", "wk": kvm, "wv": kvm, "wo": "local", "qn": "partial", "kn": "partial"}


def _local_kv(t: torch.Tensor, sel) -> torch.Tensor:
    """The K/V heads ``sel`` of this rank's query heads, from the whole
    ``t`` every model rank computes.  Under autograd they stay f32 (the
    attention widens them anyway) and the model ranks' parts of their
    gradient are summed in f32 (``to_model``), so a bf16 ``t``'s gradient
    rounds once, as the single process' group sum does."""
    if torch.is_grad_enabled() and t.requires_grad:
        return SH.to_model(t.float())[:, sel]
    return t[:, sel].contiguous()


def attn_prefill(
    p, x: torch.Tensor, cfg: ArchConfig, *, pos: torch.Tensor, causal: bool = True,
    window: int = 0, use_cuda: Optional[bool] = False, impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention x (B,S,D) -> (B,S,D), plus the KV cache
    ``{"k", "v"}`` (B, KV, S, hd): under a head-aligned partition this
    rank's query heads, and its K/V heads where they split too (else all
    of them).  ``use_cuda`` and ``impl`` go to ``kernels.ops.attention``."""
    b, s, _ = x.shape
    plan = _heads_plan(p, cfg)
    if plan is None:
        P = SH.fetch(p)
        xin = rms_norm(x, P["ln"], cfg.norm_eps)
        q, k, v = _project_qkv(P, xin, cfg, pos)
        kq, vq = k, v
    else:
        lcfg, kv_split, sel = plan
        P = SH.fetch(p, _tp_modes(kv_split))
        xin = rms_norm(x, P["ln"], cfg.norm_eps)
        q, k, v = _project_qkv(P, xin, lcfg, pos, ("wq", "wk", "wv") if kv_split else ("wq",))
        kq, vq = (k, v) if kv_split else (_local_kv(k, sel), _local_kv(v, sel))
    o = kops.attention(
        q, kq, vq, causal=causal, window=window, softcap=cfg.attn_softcap,
        use_cuda=use_cuda, impl=impl,
    )
    o = o.transpose(1, 2).reshape(b, s, -1)
    o = o @ P["wo"] if plan is None else SH.from_model(SH.row_product(o, P["wo"]), x.dtype)
    return x + o.to(x.dtype), {"k": k, "v": v}


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
    copy of the whole cache) and returned.  Under a partition the cache
    is this rank's part (``Partition.kv``): its K/V heads, or its chunk
    of the positions."""
    b = x.shape[0]
    kc, vc = cache["k"], cache["v"]
    kvh, chunk, hd = kc.shape[1], kc.shape[2], kc.shape[3]
    part = SH.current_partition()
    split = part.kv if part is not None and part.m > 1 else None
    s_cache, lo, plan, modes = chunk, 0, None, {}
    if split == "heads":
        plan = _heads_plan(p, cfg)
        if plan is None or not plan[1]:
            raise ValueError("attn_decode: a cache split on heads needs a head-aligned layer")
        modes = _tp_modes(True)
    elif split is not None:  # ("seq", s_cache): this rank's chunk of the positions
        s_cache = split[1]
        lo = part.rank_in_model * chunk
        # the projections on this rank's "model" columns, their one-token
        # outputs gathered; wo on its rows, then the sum over "model"
        modes = {w: "local" for w in ("wq", "wk", "wv") if part.model_dim(p[w]) == 1}
        if part.model_dim(p["wo"]) == 0:
            modes["wo"] = "local"
    if not 0 <= cache_len < s_cache:
        # the reference's dynamic_update_slice clamps the start: past the
        # end it would overwrite the last slot without a word
        raise ValueError(f"attn_decode: cache_len {cache_len} outside a cache of {s_cache} positions")
    lcfg = cfg if plan is None else plan[0]
    P = SH.fetch(p, modes)
    xin = rms_norm(x, P["ln"], cfg.norm_eps)
    posv = torch.full((b, 1), cache_len, dtype=torch.long, device=x.device)
    if cfg.rope == "mrope":
        posv = posv[None].expand(3, b, 1)
    gather = () if plan is not None else tuple(n for n in ("wq", "wk", "wv") if n in modes)
    q, k, v = _project_qkv(P, xin, lcfg, posv, gather=gather)
    if lo <= cache_len < lo + chunk:
        kc[:, :, cache_len - lo] = k[:, :, 0].to(kc.dtype)
        vc[:, :, cache_len - lo] = v[:, :, 0].to(vc.dtype)
    g = lcfg.n_heads // kvh
    # head h = kv * g + i reads kv-head kv: group the query heads instead
    # of repeating the cache
    qg = q.float().view(b, kvh, g, hd)
    s = (qg @ kc.float().transpose(-1, -2)) * float(cfg.hd) ** -0.5  # (B,KV,g,S)
    if cfg.attn_softcap > 0.0:
        s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
    idx = lo + torch.arange(chunk, device=x.device)
    mask = idx <= cache_len
    if window and window > 0:
        mask &= idx > cache_len - window
    if split is None or split == "heads":
        pr = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
        o = (pr @ vc.float()).to(x.dtype)  # (B,KV,g,hd)
    else:  # each rank's chunk: its max, sum and output, combined over "model"
        s = s.masked_fill(~mask, -1e30)
        top = s.amax(-1, keepdim=True)
        e = torch.exp(s - top)
        mine = torch.cat([top, e.sum(-1, keepdim=True), e @ vc.float()], dim=-1)
        every = SH.gather_model(mine[None], 0)  # (m, B, KV, g, 2 + hd)
        w = torch.exp(every[..., :1] - every[..., :1].amax(0))
        o = ((w * every[..., 2:]).sum(0) / (w * every[..., 1:2]).sum(0)).to(x.dtype)
    o = o.reshape(b, 1, -1)
    if plan is None and "wo" in modes:  # this rank's rows of wo
        n = o.shape[-1] // part.m
        o = o[..., part.rank_in_model * n:(part.rank_in_model + 1) * n]
    if plan is None and "wo" not in modes:
        o = o @ P["wo"]
    else:
        o = SH.from_model(SH.row_product(o, P["wo"]), x.dtype)
    return x + o.to(x.dtype), {"k": kc, "v": vc}


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
    p = SH.fetch({k: p[k] for k in ("wk", "wv")})
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
    p = SH.fetch({k: p[k] for k in ("ln", "wq", "wo")})
    xin = rms_norm(x, p["ln"], cfg.norm_eps)
    q = (xin @ p["wq"]).view(b, s, h, hd).transpose(1, 2).contiguous()
    o = kops.attention(
        q, mem_kv["k"], mem_kv["v"], causal=False, softcap=cfg.attn_softcap,
        use_cuda=use_cuda, impl=impl,
    )
    o = o.transpose(1, 2).reshape(b, s, -1)
    return x + (o @ p["wo"]).to(x.dtype)
