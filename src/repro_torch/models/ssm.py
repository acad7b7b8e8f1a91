"""Mamba2 block with the chunked SSD scan (counterpart of
``repro/models/ssm.py``): within a chunk the scan is masked matrix
products, across chunks a loop carries the ``(B, H, P, N)`` state (the
reference's ``lax.scan`` over chunk boundaries).

State-space semantics per head h (scalar A):
  s_t = exp(dt_t A) s_{t-1} + dt_t B_t x_t^T ;  y_t = C_t . s_t + D x_t

The reference has no Pallas kernel here (XLA einsums and ``lax.scan``),
and neither has the port: this is plain PyTorch on any device.  The scan
runs in f32 whatever the model's dtype.

Precision follows the reference step for step.  The prefill's depthwise
conv multiplies and adds in the model's dtype (the ``conv_kernel``
products summed left to right); the decode's conv runs in f32 over an f32
history.  In an f32 model the two agree, so the f32 parity tests cannot
tell them apart; a bf16 model rounds the prefill's conv at every add.

One departure: a prompt shorter than ``conv_kernel - 1`` leaves a conv
tail of zeros on the left (the causal conv's own padding), where the
reference keeps too few rows and its next decode fails.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import ArchConfig, gen_device, init_norm, rms_norm, scaled_init


def _dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """``(d_in, heads, head width, state)``: heads of 64 when ``d_in``
    divides by 64, unless ``cfg.ssm_heads`` fixes the count."""
    d_in = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    p = 64 if d_in % 64 == 0 else d_in // max(1, cfg.ssm_heads or 1)
    if cfg.ssm_heads:
        h = cfg.ssm_heads
        p = d_in // h
    else:
        h = d_in // p
    return d_in, h, p, n


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` without ``F.softplus``'s linear cut-over at 20
    (``jax.nn.softplus`` is ``logaddexp(x, 0)``)."""
    return torch.logaddexp(x, x.new_zeros(()))


def init_mamba(gen: Optional[torch.Generator], cfg: ArchConfig) -> nn.ParameterDict:
    """``w_in`` projects to ``[z, x, B, C, dt]``; ``a_log``, ``dt_bias``
    and ``d_skip`` are f32 in any model (A = -exp(0) = -1, softplus(-2) ~
    0.13, D = 1)."""
    d = cfg.d_model
    d_in, h, _, n = _dims(cfg)
    dt, dev = cfg.torch_dtype, gen_device(gen)
    conv_ch = d_in + 2 * n  # x, B, C go through the depthwise conv
    return nn.ParameterDict({
        "ln": init_norm(d, dt, dev),
        "w_in": scaled_init(gen, (d, 2 * d_in + 2 * n + h), 0, dt),
        "conv": scaled_init(gen, (cfg.conv_kernel, conv_ch), 0, dt),
        "a_log": nn.Parameter(torch.zeros(h, device=dev), requires_grad=False),
        "dt_bias": nn.Parameter(torch.full((h,), -2.0, device=dev), requires_grad=False),
        "d_skip": nn.Parameter(torch.ones(h, device=dev), requires_grad=False),
        "ln_out": init_norm(d_in, dt, dev),
        "w_out": scaled_init(gen, (d_in, d), 0, dt),
    })


def segsum(logdecay: torch.Tensor) -> torch.Tensor:
    """``L[i, j] = sum_{k=j+1..i} logdecay[k]`` for i >= j, else -inf:
    ``(..., Q) -> (..., Q, Q)``."""
    q = logdecay.shape[-1]
    cs = torch.cumsum(logdecay, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(q, device=logdecay.device)
    return diff.masked_fill(i[:, None] < i[None, :], float("-inf"))


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) f32, positive
    a: torch.Tensor,  # (H,) f32, negative
    bmat: torch.Tensor,  # (B, S, N)
    cmat: torch.Tensor,  # (B, S, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan: ``(y (B, S, H, P) f32, final state (B, H, P, N))``.
    A sequence off the chunk is padded with zero steps (dt = 0: no decay,
    no input), which leave the state as it is."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    pad = -s % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, bmat, cmat = (F.pad(t, (0, 0, 0, pad)) for t in (dt, bmat, cmat))
    nc = x.shape[1] // q
    # heads before chunk positions: (b, nc, h, q, ...)
    xc = x.reshape(b, nc, q, h, p).float().permute(0, 1, 3, 2, 4)
    dtc = dt.reshape(b, nc, q, h).permute(0, 1, 3, 2)
    bc = bmat.reshape(b, nc, q, n).float()
    cc = cmat.reshape(b, nc, q, n).float()
    da = dtc * a[:, None]  # (b, nc, h, q) log-decay a step
    xdt = xc * dtc[..., None]  # dt-weighted input

    # within a chunk: y = ((C B^T) o exp(L)) @ (x dt)
    cb = cc @ bc.transpose(-1, -2)  # (b, nc, q, q)
    att = cb[:, :, None] * torch.exp(segsum(da))  # (b, nc, h, q, q)
    y = att @ xdt  # (b, nc, h, q, p)

    # each chunk's contribution to the state: sum_j exp(sum_{k>j} da_k) B_j (x dt)_j
    cum = torch.cumsum(da, dim=-1)  # (b, nc, h, q)
    tot = cum[..., -1]  # (b, nc, h)
    xw = xdt * torch.exp(tot[..., None] - cum)[..., None]
    chunk_state = xw.transpose(-1, -2) @ bc[:, :, None]  # (b, nc, h, p, n)

    # across chunks: the state entering each chunk
    state = init_state if init_state is not None else x.new_zeros((b, h, p, n), dtype=torch.float32)
    decay = torch.exp(tot)  # (b, nc, h)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * decay[:, c, :, None, None] + chunk_state[:, c]
    prev_states = torch.stack(prev, dim=1)  # (b, nc, h, p, n)

    # y_inter[i] = (C_i . state_prev) * exp(cum_i)
    y = y + (cc[:, :, None] @ prev_states.transpose(-1, -2)) * torch.exp(cum)[..., None]
    y = y.permute(0, 1, 3, 2, 4).reshape(b, nc * q, h, p)[:, :s]
    return y, state


def _in_proj(p, x: torch.Tensor, cfg: ArchConfig):
    """Norm and input projection: ``(z, x, B, C, dt)`` on the last axis."""
    d_in, h, _, n = _dims(cfg)
    zxbcdt = rms_norm(x, p["ln"], cfg.norm_eps) @ p["w_in"]
    return torch.split(zxbcdt, [d_in, d_in, n, n, h], dim=-1)


def _out_proj(p, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, cfg: ArchConfig):
    """Gate ``y`` (f32, ``(..., d_in)``) by SiLU(z), norm, project, add to x."""
    y = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    y = rms_norm(y, p["ln_out"], cfg.norm_eps)
    return x + (y @ p["w_out"]).to(x.dtype)


def mamba_prefill(p, x: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward, x (B, S, D), and the recurrent state for
    decode: ``conv`` (B, k - 1, d_in + 2N) f32 and ``ssm`` (B, H, P, N)
    f32."""
    b, s, _ = x.shape
    d_in, h, hp, n = _dims(cfg)
    z, xi, bm, cm, dt = _in_proj(p, x, cfg)
    # depthwise causal conv over (x, B, C), in the model's dtype
    xbc = torch.cat([xi, bm, cm], dim=-1)
    k = cfg.conv_kernel
    xbc_pad = F.pad(xbc, (0, 0, k - 1, 0))
    conv = xbc_pad[:, 0:s] * p["conv"][0]
    for i in range(1, k):
        conv = conv + xbc_pad[:, i:i + s] * p["conv"][i]
    conv_tail = xbc_pad[:, s:].float()  # the last k - 1 rows, zeros before the prompt
    conv = F.silu(conv.float()).to(x.dtype)
    xi, bm, cm = torch.split(conv, [d_in, n, n], dim=-1)
    a = -torch.exp(p["a_log"])
    dtp = softplus(dt.float() + p["dt_bias"])
    xh = xi.reshape(b, s, h, hp)
    y, state = ssd_chunked(xh, dtp, a, bm, cm, cfg.chunk)
    y = y + xh.float() * p["d_skip"][:, None]
    return _out_proj(p, x, y.reshape(b, s, d_in), z, cfg), {"conv": conv_tail, "ssm": state}


def mamba_init_state(cfg: ArchConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    d_in, h, p, n = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, d_in + 2 * n), device=device),
        "ssm": torch.zeros((batch, h, p, n), device=device),
    }


def mamba_decode(p, x: torch.Tensor, state: Dict[str, torch.Tensor], cfg: ArchConfig):
    """One-token recurrent step, x (B, 1, D): ``(out, new state)``."""
    b = x.shape[0]
    d_in, h, hp, n = _dims(cfg)
    z, xi, bm, cm, dt = (t[:, 0] for t in _in_proj(p, x, cfg))
    xbc = torch.cat([xi, bm, cm], dim=-1)
    hist = torch.cat([state["conv"], xbc.float()[:, None]], dim=1)  # (B, k, ch) f32
    conv = torch.einsum("bkc,kc->bc", hist, p["conv"].float())
    conv = F.silu(conv).to(x.dtype)
    xi, bm, cm = torch.split(conv, [d_in, n, n], dim=-1)
    a = -torch.exp(p["a_log"])
    dtp = softplus(dt.float() + p["dt_bias"])  # (B, H)
    xh = xi.reshape(b, h, hp).float()
    ssm = state["ssm"] * torch.exp(dtp * a)[:, :, None, None] + (
        (xh * dtp[:, :, None])[..., None] * bm.float()[:, None, None, :]
    )
    y = (ssm @ cm.float()[:, None, :, None])[..., 0]  # (B, H, P)
    y = y + xh * p["d_skip"][None, :, None]
    out = _out_proj(p, x[:, 0], y.reshape(b, d_in), z, cfg)
    return out[:, None], {"conv": hist[:, 1:], "ssm": ssm}
