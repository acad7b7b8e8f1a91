"""xLSTM blocks (arXiv:2405.04517; counterpart of ``repro/models/xlstm.py``):
mLSTM, a matrix memory in chunked linear-attention form (masked products
within a chunk, a loop over chunks carrying the state), and sLSTM, a
scalar memory whose recurrence runs a step at a time with block-diagonal
per-head recurrent weights.

Gating as the reference has it: an exponential input gate (the mLSTM's
without a stabilizer, the sLSTM's with one), a sigmoid forget gate
accumulated in log space, and a ``max(|n|, 1)`` denominator.  The
reference has no Pallas kernel here (XLA einsums and ``lax.scan``); the
port is plain PyTorch on any device, its scans in f32.

One departure: the reference pads the mLSTM's gates with a two-pair
``pad_width`` on ``(B, S, H)`` arrays, so any sequence longer than the
chunk and off it raises there.  The port pads them on the sequence axis,
the input gate with -1e30 (a padded step writes nothing) and the forget
gate with 0 (it keeps the state).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import ArchConfig, gen_device, init_norm, rms_norm, scaled_init


def _heads(cfg: ArchConfig) -> Tuple[int, int]:
    h = cfg.n_heads
    return h, cfg.d_model // h


# =============================================================== mLSTM
def init_mlstm(gen: Optional[torch.Generator], cfg: ArchConfig) -> nn.ParameterDict:
    """Up-projection by 2 (``w_up`` to ``[x_in, z]``), q/k/v, the f32 gate
    projection ``w_if`` with bias ``b_if`` (input gates 0, forget gates 3:
    sigmoid(3) ~ 0.95), and the down-projection."""
    d = cfg.d_model
    h, _ = _heads(cfg)
    up = 2 * d
    dt, dev = cfg.torch_dtype, gen_device(gen)
    return nn.ParameterDict({
        "ln": init_norm(d, dt, dev),
        "w_up": scaled_init(gen, (d, 2 * up), 0, dt),
        "wq": scaled_init(gen, (up, up), 0, dt),
        "wk": scaled_init(gen, (up, up), 0, dt),
        "wv": scaled_init(gen, (up, up), 0, dt),
        "w_if": scaled_init(gen, (up, 2 * h), 0, torch.float32),
        "b_if": nn.Parameter(
            torch.cat([torch.zeros(h, device=dev), torch.full((h,), 3.0, device=dev)]),
            requires_grad=False,
        ),
        "ln_out": init_norm(up, dt, dev),
        "w_down": scaled_init(gen, (up, d), 0, dt),
    })


def mlstm_chunked(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,  # (B, S, H, P)
    li: torch.Tensor, lf: torch.Tensor,  # (B, S, H) f32 log input / forget gates
    chunk: int,
    init_c: Optional[torch.Tensor] = None,  # (B, H, P, P)
    init_n: Optional[torch.Tensor] = None,  # (B, H, P)
):
    """The chunked scan: ``(y (B, S, H, P) f32, C (B, H, P, P), n (B, H, P))``."""
    b, s, h, p = q.shape
    cq = min(chunk, s)
    pad = -s % cq
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        li = F.pad(li, (0, 0, 0, pad), value=-1e30)
        lf = F.pad(lf, (0, 0, 0, pad))
    nc = q.shape[1] // cq
    # heads before chunk positions: (b, nc, h, cq, ...)
    qc, kc, vc = (t.reshape(b, nc, cq, h, p).float().permute(0, 1, 3, 2, 4) for t in (q, k, v))
    lic = li.reshape(b, nc, cq, h).permute(0, 1, 3, 2)
    cum = torch.cumsum(lf.reshape(b, nc, cq, h).permute(0, 1, 3, 2), dim=-1)  # inclusive
    tot = cum[..., -1:]  # (b, nc, h, 1)

    # within a chunk: w[i, j] = exp(cum_i - cum_j + li_j) for j <= i
    logw = cum[..., :, None] - cum[..., None, :] + lic[..., None, :]
    i = torch.arange(cq, device=q.device)
    w = torch.exp(logw.masked_fill(i[:, None] < i[None, :], float("-inf")))  # (b, nc, h, i, j)
    y = ((qc @ kc.transpose(-1, -2)) * w) @ vc  # (b, nc, h, i, p)
    n_intra = w @ kc  # the denominator's terms

    # each chunk's state: C_c = sum_j exp(tot - cum_j + li_j) k_j v_j^T
    wk = kc * torch.exp(tot - cum + lic)[..., None]
    c_chunk = wk.transpose(-1, -2) @ vc  # (b, nc, h, p, p)
    n_chunk = wk.sum(dim=-2)  # (b, nc, h, p)
    decay = torch.exp(tot[..., 0])  # (b, nc, h)

    c = init_c if init_c is not None else q.new_zeros((b, h, p, p), dtype=torch.float32)
    n = init_n if init_n is not None else q.new_zeros((b, h, p), dtype=torch.float32)
    c_prev, n_prev = [], []
    for j in range(nc):
        c_prev.append(c)
        n_prev.append(n)
        c = c * decay[:, j, :, None, None] + c_chunk[:, j]
        n = n * decay[:, j, :, None] + n_chunk[:, j]
    c_prev = torch.stack(c_prev, dim=1)  # (b, nc, h, p, p)
    n_prev = torch.stack(n_prev, dim=1)  # (b, nc, h, p)

    dec = torch.exp(cum)[..., None]  # (b, nc, h, cq, 1)
    y = y + (qc @ c_prev) * dec
    n_inter = (qc @ n_prev[..., None]) * dec
    n_tot = (qc * n_intra).sum(dim=-1, keepdim=True) + n_inter
    y = y / torch.clamp(n_tot.abs(), min=1.0)
    y = y.permute(0, 1, 3, 2, 4).reshape(b, nc * cq, h, p)[:, :s]
    return y, c, n


def _mlstm_in(p, x: torch.Tensor, cfg: ArchConfig):
    """Norm, up-projection, q/k/v (k scaled by hd**-0.5 in the model's
    dtype) and the f32 gate pre-activations ``(..., 2, H)``."""
    h, _ = _heads(cfg)
    upz = rms_norm(x, p["ln"], cfg.norm_eps) @ p["w_up"]
    u, z = upz.chunk(2, dim=-1)
    up = u.shape[-1]
    hd = up // h
    q = (u @ p["wq"]).unflatten(-1, (h, hd))
    k = ((u @ p["wk"]) * hd**-0.5).unflatten(-1, (h, hd))
    v = (u @ p["wv"]).unflatten(-1, (h, hd))
    gates = (u.float() @ p["w_if"] + p["b_if"]).unflatten(-1, (2, h))
    return q, k, v, gates, z


def _mlstm_out(p, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, cfg: ArchConfig):
    y = rms_norm(y.to(x.dtype), p["ln_out"], cfg.norm_eps)
    y = y * F.silu(z.float()).to(x.dtype)
    return x + (y @ p["w_down"]).to(x.dtype)


def mlstm_prefill(p, x: torch.Tensor, cfg: ArchConfig):
    """Full-sequence forward, x (B, S, D), and the ``{c, n}`` state after it."""
    b, s, _ = x.shape
    q, k, v, gates, z = _mlstm_in(p, x, cfg)
    li = gates[..., 0, :]  # log input gate (exponential gating)
    lf = F.logsigmoid(gates[..., 1, :])
    y, c, n = mlstm_chunked(q, k, v, li, lf, cfg.chunk)
    return _mlstm_out(p, x, y.reshape(b, s, -1), z, cfg), {"c": c, "n": n}


def mlstm_init_state(cfg: ArchConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    h, _ = _heads(cfg)
    hd = 2 * cfg.d_model // h
    return {
        "c": torch.zeros((batch, h, hd, hd), device=device),
        "n": torch.zeros((batch, h, hd), device=device),
    }


def mlstm_decode(p, x: torch.Tensor, state: Dict[str, torch.Tensor], cfg: ArchConfig):
    """One-token step, x (B, 1, D): ``(out, new state)``."""
    b = x.shape[0]
    q, k, v, gates, z = (t[:, 0] for t in _mlstm_in(p, x, cfg))
    q, k, v = q.float(), k.float(), v.float()  # (B, H, P)
    i_t = torch.exp(gates[:, 0])[..., None]  # (B, H, 1)
    f_t = torch.sigmoid(gates[:, 1])[..., None]
    c = state["c"] * f_t[..., None] + i_t[..., None] * (k[..., :, None] * v[..., None, :])
    n = state["n"] * f_t + i_t * k
    num = (q[..., None, :] @ c)[..., 0, :]  # (B, H, P)
    den = torch.clamp((q * n).sum(dim=-1).abs(), min=1.0)
    y = (num / den[..., None]).reshape(b, -1)
    return _mlstm_out(p, x[:, 0], y, z, cfg)[:, None], {"c": c, "n": n}


# =============================================================== sLSTM
def init_slstm(gen: Optional[torch.Generator], cfg: ArchConfig) -> nn.ParameterDict:
    """Input projections of the ``(z, i, f, o)`` gates, the block-diagonal
    recurrent weights ``r (H, hd, 4 hd)`` f32 (fan-in hd), the f32 bias,
    and the fused up/down MLP (factor 4/3)."""
    d = cfg.d_model
    h, hd = _heads(cfg)
    dt, dev = cfg.torch_dtype, gen_device(gen)
    return nn.ParameterDict({
        "ln": init_norm(d, dt, dev),
        "w_in": scaled_init(gen, (d, 4 * d), 0, dt),
        "r": scaled_init(gen, (h, hd, 4 * hd), 1, torch.float32),
        "b": nn.Parameter(torch.zeros(4 * d, device=dev), requires_grad=False),
        "ln_out": init_norm(d, dt, dev),
        "w_up": scaled_init(gen, (d, (4 * d) // 3), 0, dt),
        "w_down": scaled_init(gen, ((4 * d) // 3, d), 0, dt),
    })


def slstm_init_state(cfg: ArchConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    h, hd = _heads(cfg)
    return {
        "c": torch.zeros((batch, h, hd), device=device),
        "n": torch.zeros((batch, h, hd), device=device),
        "h": torch.zeros((batch, h, hd), device=device),
        "m": torch.full((batch, h, hd), -1e30, device=device),
    }


def slstm_cell(p, cfg: ArchConfig, xg: torch.Tensor, st: Dict[str, torch.Tensor]):
    """One step: ``xg`` (B, 4D) f32 pre-activations from the input.  The
    gates interleave per unit: the summed pre-activations reshape to
    ``(B, H, hd, 4)`` with the gate on the last axis."""
    h, hd = _heads(cfg)
    b = xg.shape[0]
    rec = torch.einsum("bhp,hpq->bhq", st["h"], p["r"]).reshape(b, 4 * h * hd)
    g = (xg + rec + p["b"]).reshape(b, h, hd, 4)
    zt = torch.tanh(g[..., 0])
    it = g[..., 1]  # log-space input gate
    ft = F.logsigmoid(g[..., 2])
    ot = torch.sigmoid(g[..., 3])
    m_new = torch.maximum(ft + st["m"], it)  # the stabilizer
    ip = torch.exp(it - m_new)
    fp = torch.exp(ft + st["m"] - m_new)
    c = fp * st["c"] + ip * zt
    n = fp * st["n"] + ip
    return {"c": c, "n": n, "h": ot * c / torch.clamp(n, min=1.0), "m": m_new}


def _slstm_out(p, x: torch.Tensor, hs: torch.Tensor, cfg: ArchConfig):
    """Norm the cell outputs onto the residual, then the gelu MLP."""
    y = x + rms_norm(hs.to(x.dtype), p["ln_out"], cfg.norm_eps)
    # jax.nn.gelu's default is the tanh approximation
    hmid = F.gelu((y @ p["w_up"]).float(), approximate="tanh").to(x.dtype)
    return y + (hmid @ p["w_down"]).to(x.dtype)


def slstm_prefill(p, x: torch.Tensor, cfg: ArchConfig):
    """Full-sequence forward, x (B, S, D): one cell step a position (the
    reference's per-step ``lax.scan``), and the state after the last."""
    b, s, d = x.shape
    xg = (rms_norm(x, p["ln"], cfg.norm_eps) @ p["w_in"]).float()  # (B, S, 4D)
    st = slstm_init_state(cfg, b, x.device)
    hs = []
    for t in range(s):
        st = slstm_cell(p, cfg, xg[:, t], st)
        hs.append(st["h"])
    return _slstm_out(p, x, torch.stack(hs, dim=1).reshape(b, s, d), cfg), st


def slstm_decode(p, x: torch.Tensor, state: Dict[str, torch.Tensor], cfg: ArchConfig):
    """One-token step, x (B, 1, D): ``(out, new state)``."""
    b, _, d = x.shape
    xg = (rms_norm(x, p["ln"], cfg.norm_eps)[:, 0] @ p["w_in"]).float()
    st = slstm_cell(p, cfg, xg, state)
    return _slstm_out(p, x, st["h"].reshape(b, 1, d), cfg), st
