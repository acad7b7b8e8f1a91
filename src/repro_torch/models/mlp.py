"""Gated MLP (SwiGLU) feed-forward layer (counterpart of
``repro/models/mlp.py``).  The MoE layer waits for its slice
(ROADMAP queue A, item 'MoE')."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ArchConfig, gen_device, init_norm, rms_norm, scaled_init


def init_mlp(gen: torch.Generator, cfg: ArchConfig, d_ff: int = 0) -> nn.ParameterDict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = cfg.torch_dtype
    return nn.ParameterDict({
        "wi": scaled_init(gen, (d, f), 0, dt),
        "wg": scaled_init(gen, (d, f), 0, dt),
        "wo": scaled_init(gen, (f, d), 0, dt),
        "ln": init_norm(d, dt, gen_device(gen)),
    })


def mlp_forward(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    xin = rms_norm(x, p["ln"], cfg.norm_eps)
    # SiLU in f32, cast back before the product with xin @ wi
    h = F.silu((xin @ p["wg"]).float()).to(x.dtype) * (xin @ p["wi"])
    return x + (h @ p["wo"]).to(x.dtype)
