"""Gated MLP (SwiGLU) and Mixture-of-Experts feed-forward layers
(counterpart of ``repro/models/mlp.py``).

The MoE dispatch has two routes, selected by ``cfg.moe_route``:

- ``"dense"`` (default): the Switch-style capacity scatter into
  ``(e*cap+1, d)`` slots; over-capacity (token, expert) pairs fall
  through to the residual, and the stats count them;
- ``"calibrated"``: the routed-exchange path (``models.moe_routing``),
  the count-calibrated, heavy-hitter-aware ``routed_all_to_all`` the join
  engines run on, with measured per-expert capacities and exact drop
  accounting.

The reference's sharding hints for its TPU mesh have no counterpart here.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import ArchConfig, gen_device, init_norm, rms_norm, scaled_init
from .moe_routing import calibrated_dispatch, dense_capacity, router_pairs


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


def _swiglu(p, xin: torch.Tensor) -> torch.Tensor:
    # SiLU in f32, cast back before the product with xin @ wi
    h = F.silu((xin @ p["wg"]).float()).to(xin.dtype) * (xin @ p["wi"])
    return h @ p["wo"]


def mlp_forward(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    xin = rms_norm(x, p["ln"], cfg.norm_eps)
    return x + _swiglu(p, xin).to(x.dtype)


# ------------------------------------------------------------------- MoE
def init_moe(gen: torch.Generator, cfg: ArchConfig) -> nn.ParameterDict:
    """``router (d, e)`` in f32 whatever the model's dtype, the experts'
    ``wi``/``wg (e, d, f)`` and ``wo (e, f, d)``, the norm gain, and with
    shared experts ``shared``, one MLP of ``moe_d_ff * n_shared_experts``."""
    d = cfg.d_model
    e = cfg.n_experts
    f = cfg.moe_d_ff or cfg.d_ff
    dt = cfg.torch_dtype
    p = nn.ParameterDict({
        "router": scaled_init(gen, (d, e), 0, torch.float32),
        "wi": scaled_init(gen, (e, d, f), 1, dt),
        "wg": scaled_init(gen, (e, d, f), 1, dt),
        "wo": scaled_init(gen, (e, f, d), 1, dt),
        "ln": init_norm(d, dt, gen_device(gen)),
    })
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg, d_ff=f * cfg.n_shared_experts)
    return p


def _dense_dispatch(p, xf: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    """Switch-style capacity scatter.  Over-capacity pairs fall through to
    the residual; the drop is silent in the output but counted in stats.

    Each pair's rank within its expert is its arrival order (token-major,
    ``cumsum(one_hot) - one_hot``).  Only the trash slot ``e*cap`` takes
    more than one row, so the index copy into the padded buffer is exact;
    the combine adds each token's k weighted slices onto zeros in choice
    order, in the model's dtype, on any device."""
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.topk
    cap = dense_capacity(cfg, t)

    flat_e, flat_w, flat_tok = router_pairs(p, xf, cfg)
    onehot = F.one_hot(flat_e, e)  # (t*k, e)
    pos_in_e = torch.cumsum(onehot, dim=0) - onehot  # rank per expert
    my_pos = pos_in_e.gather(1, flat_e[:, None])[:, 0]
    keep = my_pos < cap

    slot = torch.where(keep, flat_e * cap + my_pos, e * cap)  # overflow -> trash
    src = xf[flat_tok]
    disp = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=xf.device).index_copy(0, slot, src)
    disp = disp[:-1].reshape(e, cap, d)

    # expert computation: one batched product per weight
    gi = torch.bmm(disp, p["wg"])
    hi = torch.bmm(disp, p["wi"])
    act = F.silu(gi.float()).to(hi.dtype) * hi
    out_e = torch.bmm(act, p["wo"])  # (e, cap, d)

    gathered = torch.cat([out_e.reshape(e * cap, d), out_e.new_zeros((1, d))], dim=0)
    per_pair = (gathered[slot] * flat_w[:, None].to(gathered.dtype)).to(xf.dtype)
    per_tok = per_pair.reshape(t, k, d)  # flat_tok is repeat(arange(t), k)
    combined = torch.zeros((t, d), dtype=xf.dtype, device=xf.device)
    for c in range(k):
        combined = combined + per_tok[:, c]
    stats = {
        "routed": keep.sum().to(torch.int32),
        "dropped": (~keep).sum().to(torch.int32),
        "heavy": torch.zeros((), dtype=torch.int32, device=xf.device),
    }
    return combined, stats


def moe_forward_stats(p, x: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    """MoE layer with routing stats: (output, ``{routed, dropped, heavy}``
    int32 scalars).  The route is ``cfg.moe_route``; both routes share
    ``router_pairs``, so comparing them isolates dispatch mechanics."""
    b, s, d = x.shape
    t = b * s
    xin = rms_norm(x, p["ln"], cfg.norm_eps)
    xf = xin.reshape(t, d)
    if cfg.moe_route == "calibrated":
        combined, stats = calibrated_dispatch(p, xf, cfg)
    elif cfg.moe_route == "dense":
        combined, stats = _dense_dispatch(p, xf, cfg)
    else:
        raise ValueError(f"moe_route {cfg.moe_route!r} not in ('dense', 'calibrated')")

    y = combined.to(x.dtype)
    if "shared" in p:
        y = y + _swiglu(p["shared"], xf).to(x.dtype)
    return x + y.reshape(b, s, d), stats


def moe_forward(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Top-k MoE layer without the stats (``moe_forward_stats``)."""
    out, _ = moe_forward_stats(p, x, cfg)
    return out
