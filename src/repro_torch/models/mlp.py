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

The dense dispatch keeps the reference's four sharding hints
(``_HINTS``, ``launch.shardings.constrain``, gated on expert parallelism
as the reference gates them: ``moe_hints``).  They bind only on DTensor
activations, and no path gives the dispatch those yet: the mesh train
step runs the forward on plain tensors, so the hints wait for
compute-side tensor parallelism.  When a mesh train step splits the
batch over data ranks (``launch.shardings.batch_split``) each rank's
capacity and arrival order are the whole batch's, as under the
reference's ``jit``, so a rank keeps and drops exactly the pairs the
single process does.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..launch.shardings import constrain, current_split, is_placed
from ..launch.mesh import mesh_shape
from .common import ArchConfig, gen_device, init_norm, rms_norm, scaled_init
from .moe_routing import calibrated_dispatch, dense_capacity, router_pairs


FSDP = ("pod", "data")
# the dense dispatch's hints, a spec a site: the gathered pairs (t*k, d)
# and the combined output (t, d) over FSDP x 'model', the dispatch buffer
# (e, cap, d) experts on 'model' with d FSDP-aligned with the expert
# weights' contraction dim, the experts' output (e, cap, d) feature-sharded
_HINTS = {"src": (FSDP, "model"), "disp": ("model", None, FSDP),
          "out": (None, None, "model"), "combined": (FSDP, "model")}


def moe_hints(xf, e: int):
    """``C(arr, site)``: ``arr`` under ``_HINTS[site]`` (``constrain``), or
    as it is when experts are expert-parallel, as the reference gates its
    hints: when ``e`` experts cannot spread over ``xf``'s mesh's ``'model'``
    axis (grok-1: 8 against 16) the dispatch buffers' feature dim goes to
    ``'model'``, so the scatter stays local to a shard; when EP engages
    (``e % model == 0``, kimi-k2's 384) the layout is left alone.  A no-op
    for a plain ``xf``."""
    ep = False
    if is_placed(xf):
        ms = mesh_shape(xf.device_mesh)
        ep = "model" in ms.axis_names and e % ms.shape["model"] == 0

    def C(arr, site: str):
        return arr if ep else constrain(arr, *_HINTS[site])

    return C


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

    flat_e, flat_w, flat_tok = router_pairs(p, xf, cfg)
    onehot = F.one_hot(flat_e, e)  # (t*k, e)
    pos_in_e = torch.cumsum(onehot, dim=0) - onehot  # rank per expert
    my_pos = pos_in_e.gather(1, flat_e[:, None])[:, 0]
    split = current_split()
    if split is None:
        cap = dense_capacity(cfg, t)
        keep = my_pos < cap
    else:  # this rank's tokens follow the earlier slices' in arrival order
        before, t_all = split.arrivals(onehot.sum(0), t)
        cap = dense_capacity(cfg, t_all)
        keep = my_pos + before[flat_e] < cap

    C = moe_hints(xf, e)

    slot = torch.where(keep, flat_e * cap + my_pos, e * cap)  # overflow -> trash
    src = C(xf[flat_tok], "src")
    disp = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=xf.device).index_copy(0, slot, src)
    disp = C(disp[:-1].reshape(e, cap, d), "disp")

    # expert computation: one batched product per weight
    gi = torch.bmm(disp, p["wg"])
    hi = torch.bmm(disp, p["wi"])
    act = F.silu(gi.float()).to(hi.dtype) * hi
    out_e = C(torch.bmm(act, p["wo"]), "out")  # (e, cap, d)

    gathered = torch.cat([out_e.reshape(e * cap, d), out_e.new_zeros((1, d))], dim=0)
    per_pair = (gathered[slot] * flat_w[:, None].to(gathered.dtype)).to(xf.dtype)
    per_tok = per_pair.reshape(t, k, d)  # flat_tok is repeat(arange(t), k)
    combined = torch.zeros((t, d), dtype=xf.dtype, device=xf.device)
    for c in range(k):
        combined = combined + per_tok[:, c]
    combined = C(combined, "combined")
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
        if current_split() is not None:
            raise NotImplementedError("the calibrated MoE route has no split-batch train step: "
                                      "its measured capacities are a rank's own")
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
