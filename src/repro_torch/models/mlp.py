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

Under a partition (``launch.shardings.partitioned``) the layers compute
on their ``"model"`` shards where the reference's rules split them: the
gated MLP column-parallel on ``wi``/``wg`` and row-parallel on ``wo``,
then the sum over ``"model"`` (Megatron's f and g, summed in f32 and
rounded once, ``launch.shardings.col_product``, ``row_product``,
``from_model``); the dense MoE
dispatch with expert parallelism where ``"model"`` shards the experts
(each model rank runs its experts' slots for every token its data slice
holds) and a Megatron split of every expert's FF where it shards their
hidden dim (grok-1's 8 experts on 16).  A layer the rules do not split
so, and the calibrated route, gather their weights and compute
replicated.

The dense dispatch keeps the reference's four sharding hints
(``_HINTS``, ``launch.shardings.constrain``, gated on expert parallelism
as the reference gates them: ``moe_hints``).  They bind only on DTensor
activations, which no path gives the dispatch: the partitioned layers
place their collectives by hand, in the layouts the hints ask for.  When
a mesh train step splits the batch over data ranks
(``launch.shardings.batch_split``) each rank's capacity and arrival
order are the whole batch's, as under the reference's ``jit``, so a rank
keeps and drops exactly the pairs the single process does.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..launch import shardings as SH
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


def _swiglu(p, xin: torch.Tensor, split: bool = False) -> torch.Tensor:
    """The gated MLP's output; ``split``: this rank's part of it, on its
    ``"model"`` columns of ``wi``/``wg`` and rows of ``wo``, in f32
    (``launch.shardings.col_product``, ``row_product``)."""
    mm = SH.col_product if split else torch.matmul
    # SiLU in f32, cast back before the product with xin @ wi
    h = F.silu(mm(xin, p["wg"]).float()).to(xin.dtype) * mm(xin, p["wi"])
    return SH.row_product(h, p["wo"]) if split else h @ p["wo"]


#: ``fetch`` modes of a gated MLP split on its hidden dim
_FF_LOCAL = {"wi": "local", "wg": "local", "wo": "local"}


def _ff_split(p) -> bool:
    """Whether the current partition's ``"model"`` splits this gated MLP's
    hidden dim (``wi``/``wg`` on their columns, ``wo`` on its rows)."""
    part = SH.current_partition()
    return (part is not None and part.m > 1 and part.model_dim(p["wi"]) == 1
            and part.model_dim(p["wg"]) == 1 and part.model_dim(p["wo"]) == 0)


def mlp_forward(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if _ff_split(p):
        P = SH.fetch(p, _FF_LOCAL)
        xin = rms_norm(x, P["ln"], cfg.norm_eps)
        return x + SH.from_model(_swiglu(P, xin, split=True), x.dtype)
    P = SH.fetch(p)
    xin = rms_norm(x, P["ln"], cfg.norm_eps)
    return x + _swiglu(P, xin).to(x.dtype)


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


def _moe_layout(p) -> str:
    """How the current partition's ``"model"`` splits a MoE layer's
    experts: ``ep`` (expert parallelism: the expert dim), ``ff`` (each
    expert's hidden dim) or ``""`` (not at all: replicated)."""
    part = SH.current_partition()
    if part is None or part.m == 1:
        return ""
    dims = tuple(part.model_dim(p[k]) for k in ("wi", "wg", "wo"))
    return {(0, 0, 0): "ep", (2, 2, 1): "ff"}.get(dims, "")


def _dense_dispatch(p, xf: torch.Tensor, cfg: ArchConfig, layout: str = ""
                    ) -> Tuple[torch.Tensor, Dict]:
    """Switch-style capacity scatter.  Over-capacity pairs fall through to
    the residual; the drop is silent in the output but counted in stats.
    Under ``layout`` ``ep`` a rank fills and runs its own experts' slots
    only, and under ``ff`` its part of every expert's hidden dim: either
    way the output is this rank's part of the sum over ``"model"``.

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

    el = e
    slot = torch.where(keep, flat_e * cap + my_pos, e * cap)  # overflow -> trash
    if layout == "ep":  # this rank's experts [e0, e0 + el); the others' pairs -> trash
        m, i = SH.model_split()
        el = e // m
        e0 = i * el
        mine = keep & (flat_e >= e0) & (flat_e < e0 + el)
        slot = torch.where(mine, (flat_e - e0) * cap + my_pos, el * cap)
    src = C(xf[flat_tok], "src")
    disp = torch.zeros((el * cap + 1, d), dtype=xf.dtype, device=xf.device).index_copy(0, slot, src)
    disp = C(disp[:-1].reshape(el, cap, d), "disp")

    # expert computation: one batched product per weight
    gi = torch.bmm(disp, p["wg"])
    hi = torch.bmm(disp, p["wi"])
    act = F.silu(gi.float()).to(hi.dtype) * hi
    out_e = C(torch.bmm(act, p["wo"]), "out")  # (el, cap, d)

    gathered = torch.cat([out_e.reshape(el * cap, d), out_e.new_zeros((1, d))], dim=0)
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
    if cfg.moe_route not in ("dense", "calibrated"):
        raise ValueError(f"moe_route {cfg.moe_route!r} not in ('dense', 'calibrated')")
    layout = _moe_layout(p) if cfg.moe_route == "dense" else ""
    if layout:  # the router, dispatch and experts in a "model" region
        shared_split = "shared" in p and _ff_split(p["shared"])
        modes = dict(_FF_LOCAL, router="partial")
        if shared_split:
            modes.update({f"shared.{k}": v for k, v in _FF_LOCAL.items()})
        P = SH.fetch(p, modes)
        xf = rms_norm(x, P["ln"], cfg.norm_eps).reshape(t, d)
        xr = SH.to_model(xf)
        combined, stats = _dense_dispatch(P, xr, cfg, layout)
        part = combined.float()
        if shared_split:
            part = part + _swiglu(P["shared"], xf, split=True)
        y = SH.from_model(part, x.dtype)
        if "shared" in p and not shared_split:
            y = y + _swiglu(P["shared"], xf).to(x.dtype)
        return x + y.reshape(b, s, d), stats
    P = SH.fetch(p)
    xin = rms_norm(x, P["ln"], cfg.norm_eps)
    xf = xin.reshape(t, d)
    if cfg.moe_route == "calibrated":
        if current_split() is not None:
            raise NotImplementedError("the calibrated MoE route has no split-batch train step: "
                                      "its measured capacities are a rank's own")
        combined, stats = calibrated_dispatch(P, xf, cfg)
    else:
        combined, stats = _dense_dispatch(P, xf, cfg)

    y = combined.to(x.dtype)
    if "shared" in P:
        y = y + _swiglu(P["shared"], xf).to(x.dtype)
    return x + y.reshape(b, s, d), stats


def moe_forward(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Top-k MoE layer without the stats (``moe_forward_stats``)."""
    out, _ = moe_forward_stats(p, x, cfg)
    return out
