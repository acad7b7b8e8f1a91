"""Optimizers over named tensors: AdamW (f32 or bf16 moments) and
Adafactor (factored second moment), with the warmup + cosine schedule and
global-norm clipping (counterpart of ``repro/train/optim.py``).

``params`` and ``grads`` are dicts of tensors keyed by parameter name
(``dict(model.named_parameters())``).  The state is a dict keyed the same
way: AdamW ``{"m": {name: t}, "v": {name: t}, "step"}``, Adafactor
``{"f": {name: {"r", "c"} or {"v"}}, "step"}``, with ``step`` a 0-d int32
tensor.  ``opt_update`` writes the new parameters into ``params`` in
place and the new state into ``state``.  Every update is computed in f32
and cast back to the parameter's (and the moment's) dtype.

``leaves`` (``DecoderLM.param_leaves()``) says which parameters the
reference stacks into one leaf: the layers of a segment.  Where the
reference's arithmetic reads the leaf as a whole it is done on the
stacked tensor here: AdamW's decoupled weight decay goes to leaves of two
or more dimensions *as stacked* (so to each layer's norm gains, not to
``final_ln``), and Adafactor factors the stacked leaf (a stacked norm's
column statistic ``c`` spans the layers, and each layer keeps a copy) and
clips the update by the RMS of the whole leaf.  Without ``leaves`` each
parameter is a leaf of its own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

Tensors = Dict[str, torch.Tensor]
Leaves = Sequence[Tuple[Tuple[str, ...], bool]]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moments_dtype: str = "float32"  # bf16 halves AdamW state memory
    warmup: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay (f32 scalar tensor)."""
    s = step.float()
    warm = torch.clamp(s / max(1, cfg.warmup), max=1.0)
    t = torch.clamp((s - cfg.warmup) / max(1, cfg.decay_steps - cfg.warmup), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def leaves_of(tensors: Tensors, leaves: Optional[Leaves] = None) -> List[Tuple[Tuple[str, ...], bool]]:
    """``leaves``, or each tensor a leaf of its own."""
    if leaves is None:
        return [((name,), False) for name in tensors]
    return [(tuple(names), bool(stacked)) for names, stacked in leaves]


def global_norm(tensors: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors.values()))


def clip_by_global_norm(grads: Tensors, max_norm: float,
                        norm_of: Callable[[Tensors], torch.Tensor] = global_norm
                        ) -> Tuple[Tensors, torch.Tensor]:
    """``grads`` scaled to at most ``max_norm`` and their norm (``norm_of``:
    on a mesh, the norm of the whole tensors a rank's shards belong to)."""
    g = norm_of(grads)
    scale = torch.clamp(max_norm / (g + 1e-9), max=1.0)
    return {k: (t.float() * scale).to(t.dtype) for k, t in grads.items()}, g


def _zeros(t: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(t.shape, dtype=dtype, device=t.device)


# ------------------------------------------------------------------ AdamW
def adamw_init(cfg: OptConfig, params: Tensors) -> Dict:
    dt = getattr(torch, cfg.moments_dtype)
    dev = next(iter(params.values())).device
    return {
        "m": {k: _zeros(p, dt) for k, p in params.items()},
        "v": {k: _zeros(p, dt) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads: Tensors, state: Dict, params: Tensors,
                 leaves: Optional[Leaves] = None) -> None:
    step = state["step"] + 1
    lr = schedule(cfg, step)
    t = step.float()
    bc1 = 1 - cfg.b1**t
    bc2 = 1 - cfg.b2**t
    for names, stacked in leaves_of(params, leaves):
        for k in names:
            g32, p = grads[k].float(), params[k]
            m, v = state["m"][k], state["v"][k]
            m2 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
            v2 = cfg.b2 * v.float() + (1 - cfg.b2) * g32 * g32
            upd = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
            if p.dim() + stacked >= 2:  # decoupled weight decay on matrices only
                upd = upd + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * upd).to(p.dtype))
            state["m"][k] = m2.to(m.dtype)
            state["v"][k] = v2.to(v.dtype)
    state["step"] = step


# -------------------------------------------------------------- Adafactor
def adafactor_init(cfg: OptConfig, params: Tensors, leaves: Optional[Leaves] = None) -> Dict:
    f: Dict[str, Dict[str, torch.Tensor]] = {}
    for names, stacked in leaves_of(params, leaves):
        shared_c = None
        for k in names:
            p = params[k]
            if p.dim() + stacked >= 2:
                # r: the leaf's shape less its last axis; c less its second
                # to last, which for a stacked vector is the layer axis: one
                # tensor that every layer of the leaf holds, as the update
                # leaves it (the reference's one c a leaf)
                if p.dim() >= 2:
                    c = torch.zeros(p.shape[:-2] + p.shape[-1:], device=p.device)
                else:
                    if shared_c is None:
                        shared_c = torch.zeros(p.shape, device=p.device)
                    c = shared_c
                f[k] = {"r": torch.zeros(p.shape[:-1], device=p.device), "c": c}
            else:
                f[k] = {"v": _zeros(p)}
    dev = next(iter(params.values())).device
    return {"f": f, "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adafactor_update(cfg: OptConfig, grads: Tensors, state: Dict, params: Tensors,
                     leaves: Optional[Leaves] = None) -> None:
    step = state["step"] + 1
    lr = schedule(cfg, step)
    beta = 1.0 - (step.float() + 1.0) ** -0.8
    f = state["f"]
    for names, stacked in leaves_of(params, leaves):
        ps = [params[k] for k in names]
        # the reference's leaf: the segment's layers stacked on axis 0
        if stacked:
            g32 = torch.stack([grads[k].float() for k in names])
            p32 = torch.stack([p.float() for p in ps])
        else:
            g32, p32 = grads[names[0]].float(), ps[0].float()
        g2 = g32 * g32 + 1e-30
        fs = [f[k] for k in names]
        if "r" in fs[0]:
            r0 = torch.stack([x["r"] for x in fs]) if stacked else fs[0]["r"]
            # a stacked vector's c spans the layers: every layer holds it
            per_layer_c = stacked and ps[0].dim() >= 2
            c0 = torch.stack([x["c"] for x in fs]) if per_layer_c else fs[0]["c"]
            r = beta * r0 + (1 - beta) * g2.mean(-1)
            c = beta * c0 + (1 - beta) * g2.mean(-2)
            denom = r[..., None] * c[..., None, :] / (r.mean(-1)[..., None, None] + 1e-30)
            u = g32 / (torch.sqrt(denom) + 1e-30)
            for i, x in enumerate(fs):
                x["r"] = r[i] if stacked else r
                x["c"] = c[i] if per_layer_c else c
        else:
            v0 = torch.stack([x["v"] for x in fs]) if stacked else fs[0]["v"]
            v = beta * v0 + (1 - beta) * g2
            u = g32 / (torch.sqrt(v) + 1e-30)
            for i, x in enumerate(fs):
                x["v"] = v[i] if stacked else v
        # update clipping (Adafactor's d=1.0 RMS rule)
        rms = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp(rms, min=1.0)
        if p32.dim() >= 2:
            u = u + cfg.weight_decay * p32
        p2 = p32 - lr * u
        for i, p in enumerate(ps):
            p.copy_((p2[i] if stacked else p2).to(p.dtype))
    state["step"] = step


# ----------------------------------------------------------------- facade
def opt_init(cfg: OptConfig, params: Tensors, leaves: Optional[Leaves] = None) -> Dict:
    if cfg.kind == "adamw":
        return adamw_init(cfg, params)
    if cfg.kind == "adafactor":
        return adafactor_init(cfg, params, leaves)
    raise ValueError(f"unknown optimizer kind {cfg.kind!r} (adamw | adafactor)")


def opt_update(cfg: OptConfig, grads: Tensors, state: Dict, params: Tensors,
               leaves: Optional[Leaves] = None) -> None:
    """One update of ``params`` (in place) and ``state`` (in place)."""
    if cfg.kind == "adamw":
        adamw_update(cfg, grads, state, params, leaves)
    elif cfg.kind == "adafactor":
        adafactor_update(cfg, grads, state, params, leaves)
    else:
        raise ValueError(f"unknown optimizer kind {cfg.kind!r} (adamw | adafactor)")
