"""The train step: loss and gradients (layers rematerialized), optional
microbatch gradient accumulation, the optional int8 gradient codec,
global-norm clipping, the optimizer update and the metrics (counterpart of
``repro/train/step.py``).

``make_train_step(model, tcfg)`` returns ``train_step(opt_state, batch)``,
which updates the model's parameters and ``opt_state`` in place and
returns the metrics as device tensors (reading them waits for the
device).  The parameters are the model's own ``nn.Parameter``s; the
train step turns on their ``requires_grad``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from . import compression
from .optim import OptConfig, clip_by_global_norm, opt_init, opt_update

_MOE_KEYS = ("routed", "dropped", "heavy")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    accum: int = 1  # microbatches per step
    remat: bool = True
    compress_grads: bool = False  # int8 codec at the accumulation boundary
    moe_metrics: bool = False  # surface MoE routing stats (moe_* metrics)


def split_batch(batch: Dict[str, torch.Tensor], accum: int):
    """``accum`` microbatches of ``batch``: every entry split on its batch
    axis, which is axis 1 of a ``(3, B, S)`` M-RoPE ``pos`` and axis 0
    otherwise."""
    out = [dict() for _ in range(accum)]
    for k, v in batch.items():
        axis = 1 if k == "pos" and v.dim() == 3 else 0
        if v.shape[axis] % accum:
            raise ValueError(f"batch {k} {tuple(v.shape)}: axis {axis} not divisible by {accum}")
        for mb, part in zip(out, torch.chunk(v, accum, dim=axis)):
            mb[k] = part
    return out


#: the one parameter the loss never reaches, a shared expert's norm gain
#: (the MoE layer normalizes once): its gradient is zero, as in JAX; any
#: other parameter without a gradient is a fault
UNREACHED = ".moe.shared.ln"


def make_train_step(model, tcfg: TrainConfig) -> Callable:
    """``train_step(opt_state, batch) -> metrics``: ``loss`` (f32),
    ``grad_norm`` (before clipping) and ``step`` (int32), plus
    ``moe_{routed,dropped,heavy}`` with ``moe_metrics``.  Accumulation
    splits the batch into ``accum`` microbatches and sums their gradients
    in f32 (peak activation memory at 1/accum)."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    names = list(params)
    leaves = model.param_leaves()

    def run_grad(mb):
        if tcfg.moe_metrics:
            loss, aux = model.loss_and_stats(mb, remat=tcfg.remat)
        else:
            loss, aux = model.loss(mb, remat=tcfg.remat), None
        grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
        cut = [k for k, g in zip(names, grads) if g is None and not k.endswith(UNREACHED)]
        if cut:
            raise RuntimeError(f"the loss does not reach {cut}: a gradient stop on its path")
        grads = [torch.zeros_like(params[k]) if g is None else g for k, g in zip(names, grads)]
        return loss.detach(), aux, dict(zip(names, grads))

    def train_step(opt_state: Dict, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if tcfg.accum == 1:
            loss, moe, grads = run_grad(batch)
        else:
            grads = {k: torch.zeros(p.shape, device=p.device) for k, p in params.items()}
            loss, moe = 0.0, None
            for mb in split_batch(batch, tcfg.accum):
                l, aux, g = run_grad(mb)
                for k in names:
                    grads[k] += g[k].float()
                del g
                loss = loss + l
                if aux is not None:
                    moe = aux if moe is None else {k: moe[k] + aux[k] for k in _MOE_KEYS}
            grads = {k: g / tcfg.accum for k, g in grads.items()}
            loss = loss / tcfg.accum
        if tcfg.compress_grads:
            grads = compression.codec_roundtrip(grads, leaves=leaves)
        grads, gnorm = clip_by_global_norm(grads, tcfg.opt.grad_clip)
        opt_update(tcfg.opt, grads, opt_state, params, leaves)
        metrics = {"loss": loss.float(), "grad_norm": gnorm, "step": opt_state["step"]}
        if tcfg.moe_metrics:
            metrics.update({f"moe_{k}": moe[k] for k in _MOE_KEYS})
        return metrics

    return train_step


def init_train_state(model, tcfg: TrainConfig) -> Dict:
    """The optimizer state of ``model``'s parameters (the model itself
    holds them, made from its generator)."""
    return opt_init(tcfg.opt, dict(model.named_parameters()), model.param_leaves())


def init_train_state_shapes(cfg, tcfg: TrainConfig):
    """``(params, opt_state)`` of ``cfg``'s model on the ``meta`` device:
    shapes and dtypes, no storage (the counterpart of ``jax.eval_shape``)."""
    from ..configs import get_model

    model = get_model(cfg, "meta")
    params = {k: p.detach() for k, p in model.named_parameters()}
    return params, init_train_state(model, tcfg)


def state_tree(model, opt_state: Dict) -> Dict:
    """``{"params", "opt"}``: what a checkpoint holds (``train/checkpoint.py``)."""
    return {"params": {k: p.detach() for k, p in model.named_parameters()}, "opt": opt_state}


@torch.no_grad()
def load_state_tree(model, opt_state: Dict, tree: Dict) -> None:
    """Copy a restored ``state_tree`` into ``model`` and ``opt_state``."""
    model.load_state_dict(tree["params"])
    opt_state.clear()
    opt_state.update(tree["opt"])
