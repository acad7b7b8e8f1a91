"""The train step: loss and gradients (layers rematerialized), optional
microbatch gradient accumulation, the optional int8 gradient codec,
global-norm clipping, the optimizer update and the metrics (counterpart of
``repro/train/step.py``).

``make_train_step(model, tcfg)`` returns ``train_step(opt_state, batch)``,
which updates the model's parameters and ``opt_state`` in place and
returns the metrics as device tensors (reading them waits for the
device).  The parameters are the model's own ``nn.Parameter``s; the
train step turns on their ``requires_grad``.

On a mesh (``launch/mesh.py``) ``place_train_state`` places the
parameters and the optimizer state by the reference's rules
(``launch/shardings.py``), and ``make_mesh_train_step(model, tcfg, mesh)``
returns ``train_step(state, batch)`` over that placed state.  Between
steps a rank holds only its shards: the model's own parameters are empty.
A step gathers the parameters whole into the model, runs forward and
backward on the rank's slice of each microbatch of the global ``batch``
(``batch_specs``; a MoE layer's capacity and arrival order stay the whole
batch's), and averages the gradients over the data ranks, in f32,
straight into each rank's shards (a reduce-scatter where the data axes
shard a parameter): for a dense model a data split of ``n`` slices is
``make_train_step`` with ``n * accum`` microbatches, those slices.  Then
the single process' codec, clipping and optimizer run on the shards, the
codec's scales and the global norm reduced over the mesh: AdamW is
elementwise; Adafactor, whose factored state replicates, updates the
whole leaves (the gradients gathered), each rank keeping its shards of
the result.  The forward stays on plain tensors, so no operator of the
model meets a DTensor.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from . import compression
from .optim import OptConfig, clip_by_global_norm, global_norm, opt_init, opt_update

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


def _grad_fn(model, tcfg: TrainConfig, params: Dict) -> Callable:
    """``run_grad(mb) -> (loss, MoE stats or None, {name: gradient})``."""
    names = list(params)

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

    return run_grad


def _gradients(tcfg: TrainConfig, run: Callable, batch: Dict, leaves,
               norm_of: Callable = global_norm, amax_over: Optional[Callable] = None):
    """``(loss, MoE stats, gradients, grad_norm)`` of ``batch``: ``run`` over
    ``accum`` microbatches (their gradients summed in f32), the codec and
    global-norm clipping (``norm_of`` and ``amax_over``: the whole
    tensors' norm and largest magnitudes, for a mesh rank's shards)."""
    if tcfg.accum == 1:
        loss, moe, grads = run(batch)
    else:
        grads, loss, moe = None, 0.0, None
        for mb in split_batch(batch, tcfg.accum):
            l, aux, g = run(mb)
            if grads is None:
                grads = {k: t.float() for k, t in g.items()}
            else:
                for k, t in g.items():
                    grads[k] += t.float()
            del g
            loss = loss + l
            if aux is not None:
                moe = aux if moe is None else {k: moe[k] + aux[k] for k in _MOE_KEYS}
        grads = {k: g / tcfg.accum for k, g in grads.items()}
        loss = loss / tcfg.accum
    if tcfg.compress_grads:
        grads = compression.codec_roundtrip(grads, leaves=leaves, amax_over=amax_over)
    grads, gnorm = clip_by_global_norm(grads, tcfg.opt.grad_clip, norm_of)
    return loss, moe, grads, gnorm


def _metrics(tcfg: TrainConfig, loss, moe, gnorm, step) -> Dict[str, torch.Tensor]:
    metrics = {"loss": loss.float(), "grad_norm": gnorm, "step": step}
    if tcfg.moe_metrics:
        metrics.update({f"moe_{k}": moe[k] for k in _MOE_KEYS})
    return metrics


def make_train_step(model, tcfg: TrainConfig) -> Callable:
    """``train_step(opt_state, batch) -> metrics``: ``loss`` (f32),
    ``grad_norm`` (before clipping) and ``step`` (int32), plus
    ``moe_{routed,dropped,heavy}`` with ``moe_metrics``.  Accumulation
    splits the batch into ``accum`` microbatches and sums their gradients
    in f32 (peak activation memory at 1/accum)."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    leaves = model.param_leaves()
    run_grad = _grad_fn(model, tcfg, params)

    def train_step(opt_state: Dict, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        loss, moe, grads, gnorm = _gradients(tcfg, run_grad, batch, leaves)
        opt_update(tcfg.opt, grads, opt_state, params, leaves)
        return _metrics(tcfg, loss, moe, gnorm, opt_state["step"])

    return train_step


# ------------------------------------------------------------- on a mesh
def release_params(model) -> None:
    """Empty the model's own parameters (a placed state holds them)."""
    for p in model.parameters():
        p.data = torch.empty(0, dtype=p.dtype, device=p.device)


def train_state_shardings(cfg, tree: Dict, mesh) -> Dict:
    """``{"params", "opt"}`` of ``Sharding``s: where each leaf of a
    ``state_tree`` of a ``cfg`` model goes on ``mesh`` (the reference's
    ``param_specs`` and ``opt_state_specs``).  ``tree``'s leaves may be
    placed already: only their whole shapes are read."""
    from ..launch import shardings as SH

    specs = {"params": SH.param_specs(cfg, tree["params"], mesh),
             "opt": SH.opt_state_specs(cfg, tree["opt"], mesh)}
    return SH.named(mesh, specs)


def place_train_state(model, opt_state: Dict, mesh) -> Dict:
    """``state_tree(model, opt_state)`` placed on ``mesh`` (DTensors, each
    rank its shards), after which the model's own parameters are empty;
    every rank must hold the same whole state.  The caller drops its
    ``opt_state``."""
    from ..launch import shardings as SH

    tree = state_tree(model, opt_state)
    state = SH.place(tree, train_state_shardings(model.cfg, tree, mesh))
    release_params(model)
    return state


def _locals(tree):
    """``tree`` with each DTensor as its local shard itself."""
    from ..launch import shardings as SH

    if isinstance(tree, dict):
        return {k: _locals(v) for k, v in tree.items()}
    return SH.local(tree)


def _rewrap(placed, locals_, memo=None):
    """``locals_`` (``_locals(placed)`` after an update that replaced some
    leaves) placed again as ``placed``'s leaves are."""
    from torch.distributed.tensor import DTensor

    from ..launch import shardings as SH

    memo = {} if memo is None else memo
    if isinstance(placed, dict):
        return {k: _rewrap(placed[k], locals_[k], memo) for k in locals_}
    if locals_ is SH.local(placed):
        return placed
    if id(locals_) not in memo:
        memo[id(locals_)] = DTensor.from_local(locals_, placed.device_mesh, placed.placements,
                                               run_check=False, shape=placed.shape,
                                               stride=placed.stride())
    return memo[id(locals_)]


def make_mesh_train_step(model, tcfg: TrainConfig, mesh) -> Callable:
    """``train_step(state, batch) -> metrics`` on ``mesh`` (see the module
    doc): ``state`` is ``place_train_state``'s, updated in place; ``batch``
    the global batch, plain tensors that every rank holds or DTensors.
    The metrics are the single process' (``make_train_step``), the same
    on every rank."""
    from ..launch import shardings as SH

    model.requires_grad_(True)
    params = dict(model.named_parameters())
    leaves = model.param_leaves()
    run_grad = _grad_fn(model, tcfg, params)
    names = SH.mesh_shape(mesh).axis_names
    every = tuple(range(len(names)))
    where: Dict = {}  # each parameter's placements, read from the state a step takes

    def run(mb):
        """One microbatch: this rank's slice, its gradients averaged over
        the ranks that split the batch, straight into this rank's shards."""
        specs = SH.batch_specs(mb, mesh)
        part = {k: SH.shard_of(v, mesh, SH.placements(specs[k], mesh)) for k, v in mb.items()}
        lead = specs["tokens"][0]
        axes = (lead,) if isinstance(lead, str) else tuple(lead or ())
        dims = tuple(names.index(a) for a in axes)
        split = SH.BatchSplit(mesh, dims) if dims else None
        with SH.batch_split(split):
            loss, aux, grads = run_grad(part)
        n = split.parts if split else 1
        # kept in f32, as ``make_train_step`` keeps a sum of microbatches
        grads = {k: SH.reduce_to(g.float(), where[k], mesh, dims) / n for k, g in grads.items()}
        if split is not None:
            loss = SH.all_reduce(loss, mesh, dims) / n
            if aux is not None:
                aux = {k: SH.all_reduce(v, mesh, dims) for k, v in aux.items()}
        return loss, aux, grads

    def norm_of(grads):
        """The global norm of the whole gradients, from this rank's shards
        (each counted once over its replicas)."""
        part = sum(torch.sum(torch.square(g.float())) / SH.replicas(where[k], mesh)
                   for k, g in grads.items())
        return torch.sqrt(SH.all_reduce(part, mesh, every))

    def train_step(state: Dict, batch: Dict) -> Dict[str, torch.Tensor]:
        where.update({k: t.placements for k, t in state["params"].items()})
        full = SH.whole_tree({k: SH.local(t) for k, t in state["params"].items()}, where, mesh)
        with torch.no_grad():
            for k, p in params.items():
                p.data = full[k]
        del full
        try:
            whole = {k: SH.gather_full(v) for k, v in batch.items()}
            loss, moe, grads, gnorm = _gradients(
                tcfg, run, whole, leaves, norm_of, lambda v: SH.all_reduce(v, mesh, every, "max"))
            opt = _locals(state["opt"])
            mine = {k: SH.local(t) for k, t in state["params"].items()}
            if tcfg.opt.kind == "adafactor":
                # the factored state replicates: update whole leaves, keep the shards
                if any(p.is_shard() for t in SH._leaves(state["opt"]) for p in t.placements):
                    raise ValueError("a sharded Adafactor state: its update reads whole leaves")
                grads = SH.whole_tree(grads, where, mesh)
                opt_update(tcfg.opt, grads, opt, params, leaves)
                for k, t in mine.items():
                    t.copy_(SH.shard_of(params[k].detach(), mesh, where[k]))
            else:  # elementwise: each rank its shards
                opt_update(tcfg.opt, grads, opt, mine, leaves)
            state["opt"] = _rewrap(state["opt"], opt)
        finally:
            release_params(model)
        return _metrics(tcfg, loss, moe, gnorm, SH.local(state["opt"]["step"]))

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
