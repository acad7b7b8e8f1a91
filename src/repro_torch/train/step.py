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
A step points the model's parameters at this rank's shards and runs
forward and backward on the rank's slice of each microbatch of the
global ``batch`` (``batch_specs``; a MoE layer's capacity and arrival
order stay the whole batch's) under a ``launch.shardings.Partition``:
each layer gathers its parameters inside its own (rematerialized) call
and computes on its ``"model"`` shards where the split allows it
(``models/``), so no rank holds a whole parameter outside the layer that
uses it.  The gradients arrive in f32 in each rank's shards through the
gathers' backward (a reduce-scatter over the data ranks); the leaves the
data axes replicate are all-reduced; all are averaged over the data
slices: for a dense model a data split of ``n`` slices is
``make_train_step`` with ``n * accum`` microbatches, those slices, up to
the order of the sums.  Then the single process' codec, clipping and
optimizer run on the shards, the codec's scales and the global norm
reduced over the mesh: AdamW is elementwise; Adafactor, whose factored
state replicates, sums its row and column statistics and its update's
RMS over the ranks that hold a leaf's other shards (``optim.Shard``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..launch import shardings as SH
from ..launch.shardings import batch_dims, batch_slices, split_batch
from . import compression
from .optim import OptConfig, Shard, clip_by_global_norm, global_norm, opt_init, opt_update

_MOE_KEYS = ("routed", "dropped", "heavy")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    accum: int = 1  # microbatches per step
    remat: bool = True
    compress_grads: bool = False  # int8 codec at the accumulation boundary
    moe_metrics: bool = False  # surface MoE routing stats (moe_* metrics)


#: the one parameter the loss never reaches, a shared expert's norm gain
#: (the MoE layer normalizes once): its gradient is zero, as in JAX; any
#: other parameter without a gradient is a fault
UNREACHED = ".moe.shared.ln"


def _loss_and_grads(model, tcfg: TrainConfig, params: Dict, mb, sink: Callable,
                    zeros: Callable):
    """``(loss, MoE stats or None, {name: gradient})`` of the microbatch
    ``mb``: the forward (layers rematerialized), then ``sink(loss)``, which
    runs the backward and returns each parameter's gradient, None where
    the loss does not reach it.  Only ``UNREACHED`` may go unreached (its
    gradient is then ``zeros(parameter)``); any other raises."""
    if tcfg.moe_metrics:
        loss, aux = model.loss_and_stats(mb, remat=tcfg.remat)
    else:
        loss, aux = model.loss(mb, remat=tcfg.remat), None
    grads = sink(loss)
    cut = [k for k, g in grads.items() if g is None and not k.endswith(UNREACHED)]
    if cut:
        raise RuntimeError(f"the loss does not reach {cut}: a gradient stop on its path")
    return loss.detach(), aux, {k: zeros(params[k]) if g is None else g for k, g in grads.items()}


def _grad_fn(model, tcfg: TrainConfig, params: Dict) -> Callable:
    """``run_grad(mb) -> (loss, MoE stats or None, {name: gradient})``."""
    names = list(params)

    def sink(loss):
        grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
        return dict(zip(names, grads))

    return lambda mb: _loss_and_grads(model, tcfg, params, mb, sink, torch.zeros_like)


def _gradients(tcfg: TrainConfig, run: Callable, mbs: List, leaves,
               norm_of: Callable = global_norm, amax_over: Optional[Callable] = None):
    """``(loss, MoE stats, gradients, grad_norm)`` of the microbatches
    ``mbs``: ``run`` over each (their gradients summed in f32, then
    averaged), the codec and global-norm clipping (``norm_of`` and
    ``amax_over``: the whole tensors' norm and largest magnitudes, for a
    mesh rank's shards)."""
    if len(mbs) == 1:
        loss, moe, grads = run(mbs[0])
    else:
        grads, loss, moe = None, 0.0, None
        for mb in mbs:
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
        grads = {k: g / len(mbs) for k, g in grads.items()}
        loss = loss / len(mbs)
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
        mbs = split_batch(batch, tcfg.accum) if tcfg.accum > 1 else [batch]
        loss, moe, grads, gnorm = _gradients(tcfg, run_grad, mbs, leaves)
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
    specs = {"params": SH.param_specs(cfg, tree["params"], mesh),
             "opt": SH.opt_state_specs(cfg, tree["opt"], mesh)}
    return SH.named(mesh, specs)


def place_train_state(model, opt_state: Dict, mesh) -> Dict:
    """``state_tree(model, opt_state)`` placed on ``mesh`` (DTensors, each
    rank its shards), after which the model's own parameters are empty;
    every rank must hold the same whole state.  The caller drops its
    ``opt_state``."""
    tree = state_tree(model, opt_state)
    state = SH.place(tree, train_state_shardings(model.cfg, tree, mesh))
    release_params(model)
    return state


def _locals(tree):
    """``tree`` with each DTensor as its local shard itself."""
    if isinstance(tree, dict):
        return {k: _locals(v) for k, v in tree.items()}
    return SH.local(tree)


def _rewrap(placed, locals_, memo=None):
    """``locals_`` (``_locals(placed)`` after an update that replaced some
    leaves) placed again as ``placed``'s leaves are."""
    from torch.distributed.tensor import DTensor

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
    on every rank.  ``train_step.on_slices(state, slices, dims)`` takes
    this rank's slices of the microbatches instead (``batch_slices``),
    the batch split over the mesh dims ``dims`` (``batch_dims``)."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    leaves = model.param_leaves()
    every = tuple(i for i in range(mesh.ndim) if mesh.size(i) > 1)
    where: Dict = {}  # each parameter's placements, read from the state a step takes

    def run(mb, dims):
        """One microbatch: this rank's slice ``mb``, its gradients averaged
        over the ranks that split the batch, in this rank's shards."""
        split = SH.BatchSplit(mesh, dims) if dims else None
        sink: Dict[int, torch.Tensor] = {}
        part = SH.Partition(mesh, {id(p): where[k] for k, p in params.items()}, dims, sink)

        def backward(loss):  # the gradients arrive in ``sink`` (``fetch``)
            torch.autograd.backward(loss)
            return {k: sink.get(id(p)) for k, p in params.items()}

        with SH.batch_split(split), SH.partitioned(part):
            # kept in f32, as ``make_train_step`` keeps a sum of microbatches
            loss, aux, grads = _loss_and_grads(
                model, tcfg, params, mb, backward,
                lambda p: torch.zeros(p.shape, device=p.device))
        n = split.parts if split else 1
        grads = {k: g / n for k, g in SH.reduce_replicated(grads, where, mesh, dims).items()}
        if split is not None:
            loss = SH.all_reduce(loss, mesh, dims) / n
            if aux is not None:
                aux = {k: SH.all_reduce(v, mesh, dims) for k, v in aux.items()}
        return loss, aux, grads

    coord = mesh.get_coordinate()

    def shard(t) -> Shard:
        """A placed parameter's ``optim.Shard`` on this rank."""
        dims = [i for i, p in enumerate(t.placements) if p.is_shard() and mesh.size(i) > 1]
        return Shard(tuple(t.shape), SH._region(t.shape, t.placements, mesh, coord),
                     lambda x: SH.all_reduce(x, mesh, dims) if dims else x)

    def norm_of(grads):
        """The global norm of the whole gradients, from this rank's shards
        (each counted once over its replicas)."""
        part = sum(torch.sum(torch.square(g.float())) / SH.replicas(where[k], mesh)
                   for k, g in grads.items())
        return torch.sqrt(SH.all_reduce(part, mesh, every))

    def on_slices(state: Dict, slices: Sequence[Dict], dims: Tuple[int, ...]
                  ) -> Dict[str, torch.Tensor]:
        where.update({k: t.placements for k, t in state["params"].items()})
        mine = {k: SH.local(t) for k, t in state["params"].items()}
        with torch.no_grad():
            for k, p in params.items():
                p.data = mine[k]
        try:
            loss, moe, grads, gnorm = _gradients(
                tcfg, lambda mb: run(mb, dims), list(slices), leaves, norm_of,
                lambda v: SH.all_reduce(v, mesh, every, "max"))
            opt = _locals(state["opt"])
            if tcfg.opt.kind == "adafactor":
                # the factored state replicates: its statistics are summed
                # over the shards (``optim.Shard``)
                if any(p.is_shard() for t in SH._leaves(state["opt"]) for p in t.placements):
                    raise ValueError("a sharded Adafactor state: its statistics are whole")
                opt_update(tcfg.opt, grads, opt, mine, leaves, lambda k: shard(state["params"][k]))
            else:  # elementwise: each rank its shards
                opt_update(tcfg.opt, grads, opt, mine, leaves)
            state["opt"] = _rewrap(state["opt"], opt)
        finally:
            release_params(model)
        return _metrics(tcfg, loss, moe, gnorm, SH.local(state["opt"]["step"]))

    def train_step(state: Dict, batch: Dict) -> Dict[str, torch.Tensor]:
        whole = {k: SH.gather_full(v) for k, v in batch.items()}
        return on_slices(state, batch_slices(whole, tcfg.accum, mesh), batch_dims(whole, mesh))

    train_step.on_slices = on_slices
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
