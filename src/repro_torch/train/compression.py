"""Gradient compression: a per-tensor symmetric int8 codec with optional
stochastic rounding, and an int8 all-reduce (counterpart of
``repro/train/compression.py``).

``int8_allreduce`` reduces where the reference reduces over a named axis
with ``pmax``/``psum``: one scale (the largest magnitude over every
shard), int8 payloads, an int32 sum and the dequantized mean.  It takes
the data-parallel shards either on an explicit leading axis, as
``relational/spmd.py`` does for ``all_to_all``, or one shard a process
with ``group=`` a process group or a one-dimension ``DeviceMesh``, over
which it runs ``all_reduce``; without a generator the two forms agree
bit for bit.  Stochastic rounding draws from an explicit
``torch.Generator`` on the tensors' device (each process its own).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .optim import Leaves, leaves_of


def _int8(x: torch.Tensor, scale: torch.Tensor, generator: Optional[torch.Generator]):
    y = x.float() / scale
    if generator is not None:
        u = torch.rand(y.shape, generator=generator, device=y.device)
        y = torch.floor(y + u)
    else:
        y = torch.round(y)  # half to even, as jnp.round
    return torch.clamp(y, -127, 127).to(torch.int8)


def _scale(*xs: torch.Tensor) -> torch.Tensor:
    amax = torch.stack([x.float().abs().max() for x in xs]).max()
    return torch.clamp(amax, min=1e-12) / 127.0


def quantize_int8(x: torch.Tensor, generator: Optional[torch.Generator] = None):
    """Per-tensor symmetric int8: ``(q int8, scale f32)``."""
    scale = _scale(x)
    return _int8(x, scale, generator), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def codec_roundtrip(tensors: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                    leaves: Optional[Leaves] = None) -> Dict[str, torch.Tensor]:
    """Quantize and dequantize every tensor, one scale per leaf (``leaves``
    as in ``train/optim.py``: a stacked leaf shares the reference's one
    scale over its layers)."""
    out = {}
    for names, _ in leaves_of(tensors, leaves):
        scale = _scale(*(tensors[k] for k in names))
        for k in names:
            out[k] = dequantize_int8(_int8(tensors[k], scale, generator), scale, tensors[k].dtype)
    return out


def int8_allreduce(x: torch.Tensor, generator: Optional[torch.Generator] = None,
                   *, group=None) -> torch.Tensor:
    """Mean over the data-parallel shards with an int8 payload: ``x.shape``,
    ``x.dtype``.  Without ``group``, ``x`` holds every shard on its leading
    axis and the mean comes back broadcast to each.  With ``group`` (a
    process group, or a one-dimension ``DeviceMesh``) ``x`` is this
    process' shard: an ``all_reduce`` MAX of its magnitude gives the scale,
    an ``all_reduce`` SUM adds the int8 values as int32, and every process
    gets the mean.  The values are int8 (1 byte an element of information)
    but the sum carries them as int32, 4 bytes an element, beside one f32
    scale, as the reference's ``psum`` does."""
    if group is None:
        scale = _scale(x)
        q = _int8(x, scale, generator)
        total = q.to(torch.int32).sum(dim=0)
        mean = total.float() * scale / float(x.shape[0])
        return mean.to(x.dtype).expand(x.shape).clone()
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(group, DeviceMesh):
        group = group.get_group()
    # gloo moves host tensors only: a card's shard crosses through the host
    staged = dist.get_backend(group) == "gloo" and x.device.type == "cuda"
    amax = x.float().abs().max().reshape(1)
    amax = amax.cpu() if staged else amax
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax.to(x.device)[0], min=1e-12) / 127.0
    total = _int8(x, scale, generator).to(torch.int32)
    total = total.cpu() if staged else total
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    mean = total.to(x.device).float() * scale / float(dist.get_world_size(group))
    return mean.to(x.dtype)
