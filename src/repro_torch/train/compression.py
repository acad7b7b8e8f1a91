"""Gradient compression: a per-tensor symmetric int8 codec with optional
stochastic rounding, and an int8 all-reduce (counterpart of
``repro/train/compression.py``).

``int8_allreduce`` takes the data-parallel shards on an explicit leading
axis, as ``relational/spmd.py`` does for ``all_to_all``, where the
reference reduces over a named axis with ``pmax``/``psum``: one scale (the
largest magnitude over every shard), int8 payloads, an int32 sum and the
dequantized mean.  Stochastic rounding draws from an explicit
``torch.Generator`` on the tensors' device.
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


def int8_allreduce(x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Mean over the leading data-parallel axis of ``x`` with an int8
    payload, broadcast back to every shard: ``x.shape``, ``x.dtype``.
    Wire cost: 1 byte an element and one f32 scale."""
    scale = _scale(x)
    q = _int8(x, scale, generator)
    total = q.to(torch.int32).sum(dim=0)
    n = x.shape[0]
    mean = total.float() * scale / float(n)
    return mean.to(x.dtype).expand(x.shape).clone()
