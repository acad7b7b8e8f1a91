"""Plain PyTorch oracles for every Hopper kernel of the port.

Each kernel's plain version is kept beside its kernel (one copy of the
reference semantics): the ``'torch'`` backend runs them, the CPU tests
hold them against ``repro.kernels.ref`` and the Pallas kernels, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.
``attention_ref`` is the dense oracle of the attention tests only; no
path of the port runs it."""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention_plain as flash_attention_ref
from .hash_partition import hash_partition_plain as hash_partition_ref
from .semijoin_probe import semijoin_probe_plain as semijoin_probe_ref
from .sorted_probe import sorted_probe_ranges_plain as sorted_probe_ranges_ref

__all__ = [
    "attention_ref", "flash_attention_ref", "hash_partition_ref",
    "semijoin_probe_ref", "sorted_probe_ranges_ref",
]


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Dense softmax attention in f32, GQA by repeating kv heads; rows
    with no visible key are 0 (``repro/kernels/ref.py::attention_ref``)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    g = h // k.shape[1]
    scale = float(scale) if scale is not None else float(d) ** -0.5
    kk = k.float().repeat_interleave(g, dim=1)
    vv = v.float().repeat_interleave(g, dim=1)
    s = (q.float() @ kk.transpose(-1, -2)) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= cols > rows - window
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    out = p @ vv
    out = torch.where(mask.any(dim=-1)[:, None], out, 0.0)
    return out.to(q.dtype)
