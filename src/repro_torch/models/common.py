"""Shared model substrate: arch config, norms, embeddings, RoPE/M-RoPE
and the token cross-entropy (counterpart of ``repro/models/common.py``).

Parameters are ``nn.Parameter``s held by ``nn.Module``s, one module per
layer (the reference stacks homogeneous runs of layers under
``lax.scan``); the names follow the reference's param tree, so
``interop.lm_params_from_numpy`` maps one onto the other.  Weights are
stored ``(fan_in, fan_out)`` and applied as ``x @ w``, as in the
reference.  Initialisation draws from an explicit ``torch.Generator``: it
has the reference's distribution, not its bits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch
from torch import nn

@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # block pattern: tuple of block kinds, len == n_layers (decoder side)
    pattern: Tuple[str, ...] = ()
    # attention options
    rope: str = "rope"  # rope | mrope | none
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    window: int = 0  # sliding window width for 'local' blocks
    # MoE
    n_experts: int = 0
    topk: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim (kimi: 2048)
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_route: str = "dense"  # dense | calibrated
    moe_plan: Optional[Any] = None
    # SSM / xLSTM
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    conv_kernel: int = 4
    chunk: int = 256
    # enc-dec (whisper)
    encdec: bool = False
    enc_layers: int = 0
    dec_ratio: int = 8  # train: decoder tokens = seq // dec_ratio
    # misc
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # notes for deviations from the public checkpoint
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def blocks(self) -> Tuple[str, ...]:
        if self.pattern:
            assert len(self.pattern) == self.n_layers, (
                self.name, len(self.pattern), self.n_layers
            )
            return self.pattern
        kind = "moe" if self.n_experts else "attn"
        return (kind,) * self.n_layers

    def segments(self) -> Tuple[Tuple[str, int], ...]:
        """Run-length encode the block pattern (the reference's scan
        segments, which its param tree follows)."""
        out = []
        for b in self.blocks():
            if out and out[-1][0] == b:
                out[-1] = (b, out[-1][1] + 1)
            else:
                out.append((b, 1))
        return tuple(out)


def gen_device(gen: Optional[torch.Generator]) -> torch.device:
    """Where parameters are made: the generator's device, or ``meta``
    (shapes and dtypes only) without a generator."""
    return gen.device if gen is not None else torch.device("meta")


def scaled_init(
    gen: Optional[torch.Generator], shape: Sequence[int], scale_axis: int, dtype,
    scale: float = 1.0,
) -> nn.Parameter:
    """Normal init with std ``scale / sqrt(fan_in)``, drawn in f32 on the
    generator's device."""
    std = scale / math.sqrt(shape[scale_axis])
    w = torch.randn(tuple(shape), generator=gen, device=gen_device(gen), dtype=torch.float32)
    return nn.Parameter((w * std).to(dtype), requires_grad=False)


def init_norm(d: int, dtype, device) -> nn.Parameter:
    # gain stored as g, applied as (1 + g)
    return nn.Parameter(torch.zeros(d, dtype=dtype, device=device), requires_grad=False)


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + g.float())).to(dt)


# ------------------------------------------------------------------- RoPE
def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    # half-split rotation (jnp.split(x, 2, -1)), not the interleaved one
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, H, S, D), pos (B, S) int -> rotated x."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (d/2,)
    ang = pos[:, None, :, None].float() * freqs  # (B,1,S,d/2)
    return _rotate(x, torch.cos(ang), torch.sin(ang))


def apply_mrope(
    x: torch.Tensor, pos3: torch.Tensor, theta: float, sections=(2, 3, 3)
) -> torch.Tensor:
    """Qwen2-VL M-RoPE: pos3 (3, B, S) = (temporal, height, width) ids.

    The head-dim frequency bands are split 2:3:3 over the three axes;
    text tokens carry identical ids on all axes, so M-RoPE == RoPE for
    pure text."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (d/2,)
    nb = d // 2
    tot = sum(sections)
    bounds, acc = [], 0
    for sec in sections:
        acc += int(round(nb * sec / tot))
        bounds.append(acc)
    bounds[-1] = nb
    band = torch.zeros(nb, dtype=torch.long, device=x.device)
    prev = 0
    for i, bd in enumerate(bounds):
        band[prev:bd] = i
        prev = bd
    pos_sel = pos3[band].permute(1, 2, 0)  # (B, S, nb): each band's axis
    ang = pos_sel.float() * freqs
    cos = torch.cos(ang)[:, None]  # (B,1,S,nb)
    sin = torch.sin(ang)[:, None]
    return _rotate(x, cos, sin)


# --------------------------------------------------------------- embeddings
def init_embed(gen: torch.Generator, vocab: int, d: int, dtype) -> nn.ParameterDict:
    return nn.ParameterDict({"table": scaled_init(gen, (vocab, d), 1, dtype)})


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def unembed(x: torch.Tensor, table: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    """f32 logits ``x @ table.T``, soft-capped when ``softcap > 0`` (the
    f32 copy of the table is a temporary of ``4 * vocab * d`` bytes)."""
    logits = x.float() @ table.float().T
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy of f32 ``logits (..., V)`` against integer
    ``targets (...)``: ``logsumexp`` minus the gold logit."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (lse - gold).mean()
