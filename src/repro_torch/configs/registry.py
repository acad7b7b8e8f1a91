"""Architecture registry (counterpart of ``repro/configs/registry.py``):
config lookup by ``--arch`` id, the model for a config, the reduced
smoke configs and a concrete smoke batch.  The dry run's ``input_specs``
and ``cells`` are not ported yet."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..models.common import LATER, ArchConfig
from .gemma2_9b import CONFIG as _gemma2
from .grok_1_314b import CONFIG as _grok
from .kimi_k2_1t_a32b import CONFIG as _kimi
from .qwen2_vl_2b import CONFIG as _qwen2vl
from .qwen3_8b import CONFIG as _qwen3
from .smollm_360m import CONFIG as _smollm
from .starcoder2_7b import CONFIG as _starcoder2
from .whisper_small import CONFIG as _whisper
from .xlstm_125m import CONFIG as _xlstm
from .zamba2_7b import CONFIG as _zamba2

CONFIGS: Dict[str, ArchConfig] = {
    c.name: c
    for c in [
        _qwen2vl, _xlstm, _grok, _kimi, _whisper,
        _gemma2, _starcoder2, _smollm, _qwen3, _zamba2,
    ]
}

#: families whose model is ported: decoder LMs of attention + MLP blocks
#: (qwen2-vl's backbone is one, with M-RoPE), of attention + MoE blocks,
#: of mLSTM + sLSTM blocks (ssm: xlstm-125m) and of Mamba2 blocks with a
#: shared attention block (hybrid: zamba2-7b)
PORTED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")
_FAMILY_ITEM = {"audio": LATER["whisper"]}


def get_config(arch: str) -> ArchConfig:
    return CONFIGS[arch]


def get_model(cfg: ArchConfig, device=None, **kw):
    """The ``DecoderLM`` of ``cfg`` on ``device`` (None = the CUDA card);
    ``kw`` goes to its constructor (``backend``, ``generator``)."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"({_FAMILY_ITEM.get(cfg.family, 'ROADMAP queue A')})"
        )
    from ..models.transformer import DecoderLM

    return DecoderLM(cfg, device, **kw)


# -------------------------------------------------------------- reductions
def reduced_config(cfg: ArchConfig) -> ArchConfig:
    """Smoke-test scale: same family/block kinds, tiny everything."""
    # keep one occurrence of each distinct kind, in order
    kinds = []
    for k in cfg.blocks():
        if k not in kinds:
            kinds.append(k)
    pattern = []
    for k in kinds:
        pattern.extend([k, k] if len(kinds) <= 2 else [k])
    heads = 4
    kv = max(1, min(heads, (cfg.n_kv_heads * heads) // max(1, cfg.n_heads)) or 1)
    if kv == 0 or heads % kv:
        kv = heads
    return dataclasses.replace(
        cfg,
        n_layers=len(pattern),
        pattern=tuple(pattern),
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=128,
        n_experts=min(cfg.n_experts, 4),
        topk=min(cfg.topk, 2),
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        ssm_state=16 if cfg.ssm_state else 0,
        window=8 if cfg.window else 0,
        chunk=16,
        enc_layers=2 if cfg.encdec else 0,
        dtype="float32",
    )


def make_smoke_batch(cfg: ArchConfig, generator: torch.Generator, b: int = 2,
                     s: int = 32) -> Dict[str, torch.Tensor]:
    """A concrete small training batch (reduced configs): random tokens and
    targets in ``[0, vocab)`` from ``generator``, on its device, and the
    ``(3, B, S)`` text positions for an M-RoPE config.  The draws have the
    reference's distribution, not its bits."""
    if cfg.encdec:
        raise NotImplementedError(f"{cfg.name}: enc-dec models are not ported yet ({LATER['whisper']})")
    dev = generator.device
    batch = {
        k: torch.randint(0, cfg.vocab, (b, s), generator=generator, device=dev)
        for k in ("tokens", "targets")
    }
    if cfg.rope == "mrope":
        pos = torch.arange(s, device=dev)[None].expand(b, s)
        batch["pos"] = pos[None].expand(3, b, s)
    return batch
