"""Architecture + shape registry (counterpart of
``repro/configs/registry.py``): config lookup by ``--arch`` id, the model
for a config, the reduced smoke configs and a concrete smoke batch, the
cells of the dry run (``SHAPES``, ``LONG_OK``, ``cell_enabled``,
``cells``) and their inputs as meta-device tensors (``input_specs``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..models.common import ArchConfig
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

# shape id -> (seq_len, global_batch, kind)
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}

# long_500k only for sub-quadratic (SSM/hybrid) archs, as in the reference
LONG_OK = {"xlstm-125m", "zamba2-7b"}


def cell_enabled(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_OK
    return True


def cells() -> Tuple[Tuple[str, str], ...]:
    return tuple((a, s) for a in CONFIGS for s in SHAPES if cell_enabled(a, s))


#: families whose model is ported, every family of CONFIGS: decoder LMs of
#: attention + MLP blocks (qwen2-vl's backbone is one, with M-RoPE), of
#: attention + MoE blocks, of mLSTM + sLSTM blocks (ssm: xlstm-125m) and of
#: Mamba2 blocks with a shared attention block (hybrid: zamba2-7b), and the
#: encoder-decoder (audio: whisper-small)
PORTED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def get_config(arch: str) -> ArchConfig:
    return CONFIGS[arch]


def get_model(cfg: ArchConfig, device=None, **kw):
    """The model of ``cfg`` on ``device`` (None = the CUDA card): a
    ``WhisperModel`` for an encoder-decoder, else a ``DecoderLM``; ``kw``
    goes to its constructor (``backend``, ``generator``)."""
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r} (known: {PORTED_FAMILIES})")
    from ..models.transformer import DecoderLM
    from ..models.whisper import WhisperModel

    return (WhisperModel if cfg.encdec else DecoderLM)(cfg, device, **kw)


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


# ------------------------------------------------------------- input specs
def _tok(b: int, s: int) -> torch.Tensor:
    return torch.empty((b, s), dtype=torch.int32, device="meta")


def input_specs(cfg: ArchConfig, shape: str, *, batch: Optional[int] = None,
                seq: Optional[int] = None) -> Dict:
    """Meta-device stand-ins (shapes and dtypes, no storage) for every
    model input of the cell, as the reference's ShapeDtypeStructs:

    train   -> ``{"batch": {...}}``, the train step's batch;
    prefill -> ``{"batch": {...}}``, the prefill's;
    decode  -> ``{"caches", "tokens"}``: ``init_caches`` of the model on
    ``meta`` and one token a sequence.

    ``batch`` and ``seq`` replace the shape's batch and sequence length
    (for decode the cache's positions, for whisper its frames)."""
    s, b, kind = SHAPES[shape]
    b = b if batch is None else int(batch)
    s = s if seq is None else int(seq)

    def frames(n: int) -> torch.Tensor:
        return torch.empty((b, n, cfg.d_model), dtype=cfg.torch_dtype, device="meta")

    if kind in ("train", "prefill"):
        if cfg.encdec:
            batch = {"frames": frames(s)}
            if kind == "train":
                batch["tokens"], batch["targets"] = _tok(b, s // cfg.dec_ratio), _tok(b, s // cfg.dec_ratio)
            return {"batch": batch}
        batch = {"tokens": _tok(b, s)}
        if kind == "train":
            batch["targets"] = _tok(b, s)
        if cfg.rope == "mrope":
            batch["pos"] = torch.empty((3, b, s), dtype=torch.int32, device="meta")
        return {"batch": batch}
    # decode: one new token against an S-length cache
    model = get_model(cfg, "meta")
    caches = model.init_caches(b, s, 64) if cfg.encdec else model.init_caches(b, s, s - 1)
    return {"caches": caches, "tokens": torch.empty((b,), dtype=torch.int32, device="meta")}


def make_smoke_batch(cfg: ArchConfig, generator: torch.Generator, b: int = 2,
                     s: int = 32) -> Dict[str, torch.Tensor]:
    """A concrete small training batch (reduced configs) from ``generator``,
    on its device: random tokens and targets in ``[0, vocab)`` and the
    ``(3, B, S)`` text positions for an M-RoPE config; for an
    encoder-decoder, normal frames ``(B, S, d_model)`` in the config's
    dtype and ``max(4, S // dec_ratio)`` tokens and targets.  The draws
    have the reference's distribution, not its bits."""
    dev = generator.device
    if cfg.encdec:
        sd = max(4, s // cfg.dec_ratio)
        frames = torch.randn((b, s, cfg.d_model), generator=generator, device=dev)
        batch = {"frames": frames.to(cfg.torch_dtype)}
        batch.update({
            k: torch.randint(0, cfg.vocab, (b, sd), generator=generator, device=dev)
            for k in ("tokens", "targets")
        })
        return batch
    batch = {
        k: torch.randint(0, cfg.vocab, (b, s), generator=generator, device=dev)
        for k in ("tokens", "targets")
    }
    if cfg.rope == "mrope":
        pos = torch.arange(s, device=dev)[None].expand(b, s)
        batch["pos"] = pos[None].expand(3, b, s)
    return batch
