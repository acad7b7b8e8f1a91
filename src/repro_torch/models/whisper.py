"""Whisper-style encoder-decoder backbone (arXiv:2212.04356), the
counterpart of ``repro/models/whisper.py``.

The conv/mel frontend is a stub, as in the reference: the model takes
precomputed frame embeddings ``(B, S_frames, d_model)``.  The transformer
backbone is real: a bidirectional encoder, a causal decoder with
cross-attention, sinusoidal positions, the embedding table tied to the
output.

- train: encode S frames, teacher-forced decoder over ``S // dec_ratio``
  tokens (``loss``);
- prefill: encode, build every decoder layer's cross K/V once, run the
  BOS token (``prefill``);
- decode: one decoder token against the S-frame cross K/V and its own
  self-attention cache (``decode_step``).

One module per layer: ``enc.{i}.{attn,mlp}`` and
``dec.{i}.{self,cross,mlp}`` (the reference scans stacked ``enc``/``dec``
leaves, axis 0 the layer; ``interop.lm_params_from_numpy`` maps one onto
the other).  The encoder's attention and every cross-attention call run
through ``kernels.ops.attention``: with the ``'cuda'`` backend and no
autograd the Hopper flash kernel (non-causal; at Sq = 1 in decode), with
``'torch'`` its plain version.  The decoder's self-attention decodes in
plain torch, as every decoder of the port does.

Caches are the reference's layout: ``{"cross": {"k", "v"}, "self": {"k",
"v"}, "len": int}``, each tensor ``(L, B, KV, S, hd)`` with the layer on
axis 0; decode writes the self cache in place, one row a layer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..launch import shardings as SH
from .attention import (
    attn_decode, attn_forward, cross_attn_forward, cross_kv, init_attn, init_cross_attn,
)
from .common import ArchConfig, embed, init_embed, init_norm, rms_norm, softmax_xent, unembed
from .mlp import init_mlp, mlp_forward
from .transformer import ModelBase


def sinusoid(s: int, d: int, dtype, device=None) -> torch.Tensor:
    """(s, d) sinusoidal positions, sin on even columns and cos on odd,
    computed in f32 and cast to ``dtype``."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(
        -math.log(10000.0) * torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    )
    pe = torch.zeros((s, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


def _enc_cfg(cfg: ArchConfig) -> ArchConfig:
    return dataclasses.replace(cfg, rope="none")


class EncoderLayer(nn.Module):
    """Bidirectional self-attention, then the MLP."""

    def __init__(self, cfg: ArchConfig, gen: Optional[torch.Generator]):
        super().__init__()
        self.cfg = cfg
        self.attn = init_attn(gen, cfg)
        self.mlp = init_mlp(gen, cfg)

    def forward(self, x: torch.Tensor, use_cuda: Optional[bool], impl: Optional[str] = None):
        x = attn_forward(self.attn, x, self.cfg, pos=None, causal=False, use_cuda=use_cuda,
                         impl=impl)
        return mlp_forward(self.mlp, x, self.cfg)


class DecoderLayer(nn.Module):
    """Causal self-attention, cross-attention to the encoder, the MLP."""

    def __init__(self, cfg: ArchConfig, gen: Optional[torch.Generator]):
        super().__init__()
        self.cfg = cfg
        self.self = init_attn(gen, cfg)
        self.cross = init_cross_attn(gen, cfg)
        self.mlp = init_mlp(gen, cfg)

    def forward(self, x: torch.Tensor, mem: torch.Tensor, use_cuda: Optional[bool],
                impl: Optional[str] = None):
        """The full-sequence layer (training): the cross K/V from ``mem``."""
        cfg = self.cfg
        x = attn_forward(self.self, x, cfg, pos=None, causal=True, use_cuda=use_cuda, impl=impl)
        x = cross_attn_forward(self.cross, x, cross_kv(self.cross, mem, cfg), cfg,
                               use_cuda=use_cuda, impl=impl)
        return mlp_forward(self.mlp, x, cfg)

    def decode(self, x, self_cache, cross, cache_len: int, use_cuda: bool):
        x, _ = attn_decode(self.self, x, self_cache, cache_len, self.cfg)
        x = cross_attn_forward(self.cross, x, cross, self.cfg, use_cuda=use_cuda)
        return mlp_forward(self.mlp, x, self.cfg)


class WhisperModel(ModelBase):
    """Serving surface: ``prefill(batch, s_cache) -> (BOS logits, caches)``,
    ``decode_step(caches, tokens) -> (logits, caches)``, ``init_caches``;
    training surface: ``loss`` and ``param_leaves``; ``encode`` and
    ``_decode_stack`` as in the reference.  The constructor takes
    ``DecoderLM``'s arguments and the same backend rule."""

    def __init__(
        self,
        cfg: ArchConfig,
        device=None,
        *,
        backend: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
    ):
        if not cfg.encdec:
            raise ValueError(f"{cfg.name} is not an encoder-decoder: build it with configs.get_model")
        super().__init__(cfg, device, backend)
        gen = self._generator(generator)
        dt, dev = cfg.torch_dtype, self.device
        ecfg = _enc_cfg(cfg)
        self.embed = init_embed(gen, cfg.vocab, cfg.d_model, dt)
        self.enc = nn.ModuleList(EncoderLayer(ecfg, gen) for _ in range(cfg.enc_layers or cfg.n_layers))
        self.dec = nn.ModuleList(DecoderLayer(cfg, gen) for _ in range(cfg.n_layers))
        self.enc_ln = init_norm(cfg.d_model, dt, dev)
        self.final_ln = init_norm(cfg.d_model, dt, dev)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, SH.fetch_one(self.final_ln), self.cfg.norm_eps)
        return unembed(x, SH.fetch_one(self.embed["table"]))

    # ----------------------------------------------------------------- encoder
    def encode(self, frames: torch.Tensor, use_cuda: Optional[bool],
               impl: Optional[str] = None, remat: bool = False) -> torch.Tensor:
        """frames (B, S, D) -> the normed encoder output (B, S, D);
        ``use_cuda`` and ``impl`` go to ``kernels.ops.attention``."""
        frames = frames.to(self.device)
        b, s, d = frames.shape
        x = frames + sinusoid(s, d, frames.dtype, self.device)[None]
        for layer in self.enc:
            if remat:
                x = checkpoint(layer, x, use_cuda, impl, use_reentrant=False)
            else:
                x = layer(x, use_cuda, impl)
        return rms_norm(x, SH.fetch_one(self.enc_ln), self.cfg.norm_eps)

    # ----------------------------------------------------------------- decoder
    def _decode_stack(self, tokens: torch.Tensor, mem: torch.Tensor, use_cuda: Optional[bool],
                      impl: Optional[str] = None, remat: bool = False) -> torch.Tensor:
        """Teacher-forced decoder over tokens (B, S) against ``mem``: the
        final-normed stream (B, S, D)."""
        b, s = tokens.shape
        x = embed(tokens.to(self.device), SH.fetch_one(self.embed["table"]))
        x = x + sinusoid(s, self.cfg.d_model, x.dtype, self.device)[None]
        for layer in self.dec:
            if remat:
                x = checkpoint(layer, x, mem, use_cuda, impl, use_reentrant=False)
            else:
                x = layer(x, mem, use_cuda, impl)
        return rms_norm(x, SH.fetch_one(self.final_ln), self.cfg.norm_eps)

    @torch.no_grad()
    def logits(self, frames: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The full forward pass: f32 logits (B, S, V) of ``tokens``
        teacher-forced against ``frames``."""
        use_cuda = self.use_cuda
        x = self._decode_stack(tokens, self.encode(frames, use_cuda), use_cuda)
        return unembed(x, SH.fetch_one(self.embed["table"]))

    # ------------------------------------------------------------------- train
    def loss(self, batch: Dict[str, torch.Tensor], remat: bool = True,
             impl: Optional[str] = None) -> torch.Tensor:
        """Mean token cross-entropy of the decoder over ``batch["tokens"]``
        against ``batch["targets"]``, given ``batch["frames"]``; ``remat``
        runs each layer under ``torch.utils.checkpoint``."""
        use_cuda = self._train_use_cuda()
        mem = self.encode(batch["frames"], use_cuda, impl, remat)
        x = self._decode_stack(batch["tokens"], mem, use_cuda, impl, remat)
        logits = unembed(x, SH.fetch_one(self.embed["table"]))
        return softmax_xent(logits, batch["targets"].to(self.device))

    def param_leaves(self) -> List[Tuple[Tuple[str, ...], bool]]:
        """The reference's parameter leaves over this model's names: the
        table and the two final norms unstacked, then each of ``enc``'s
        and ``dec``'s leaves, which stack the layers on axis 0 there."""
        out: List[Tuple[Tuple[str, ...], bool]] = [
            ((name,), False) for name, _ in self.named_parameters()
            if not name.startswith(("enc.", "dec."))
        ]
        for stack in ("enc", "dec"):
            layers = getattr(self, stack)
            for key, _ in layers[0].named_parameters():
                out.append((tuple(f"{stack}.{i}.{key}" for i in range(len(layers))), True))
        return out

    # ------------------------------------------------------------------- serve
    def init_caches(self, batch: int, s_frames: int, dec_cache: int) -> Dict:
        """Empty caches with ``len`` 0: zero cross K/V of ``s_frames``
        positions and zero self K/V of ``dec_cache``, on the model's device
        (``meta``: shapes only)."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, cfg.n_kv_heads)
        dt, dev = cfg.torch_dtype, self.device
        return {
            "cross": {k: torch.zeros(shape + (s_frames, cfg.hd), dtype=dt, device=dev)
                      for k in ("k", "v")},
            "self": {k: torch.zeros(shape + (dec_cache, cfg.hd), dtype=dt, device=dev)
                     for k in ("k", "v")},
            "len": 0,
        }

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], s_cache: int = 0):
        """Encode ``batch["frames"]``, project every decoder layer's cross
        K/V once, and run the BOS token (``batch["bos"]``, default 0)
        through ``decode_step``; ``s_cache`` (0: 64) sizes the self cache.
        Returns (the BOS step's logits (B, V), caches)."""
        cfg = self.cfg
        mem = self.encode(batch["frames"], self.use_cuda)
        b, s, _ = mem.shape
        caches = self.init_caches(b, 0, s_cache or 64)
        shape = (cfg.n_layers, b, cfg.n_kv_heads, s, cfg.hd)
        cross = {k: torch.empty(shape, dtype=mem.dtype, device=self.device) for k in ("k", "v")}
        for i, layer in enumerate(self.dec):
            for k, t in cross_kv(layer.cross, mem, cfg).items():
                cross[k][i] = t
        caches["cross"] = cross
        del mem
        bos = batch.get("bos")
        bos = torch.zeros((b,), dtype=torch.long, device=self.device) if bos is None else bos
        return self.decode_step(caches, bos)

    @torch.no_grad()
    def decode_step(self, caches: Dict, tokens: torch.Tensor):
        """One decoder token for every sequence: tokens (B,) -> f32 logits
        (B, V) and the caches with ``len + 1`` (the self cache written in
        place).  A full self cache raises: the reference's clamped
        ``dynamic_slice`` would reuse the last position row and slot."""
        clen = int(caches["len"])
        sk, sv = caches["self"]["k"], caches["self"]["v"]
        s_total = sk.shape[3]
        if clen >= s_total:
            raise ValueError(f"decode_step: cache full, len {clen} of {s_total} positions")
        x = embed(tokens.to(self.device)[:, None], SH.fetch_one(self.embed["table"]))
        x = x + sinusoid(s_total, self.cfg.d_model, x.dtype, self.device)[clen]
        use_cuda = self.use_cuda
        ck, cv = caches["cross"]["k"], caches["cross"]["v"]
        for i, layer in enumerate(self.dec):
            x = layer.decode(x, {"k": sk[i], "v": sv[i]}, {"k": ck[i], "v": cv[i]}, clen, use_cuda)
        logits = self._head(x)[:, 0]
        return logits, {"cross": caches["cross"], "self": caches["self"], "len": clen + 1}
