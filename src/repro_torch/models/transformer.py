"""Decoder LM over a block pattern (counterpart of
``repro/models/transformer.py``): prefill of a prompt batch and one-token
decode steps over per-layer caches for serving, and the training loss
(``loss``, ``loss_and_stats``) with per-layer rematerialization.

One ``Block`` module per layer in ``cfg.blocks()`` order (a Python loop
takes the place of the reference's ``lax.scan`` over stacked segments).
Block kinds: ``attn``, ``local`` (sliding window ``cfg.window``) and
``moe`` (attention, then the Mixture-of-Experts layer of ``models/mlp.py``
on ``cfg.moe_route``); ``mamba`` (Mamba2, ``models/ssm.py``), ``mlstm``
and ``slstm`` (``models/xlstm.py``); and ``shared_attn``, zamba2's one
attention + MLP block, held once as ``DecoderLM.shared_attn`` and run at
every ``shared_attn`` position, each position with its own KV cache.

The backend follows ``GymConfig.local_backend``: ``'cuda'`` runs prefill
attention on the Hopper flash kernel and refuses CPU tensors, ``'torch'``
runs its plain version on any device, and ``None`` means ``'cuda'`` on a
CUDA device and ``'torch'`` on the CPU.  The flash kernel has no
backward, so the loss takes ``kernels.ops.attention``'s rule under
autograd (the chunked scan at 2048 keys and more, the plain version
below) unless ``impl`` names one; with the ``'cuda'`` backend named it
reaches the kernel, which refuses to be recorded.  The recurrent kinds
run plain PyTorch on either backend (the reference has no kernel there).
The device defaults to the CUDA card and raises without one; the CPU is
used only when asked for.

Under a partition (``launch.shardings.partitioned``: a train step,
prefill or decode on a mesh) each layer takes its parameters through
``fetch`` inside the layer's call, under remat too, so nothing gathered
outlives its layer: attention and the MLP and MoE layers compute on
their ``"model"`` shards where the split allows it (``models/attention.py``,
``models/mlp.py``), the tables, norms and recurrent blocks replicated.
Prefill keeps each rank's part of the KV caches (``Partition.kv``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..launch import shardings as SH
from ..relational.spmd import resolve_device
from . import ssm, xlstm
from .attention import attn_decode, attn_forward, attn_prefill, init_attn
from .common import (
    ArchConfig, embed, init_embed, init_norm, rms_norm, softmax_xent, unembed,
)
from .mlp import init_mlp, init_moe, mlp_forward, moe_forward_stats

BACKENDS = ("torch", "cuda")
#: the kinds whose cache is a KV cache (the reference's ``ATTN_KINDS``)
ATTN_KINDS = ("attn", "local", "moe", "shared_attn")


class Recurrent(NamedTuple):
    """A recurrent block kind's functions (``models/ssm.py``,
    ``models/xlstm.py``)."""
    init: Callable
    prefill: Callable
    decode: Callable
    init_state: Callable


RECURRENT = {
    "mamba": Recurrent(ssm.init_mamba, ssm.mamba_prefill, ssm.mamba_decode, ssm.mamba_init_state),
    "mlstm": Recurrent(xlstm.init_mlstm, xlstm.mlstm_prefill, xlstm.mlstm_decode,
                       xlstm.mlstm_init_state),
    "slstm": Recurrent(xlstm.init_slstm, xlstm.slstm_prefill, xlstm.slstm_decode,
                       xlstm.slstm_init_state),
}
PORTED_KINDS = ATTN_KINDS + tuple(RECURRENT)
MOE_STATS = ("routed", "dropped", "heavy")


def check_kinds(cfg: ArchConfig) -> None:
    """Raise for the first block kind of ``cfg`` that no model knows."""
    for kind in cfg.blocks():
        if kind not in PORTED_KINDS:
            raise ValueError(f"{cfg.name}: unknown block kind {kind!r} (known: {PORTED_KINDS})")


class Block(nn.Module):
    """One decoder layer: attention (global or windowed) then the MLP, for
    kind ``moe`` global attention then the MoE layer, or one recurrent
    block (``mamba``, ``mlstm``, ``slstm``: its parameters under the kind's
    name, as in the reference's tree)."""

    def __init__(self, kind: str, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        self.kind = kind
        self.cfg = cfg
        self.window = cfg.window if kind == "local" else 0
        if kind in RECURRENT:
            setattr(self, kind, RECURRENT[kind].init(gen, cfg))
            return
        self.attn = init_attn(gen, cfg)
        if kind == "moe":
            self.moe = init_moe(gen, cfg)
        else:
            self.mlp = init_mlp(gen, cfg)

    def _ffn(self, x: torch.Tensor):
        """The feed-forward half: (output, MoE stats or None)."""
        if self.kind == "moe":
            return moe_forward_stats(self.moe, x, self.cfg)
        return mlp_forward(self.mlp, x, self.cfg), None

    def forward(self, x: torch.Tensor, pos: torch.Tensor, use_cuda: Optional[bool],
                impl: Optional[str] = None):
        """(output, MoE stats ``{routed, dropped, heavy}`` or None)."""
        if self.kind in RECURRENT:
            return RECURRENT[self.kind].prefill(SH.fetch(getattr(self, self.kind)), x, self.cfg)[0], None
        x = attn_forward(
            self.attn, x, self.cfg, pos=pos, causal=True, window=self.window,
            use_cuda=use_cuda, impl=impl,
        )
        return self._ffn(x)

    def prefill(self, x, pos, use_cuda: bool):
        if self.kind in RECURRENT:
            return RECURRENT[self.kind].prefill(SH.fetch(getattr(self, self.kind)), x, self.cfg)
        x, cache = attn_prefill(
            self.attn, x, self.cfg, pos=pos, causal=True, window=self.window,
            use_cuda=use_cuda,
        )
        return self._ffn(x)[0], cache

    def decode(self, x, cache, cache_len: int):
        if self.kind in RECURRENT:
            return RECURRENT[self.kind].decode(SH.fetch(getattr(self, self.kind)), x, cache, self.cfg)
        x, cache = attn_decode(self.attn, x, cache, cache_len, self.cfg, window=self.window)
        return self._ffn(x)[0], cache

    def init_cache(self, batch: int, s_cache: int, device) -> Dict[str, torch.Tensor]:
        """This layer's empty cache: zero ``{k, v}`` of ``s_cache``
        positions, or the recurrent kind's initial state."""
        if self.kind in RECURRENT:
            return RECURRENT[self.kind].init_state(self.cfg, batch, device)
        cfg = self.cfg
        shape = (batch, cfg.n_kv_heads, s_cache, cfg.hd)
        return {k: torch.zeros(shape, dtype=cfg.torch_dtype, device=device) for k in ("k", "v")}


class SharedPosition(nn.Module):
    """A ``shared_attn`` position: it runs the model's one shared block and
    holds no parameter of its own (the block is not registered here, so
    the model's parameters and state dict hold it once, as
    ``shared_attn.*``, and its gradient sums over the positions)."""

    def __init__(self, block: Block):
        super().__init__()
        self.kind = block.kind
        self.__dict__["block"] = block  # bypasses nn.Module's registration

    def forward(self, *args):
        return self.block(*args)

    def prefill(self, *args):
        return self.block.prefill(*args)

    def decode(self, *args):
        return self.block.decode(*args)

    def init_cache(self, *args):
        return self.block.init_cache(*args)


class ModelBase(nn.Module):
    """What ``DecoderLM`` and ``WhisperModel`` (``models/whisper.py``)
    share: the device (None = the CUDA card), the backend and the
    generator the parameters are drawn from."""

    def __init__(self, cfg: ArchConfig, device=None, backend: Optional[str] = None):
        super().__init__()
        if backend not in (None,) + BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        self.cfg = cfg
        self.device = resolve_device(device)
        #: 'cuda' | 'torch' | None (follow the device); may be switched later
        self.backend = backend

    def _generator(self, gen: Optional[torch.Generator]) -> Optional[torch.Generator]:
        """The generator to draw parameters from: ``gen``, or one seeded
        with 0 on the model's device; None on the meta device (shapes
        only: nothing is drawn)."""
        dev = self.device
        if dev.type == "meta":
            if gen is not None:
                raise ValueError("a model on the meta device takes no generator")
            return None
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
        elif gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, model on {dev}")
        return gen

    @property
    def use_cuda(self) -> bool:
        """Whether serving attention launches the Hopper kernel."""
        backend = self.backend
        if backend is None:
            backend = "cuda" if self.device.type == "cuda" else "torch"
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        return backend == "cuda"

    def _train_use_cuda(self) -> Optional[bool]:
        """The loss's ``use_cuda``: None follows the tensors and autograd
        (``kernels.ops.attention``), a named backend is kept."""
        if self.backend not in (None,) + BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")
        return None if self.backend is None else self.backend == "cuda"


class DecoderLM(ModelBase):
    """Serving surface: ``prefill(batch, s_cache) -> (last logits, caches)``,
    ``decode_step(caches, tokens) -> (logits, caches)``, ``init_caches``,
    and ``logits`` for the full forward pass; training surface: ``loss``,
    ``loss_and_stats`` and ``param_leaves``.

    Caches are ``{"layers": [one dict a layer], "len": int}``, each
    layer's by its kind as in the reference: ``{"k", "v"}`` (B, KV,
    s_cache, hd) for the attention kinds, written in place by decode;
    ``{"conv", "ssm"}`` for ``mamba``, ``{"c", "n"}`` for ``mlstm`` and
    ``{"c", "n", "h", "m"}`` for ``slstm``, all f32, replaced each step."""

    def __init__(
        self,
        cfg: ArchConfig,
        device=None,
        *,
        backend: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
    ):
        if cfg.encdec:
            raise ValueError(f"{cfg.name} is an encoder-decoder: build it with "
                             "configs.get_model, which gives a WhisperModel")
        check_kinds(cfg)
        super().__init__(cfg, device, backend)
        dev = self.device
        gen = self._generator(generator)
        self.embed = init_embed(gen, cfg.vocab, cfg.d_model, cfg.torch_dtype)
        self.final_ln = init_norm(cfg.d_model, cfg.torch_dtype, dev)
        if not cfg.tie_embeddings:
            self.unembed = init_embed(gen, cfg.vocab, cfg.d_model, cfg.torch_dtype)
        layers: List[nn.Module] = []
        for kind in cfg.blocks():
            if kind != "shared_attn":
                layers.append(Block(kind, cfg, gen))
                continue
            if not hasattr(self, "shared_attn"):  # one block for every position
                self.shared_attn = Block(kind, cfg, gen)
            layers.append(SharedPosition(self.shared_attn))
        self.layers = nn.ModuleList(layers)

    # ------------------------------------------------------------- helpers
    def _table(self) -> torch.Tensor:
        return (self.unembed if not self.cfg.tie_embeddings else self.embed)["table"]

    def _pos(self, pos: Optional[torch.Tensor], b: int, s: int) -> torch.Tensor:
        if pos is not None:
            return pos.to(self.device)
        pos = torch.arange(s, device=self.device)[None].expand(b, s)
        if self.cfg.rope == "mrope":
            pos = pos[None].expand(3, b, s)
        return pos

    def _head(self, x: torch.Tensor, table: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Final norm and unembedding; ``table``: the tied table the
        embedding fetched (one gathered table, whose two gradients sum in
        its dtype, as the single process' parameter's do).  Serving under
        a partition whose ``"model"`` splits the vocabulary computes its
        columns and gathers the logits (``launch.shardings.vocab_logits``)."""
        x = rms_norm(x, SH.fetch_one(self.final_ln), self.cfg.norm_eps)
        if table is None and SH.vocab_split(self._table()):
            return SH.vocab_logits(x, self._table(), self.cfg.logit_softcap)
        table = SH.fetch_one(self._table()) if table is None else table
        return unembed(x, table, self.cfg.logit_softcap)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The embedding lookup (vocab-parallel when serving under a
        partition that splits the vocabulary)."""
        table = self.embed["table"]
        if SH.vocab_split(table):
            return SH.vocab_embed(tokens, table)
        return embed(tokens, SH.fetch_one(table))

    # ------------------------------------------------------------- forward
    def _forward(self, tokens: torch.Tensor, pos: Optional[torch.Tensor],
                 use_cuda: Optional[bool], impl: Optional[str] = None,
                 remat: bool = False):
        """tokens (B, S) -> (f32 logits (B, S, V), the MoE stats summed over
        MoE layers, int32).  ``remat`` runs each layer under
        ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` over
        its scanned layer): the backward keeps one activation a layer and
        recomputes the rest."""
        b, s = tokens.shape
        pos = self._pos(pos, b, s)
        table = SH.fetch_one(self.embed["table"])
        x = embed(tokens.to(self.device), table)
        totals = {k: torch.zeros((), dtype=torch.int32, device=self.device) for k in MOE_STATS}
        for layer in self.layers:
            if remat:
                x, stats = checkpoint(layer, x, pos, use_cuda, impl, use_reentrant=False)
            else:
                x, stats = layer(x, pos, use_cuda, impl)
            if stats is not None:
                totals = {k: totals[k] + stats[k] for k in MOE_STATS}
        return self._head(x, table if self.cfg.tie_embeddings else None), totals

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor, pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full forward pass: tokens (B, S) -> f32 logits (B, S, V)."""
        return self._forward(tokens, pos, self.use_cuda)[0]

    # --------------------------------------------------------------- train
    def loss(self, batch: Dict[str, torch.Tensor], remat: bool = True,
             impl: Optional[str] = None) -> torch.Tensor:
        """Mean token cross-entropy of ``batch["tokens"]`` against
        ``batch["targets"]`` (both (B, S)); ``batch["pos"]`` is optional.
        ``impl`` picks the attention (``kernels.ops.attention``)."""
        return self.loss_and_stats(batch, remat=remat, impl=impl)[0]

    def loss_and_stats(self, batch: Dict[str, torch.Tensor], remat: bool = True,
                       impl: Optional[str] = None):
        """Loss plus the MoE routing counts ``{routed, dropped, heavy}``
        summed over MoE layers (int32; zeros for a model without MoE
        blocks, as in the reference)."""
        logits, stats = self._forward(batch["tokens"], batch.get("pos"), self._train_use_cuda(),
                                      impl, remat)
        return softmax_xent(logits, batch["targets"].to(self.device)), stats

    def with_config(self, cfg: ArchConfig) -> "DecoderLM":
        """A model of ``cfg`` over this model's parameters, the same tensors
        (the reference's ``get_model(cfg)`` applied to the same params):
        for example ``moe_routing.apply_plan(self.cfg, plan)`` to run the
        calibrated MoE route on the weights of the dense one.  ``cfg`` must
        give every parameter the same shape."""
        new = DecoderLM(cfg, "meta", backend=self.backend)
        new.load_state_dict(self.state_dict(), assign=True)
        new.device = self.device
        return new

    def param_leaves(self) -> List[Tuple[Tuple[str, ...], bool]]:
        """The reference's parameter leaves over this model's parameter
        names, ``(names, stacked)``: the unstacked ones (the tables, the
        final norm, zamba2's shared block, which the reference keeps as
        one unstacked leaf whatever its count of positions), then each
        segment's.  The
        reference stacks each run of equal block kinds (``cfg.segments()``)
        on a leading layer axis, so one leaf there is ``stacked`` layers
        here; the optimizer and the gradient codec treat such a leaf as one
        tensor (``train/optim.py``)."""
        out: List[Tuple[Tuple[str, ...], bool]] = []
        for name, _ in self.named_parameters():
            if not name.startswith("layers."):
                out.append(((name,), False))
        first = 0
        for _, count in self.cfg.segments():
            for key, _ in self.layers[first].named_parameters():
                out.append((tuple(f"layers.{first + i}.{key}" for i in range(count)), True))
            first += count
        return out

    # --------------------------------------------------------------- serve
    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], s_cache: Optional[int] = None):
        """Run the prompt; returns (last-token logits (B, V), caches), the
        KV caches zero-padded to ``s_cache`` positions with ``len = S``."""
        tokens = batch["tokens"].to(self.device)
        b, s = tokens.shape
        s_cache = s_cache or s
        if s_cache < s:
            raise ValueError(f"s_cache {s_cache} < prompt length {s}")
        pos = self._pos(batch.get("pos"), b, s)
        use_cuda = self.use_cuda
        x = self._embed(tokens)
        caches: List[Dict[str, torch.Tensor]] = []
        for layer in self.layers:
            x, c = layer.prefill(x, pos, use_cuda)
            if layer.kind in ATTN_KINDS:
                c = {k: _kv_part(_pad_seq(t, s_cache)) for k, t in c.items()}
            caches.append(c)
        logits = self._head(x[:, -1:])
        return logits[:, 0], {"layers": caches, "len": s}

    def init_caches(self, batch: int, s_cache: int, prefix_len: int) -> Dict[str, Any]:
        """Empty caches claiming a valid prefix of ``prefix_len``: zero KV
        caches of ``s_cache`` positions, each recurrent layer's initial
        state (each layer gets its own tensors)."""
        layers = [layer.init_cache(batch, s_cache, self.device) for layer in self.layers]
        return {"layers": layers, "len": int(prefix_len)}

    @torch.no_grad()
    def decode_step(self, caches: Dict[str, Any], tokens: torch.Tensor):
        """One token for every sequence: tokens (B,) -> logits (B, V).  A
        model with attention refuses a full KV cache; a recurrent-only
        one has no cache length."""
        clen = int(caches["len"])
        kv = [c["k"].shape[2] for layer, c in zip(self.layers, caches["layers"])
              if layer.kind in ATTN_KINDS]
        part = SH.current_partition()
        if kv and part is not None and part.m > 1 and isinstance(part.kv, tuple):
            kv = [part.kv[1]]  # ("seq", s_cache): a rank holds a chunk of the positions
        if kv and clen >= kv[0]:
            raise ValueError(f"cache full: len {clen} of {kv[0]}")
        x = self._embed(tokens.to(self.device)[:, None])
        new: List[Dict[str, torch.Tensor]] = []
        for layer, cache in zip(self.layers, caches["layers"]):
            x, c = layer.decode(x, cache, clen)
            new.append(c)
        logits = self._head(x)[:, 0]
        return logits, {"layers": new, "len": clen + 1}


def _kv_part(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of a whole (B, KV, s_cache, hd) cache, where the
    current partition splits caches on the sequence (a copy); ``t`` as it
    is otherwise (a cache split on heads is computed split)."""
    part = SH.current_partition()
    if part is None or part.m == 1 or not isinstance(part.kv, tuple):
        return t
    n = t.shape[2] // part.m
    return t.narrow(2, part.rank_in_model * n, n).clone()


def _pad_seq(t: torch.Tensor, s_cache: int) -> torch.Tensor:
    """(B, KV, S, hd) -> (B, KV, s_cache, hd), zeros after S."""
    b, kv, s, hd = t.shape
    out = torch.zeros((b, kv, s_cache, hd), dtype=t.dtype, device=t.device)
    out[:, :, :s] = t
    return out
