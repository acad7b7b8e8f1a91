"""Prefill and decode on a mesh: the counterpart of the reference's
``prefill_step`` and ``serve_step`` (``repro/launch/dryrun.py:87-112``),
which ``jit`` under the serving placements.

``MeshServer(model, mesh)`` places ``model``'s parameters on ``mesh``
(a ``("data", "model")`` or ``("pod", "data", "model")`` ``DeviceMesh``,
``launch/mesh.py``): TP-only (``"model"`` splits, no data axis) when a
``"model"`` shard of the parameters fits ``SERVE_TP_ONLY_BYTES``, else the
training rules, as the reference decides (``dryrun.py:83,100``).  Each
rank keeps only its shards: the model's own parameters point at them, so
the model serves on the mesh alone.  Every rank makes the same calls:

- ``prefill(batch, s_cache)``: the rank's slice of the batch (its data
  coordinates, ``batch_specs``) through the partitioned layers
  (``models/``: each layer gathers what it needs inside its call and
  computes on its ``"model"`` shards where the split is head-aligned),
  a MoE layer's capacity and arrival order the whole batch's
  (``BatchSplit``), keeping its part of each KV cache under ``cache_spec``: its K/V heads
  where ``"model"`` divides them, else its chunk of the positions, else
  the whole cache; recurrent states whole (their blocks compute
  replicated);
- ``decode_step(caches, tokens)``: one token for the rank's slice; a
  cache split on the sequence is attended chunk by chunk, the partial
  max, sum and output combined over ``"model"``: no rank gathers a cache;
- ``generate(prompt, steps)``: greedy tokens (and logits) of the whole
  batch on every rank, the slices gathered at the end.

Entry points run on the card unless the model and mesh are on the CPU.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..launch import shardings as SH

#: a serving model whose ``"model"`` shard fits this takes TP-only weights
SERVE_TP_ONLY_BYTES = 8 << 30


def serve_tp_only(params: Dict[str, torch.Tensor], mesh) -> bool:
    """Whether ``params`` serve TP-only on ``mesh``: their bytes over the
    ``"model"`` axis' size at most ``SERVE_TP_ONLY_BYTES``."""
    total = sum(p.numel() * p.element_size() for p in params.values())
    return total // SH.mesh_shape(mesh).shape["model"] <= SERVE_TP_ONLY_BYTES


def kv_split(cfg, mesh, s_cache: int):
    """How ``cache_spec`` splits a KV cache of ``s_cache`` positions over
    ``"model"``: ``"heads"``, ``("seq", s_cache)`` or None (whole)."""
    spec = SH.cache_spec("k", (1, 1, cfg.n_kv_heads, s_cache, cfg.hd), mesh)
    if spec[2] == "model":
        return "heads"
    if len(spec) > 3 and spec[3] == "model":
        return ("seq", s_cache)
    return None


class MeshServer:
    """``model`` placed for serving on ``mesh`` (see the module doc)."""

    def __init__(self, model, mesh):
        self.model, self.mesh = model, mesh
        params = dict(model.named_parameters())
        self.tp_only = serve_tp_only(params, mesh)
        specs = SH.param_specs(model.cfg, params, mesh, serve_tp_only=self.tp_only)
        self.where = {id(p): SH.placements(specs[k], mesh) for k, p in params.items()}
        with torch.no_grad():
            for k, p in params.items():
                p.data = SH.shard_of(p.detach(), mesh, self.where[id(p)])
        self.kv, self.dims = None, ()

    def set_slice(self, dims, s_cache: Optional[int] = None) -> None:
        """Serve this rank's slice of a batch split over the mesh dims
        ``dims`` (``launch.shardings.batch_dims``), with caches of
        ``s_cache`` positions: a decoder LM's KV caches split as
        ``kv_split`` says, an encoder-decoder's stay whole over ``"model"``
        (its blocks compute replicated).  ``prefill_slice`` sets it;
        ``decode_step`` on caches made elsewhere needs it set first."""
        lm = hasattr(self.model, "layers")
        self.kv = kv_split(self.model.cfg, self.mesh, s_cache) if lm else None
        self.dims = tuple(dims)

    def _scope(self):
        """The partition, and the batch split (a MoE layer's capacity and
        arrival order are the whole batch's), of a call."""
        import contextlib

        stack = contextlib.ExitStack()
        stack.enter_context(SH.partitioned(SH.Partition(self.mesh, self.where, self.dims,
                                                        kv=self.kv)))
        stack.enter_context(SH.batch_split(SH.BatchSplit(self.mesh, self.dims) if self.dims else None))
        return stack

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], s_cache: Optional[int] = None):
        """``model.prefill`` of this rank's slice of ``batch`` (whole
        tensors every rank holds): (its last logits, its caches)."""
        return self.prefill_slice(SH.batch_slices(batch, 1, self.mesh)[0], SH.batch_dims(batch, self.mesh),
                                  s_cache)

    @torch.no_grad()
    def prefill_slice(self, mine: Dict[str, torch.Tensor], dims, s_cache: Optional[int] = None):
        """``prefill`` of this rank's slice ``mine`` of a batch split over
        the mesh dims ``dims`` (``set_slice``; a decoder LM's caches hold
        ``s_cache`` positions, by default the prompt's)."""
        if hasattr(self.model, "layers"):
            s_cache = s_cache or mine["tokens"].shape[1]
        self.set_slice(dims, s_cache)
        with self._scope():
            return self.model.prefill(mine, s_cache=s_cache)

    @torch.no_grad()
    def decode_step(self, caches: Dict, tokens: torch.Tensor):
        """``model.decode_step`` of this rank's slice: ``tokens`` and
        ``caches`` are the slice's (``prefill``'s, or made for the slice
        ``set_slice`` set)."""
        with self._scope():
            return self.model.decode_step(caches, tokens)

    def gather_batch(self, t: torch.Tensor) -> torch.Tensor:
        """The whole batch of a per-slice tensor (batch-major), on every
        rank: all-gathers over the dims that split the batch."""
        for i in reversed(self.dims):
            t = SH._all_gather_dim([t], [0], self.mesh, i)[0]
        return t

    def generate(self, prompt: torch.Tensor, *, steps: int, s_cache: Optional[int] = None,
                 return_logits: bool = False):
        """Greedy ``serve.generate`` on the mesh: (B, steps) tokens of the
        whole ``prompt`` on every rank (and the f32 logits (B, steps, V))."""
        from .decode import sample

        s_cache = s_cache or (prompt.shape[1] + steps + 1)
        logits, caches = self.prefill({"tokens": prompt}, s_cache)
        toks, lgts = [sample(logits, None, 0.0)], [logits]
        for _ in range(steps - 1):
            logits, caches = self.decode_step(caches, toks[-1])
            lgts.append(logits)
            toks.append(sample(logits, None, 0.0))
        out = self.gather_batch(torch.stack(toks, dim=1))
        if return_logits:
            return out, self.gather_batch(torch.stack(lgts, dim=1))
        return out


__all__ = ["MeshServer", "SERVE_TP_ONLY_BYTES", "kv_split", "serve_tp_only"]
