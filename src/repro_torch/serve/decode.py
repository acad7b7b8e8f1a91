"""Batched serving loop: prefill + greedy/temperature decode over the
model-agnostic cache interface (KV caches for attention archs, recurrent
state for SSM/xLSTM, cross-KV for whisper), the counterpart of
``repro/serve/decode.py``."""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch


def sample(
    logits: torch.Tensor, generator: Optional[torch.Generator], temperature: float
) -> torch.Tensor:
    """Greedy (``temperature <= 0``: argmax, the first maximum as in JAX)
    or a categorical draw from ``logits / temperature`` with ``generator``
    (which will not give JAX's bits)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run(model, prefill: Callable, steps: int, temperature: float,
         generator: Optional[torch.Generator], return_logits: bool,
         stats: Optional[Dict[str, float]]):
    """``prefill()`` then ``steps - 1`` decode steps, sampling each token
    from the last logits (see ``generate``)."""
    dev = model.device
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill()
    toks = [sample(logits, generator, temperature)]
    lgts = [logits]
    _sync(dev)
    t1 = time.perf_counter()
    for _ in range(steps - 1):
        logits, caches = model.decode_step(caches, toks[-1])
        lgts.append(logits)
        toks.append(sample(logits, generator, temperature))
    out = torch.stack(toks, dim=1)
    _sync(dev)
    if stats is not None:
        stats["prefill_s"] = t1 - t0
        stats["decode_s"] = time.perf_counter() - t1
    if return_logits:
        return out, torch.stack(lgts, dim=1)
    return out


def generate(
    model,
    prompt: torch.Tensor,  # (B, S) integer token ids
    *,
    steps: int,
    s_cache: Optional[int] = None,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    pos: Optional[torch.Tensor] = None,
    return_logits: bool = False,
    stats: Optional[Dict[str, float]] = None,
):
    """Returns (B, steps) generated tokens (greedy if temperature=0): one
    from the prefill's logits, then ``steps - 1`` decode steps.

    ``return_logits``: also return the per-step f32 logits (B, steps, V).
    ``stats``: when given, receives ``prefill_s`` and ``decode_s``, host
    seconds each ending in a device synchronize."""
    b, s = prompt.shape
    s_cache = s_cache or (s + steps + 1)
    batch = {"tokens": prompt}
    if pos is not None:
        batch["pos"] = pos
    return _run(model, lambda: model.prefill(batch, s_cache=s_cache), steps, temperature,
                generator, return_logits, stats)


def generate_whisper(
    model,
    frames: torch.Tensor,  # (B, S_frames, d_model) in the model's dtype
    *,
    steps: int,
    dec_cache: int = 64,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    return_logits: bool = False,
    stats: Optional[Dict[str, float]] = None,
):
    """Returns (B, steps) tokens a ``WhisperModel`` generates from
    ``frames``: one from the prefill's BOS step, then ``steps - 1`` decode
    steps against a self cache of ``dec_cache`` positions (at least
    ``steps``: a full cache raises).  ``return_logits`` and ``stats`` as
    in ``generate``."""
    return _run(model, lambda: model.prefill({"frames": frames}, s_cache=dec_cache), steps,
                temperature, generator, return_logits, stats)
