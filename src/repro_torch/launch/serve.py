"""Serving command line: init a model from a seed, prefill a batch of prompts,
decode N tokens, report tokens/s (counterpart of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \\
        --reduced --device cpu --batch 2 --prompt 16 --steps 8

Without ``--device`` it runs on the CUDA card, and raises without one.
The prompt is drawn with numpy from ``--seed``; for an encoder-decoder
(``--arch whisper-small``) the prompt is ``--prompt`` frames
``(batch, prompt, d_model)`` of normal values in the config's dtype, and
``generate_whisper`` decodes against a self cache of ``steps + 4``
positions.  The weights are random,
from a ``torch.Generator`` seeded with ``--seed``, or with ``--ckpt`` the
parameters of a training checkpoint (``launch/train.py --ckpt``).
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from ..configs import get_config, get_model, reduced_config
from ..relational.spmd import resolve_device
from ..serve import generate, generate_whisper
from ..train import checkpoint as ckpt


def main(argv: Optional[List[str]] = None) -> torch.Tensor:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cpu | cuda (default: the CUDA card)")
    ap.add_argument("--ckpt", default=None,
                    help="restore params from a training checkpoint dir (its latest step)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    model = get_model(cfg, dev, generator=gen)
    if args.ckpt:
        # only the parameters of a training checkpoint (it also holds the
        # optimizer state); a reference checkpoint goes through
        # interop.checkpoint_from_reference first
        params = {k: p.detach() for k, p in model.named_parameters()}
        restored, _ = ckpt.restore(args.ckpt, {"params": params}, partial=True)
        model.load_state_dict(restored["params"])
    rng = np.random.default_rng(args.seed)
    stats: dict = {}
    if cfg.encdec:
        frames = rng.standard_normal((args.batch, args.prompt, cfg.d_model), dtype=np.float32)
        toks = generate_whisper(
            model, torch.from_numpy(frames).to(dev, cfg.torch_dtype), steps=args.steps,
            dec_cache=args.steps + 4, temperature=args.temperature, generator=gen, stats=stats,
        )
    else:
        prompt = rng.integers(0, cfg.vocab, (args.batch, args.prompt))
        toks = generate(
            model, torch.from_numpy(prompt).to(dev), steps=args.steps,
            temperature=args.temperature, generator=gen, stats=stats,
        )
    n = args.batch * args.steps
    total = stats["prefill_s"] + stats["decode_s"]
    decode_ms = 1e3 * stats["decode_s"] / max(1, args.steps - 1)
    print(
        f"arch={cfg.name} device={dev} backend={'cuda' if model.use_cuda else 'torch'} "
        f"generated {n} tokens in {total:.3f}s ({n / total:.1f} tok/s): "
        f"prefill {args.batch}x{args.prompt} in {stats['prefill_s']:.3f}s, "
        f"decode {decode_ms:.2f} ms/step for {args.batch} sequences"
    )
    for row in toks.tolist():
        print(" ", row)
    return toks


if __name__ == "__main__":
    main()
