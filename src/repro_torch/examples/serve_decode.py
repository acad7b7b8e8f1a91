"""Serving: batched prefill + decode on three cache families, attention
KV (smollm), recurrent state (xlstm) and encoder-decoder cross-KV
(whisper), with the reduced configs (the port of
``examples/serve_decode.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_decode [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from ..configs import CONFIGS, get_model, reduced_config
from ..relational.spmd import resolve_device
from ..serve import generate, generate_whisper

ARCHS = ("smollm-360m", "xlstm-125m", "whisper-small")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu | cuda (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(1)
    for arch in ARCHS:
        cfg = reduced_config(CONFIGS[arch])
        model = get_model(cfg, dev, generator=torch.Generator(device=dev).manual_seed(0))
        if cfg.encdec:
            frames = torch.from_numpy(rng.standard_normal((2, 32, cfg.d_model), dtype=np.float32))
            toks = generate_whisper(model, frames.to(dev, cfg.torch_dtype), steps=8, dec_cache=16)
        else:
            prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12))).to(dev)
            toks = generate(model, prompt, steps=8)
        assert toks.shape == (2, 8)
        assert bool((toks >= 0).all()) and bool((toks < cfg.vocab).all())
        print(f"{arch:14s} generated: {toks.tolist()}")
    print("ok")


if __name__ == "__main__":
    main()
