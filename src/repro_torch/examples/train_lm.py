"""Train a ~100M-parameter dense LM for a few hundred steps on batches
assembled by the GYM relational pipeline (the port of
``examples/train_lm.py``).

Full run:
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
Quick check:
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 20 --tiny [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import List, Optional

import torch

from ..configs import CONFIGS, get_model
from ..data import CorpusConfig, batches
from ..relational.spmd import resolve_device
from ..train import OptConfig, TrainConfig, init_train_state, make_train_step
from ..train import checkpoint as ckpt
from ..train.step import state_tree


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default=None, help="cpu | cuda (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ~100M-param smollm-family config (12 x 768, 49k vocab ~ 97M params)
    base = CONFIGS["smollm-360m"]
    if args.tiny:
        cfg = dataclasses.replace(
            base, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
            d_ff=256, vocab=1024, pattern=(), dtype="float32",
        )
        batch, seq = 4, 64
    else:
        cfg = dataclasses.replace(
            base, n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
            d_ff=2048, vocab=49152, pattern=(), dtype="float32",
        )
        batch, seq = 8, 256

    model = get_model(cfg, dev, generator=torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name}-variant params={n_params / 1e6:.1f}M device={dev}")

    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, warmup=20, decay_steps=args.steps))
    opt = init_train_state(model, tcfg)
    step_fn = make_train_step(model, tcfg)

    data = batches(CorpusConfig(seed=23), batch=batch, seq=seq, vocab=cfg.vocab, device=dev)
    t0 = time.time()
    for step in range(args.steps):
        b = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
        m = step_fn(opt, b)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {float(m['loss']):.4f} ({time.time() - t0:.0f}s)",
                  flush=True)
        if (step + 1) % 100 == 0:
            ckpt.save(args.ckpt, step + 1, state_tree(model, opt))
            print(f"  checkpoint @ {step + 1}")
    print("done")


if __name__ == "__main__":
    main()
