"""Training command line: the GYM-assembled data pipeline -> the train
step -> a checkpoint/resume loop with the straggler watchdog (counterpart
of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --reduced --device cpu --steps 5 --batch 4 --seq 32 --ckpt /tmp/run1

Without ``--device`` it runs on the CUDA card, and raises without one; the
corpus join runs there too.  One device: the reference's mesh and
shardings are not part of the port.  The weights are random, from a
``torch.Generator`` seeded with 0 (the reference's ``PRNGKey(0)``).  Each
step prints ``step``, ``loss``, ``gnorm`` and its milliseconds (flagged
``STRAGGLER`` past 3x the running median), then ``[done]``.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from ..configs import get_config, get_model, reduced_config
from ..data import CorpusConfig, batches
from ..relational.spmd import resolve_device
from ..train import OptConfig, TrainConfig, init_train_state, make_train_step
from ..train import checkpoint as ckpt
from ..train.elastic import HeartbeatMonitor
from ..train.step import load_state_tree, state_tree


def main(argv: Optional[List[str]] = None) -> Dict:
    """Returns ``{"start", "losses", "grad_norms", "step_s", "model",
    "opt_state"}`` for callers that drive it in-process."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt_every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress_grads", action="store_true")
    ap.add_argument("--device", default=None, help="cpu | cuda (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = get_model(cfg, dev, generator=gen)
    tcfg = TrainConfig(
        opt=OptConfig(lr=args.lr, warmup=10, decay_steps=max(100, args.steps)),
        accum=args.accum,
        compress_grads=args.compress_grads,
    )
    opt_state = init_train_state(model, tcfg)

    start = 0
    if args.resume and args.ckpt and ckpt.latest_step(args.ckpt) is not None:
        restored, extra = ckpt.restore(args.ckpt, state_tree(model, opt_state))
        load_state_tree(model, opt_state, restored)
        start = int(extra.get("next_step", 0))
        print(f"[resume] from step {start}")

    step_fn = make_train_step(model, tcfg)
    data = batches(
        CorpusConfig(seed=17), batch=args.batch, seq=args.seq, vocab=cfg.vocab, device=dev
    )
    hb = HeartbeatMonitor()
    out: Dict = {"start": start, "losses": [], "grad_norms": [], "step_s": []}
    pending = None
    for step in range(start, args.steps):
        hb.start()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
        m = step_fn(opt_state, batch)
        loss = float(m["loss"])
        dt, straggling = hb.stop()
        gnorm = float(m["grad_norm"])
        print(
            f"step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
            f"{dt*1e3:.0f}ms{' STRAGGLER' if straggling else ''}",
            flush=True,
        )
        out["losses"].append(loss)
        out["grad_norms"].append(gnorm)
        out["step_s"].append(dt)
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = ckpt.save_async(
                args.ckpt, step + 1, state_tree(model, opt_state),
                extra={"next_step": step + 1},
            )
    if pending is not None:
        pending.join()
    if args.ckpt:
        ckpt.save(
            args.ckpt, args.steps, state_tree(model, opt_state),
            extra={"next_step": args.steps},
        )
    print("[done]")
    out.update(model=model, opt_state=opt_state)
    return out


if __name__ == "__main__":
    main()
