"""MoE token dispatch on the join engines' routed exchange: calibrate
per-expert capacities from measured counts, spread hot experts via the
heavy split, and compare against the dense Switch-style scatter, which
silently drops over-capacity tokens the calibrated route keeps (the port
of ``examples/moe_routing.py``).

    PYTHONPATH=src python -m repro_torch.examples.moe_routing [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..configs import CONFIGS, reduced_config
from ..models.common import rms_norm
from ..models.mlp import init_moe, moe_forward_stats
from ..models.moe_routing import apply_plan, calibrate_moe, record_dense_round, record_moe_round
from ..relational.ledger import Ledger
from ..relational.spmd import resolve_device


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu | cuda (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)

    # --- 1. a small MoE layer and a skewed batch ------------------------
    # tokens cluster around per-expert prototypes, so one expert runs hot:
    # the heavy-hitter shape the paper's skew machinery (Lemma 8) handles
    cfg = reduced_config(CONFIGS["kimi-k2-1t-a32b"])  # 4 experts, top-2, f32
    p = init_moe(torch.Generator(device=dev).manual_seed(0), cfg)
    rng = np.random.default_rng(7)
    protos = rng.standard_normal((cfg.n_experts, cfg.d_model)).astype(np.float32)
    pick = rng.choice(cfg.n_experts, size=256, p=[0.85, 0.07, 0.05, 0.03])
    x = torch.from_numpy(
        (protos[pick] * 2.0 + 0.05 * rng.standard_normal((256, cfg.d_model)))
        .reshape(4, 64, cfg.d_model).astype(np.float32)
    ).to(dev)

    with torch.no_grad():
        # --- 2. dense Switch-style scatter: drops are silent -------------
        y_dense, dense_stats = moe_forward_stats(p, x, cfg)
        print(f"[dense]      routed={int(dense_stats['routed'])} "
              f"dropped={int(dense_stats['dropped'])}  (lost to capacity 1.25)")

        # --- 3. calibrate: measure counts, flag hot experts, tight caps --
        xf = rms_norm(x, p["ln"], cfg.norm_eps).reshape(-1, cfg.d_model)
        plan, info = calibrate_moe(p, xf, cfg, threshold=1.5)
        print(f"[calibrate]  arrivals={[int(a) for a in info['arrivals']]} "
              f"heavy={list(plan.heavy)} cap_send={plan.cap_send} cap_recv={plan.cap_recv}")

        # --- 4. the calibrated route: same math, zero drops ---------------
        y_calib, calib_stats = moe_forward_stats(p, x, apply_plan(cfg, plan))
        print(f"[calibrated] routed={int(calib_stats['routed'])} "
              f"dropped={int(calib_stats['dropped'])} heavy_routed={int(calib_stats['heavy'])}")
        assert int(calib_stats["dropped"]) == 0  # measured caps: provably no drop
        assert int(dense_stats["dropped"]) > 0   # the dense route did lose tokens

        # parity holds wherever the dense route kept the token (checked on
        # a no-drop config: capacity factor e makes the dense scatter lossless)
        ucfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
        yd, _ = moe_forward_stats(p, x, ucfg)
        uplan, _ = calibrate_moe(p, xf, ucfg)
        yc, _ = moe_forward_stats(p, x, apply_plan(ucfg, uplan))
        np.testing.assert_allclose(yd.cpu().numpy(), yc.cpu().numpy(), atol=2e-5, rtol=2e-5)

    # --- 5. both routes in one byte-true cost ledger --------------------
    led = Ledger()
    record_dense_round(led, {k: int(v) for k, v in dense_stats.items()},
                       cfg=cfg, t=256, d=cfg.d_model, note="zipf-hot dense")
    record_moe_round(led, {k: int(v) for k, v in calib_stats.items()},
                     plan=plan, d=cfg.d_model, note="zipf-hot calibrated")
    print(f"\n{led}")
    s = led.summary()
    print(f"[ledger] dropped_tuples={s['dropped_tuples']} heavy_dests={s['heavy_dests']} "
          f"payload={s['payload_bytes']}B useful={s['useful_bytes']}B")


if __name__ == "__main__":
    main()
