"""MoE expert dispatch as the second customer of the routed exchange
(counterpart of ``repro/models/moe_routing.py``).

Expert dispatch is a skewed hash exchange: tokens are tuples, experts
are destinations, hot experts are heavy hitters, and capacity factors
are the join engines' measured capacities.  This module routes
(token, choice) pairs through the same ``relational.routed`` primitive
the hash, grid and hybrid joins run on:

- **count pre-pass**: ``calibrate_moe`` runs the router once on a
  calibration batch and ships per-expert bucket counts through
  ``route_counts`` (the join engines' measure pre-pass), picking tight
  pow2 send/receive capacities instead of a guessed ``capacity_factor``;
- **heavy split**: experts whose measured arrival exceeds the balanced
  share (``RoutePolicy.heavy_flags``) have their pairs spread round-robin
  over all expert shards (``split_dests``), and every shard applies the
  hot expert's weights to its slice;
- **explicit drops**: the dense scatter of ``mlp.moe_forward`` drops
  over-capacity pairs into the residual; the routed path reports the
  exact dropped-pair count, and a plan whose capacities come from the
  measure drops nothing.

The reference maps a per-shard body over ``e`` shards with ``jax.vmap``;
here the body runs over an explicit leading ``(e,)`` shard axis, as
every operator of the port does.  The plan (``MoEPlan``) is frozen and
hashable and rides inside ``ArchConfig`` (``cfg.moe_plan``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..relational.ledger import Ledger
from ..relational.routed import (
    RoutePolicy, _bucketize, padded_slots, pow2, route_counts, routed_all_to_all,
)
from ..relational.skew import DEFAULT_SKEW_THRESHOLD, split_dests
from ..relational.wire import count_wire_bytes, dense_wire_bytes
from .common import ArchConfig

#: payload columns appended to the d activation features of each
#: (token, choice) pair: [gate weight, token id, expert id].  Float32
#: carries the integer ids exactly while they stay below 2**24, so one
#: homogeneous buffer rides the exchange.
PAIR_EXTRA = 3


# ----------------------------------------------------------------- router
def router_pairs(
    p, xf: torch.Tensor, cfg: ArchConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing decisions shared by both dispatch routes: returns
    ``(flat_e, flat_w, flat_tok)``, each ``(t*k,)``, token-major.

    Equal gates go to the lower expert index first, as ``jax.lax.top_k``
    orders them (a stable descending sort; ``torch.topk`` promises no
    order among ties)."""
    t = xf.shape[0]
    k = cfg.topk
    logits = xf.float() @ p["router"].float()  # (t, e)
    gates = torch.softmax(logits, dim=-1)
    topw, tope = torch.sort(gates, dim=-1, descending=True, stable=True)
    topw, tope = topw[:, :k], tope[:, :k]
    topw = topw / (topw.sum(-1, keepdim=True) + 1e-9)
    flat_tok = torch.arange(t, device=xf.device).repeat_interleave(k)
    return tope.reshape(-1), topw.reshape(-1), flat_tok


# ------------------------------------------------------------------- plan
@dataclasses.dataclass(frozen=True)
class MoEPlan:
    """Static routing plan of one calibrated MoE dispatch.

    Frozen and tuple-valued, so it is hashable, and pow2-bucketed.
    ``e`` expert shards each own ``tpp`` tokens' (token, choice) pairs;
    ``heavy`` lists the experts the count pre-pass flagged hot (their
    pairs spread round-robin over all shards)."""

    e: int                      # experts == route shards
    k: int                      # choices per token
    tpp: int                    # tokens per shard (pairs per shard = tpp*k)
    cap_send: int               # dispatch per-destination bucket capacity
    cap_recv: int               # per-expert receive capacity
    heavy: Tuple[int, ...] = ()  # statically known hot experts

    @property
    def ret_cap_send(self) -> int:
        """Combine-exchange send buckets: a shard returns at most what it
        received, and at most one home shard's worth of pairs."""
        return pow2(min(self.cap_recv, self.tpp * self.k))

    @property
    def ret_cap_recv(self) -> int:
        """Combine-exchange receive capacity: a home shard gets back at
        most its own ``tpp*k`` pairs, so the return trip never drops
        when the dispatch did not."""
        return pow2(self.tpp * self.k)

    @staticmethod
    def sound(t: int, k: int, e: int) -> "MoEPlan":
        """Worst-case-sound plan (no measure): capacities cover every
        pair landing on one expert, so drops are impossible."""
        tpp = -(-t // e)
        return MoEPlan(e=e, k=k, tpp=tpp, cap_send=pow2(tpp * k), cap_recv=pow2(t * k))


def apply_plan(cfg: ArchConfig, plan: MoEPlan) -> ArchConfig:
    """Config with the calibrated route and ``plan`` installed."""
    return dataclasses.replace(cfg, moe_route="calibrated", moe_plan=plan)


def _heavy_vec(plan: MoEPlan, device) -> torch.Tensor:
    """``(e, e)`` heavy flags: every shard's copy of the plan's vector."""
    flags = torch.zeros((plan.e,), dtype=torch.bool, device=device)
    flags[list(plan.heavy)] = True
    return flags.expand(plan.e, plan.e)


def _shard_pairs(plan: MoEPlan, t: int, flat_e: torch.Tensor, payload_cols: torch.Tensor):
    """Pad the token-major pair arrays to ``e * tpp * k`` and fold in the
    shard axis: shard s owns tokens ``[s*tpp, (s+1)*tpp)``, so all k
    pairs of a token live on one shard and the combine is shard-local.
    Returns ``(payload (e, tpp*k, ar), valid (e, tpp*k), dest (e, tpp*k))``."""
    e, k, tpp = plan.e, plan.k, plan.tpp
    if t > e * tpp:
        raise ValueError(f"plan sized for {e * tpp} tokens, got {t}")
    pad = e * tpp * k - t * k
    valid = F.pad(torch.ones((t * k,), dtype=torch.bool, device=flat_e.device), (0, pad))
    dest = F.pad(flat_e.to(torch.int32), (0, pad))
    payload = F.pad(payload_cols, (0, 0, 0, pad))
    npairs = tpp * k
    return (
        payload.reshape(e, npairs, payload.shape[1]),
        valid.reshape(e, npairs),
        dest.reshape(e, npairs),
    )


# ------------------------------------------------------------ calibration
@torch.no_grad()
def calibrate_moe(
    p_moe,
    xf: torch.Tensor,
    cfg: ArchConfig,
    *,
    threshold: Optional[float] = None,
    cap_recv_ceiling: Optional[int] = None,
) -> Tuple[MoEPlan, Dict]:
    """Measure a calibration batch and build a tight ``MoEPlan``.

    Runs the router once (host-visible), flags heavy experts from the
    per-expert arrivals, then ships the actual per-shard send counts
    through ``route_counts`` (the join engines' count pre-pass), so
    ``cap_send``/``cap_recv`` are the measured maxima after heavy
    spreading, pow2-bucketed.

    ``cap_recv_ceiling`` clips the receive capacity (a memory bound); the
    dispatch then reports its exact overflow.  Returns (plan, measure
    info: ``arrivals``, ``heavy``, ``out_counts``)."""
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.topk
    policy = RoutePolicy(
        skew_threshold=DEFAULT_SKEW_THRESHOLD if threshold is None else threshold
    )
    flat_e, _, _ = router_pairs(p_moe, xf, cfg)
    arrivals = np.bincount(flat_e.cpu().numpy(), minlength=e)
    flags = policy.heavy_flags(arrivals.reshape(1, e), e)
    heavy = tuple(int(i) for i in np.nonzero(flags)[0])
    tpp = -(-t // e)
    probe = MoEPlan(e=e, k=k, tpp=tpp, cap_send=1, cap_recv=1, heavy=heavy)
    _, valid, dest = _shard_pairs(
        probe, t, flat_e, torch.zeros((t * k, 1), dtype=torch.float32, device=xf.device)
    )
    d2, _ = split_dests(torch.where(valid, dest, e), _heavy_vec(probe, xf.device), e)
    out_counts, recv_tot = route_counts(d2, e)
    cap_send = pow2(int(out_counts.max()))
    cap_recv = pow2(int(recv_tot.max()))
    if cap_recv_ceiling is not None:
        cap_recv = min(cap_recv, int(cap_recv_ceiling))
    plan = MoEPlan(e=e, k=k, tpp=tpp, cap_send=cap_send, cap_recv=cap_recv, heavy=heavy)
    return plan, {"arrivals": arrivals, "heavy": heavy, "out_counts": out_counts.cpu().numpy()}


# --------------------------------------------------------------- dispatch
def _ffn(rx: torch.Tensor, w_g: torch.Tensor, w_i: torch.Tensor, w_o: torch.Tensor) -> torch.Tensor:
    g = F.silu((rx @ w_g).float()).to(rx.dtype)
    return (g * (rx @ w_i)) @ w_o


def calibrated_dispatch(p, xf: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    """Route (token, choice) pairs to expert shards via
    ``routed_all_to_all``, apply the expert FFNs, and route the weighted
    outputs back: two exchanges, like the production MoE all-to-all pair.

    Light pairs land on their expert's home shard and run that shard's
    expert; pairs of each statically known heavy expert are spread
    round-robin (``heavy=``) and every shard applies that expert's
    weights to its slice.  The combine exchange returns pairs to the
    token's home shard, whose capacities are exact.  The FFN runs shard
    by shard (each shard's whole receive buffer, masked, as in the
    reference), so its transient is one shard's.

    Returns (combined ``(t, d)`` expert mix in ``xf``'s dtype, stats) with
    stats = ``{routed, dropped, heavy}`` int32 scalars; ``dropped`` is the
    exact pair loss across both exchanges."""
    plan: MoEPlan = cfg.moe_plan
    if plan is None:
        raise ValueError("moe_route='calibrated' needs cfg.moe_plan")
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.topk
    if (plan.e, plan.k) != (e, k):
        raise ValueError(f"plan for e={plan.e}, k={plan.k}; config has e={e}, k={k}")
    if t * k >= 2**24:
        raise ValueError(f"t*k = {t * k} pairs: f32 payload ids must stay below 2**24")
    tpp = plan.tpp
    dev = xf.device

    flat_e, flat_w, flat_tok = router_pairs(p, xf, cfg)
    payload = torch.cat(
        [
            xf[flat_tok].float(),
            flat_w[:, None].float(),
            flat_tok[:, None].float(),
            flat_e[:, None].float(),
        ],
        dim=1,
    )  # (t*k, d + PAIR_EXTRA)
    s_payload, s_valid, s_dest = _shard_pairs(plan, t, flat_e, payload)
    wg, wi, wo = p["wg"], p["wi"], p["wo"]

    r = routed_all_to_all(
        s_payload, s_valid, s_dest, p=e, c_out=plan.cap_send, cap_recv=plan.cap_recv,
        heavy=_heavy_vec(plan, dev),
    )
    rx = r.data[..., :d].to(wg.dtype)  # (e, cap_recv, d)
    rw = r.data[..., d]
    rtok = r.data[..., d + 1].to(torch.int64)
    rexp = r.data[..., d + 2].to(torch.int64)
    own = torch.arange(e, device=dev)[:, None]
    own_mask = r.valid & (rexp == own)
    for h in plan.heavy:  # heavy experts are handled below, everywhere
        own_mask = own_mask & (rexp != h)
    ys = []
    for s in range(e):
        y = _ffn(rx[s], wg[s], wi[s], wo[s]) * own_mask[s, :, None].to(wg.dtype)
        for h in plan.heavy:  # hot experts run on every shard
            mh = r.valid[s] & (rexp[s] == h)
            y = y + _ffn(rx[s], wg[h], wi[h], wo[h]) * mh[:, None].to(wg.dtype)
        ys.append(y)
    yw = torch.stack(ys).float() * rw[..., None]
    back = torch.cat([yw, rtok.float()[..., None]], dim=-1)
    home = torch.clamp(torch.div(rtok, tpp, rounding_mode="floor"), 0, e - 1)
    r2 = routed_all_to_all(
        back, r.valid, home, p=e, c_out=plan.ret_cap_send, cap_recv=plan.ret_cap_recv,
    )
    # the combine, shard-local: each returned pair takes the slot of its
    # arrival rank among its token's pairs, then the k slots are summed in
    # that order (a fixed order on any device)
    btok = r2.data[..., d].to(torch.int64) - own * tpp
    slot = torch.where(r2.valid, btok, tpp).to(torch.int32)
    buf, _, _, _ = _bucketize(r2.data[..., :d], slot, tpp, k)  # (e, tpp, k, d)
    y_blk = torch.zeros((e, tpp, d), dtype=torch.float32, device=dev)
    for c in range(k):
        y_blk = y_blk + buf[:, :, c]
    dropped = r.dropped_send + r.dropped_recv + r2.dropped_send + r2.dropped_recv
    combined = y_blk.reshape(e * tpp, d)[:t].to(xf.dtype)
    stats = {
        "routed": r.sent.sum().to(torch.int32),
        "dropped": dropped.sum().to(torch.int32),
        "heavy": r.heavy_sent.sum().to(torch.int32),
    }
    return combined, stats


# -------------------------------------------------------------- accounting
def calibrated_dispatch_bytes(plan: MoEPlan, d: int) -> Tuple[int, int]:
    """(payload_bytes, padded_slots) the calibrated route's two exchanges
    ship fleet-wide: dense float32 cells and the valid plane, priced by
    the join ledger's ``wire.dense_wire_bytes``."""
    ar_out, ar_back = d + PAIR_EXTRA, d + 1
    pb = dense_wire_bytes(plan.e, plan.cap_send, ar_out) + dense_wire_bytes(
        plan.e, plan.ret_cap_send, ar_back
    )
    pad = padded_slots(plan.e, plan.cap_send, ar_out) + padded_slots(
        plan.e, plan.ret_cap_send, ar_back
    )
    return pb, pad


def dense_capacity(cfg: ArchConfig, t: int) -> int:
    """Slots an expert of the dense scatter holds for ``t`` tokens:
    ``capacity_factor`` times the mean load ``t*k/e``, at least one."""
    return max(1, int(cfg.capacity_factor * t * cfg.topk / cfg.n_experts))


def dense_scatter_bytes(cfg: ArchConfig, t: int, d: int) -> Tuple[int, int]:
    """(payload_bytes, padded_slots) of the dense scatter's dispatch
    buffer: the ``(e*cap+1, d)`` slots every step materializes whether
    occupied or not."""
    e, cap = cfg.n_experts, dense_capacity(cfg, t)
    return 4 * (e * cap + 1) * d, (e * cap + 1) * d


def record_moe_round(
    ledger: Ledger,
    stats: Dict,
    *,
    plan: MoEPlan,
    d: int,
    note: str = "",
    measured: bool = True,
) -> None:
    """One calibrated MoE layer's dispatch as a ledger round, in the join
    vocabulary: ``comm`` = pairs routed, ``heavy`` = pair-sends via the
    heavy spread, ``dropped`` = exact capacity losses, byte-true
    payload/useful accounting over both exchanges.  ``measured``: charge
    the calibration count pre-pass (one measure dispatch and its
    ``(e,)``-int count vectors) to this round."""
    routed = int(stats["routed"])
    dropped = int(stats["dropped"])
    pb, pad = calibrated_dispatch_bytes(plan, d)
    measure_pb = count_wire_bytes(plan.e) if measured else 0
    delivered = max(routed - dropped, 0)
    ledger.add_round(
        "moe",
        [f"moe_dispatch[e={plan.e},k={plan.k},cap={plan.cap_recv}]"],
        comm=routed,
        note=note,
        n_rounds=2,  # dispatch + combine exchanges
        dispatches=1,
        measure_dispatches=1 if measured else 0,
        padded=pad + (plan.e * plan.e if measured else 0),
        heavy=int(stats["heavy"]),
        payload_bytes=pb + measure_pb,
        useful_bytes=4 * (routed * (d + PAIR_EXTRA) + delivered * (d + 1)),
        dropped=dropped,
        heavy_dests=len(plan.heavy),
    )


def record_dense_round(
    ledger: Ledger, stats: Dict, *, cfg: ArchConfig, t: int, d: int, note: str = "",
) -> None:
    """The dense scatter route in the same vocabulary, so one ledger
    compares both dispatches: ``dropped`` is its over-capacity loss."""
    routed = int(stats["routed"])
    pb, pad = dense_scatter_bytes(cfg, t, d)
    ledger.add_round(
        "moe",
        [f"moe_dense[e={cfg.n_experts},k={cfg.topk}]"],
        comm=routed,
        note=note,
        n_rounds=1,
        dispatches=1,
        padded=pad,
        payload_bytes=pb,
        useful_bytes=4 * routed * d,
        dropped=int(stats["dropped"]),
    )
