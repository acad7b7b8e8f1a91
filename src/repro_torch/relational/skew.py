"""Heavy-hitter detection and hybrid (hash + grid) exchange routing.

The hash exchange is communication-optimal but skew-sensitive: every row
of a join key lands on ``hash(key) % p``, so one heavy key concentrates
its whole load on a single reducer.  The grid exchange is skew-proof but
pays Lemma 8's B(X, M) replication on every row.  The heavy/light
decomposition sits between them (Joglekar & Ré; Hu & Yi):

- **light keys** keep the hash routing — comm ~ inputs;
- **heavy keys** (detected host-side from the count pre-pass, which
  already ships per-destination load statistics) switch to grid-style
  routing: one side is spread round-robin over all p reducers, the other
  is broadcast to every reducer — Lemma 8 with g = (p, 1), restricted to
  the heavy keys.

Because the hash is key-consistent across both operands (same seed, same
shared attributes), a destination-level decision is a key-level
decision: key k is heavy iff destination ``hash(k) % p`` is flagged, and
both sides agree.  The (p,)-bool flag vector rides into the payload as
data, so an all-light pattern routes exactly as the plain hash exchange.

The routing functions work over the port's explicit axes: ``dest`` is
``(p, *K, n)`` (reducer axis first, then any instance axes) and ``heavy``
``(p, *K, p)``, one flag vector per shard and instance (on a mesh the
rank's block, leading axis 1).  The detection functions read count
matrices the host gathered over the whole reducer axis.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .spmd import axis_index

#: Default heavy-hitter sensitivity: a destination is heavy when its
#: arrival exceeds this multiple of the perfectly balanced share
#: ceil(total / p).  3x is far above the multinomial max/mean noise of
#: uniform data at the p's this repo runs (<= 1.5x), and well below the
#: p * share amplification of a planted heavy key.
DEFAULT_SKEW_THRESHOLD = 3.0

#: Destinations with fewer arrivals than this are never heavy — a tiny
#: table cannot blow a capacity, and pow2 capacities floor at 4 anyway.
MIN_HEAVY_ARRIVAL = 8


# --------------------------------------------------------------- detection
def heavy_dest_flags(
    out_counts: np.ndarray, p: int, threshold: float = DEFAULT_SKEW_THRESHOLD
) -> np.ndarray:
    """Heavy-destination flags of ONE exchange side from its count
    pre-pass: ``out_counts`` is the (shards, p) per-shard send-count
    matrix (``shuffle.bucket_counts`` per shard), so column d sums to the
    total arrival at reducer d.  Returns a (p,) bool vector.

    The threshold is tied to the balanced per-reducer share (which is
    what the capacity manager's M-derived capacities assume): destination
    d is heavy iff ``arrival(d) > max(MIN_HEAVY_ARRIVAL,
    threshold * ceil(total / p))``."""
    counts = np.asarray(out_counts).reshape(-1, p)
    arrivals = counts.sum(axis=0)
    total = int(arrivals.sum())
    balanced = -(-total // p) if total else 0
    cut = max(float(MIN_HEAVY_ARRIVAL), threshold * balanced)
    return arrivals > cut


def heavy_dest_flags_many(
    out_counts: np.ndarray, p: int, threshold: float = DEFAULT_SKEW_THRESHOLD
) -> np.ndarray:
    """Batched ``heavy_dest_flags``: (shards, k, p) send counts of a
    k-instance op group -> (k, p) bool flags, each instance thresholded
    against its own balanced share."""
    counts = np.asarray(out_counts).reshape(out_counts.shape[0], -1, p)
    arrivals = counts.sum(axis=0)  # (k, p)
    totals = arrivals.sum(axis=1, keepdims=True)
    balanced = -(-totals // p)
    cut = np.maximum(float(MIN_HEAVY_ARRIVAL), threshold * balanced)
    return arrivals > cut


# ----------------------------------------------------------------- routing
def _is_heavy(dest: torch.Tensor, heavy: torch.Tensor, p: int) -> torch.Tensor:
    """Per-row heavy mask: ``heavy[dest]`` with dead rows (dest == p)
    always light."""
    pad = torch.zeros(tuple(heavy.shape[:-1]) + (1,), dtype=torch.bool, device=heavy.device)
    padded = torch.cat([heavy.to(torch.bool), pad], dim=-1)
    return torch.gather(padded, -1, dest.clamp(0, p).to(torch.int64))


def split_dests(
    dest: torch.Tensor, heavy: torch.Tensor, p: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Position-partitioned routing of the spread side: light rows keep
    their hash destination; heavy rows are dealt round-robin over all p
    reducers, offset by the shard index so shards don't synchronize on
    reducer 0.  Each row still goes to exactly ONE destination.

    ``dest``: (p, *K, n) int32 in [0, p] (p = dead).  The round-robin
    position is a per-shard, per-instance ``cumsum`` over the row axis.
    Returns (dest', is_heavy)."""
    is_heavy = _is_heavy(dest, heavy, p)
    shard = axis_index(p, dest)
    hidx = torch.cumsum(is_heavy.to(torch.int32), dim=-1).to(torch.int32) - 1
    spread = ((hidx + shard) % p).to(torch.int32)
    return torch.where(is_heavy, spread, dest.to(torch.int32)), is_heavy


def bcast_dests(
    dest: torch.Tensor, heavy: torch.Tensor, p: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Broadcast routing of the replicated side: light rows go to their
    hash destination only (slot 0; slots 1..p-1 are the dead ``p``);
    heavy rows go to every reducer — wherever the spread side scattered
    their join partners.  No shard offset: the broadcast side is the same
    on every shard.  Returns (dests (p, *K, n, p), is_heavy)."""
    is_heavy = _is_heavy(dest, heavy, p)
    cols = torch.arange(p, dtype=torch.int32, device=dest.device)
    light = torch.where(cols == 0, dest.to(torch.int32).unsqueeze(-1), p)
    dests = torch.where(is_heavy.unsqueeze(-1), cols, light).to(torch.int32)
    return dests, is_heavy
