"""Heavy-hitter detection from the count pre-pass (host-side numpy).

The hash exchange is skew-sensitive: every row of a join key lands on
``hash(key) % p``.  The count pre-pass already ships per-destination load
statistics, so heavy destinations are detected from them for free.  The
hash engine uses the flags only for diagnostics (the capacity ceiling's
message) and to keep skewed measures out of the caps cache; the hybrid
engine's spread/broadcast routing is not part of the port yet.
"""
from __future__ import annotations

import numpy as np

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
