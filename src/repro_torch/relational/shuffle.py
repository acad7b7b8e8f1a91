"""The MapReduce shuffle: thin join-facing veneer over ``routed``.

``exchange``: hash-partitioned repartitioning (map stage: bucket rows by
destination; network: one all_to_all; reduce stage: compact).
``exchange_multi``: each row goes to ``g`` destinations (the broadcast
cross join).  ``exchange_counts`` is the count-only pre-pass behind the
engine's occupancy-adaptive shuffle.  Every function takes the reducer
axis first, then any instance axes of a fused op group.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .routed import (  # noqa: F401  (re-exported: the join data plane's names)
    bucket_counts,
    padded_slots,
    pow2,
    route_counts,
    routed_all_to_all,
)


def exchange_counts(dest: torch.Tensor, p: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Count-only pre-pass of an exchange: ``(out_counts, recv_total)``."""
    return route_counts(dest, p)


def exchange(data, valid, dest, *, p: int, c_out: int, cap_recv: int):
    """Repartition rows to ``dest`` shards.

    Returns (rdata (p, *K, cap_recv, ar), rvalid, sent, dropped_send,
    dropped_recv)."""
    r = routed_all_to_all(data, valid, dest, p=p, c_out=c_out, cap_recv=cap_recv)
    return r.data, r.valid, r.sent, r.dropped_send, r.dropped_recv


def exchange_multi(data, valid, dests, *, p: int, c_out: int, cap_recv: int):
    """Replicated send: each row goes to up to g destinations
    (``dests`` (p, *K, n, g); in-row duplicates go to the skip slot)."""
    r = routed_all_to_all(data, valid, dests, p=p, c_out=c_out, cap_recv=cap_recv)
    return r.data, r.valid, r.sent, r.dropped_send, r.dropped_recv
