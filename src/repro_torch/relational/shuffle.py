"""The MapReduce shuffle: thin join-facing veneer over ``routed``.

``exchange``: hash-partitioned repartitioning (map stage: bucket rows by
destination; network: one all_to_all; reduce stage: compact).
``exchange_multi``: each row goes to ``g`` destinations (the broadcast
cross join, grid offsets, heavy broadcast).  ``exchange_counts`` is the
count-only pre-pass behind the engine's occupancy-adaptive shuffle.
Every function takes the reducer axis first, then any instance axes of a
fused op group.

Passing a ``wire.WireFormat`` (``fmt=``) replaces the dense int32 cells +
bool valid pair with ONE bit-packed uint8 buffer per exchange (same rows
out, exact round-trip), encoded and decoded by ``backend``'s codec.
``exchange_start`` / ``exchange_finish`` split an exchange around its
collective so a fused group can concatenate many encoded exchanges into a
single segmented all_to_all (``ship_segments``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .routed import (  # noqa: F401  (re-exported: the join data plane's names)
    bucket_counts,
    padded_slots,
    pow2,
    route_counts,
    routed_all_to_all,
    routed_finish,
    routed_start,
    ship_segments,
)
from .wire import WireFormat


def exchange_counts(dest: torch.Tensor, p: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Count-only pre-pass of an exchange: ``(out_counts, recv_total)``."""
    return route_counts(dest, p)


def exchange(
    data, valid, dest, *, p: int, c_out: int, cap_recv: int,
    fmt: Optional[WireFormat] = None, backend: Optional[str] = None,
):
    """Repartition rows to ``dest`` shards.  ``fmt=None`` ships the dense
    buckets + valid plane; a ``WireFormat`` one bit-packed buffer.  Rows
    out are bit-identical either way.

    Returns (rdata (p, *K, cap_recv, ar), rvalid, sent, dropped_send,
    dropped_recv)."""
    r = routed_all_to_all(
        data, valid, dest, p=p, c_out=c_out, cap_recv=cap_recv, fmt=fmt, backend=backend
    )
    return r.data, r.valid, r.sent, r.dropped_send, r.dropped_recv


def exchange_multi(
    data, valid, dests, *, p: int, c_out: int, cap_recv: int,
    fmt: Optional[WireFormat] = None, backend: Optional[str] = None,
):
    """Replicated send: each row goes to up to g destinations
    (``dests`` (p, *K, n, g); in-row duplicates go to the skip slot)."""
    r = routed_all_to_all(
        data, valid, dests, p=p, c_out=c_out, cap_recv=cap_recv, fmt=fmt, backend=backend
    )
    return r.data, r.valid, r.sent, r.dropped_send, r.dropped_recv


# ------------------------------------------- segmented (fused-group) exchange
def exchange_start(
    data, valid, dest, *, p: int, c_out: int, fmt: WireFormat,
    backend: Optional[str] = None,
):
    """Map stage of a packed exchange: returns (wire segment (p, *K, p,
    nbytes), sent, dropped_send)."""
    wire, sent, dropped_send, _ = routed_start(
        data, valid, dest, p=p, c_out=c_out, fmt=fmt, backend=backend
    )
    return wire, sent, dropped_send


def exchange_multi_start(
    data, valid, dests, *, p: int, c_out: int, fmt: WireFormat,
    backend: Optional[str] = None,
):
    """Map stage of a packed replicated send (``exchange_multi``)."""
    wire, sent, dropped_send, _ = routed_start(
        data, valid, dests, p=p, c_out=c_out, fmt=fmt, backend=backend
    )
    return wire, sent, dropped_send


def exchange_finish(
    rwire, *, p: int, c_out: int, cap_recv: int, fmt: WireFormat,
    backend: Optional[str] = None,
):
    """Reduce stage of a packed exchange: decode the received segment and
    compact.  Returns (rdata, rvalid, dropped_recv)."""
    return routed_finish(
        rwire, p=p, c_out=c_out, cap_recv=cap_recv, fmt=fmt, backend=backend
    )
