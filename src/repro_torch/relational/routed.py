"""The routed all-to-all exchange primitive (dense wire).

``routed_all_to_all(data, valid, dests, ...)`` routes rows to destination
shards.  Tensors carry the reducer axis first and any further batch axes
(a fused op group's instances) after it: data ``(p, *K, n, ar)``, valid
``(p, *K, n)``.  ``dests`` ``(p, *K, n)`` is a single-destination send
(the hash exchange, optionally with heavy-hitter round-robin spreading
via ``heavy=``); ``(p, *K, n, g)`` is a replicated send (the broadcast
cross join, grid offsets, heavy broadcast), with in-row duplicate
destinations deduplicated.

Map stage: ``_bucketize`` scatters each shard's rows into ``(p, c_out)``
destination buckets with one stable sort.  Network: the ``all_to_all`` is
a swap of the (source, destination) axes.  Reduce stage: ``compact``.
Overflow anywhere is reported, never silently dropped — the join engine
abort-retries with larger capacities.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from .localops import _seg, compact
from .skew import DEFAULT_SKEW_THRESHOLD, heavy_dest_flags, heavy_dest_flags_many, split_dests


def pow2(x: int) -> int:
    """Round capacities up to powers of two (min 4): distinct shapes
    collapse, so uniform shapes make op groups batchable and calibrated
    occupancies reuse buffers across rounds."""
    return 1 << max(2, int(x - 1).bit_length())


def padded_slots(p: int, c_out: int, arity: int = 1) -> int:
    """int32 cells a fleet-wide exchange ships for one ``all_to_all``:
    each of the ``p`` shards sends the dense ``(p, c_out, arity)`` bucket
    buffer whether the buckets are full or empty."""
    return p * p * c_out * max(1, arity)


def _bucketize(
    data: torch.Tensor, valid_dest: torch.Tensor, p: int, c_out: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter rows into per-destination buckets, per segment.

    ``data`` (S, n, ar); ``valid_dest`` (S, n) int32 in [0,p) for live
    rows, == p for dead rows.  Returns (buf (S, p, c_out, ar), buf_valid
    (S, p, c_out), sent (S,), dropped (S,)).

    One stable sort: each sorted slot's in-bucket position is its
    distance to the last bucket boundary (a cummax of boundary indices),
    scattered back to row order; rows then scatter straight into the
    buffer (rows past ``c_out`` go to a discarded trash slot)."""
    s, n, ar = data.shape
    dev = data.device
    buf = torch.zeros((s, p * c_out + 1, ar), dtype=data.dtype, device=dev)
    bufv = torch.zeros((s, p * c_out + 1), dtype=torch.bool, device=dev)
    zero = torch.zeros((s,), dtype=torch.int64, device=dev)
    if n == 0:
        return (
            buf[:, :-1].reshape(s, p, c_out, ar), bufv[:, :-1].reshape(s, p, c_out),
            zero, zero,
        )
    sdest, order = torch.sort(valid_dest, dim=-1, stable=True)
    idx = torch.arange(n, device=dev).expand(s, n)
    is_start = torch.ones((s, n), dtype=torch.bool, device=dev)
    is_start[:, 1:] = sdest[:, 1:] != sdest[:, :-1]
    bucket_start = torch.cummax(torch.where(is_start, idx, 0), dim=-1).values
    pos_sorted = idx - bucket_start
    pos = torch.empty_like(pos_sorted).scatter_(-1, order, pos_sorted)
    live = valid_dest < p
    ok = live & (pos < c_out)
    flat = torch.where(ok, valid_dest.to(torch.int64) * c_out + pos, p * c_out)
    buf.scatter_(1, flat.unsqueeze(-1).expand(-1, -1, ar), data)
    bufv.scatter_(1, flat, ok)
    sent = ok.sum(-1)
    dropped = (live & ~ok).sum(-1)
    return (
        buf[:, :-1].reshape(s, p, c_out, ar), bufv[:, :-1].reshape(s, p, c_out),
        sent, dropped,
    )


def _multi_flatten(
    data: torch.Tensor, valid: torch.Tensor, dests: torch.Tensor, p: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The map-side row tiling of a replicated send: dedupe each row's
    destination list to the skip slot, then flatten to one (n*g,) send."""
    g = dests.shape[-1]
    if g > 1:
        eq = dests.unsqueeze(-1) == dests.unsqueeze(-2)  # (..., n, g, g)
        earlier = torch.ones((g, g), dtype=torch.bool, device=dests.device).tril(-1)
        dup = (eq & earlier).any(-1)
        dests = torch.where(dup, p, dests)
    tiled = data.repeat_interleave(g, dim=-2)
    flat_dest = torch.where(
        valid.repeat_interleave(g, dim=-1),
        dests.reshape(tuple(dests.shape[:-2]) + (-1,)),
        p,
    ).to(torch.int32)
    return tiled, flat_dest


# ------------------------------------------------------ count-only pre-pass
def bucket_counts(dest: torch.Tensor, p: int) -> torch.Tensor:
    """Per-destination outgoing bucket counts over the last axis:
    ``(*L, n)`` destinations (== p for dead slots) -> ``(*L, p)``."""
    lead = tuple(dest.shape[:-1])
    flat = _seg(dest, 1).to(torch.int64)
    live = (flat >= 0) & (flat < p)
    idx = torch.where(live, flat, p)
    out = torch.zeros((flat.shape[0], p + 1), dtype=torch.int64, device=dest.device)
    out.scatter_add_(1, idx, torch.ones_like(idx))
    return out[:, :p].reshape(lead + (p,))


def route_counts(dest: torch.Tensor, p: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The count-only pre-pass of a routed exchange: per-destination
    bucket COUNTS shipped instead of the payload.  ``dest`` (p, *K, n).

    Returns ``(out_counts (p, *K, p), recv_total (p, *K))``: the max of the
    first is the tight send capacity ``c_out``, the max of the second the
    tight receive capacity ``cap_recv``."""
    out = bucket_counts(dest, p)
    recv = out.transpose(0, -1)  # all_to_all: (dst, *K, src)
    return out, recv.sum(-1)


# --------------------------------------------------------------- primitive
class RoutedResult(NamedTuple):
    """One routed exchange's received rows + stats (per shard/instance)."""

    data: torch.Tensor          # (p, *K, cap_recv, ar) received rows, compacted
    valid: torch.Tensor         # (p, *K, cap_recv) bool
    sent: torch.Tensor          # rows that made it into a send bucket
    dropped_send: torch.Tensor  # rows lost to a full send bucket (c_out)
    dropped_recv: torch.Tensor  # rows lost to a full receive buffer (cap_recv)
    heavy_sent: torch.Tensor    # rows routed via the heavy-hitter spread


def routed_all_to_all(
    data: torch.Tensor,
    valid: torch.Tensor,
    dests: torch.Tensor,
    *,
    p: int,
    c_out: int,
    cap_recv: int,
    heavy: Optional[torch.Tensor] = None,
) -> RoutedResult:
    """Route rows to destination shards over the dense wire (the packed
    wire is not ported yet).

    ``heavy`` (p, *K, p) bool, single-destination sends only: rows bound
    for a destination the count pre-pass flagged heavy are spread
    round-robin over all p shards (``skew.split_dests`` — Lemma 8's
    position-partitioned side, restricted to the heavy keys).  The
    consumer owns putting the matching state everywhere."""
    lead = tuple(data.shape[:-2])
    ar = data.shape[-1]
    assert lead[0] == p, (lead, p)
    heavy_sent = None
    if dests.dim() == data.dim():  # (p, *K, n, g): replicated send
        assert heavy is None, "heavy spreading applies to single-dest routes"
        rows, flat_dest = _multi_flatten(data, valid, dests, p)
    else:
        rows = data
        flat_dest = torch.where(valid, dests, p).to(torch.int32)
        if heavy is not None:
            flat_dest, is_heavy = split_dests(flat_dest, heavy, p)
            heavy_sent = (is_heavy & valid).sum(-1)
    buf, bufv, sent, dropped_send = _bucketize(
        _seg(rows, 2), _seg(flat_dest, 1), p, c_out
    )
    # all_to_all: shard s's bucket d becomes shard d's segment s
    buf = buf.reshape(lead + (p, c_out, ar)).transpose(0, len(lead))
    bufv = bufv.reshape(lead + (p, c_out)).transpose(0, len(lead))
    rdata, rv, dropped_recv = compact(
        buf.reshape(lead + (p * c_out, ar)), bufv.reshape(lead + (p * c_out,)),
        cap_recv,
    )
    if heavy_sent is None:
        heavy_sent = torch.zeros(lead, dtype=torch.int64, device=data.device)
    return RoutedResult(
        rdata, rv, sent.reshape(lead), dropped_send.reshape(lead), dropped_recv,
        heavy_sent,
    )


# ----------------------------------------------------------------- policy
@dataclasses.dataclass(frozen=True)
class RoutePolicy:
    """Per-consumer routing configuration: the wire encoding and the
    heavy-hitter sensitivity, shared by every exchange of a query.

    ``wire_policy``: packed formats (only None — dense — is ported).
    ``skew_threshold``: a destination is heavy when its measured arrival
    exceeds this multiple of the balanced share."""

    wire_policy: None = None
    skew_threshold: float = DEFAULT_SKEW_THRESHOLD

    def __post_init__(self):
        if self.wire_policy is not None:
            raise NotImplementedError(
                "RoutePolicy: the packed wire is not ported yet (ROADMAP queue A)"
            )

    # -- heavy-hitter detection ---------------------------------------------
    def heavy_flags(self, out_counts, p: int):
        """(shards, p) send-count matrix -> (p,) heavy-destination flags
        at this policy's threshold."""
        return heavy_dest_flags(out_counts, p, self.skew_threshold)

    def heavy_flags_many(self, out_counts, p: int):
        """(shards, k, p) group send counts -> (k, p) flags."""
        return heavy_dest_flags_many(out_counts, p, self.skew_threshold)
