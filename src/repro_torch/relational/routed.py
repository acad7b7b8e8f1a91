"""The routed all-to-all exchange primitive (dense and packed wire).

``routed_all_to_all(data, valid, dests, ...)`` routes rows to destination
shards.  Tensors carry the reducer axis first and any further batch axes
(a fused op group's instances) after it: data ``(p, *K, n, ar)``, valid
``(p, *K, n)``.  ``dests`` ``(p, *K, n)`` is a single-destination send
(the hash exchange, optionally with heavy-hitter round-robin spreading
via ``heavy=``); ``(p, *K, n, g)`` is a replicated send (the broadcast
cross join, grid offsets, heavy broadcast), with in-row duplicate
destinations deduplicated.

Map stage: ``_bucketize`` scatters each shard's rows into ``(p, c_out)``
destination buckets with one stable sort.  Network: ``spmd.all_to_all``
over the (source, destination) axes (an axis swap in the simulation, a
collective on a mesh) — of the dense data and valid buckets, or of ONE
bit-packed uint8 buffer when a ``wire.WireFormat`` is given (``fmt=``;
the local backend's codec encodes and decodes it, the kernels on the
card).  ``routed_start`` / ``ship_segments`` /
``routed_finish`` split a packed exchange around its collective, so a
fused group ships every op's and side's bytes in one segmented buffer.
Reduce stage: ``compact``.
Overflow anywhere is reported, never silently dropped — the join engine
abort-retries with larger capacities.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from .localops import _seg, compact, default_backend, get_local_backend
from .skew import DEFAULT_SKEW_THRESHOLD, heavy_dest_flags, heavy_dest_flags_many, split_dests
from .spmd import all_to_all
from .wire import WireFormat, WirePolicy, get_codec, pack_segments, split_segments


def pow2(x: int) -> int:
    """Round capacities up to powers of two (min 4): distinct shapes
    collapse, so uniform shapes make op groups batchable and calibrated
    occupancies reuse buffers across rounds."""
    return 1 << max(2, int(x - 1).bit_length())


def padded_slots(p: int, c_out: int, arity: int = 1) -> int:
    """int32 cells a fleet-wide exchange ships for one ``all_to_all``:
    each of the ``p`` shards sends the dense ``(p, c_out, arity)`` bucket
    buffer whether the buckets are full or empty.  ``p`` is the logical
    reducer count, on a mesh too (never a block's length)."""
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
    recv = all_to_all(out, -1)  # (dst, *K, src)
    return out, recv.sum(-1)


# ------------------------------------------------------------- collective
def _codec_backend(backend: Optional[str], t: torch.Tensor):
    """The local backend that runs the wire codec: the caller's, else the
    tensor's device default (the kernels on the card)."""
    return get_local_backend(backend or default_backend(t.device))


def _wire_ship(
    buf: torch.Tensor, buf_valid: torch.Tensor, fmt: WireFormat, c_out: int,
    backend: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed collective: encode the buckets ``(p, *K, p, c_out, ar)`` +
    valid plane into one bit-packed uint8 buffer, run ONE all_to_all (in
    place of the dense path's data + valid pair), decode back.  The codec
    hook wraps the bytes around the collective."""
    be = _codec_backend(backend, buf_valid)
    wire = be.wire_encode(buf, buf_valid, fmt)  # (p, *K, p, nbytes)
    enc, dec = get_codec(fmt.codec)
    payload, aux = enc(wire)
    rpayload = all_to_all(payload, payload.dim() - 2)
    return be.wire_decode(dec(rpayload, aux), fmt, c_out)


def _ship(
    buf: torch.Tensor, buf_valid: torch.Tensor, fmt: Optional[WireFormat], c_out: int,
    backend: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The collective of one exchange over ``(p, *K, p, c_out[, ar])``
    buckets: the dense data + valid pair (an axis swap each) or one packed
    uint8 buffer.  Shard s's bucket d becomes shard d's segment s."""
    if fmt is None:
        return all_to_all(buf, buf.dim() - 3), all_to_all(buf_valid, buf_valid.dim() - 2)
    return _wire_ship(buf, buf_valid, fmt, c_out, backend)


# --------------------------------------------------------------- primitive
class RoutedResult(NamedTuple):
    """One routed exchange's received rows + stats (per shard/instance)."""

    data: torch.Tensor          # (p, *K, cap_recv, ar) received rows, compacted
    valid: torch.Tensor         # (p, *K, cap_recv) bool
    sent: torch.Tensor          # rows that made it into a send bucket
    dropped_send: torch.Tensor  # rows lost to a full send bucket (c_out)
    dropped_recv: torch.Tensor  # rows lost to a full receive buffer (cap_recv)
    heavy_sent: torch.Tensor    # rows routed via the heavy-hitter spread


def _map_stage(data, valid, dests, *, p: int, c_out: int, heavy=None):
    """Route and bucketize every shard's rows: returns (buf (p, *K, p,
    c_out, ar), buf_valid, sent, dropped_send, heavy_sent), stats (p, *K)."""
    lead = tuple(data.shape[:-2])
    ar = data.shape[-1]
    assert lead[0] in (p, 1), (lead, p)  # the reducer axis, or a mesh rank's block
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
    if heavy_sent is None:
        heavy_sent = torch.zeros(lead, dtype=torch.int64, device=data.device)
    return (
        buf.reshape(lead + (p, c_out, ar)), bufv.reshape(lead + (p, c_out)),
        sent.reshape(lead), dropped_send.reshape(lead), heavy_sent,
    )


def _reduce_stage(rbuf, rvalid, *, p: int, c_out: int, cap_recv: int):
    """Compact the received ``(p, *K, p, c_out[, ar])`` segments."""
    lead = tuple(rvalid.shape[:-2])
    ar = rbuf.shape[-1]
    return compact(
        rbuf.reshape(lead + (p * c_out, ar)), rvalid.reshape(lead + (p * c_out,)),
        cap_recv,
    )


def routed_all_to_all(
    data: torch.Tensor,
    valid: torch.Tensor,
    dests: torch.Tensor,
    *,
    p: int,
    c_out: int,
    cap_recv: int,
    fmt: Optional[WireFormat] = None,
    heavy: Optional[torch.Tensor] = None,
    backend: Optional[str] = None,
) -> RoutedResult:
    """Route rows to destination shards.

    ``heavy`` (p, *K, p) bool, single-destination sends only: rows bound
    for a destination the count pre-pass flagged heavy are spread
    round-robin over all p shards (``skew.split_dests`` — Lemma 8's
    position-partitioned side, restricted to the heavy keys).  The
    consumer owns putting the matching state everywhere.

    ``fmt=None`` ships the dense buckets + bool valid plane; a
    ``WireFormat`` ships one bit-packed uint8 buffer, encoded and decoded
    by ``backend``'s codec (None: the device default).  Rows out are
    bit-identical either way."""
    buf, bufv, sent, dropped_send, heavy_sent = _map_stage(
        data, valid, dests, p=p, c_out=c_out, heavy=heavy
    )
    rbuf, rvalid = _ship(buf, bufv, fmt, c_out, backend)
    rdata, rv, dropped_recv = _reduce_stage(rbuf, rvalid, p=p, c_out=c_out, cap_recv=cap_recv)
    return RoutedResult(rdata, rv, sent, dropped_send, dropped_recv, heavy_sent)


# ------------------------------------------- segmented (fused-group) exchange
# An exchange split around its collective: ``routed_start`` buckets and
# encodes one op's send into a (p, *K, p, nbytes) segment, ``ship_segments``
# runs ONE all_to_all over every segment of a fused op group concatenated
# (mixed schemas/arities each keep their own format), and ``routed_finish``
# decodes and compacts each op's received segment.
def routed_start(
    data: torch.Tensor,
    valid: torch.Tensor,
    dests: torch.Tensor,
    *,
    p: int,
    c_out: int,
    fmt: WireFormat,
    heavy: Optional[torch.Tensor] = None,
    backend: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Map stage of a packed routed exchange: returns (wire segment
    (p, *K, p, nbytes), sent, dropped_send, heavy_sent).  Accepts the same
    destination shapes as ``routed_all_to_all``."""
    buf, bufv, sent, dropped_send, heavy_sent = _map_stage(
        data, valid, dests, p=p, c_out=c_out, heavy=heavy
    )
    wire = _codec_backend(backend, bufv).wire_encode(buf, bufv, fmt)
    return wire, sent, dropped_send, heavy_sent


def ship_segments(wires: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """ONE all_to_all for a whole fused group: concatenate each exchange's
    (p, *K, p, nbytes_i) segment, swap the (source, destination) axes,
    split back."""
    seg = pack_segments(wires)
    rseg = all_to_all(seg, seg.dim() - 2)
    return split_segments(rseg, [w.shape[-1] for w in wires])


def routed_finish(
    rwire: torch.Tensor, *, p: int, c_out: int, cap_recv: int, fmt: WireFormat,
    backend: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reduce stage of a packed routed exchange: decode the received
    segment and compact.  Returns (rdata, rvalid, dropped_recv)."""
    rbuf, rvalid = _codec_backend(backend, rwire).wire_decode(rwire, fmt, c_out)
    return _reduce_stage(rbuf, rvalid, p=p, c_out=c_out, cap_recv=cap_recv)


# ----------------------------------------------------------------- policy
@dataclasses.dataclass(frozen=True)
class RoutePolicy:
    """Per-consumer routing configuration: the wire encoding and the
    heavy-hitter sensitivity, shared by every exchange of a query, so
    format soundness and skew decisions are consistent across rounds.

    ``wire_policy``: column-range-derived packed formats (None = dense
    exchanges).  ``skew_threshold``: a destination is heavy when its
    measured arrival exceeds this multiple of the balanced share."""

    wire_policy: Optional[WirePolicy] = None
    skew_threshold: float = DEFAULT_SKEW_THRESHOLD

    # -- packed wire formats ------------------------------------------------
    def fmt_for(self, schemas: Sequence[Sequence[str]]) -> Optional[WireFormat]:
        """Group-uniform packed format of one exchange side: the widest-
        per-column union over the group's instances (wider is sound)."""
        if self.wire_policy is None:
            return None
        return WireFormat.union([self.wire_policy.format_for(s) for s in schemas])

    def pair_fmts(
        self,
        lhs_schemas: Sequence[Sequence[str]],
        rhs_schemas: Sequence[Sequence[str]],
        xcaps,
        rhs_keys_only: bool = False,
    ):
        """Formats of a two-sided exchange group.  ``rhs_keys_only``: the
        rhs ships its deduplicated shared-key projection (semijoins), so
        its format covers the key columns only.  The formats are recorded
        per side in the measurement's ``SideCaps``.  Returns (fmts, xcaps)."""
        if self.wire_policy is None:
            return None, xcaps
        fmt_l = self.fmt_for(lhs_schemas)
        if rhs_keys_only:
            rschemas = [
                tuple(x for x in l if x in set(r))
                for l, r in zip(lhs_schemas, rhs_schemas)
            ]
        else:
            rschemas = list(rhs_schemas)
        fmt_r = self.fmt_for(rschemas)
        if xcaps is not None:
            xcaps = dataclasses.replace(
                xcaps,
                lhs=dataclasses.replace(xcaps.lhs, fmt=fmt_l),
                rhs=None if xcaps.rhs is None else dataclasses.replace(xcaps.rhs, fmt=fmt_r),
            )
        return (fmt_l, fmt_r), xcaps

    def single_fmt(self, schemas: Sequence[Sequence[str]], xcaps):
        """Format of a one-sided exchange group (dedup), recorded in the
        measurement's ``SideCaps``.  Returns (fmt, xcaps)."""
        if self.wire_policy is None:
            return None, xcaps
        fmt = self.fmt_for(schemas)
        if xcaps is not None:
            xcaps = dataclasses.replace(xcaps, lhs=dataclasses.replace(xcaps.lhs, fmt=fmt))
        return fmt, xcaps

    # -- heavy-hitter detection ---------------------------------------------
    def heavy_flags(self, out_counts, p: int):
        """(shards, p) send-count matrix -> (p,) heavy-destination flags
        at this policy's threshold."""
        return heavy_dest_flags(out_counts, p, self.skew_threshold)

    def heavy_flags_many(self, out_counts, p: int):
        """(shards, k, p) group send counts -> (k, p) flags."""
        return heavy_dest_flags_many(out_counts, p, self.skew_threshold)
