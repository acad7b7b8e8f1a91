"""Batched ("round-fused") distributed operators — hash, hybrid and grid paths.

A DYM round schedules k independent operator instances.  These variants
stack the k instances along a batch axis between the reducer axis and the
row axis — DTable (p, cap, ar) -> stacked (p, k, cap, ar) — and run every
per-shard step over both leading axes at once, so one ``SPMD.run``
dispatch (and one kernel launch per hot loop, one all_to_all per shuffle
stage) serves the whole group.

Uniformity contract (enforced by the physical layer's grouping): shard
shapes (cap, arity), key-column COUNT and every capacity must be equal
across the k instances.  Key column POSITIONS and hash seeds may differ
per instance — they ride as ``(p, k, ·)`` tensors applied with
``gather``.

Hash-, hybrid- and grid-path batched ops give bit-identical results (and
identical ``sent``/``dropped``/``heavy`` stats) to
``repro.relational.batched`` given the same seeds and capacities.  The
hybrid paths route light keys by hash and heavy keys grid-style
(``relational.skew``), with the per-instance heavy flags riding as a
``(p, k, p)`` tensor.  The grid paths (Lemma 8 joins and Lemma 10
semijoins) route by position, so their pre-passes need no seeds.

Calibration pre-passes: every payload operator here has a ``measure_*``
sibling — one extra count-only dispatch per op group that ships only
per-destination bucket counts; ``RoundCounts`` fuses every group of a
round stage into ONE such dispatch.  The hash join measure additionally
exchanges a hashed-key column and counts the join output exactly, so
blown output capacities are pre-floored instead of abort-retried.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .grid import (
    _flat_dests,
    _grid_dests,
    _grid_send_one,
    _grid_shares,
    _position_groups,
)
from .hashing import dense_ranks, hash_columns, u32_to_i32
from .localops import (
    get_local_backend,
    local_dedup_mask,
    local_join_count,
    local_join_ranked,
    local_semijoin_mask,
)
from .localops import take_cols as _take
from .shuffle import (
    bucket_counts,
    exchange,
    exchange_counts,
    exchange_finish,
    exchange_multi,
    exchange_start,
    padded_slots,
    pow2,
    ship_segments,
)
from .skew import DEFAULT_SKEW_THRESHOLD, bcast_dests, heavy_dest_flags_many, split_dests
from .spmd import SPMD, all_to_all
from .table import DTable, schema_join
from .wire import WireFormat, count_wire_bytes, dense_wire_bytes, packed_wire_bytes


def _xbytes(p: int, c_out: int, arity: int, fmt: Optional[WireFormat]) -> int:
    """Bytes ONE exchange of this shape ships end-to-end: dense cells +
    valid plane when ``fmt`` is None, the packed bit stream otherwise."""
    if fmt is None:
        return dense_wire_bytes(p, c_out, arity)
    return packed_wire_bytes(p, c_out, fmt)


# Width of the packed join pre-count's key hash when the actual key
# projection is wider (see ``join_pair_measure_spec``), the reference's
# choice, kept for parity.  Narrower than the packed keys on any
# multi-attribute schema; its extra collisions only OVER-count the join
# output.  Over a few thousand distinct keys that stays inside the pow2
# rounding of the derived ``out_need``; over about 2^20 each hash value
# stands for some 16 keys, and ``out_need`` (so the output capacity) can
# come out several times the dense run's.
JOIN_HASH_BITS = 16
_JOIN_HASH_FMT = WireFormat((JOIN_HASH_BITS,))


# ------------------------------------------------------------ stack helpers
def _stack(tables: Sequence[DTable]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p, cap, ar) x k -> data (p, k, cap, ar), valid (p, k, cap)."""
    assert len({(t.cap, t.arity) for t in tables}) == 1, (
        "batched group must have uniform shard shapes: "
        + str([(t.cap, t.arity) for t in tables])
    )
    data = torch.stack([t.data for t in tables], dim=1)
    valid = torch.stack([t.valid for t in tables], dim=1)
    return data, valid


def _unstack(data, valid, schemas: Sequence[Tuple[str, ...]]) -> List[DTable]:
    return [DTable(data[:, i], valid[:, i], s) for i, s in enumerate(schemas)]


def _key_array(keys: Sequence[Sequence[int]], spmd: SPMD) -> torch.Tensor:
    """Per-instance key column indices as a (shards, k, n_keys) tensor
    (``spmd.shards``: p in the simulation, the rank's block on a mesh)."""
    assert len({len(k) for k in keys}) == 1, "key-column count must be uniform"
    ks = np.asarray([list(k) for k in keys], np.int64).reshape(len(keys), -1)
    return torch.from_numpy(ks).to(spmd.device).expand((spmd.shards,) + ks.shape)


def _seed_array(seeds: Sequence[int], spmd: SPMD) -> torch.Tensor:
    s = torch.tensor([int(x) & 0xFFFFFFFF for x in seeds], dtype=torch.int64)
    return s.to(spmd.device).expand(spmd.shards, len(seeds))


def _per_op_stats(
    spmd: SPMD, sent, dropped, padded: int = 0, heavy=None, wire_bytes: int = 0,
    ubytes=None,
) -> List[Dict[str, int]]:
    """(p, k) shard stats (read through ``spmd.to_host``, so gathered on a
    mesh) -> one {'sent','dropped','padded',...} dict per
    instance; ``padded``/``wire_bytes`` (statics of the dispatch) are
    identical across the group's instances.  ``heavy`` (the hybrid ops'
    (p, k) tuple-sends routed through the heavy-hitter path) adds a
    ``'heavy'`` key only when given, so the hash and grid ops' stats stay
    as they are."""
    extra = [x for x in (heavy, ubytes) if x is not None]
    s, d, *rest = [x.sum(axis=0) for x in spmd.to_host_many(sent, dropped, *extra)]
    out = [
        {
            "sent": int(a),
            "dropped": int(b),
            "padded": int(padded),
            "wire_bytes": int(wire_bytes),
        }
        for a, b in zip(s, d)
    ]
    if heavy is not None:
        for st, h in zip(out, rest.pop(0)):
            st["heavy"] = int(h)
    if ubytes is not None:
        for st, u in zip(out, rest.pop(0)):
            st["ubytes"] = int(u)
    return out


# --------------------------------------------------- calibration pre-passes
@dataclasses.dataclass(frozen=True)
class SideCaps:
    """Tight pow2 capacities for ONE exchange side: ``c_out`` (per-
    destination send bucket) and ``cap_recv`` (post-all_to_all compact)."""

    c_out: int
    cap_recv: int
    # packed wire format of this side's exchange (None = dense), recorded
    # by the engine when a WirePolicy is active
    fmt: Optional[WireFormat] = None

    @staticmethod
    def from_counts(out_counts: np.ndarray, recv_tot: np.ndarray) -> "SideCaps":
        """From host count arrays over the whole reducer axis."""
        return SideCaps(
            pow2(max(1, int(np.max(out_counts)))),
            pow2(max(1, int(np.max(recv_tot)))),
        )


@dataclasses.dataclass(frozen=True)
class GroupMeasure:
    """What one count-only pre-pass learned about an op group.

    ``lhs``/``rhs``: per-side tight capacities (max over the group's k
    instances).  ``out_recv``: the receive requirement of the exchange
    whose buffer IS the op's output (semijoin S side, intersect A side,
    dedup).  ``out_need``: exact join-output requirement (hash joins).
    ``padded``/``wire_bytes``: cells and bytes the pre-pass itself
    shipped, charged to the ledger.

    Heavy-hitter surface (``relational.skew``): ``heavy`` is the (k, p)
    bool per-instance flags the count pre-pass detected (None where
    detection doesn't apply), ``n_heavy`` the flagged destination count
    (skewed measures are never cached), ``lhs_heavy_rows`` /
    ``rhs_heavy_rows`` each side's row mass at the flagged destinations.
    ``hybrid_routed`` is True when the capacities were re-measured under
    hybrid routing and the payload must run the hybrid exchange;
    ``swap_spread`` picks the hybrid join's roles (False: spread the lhs,
    broadcast the rhs; True the reverse — the side with the larger heavy
    mass spreads)."""

    lhs: SideCaps
    rhs: Optional[SideCaps] = None
    out_recv: Optional[int] = None
    out_need: Optional[int] = None
    padded: int = 0
    wire_bytes: int = 0
    heavy: Optional[np.ndarray] = None
    n_heavy: int = 0
    lhs_heavy_rows: int = 0
    rhs_heavy_rows: int = 0
    hybrid_routed: bool = False
    swap_spread: bool = False


# ------------------------------------------------- cross-request batching
def cross_request_key(kind, engine, cap, lhs, rhs, xcaps) -> Optional[Tuple]:
    """Cross-REQUEST bucketing key of one prepared op group — the serving
    layer's merge key.  Groups from different queries with equal keys run
    as ONE stacked dispatch: the k axis of the ``dist_*_many`` operators
    spans requests.  The key is engine strategy + local backend, op kind,
    managed output capacity, per-side shard shapes, the measured pow2
    exchange caps and the shared-key-column count (key positions and seeds
    ride as per-instance data).  Equal measured caps make a merge free: no
    rider ships padding another rider's measure asked for.

    None = dispatch solo: packed wire formats are per query (their bit
    widths come from that query's base relations), and hybrid-routed
    payloads carry per-instance heavy-destination flags whose
    spread/broadcast roles do not merge across measures."""
    if engine.wire_policy is not None:
        return None
    if xcaps is not None and xcaps.hybrid_routed:
        return None
    key: Tuple = (
        engine.name, engine.local_backend, kind, int(cap),
        lhs[0].cap, lhs[0].arity,
    )
    if xcaps is None:
        key += (None,)
    else:
        key += (xcaps.lhs, xcaps.rhs, xcaps.out_recv, xcaps.out_need)
    if rhs is not None:
        n_shared = sum(1 for x in lhs[0].schema if x in set(rhs[0].schema))
        key += (rhs[0].cap, rhs[0].arity, n_shared)
    return key


def merge_measures(ms: Sequence[Optional[GroupMeasure]]) -> Optional[GroupMeasure]:
    """Elementwise-max merge of same-key groups' measures for a
    cross-request fused dispatch (wider capacities are always sound: rows,
    ``sent`` and drops are unaffected).  None when ANY measure is missing:
    the merged dispatch then runs at the group defaults.  The measures'
    own wire charges (``padded`` / ``wire_bytes``) are not merged: each
    request charges its pre-pass traffic to its own ledger."""
    if any(m is None for m in ms):
        return None
    assert not any(m.hybrid_routed for m in ms), "hybrid measures don't merge"
    if len(ms) == 1:
        return ms[0]

    def side(sel) -> Optional[SideCaps]:
        sides = [sel(m) for m in ms]
        if any(s is None for s in sides):
            return None
        assert all(s.fmt is None for s in sides), "packed fmts don't merge"
        return SideCaps(max(s.c_out for s in sides), max(s.cap_recv for s in sides))

    def opt_max(sel) -> Optional[int]:
        vals = [sel(m) for m in ms if sel(m) is not None]
        return max(vals) if vals else None

    return GroupMeasure(
        lhs=side(lambda m: m.lhs),
        rhs=side(lambda m: m.rhs),
        out_recv=opt_max(lambda m: m.out_recv),
        out_need=opt_max(lambda m: m.out_need),
        padded=0,
        wire_bytes=0,
    )


def _dests(keys: torch.Tensor, valid: torch.Tensor, p: int, seed, backend: str) -> torch.Tensor:
    """Destinations from a pre-gathered (..., cap, n_keys) key matrix —
    hashes columns in order, identical to ``dests_for(data, key_cols)``."""
    be = get_local_backend(backend)
    return be.dests(keys, valid, tuple(range(keys.shape[-1])), p, seed)


# -------------------------------------------- hash-path measure dispatches
def _measure_pair_shard_b(ad, av, bd, bv, seed, ak, bk, *, p, dedup_b, backend):
    """Count both sides' exchanges of every (a, b) instance with the SAME
    seeds/keys the payload dispatch will use."""
    da = _dests(_take(ad, ak), av, p, seed, backend)
    oa, ra = exchange_counts(da, p)
    bkeys = _take(bd, bk)
    bv2 = local_dedup_mask(bkeys, bv, tuple(range(bk.shape[-1]))) if dedup_b else bv
    db = _dests(bkeys, bv2, p, seed, backend)
    ob, rb = exchange_counts(db, p)
    return oa, ra, ob, rb


def _hashed_key(keys: torch.Tensor, seed) -> torch.Tensor:
    """A single int32 hashed-key column standing in for the key
    projection: equal keys keep equal hashes (and destinations), so a join
    count over it can only over-count."""
    h = hash_columns(keys, tuple(range(keys.shape[-1])), seed)
    return u32_to_i32(h).unsqueeze(-1)


def _measure_keys(akeys, bkeys, seed, fmt):
    """Shared key-source policy of the fused and fallback join counts:
    dense ships the key projection itself (``fmt=None``); packed ships the
    key projection when it bit-packs narrower than a hashed column (exact
    count), else a ``JOIN_HASH_BITS``-bit hash (equal keys keep equal
    hashes, so the count only OVER-counts — sound).  Returns (sa, sb, key
    column ids, wire format to ship with)."""
    kc = tuple(range(akeys.shape[-1]))
    if fmt is not None and fmt.row_bits <= _JOIN_HASH_FMT.row_bits:
        return akeys, bkeys, kc, fmt
    if fmt is not None:
        mask = (1 << JOIN_HASH_BITS) - 1
        sa = (hash_columns(akeys, kc, seed) & mask).to(torch.int32).unsqueeze(-1)
        sb = (hash_columns(bkeys, kc, seed) & mask).to(torch.int32).unsqueeze(-1)
        return sa, sb, (0,), _JOIN_HASH_FMT
    return akeys, bkeys, kc, None


def _pair_ship(sa, av, da, sb, bv, db, *, p, c_out_a, c_out_b, cap_a, cap_b,
               fmt_a, fmt_b, backend):
    """Both sides of a two-sided exchange: two dense exchanges, or (both
    formats given) one segmented packed all_to_all.  Returns ((a2, a2v,
    sent_a, dropped_a), (b2, b2v, sent_b, dropped_b)), drops summed over
    the send and receive stages."""
    if fmt_a is not None and fmt_b is not None:
        aw, sent_a, dsa = exchange_start(sa, av, da, p=p, c_out=c_out_a, fmt=fmt_a,
                                         backend=backend)
        bw, sent_b, dsb = exchange_start(sb, bv, db, p=p, c_out=c_out_b, fmt=fmt_b,
                                         backend=backend)
        aw2, bw2 = ship_segments([aw, bw])
        a2, a2v, dra = exchange_finish(aw2, p=p, c_out=c_out_a, cap_recv=cap_a, fmt=fmt_a,
                                       backend=backend)
        b2, b2v, drb = exchange_finish(bw2, p=p, c_out=c_out_b, cap_recv=cap_b, fmt=fmt_b,
                                       backend=backend)
    else:
        a2, a2v, sent_a, dsa, dra = exchange(sa, av, da, p=p, c_out=c_out_a, cap_recv=cap_a)
        b2, b2v, sent_b, dsb, drb = exchange(sb, bv, db, p=p, c_out=c_out_b, cap_recv=cap_b)
    return (a2, a2v, sent_a, dsa + dra), (b2, b2v, sent_b, dsb + drb)


def _join_count_shard_b(ad, av, bd, bv, seed, ak, bk, *,
                        p, c_out_a, c_out_b, cap_a, cap_b, fmt=None, backend):
    """Keys-only exchange at the ALREADY-CALIBRATED tight capacities,
    then the exact per-shard join output count (``_measure_keys`` picks
    what ships under a packed ``fmt``)."""
    akeys = _take(ad, ak)
    da = _dests(akeys, av, p, seed, backend)
    bkeys = _take(bd, bk)
    db = _dests(bkeys, bv, p, seed, backend)
    sa, sb, kc, sfmt = _measure_keys(akeys, bkeys, seed, fmt)
    (a2, a2v, *_), (b2, b2v, *_) = _pair_ship(
        sa, av, da, sb, bv, db, p=p, c_out_a=c_out_a, c_out_b=c_out_b,
        cap_a=cap_a, cap_b=cap_b, fmt_a=sfmt, fmt_b=sfmt, backend=backend,
    )
    return local_join_count(a2, a2v, b2, b2v, kc, kc, backend)


# ------------------------------------------ hybrid-routing measure helpers
def _heavy_array(heavy: np.ndarray, spmd: SPMD) -> torch.Tensor:
    """Per-instance heavy-destination flags as a (shards, k, p) bool
    tensor on the device: data, so one code path serves every flag
    pattern."""
    h = torch.from_numpy(np.asarray(heavy, bool).reshape(len(heavy), spmd.p))
    return h.to(spmd.device).expand((spmd.shards,) + tuple(h.shape))


def _hybrid_exchange(data, valid, dest, hw, *, p, c_out, cap_recv, spread,
                     fmt=None, backend=None):
    """One side of a hybrid exchange: ``spread=True`` deals the heavy rows
    round-robin (single-dest ``exchange``), ``spread=False`` broadcasts
    them to every reducer (``exchange_multi``).  Returns (rdata, rvalid,
    sent, dropped, heavy_sends)."""
    if spread:
        d2, hvy = split_dests(dest, hw, p)
        rd, rv, sent, ds, dr = exchange(
            data, valid, d2, p=p, c_out=c_out, cap_recv=cap_recv, fmt=fmt, backend=backend
        )
        return rd, rv, sent, ds + dr, hvy.sum(-1)
    d2, hvy = bcast_dests(dest, hw, p)
    rd, rv, sent, ds, dr = exchange_multi(
        data, valid, d2, p=p, c_out=c_out, cap_recv=cap_recv, fmt=fmt, backend=backend
    )
    return rd, rv, sent, ds + dr, p * hvy.sum(-1)


def _hybrid_counts_one_side(dest, hw, *, p, spread):
    if spread:
        d2, _ = split_dests(dest, hw, p)
        return exchange_counts(d2, p)
    d2, _ = bcast_dests(dest, hw, p)
    return exchange_counts(_flat_dests(d2), p)


def _hybrid_pair_counts_shard_b(ad, av, bd, bv, seed, ak, bk, hw, *,
                                p, dedup_b, swap, backend):
    """Count both sides of every instance under HYBRID routing: the spread
    side's heavy rows dealt round-robin, the broadcast side's heavy rows to
    every reducer — the dests the hybrid payload will use.  ``swap``
    spreads the rhs and broadcasts the lhs instead."""
    da = _dests(_take(ad, ak), av, p, seed, backend)
    oa, ra = _hybrid_counts_one_side(da, hw, p=p, spread=not swap)
    bkeys = _take(bd, bk)
    bv2 = local_dedup_mask(bkeys, bv, tuple(range(bk.shape[-1]))) if dedup_b else bv
    db = _dests(bkeys, bv2, p, seed, backend)
    ob, rb = _hybrid_counts_one_side(db, hw, p=p, spread=swap)
    return oa, ra, ob, rb


def _hybrid_pair_counts(
    spmd: SPMD, as_, bs, a_keys, b_keys, seeds, heavy, *,
    dedup_b, swap, backend,
) -> Tuple[SideCaps, SideCaps]:
    """ONE count-only dispatch re-measuring an op group's exchanges under
    hybrid routing (run only when the hash counts flagged heavy
    destinations)."""
    p = spmd.p
    ad, av = _stack(as_)
    bd, bv = _stack(bs)
    oa, ra, ob, rb = spmd.run(
        _hybrid_pair_counts_shard_b,
        ad, av, bd, bv, _seed_array(seeds, spmd),
        _key_array(a_keys, spmd), _key_array(b_keys, spmd),
        _heavy_array(heavy, spmd),
        p=p, dedup_b=dedup_b, swap=swap, backend=backend, measure=True,
    )
    oa, ra, ob, rb = spmd.to_host_many(oa, ra, ob, rb)
    return SideCaps.from_counts(oa, ra), SideCaps.from_counts(ob, rb)


def _hybrid_join_count_shard_b(ad, av, bd, bv, seed, ak, bk, hw, *,
                               p, c_out_a, c_out_b, cap_a, cap_b, swap, fmt=None,
                               backend):
    """Keys-only exchange at the hybrid-calibrated capacities, then the
    exact per-shard join output count UNDER HYBRID PLACEMENT — the spread
    join's true requirement, not the hash join's one-reducer pile-up."""
    akeys = _take(ad, ak)
    da = _dests(akeys, av, p, seed, backend)
    bkeys = _take(bd, bk)
    db = _dests(bkeys, bv, p, seed, backend)
    sa, sb, kc, sfmt = _measure_keys(akeys, bkeys, seed, fmt)
    a2, a2v, *_ = _hybrid_exchange(
        sa, av, da, hw, p=p, c_out=c_out_a, cap_recv=cap_a, spread=not swap,
        fmt=sfmt, backend=backend,
    )
    b2, b2v, *_ = _hybrid_exchange(
        sb, bv, db, hw, p=p, c_out=c_out_b, cap_recv=cap_b, spread=swap,
        fmt=sfmt, backend=backend,
    )
    return local_join_count(a2, a2v, b2, b2v, kc, kc, backend)


def _finalize_pair_counts(
    oa_np: np.ndarray, ra, ob_np: np.ndarray, rb, *, p: int,
    count_padded: int, count_bytes: int = 0,
    skew_threshold: float = DEFAULT_SKEW_THRESHOLD,
) -> GroupMeasure:
    """Host-side tail shared by the per-group pair measure and the
    combined round pre-pass: tight pow2 caps per side plus the free
    heavy-destination detection (the hash is key-consistent across both
    sides, so overload on EITHER side flags the destination's keys heavy
    for both: the union of both sides' flags decides)."""
    heavy = heavy_dest_flags_many(oa_np, p, skew_threshold) | heavy_dest_flags_many(
        ob_np, p, skew_threshold
    )
    arrivals_a = oa_np.reshape(oa_np.shape[0], -1, p).sum(axis=0)  # (k, p)
    arrivals_b = ob_np.reshape(ob_np.shape[0], -1, p).sum(axis=0)
    return GroupMeasure(
        lhs=SideCaps.from_counts(oa_np, ra),
        rhs=SideCaps.from_counts(ob_np, rb),
        out_recv=None,
        padded=count_padded,
        wire_bytes=count_bytes,
        heavy=heavy,
        n_heavy=int(heavy.sum()),
        lhs_heavy_rows=int(arrivals_a[heavy].sum()),
        rhs_heavy_rows=int(arrivals_b[heavy].sum()),
    )


def _measure_pair_many(
    spmd: SPMD, as_, bs, a_keys, b_keys, seeds, *, dedup_b: bool,
    backend: str = "torch", skew_threshold: float = DEFAULT_SKEW_THRESHOLD,
) -> GroupMeasure:
    p = spmd.p
    ad, av = _stack(as_)
    bd, bv = _stack(bs)
    oa, ra, ob, rb = spmd.run(
        _measure_pair_shard_b,
        ad, av, bd, bv, _seed_array(seeds, spmd),
        _key_array(a_keys, spmd), _key_array(b_keys, spmd),
        p=p, dedup_b=dedup_b, backend=backend, measure=True,
    )
    return _finalize_pair_counts(
        *spmd.to_host_many(oa, ra, ob, rb), p=p,
        count_padded=2 * len(as_) * p * p,  # two (p,)-int count vectors each
        count_bytes=count_wire_bytes(p, 2 * len(as_)),
        skew_threshold=skew_threshold,
    )


def _pair_keys(as_, bs):
    shareds = [[x for x in a.schema if x in b.schema] for a, b in zip(as_, bs)]
    return (
        [a.cols(sh) for a, sh in zip(as_, shareds)],
        [b.cols(sh) for b, sh in zip(bs, shareds)],
    )


def measure_semijoin_many(
    spmd: SPMD, ss, rs, *, seeds, backend: str = "torch",
    hybrid: bool = False, skew_threshold: float = DEFAULT_SKEW_THRESHOLD,
) -> GroupMeasure:
    """Pre-pass of ``dist_semijoin_many``: S side raw, R side the
    deduplicated key projection — the S receive count bounds the output.

    ``hybrid=True``: when the counts flag heavy destinations, ONE more
    count-only dispatch re-measures both sides under hybrid routing (S
    spread, R keys broadcast); ``hybrid_routed`` marks the result so."""
    s_keys, r_keys = _pair_keys(ss, rs)
    m = _measure_pair_many(
        spmd, ss, rs, s_keys, r_keys, seeds, dedup_b=True, backend=backend,
        skew_threshold=skew_threshold,
    )
    return finish_semijoin_measure(spmd, ss, rs, seeds, m, hybrid=hybrid, backend=backend)


def finish_semijoin_measure(
    spmd: SPMD, ss, rs, seeds, m: GroupMeasure, *,
    hybrid: bool, backend: str = "torch",
) -> GroupMeasure:
    """Tail of the semijoin pre-pass given pair counts ``m`` from ANY
    source (the per-group dispatch or one slice of ``RoundCounts``): the S
    receive count bounds the output."""
    if hybrid and m.n_heavy:
        # roles are fixed for a semijoin: S (the output side, one copy per
        # row) spreads, R's deduplicated key projection broadcasts — a
        # heavy KEY is a single R-side row after dedup, so broadcast costs
        # n_heavy * p keys, never a relation's row mass
        p = spmd.p
        s_keys, r_keys = _pair_keys(ss, rs)
        lhs, rhs = _hybrid_pair_counts(
            spmd, ss, rs, s_keys, r_keys, seeds, m.heavy,
            dedup_b=True, swap=False, backend=backend,
        )
        return dataclasses.replace(
            m, lhs=lhs, rhs=rhs, out_recv=lhs.cap_recv,
            padded=m.padded + 2 * len(ss) * p * p,
            wire_bytes=m.wire_bytes + count_wire_bytes(p, 2 * len(ss)),
            hybrid_routed=True,
        )
    return dataclasses.replace(m, out_recv=m.lhs.cap_recv)


def hybridize_join_measure(
    spmd: SPMD, as_, bs, seeds, m: GroupMeasure, *,
    hybrid: bool, backend: str = "torch",
) -> GroupMeasure:
    """Join-measure middle stage shared by ``measure_join_many`` and the
    combined round pre-pass: when heavy destinations were flagged,
    re-measure both sides under hybrid routing (one extra count-only
    dispatch, skew-dependent and rare)."""
    if not (hybrid and m.n_heavy):
        return m
    # spread the side carrying the LARGER heavy row mass, broadcast the
    # smaller — that balances both the wire and the join output
    p = spmd.p
    a_keys, b_keys = _pair_keys(as_, bs)
    swap = m.rhs_heavy_rows > m.lhs_heavy_rows
    lhs, rhs = _hybrid_pair_counts(
        spmd, as_, bs, a_keys, b_keys, seeds, m.heavy,
        dedup_b=False, swap=swap, backend=backend,
    )
    # a light-placement output count is void under hybrid routing; the
    # join-need pass recomputes it at the hybrid placement
    return dataclasses.replace(
        m, lhs=lhs, rhs=rhs, out_need=None,
        padded=m.padded + 2 * len(as_) * p * p,
        wire_bytes=m.wire_bytes + count_wire_bytes(p, 2 * len(as_)),
        hybrid_routed=True, swap_spread=swap,
    )


def measure_join_many(
    spmd: SPMD, as_, bs, *, seeds, backend: str = "torch",
    hybrid: bool = False, skew_threshold: float = DEFAULT_SKEW_THRESHOLD,
) -> GroupMeasure:
    """Pre-pass of ``dist_join_many``: the count dispatch (tight shuffle
    capacities), then a keys-only exchange AT those capacities whose
    exact output count pre-sizes ``out_need`` — both priced into
    ``padded``.

    ``hybrid=True``: when the counts flag heavy destinations, the
    capacities are re-measured under hybrid routing and the keys-only
    output count runs at the HYBRID placement."""
    p = spmd.p
    a_keys, b_keys = _pair_keys(as_, bs)
    m = _measure_pair_many(
        spmd, as_, bs, a_keys, b_keys, seeds, dedup_b=False, backend=backend,
        skew_threshold=skew_threshold,
    )
    k, nk = len(as_), len(a_keys[0])
    m = hybridize_join_measure(spmd, as_, bs, seeds, m, hybrid=hybrid, backend=backend)
    ad, av = _stack(as_)
    bd, bv = _stack(bs)
    arrays = (
        ad, av, bd, bv, _seed_array(seeds, spmd),
        _key_array(a_keys, spmd), _key_array(b_keys, spmd),
    )
    caps = dict(
        p=p, c_out_a=m.lhs.c_out, c_out_b=m.rhs.c_out,
        cap_a=m.lhs.cap_recv, cap_b=m.rhs.cap_recv, backend=backend,
    )
    if not m.hybrid_routed:
        cnt = spmd.run(_join_count_shard_b, *arrays, **caps, measure=True)
    else:
        cnt = spmd.run(
            _hybrid_join_count_shard_b, *arrays, _heavy_array(m.heavy, spmd),
            **caps, swap=m.swap_spread, measure=True,
        )
    return dataclasses.replace(
        m,
        out_need=pow2(max(1, int(spmd.to_host(cnt).max()))),
        padded=m.padded
        + k * (padded_slots(p, m.lhs.c_out, nk) + padded_slots(p, m.rhs.c_out, nk)),
        wire_bytes=m.wire_bytes
        + k * (dense_wire_bytes(p, m.lhs.c_out, nk) + dense_wire_bytes(p, m.rhs.c_out, nk)),
    )


def measure_intersect_many(
    spmd: SPMD, as_, bs, *, seeds, backend: str = "torch"
) -> GroupMeasure:
    """Pre-pass of ``dist_intersect_many`` (A = full row key)."""
    m = _measure_pair_many(
        spmd, as_, bs,
        [tuple(range(a.arity)) for a in as_],
        [b.cols(a.schema) for a, b in zip(as_, bs)],
        seeds, dedup_b=False, backend=backend,
    )
    return dataclasses.replace(m, out_recv=m.lhs.cap_recv)


def _measure_one_shard_b(d, v, seed, cols, *, p, backend):
    return exchange_counts(_dests(_take(d, cols), v, p, seed, backend), p)


def measure_dedup_many(
    spmd: SPMD, ts, *, seeds, backend: str = "torch"
) -> GroupMeasure:
    """Pre-pass of ``dist_dedup_many`` (full-row key, single exchange)."""
    p = spmd.p
    d, v = _stack(ts)
    cols = _key_array([tuple(range(t.arity)) for t in ts], spmd)
    o, r = spmd.run(
        _measure_one_shard_b, d, v, _seed_array(seeds, spmd), cols,
        p=p, backend=backend, measure=True,
    )
    caps = SideCaps.from_counts(*spmd.to_host_many(o, r))
    return GroupMeasure(
        lhs=caps, out_recv=caps.cap_recv, padded=len(ts) * p * p,
        wire_bytes=count_wire_bytes(p, len(ts)),
    )


# -------------------------------------------- grid-path measure dispatches
def _grid_pair_dests(av, bv, *, g_a, g_b, cap_a, cap_b, offs_a, offs_b,
                     stride_a, stride_b, p):
    dest_a = _grid_dests(_position_groups(av, g_a, cap_a, p), g_a, stride_a, offs_a, p)
    dest_b = _grid_dests(_position_groups(bv, g_b, cap_b, p), g_b, stride_b, offs_b, p)
    return _flat_dests(dest_a), _flat_dests(dest_b)


def _grid_measure_shard_b(av, bv, *, plan, p):
    da, db = _grid_pair_dests(av, bv, p=p, **dict(plan))
    oa, ra = exchange_counts(da, p)
    ob, rb = exchange_counts(db, p)
    return oa, ra, ob, rb


def _grid_rkeys_valid(rd, rv, rk):
    """Valid mask of R's deduplicated key projection: its position groups
    are counted on these rows, exactly as the mark stage sends them."""
    return local_dedup_mask(_take(rd, rk), rv, tuple(range(rk.shape[-1])))


def _grid_measure_rkeys_shard_b(av, rd, rv, rk, *, plan, p):
    """Grid semijoin pre-pass: S positional, R the dedup'd key projection."""
    da, db = _grid_pair_dests(av, _grid_rkeys_valid(rd, rv, rk), p=p, **dict(plan))
    oa, ra = exchange_counts(da, p)
    ob, rb = exchange_counts(db, p)
    return oa, ra, ob, rb


def _grid_pair_plan(g_a, g_b, cap_a, cap_b):
    """Static dest plan of a 2-relation grid — cell = grp_a * g_b + grp_b,
    which is both the Lemma 8 (w=2) join layout and the Lemma 10 mark
    layout (S major, R-projection minor)."""
    stride_a, stride_b = g_b, 1
    offs_a = tuple(range(g_b))
    offs_b = tuple(c * g_b for c in range(g_a))
    return (
        ("g_a", g_a), ("g_b", g_b), ("cap_a", cap_a), ("cap_b", cap_b),
        ("offs_a", offs_a), ("offs_b", offs_b),
        ("stride_a", stride_a), ("stride_b", stride_b),
    )


def _stack_valid(tables: Sequence[DTable]) -> torch.Tensor:
    """Valid masks only, (p, k, cap) — the grid pre-passes are positional,
    so they never need the payload columns."""
    assert len({t.cap for t in tables}) == 1
    return torch.stack([t.valid for t in tables], dim=1)


def _grid_measure(spmd: SPMD, oa, ra, ob, rb, k: int) -> GroupMeasure:
    p = spmd.p
    oa, ra, ob, rb = spmd.to_host_many(oa, ra, ob, rb)
    return GroupMeasure(
        lhs=SideCaps.from_counts(oa, ra),
        rhs=SideCaps.from_counts(ob, rb),
        padded=2 * k * p * p,
        wire_bytes=count_wire_bytes(p, 2 * k),
    )


def measure_grid_join_many(spmd: SPMD, as_, bs) -> GroupMeasure:
    """Pre-pass of ``grid_join_many``: positional dests need no seeds, so
    the counts are exact for the payload send regardless of hashing."""
    p = spmd.p
    a0, b0 = as_[0], bs[0]
    g = _grid_shares([a0.cap * p, b0.cap * p], p)
    oa, ra, ob, rb = spmd.run(
        _grid_measure_shard_b, _stack_valid(as_), _stack_valid(bs),
        plan=_grid_pair_plan(g[0], g[1], a0.cap, b0.cap), p=p, measure=True,
    )
    return _grid_measure(spmd, oa, ra, ob, rb, len(as_))


def measure_grid_semijoin_many(spmd: SPMD, ss, rs) -> GroupMeasure:
    """Pre-pass of ``grid_semijoin_many``'s mark stage (the trailing hash
    dedup keeps its managed capacity — its input is the mark output, which
    does not exist yet)."""
    p = spmd.p
    s0, r0 = ss[0], rs[0]
    g_s, g_r = _grid_shares([s0.cap * p, r0.cap * p], p)
    shareds = [[x for x in s.schema if x in r.schema] for s, r in zip(ss, rs)]
    rd, rv = _stack(rs)  # R's key projection needs the data; S only its mask
    rk = _key_array([r.cols(sh) for r, sh in zip(rs, shareds)], spmd)
    oa, ra, ob, rb = spmd.run(
        _grid_measure_rkeys_shard_b, _stack_valid(ss), rd, rv, rk,
        plan=_grid_pair_plan(g_s, g_r, s0.cap, r0.cap), p=p, measure=True,
    )
    return _grid_measure(spmd, oa, ra, ob, rb, len(ss))


# ---------------------------------------- combined round-level measure pass
@dataclasses.dataclass
class MeasureSpec:
    """One op group's slice of a round's COMBINED count pre-pass.

    Building a spec stacks the group's inputs on device but dispatches
    nothing; ``RoundCounts`` fuses every spec of a round stage into one
    dispatch whose count blocks ride a single ``(m, p)`` all_to_all.
    ``rows`` is how many count rows the spec owns (2k for two-sided
    groups, k for single exchanges)."""

    tag: str  # 'pair' | 'join_pair' | 'single' | 'grid_pair' | 'grid_rkeys'
    entry: Tuple
    arrays: Tuple
    k: int
    rows: int
    count_padded: int  # int32 cells this spec's count vectors ship
    count_bytes: int = 0  # byte-true size of the same pre-pass traffic
    skew_threshold: float = DEFAULT_SKEW_THRESHOLD
    join_rows: int = 0  # rows this spec owns in the fused join-count block


def pair_measure_spec(
    spmd: SPMD, as_, bs, a_keys, b_keys, seeds, *,
    dedup_b: bool, skew_threshold: float = DEFAULT_SKEW_THRESHOLD,
) -> MeasureSpec:
    """Hash pair exchange counts (semijoin/join/intersect pre-pass)."""
    p = spmd.p
    ad, av = _stack(as_)
    bd, bv = _stack(bs)
    k = len(as_)
    return MeasureSpec(
        tag="pair",
        entry=("pair", k, bool(dedup_b)),
        arrays=(
            ad, av, bd, bv, _seed_array(seeds, spmd),
            _key_array(a_keys, spmd), _key_array(b_keys, spmd),
        ),
        k=k, rows=2 * k, count_padded=2 * k * p * p,
        count_bytes=count_wire_bytes(p, 2 * k),
        skew_threshold=skew_threshold,
    )


def join_pair_measure_spec(
    spmd: SPMD, as_, bs, a_keys, b_keys, seeds, *,
    g_a: int, g_b: int, skew_threshold: float = DEFAULT_SKEW_THRESHOLD,
    fmt: Optional[WireFormat] = None,
) -> MeasureSpec:
    """Hash join pre-pass with the output count FUSED into the same
    dispatch: besides both sides' exchange counts, the program ships a
    keys-only exchange per side at the STATIC guess capacities
    ``g_a``/``g_b`` and counts the join output per destination.  The
    fetched counts prove post hoc whether the guess held; ``_finalize_spec``
    only trusts the fused count when it did.

    Dense (``fmt=None``) ships a single hashed-key column per side: the
    count can only over-count, a sound ``out_need`` at width-1 wire cost.
    Packed (``fmt`` = the group's shared-key ``WireFormat``) ships the key
    projections bit-packed when they fit in fewer bits than a hashed
    column (an exact count), else a bit-packed ``JOIN_HASH_BITS``-bit key
    hash (``_measure_keys``)."""
    p = spmd.p
    ad, av = _stack(as_)
    bd, bv = _stack(bs)
    k = len(as_)
    keyed = False
    sfmt = fmt
    if fmt is not None:
        # the SHIPPED format after the _measure_keys policy (the entry
        # keeps the original so the shard body resolves identically)
        keyed = fmt.row_bits <= _JOIN_HASH_FMT.row_bits
        if not keyed:
            sfmt = _JOIN_HASH_FMT
    if fmt is None:
        # count vectors + the two hashed-key (width 1) dense exchanges
        pad = 2 * k * p * p + k * p * p * (g_a + g_b)
        byt = count_wire_bytes(p, 2 * k) + k * (
            dense_wire_bytes(p, g_a, 1) + dense_wire_bytes(p, g_b, 1)
        )
    else:
        # count vectors + the two packed keys-only exchanges (the slot
        # metric stays width-weighted: one cell per shipped column)
        pad = 2 * k * p * p + k * p * p * (g_a + g_b) * sfmt.arity
        byt = count_wire_bytes(p, 2 * k) + k * (
            packed_wire_bytes(p, g_a, sfmt) + packed_wire_bytes(p, g_b, sfmt)
        )
    return MeasureSpec(
        tag="join_pair",
        entry=("join_pair", k, g_a, g_b, fmt, keyed),
        arrays=(
            ad, av, bd, bv, _seed_array(seeds, spmd),
            _key_array(a_keys, spmd), _key_array(b_keys, spmd),
        ),
        k=k, rows=2 * k, count_padded=pad, count_bytes=byt,
        skew_threshold=skew_threshold, join_rows=k,
    )


def single_measure_spec(spmd: SPMD, ts, seeds) -> MeasureSpec:
    """Full-row-key single exchange counts (dedup pre-pass)."""
    p = spmd.p
    d, v = _stack(ts)
    cols = _key_array([tuple(range(t.arity)) for t in ts], spmd)
    k = len(ts)
    return MeasureSpec(
        tag="single",
        entry=("single", k),
        arrays=(d, v, _seed_array(seeds, spmd), cols),
        k=k, rows=k, count_padded=k * p * p,
        count_bytes=count_wire_bytes(p, k),
    )


def grid_pair_measure_spec(spmd: SPMD, as_, bs) -> MeasureSpec:
    """Positional grid join send counts (seedless, exact)."""
    p = spmd.p
    a0, b0 = as_[0], bs[0]
    g = _grid_shares([a0.cap * p, b0.cap * p], p)
    k = len(as_)
    return MeasureSpec(
        tag="grid_pair",
        entry=("grid_pair", k, _grid_pair_plan(g[0], g[1], a0.cap, b0.cap)),
        arrays=(_stack_valid(as_), _stack_valid(bs)),
        k=k, rows=2 * k, count_padded=2 * k * p * p,
        count_bytes=count_wire_bytes(p, 2 * k),
    )


def grid_rkeys_measure_spec(spmd: SPMD, ss, rs) -> MeasureSpec:
    """Grid semijoin mark-stage counts: S positional, R the dedup'd key
    projection (masked rows recounted, exactly as the mark stage does)."""
    p = spmd.p
    s0, r0 = ss[0], rs[0]
    g_s, g_r = _grid_shares([s0.cap * p, r0.cap * p], p)
    shareds = [[x for x in s.schema if x in r.schema] for s, r in zip(ss, rs)]
    rd, rv = _stack(rs)
    rk = _key_array([r.cols(sh) for r, sh in zip(rs, shareds)], spmd)
    k = len(ss)
    return MeasureSpec(
        tag="grid_rkeys",
        entry=("grid_rkeys", k, _grid_pair_plan(g_s, g_r, s0.cap, r0.cap)),
        arrays=(_stack_valid(ss), rd, rv, rk),
        k=k, rows=2 * k, count_padded=2 * k * p * p,
        count_bytes=count_wire_bytes(p, 2 * k),
    )


def _measure_round_shard(*arrays, entries, p, backend):
    """Body of the combined pre-pass: every group's local per-destination
    counts, computed with the SAME destination logic as its payload,
    concatenated into one ``(p, m, p)`` block and shipped over ONE
    all_to_all.  Returns ``(local_counts (p, m, p), recv_totals (p, m),
    join_counts (p, j))``."""
    blocks = []
    jblocks = []
    i = 0
    for e in entries:
        tag = e[0]
        if tag == "pair":
            _, k, dedup_b = e
            ad, av, bd, bv, seed, ak, bk = arrays[i: i + 7]
            i += 7
            da = _dests(_take(ad, ak), av, p, seed, backend)
            bkeys = _take(bd, bk)
            bv2 = (
                local_dedup_mask(bkeys, bv, tuple(range(bk.shape[-1])))
                if dedup_b else bv
            )
            db = _dests(bkeys, bv2, p, seed, backend)
            blocks += [bucket_counts(da, p), bucket_counts(db, p)]
        elif tag == "join_pair":
            _, k, g_a, g_b, jfmt, _keyed = e
            ad, av, bd, bv, seed, ak, bk = arrays[i: i + 7]
            i += 7
            akeys = _take(ad, ak)
            da = _dests(akeys, av, p, seed, backend)
            bkeys = _take(bd, bk)
            db = _dests(bkeys, bv, p, seed, backend)
            if jfmt is not None:
                # packed: the bit-packed key projection (narrow keys, exact
                # count) or a JOIN_HASH_BITS-bit hash (wide keys, sound
                # over-count); one segmented collective either way
                sa, sb, kc, sfmt = _measure_keys(akeys, bkeys, seed, jfmt)
            else:
                # dense: a single hashed-key column stands in for the
                # nk-wide key projection: the count can only over-count —
                # a sound out_need
                sa, sb, kc, sfmt = _hashed_key(akeys, seed), _hashed_key(bkeys, seed), (0,), None
            (a2, a2v, *_), (b2, b2v, *_) = _pair_ship(
                sa, av, da, sb, bv, db, p=p, c_out_a=g_a, c_out_b=g_b,
                cap_a=p * g_a, cap_b=p * g_b, fmt_a=sfmt, fmt_b=sfmt, backend=backend,
            )
            jc = local_join_count(a2, a2v, b2, b2v, kc, kc, backend)
            blocks += [bucket_counts(da, p), bucket_counts(db, p)]
            jblocks.append(jc)
        elif tag == "single":
            _, k = e
            d, v, seed, cols = arrays[i: i + 4]
            i += 4
            blocks.append(bucket_counts(_dests(_take(d, cols), v, p, seed, backend), p))
        elif tag == "grid_pair":
            _, k, plan = e
            gav, gbv = arrays[i: i + 2]
            i += 2
            da, db = _grid_pair_dests(gav, gbv, p=p, **dict(plan))
            blocks += [bucket_counts(da, p), bucket_counts(db, p)]
        else:  # grid_rkeys
            _, k, plan = e
            sv, rd, rv, rk = arrays[i: i + 4]
            i += 4
            da, db = _grid_pair_dests(sv, _grid_rkeys_valid(rd, rv, rk), p=p, **dict(plan))
            blocks += [bucket_counts(da, p), bucket_counts(db, p)]
    cnts = torch.cat(blocks, dim=1)  # (p_src, m, p_dst)
    recv = all_to_all(cnts, 2)  # (p_dst, m, p_src)
    if jblocks:
        jcnt = torch.cat(jblocks, dim=1)
    else:
        jcnt = torch.zeros((cnts.shape[0], 0), dtype=torch.int64, device=cnts.device)
    return cnts, recv.sum(-1), jcnt


def _finalize_spec(
    spec: MeasureSpec, cnts: np.ndarray, recv: np.ndarray, off: int, p: int,
    jcnt: Optional[np.ndarray] = None, joff: int = 0,
) -> GroupMeasure:
    """Slice one spec's rows out of the fetched combined counts and
    reproduce the host-side semantics of its per-group measure."""
    k = spec.k
    if spec.tag == "single":
        o, r = cnts[:, off: off + k, :], recv[:, off: off + k]
        caps = SideCaps.from_counts(o, r)
        return GroupMeasure(
            lhs=caps, out_recv=caps.cap_recv, padded=spec.count_padded,
            wire_bytes=spec.count_bytes,
        )
    oa, ra = cnts[:, off: off + k, :], recv[:, off: off + k]
    ob, rb = cnts[:, off + k: off + 2 * k, :], recv[:, off + k: off + 2 * k]
    if spec.tag in ("grid_pair", "grid_rkeys"):
        # positional routing: no heavy-destination surface
        return GroupMeasure(
            lhs=SideCaps.from_counts(oa, ra),
            rhs=SideCaps.from_counts(ob, rb),
            padded=spec.count_padded,
            wire_bytes=spec.count_bytes,
        )
    m = _finalize_pair_counts(
        oa, ra, ob, rb, p=p,
        count_padded=spec.count_padded, count_bytes=spec.count_bytes,
        skew_threshold=spec.skew_threshold,
    )
    if spec.tag == "join_pair":
        # trust the fused output count only when the counts prove the
        # hashed-key exchanges held every send (guess not exceeded)
        _, _, g_a, g_b, _jfmt, _keyed = spec.entry
        if int(oa.max()) <= g_a and int(ob.max()) <= g_b:
            jc = jcnt[:, joff: joff + spec.join_rows]
            m = dataclasses.replace(m, out_need=pow2(max(1, int(jc.max()))))
    return m


class RoundCounts:
    """Handle over ONE combined count dispatch covering every measuring
    op group of a round stage.

    Construction launches the dispatch and returns immediately (on CUDA
    the work is queued asynchronously), so the executor can issue it
    while the previous round's payload is still running (measure
    prefetch).  ``fetch()`` is the round's single host read-back."""

    def __init__(self, spmd: SPMD, specs: Sequence[MeasureSpec], *,
                 backend: str = "torch"):
        self.spmd = spmd
        self.specs = list(specs)
        self.p = spmd.p
        arrays: List[torch.Tensor] = []
        entries = []
        for s in self.specs:
            entries.append(s.entry)
            arrays.extend(s.arrays)
        self._cnts, self._recv, self._jcnt = spmd.run(
            _measure_round_shard, *arrays,
            entries=tuple(entries), p=spmd.p, backend=backend, measure=True,
        )
        self._host: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None

    @property
    def count_padded(self) -> int:
        return sum(s.count_padded for s in self.specs)

    @property
    def count_bytes(self) -> int:
        return sum(s.count_bytes for s in self.specs)

    def fetch(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self._host is None:
            self._host = tuple(self.spmd.to_host_many(self._cnts, self._recv, self._jcnt))
        return self._host

    def measures(self) -> List[GroupMeasure]:
        cnts, recv, jcnt = self.fetch()
        out = []
        off = 0
        joff = 0
        for s in self.specs:
            out.append(_finalize_spec(s, cnts, recv, off, self.p, jcnt, joff))
            off += s.rows
            joff += s.join_rows
        return out


def _join_need_round_shard(*arrays, entries, p, backend):
    """Body of the fused join output-count pass: every join group's
    keys-only exchange (at its calibrated capacities) plus exact local
    join count, concatenated — one dispatch per round stage."""
    outs = []
    i = 0
    for e in entries:
        if e[0] == "hash":
            _, k, coa, cob, ca, cb, fmt = e
            ad, av, bd, bv, seed, ak, bk = arrays[i: i + 7]
            i += 7
            outs.append(_join_count_shard_b(
                ad, av, bd, bv, seed, ak, bk, p=p, c_out_a=coa, c_out_b=cob,
                cap_a=ca, cap_b=cb, fmt=fmt, backend=backend,
            ))
        else:  # hybrid placement
            _, k, coa, cob, ca, cb, swap, fmt = e
            ad, av, bd, bv, seed, ak, bk, hw = arrays[i: i + 8]
            i += 8
            outs.append(_hybrid_join_count_shard_b(
                ad, av, bd, bv, seed, ak, bk, hw, p=p, c_out_a=coa,
                c_out_b=cob, cap_a=ca, cap_b=cb, swap=swap, fmt=fmt, backend=backend,
            ))
    return torch.cat(outs, dim=1)  # (p, sum_k)


def join_need_many(
    spmd: SPMD, items, *, fmts: Optional[Sequence[Optional[WireFormat]]] = None,
    backend: str = "torch",
) -> List[GroupMeasure]:
    """ONE dispatch computing the exact join-output requirement for EVERY
    join group of a round stage; each returned measure carries
    ``out_need`` with the keys-only exchange priced into ``padded``.

    ``fmts`` (one shared-key ``WireFormat`` or None per item) packs the
    keys-only exchanges with the ``_measure_keys`` policy — the same wire
    the fused pre-count would have used."""
    p = spmd.p
    if fmts is None:
        fmts = [None] * len(items)
    arrays: List[torch.Tensor] = []
    entries = []
    nks = []
    for (as_, bs, seeds, m), fmt in zip(items, fmts):
        a_keys, b_keys = _pair_keys(as_, bs)
        nks.append(len(a_keys[0]))
        ad, av = _stack(as_)
        bd, bv = _stack(bs)
        caps = (m.lhs.c_out, m.rhs.c_out, m.lhs.cap_recv, m.rhs.cap_recv)
        arrays.extend((
            ad, av, bd, bv, _seed_array(seeds, spmd),
            _key_array(a_keys, spmd), _key_array(b_keys, spmd),
        ))
        if m.hybrid_routed:
            entries.append(("hybrid", len(as_)) + caps + (m.swap_spread, fmt))
            arrays.append(_heavy_array(m.heavy, spmd))
        else:
            entries.append(("hash", len(as_)) + caps + (fmt,))
    cnt = spmd.to_host(spmd.run(
        _join_need_round_shard, *arrays,
        entries=tuple(entries), p=p, backend=backend, measure=True,
    ))  # (p, sum_k)
    out = []
    off = 0
    for (as_, bs, seeds, m), e, nk, fmt in zip(items, entries, nks, fmts):
        k = e[1]
        c = cnt[:, off: off + k]
        off += k
        if fmt is not None:
            # the shipped format after the _measure_keys policy: the keys
            # when narrow enough, the JOIN_HASH_BITS hash otherwise
            sfmt = fmt if fmt.row_bits <= _JOIN_HASH_FMT.row_bits else _JOIN_HASH_FMT
            pad_x = k * (
                padded_slots(p, m.lhs.c_out, sfmt.arity)
                + padded_slots(p, m.rhs.c_out, sfmt.arity)
            )
            byt_x = k * (
                packed_wire_bytes(p, m.lhs.c_out, sfmt)
                + packed_wire_bytes(p, m.rhs.c_out, sfmt)
            )
        else:
            pad_x = k * (padded_slots(p, m.lhs.c_out, nk) + padded_slots(p, m.rhs.c_out, nk))
            byt_x = k * (
                dense_wire_bytes(p, m.lhs.c_out, nk) + dense_wire_bytes(p, m.rhs.c_out, nk)
            )
        out.append(dataclasses.replace(
            m,
            out_need=pow2(max(1, int(c.max()))),
            padded=m.padded + pad_x,
            wire_bytes=m.wire_bytes + byt_x,
        ))
    return out


# ------------------------------------------------------------ hash semijoin
def _semijoin_shard_b(sd, sv, rd, rv, seed, sk, rk, *,
                      p, c_out_s, c_out_r, cap_s, cap_r, fmt_s=None, fmt_r=None,
                      backend):
    nk = rk.shape[-1]
    kcols = tuple(range(nk))
    # ship only the deduplicated key projection of R (S |>< R = S |><
    # pi_{S&R}(R)), as in Sec. 4.1
    rkeys = _take(rd, rk)
    rkv = local_dedup_mask(rkeys, rv, kcols)
    rkeys = torch.where(rkv.unsqueeze(-1), rkeys, 0)
    rdest = _dests(rkeys, rkv, p, seed, backend)
    sdest = _dests(_take(sd, sk), sv, p, seed, backend)
    # packed: both sides encode into ONE segmented buffer, one all_to_all
    (rk2, rkv2, sent_r, dr_r), (s2, s2v, sent_s, dr_s) = _pair_ship(
        rkeys, rkv, rdest, sd, sv, sdest, p=p, c_out_a=c_out_r, c_out_b=c_out_s,
        cap_a=cap_r, cap_b=cap_s, fmt_a=fmt_r, fmt_b=fmt_s, backend=backend,
    )
    rkv2 = local_dedup_mask(rk2, rkv2, kcols)
    mask = local_semijoin_mask(_take(s2, sk), s2v, kcols, rk2, rkv2, kcols, backend)
    s2 = torch.where(mask.unsqueeze(-1), s2, 0)
    ub = 4 * (nk * sent_r + sd.shape[-1] * sent_s)  # dense int32 bytes occupied
    return s2, mask, sent_r + sent_s, dr_r + dr_s, ub


def dist_semijoin_many(
    spmd: SPMD, ss: Sequence[DTable], rs: Sequence[DTable], *,
    seeds: Sequence[int], cap_recv: Tuple[int, int],
    c_out: Optional[Tuple[int, int]] = None,
    fmts: Optional[Tuple] = None,  # (fmt_s, fmt_r) or None = dense
    backend: str = "torch",
) -> Tuple[List[DTable], List[Dict]]:
    """k-fold S_i |>< R_i in ONE dispatch."""
    p = spmd.p
    shareds = [[x for x in s.schema if x in r.schema] for s, r in zip(ss, rs)]
    assert all(shareds), "semijoin with no shared attrs in batch"
    c_out = c_out or (ss[0].cap, rs[0].cap)
    sd, sv = _stack(ss)
    rd, rv = _stack(rs)
    sk = _key_array([s.cols(sh) for s, sh in zip(ss, shareds)], spmd)
    rk = _key_array([r.cols(sh) for r, sh in zip(rs, shareds)], spmd)
    fmt_s, fmt_r = fmts if fmts is not None else (None, None)
    od, ov, sent, dropped, ub = spmd.run(
        _semijoin_shard_b,
        sd, sv, rd, rv, _seed_array(seeds, spmd), sk, rk,
        p=p, c_out_s=c_out[0], c_out_r=c_out[1],
        cap_s=cap_recv[0], cap_r=cap_recv[1], fmt_s=fmt_s, fmt_r=fmt_r, backend=backend,
    )
    return _unstack(od, ov, [s.schema for s in ss]), _per_op_stats(
        spmd, sent, dropped,
        # S ships full rows; R ships its deduplicated key projection
        padded_slots(p, c_out[0], ss[0].arity)
        + padded_slots(p, c_out[1], len(shareds[0])),
        wire_bytes=_xbytes(p, c_out[0], ss[0].arity, fmt_s)
        + _xbytes(p, c_out[1], len(shareds[0]), fmt_r),
        ubytes=ub,
    )


# ---------------------------------------------------------------- hash join
def _join_shard_b(ad, av, bd, bv, seed, ak, bk, bkeep, *,
                  p, c_out_a, c_out_b, cap_a, cap_b, out_cap, fmt_a=None, fmt_b=None,
                  backend):
    nk = ak.shape[-1]
    kcols = tuple(range(nk))
    adest = _dests(_take(ad, ak), av, p, seed, backend)
    bdest = _dests(_take(bd, bk), bv, p, seed, backend)
    (a2, a2v, sent_a, dr_a), (b2, b2v, sent_b, dr_b) = _pair_ship(
        ad, av, adest, bd, bv, bdest, p=p, c_out_a=c_out_a, c_out_b=c_out_b,
        cap_a=cap_a, cap_b=cap_b, fmt_a=fmt_a, fmt_b=fmt_b, backend=backend,
    )
    ra, rb = dense_ranks(_take(a2, ak), a2v, kcols, _take(b2, bk), b2v, kcols)
    out, out_v, over = local_join_ranked(
        a2, a2v, ra, b2, b2v, rb, bkeep, out_cap, backend
    )
    ub = 4 * (ad.shape[-1] * sent_a + bd.shape[-1] * sent_b)
    return out, out_v, sent_a + sent_b, dr_a + dr_b + over, ub


def dist_join_many(
    spmd: SPMD, as_: Sequence[DTable], bs: Sequence[DTable], *,
    seeds: Sequence[int], out_cap: int,
    c_out: Optional[Tuple[int, int]] = None,
    cap_recv: Optional[Tuple[int, int]] = None,
    fmts: Optional[Tuple] = None,  # (fmt_a, fmt_b) or None = dense
    backend: str = "torch",
) -> Tuple[List[DTable], List[Dict]]:
    """k-fold A_i |><| B_i in ONE dispatch."""
    p = spmd.p
    shareds = [[x for x in a.schema if x in b.schema] for a, b in zip(as_, bs)]
    # DYM rounds only join GHD-adjacent nodes, which share attributes; the
    # cross-join case is served by sequential dist_join's broadcast plan
    assert all(shareds), "attribute-disjoint join in batch; use dist_join"
    keeps = [
        tuple(i for i, x in enumerate(b.schema) if x not in set(a.schema))
        for a, b in zip(as_, bs)
    ]
    schemas = [schema_join(a.schema, b.schema) for a, b in zip(as_, bs)]
    c_out = c_out or (as_[0].cap, bs[0].cap)
    cap_recv = cap_recv or (p * as_[0].cap, p * bs[0].cap)
    ad, av = _stack(as_)
    bd, bv = _stack(bs)
    ak = _key_array([a.cols(sh) for a, sh in zip(as_, shareds)], spmd)
    bk = _key_array([b.cols(sh) for b, sh in zip(bs, shareds)], spmd)
    bkeep = _key_array(keeps, spmd)
    fmt_a, fmt_b = fmts if fmts is not None else (None, None)
    od, ov, sent, dropped, ub = spmd.run(
        _join_shard_b,
        ad, av, bd, bv, _seed_array(seeds, spmd), ak, bk, bkeep,
        p=p, c_out_a=c_out[0], c_out_b=c_out[1],
        cap_a=cap_recv[0], cap_b=cap_recv[1], out_cap=out_cap,
        fmt_a=fmt_a, fmt_b=fmt_b, backend=backend,
    )
    return _unstack(od, ov, schemas), _per_op_stats(
        spmd, sent, dropped,
        padded_slots(p, c_out[0], as_[0].arity)
        + padded_slots(p, c_out[1], bs[0].arity),
        wire_bytes=_xbytes(p, c_out[0], as_[0].arity, fmt_a)
        + _xbytes(p, c_out[1], bs[0].arity, fmt_b),
        ubytes=ub,
    )


# ------------------------------------------- hybrid (heavy-hitter) semijoin
def _hybrid_semijoin_shard_b(sd, sv, rd, rv, seed, sk, rk, hw, *,
                             p, c_out_s, c_out_r, cap_s, cap_r, fmt_s=None, fmt_r=None,
                             backend):
    """``_semijoin_shard_b`` with hybrid routing: S (the output side)
    spread, R's deduplicated key projection broadcast for heavy keys.  An
    S row lands on exactly one reducer either way, and every R key it can
    match is there (hash-co-located for light keys, broadcast for heavy),
    so the mask — and the output row set — is the hash semijoin's."""
    nk = rk.shape[-1]
    kcols = tuple(range(nk))
    rkeys = _take(rd, rk)
    rkv = local_dedup_mask(rkeys, rv, kcols)
    rkeys = torch.where(rkv.unsqueeze(-1), rkeys, 0)
    rk2, rkv2, sent_r, dr_r, hvy_r = _hybrid_exchange(
        rkeys, rkv, _dests(rkeys, rkv, p, seed, backend), hw,
        p=p, c_out=c_out_r, cap_recv=cap_r, spread=False, fmt=fmt_r, backend=backend,
    )
    rkv2 = local_dedup_mask(rk2, rkv2, kcols)
    s2, s2v, sent_s, dr_s, hvy_s = _hybrid_exchange(
        sd, sv, _dests(_take(sd, sk), sv, p, seed, backend), hw,
        p=p, c_out=c_out_s, cap_recv=cap_s, spread=True, fmt=fmt_s, backend=backend,
    )
    mask = local_semijoin_mask(_take(s2, sk), s2v, kcols, rk2, rkv2, kcols, backend)
    s2 = torch.where(mask.unsqueeze(-1), s2, 0)
    ub = 4 * (nk * sent_r + sd.shape[-1] * sent_s)
    return s2, mask, sent_r + sent_s, dr_r + dr_s, hvy_s + hvy_r, ub


def hybrid_semijoin_many(
    spmd: SPMD, ss: Sequence[DTable], rs: Sequence[DTable], *,
    seeds: Sequence[int], heavy: np.ndarray, cap_recv: Tuple[int, int],
    c_out: Optional[Tuple[int, int]] = None,
    fmts: Optional[Tuple] = None,  # (fmt_s, fmt_r) or None = dense
    backend: str = "torch",
) -> Tuple[List[DTable], List[Dict]]:
    """k-fold skew-resilient S_i |>< R_i in ONE dispatch: light keys hash,
    heavy keys (``heavy`` (k, p) per-instance flags) spread/broadcast.
    Same row sets as ``dist_semijoin_many``; stats carry the extra
    ``'heavy'`` count of tuple-sends routed through the heavy path."""
    p = spmd.p
    shareds = [[x for x in s.schema if x in r.schema] for s, r in zip(ss, rs)]
    assert all(shareds), "semijoin with no shared attrs in batch"
    # a row reaches each destination at most once, so the worst-case send
    # bucket is the shard cap even for the broadcast side
    c_out = c_out or (ss[0].cap, rs[0].cap)
    sd, sv = _stack(ss)
    rd, rv = _stack(rs)
    sk, rk = (_key_array(ks, spmd) for ks in _pair_keys(ss, rs))
    fmt_s, fmt_r = fmts if fmts is not None else (None, None)
    od, ov, sent, dropped, hvy, ub = spmd.run(
        _hybrid_semijoin_shard_b,
        sd, sv, rd, rv, _seed_array(seeds, spmd), sk, rk,
        _heavy_array(heavy, spmd),
        p=p, c_out_s=c_out[0], c_out_r=c_out[1],
        cap_s=cap_recv[0], cap_r=cap_recv[1], fmt_s=fmt_s, fmt_r=fmt_r, backend=backend,
    )
    return _unstack(od, ov, [s.schema for s in ss]), _per_op_stats(
        spmd, sent, dropped,
        padded_slots(p, c_out[0], ss[0].arity)
        + padded_slots(p, c_out[1], len(shareds[0])),
        heavy=hvy,
        wire_bytes=_xbytes(p, c_out[0], ss[0].arity, fmt_s)
        + _xbytes(p, c_out[1], len(shareds[0]), fmt_r),
        ubytes=ub,
    )


# ----------------------------------------------- hybrid (heavy-hitter) join
def _hybrid_join_shard_b(ad, av, bd, bv, seed, ak, bk, bkeep, hw, *,
                         p, c_out_a, c_out_b, cap_a, cap_b, out_cap, swap,
                         fmt_a=None, fmt_b=None, backend):
    """``_join_shard_b`` with hybrid routing: one side spread, the other
    broadcast for heavy keys (``swap`` picks which).  A heavy pair (a, b)
    meets exactly once — at the unique reducer holding the spread copy;
    light pairs meet at ``hash(key)``; heavy and light keys cannot
    cross-match because heaviness is a function of the key."""
    kcols = tuple(range(ak.shape[-1]))
    a2, a2v, sent_a, dr_a, hvy_a = _hybrid_exchange(
        ad, av, _dests(_take(ad, ak), av, p, seed, backend), hw,
        p=p, c_out=c_out_a, cap_recv=cap_a, spread=not swap, fmt=fmt_a, backend=backend,
    )
    b2, b2v, sent_b, dr_b, hvy_b = _hybrid_exchange(
        bd, bv, _dests(_take(bd, bk), bv, p, seed, backend), hw,
        p=p, c_out=c_out_b, cap_recv=cap_b, spread=swap, fmt=fmt_b, backend=backend,
    )
    ra, rb = dense_ranks(_take(a2, ak), a2v, kcols, _take(b2, bk), b2v, kcols)
    out, out_v, over = local_join_ranked(
        a2, a2v, ra, b2, b2v, rb, bkeep, out_cap, backend
    )
    ub = 4 * (ad.shape[-1] * sent_a + bd.shape[-1] * sent_b)
    return out, out_v, sent_a + sent_b, dr_a + dr_b + over, hvy_a + hvy_b, ub


def hybrid_join_many(
    spmd: SPMD, as_: Sequence[DTable], bs: Sequence[DTable], *,
    seeds: Sequence[int], out_cap: int, heavy: np.ndarray,
    c_out: Optional[Tuple[int, int]] = None,
    cap_recv: Optional[Tuple[int, int]] = None,
    swap: bool = False,
    fmts: Optional[Tuple] = None,  # (fmt_a, fmt_b) or None = dense
    backend: str = "torch",
) -> Tuple[List[DTable], List[Dict]]:
    """k-fold skew-resilient A_i |><| B_i in ONE dispatch; same row sets
    as ``dist_join_many`` with heavy keys routed spread/broadcast.
    ``swap`` (``GroupMeasure.swap_spread``) spreads B and broadcasts A."""
    p = spmd.p
    shareds = [[x for x in a.schema if x in b.schema] for a, b in zip(as_, bs)]
    assert all(shareds), "attribute-disjoint join in batch; use dist_join"
    keeps = [
        tuple(i for i, x in enumerate(b.schema) if x not in set(a.schema))
        for a, b in zip(as_, bs)
    ]
    schemas = [schema_join(a.schema, b.schema) for a, b in zip(as_, bs)]
    c_out = c_out or (as_[0].cap, bs[0].cap)
    cap_recv = cap_recv or (p * as_[0].cap, p * bs[0].cap)
    ad, av = _stack(as_)
    bd, bv = _stack(bs)
    ak, bk = (_key_array(ks, spmd) for ks in _pair_keys(as_, bs))
    fmt_a, fmt_b = fmts if fmts is not None else (None, None)
    od, ov, sent, dropped, hvy, ub = spmd.run(
        _hybrid_join_shard_b,
        ad, av, bd, bv, _seed_array(seeds, spmd), ak, bk,
        _key_array(keeps, spmd), _heavy_array(heavy, spmd),
        p=p, c_out_a=c_out[0], c_out_b=c_out[1],
        cap_a=cap_recv[0], cap_b=cap_recv[1], out_cap=out_cap, swap=swap,
        fmt_a=fmt_a, fmt_b=fmt_b, backend=backend,
    )
    return _unstack(od, ov, schemas), _per_op_stats(
        spmd, sent, dropped,
        padded_slots(p, c_out[0], as_[0].arity)
        + padded_slots(p, c_out[1], bs[0].arity),
        heavy=hvy,
        wire_bytes=_xbytes(p, c_out[0], as_[0].arity, fmt_a)
        + _xbytes(p, c_out[1], bs[0].arity, fmt_b),
        ubytes=ub,
    )


# ----------------------------------------------------------- hash intersect
def _intersect_shard_b(ad, av, bd, bv, seed, bcols, *,
                       p, c_out_a, c_out_b, cap_a, cap_b, fmt_a=None, fmt_b=None,
                       backend):
    acols = tuple(range(ad.shape[-1]))
    adest = _dests(ad, av, p, seed, backend)
    bdest = _dests(_take(bd, bcols), bv, p, seed, backend)
    (a2, a2v, sent_a, dr_a), (b2, b2v, sent_b, dr_b) = _pair_ship(
        ad, av, adest, bd, bv, bdest, p=p, c_out_a=c_out_a, c_out_b=c_out_b,
        cap_a=cap_a, cap_b=cap_b, fmt_a=fmt_a, fmt_b=fmt_b, backend=backend,
    )
    mask = local_semijoin_mask(a2, a2v, acols, _take(b2, bcols), b2v, acols, backend)
    a2 = torch.where(mask.unsqueeze(-1), a2, 0)
    ub = 4 * (ad.shape[-1] * sent_a + bd.shape[-1] * sent_b)
    return a2, mask, sent_a + sent_b, dr_a + dr_b, ub


def dist_intersect_many(
    spmd: SPMD, as_: Sequence[DTable], bs: Sequence[DTable], *,
    seeds: Sequence[int], cap_recv: Tuple[int, int],
    c_out: Optional[Tuple[int, int]] = None,
    fmts: Optional[Tuple] = None,  # (fmt_a, fmt_b) or None = dense
    backend: str = "torch",
) -> Tuple[List[DTable], List[Dict]]:
    """k-fold A_i ^ B_i (same attr sets) in ONE dispatch."""
    p = spmd.p
    for a, b in zip(as_, bs):
        assert set(a.schema) == set(b.schema), (a.schema, b.schema)
    c_out = c_out or (as_[0].cap, bs[0].cap)
    ad, av = _stack(as_)
    bd, bv = _stack(bs)
    bcols = _key_array([b.cols(a.schema) for a, b in zip(as_, bs)], spmd)
    fmt_a, fmt_b = fmts if fmts is not None else (None, None)
    od, ov, sent, dropped, ub = spmd.run(
        _intersect_shard_b,
        ad, av, bd, bv, _seed_array(seeds, spmd), bcols,
        p=p, c_out_a=c_out[0], c_out_b=c_out[1],
        cap_a=cap_recv[0], cap_b=cap_recv[1], fmt_a=fmt_a, fmt_b=fmt_b, backend=backend,
    )
    return _unstack(od, ov, [a.schema for a in as_]), _per_op_stats(
        spmd, sent, dropped,
        padded_slots(p, c_out[0], as_[0].arity)
        + padded_slots(p, c_out[1], bs[0].arity),
        wire_bytes=_xbytes(p, c_out[0], as_[0].arity, fmt_a)
        + _xbytes(p, c_out[1], bs[0].arity, fmt_b),
        ubytes=ub,
    )


# --------------------------------------------------------------- hash dedup
def _dedup_shard_b(d, v, seed, *, p, c_out, cap_recv, fmt=None, backend):
    d2, v2, sent, ds, dr = exchange(
        d, v, _dests(d, v, p, seed, backend), p=p, c_out=c_out, cap_recv=cap_recv,
        fmt=fmt, backend=backend,
    )
    mask = local_dedup_mask(d2, v2, tuple(range(d.shape[-1])))
    d2 = torch.where(mask.unsqueeze(-1), d2, 0)
    return d2, mask, sent, ds + dr


def dist_dedup_many(
    spmd: SPMD, ts: Sequence[DTable], *, seeds: Sequence[int], cap_recv: int,
    c_out: Optional[int] = None, fmt: Optional[WireFormat] = None,
    backend: str = "torch",
) -> Tuple[List[DTable], List[Dict]]:
    p = spmd.p
    c_out = c_out or ts[0].cap
    d, v = _stack(ts)
    od, ov, sent, dropped = spmd.run(
        _dedup_shard_b, d, v, _seed_array(seeds, spmd),
        p=p, c_out=c_out, cap_recv=cap_recv, fmt=fmt, backend=backend,
    )
    return _unstack(od, ov, [t.schema for t in ts]), _per_op_stats(
        spmd, sent, dropped, padded_slots(p, c_out, ts[0].arity),
        wire_bytes=_xbytes(p, c_out, ts[0].arity, fmt),
        # single exchange: useful bytes are 4 * arity * sent
        ubytes=4 * ts[0].arity * sent,
    )


# ---------------------------------------------- grid semijoin (Lemma 10)
def _grid_semijoin_mark_b(sd, sv, rd, rv, sk, rk, *,
                          g_s, g_r, s_cap, r_cap, p, c_out_s, c_out_r,
                          cap_s, cap_r, fmt_s=None, fmt_r=None, backend):
    """Round 1 of Lemma 10 for every instance of the group: S by position
    to its g_r cells, R's deduplicated key projection by position to its
    g_s cells, then each cell marks its S rows matched by its R block."""
    nk = rk.shape[-1]
    kcols = tuple(range(nk))
    grp_s = _position_groups(sv, g_s, s_cap, p)
    dest_s = _grid_dests(grp_s, g_s, g_r, range(g_r), p)
    s2, s2v, sent_s, dss, drs = exchange_multi(
        sd, sv, dest_s, p=p, c_out=c_out_s, cap_recv=cap_s, fmt=fmt_s, backend=backend
    )
    rkeys = _take(rd, rk)
    rkv = local_dedup_mask(rkeys, rv, kcols)
    rkeys = torch.where(rkv.unsqueeze(-1), rkeys, 0)
    grp_r = _position_groups(rkv, g_r, r_cap, p)
    dest_r = _grid_dests(grp_r, g_r, 1, [c * g_r for c in range(g_s)], p)
    r2, r2v, sent_r, dsr, drr = exchange_multi(
        rkeys, rkv, dest_r, p=p, c_out=c_out_r, cap_recv=cap_r, fmt=fmt_r, backend=backend
    )
    mask = local_semijoin_mask(_take(s2, sk), s2v, kcols, r2, r2v, kcols, backend)
    s2 = torch.where(mask.unsqueeze(-1), s2, 0)
    ub = 4 * (sd.shape[-1] * sent_s + nk * sent_r)
    return s2, mask, sent_s + sent_r, dss + drs + dsr + drr, ub


def grid_semijoin_many(
    spmd: SPMD,
    ss: Sequence[DTable],
    rs: Sequence[DTable],
    *,
    seeds: Sequence[int],
    out_cap: int,
    c_out: Optional[Tuple[int, int]] = None,
    cap_recv: Optional[Tuple[int, int]] = None,
    fmts: Optional[Tuple] = None,  # (fmt_s, fmt_rkeys) or None = dense
    backend: str = "torch",
) -> Tuple[List[DTable], List[Dict]]:
    """k-fold Lemma-10 grid semijoin: one MARK dispatch for the whole group
    + one batched hash-dedup dispatch for the marked duplicates (2 claimed
    BSP rounds either way).  ``c_out``/``cap_recv`` (per (S, R-keys) side)
    override the worst-case mark-stage capacities with calibrated ones
    (``measure_grid_semijoin_many``)."""
    p = spmd.p
    s0, r0 = ss[0], rs[0]
    shareds = [[x for x in s.schema if x in r.schema] for s, r in zip(ss, rs)]
    assert all(shareds)
    sz_s, sz_r = s0.cap * p, r0.cap * p
    g_s, g_r = _grid_shares([sz_s, sz_r], p)
    c_out = c_out or (s0.cap * g_r, r0.cap * g_s)
    cap_recv = cap_recv or (-(-sz_s // g_s), -(-sz_r // g_r))
    sd, sv = _stack(ss)
    rd, rv = _stack(rs)
    sk = _key_array([s.cols(sh) for s, sh in zip(ss, shareds)], spmd)
    rk = _key_array([r.cols(sh) for r, sh in zip(rs, shareds)], spmd)
    fmt_s, fmt_r = fmts if fmts is not None else (None, None)
    md, mv, sent, dropped, ub = spmd.run(
        _grid_semijoin_mark_b,
        sd, sv, rd, rv, sk, rk,
        g_s=g_s, g_r=g_r, s_cap=s0.cap, r_cap=r0.cap, p=p,
        c_out_s=c_out[0], c_out_r=c_out[1],
        cap_s=cap_recv[0], cap_r=cap_recv[1], fmt_s=fmt_s, fmt_r=fmt_r, backend=backend,
    )
    marked = _unstack(md, mv, [s.schema for s in ss])
    mark_stats = _per_op_stats(
        spmd, sent, dropped,
        padded_slots(p, c_out[0], s0.arity)
        + padded_slots(p, c_out[1], len(shareds[0])),
        wire_bytes=_xbytes(p, c_out[0], s0.arity, fmt_s)
        + _xbytes(p, c_out[1], len(shareds[0]), fmt_r),
        ubytes=ub,
    )
    ded, ded_stats = dist_dedup_many(
        spmd, marked, seeds=[s + 7 for s in seeds],
        c_out=marked[0].cap, cap_recv=out_cap, fmt=fmt_s, backend=backend,
    )
    return ded, [_sum_stats(m, d) for m, d in zip(mark_stats, ded_stats)]


def _sum_stats(*parts: Dict[str, int]) -> Dict[str, int]:
    return {
        key: sum(st.get(key, 0) for st in parts)
        for key in ("sent", "dropped", "padded", "wire_bytes", "ubytes")
    }


# -------------------------------------------------- grid join (Lemma 8, w=2)
def _local_join_shard_b(ad, av, bd, bv, ak, bk, bkeep, *, out_cap, backend):
    kcols = tuple(range(ak.shape[-1]))
    ra, rb = dense_ranks(_take(ad, ak), av, kcols, _take(bd, bk), bv, kcols)
    out, out_v, over = local_join_ranked(ad, av, ra, bd, bv, rb, bkeep, out_cap, backend)
    return out, out_v, torch.zeros_like(over), over


def grid_join_many(
    spmd: SPMD,
    as_: Sequence[DTable],
    bs: Sequence[DTable],
    *,
    out_cap: int,
    c_out: Optional[Tuple[int, int]] = None,
    cap_recv: Optional[Tuple[int, int]] = None,
    fmts: Optional[Tuple] = None,  # (fmt_a, fmt_b) or None = dense
    backend: str = "torch",
) -> Tuple[List[DTable], List[Dict]]:
    """k-fold Lemma-8 grid join (w=2): two batched position-group send
    dispatches + one batched local-join dispatch — one claimed BSP round.
    ``c_out``/``cap_recv`` (per (A, B) relation) override the worst-case
    send capacities with calibrated ones (``measure_grid_join_many``)."""
    p = spmd.p
    a0, b0 = as_[0], bs[0]
    g = _grid_shares([a0.cap * p, b0.cap * p], p)
    # mixed-radix grid: table 0 strides by g[1], table 1 strides by 1
    strides = [g[1], 1]
    plans = [
        # (g_self, stride, offsets over the OTHER dim)
        (g[0], strides[0], tuple(c * strides[1] for c in range(g[1]))),
        (g[1], strides[1], tuple(c * strides[0] for c in range(g[0]))),
    ]
    parts = []
    send_stats = []
    for i, (tables, (g_self, stride, offs)) in enumerate(zip((as_, bs), plans)):
        t0 = tables[0]
        d, v = _stack(tables)
        co = c_out[i] if c_out else t0.cap * (g[0] * g[1] // g_self)
        cr = cap_recv[i] if cap_recv else -(-(p * t0.cap) // g_self)
        fmt = fmts[i] if fmts is not None else None
        rd, rv, stats = spmd.run(
            _grid_send_one, d, v,
            g_self=g_self, stride=stride, offsets=offs, p=p, cap=t0.cap,
            c_out=co, cap_recv=cr, fmt=fmt, backend=backend,
        )
        parts.append((rd, rv))
        send_stats.append(_per_op_stats(
            spmd, stats["sent"], stats["dropped"], padded_slots(p, co, t0.arity),
            wire_bytes=_xbytes(p, co, t0.arity, fmt), ubytes=stats["ubytes"],
        ))
    shareds = [[x for x in a.schema if x in b.schema] for a, b in zip(as_, bs)]
    keeps = [
        tuple(i for i, x in enumerate(b.schema) if x not in set(a.schema))
        for a, b in zip(as_, bs)
    ]
    schemas = [schema_join(a.schema, b.schema) for a, b in zip(as_, bs)]
    ak = _key_array([a.cols(sh) for a, sh in zip(as_, shareds)], spmd)
    bk = _key_array([b.cols(sh) for b, sh in zip(bs, shareds)], spmd)
    bkeep = _key_array(keeps, spmd)
    (ad, av), (bd, bv) = parts
    od, ov, sent_j, over = spmd.run(
        _local_join_shard_b, ad, av, bd, bv, ak, bk, bkeep,
        out_cap=out_cap, backend=backend,
    )
    join_stats = _per_op_stats(spmd, sent_j, over)
    return _unstack(od, ov, schemas), [
        _sum_stats(sa, sb, sj) for sa, sb, sj in zip(send_stats[0], send_stats[1], join_stats)
    ]
