"""Batched ("round-fused") distributed operators — hash and grid paths.

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

Hash-path and grid-path batched ops give bit-identical results (and
identical ``sent``/``dropped`` stats) to ``repro.relational.batched``
given the same seeds and capacities.  The grid paths (Lemma 8 joins and
Lemma 10 semijoins) route by position, so their pre-passes need no
seeds.

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
    exchange_multi,
    padded_slots,
    pow2,
)
from .skew import DEFAULT_SKEW_THRESHOLD, heavy_dest_flags_many
from .spmd import SPMD
from .table import DTable, schema_join
from .wire import count_wire_bytes, dense_wire_bytes


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


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


def _key_array(keys: Sequence[Sequence[int]], p: int, device) -> torch.Tensor:
    """Per-instance key column indices as a (p, k, n_keys) tensor."""
    assert len({len(k) for k in keys}) == 1, "key-column count must be uniform"
    ks = np.asarray([list(k) for k in keys], np.int64).reshape(len(keys), -1)
    return torch.from_numpy(ks).to(device).expand((p,) + ks.shape)


def _seed_array(seeds: Sequence[int], p: int, device) -> torch.Tensor:
    s = torch.tensor([int(x) & 0xFFFFFFFF for x in seeds], dtype=torch.int64)
    return s.to(device).expand(p, len(seeds))


def _per_op_stats(
    sent, dropped, padded: int = 0, wire_bytes: int = 0, ubytes=None,
) -> List[Dict[str, int]]:
    """(p, k) shard stats -> one {'sent','dropped','padded',...} dict per
    instance; ``padded``/``wire_bytes`` (statics of the dispatch) are
    identical across the group's instances."""
    s = _host(sent).sum(axis=0)
    d = _host(dropped).sum(axis=0)
    out = [
        {
            "sent": int(a),
            "dropped": int(b),
            "padded": int(padded),
            "wire_bytes": int(wire_bytes),
        }
        for a, b in zip(s, d)
    ]
    if ubytes is not None:
        for st, u in zip(out, _host(ubytes).sum(axis=0)):
            st["ubytes"] = int(u)
    return out


# --------------------------------------------------- calibration pre-passes
@dataclasses.dataclass(frozen=True)
class SideCaps:
    """Tight pow2 capacities for ONE exchange side: ``c_out`` (per-
    destination send bucket) and ``cap_recv`` (post-all_to_all compact)."""

    c_out: int
    cap_recv: int

    @staticmethod
    def from_counts(out_counts, recv_tot) -> "SideCaps":
        return SideCaps(
            pow2(max(1, int(_host(out_counts).max()))),
            pow2(max(1, int(_host(recv_tot).max()))),
        )


@dataclasses.dataclass(frozen=True)
class GroupMeasure:
    """What one count-only pre-pass learned about an op group.

    ``lhs``/``rhs``: per-side tight capacities (max over the group's k
    instances).  ``out_recv``: the receive requirement of the exchange
    whose buffer IS the op's output (semijoin S side, intersect A side,
    dedup).  ``out_need``: exact join-output requirement (hash joins).
    ``padded``/``wire_bytes``: cells and bytes the pre-pass itself
    shipped, charged to the ledger.  ``n_heavy``: destinations the
    counts flagged heavy (diagnostics; skewed measures are never cached).
    ``hybrid_routed`` stays False until the hybrid engine is ported."""

    lhs: SideCaps
    rhs: Optional[SideCaps] = None
    out_recv: Optional[int] = None
    out_need: Optional[int] = None
    padded: int = 0
    wire_bytes: int = 0
    n_heavy: int = 0
    hybrid_routed: bool = False


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


def _join_count_shard_b(ad, av, bd, bv, seed, ak, bk, *,
                        p, c_out_a, c_out_b, cap_a, cap_b, backend):
    """Keys-only exchange at the ALREADY-CALIBRATED tight capacities,
    then the exact per-shard join output count."""
    akeys = _take(ad, ak)
    da = _dests(akeys, av, p, seed, backend)
    bkeys = _take(bd, bk)
    db = _dests(bkeys, bv, p, seed, backend)
    kc = tuple(range(ak.shape[-1]))
    a2, a2v, *_ = exchange(akeys, av, da, p=p, c_out=c_out_a, cap_recv=cap_a)
    b2, b2v, *_ = exchange(bkeys, bv, db, p=p, c_out=c_out_b, cap_recv=cap_b)
    return local_join_count(a2, a2v, b2, b2v, kc, kc, backend)


def _finalize_pair_counts(
    oa_np: np.ndarray, ra, ob_np: np.ndarray, rb, *, p: int,
    count_padded: int, count_bytes: int = 0,
    skew_threshold: float = DEFAULT_SKEW_THRESHOLD,
) -> GroupMeasure:
    """Host-side tail shared by the per-group pair measure and the
    combined round pre-pass: tight pow2 caps per side plus the free
    heavy-destination detection (the hash is key-consistent across both
    sides, so overload on EITHER side flags the destination)."""
    heavy = heavy_dest_flags_many(oa_np, p, skew_threshold) | heavy_dest_flags_many(
        ob_np, p, skew_threshold
    )
    return GroupMeasure(
        lhs=SideCaps.from_counts(oa_np, ra),
        rhs=SideCaps.from_counts(ob_np, rb),
        out_recv=None,
        padded=count_padded,
        wire_bytes=count_bytes,
        n_heavy=int(heavy.sum()),
    )


def _measure_pair_many(
    spmd: SPMD, as_, bs, a_keys, b_keys, seeds, *, dedup_b: bool,
    backend: str = "torch", skew_threshold: float = DEFAULT_SKEW_THRESHOLD,
) -> GroupMeasure:
    p, dev = spmd.p, spmd.device
    ad, av = _stack(as_)
    bd, bv = _stack(bs)
    oa, ra, ob, rb = spmd.run(
        _measure_pair_shard_b,
        ad, av, bd, bv, _seed_array(seeds, p, dev),
        _key_array(a_keys, p, dev), _key_array(b_keys, p, dev),
        p=p, dedup_b=dedup_b, backend=backend, measure=True,
    )
    return _finalize_pair_counts(
        _host(oa), _host(ra), _host(ob), _host(rb), p=p,
        count_padded=2 * len(as_) * p * p,  # two (p,)-int count vectors each
        count_bytes=count_wire_bytes(p, 2 * len(as_)),
        skew_threshold=skew_threshold,
    )


def measure_semijoin_many(
    spmd: SPMD, ss, rs, *, seeds, backend: str = "torch",
    skew_threshold: float = DEFAULT_SKEW_THRESHOLD,
) -> GroupMeasure:
    """Pre-pass of ``dist_semijoin_many``: S side raw, R side the
    deduplicated key projection — the S receive count bounds the output."""
    shareds = [[x for x in s.schema if x in r.schema] for s, r in zip(ss, rs)]
    s_keys = [s.cols(sh) for s, sh in zip(ss, shareds)]
    r_keys = [r.cols(sh) for r, sh in zip(rs, shareds)]
    m = _measure_pair_many(
        spmd, ss, rs, s_keys, r_keys, seeds, dedup_b=True, backend=backend,
        skew_threshold=skew_threshold,
    )
    return finish_semijoin_measure(m)


def finish_semijoin_measure(m: GroupMeasure) -> GroupMeasure:
    """Tail of the semijoin pre-pass given pair counts ``m`` from ANY
    source (the per-group dispatch or one slice of ``RoundCounts``): the S
    receive count bounds the output."""
    return dataclasses.replace(m, out_recv=m.lhs.cap_recv)


def measure_join_many(
    spmd: SPMD, as_, bs, *, seeds, backend: str = "torch",
    skew_threshold: float = DEFAULT_SKEW_THRESHOLD,
) -> GroupMeasure:
    """Pre-pass of ``dist_join_many``: the count dispatch (tight shuffle
    capacities), then a keys-only exchange AT those capacities whose
    exact output count pre-sizes ``out_need`` — both priced into
    ``padded``."""
    p, dev = spmd.p, spmd.device
    shareds = [[x for x in a.schema if x in b.schema] for a, b in zip(as_, bs)]
    a_keys = [a.cols(sh) for a, sh in zip(as_, shareds)]
    b_keys = [b.cols(sh) for b, sh in zip(bs, shareds)]
    m = _measure_pair_many(
        spmd, as_, bs, a_keys, b_keys, seeds, dedup_b=False, backend=backend,
        skew_threshold=skew_threshold,
    )
    k, nk = len(as_), len(a_keys[0])
    ad, av = _stack(as_)
    bd, bv = _stack(bs)
    cnt = spmd.run(
        _join_count_shard_b,
        ad, av, bd, bv, _seed_array(seeds, p, dev),
        _key_array(a_keys, p, dev), _key_array(b_keys, p, dev),
        p=p, c_out_a=m.lhs.c_out, c_out_b=m.rhs.c_out,
        cap_a=m.lhs.cap_recv, cap_b=m.rhs.cap_recv, backend=backend,
        measure=True,
    )
    return dataclasses.replace(
        m,
        out_need=pow2(max(1, int(_host(cnt).max()))),
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
    p, dev = spmd.p, spmd.device
    d, v = _stack(ts)
    cols = _key_array([tuple(range(t.arity)) for t in ts], p, dev)
    o, r = spmd.run(
        _measure_one_shard_b, d, v, _seed_array(seeds, p, dev), cols,
        p=p, backend=backend, measure=True,
    )
    caps = SideCaps.from_counts(o, r)
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


def _grid_measure(oa, ra, ob, rb, k: int, p: int) -> GroupMeasure:
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
    g = _grid_shares([a0.cap * a0.p, b0.cap * b0.p], p)
    oa, ra, ob, rb = spmd.run(
        _grid_measure_shard_b, _stack_valid(as_), _stack_valid(bs),
        plan=_grid_pair_plan(g[0], g[1], a0.cap, b0.cap), p=p, measure=True,
    )
    return _grid_measure(oa, ra, ob, rb, len(as_), p)


def measure_grid_semijoin_many(spmd: SPMD, ss, rs) -> GroupMeasure:
    """Pre-pass of ``grid_semijoin_many``'s mark stage (the trailing hash
    dedup keeps its managed capacity — its input is the mark output, which
    does not exist yet)."""
    p, dev = spmd.p, spmd.device
    s0, r0 = ss[0], rs[0]
    g_s, g_r = _grid_shares([s0.cap * s0.p, r0.cap * r0.p], p)
    shareds = [[x for x in s.schema if x in r.schema] for s, r in zip(ss, rs)]
    rd, rv = _stack(rs)  # R's key projection needs the data; S only its mask
    rk = _key_array([r.cols(sh) for r, sh in zip(rs, shareds)], p, dev)
    oa, ra, ob, rb = spmd.run(
        _grid_measure_rkeys_shard_b, _stack_valid(ss), rd, rv, rk,
        plan=_grid_pair_plan(g_s, g_r, s0.cap, r0.cap), p=p, measure=True,
    )
    return _grid_measure(oa, ra, ob, rb, len(ss), p)


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
    p, dev = spmd.p, spmd.device
    ad, av = _stack(as_)
    bd, bv = _stack(bs)
    k = len(as_)
    return MeasureSpec(
        tag="pair",
        entry=("pair", k, bool(dedup_b)),
        arrays=(
            ad, av, bd, bv, _seed_array(seeds, p, dev),
            _key_array(a_keys, p, dev), _key_array(b_keys, p, dev),
        ),
        k=k, rows=2 * k, count_padded=2 * k * p * p,
        count_bytes=count_wire_bytes(p, 2 * k),
        skew_threshold=skew_threshold,
    )


def join_pair_measure_spec(
    spmd: SPMD, as_, bs, a_keys, b_keys, seeds, *,
    g_a: int, g_b: int, skew_threshold: float = DEFAULT_SKEW_THRESHOLD,
) -> MeasureSpec:
    """Hash join pre-pass with the output count FUSED into the same
    dispatch: besides both sides' exchange counts, the program ships a
    single hashed-key column per side at the STATIC guess capacities
    ``g_a``/``g_b`` and counts the join output per destination.  The
    fetched counts prove post hoc whether the guess held; ``_finalize_spec``
    only trusts the fused count when it did."""
    p, dev = spmd.p, spmd.device
    ad, av = _stack(as_)
    bd, bv = _stack(bs)
    k = len(as_)
    # count vectors + the two hashed-key (width 1) dense exchanges
    pad = 2 * k * p * p + k * p * p * (g_a + g_b)
    byt = count_wire_bytes(p, 2 * k) + k * (
        dense_wire_bytes(p, g_a, 1) + dense_wire_bytes(p, g_b, 1)
    )
    return MeasureSpec(
        tag="join_pair",
        entry=("join_pair", k, g_a, g_b),
        arrays=(
            ad, av, bd, bv, _seed_array(seeds, p, dev),
            _key_array(a_keys, p, dev), _key_array(b_keys, p, dev),
        ),
        k=k, rows=2 * k, count_padded=pad, count_bytes=byt,
        skew_threshold=skew_threshold, join_rows=k,
    )


def single_measure_spec(spmd: SPMD, ts, seeds) -> MeasureSpec:
    """Full-row-key single exchange counts (dedup pre-pass)."""
    p, dev = spmd.p, spmd.device
    d, v = _stack(ts)
    cols = _key_array([tuple(range(t.arity)) for t in ts], p, dev)
    k = len(ts)
    return MeasureSpec(
        tag="single",
        entry=("single", k),
        arrays=(d, v, _seed_array(seeds, p, dev), cols),
        k=k, rows=k, count_padded=k * p * p,
        count_bytes=count_wire_bytes(p, k),
    )


def grid_pair_measure_spec(spmd: SPMD, as_, bs) -> MeasureSpec:
    """Positional grid join send counts (seedless, exact)."""
    p = spmd.p
    a0, b0 = as_[0], bs[0]
    g = _grid_shares([a0.cap * a0.p, b0.cap * b0.p], p)
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
    p, dev = spmd.p, spmd.device
    s0, r0 = ss[0], rs[0]
    g_s, g_r = _grid_shares([s0.cap * s0.p, r0.cap * r0.p], p)
    shareds = [[x for x in s.schema if x in r.schema] for s, r in zip(ss, rs)]
    rd, rv = _stack(rs)
    rk = _key_array([r.cols(sh) for r, sh in zip(rs, shareds)], p, dev)
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
            _, k, g_a, g_b = e
            ad, av, bd, bv, seed, ak, bk = arrays[i: i + 7]
            i += 7
            akeys = _take(ad, ak)
            da = _dests(akeys, av, p, seed, backend)
            bkeys = _take(bd, bk)
            db = _dests(bkeys, bv, p, seed, backend)
            # a single hashed-key column stands in for the nk-wide key
            # projection: the count can only over-count — a sound out_need
            sa = _hashed_key(akeys, seed)
            sb = _hashed_key(bkeys, seed)
            a2, a2v, *_ = exchange(sa, av, da, p=p, c_out=g_a, cap_recv=p * g_a)
            b2, b2v, *_ = exchange(sb, bv, db, p=p, c_out=g_b, cap_recv=p * g_b)
            jc = local_join_count(a2, a2v, b2, b2v, (0,), (0,), backend)
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
    recv = cnts.permute(2, 1, 0)  # all_to_all on the count-vector axis
    if jblocks:
        jcnt = torch.cat(jblocks, dim=1)
    else:
        jcnt = torch.zeros((p, 0), dtype=torch.int64, device=cnts.device)
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
        _, _, g_a, g_b = spec.entry
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
            self._host = (_host(self._cnts), _host(self._recv), _host(self._jcnt))
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
        _, k, coa, cob, ca, cb = e
        ad, av, bd, bv, seed, ak, bk = arrays[i: i + 7]
        i += 7
        outs.append(_join_count_shard_b(
            ad, av, bd, bv, seed, ak, bk, p=p, c_out_a=coa, c_out_b=cob,
            cap_a=ca, cap_b=cb, backend=backend,
        ))
    return torch.cat(outs, dim=1)  # (p, sum_k)


def join_need_many(spmd: SPMD, items, *, backend: str = "torch") -> List[GroupMeasure]:
    """ONE dispatch computing the exact join-output requirement for EVERY
    join group of a round stage; each returned measure carries
    ``out_need`` with the keys-only exchange priced into ``padded``."""
    p, dev = spmd.p, spmd.device
    arrays: List[torch.Tensor] = []
    entries = []
    nks = []
    for as_, bs, seeds, m in items:
        shareds = [[x for x in a.schema if x in b.schema] for a, b in zip(as_, bs)]
        a_keys = [a.cols(sh) for a, sh in zip(as_, shareds)]
        b_keys = [b.cols(sh) for b, sh in zip(bs, shareds)]
        nks.append(len(a_keys[0]))
        ad, av = _stack(as_)
        bd, bv = _stack(bs)
        entries.append((
            "hash", len(as_), m.lhs.c_out, m.rhs.c_out,
            m.lhs.cap_recv, m.rhs.cap_recv,
        ))
        arrays.extend((
            ad, av, bd, bv, _seed_array(seeds, p, dev),
            _key_array(a_keys, p, dev), _key_array(b_keys, p, dev),
        ))
    cnt = _host(spmd.run(
        _join_need_round_shard, *arrays,
        entries=tuple(entries), p=p, backend=backend, measure=True,
    ))  # (p, sum_k)
    out = []
    off = 0
    for (as_, bs, seeds, m), e, nk in zip(items, entries, nks):
        k = e[1]
        c = cnt[:, off: off + k]
        off += k
        out.append(dataclasses.replace(
            m,
            out_need=pow2(max(1, int(c.max()))),
            padded=m.padded + k * (
                padded_slots(p, m.lhs.c_out, nk) + padded_slots(p, m.rhs.c_out, nk)
            ),
            wire_bytes=m.wire_bytes + k * (
                dense_wire_bytes(p, m.lhs.c_out, nk)
                + dense_wire_bytes(p, m.rhs.c_out, nk)
            ),
        ))
    return out


# ------------------------------------------------------------ hash semijoin
def _semijoin_shard_b(sd, sv, rd, rv, seed, sk, rk, *,
                      p, c_out_s, c_out_r, cap_s, cap_r, backend):
    nk = rk.shape[-1]
    kcols = tuple(range(nk))
    # ship only the deduplicated key projection of R (S |>< R = S |><
    # pi_{S&R}(R)), as in Sec. 4.1
    rkeys = _take(rd, rk)
    rkv = local_dedup_mask(rkeys, rv, kcols)
    rkeys = torch.where(rkv.unsqueeze(-1), rkeys, 0)
    rdest = _dests(rkeys, rkv, p, seed, backend)
    sdest = _dests(_take(sd, sk), sv, p, seed, backend)
    rk2, rkv2, sent_r, dsr, drr = exchange(rkeys, rkv, rdest, p=p, c_out=c_out_r, cap_recv=cap_r)
    s2, s2v, sent_s, dss, drs = exchange(sd, sv, sdest, p=p, c_out=c_out_s, cap_recv=cap_s)
    rkv2 = local_dedup_mask(rk2, rkv2, kcols)
    mask = local_semijoin_mask(_take(s2, sk), s2v, kcols, rk2, rkv2, kcols, backend)
    s2 = torch.where(mask.unsqueeze(-1), s2, 0)
    ub = 4 * (nk * sent_r + sd.shape[-1] * sent_s)  # dense int32 bytes occupied
    return s2, mask, sent_r + sent_s, dsr + drr + dss + drs, ub


def dist_semijoin_many(
    spmd: SPMD, ss: Sequence[DTable], rs: Sequence[DTable], *,
    seeds: Sequence[int], cap_recv: Tuple[int, int],
    c_out: Optional[Tuple[int, int]] = None, backend: str = "torch",
) -> Tuple[List[DTable], List[Dict]]:
    """k-fold S_i |>< R_i in ONE dispatch."""
    p, dev = spmd.p, spmd.device
    shareds = [[x for x in s.schema if x in r.schema] for s, r in zip(ss, rs)]
    assert all(shareds), "semijoin with no shared attrs in batch"
    c_out = c_out or (ss[0].cap, rs[0].cap)
    sd, sv = _stack(ss)
    rd, rv = _stack(rs)
    sk = _key_array([s.cols(sh) for s, sh in zip(ss, shareds)], p, dev)
    rk = _key_array([r.cols(sh) for r, sh in zip(rs, shareds)], p, dev)
    od, ov, sent, dropped, ub = spmd.run(
        _semijoin_shard_b,
        sd, sv, rd, rv, _seed_array(seeds, p, dev), sk, rk,
        p=p, c_out_s=c_out[0], c_out_r=c_out[1],
        cap_s=cap_recv[0], cap_r=cap_recv[1], backend=backend,
    )
    return _unstack(od, ov, [s.schema for s in ss]), _per_op_stats(
        sent, dropped,
        # S ships full rows; R ships its deduplicated key projection
        padded_slots(p, c_out[0], ss[0].arity)
        + padded_slots(p, c_out[1], len(shareds[0])),
        wire_bytes=dense_wire_bytes(p, c_out[0], ss[0].arity)
        + dense_wire_bytes(p, c_out[1], len(shareds[0])),
        ubytes=ub,
    )


# ---------------------------------------------------------------- hash join
def _join_shard_b(ad, av, bd, bv, seed, ak, bk, bkeep, *,
                  p, c_out_a, c_out_b, cap_a, cap_b, out_cap, backend):
    nk = ak.shape[-1]
    kcols = tuple(range(nk))
    adest = _dests(_take(ad, ak), av, p, seed, backend)
    bdest = _dests(_take(bd, bk), bv, p, seed, backend)
    a2, a2v, sent_a, dsa, dra = exchange(ad, av, adest, p=p, c_out=c_out_a, cap_recv=cap_a)
    b2, b2v, sent_b, dsb, drb = exchange(bd, bv, bdest, p=p, c_out=c_out_b, cap_recv=cap_b)
    ra, rb = dense_ranks(_take(a2, ak), a2v, kcols, _take(b2, bk), b2v, kcols)
    out, out_v, over = local_join_ranked(
        a2, a2v, ra, b2, b2v, rb, bkeep, out_cap, backend
    )
    ub = 4 * (ad.shape[-1] * sent_a + bd.shape[-1] * sent_b)
    return out, out_v, sent_a + sent_b, dsa + dra + dsb + drb + over, ub


def dist_join_many(
    spmd: SPMD, as_: Sequence[DTable], bs: Sequence[DTable], *,
    seeds: Sequence[int], out_cap: int,
    c_out: Optional[Tuple[int, int]] = None,
    cap_recv: Optional[Tuple[int, int]] = None,
    backend: str = "torch",
) -> Tuple[List[DTable], List[Dict]]:
    """k-fold A_i |><| B_i in ONE dispatch."""
    p, dev = spmd.p, spmd.device
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
    ak = _key_array([a.cols(sh) for a, sh in zip(as_, shareds)], p, dev)
    bk = _key_array([b.cols(sh) for b, sh in zip(bs, shareds)], p, dev)
    bkeep = _key_array(keeps, p, dev)
    od, ov, sent, dropped, ub = spmd.run(
        _join_shard_b,
        ad, av, bd, bv, _seed_array(seeds, p, dev), ak, bk, bkeep,
        p=p, c_out_a=c_out[0], c_out_b=c_out[1],
        cap_a=cap_recv[0], cap_b=cap_recv[1], out_cap=out_cap, backend=backend,
    )
    return _unstack(od, ov, schemas), _per_op_stats(
        sent, dropped,
        padded_slots(p, c_out[0], as_[0].arity)
        + padded_slots(p, c_out[1], bs[0].arity),
        wire_bytes=dense_wire_bytes(p, c_out[0], as_[0].arity)
        + dense_wire_bytes(p, c_out[1], bs[0].arity),
        ubytes=ub,
    )


# ----------------------------------------------------------- hash intersect
def _intersect_shard_b(ad, av, bd, bv, seed, bcols, *,
                       p, c_out_a, c_out_b, cap_a, cap_b, backend):
    acols = tuple(range(ad.shape[-1]))
    adest = _dests(ad, av, p, seed, backend)
    bdest = _dests(_take(bd, bcols), bv, p, seed, backend)
    a2, a2v, sent_a, dsa, dra = exchange(ad, av, adest, p=p, c_out=c_out_a, cap_recv=cap_a)
    b2, b2v, sent_b, dsb, drb = exchange(bd, bv, bdest, p=p, c_out=c_out_b, cap_recv=cap_b)
    mask = local_semijoin_mask(a2, a2v, acols, _take(b2, bcols), b2v, acols, backend)
    a2 = torch.where(mask.unsqueeze(-1), a2, 0)
    ub = 4 * (ad.shape[-1] * sent_a + bd.shape[-1] * sent_b)
    return a2, mask, sent_a + sent_b, dsa + dra + dsb + drb, ub


def dist_intersect_many(
    spmd: SPMD, as_: Sequence[DTable], bs: Sequence[DTable], *,
    seeds: Sequence[int], cap_recv: Tuple[int, int],
    c_out: Optional[Tuple[int, int]] = None, backend: str = "torch",
) -> Tuple[List[DTable], List[Dict]]:
    """k-fold A_i ^ B_i (same attr sets) in ONE dispatch."""
    p, dev = spmd.p, spmd.device
    for a, b in zip(as_, bs):
        assert set(a.schema) == set(b.schema), (a.schema, b.schema)
    c_out = c_out or (as_[0].cap, bs[0].cap)
    ad, av = _stack(as_)
    bd, bv = _stack(bs)
    bcols = _key_array([b.cols(a.schema) for a, b in zip(as_, bs)], p, dev)
    od, ov, sent, dropped, ub = spmd.run(
        _intersect_shard_b,
        ad, av, bd, bv, _seed_array(seeds, p, dev), bcols,
        p=p, c_out_a=c_out[0], c_out_b=c_out[1],
        cap_a=cap_recv[0], cap_b=cap_recv[1], backend=backend,
    )
    return _unstack(od, ov, [a.schema for a in as_]), _per_op_stats(
        sent, dropped,
        padded_slots(p, c_out[0], as_[0].arity)
        + padded_slots(p, c_out[1], bs[0].arity),
        wire_bytes=dense_wire_bytes(p, c_out[0], as_[0].arity)
        + dense_wire_bytes(p, c_out[1], bs[0].arity),
        ubytes=ub,
    )


# --------------------------------------------------------------- hash dedup
def _dedup_shard_b(d, v, seed, *, p, c_out, cap_recv, backend):
    d2, v2, sent, ds, dr = exchange(
        d, v, _dests(d, v, p, seed, backend), p=p, c_out=c_out, cap_recv=cap_recv
    )
    mask = local_dedup_mask(d2, v2, tuple(range(d.shape[-1])))
    d2 = torch.where(mask.unsqueeze(-1), d2, 0)
    return d2, mask, sent, ds + dr


def dist_dedup_many(
    spmd: SPMD, ts: Sequence[DTable], *, seeds: Sequence[int], cap_recv: int,
    c_out: Optional[int] = None, backend: str = "torch",
) -> Tuple[List[DTable], List[Dict]]:
    p, dev = spmd.p, spmd.device
    c_out = c_out or ts[0].cap
    d, v = _stack(ts)
    od, ov, sent, dropped = spmd.run(
        _dedup_shard_b, d, v, _seed_array(seeds, p, dev),
        p=p, c_out=c_out, cap_recv=cap_recv, backend=backend,
    )
    return _unstack(od, ov, [t.schema for t in ts]), _per_op_stats(
        sent, dropped, padded_slots(p, c_out, ts[0].arity),
        wire_bytes=dense_wire_bytes(p, c_out, ts[0].arity),
        # single exchange: useful bytes are 4 * arity * sent, host-side
        ubytes=4 * ts[0].arity * _host(sent),
    )


# ---------------------------------------------- grid semijoin (Lemma 10)
def _grid_semijoin_mark_b(sd, sv, rd, rv, sk, rk, *,
                          g_s, g_r, s_cap, r_cap, p, c_out_s, c_out_r,
                          cap_s, cap_r, backend):
    """Round 1 of Lemma 10 for every instance of the group: S by position
    to its g_r cells, R's deduplicated key projection by position to its
    g_s cells, then each cell marks its S rows matched by its R block."""
    nk = rk.shape[-1]
    kcols = tuple(range(nk))
    grp_s = _position_groups(sv, g_s, s_cap, p)
    dest_s = _grid_dests(grp_s, g_s, g_r, range(g_r), p)
    s2, s2v, sent_s, dss, drs = exchange_multi(
        sd, sv, dest_s, p=p, c_out=c_out_s, cap_recv=cap_s
    )
    rkeys = _take(rd, rk)
    rkv = local_dedup_mask(rkeys, rv, kcols)
    rkeys = torch.where(rkv.unsqueeze(-1), rkeys, 0)
    grp_r = _position_groups(rkv, g_r, r_cap, p)
    dest_r = _grid_dests(grp_r, g_r, 1, [c * g_r for c in range(g_s)], p)
    r2, r2v, sent_r, dsr, drr = exchange_multi(
        rkeys, rkv, dest_r, p=p, c_out=c_out_r, cap_recv=cap_r
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
    backend: str = "torch",
) -> Tuple[List[DTable], List[Dict]]:
    """k-fold Lemma-10 grid semijoin: one MARK dispatch for the whole group
    + one batched hash-dedup dispatch for the marked duplicates (2 claimed
    BSP rounds either way).  ``c_out``/``cap_recv`` (per (S, R-keys) side)
    override the worst-case mark-stage capacities with calibrated ones
    (``measure_grid_semijoin_many``)."""
    p, dev = spmd.p, spmd.device
    s0, r0 = ss[0], rs[0]
    shareds = [[x for x in s.schema if x in r.schema] for s, r in zip(ss, rs)]
    assert all(shareds)
    sz_s, sz_r = s0.cap * s0.p, r0.cap * r0.p
    g_s, g_r = _grid_shares([sz_s, sz_r], p)
    c_out = c_out or (s0.cap * g_r, r0.cap * g_s)
    cap_recv = cap_recv or (-(-sz_s // g_s), -(-sz_r // g_r))
    sd, sv = _stack(ss)
    rd, rv = _stack(rs)
    sk = _key_array([s.cols(sh) for s, sh in zip(ss, shareds)], p, dev)
    rk = _key_array([r.cols(sh) for r, sh in zip(rs, shareds)], p, dev)
    md, mv, sent, dropped, ub = spmd.run(
        _grid_semijoin_mark_b,
        sd, sv, rd, rv, sk, rk,
        g_s=g_s, g_r=g_r, s_cap=s0.cap, r_cap=r0.cap, p=p,
        c_out_s=c_out[0], c_out_r=c_out[1],
        cap_s=cap_recv[0], cap_r=cap_recv[1], backend=backend,
    )
    marked = _unstack(md, mv, [s.schema for s in ss])
    mark_stats = _per_op_stats(
        sent, dropped,
        padded_slots(p, c_out[0], s0.arity)
        + padded_slots(p, c_out[1], len(shareds[0])),
        wire_bytes=dense_wire_bytes(p, c_out[0], s0.arity)
        + dense_wire_bytes(p, c_out[1], len(shareds[0])),
        ubytes=ub,
    )
    ded, ded_stats = dist_dedup_many(
        spmd, marked, seeds=[s + 7 for s in seeds],
        c_out=marked[0].cap, cap_recv=out_cap, backend=backend,
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
    backend: str = "torch",
) -> Tuple[List[DTable], List[Dict]]:
    """k-fold Lemma-8 grid join (w=2): two batched position-group send
    dispatches + one batched local-join dispatch — one claimed BSP round.
    ``c_out``/``cap_recv`` (per (A, B) relation) override the worst-case
    send capacities with calibrated ones (``measure_grid_join_many``)."""
    p, dev = spmd.p, spmd.device
    a0, b0 = as_[0], bs[0]
    g = _grid_shares([a0.cap * a0.p, b0.cap * b0.p], p)
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
        cr = cap_recv[i] if cap_recv else -(-(t0.p * t0.cap) // g_self)
        rd, rv, stats = spmd.run(
            _grid_send_one, d, v,
            g_self=g_self, stride=stride, offsets=offs, p=p, cap=t0.cap,
            c_out=co, cap_recv=cr,
        )
        parts.append((rd, rv))
        send_stats.append(_per_op_stats(
            stats["sent"], stats["dropped"], padded_slots(p, co, t0.arity),
            wire_bytes=dense_wire_bytes(p, co, t0.arity), ubytes=stats["ubytes"],
        ))
    shareds = [[x for x in a.schema if x in b.schema] for a, b in zip(as_, bs)]
    keeps = [
        tuple(i for i, x in enumerate(b.schema) if x not in set(a.schema))
        for a, b in zip(as_, bs)
    ]
    schemas = [schema_join(a.schema, b.schema) for a, b in zip(as_, bs)]
    ak = _key_array([a.cols(sh) for a, sh in zip(as_, shareds)], p, dev)
    bk = _key_array([b.cols(sh) for b, sh in zip(bs, shareds)], p, dev)
    bkeep = _key_array(keeps, p, dev)
    (ad, av), (bd, bv) = parts
    od, ov, sent_j, over = spmd.run(
        _local_join_shard_b, ad, av, bd, bv, ak, bk, bkeep,
        out_cap=out_cap, backend=backend,
    )
    join_stats = _per_op_stats(sent_j, over)
    return _unstack(od, ov, schemas), [
        _sum_stats(sa, sb, sj) for sa, sb, sj in zip(send_stats[0], send_stats[1], join_stats)
    ]
