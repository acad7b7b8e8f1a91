"""Distributed relational operators on DTables (sequential, one op each).

Each operator = (repartition via hash shuffle) + (per-shard local op), all
inside one per-shard function so a BSP round is one ``SPMD.run``
dispatch.  Operators return (result DTable, stats) where stats carry
``sent`` (tuples communicated — the paper's cost unit), ``dropped``
(capacity overflows; nonzero => the driver must retry with bigger caps)
and ``padded`` (dense all_to_all slots the wire shipped, known from ``p``
and each exchange's ``c_out``, so accounted host-side).

The fused round path lives in ``batched``; these are the operators the
materialization stage and the capacity manager call directly, plus the
sequential fronts of every exchange (``repartition``, ``dist_semijoin``,
``dist_intersect``) and of the hybrid heavy-hitter routing
(``dist_join_hybrid``, ``dist_semijoin_hybrid``).

``measure_exchange`` is the sequential count-only pre-pass: the tight
per-exchange capacities it returns are what the capacity manager feeds
back as ``c_out``/``cap_recv``.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .hashing import hash_columns
from .localops import (
    get_local_backend,
    local_dedup_mask,
    local_intersect_mask,
    local_join,
    local_join_count,
    local_project,
    local_semijoin_mask,
)
from .shuffle import exchange, exchange_counts, exchange_multi, padded_slots, pow2
from .skew import DEFAULT_SKEW_THRESHOLD
from .spmd import SPMD
from .table import DTable, schema_join
from .wire import count_wire_bytes, dense_wire_bytes


class Overflow(Exception):
    """A reducer exceeded its capacity — the paper's 'abort'."""


def _stats(sent, dropped, ubytes=None):
    out = {"sent": sent, "dropped": dropped}
    if ubytes is not None:
        out["ubytes"] = ubytes
    return out


def agg_stats(spmd: SPMD, stats, padded: int = 0, wire_bytes: int = 0) -> Dict[str, int]:
    """Per-shard stats summed over the whole reducer axis (gathered on a
    mesh) into host ints."""
    out = {k: int(v.sum()) for k, v in zip(stats, spmd.to_host_many(*stats.values()))}
    out.setdefault("padded", int(padded))
    out.setdefault("wire_bytes", int(wire_bytes))
    out.setdefault("ubytes", 0)
    return out


def _caps_from_counts(o, r) -> Tuple[int, int]:
    return pow2(max(1, int(o.max()))), pow2(max(1, int(r.max())))


# ---------------------------------------------------------------- repartition
def _repart_shard(data, valid, seed, *, cols, p, c_out, cap_recv, backend):
    dest = get_local_backend(backend).dests(data, valid, cols, p, seed)
    rd, rv, sent, ds, dr = exchange(data, valid, dest, p=p, c_out=c_out, cap_recv=cap_recv)
    return rd, rv, _stats(sent, ds + dr, ubytes=4 * data.shape[-1] * sent)


def repartition(
    spmd: SPMD, t: DTable, attrs: Sequence[str], *, seed: int, c_out: int,
    cap_recv: int, backend: str = "torch",
) -> Tuple[DTable, Dict]:
    """Hash-repartition ``t`` on ``attrs`` (one exchange, no local op)."""
    rd, rv, stats = spmd.run(
        _repart_shard, t.data, t.valid, spmd.seeds(seed),
        cols=t.cols(attrs), p=spmd.p, c_out=c_out, cap_recv=cap_recv,
        backend=backend,
    )
    return DTable(rd, rv, t.schema), agg_stats(
        spmd, stats,
        padded_slots(spmd.p, c_out, t.arity),
        wire_bytes=dense_wire_bytes(spmd.p, c_out, t.arity),
    )


# ------------------------------------------------------ count-only pre-pass
def _exchange_count_shard(data, valid, seed, *, cols, p, dedup, backend):
    """Mirror of the map stage of one exchange, counts only: same key
    columns, same seed, same destination hash — but the exchange carries
    a (p,)-int count vector instead of the payload buffer."""
    be = get_local_backend(backend)
    if dedup:  # semijoin ships the deduplicated key projection of R
        keys, v = local_project(data, valid, cols, dedup=True)
        dest = be.dests(keys, v, tuple(range(len(cols))), p, seed)
    else:
        dest = be.dests(data, valid, cols, p, seed)
    return exchange_counts(dest, p)


def measure_exchange(
    spmd: SPMD, t: DTable, attrs: Sequence[str], *, seed: int,
    dedup: bool = False, backend: str = "torch",
) -> Tuple[int, int]:
    """Count-only pre-pass of ``t``'s hash exchange on ``attrs``: one tiny
    dispatch returning the tight pow2 ``(c_out, cap_recv)`` for the payload
    exchange that follows with the SAME seed."""
    out_counts, recv_tot = spmd.run(
        _exchange_count_shard, t.data, t.valid, spmd.seeds(seed),
        cols=t.cols(attrs), p=spmd.p, dedup=dedup, backend=backend,
        measure=True,
    )
    return _caps_from_counts(*spmd.to_host_many(out_counts, recv_tot))


def _exchange_count_pair_shard(
    ad, av, bd, bv, seed, *, cols_a, cols_b, p, dedup_a, dedup_b, backend
):
    """Both sides of a two-table exchange counted in ONE program."""
    be = get_local_backend(backend)
    va, vb = av, bv
    if dedup_a:
        ka, va = local_project(ad, av, cols_a, dedup=True)
        da = be.dests(ka, va, tuple(range(len(cols_a))), p, seed)
    else:
        da = be.dests(ad, va, cols_a, p, seed)
    if dedup_b:
        kb, vb = local_project(bd, bv, cols_b, dedup=True)
        db = be.dests(kb, vb, tuple(range(len(cols_b))), p, seed)
    else:
        db = be.dests(bd, vb, cols_b, p, seed)
    return exchange_counts(da, p), exchange_counts(db, p)


def measure_exchange_pair(
    spmd: SPMD, a: DTable, b: DTable, attrs_a: Sequence[str],
    attrs_b: Sequence[str], *, seed: int,
    dedup: Tuple[bool, bool] = (False, False), backend: str = "torch",
) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Count-only pre-pass for BOTH sides of a join exchange in one
    dispatch.  Returns ``(c_out, cap_recv)`` pairs ordered (a, b)."""
    (oa, ra), (ob, rb) = spmd.run(
        _exchange_count_pair_shard,
        a.data, a.valid, b.data, b.valid, spmd.seeds(seed),
        cols_a=a.cols(attrs_a), cols_b=b.cols(attrs_b),
        p=spmd.p, dedup_a=dedup[0], dedup_b=dedup[1],
        backend=backend, measure=True,
    )
    oa, ra, ob, rb = spmd.to_host_many(oa, ra, ob, rb)
    ca, cra = _caps_from_counts(oa, ra)
    cb, crb = _caps_from_counts(ob, rb)
    return (ca, cb), (cra, crb)


def _exchange_count_pairs_shard(*args, entries, p, backend):
    """SEVERAL two-table exchanges counted in ONE program; ``args`` packs
    (a_data, a_valid, b_data, b_valid, seed) per entry."""
    out = []
    for i, (cols_a, cols_b, dedup_a, dedup_b) in enumerate(entries):
        ad, av, bd, bv, seed = args[5 * i: 5 * i + 5]
        out.append(
            _exchange_count_pair_shard(
                ad, av, bd, bv, seed, cols_a=cols_a, cols_b=cols_b, p=p,
                dedup_a=dedup_a, dedup_b=dedup_b, backend=backend,
            )
        )
    return tuple(out)


def measure_exchange_pairs(spmd: SPMD, items, *, backend: str = "torch"):
    """Count-only pre-pass for SEVERAL two-table exchanges in one dispatch
    and one host sync.  ``items`` are (a, b, attrs_a, attrs_b, seed,
    (dedup_a, dedup_b)); returns the per-item ((c_out_a, c_out_b),
    (cap_recv_a, cap_recv_b))."""
    arrays = []
    entries = []
    for a, b, attrs_a, attrs_b, seed, dedup in items:
        arrays += [a.data, a.valid, b.data, b.valid, spmd.seeds(seed)]
        entries.append(
            (a.cols(attrs_a), b.cols(attrs_b), bool(dedup[0]), bool(dedup[1]))
        )
    res = spmd.run(
        _exchange_count_pairs_shard, *arrays,
        entries=tuple(entries), p=spmd.p, backend=backend, measure=True,
    )
    out = []
    for (oa, ra), (ob, rb) in res:
        oa, ra, ob, rb = spmd.to_host_many(oa, ra, ob, rb)
        ca, cra = _caps_from_counts(oa, ra)
        cb, crb = _caps_from_counts(ob, rb)
        out.append(((ca, cb), (cra, crb)))
    return out


# ----------------------------------------------------------------------- join
def _join_shard(
    a_data, a_valid, b_data, b_valid, seed, *,
    a_key, b_key, b_keep, p, c_out_a, c_out_b, cap_a, cap_b, out_cap, backend,
):
    be = get_local_backend(backend)
    da = be.dests(a_data, a_valid, a_key, p, seed)
    a2, a2v, sent_a, dsa, dra = exchange(a_data, a_valid, da, p=p, c_out=c_out_a, cap_recv=cap_a)
    db = be.dests(b_data, b_valid, b_key, p, seed)
    b2, b2v, sent_b, dsb, drb = exchange(b_data, b_valid, db, p=p, c_out=c_out_b, cap_recv=cap_b)
    # key columns are unchanged by the shuffle: join on a_key/b_key directly
    out, out_v, over = local_join(a2, a2v, b2, b2v, a_key, b_key, b_keep, out_cap, backend)
    ub = 4 * (a_data.shape[-1] * sent_a + b_data.shape[-1] * sent_b)
    return out, out_v, _stats(sent_a + sent_b, dsa + dra + dsb + drb + over, ubytes=ub)


def _cross_join_shard(
    a_data, a_valid, b_data, b_valid, *, b_keep, p, c_out_b, cap_b, out_cap, backend,
):
    """Attribute-disjoint join: A stays put, B broadcasts to every reducer
    (comm = p * |B|), then an empty-key local join expands A_shard x B."""
    n = b_data.shape[-2]
    dests = torch.arange(p, dtype=torch.int32, device=b_data.device).expand(
        b_data.shape[0], n, p
    )
    b2, b2v, sent_b, dsb, drb = exchange_multi(
        b_data, b_valid, dests, p=p, c_out=c_out_b, cap_recv=cap_b
    )
    out, out_v, over = local_join(
        a_data, a_valid, b2, b2v, (), (), b_keep, out_cap, backend
    )
    return out, out_v, _stats(
        sent_b, dsb + drb + over, ubytes=4 * b_data.shape[-1] * sent_b
    )


def dist_join(
    spmd: SPMD, a: DTable, b: DTable, *, seed: int, out_cap: int,
    c_out: Optional[Tuple[int, int]] = None,
    cap_recv: Optional[Tuple[int, int]] = None,
    calibrate: bool = False, backend: str = "torch",
) -> Tuple[DTable, Dict]:
    """Hash join of a and b on their shared attributes (co-partitioning).
    With NO shared attributes this is a broadcast cross join.

    ``calibrate=True``: when the shuffle capacities are not given, run the
    count-only pre-pass per side and use the tight pow2 capacities."""
    shared = [x for x in a.schema if x in b.schema]
    a_key = a.cols(shared)
    b_key = b.cols(shared)
    b_keep = tuple(i for i, x in enumerate(b.schema) if x not in set(a.schema))
    out_schema = schema_join(a.schema, b.schema)
    p = spmd.p
    count_pad = 0
    count_bytes = 0
    if calibrate and shared and c_out is None and cap_recv is None:
        c_out, cap_recv = measure_exchange_pair(
            spmd, a, b, shared, shared, seed=seed, backend=backend
        )
        count_pad = 2 * p * p  # the two (p,)-int count vectors
        count_bytes = count_wire_bytes(p, 2)
    c_out = c_out or (a.cap, b.cap)           # safe: one shard sends all
    cap_recv = cap_recv or (p * a.cap, p * b.cap)  # safe: one shard gets all
    if not shared:
        od, ov, stats = spmd.run(
            _cross_join_shard,
            a.data, a.valid, b.data, b.valid,
            b_keep=b_keep, p=p, c_out_b=c_out[1], cap_b=cap_recv[1],
            out_cap=out_cap, backend=backend,
        )
        return DTable(od, ov, out_schema), agg_stats(
            spmd, stats,
            padded_slots(p, c_out[1], b.arity),
            wire_bytes=dense_wire_bytes(p, c_out[1], b.arity),
        )
    od, ov, stats = spmd.run(
        _join_shard,
        a.data, a.valid, b.data, b.valid, spmd.seeds(seed),
        a_key=a_key, b_key=b_key, b_keep=b_keep, p=p,
        c_out_a=c_out[0], c_out_b=c_out[1],
        cap_a=cap_recv[0], cap_b=cap_recv[1],
        out_cap=out_cap, backend=backend,
    )
    return DTable(od, ov, out_schema), agg_stats(
        spmd, stats,
        padded_slots(p, c_out[0], a.arity)
        + padded_slots(p, c_out[1], b.arity)
        + count_pad,
        wire_bytes=dense_wire_bytes(p, c_out[0], a.arity)
        + dense_wire_bytes(p, c_out[1], b.arity)
        + count_bytes,
    )


# --------------------------------------------- hybrid (heavy-hitter) variants
def dist_join_hybrid(
    spmd: SPMD, a: DTable, b: DTable, *, seed: int,
    out_cap: Optional[int] = None, skew_threshold: Optional[float] = None,
    backend: str = "torch",
) -> Tuple[DTable, Dict]:
    """Skew-resilient hash join: the count pre-pass detects heavy keys
    (``relational.skew``) and routes them grid-style — one side's heavy
    rows spread over all p reducers, the other's broadcast — while light
    keys keep the plain hash exchange.  Row set identical to
    ``dist_join``; stats gain ``'heavy'`` (tuple-sends on the heavy path),
    and the measure pre-pass's wire cost is folded into ``'padded'``.
    ``out_cap=None`` uses the pre-counted exact output requirement under
    the hybrid placement."""
    shared = [x for x in a.schema if x in b.schema]
    if not shared:  # broadcast cross join: already skew-free
        assert out_cap is not None, "cross join needs an explicit out_cap"
        out, st = dist_join(spmd, a, b, seed=seed, out_cap=out_cap, backend=backend)
        st.setdefault("heavy", 0)
        return out, st
    from . import batched as B  # function-level: batched imports grid -> ops

    thresh = DEFAULT_SKEW_THRESHOLD if skew_threshold is None else skew_threshold
    m = B.measure_join_many(
        spmd, [a], [b], seeds=[seed], backend=backend,
        hybrid=True, skew_threshold=thresh,
    )
    kw = dict(
        seeds=[seed], out_cap=out_cap if out_cap is not None else m.out_need,
        c_out=(m.lhs.c_out, m.rhs.c_out),
        cap_recv=(m.lhs.cap_recv, m.rhs.cap_recv), backend=backend,
    )
    if m.hybrid_routed:
        outs, stats = B.hybrid_join_many(
            spmd, [a], [b], heavy=m.heavy, swap=m.swap_spread, **kw
        )
    else:
        outs, stats = B.dist_join_many(spmd, [a], [b], **kw)
    return outs[0], _with_measure(stats[0], m)


def dist_semijoin_hybrid(
    spmd: SPMD, s: DTable, r: DTable, *, seed: int,
    cap_recv: Optional[int] = None, skew_threshold: Optional[float] = None,
    backend: str = "torch",
) -> Tuple[DTable, Dict]:
    """Skew-resilient S |>< R: heavy S rows spread positionally, heavy R
    keys broadcast; light keys hash as in ``dist_semijoin``.  Row set
    identical; ``cap_recv`` (the S-side output capacity) defaults to the
    measured hybrid arrival bound."""
    shared = [x for x in s.schema if x in r.schema]
    assert shared, f"semijoin with no shared attrs: {s.schema} vs {r.schema}"
    from . import batched as B  # function-level: batched imports grid -> ops

    thresh = DEFAULT_SKEW_THRESHOLD if skew_threshold is None else skew_threshold
    m = B.measure_semijoin_many(
        spmd, [s], [r], seeds=[seed], backend=backend,
        hybrid=True, skew_threshold=thresh,
    )
    kw = dict(
        seeds=[seed], c_out=(m.lhs.c_out, m.rhs.c_out),
        cap_recv=(max(cap_recv or 0, m.lhs.cap_recv), m.rhs.cap_recv),
        backend=backend,
    )
    if m.hybrid_routed:
        outs, stats = B.hybrid_semijoin_many(spmd, [s], [r], heavy=m.heavy, **kw)
    else:
        outs, stats = B.dist_semijoin_many(spmd, [s], [r], **kw)
    return outs[0], _with_measure(stats[0], m)


def _with_measure(stats: Dict, m) -> Dict:
    """One hybrid op's stats with its measure pre-pass's wire cost folded
    in and a ``'heavy'`` count even when nothing routed heavy."""
    st = dict(stats)
    st["padded"] = st.get("padded", 0) + m.padded
    st["wire_bytes"] = st.get("wire_bytes", 0) + m.wire_bytes
    st.setdefault("heavy", 0)
    return st


# ------------------------------------------------------------------- semijoin
def _semijoin_shard(
    s_data, s_valid, r_data, r_valid, seed, *,
    s_key, r_key, p, c_out_s, c_out_r, cap_s, cap_r, backend,
):
    be = get_local_backend(backend)
    # ship only the deduplicated key projection of R (S |>< R = S |><
    # pi_{S&R}(R)), as in Sec. 4.1
    rk, rkv = local_project(r_data, r_valid, r_key, dedup=True)
    kcols = tuple(range(len(r_key)))
    dr_dest = be.dests(rk, rkv, kcols, p, seed)
    rk2, rkv2, sent_r, dsr, drr = exchange(rk, rkv, dr_dest, p=p, c_out=c_out_r, cap_recv=cap_r)
    rkv2 = local_dedup_mask(rk2, rkv2, kcols)
    ds_dest = be.dests(s_data, s_valid, s_key, p, seed)
    s2, s2v, sent_s, dss, drs = exchange(s_data, s_valid, ds_dest, p=p, c_out=c_out_s, cap_recv=cap_s)
    mask = local_semijoin_mask(s2, s2v, s_key, rk2, rkv2, kcols, backend)
    s2 = torch.where(mask.unsqueeze(-1), s2, 0)
    ub = 4 * (rk.shape[-1] * sent_r + s_data.shape[-1] * sent_s)
    return s2, mask, _stats(sent_r + sent_s, dsr + drr + dss + drs, ubytes=ub)


def dist_semijoin(
    spmd: SPMD, s: DTable, r: DTable, *, seed: int,
    c_out: Optional[Tuple[int, int]] = None,
    cap_recv: Optional[Tuple[int, int]] = None, backend: str = "torch",
) -> Tuple[DTable, Dict]:
    """S |>< R on shared attributes; result has S's schema (repartitioned)."""
    shared = [x for x in s.schema if x in r.schema]
    assert shared, f"semijoin with no shared attrs: {s.schema} vs {r.schema}"
    p = spmd.p
    c_out = c_out or (s.cap, r.cap)
    cap_recv = cap_recv or (p * s.cap, p * r.cap)
    sd, sv, stats = spmd.run(
        _semijoin_shard,
        s.data, s.valid, r.data, r.valid, spmd.seeds(seed),
        s_key=s.cols(shared), r_key=r.cols(shared), p=p,
        c_out_s=c_out[0], c_out_r=c_out[1],
        cap_s=cap_recv[0], cap_r=cap_recv[1], backend=backend,
    )
    return DTable(sd, sv, s.schema), agg_stats(
        spmd, stats,
        # S ships full rows; R ships only its deduplicated key projection
        padded_slots(p, c_out[0], s.arity) + padded_slots(p, c_out[1], len(shared)),
        wire_bytes=dense_wire_bytes(p, c_out[0], s.arity)
        + dense_wire_bytes(p, c_out[1], len(shared)),
    )


# ------------------------------------------------------------------ intersect
def _intersect_shard(
    a_data, a_valid, b_data, b_valid, seed, *,
    a_cols, b_cols, p, c_out_a, c_out_b, cap_a, cap_b, backend,
):
    be = get_local_backend(backend)
    da = be.dests(a_data, a_valid, a_cols, p, seed)
    a2, a2v, sent_a, dsa, dra = exchange(a_data, a_valid, da, p=p, c_out=c_out_a, cap_recv=cap_a)
    db = be.dests(b_data, b_valid, b_cols, p, seed)
    b2, b2v, sent_b, dsb, drb = exchange(b_data, b_valid, db, p=p, c_out=c_out_b, cap_recv=cap_b)
    mask = local_intersect_mask(a2, a2v, b2, b2v, a_cols, b_cols, backend)
    a2 = torch.where(mask.unsqueeze(-1), a2, 0)
    ub = 4 * (a_data.shape[-1] * sent_a + b_data.shape[-1] * sent_b)
    return a2, mask, _stats(sent_a + sent_b, dsa + dra + dsb + drb, ubytes=ub)


def dist_intersect(
    spmd: SPMD, a: DTable, b: DTable, *, seed: int,
    c_out: Optional[Tuple[int, int]] = None,
    cap_recv: Optional[Tuple[int, int]] = None, backend: str = "torch",
) -> Tuple[DTable, Dict]:
    """A intersect B (same attr sets, any column order); result: A's rows."""
    assert set(a.schema) == set(b.schema), (a.schema, b.schema)
    p = spmd.p
    c_out = c_out or (a.cap, b.cap)
    cap_recv = cap_recv or (p * a.cap, p * b.cap)
    ad, av, stats = spmd.run(
        _intersect_shard,
        a.data, a.valid, b.data, b.valid, spmd.seeds(seed),
        a_cols=tuple(range(len(a.schema))), b_cols=b.cols(a.schema), p=p,
        c_out_a=c_out[0], c_out_b=c_out[1],
        cap_a=cap_recv[0], cap_b=cap_recv[1], backend=backend,
    )
    return DTable(ad, av, a.schema), agg_stats(
        spmd, stats,
        padded_slots(p, c_out[0], a.arity) + padded_slots(p, c_out[1], b.arity),
        wire_bytes=dense_wire_bytes(p, c_out[0], a.arity)
        + dense_wire_bytes(p, c_out[1], b.arity),
    )


# ---------------------------------------------------------------------- dedup
def _dedup_shard(data, valid, seed, *, cols, p, c_out, cap_recv, backend):
    dest = get_local_backend(backend).dests(data, valid, cols, p, seed)
    d2, v2, sent, ds, dr = exchange(data, valid, dest, p=p, c_out=c_out, cap_recv=cap_recv)
    mask = local_dedup_mask(d2, v2, cols)
    d2 = torch.where(mask.unsqueeze(-1), d2, 0)
    return d2, mask, _stats(sent, ds + dr, ubytes=4 * data.shape[-1] * sent)


def dist_dedup(
    spmd: SPMD, t: DTable, *, seed: int,
    c_out: Optional[int] = None, cap_recv: Optional[int] = None,
    backend: str = "torch",
) -> Tuple[DTable, Dict]:
    p = spmd.p
    c_out = c_out or t.cap
    cap_recv = cap_recv or p * t.cap
    cols = tuple(range(len(t.schema)))
    d, v, stats = spmd.run(
        _dedup_shard, t.data, t.valid, spmd.seeds(seed),
        cols=cols, p=p, c_out=c_out, cap_recv=cap_recv, backend=backend,
    )
    return DTable(d, v, t.schema), agg_stats(
        spmd, stats,
        padded_slots(p, c_out, t.arity),
        wire_bytes=dense_wire_bytes(p, c_out, t.arity),
    )


# ------------------------------------------------- hypercube (Lemma 8/Shares)
def _hypercube_send_shard(data, valid, seed, *, dest_plan, p, c_out, cap_recv):
    """dest_plan: (fixed, wild_offsets)
    - fixed: tuple of (col, share, stride, attr_id) — coordinate =
      hash(col value; seeded by the GLOBAL attr id) % share, so every
      relation hashes a shared attribute identically;
    - wild_offsets: precomputed flat offsets over the wildcard dims."""
    fixed, wild_offsets = dest_plan
    base = torch.zeros(valid.shape, dtype=torch.int64, device=data.device)
    for col, share, stride, attr_id in fixed:
        h = hash_columns(data, (col,), seed + 7717 * (1 + attr_id))
        base = base + (h % share) * stride
    offs = torch.tensor(wild_offsets, dtype=torch.int64, device=data.device)
    dests = (base.unsqueeze(-1) + offs).to(torch.int32)
    rd, rv, sent, ds, dr = exchange_multi(
        data, valid, dests, p=p, c_out=c_out, cap_recv=cap_recv
    )
    return rd, rv, _stats(sent, ds + dr, ubytes=4 * data.shape[-1] * sent)


def hypercube_partition(
    spmd: SPMD,
    t: DTable,
    shares: Dict[str, int],
    attr_order: Sequence[str],
    *,
    seed: int,
    c_out: int,
    cap_recv: int,
) -> Tuple[DTable, Dict]:
    """Send each row of ``t`` to every hypercube cell consistent with its
    attribute hashes (Shares / Lemma 8).  Cells are mixed-radix points
    over ``attr_order`` with radix ``shares[attr]``; cell ids < p."""
    strides: Dict[str, int] = {}
    acc = 1
    for a in attr_order:
        strides[a] = acc
        acc *= shares[a]
    assert acc <= spmd.p, f"cells {acc} > p {spmd.p}"
    attr_ids = {a: i for i, a in enumerate(attr_order)}
    fixed = tuple(
        (t.col(a), shares[a], strides[a], attr_ids[a])
        for a in attr_order
        if a in t.schema
    )
    wild_attrs = [a for a in attr_order if a not in t.schema]
    combos = itertools.product(*[range(shares[a]) for a in wild_attrs])
    wild_offsets = tuple(
        sum(c * strides[a] for c, a in zip(combo, wild_attrs)) for combo in combos
    ) or (0,)
    rd, rv, stats = spmd.run(
        _hypercube_send_shard,
        t.data, t.valid, spmd.seeds(seed),
        dest_plan=(fixed, wild_offsets),
        p=spmd.p, c_out=c_out, cap_recv=cap_recv,
    )
    return DTable(rd, rv, t.schema), agg_stats(
        spmd, stats,
        padded_slots(spmd.p, c_out, t.arity),
        wire_bytes=dense_wire_bytes(spmd.p, c_out, t.arity),
    )


# ------------------------------------------------------- local multiway join
def _multijoin_shard(*arrays, plan, out_caps, backend):
    """arrays: d0,v0,d1,v1,...; plan: tuple of (a_key, b_key, b_keep) for the
    left-deep fold (an empty key is the cross join); out_caps: per-step
    output capacities."""
    k = len(arrays) // 2
    acc_d, acc_v = arrays[0], arrays[1]
    over_total = torch.zeros(acc_v.shape[:-1], dtype=torch.int64, device=acc_v.device)
    for step in range(k - 1):
        a_key, b_key, b_keep = plan[step]
        acc_d, acc_v, over = local_join(
            acc_d, acc_v, arrays[2 * step + 2], arrays[2 * step + 3],
            a_key, b_key, b_keep, out_caps[step], backend,
        )
        over_total = over_total + over
    return acc_d, acc_v, _stats(torch.zeros_like(over_total), over_total)


def local_multiway_join(
    spmd: SPMD, tables: List[DTable], out_caps: Sequence[int],
    backend: str = "torch",
) -> Tuple[DTable, Dict]:
    """Per-shard left-deep multiway join (no communication — reducers join
    their co-located buckets, the reduce stage of Lemma 8)."""
    assert len(tables) >= 1
    if len(tables) == 1:
        return tables[0], {
            "sent": 0, "dropped": 0, "padded": 0, "wire_bytes": 0, "ubytes": 0,
        }
    plan = []
    schema = tables[0].schema
    for nxt in tables[1:]:
        shared = [x for x in schema if x in nxt.schema]
        a_key = tuple(schema.index(x) for x in shared)
        b_key = tuple(nxt.schema.index(x) for x in shared)
        b_keep = tuple(i for i, x in enumerate(nxt.schema) if x not in set(schema))
        plan.append((a_key, b_key, b_keep))
        schema = schema_join(schema, nxt.schema)
    args = []
    for t in tables:
        args.extend([t.data, t.valid])
    od, ov, stats = spmd.run(
        _multijoin_shard, *args,
        plan=tuple(plan), out_caps=tuple(out_caps), backend=backend,
    )
    return DTable(od, ov, schema), agg_stats(spmd, stats)


# ------------------------------------------------------ join output counting
def _join_count_shard(
    a_data, a_valid, b_data, b_valid, seed, *,
    a_key, b_key, p, c_out_a, c_out_b, cap_a, cap_b, backend,
):
    """Shuffle ONLY the key projections with the join's hash plan and count
    the exact per-shard join output (capacity planning, no payload moved)."""
    be = get_local_backend(backend)
    ak, akv = local_project(a_data, a_valid, a_key, dedup=False)
    kc = tuple(range(len(a_key)))
    da = be.dests(ak, akv, kc, p, seed)
    a2, a2v, *_ = exchange(ak, akv, da, p=p, c_out=c_out_a, cap_recv=cap_a)
    bk, bkv = local_project(b_data, b_valid, b_key, dedup=False)
    db = be.dests(bk, bkv, kc, p, seed)
    b2, b2v, *_ = exchange(bk, bkv, db, p=p, c_out=c_out_b, cap_recv=cap_b)
    return local_join_count(a2, a2v, b2, b2v, kc, kc, backend)


def dist_join_count(
    spmd: SPMD, a: DTable, b: DTable, *, seed: int, backend: str = "torch"
) -> np.ndarray:
    """Exact per-shard output size of ``dist_join(a, b, seed=seed)`` with
    default receive capacities — (p,) array.  Used by the capacity
    manager to pre-size a blown join's retry instead of guessing."""
    shared = [x for x in a.schema if x in b.schema]
    p = spmd.p
    counts = spmd.run(
        _join_count_shard,
        a.data, a.valid, b.data, b.valid, spmd.seeds(seed),
        a_key=a.cols(shared), b_key=b.cols(shared), p=p,
        c_out_a=a.cap, c_out_b=b.cap, cap_a=p * a.cap, cap_b=p * b.cap,
        backend=backend, measure=True,
    )
    return spmd.to_host(counts)


# -------------------------------------------------------------------- project
def _project_shard(data, valid, *, cols, dedup):
    return local_project(data, valid, cols, dedup)


def dist_project(
    spmd: SPMD, t: DTable, attrs: Sequence[str], *, dedup: bool = False
) -> Tuple[DTable, Dict]:
    """Shard-local projection (no communication); stats are zero."""
    d, v = spmd.run(_project_shard, t.data, t.valid, cols=t.cols(attrs), dedup=dedup)
    return DTable(d, v, tuple(attrs)), {
        "sent": 0, "dropped": 0, "padded": 0, "wire_bytes": 0, "ubytes": 0,
    }


def check_no_drop(
    stats: Dict[str, int], op: str = "?", cap: Optional[int] = None
) -> None:
    """Raise ``Overflow`` if the operator dropped tuples."""
    if stats.get("dropped", 0):
        at = f" at capacity {cap}" if cap is not None else ""
        raise Overflow(
            f"{op}: {stats['dropped']} tuples dropped{at} (capacity abort; "
            f"sent={stats.get('sent', '?')}) — retry with a larger capacity "
            "or enable the count-calibrated shuffle pre-pass"
        )
