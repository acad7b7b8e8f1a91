"""Paper-faithful grid operators: Lemma 8 (one-round grid multiway join),
Lemma 10 (O(1)-round grid semijoin), Lemma 9 (log-round tree dedup).

These are the *skew-proof* primitives: groups are formed by POSITION (each
group has size <= ceil(count/g)), never by key hash, so the per-reducer
input bound holds under any skew — at the price of the paper's
B(X, M) = X^2/M communication.  The hash-based operators in ``ops.py`` are
the beyond-paper optimized path (comm ~ |R|+|S|, skew-sensitive with
overflow-retry).

Every per-shard body works over the explicit leading reducer axis (and
any instance axes after it), so a shard's index is an ``arange`` over
that axis.  The grid geometry is plain Python, so it is the reference's
to the last integer.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .hashing import hash_columns
from .localops import local_dedup_mask, local_project, local_semijoin_mask
from .ops import _stats, agg_stats, dist_dedup, local_multiway_join
from .shuffle import exchange, exchange_counts, exchange_multi, padded_slots, pow2
from .spmd import SPMD
from .table import DTable
from .wire import count_wire_bytes, dense_wire_bytes

#: the ROADMAP item that ports the packed wire (``fmts``)
PACKED_ITEM = "ROADMAP queue A, item 'packed wire'"


def _shard_index(x: torch.Tensor) -> torch.Tensor:
    """Each row's shard index, shaped to broadcast against ``x`` (whose
    first axis is the reducer axis)."""
    p = x.shape[0]
    return torch.arange(p, device=x.device).view((p,) + (1,) * (x.dim() - 1))


def _position_groups(valid: torch.Tensor, g: int, cap: int, p: int) -> torch.Tensor:
    """Group id in [0,g) for each row by *global position* (shard-major).

    ``valid`` is (p, *K, n).  Positions are globally contiguous: shard s,
    local slot k -> s*cap + k, then group = pos // ceil(p*cap/g).  Every
    group gets an equal slice of the global slot space — size bounds hold
    regardless of key values (the paper's 'disjoint groups of size M/w')."""
    n = valid.shape[-1]
    pos = _shard_index(valid) * cap + torch.arange(n, device=valid.device)
    per = -(-(p * cap) // g)  # ceil: slots per group (hard receive bound)
    grp = (pos // per).to(torch.int32)
    return torch.where(valid, grp, g)


def _grid_dests(
    grp: torch.Tensor, g_self: int, stride: int, offsets: Sequence[int], p: int
) -> torch.Tensor:
    """(…, n) group ids -> (…, n, len(offsets)) grid cells: the row's own
    coordinate times ``stride`` plus every offset over the other dims;
    rows of no group (== g_self) go to the skip slot p."""
    offs = torch.tensor(tuple(offsets), dtype=torch.int32, device=grp.device)
    cells = grp.unsqueeze(-1) * stride + offs
    return torch.where((grp < g_self).unsqueeze(-1), cells, p).to(torch.int32)


def _flat_dests(dests: torch.Tensor) -> torch.Tensor:
    """(…, n, g) replicated destinations -> (…, n*g) for counting."""
    return dests.reshape(tuple(dests.shape[:-2]) + (-1,))


def _grid_shares(sizes: Sequence[int], p: int) -> List[int]:
    """Choose per-relation group counts g_i with prod(g_i) <= p, g_i >= 1,
    proportional to relation sizes (larger relation -> more groups, the
    paper's g_i = w|R_i|/M with M implied by p)."""
    w = len(sizes)
    if w == 1:
        return [min(p, 1) or 1]
    logs = [math.log(max(2, s)) for s in sizes]
    tot = sum(logs)
    raw = [max(1.0, p ** (l / tot)) for l in logs]
    g = [max(1, int(x)) for x in raw]
    # fix overflow from rounding
    while math.prod(g) > p:
        i = max(range(w), key=lambda i: g[i])
        g[i] -= 1
    # greedily grow while it fits
    grew = True
    while grew:
        grew = False
        for i in sorted(range(w), key=lambda i: -sizes[i]):
            g2 = list(g)
            g2[i] += 1
            if math.prod(g2) <= p:
                g = g2
                grew = True
    return g


def _grid_geometry(
    sizes: Sequence[int], p: int
) -> Tuple[List[int], List[int], List[Tuple[int, ...]]]:
    """Shared geometry of one grid join: per-relation group counts,
    reducer-index strides, and each relation's replication offsets over
    the other dimensions.  Deterministic in (sizes, p), so the count
    pre-pass and the payload always agree on the grid."""
    w = len(sizes)
    g = _grid_shares(sizes, p)
    strides = [1] * w
    acc = 1
    for i in range(w - 1, -1, -1):
        strides[i] = acc
        acc *= g[i]
    all_offs: List[Tuple[int, ...]] = []
    for i in range(w):
        offs: List[int] = []
        other = [j for j in range(w) if j != i]

        def rec(k: int, base: int):
            if k == len(other):
                offs.append(base)
                return
            j = other[k]
            for c in range(g[j]):
                rec(k + 1, base + c * strides[j])

        rec(0, 0)
        all_offs.append(tuple(offs))
    return g, strides, all_offs


def _caps_of(oc, rt, i: int) -> Tuple[int, int]:
    return pow2(max(1, int(oc[:, i].max()))), pow2(max(1, int(rt[:, i].max())))


def grid_multiway_count(
    spmd: SPMD, table_groups: List[List[DTable]]
) -> Tuple[List[List[Tuple[int, int]]], List[int], List[int]]:
    """ONE combined count dispatch for the position-group sends of
    SEVERAL multiway joins (one per GHD vertex at materialization), so a
    query with many multi-atom bags pays a single measure dispatch for
    the whole materialization stage.

    Returns (cals, count_pads, count_bytes): per group, the (c_out,
    cap_recv) pow2 pair for each relation (feed to
    ``grid_multiway_join(cals=...)``), the count wire cells to charge
    ((p,)-ints per relation), and their byte-true sibling."""
    entries: List[Tuple[int, int, Tuple[int, ...], int]] = []
    valids = []
    slices: List[Tuple[int, int]] = []
    for tables in table_groups:
        sizes = [t.cap * t.p for t in tables]
        g, strides, all_offs = _grid_geometry(sizes, spmd.p)
        start = len(entries)
        for i, t in enumerate(tables):
            entries.append((g[i], strides[i], all_offs[i], t.cap))
            valids.append(t.valid)
        slices.append((start, len(entries)))
    oc, rt = spmd.run(
        _grid_send_count_round, *valids, entries=tuple(entries), p=spmd.p,
        measure=True,
    )
    oc, rt = oc.cpu().numpy(), rt.cpu().numpy()  # (p, n, p), (p, n)
    cals = [[_caps_of(oc, rt, i) for i in range(a, b)] for a, b in slices]
    pads = [(b - a) * spmd.p * spmd.p for a, b in slices]
    byts = [count_wire_bytes(spmd.p, b - a) for a, b in slices]
    return cals, pads, byts


def grid_multiway_join(
    spmd: SPMD,
    tables: List[DTable],
    *,
    out_cap: int,
    c_out: Optional[int] = None,
    cap_recv: Optional[int] = None,
    sizes: Optional[Sequence[int]] = None,
    calibrate: bool = False,
    cals: Optional[List[Tuple[int, int]]] = None,
    fmts: Optional[List] = None,
    backend: str = "torch",
) -> Tuple[DTable, Dict]:
    """Lemma 8: join w relations in ONE round on a grid of prod(g_i) <= p
    reducers; every reducer receives one position-group per relation.

    Skew-proof: group membership is positional.  Communication =
    sum_i |R_i| * prod_{j != i} g_j  (+ output), the paper's
    O((sum |R_i|)^w / M^{w-1} + OUT).

    ``calibrate=True``: a count-only pre-pass per relation replaces the
    worst-case send capacity (full shard cap replicated to every other
    grid dim) with the tight pow2 occupancy of the position groups.
    ``cals`` supplies those (c_out, cap_recv) pairs pre-measured by
    ``grid_multiway_count`` — the caller then owns the count-pad
    accounting.  ``c_out``/``cap_recv`` fix every relation's send and
    receive capacity (they also turn ``calibrate`` off), and ``sizes``
    replaces the relations' global slot counts in the grid shares.
    Only the dense wire is ported (``fmts`` must be None)."""
    if fmts is not None:
        raise NotImplementedError(
            f"grid exchanges with wire formats (fmts=...) need the packed wire, "
            f"which is not ported yet ({PACKED_ITEM})"
        )
    w = len(tables)
    assert w >= 1
    p = spmd.p
    if w == 1:
        return tables[0], {
            "sent": 0, "dropped": 0, "padded": 0, "wire_bytes": 0, "ubytes": 0,
        }
    sizes = list(sizes) if sizes is not None else [t.cap * t.p for t in tables]
    g, strides, all_offs = _grid_geometry(sizes, p)
    acc = math.prod(g)

    count_pad = 0
    count_b = 0
    if cals is None and calibrate and c_out is None and cap_recv is None:
        # ONE combined count dispatch for every relation's position-group
        # send (and one host sync), instead of one per relation
        oc, rt = spmd.run(
            _grid_send_count_round,
            *[t.valid for t in tables],
            entries=tuple(
                (g[i], strides[i], all_offs[i], tables[i].cap) for i in range(w)
            ),
            p=p,
            measure=True,
        )
        oc, rt = oc.cpu().numpy(), rt.cpu().numpy()  # (p, w, p), (p, w)
        cals = [_caps_of(oc, rt, i) for i in range(w)]
        count_pad = p * p  # one (p,)-int count vector per relation
        count_b = count_wire_bytes(p, 1)

    parts: List[DTable] = []
    stats_total = {"sent": 0, "dropped": 0, "padded": 0, "wire_bytes": 0, "ubytes": 0}
    for i, t in enumerate(tables):
        n_other = acc // g[i]
        if cals is not None:
            co, cr = cals[i]
        else:
            co = c_out if c_out is not None else t.cap * n_other
            cr = cap_recv if cap_recv is not None else -(-(t.p * t.cap) // g[i])
        rd, rv, stats = spmd.run(
            _grid_send_one, t.data, t.valid,
            g_self=g[i], stride=strides[i], offsets=all_offs[i], p=p,
            cap=t.cap, c_out=co, cap_recv=cr,
        )
        parts.append(DTable(rd, rv, t.schema))
        s = agg_stats(
            stats,
            padded_slots(p, co, t.arity) + count_pad,
            wire_bytes=dense_wire_bytes(p, co, t.arity) + count_b,
        )
        for key in stats_total:
            stats_total[key] += s[key]

    # local multiway join at each grid cell (one reduce stage, no comm)
    joined, jstats = local_multiway_join(spmd, parts, [out_cap] * (w - 1), backend)
    stats_total["dropped"] += jstats["dropped"]
    return joined, stats_total


def _grid_send_count_one(valid, *, g_self, stride, offsets, p, cap):
    """Count-only pre-pass of one position-group send (``_grid_send_one``
    minus the payload): same dests, a (p,)-int exchange."""
    grp = _position_groups(valid, g_self, cap, p)
    dests = _grid_dests(grp, g_self, stride, offsets, p)
    return exchange_counts(_flat_dests(dests), p)


def _grid_send_count_round(*valids, entries, p):
    """Every relation's position-group send counted in ONE program (n
    relations of one multijoin, or of several when ``grid_multiway_count``
    batches a whole materialization stage).  ``entries`` is a static tuple
    of (g_self, stride, offsets, cap) per relation; returns stacked
    ((p, n, p) out_counts, (p, n) recv totals)."""
    outs, recvs = [], []
    for v, (g_self, stride, offsets, cap) in zip(valids, entries):
        o, r = _grid_send_count_one(
            v, g_self=g_self, stride=stride, offsets=offsets, p=p, cap=cap
        )
        outs.append(o)
        recvs.append(r)
    return torch.stack(outs, dim=1), torch.stack(recvs, dim=1)


def _grid_send_one(data, valid, *, g_self, stride, offsets, p, cap, c_out, cap_recv):
    """One relation's position-group send over (p, *K, n, ar) tables: each
    live row goes to every grid cell on its own coordinate."""
    grp = _position_groups(valid, g_self, cap, p)
    dests = _grid_dests(grp, g_self, stride, offsets, p)
    rd, rv, sent, ds, dr = exchange_multi(
        data, valid, dests, p=p, c_out=c_out, cap_recv=cap_recv
    )
    return rd, rv, _stats(sent, ds + dr, ubytes=4 * data.shape[-1] * sent)


def grid_join(spmd: SPMD, a: DTable, b: DTable, *, out_cap: int, **kw) -> Tuple[DTable, Dict]:
    """Lemma 8 with w=2."""
    return grid_multiway_join(spmd, [a, b], out_cap=out_cap, **kw)


# ----------------------------------------------------------------- Lemma 10
def _grid_semijoin_mark(
    s_data, s_valid, r_data, r_valid, *,
    s_key, r_key, g_s, g_r, s_cap, r_cap, p, c_out_s, c_out_r, cap_s, cap_r,
    backend,
):
    """Round 1 of Lemma 10: grid (g_s x g_r); reducer (i,j) holds S group i
    and R-projection group j; emits S rows matched by its R block (an S row
    appears in g_r reducers -> up to g_r 'duplicates', all kept here)."""
    grp_s = _position_groups(s_valid, g_s, s_cap, p)
    dest_s = _grid_dests(grp_s, g_s, g_r, range(g_r), p)
    s2, s2v, sent_s, dss, drs = exchange_multi(
        s_data, s_valid, dest_s, p=p, c_out=c_out_s, cap_recv=cap_s
    )
    rk, rkv = local_project(r_data, r_valid, r_key, dedup=True)
    grp_r = _position_groups(rkv, g_r, r_cap, p)
    dest_r = _grid_dests(grp_r, g_r, 1, [c * g_r for c in range(g_s)], p)
    r2, r2v, sent_r, dsr, drr = exchange_multi(
        rk, rkv, dest_r, p=p, c_out=c_out_r, cap_recv=cap_r
    )
    kcols = tuple(range(len(r_key)))
    mask = local_semijoin_mask(s2, s2v, s_key, r2, r2v, kcols, backend)
    s2 = torch.where(mask.unsqueeze(-1), s2, 0)
    ub = 4 * (s_data.shape[-1] * sent_s + rk.shape[-1] * sent_r)
    return s2, mask, _stats(sent_s + sent_r, dss + drs + dsr + drr, ubytes=ub)


def grid_semijoin(
    spmd: SPMD,
    s: DTable,
    r: DTable,
    *,
    out_cap: Optional[int] = None,
    seed: int = 0,
    backend: str = "torch",
) -> Tuple[DTable, Dict, int]:
    """Lemma 10: S |>< R in O(1) rounds, skew-proof grid + hash dedup of the
    <= g_r marked duplicates.  ``out_cap`` is the dedup's receive capacity
    (default S's cap).  Returns (table, stats, engine_rounds)."""
    shared = [x for x in s.schema if x in r.schema]
    assert shared
    p = spmd.p
    sz_s = s.cap * s.p
    sz_r = r.cap * r.p
    g_s, g_r = _grid_shares([sz_s, sz_r], p)
    md, mv, stats = spmd.run(
        _grid_semijoin_mark,
        s.data, s.valid, r.data, r.valid,
        s_key=s.cols(shared), r_key=r.cols(shared),
        g_s=g_s, g_r=g_r, s_cap=s.cap, r_cap=r.cap, p=p,
        c_out_s=s.cap * g_r, c_out_r=r.cap * g_s,
        cap_s=-(-sz_s // g_s), cap_r=-(-sz_r // g_r), backend=backend,
    )
    marked = DTable(md, mv, s.schema)
    st = agg_stats(
        stats,
        padded_slots(p, s.cap * g_r, s.arity) + padded_slots(p, r.cap * g_s, len(shared)),
        wire_bytes=dense_wire_bytes(p, s.cap * g_r, s.arity)
        + dense_wire_bytes(p, r.cap * g_s, len(shared)),
    )
    # Round 2: dedup the marked copies (<= g_r per tuple) by full-row hash.
    ded, dstats = dist_dedup(
        spmd, marked, seed=seed + 7, c_out=marked.cap, cap_recv=out_cap or s.cap,
        backend=backend,
    )
    return ded, {key: st[key] + dstats[key] for key in st}, 2


# ------------------------------------------------------------------ Lemma 9
def _tree_dedup_shard(data, valid, seed, *, cols, block, p, c_out, cap_recv):
    h = hash_columns(data, cols, seed)
    base = (_shard_index(valid) // block) * block
    dest = (base + h % block).to(torch.int32)
    dest = torch.where(valid, dest, p)
    rd, rv, sent, ds, dr = exchange(data, valid, dest, p=p, c_out=c_out, cap_recv=cap_recv)
    mask = local_dedup_mask(rd, rv, cols)
    rd = torch.where(mask.unsqueeze(-1), rd, 0)
    return rd, mask, _stats(sent, ds + dr, ubytes=4 * data.shape[-1] * sent)


def tree_dedup(
    spmd: SPMD,
    t: DTable,
    *,
    fan: int = 4,
    seed: int = 0,
    cap_recv: Optional[int] = None,
) -> Tuple[DTable, Dict, int]:
    """Lemma 9: duplicate elimination in O(log_fan(p)) rounds.

    Round i merges blocks of fan^(i+1) shards: within each block, rows
    shuffle to the shard selected by hash — per-round fan-in is bounded by
    ``fan`` predecessor groups (the paper's sqrt(M)-reducer merge tree), so
    no reducer's receive volume grows with the global duplicate count k.
    ``cap_recv`` is every round's receive capacity (default ``t.cap *
    fan``).  Returns (table, stats, rounds)."""
    p = spmd.p
    cols = tuple(range(len(t.schema)))
    cap_recv = cap_recv or t.cap * fan
    cur = t
    total = {"sent": 0, "dropped": 0, "padded": 0, "wire_bytes": 0, "ubytes": 0}
    rounds = 0
    block = fan
    while True:
        block_eff = min(block, p)
        co = cur.cap
        d, v, stats = spmd.run(
            _tree_dedup_shard,
            cur.data, cur.valid, spmd.seeds(seed + rounds),
            cols=cols, block=block_eff, p=p, c_out=co, cap_recv=cap_recv,
        )
        cur = DTable(d, v, t.schema)
        s = agg_stats(
            stats,
            padded_slots(p, co, t.arity),
            wire_bytes=dense_wire_bytes(p, co, t.arity),
        )
        for key in total:
            total[key] += s[key]
        rounds += 1
        if block_eff >= p:
            break
        block *= fan
    return cur, total, rounds
