"""Shares [Afrati & Ullman, TKDE'11] — the optimal ONE-round join algorithm
(paper Sec. 2.3, the baseline of Tables 2 and 3).

Each attribute A gets a *share* s_A with prod(s_A) <= p; the p reducers are
cells of the hypercube prod over attrs.  A tuple of R is hashed on R's
attributes and replicated to every cell consistent with those hashes —
communication = sum_i |R_i| * prod_{A not in R_i} s_A (+ OUT).  All in one
BSP round (this is exactly Lemma 8 when every attribute is in some
relation of the join).

``optimize_shares`` picks integer shares by coordinate ascent on the
replication cost — matching the known optima for our benchmark families
(e.g. for C_n only every other attribute gets a share > 1).

``shares_join`` runs on the CUDA card unless the caller passes
``device="cpu"``, as ``gym()`` does, or on a device mesh with
``spmd=SPMD(p, mesh=...)``, one process a reducer.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..relational import ops as R
from ..relational.ledger import Ledger
from ..relational.localops import default_backend
from ..relational.spmd import SPMD, spmd_for
from ..relational.table import DTable, unique_rows
from .hypergraph import Query

def replication_cost(
    query: Query, sizes: Dict[str, int], shares: Dict[str, int]
) -> float:
    """sum_i |R_i| * prod_{A not in attrs(R_i)} s_A."""
    total = 0.0
    for atom in query.atoms:
        rep = 1.0
        for a, s in shares.items():
            if a not in atom.attr_set:
                rep *= s
        total += sizes[atom.alias] * rep
    return total


def optimize_shares(
    query: Query, sizes: Dict[str, int], p: int
) -> Dict[str, int]:
    """Greedy coordinate ascent: repeatedly bump the share whose increase
    most reduces replication cost, while prod(shares) <= p."""
    attrs = sorted(query.vertices)
    shares = {a: 1 for a in attrs}

    def prod() -> int:
        return math.prod(shares.values())

    improved = True
    while improved:
        improved = False
        base = replication_cost(query, sizes, shares)
        best: Tuple[float, Optional[str]] = (base, None)
        for a in attrs:
            if prod() // shares[a] * (shares[a] + 1) > p:
                continue
            shares[a] += 1
            c = replication_cost(query, sizes, shares)
            shares[a] -= 1
            # increasing a share never increases cost; prefer the largest
            # balance gain (smaller max-load ~ smaller per-reducer input)
            if c < best[0] - 1e-9:
                best = (c, a)
        if best[1] is not None:
            shares[best[1]] += 1
            improved = True
        else:
            # cost-neutral bumps still balance load: bump the attr with the
            # most relations touching it, if it fits
            cands = [
                a
                for a in attrs
                if prod() // shares[a] * (shares[a] + 1) <= p
                and sum(a in at.attr_set for at in query.atoms) >= 2
            ]
            if cands:
                a = max(
                    cands, key=lambda a: sum(a in at.attr_set for at in query.atoms)
                )
                shares[a] += 1
                improved = True
    return shares


def shares_join(
    query: Query,
    data: Dict[str, np.ndarray],
    *,
    p: Optional[int] = None,
    spmd: Optional[SPMD] = None,
    shares: Optional[Dict[str, int]] = None,
    out_cap: Optional[int] = None,
    seed: int = 0,
    max_retries: int = 12,
    local_backend: Optional[str] = None,
    device=None,
) -> Tuple[np.ndarray, Tuple[str, ...], Ledger]:
    """One-round Shares evaluation of Q.  Returns (rows, schema, ledger).

    ``shares`` fixes the per-attribute shares (default
    ``optimize_shares``); ``max_retries`` bounds the re-runs with doubled
    capacities before a dropped row becomes an error.  ``local_backend``
    None means ``'cuda'`` on a CUDA device and ``'torch'`` on the CPU, as
    ``GymConfig.local_backend``.

    ``p`` reducers (4 unless given) simulated on ``device``, as ``gym``;
    or ``spmd``, e.g. one rank of a mesh, ``SPMD(p, mesh=...)``: every rank
    calls with the same arguments and returns the whole answer."""
    s = spmd_for("shares_join", p, spmd, device)
    p = s.p
    backend = local_backend or default_backend(s.device)
    ledger = Ledger()

    tables: Dict[str, DTable] = {}
    sizes: Dict[str, int] = {}
    for atom in query.atoms:
        rows = np.asarray(data[atom.rel], np.int32).reshape(-1, len(atom.attrs))
        if rows.shape[0]:
            rows = unique_rows(rows)  # relations are sets
        tables[atom.alias] = s.device_put(DTable.scatter_numpy(rows, atom.attrs, p))
        sizes[atom.alias] = rows.shape[0]

    shares = shares or optimize_shares(query, sizes, p)
    attr_order = sorted(shares, key=lambda a: -shares[a])
    n_cells = math.prod(shares.values())
    assert n_cells <= p

    out_cap = out_cap or max(4, 4 * max(sizes.values()))
    in_cap = max(4, 2 * max(sizes.values()))
    attempt = 0
    while True:
        attempt += 1
        assert attempt <= max_retries, "shares: too many retries"
        comm = 0
        dropped = 0
        parts: List[DTable] = []
        for atom in query.atoms:
            t = tables[atom.alias]
            rep = math.prod(
                sh for a, sh in shares.items() if a not in atom.attr_set
            )
            part, st = R.hypercube_partition(
                s, t, shares, attr_order,
                seed=seed + attempt, c_out=t.cap * max(1, rep), cap_recv=in_cap,
            )
            comm += st["sent"]
            dropped += st["dropped"]
            parts.append(part)
        joined, st = R.local_multiway_join(
            s, parts, out_caps=[out_cap] * (len(parts) - 1), backend=backend,
        )
        dropped += st["dropped"]
        if dropped == 0:
            break
        in_cap *= 2
        out_cap *= 2
        ledger.retries += 1
    # each output tuple may be produced once per cell only if the cell is
    # uniquely determined by the tuple's attribute hashes — with all output
    # attrs sharded it is unique; dedup guards the general case.
    deduped, st = R.dist_dedup(
        s, joined, seed=seed + 101, c_out=joined.cap, cap_recv=joined.cap,
        backend=backend,
    )
    ledger.add_round("shares", [f"hypercube {shares}"], comm, n_rounds=1)
    ledger.output_tuples = int(s.to_host(deduped.valid).sum())
    want = [a for a in query.output_attrs if a in deduped.schema]
    out, _ = R.dist_project(s, deduped, want)
    return out.to_numpy(s), out.schema, ledger
