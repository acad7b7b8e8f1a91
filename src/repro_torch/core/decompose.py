"""GHD construction.

- ``gyo_join_tree``: GYO ear-removal for acyclic queries -> width-1 GHD
  (the input Yannakakis expects, paper Sec. 4.1).
- ``minfill_ghd``: min-fill tree decomposition of the primal graph, bags
  covered greedily by hyperedges -> a (possibly suboptimal-width) GHD of any
  query.  Used for generic inputs and property tests.
- ``ghd_for``: front door — width-1 via GYO when acyclic, else min-fill.
"""
from __future__ import annotations

import itertools
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .ghd import GHD
from .hypergraph import Query, min_edge_cover


def gyo_join_tree(query: Query) -> Optional[GHD]:
    """GYO reduction. Returns a width-1 GHD (join tree) or None if cyclic.

    An atom R is an *ear* if every attribute of R that is shared with any
    other atom is contained in a single other atom W (the witness); isolated
    atoms are ears too.  Repeatedly removing ears empties exactly the acyclic
    hypergraphs.
    """
    alive: Dict[str, FrozenSet[str]] = dict(query.edges)
    parent_alias: Dict[str, Optional[str]] = {}
    order: List[str] = []

    while len(alive) > 1:
        ear = None
        for alias, attrs in sorted(alive.items()):
            others = {a: e for a, e in alive.items() if a != alias}
            shared = frozenset(
                v for v in attrs if any(v in e for e in others.values())
            )
            if not shared:
                ear, witness = alias, next(iter(sorted(others)))
                break
            w = next((a for a, e in sorted(others.items()) if shared <= e), None)
            if w is not None:
                ear, witness = alias, w
                break
        if ear is None:
            return None  # cyclic
        parent_alias[ear] = witness
        order.append(ear)
        del alive[ear]

    last = next(iter(alive))
    parent_alias[last] = None
    order.append(last)

    # Build rooted tree: node ids = dense ints, one per atom; parent links
    # point at the witness atom.
    ids = {alias: i for i, alias in enumerate(order)}
    root = ids[last]
    edges = [
        (ids[p], ids[a]) for a, p in parent_alias.items() if p is not None
    ]
    chi = {ids[a]: query.edges[a] for a in order}
    lam = {ids[a]: frozenset([a]) for a in order}
    g = GHD.build(root, edges, chi, lam)
    g.validate(query)
    return g


def minfill_ghd(query: Query) -> GHD:
    """Tree decomposition by min-fill elimination, converted to a GHD.

    Standard construction: eliminate the vertex whose neighborhood needs the
    fewest fill edges; its bag = {v} + current neighbors.  Bag b_v connects
    to the bag of the first eliminated vertex in b_v \\ {v}.  lam = greedy
    minimum-ish edge cover of each bag.
    """
    adj = {v: set(ns) for v, ns in query.primal_graph().items()}
    if not adj:
        raise ValueError("empty query")
    bags: List[Tuple[str, FrozenSet[str]]] = []
    elim_pos: Dict[str, int] = {}
    verts = set(adj)
    while verts:
        # min-fill choice
        def fill_cost(v: str) -> int:
            ns = adj[v] & verts
            return sum(
                1
                for a, b in itertools.combinations(sorted(ns), 2)
                if b not in adj[a]
            )

        v = min(sorted(verts), key=fill_cost)
        ns = adj[v] & verts
        bags.append((v, frozenset({v} | ns)))
        elim_pos[v] = len(bags) - 1
        for a, b in itertools.combinations(sorted(ns), 2):
            adj[a].add(b)
            adj[b].add(a)
        verts.remove(v)

    n_bags = len(bags)
    root = n_bags - 1
    edges: List[Tuple[int, int]] = []
    for i, (v, bag) in enumerate(bags):
        rest = [u for u in bag if u != v]
        if rest:
            j = min(elim_pos[u] for u in rest)
            edges.append((j, i))  # parent = bag of first-eliminated neighbor
    chi = {i: bag for i, (_, bag) in enumerate(bags)}
    lam: Dict[int, FrozenSet[str]] = {}
    for i, (_, bag) in enumerate(bags):
        cover = min_edge_cover(bag, query.edges, max_k=4)
        if cover is None:  # fall back to greedy (always succeeds: bags are
            cover = _greedy_cover(bag, query)  # unions of clique vertices)
        lam[i] = cover
    g = GHD.build(root, edges, chi, lam)
    g.validate(query)
    return g


def _greedy_cover(target: FrozenSet[str], query: Query) -> FrozenSet[str]:
    remaining = set(target)
    chosen: Set[str] = set()
    while remaining:
        alias = max(
            sorted(query.edges), key=lambda a: len(query.edges[a] & remaining)
        )
        if not query.edges[alias] & remaining:
            raise ValueError(f"cannot cover {sorted(remaining)}")
        chosen.add(alias)
        remaining -= query.edges[alias]
    return frozenset(chosen)


def ghd_for(query: Query) -> GHD:
    g = gyo_join_tree(query)
    if g is None:
        g = minfill_ghd(query)
    return g
