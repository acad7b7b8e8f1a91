"""C-GTA (paper Section 7): constant-factor tree shrinking by merging
adjacent vertices, doubling width per pass; composed with Log-GTA it yields
the Theorem 25 spectrum: width <= 2^i * max(w, 3iw), depth <= log((15/16)^i n).
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Tuple

from .ghd import GHD
from .hypergraph import Query
from .loggta import log_gta


def _merge_into(g: GHD, keep: int, gone: int) -> None:
    """Merge ``gone`` into ``keep``; both adjacent or sibling leaves.

    chi/lam become unions; ``gone``'s children move under ``keep``.
    """
    g.chi[keep] = g.chi[keep] | g.chi[gone]
    g.lam[keep] = g.lam[keep] | g.lam[gone]
    for c in list(g.children.get(gone, [])):
        g.parent[c] = keep
        g.children[keep].append(c)
    p = g.parent[gone]
    if p is not None:
        g.children[p].remove(gone)
    elif g.root == gone:
        g.root = keep
        g.parent[keep] = None
    del g.parent[gone], g.chi[gone], g.lam[gone]
    g.children.pop(gone, None)


def cgta_pass(ghd: GHD, query: Query) -> GHD:
    """One C-GTA pass: (1)/(2) pair-merge leaf children (odd leftover merges
    into the parent); (3) merge unique-child chains when the child has an
    even number of leaf children.

    Merges within a pass are *disjoint* (each vertex participates in at most
    one), so a pass grows width by at most 2x while removing >= max(L,U)/2
    vertices (Lemma 24 gives >= N/16 per the paper's analysis).
    """
    g = ghd.copy()
    consumed: set = set()

    # steps 1 & 2: leaves under each parent
    for u in list(g.topo_order()):
        if u not in g.chi or u in consumed:
            continue
        leaf_kids = [
            c
            for c in g.children.get(u, [])
            if not g.children.get(c) and c not in consumed
        ]
        while len(leaf_kids) >= 2:
            a, b = leaf_kids[0], leaf_kids[1]
            _merge_into(g, a, b)
            consumed.update((a, b))
            leaf_kids = leaf_kids[2:]
        if len(leaf_kids) == 1:
            _merge_into(g, u, leaf_kids[0])
            consumed.update((u, leaf_kids[0]))

    # step 3: unique-child merges (disjoint from all earlier merges)
    for u in list(g.topo_order()):
        if u not in g.chi or u in consumed:
            continue
        kids = g.children.get(u, [])
        if len(kids) == 1 and kids[0] not in consumed:
            c = kids[0]
            leafs_of_c = [x for x in g.children.get(c, []) if not g.children.get(x)]
            if len(leafs_of_c) % 2 == 0:
                _merge_into(g, u, c)
                consumed.update((u, c))

    g.validate(query)
    return g


def cgta(ghd: GHD, query: Query, passes: int) -> GHD:
    """Theorem 25 composition: ``passes`` C-GTA shrink passes, then Log-GTA."""
    g = ghd
    for _ in range(passes):
        before = g.size()
        g = cgta_pass(g, query)
        if g.size() == before:  # nothing left to merge
            break
    return log_gta(g, query)
