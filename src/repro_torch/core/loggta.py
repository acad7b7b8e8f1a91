"""Log-GTA (paper Section 6): transform any GHD with width w and
intersection width iw into an O(log n)-depth GHD of width <= max(w, 3iw).

The extended GHD carries:
  - active/inactive vertex labels (active(T') is the up-closed top subtree),
  - per-vertex heights assigned at inactivation time,
  - common covers cc(u,v) (size <= iw) on the edges of active(T').

Each iteration inactivates all active leaves plus a pairwise non-adjacent
set of unique-c-gc vertices (with their unique children) — together at least
1/4 of the active vertices (Lemma 16) — so O(log n) iterations suffice
(Lemma 19), and heights grow by at most 1 per iteration (Lemma 20).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .ghd import GHD
from .hypergraph import Query, min_edge_cover


@dataclass
class ExtendedGHD:
    ghd: GHD
    active: Set[int]
    cc: Dict[Tuple[int, int], FrozenSet[str]]  # (parent,child) in active(T')
    height: Dict[int, int]
    next_id: int

    @staticmethod
    def extend(ghd: GHD, query: Query, max_cover: Optional[int] = None) -> "ExtendedGHD":
        g = ghd.copy()
        cc: Dict[Tuple[int, int], FrozenSet[str]] = {}
        for p, c in g.tree_edges():
            shared = g.chi[p] & g.chi[c]
            cover = min_edge_cover(shared, query.edges, max_k=max_cover)
            assert cover is not None, "GHD edge must have a finite cover"
            cc[(p, c)] = cover
        return ExtendedGHD(
            ghd=g,
            active=set(g.nodes()),
            cc=cc,
            height={},
            next_id=max(g.nodes()) + 1,
        )

    # ------------------------------------------------------------------ helpers
    def active_children(self, n: int) -> List[int]:
        return [c for c in self.ghd.children.get(n, []) if c in self.active]

    def active_leaves(self) -> List[int]:
        return [n for n in self.active if not self.active_children(n)]

    def unique_cgc(self) -> List[int]:
        """Active vertices u with exactly one active child c, where c also
        has exactly one active child gc."""
        out = []
        for u in self.active:
            cs = self.active_children(u)
            if len(cs) != 1:
                continue
            gcs = self.active_children(cs[0])
            if len(gcs) == 1:
                out.append(u)
        return out

    def _inactive_children(self, n: int) -> List[int]:
        return [c for c in self.ghd.children.get(n, []) if c not in self.active]

    def _assign_height(self, n: int) -> None:
        kids = self._inactive_children(n)
        self.height[n] = 0 if not kids else 1 + max(self.height[k] for k in kids)

    # ---------------------------------------------------------------- operations
    def inactivate_leaf(self, l: int) -> None:
        assert l in self.active and not self.active_children(l)
        p = self.ghd.parent[l]
        if p is not None:
            self.cc.pop((p, l), None)
        self.active.remove(l)
        self._assign_height(l)

    def inactivate_unique_cgc(self, u: int) -> int:
        """Perform unique-c-gc inactivation at u; returns the new vertex s."""
        g = self.ghd
        cs = self.active_children(u)
        assert len(cs) == 1, f"{u} not unique-c-gc"
        c = cs[0]
        gcs = self.active_children(c)
        assert len(gcs) == 1, f"{u} not unique-c-gc (child has {len(gcs)} active)"
        gc = gcs[0]
        p = g.parent[u]  # active by up-closedness (or None if u is root)

        cc_pu = self.cc.get((p, u), frozenset()) if p is not None else frozenset()
        cc_uc = self.cc[(u, c)]
        cc_cgc = self.cc[(c, gc)]

        s = self.next_id
        self.next_id += 1
        chi_s: FrozenSet[str] = frozenset(
            ((g.chi[p] & g.chi[u]) if p is not None else frozenset())
            | (g.chi[u] & g.chi[c])
            | (g.chi[c] & g.chi[gc])
        )
        lam_s = frozenset(cc_pu | cc_uc | cc_cgc)

        # rewire: s replaces the u->c->gc chain segment
        if p is not None:
            g.children[p].remove(u)
            g.children[p].append(s)
        else:
            g.root = s
        g.parent[s] = p
        g.children[s] = [u, c, gc]
        g.parent[u] = s
        g.children[c].remove(gc)
        g.children[u].remove(c)
        g.parent[c] = s
        g.parent[gc] = s
        g.chi[s] = chi_s
        g.lam[s] = lam_s

        # common covers: (p,s) inherits cc(p,u); (s,gc) inherits cc(c,gc)
        if p is not None:
            del self.cc[(p, u)]
            self.cc[(p, s)] = cc_pu
        del self.cc[(u, c)]
        del self.cc[(c, gc)]
        self.cc[(s, gc)] = cc_cgc

        # inactivate u and c (heights from their *inactive* children)
        self.active.add(s)
        self.active.discard(u)
        self.active.discard(c)
        self._assign_height(u)
        self._assign_height(c)
        return s

    # ------------------------------------------------------------- invariants
    def check_invariants(self, query: Query, max_width: int) -> None:
        g = self.ghd
        # 1: active(T') is an up-closed tree containing the root
        if self.active:
            assert g.root in self.active
            for n in self.active:
                p = g.parent[n]
                assert p is None or p in self.active, "active set not up-closed"
        # 2: inactive subtrees fully inactive (implied by up-closedness)
        # 3: heights correct for inactive vertices
        for n in g.nodes():
            if n in self.active:
                continue
            kids = g.children.get(n, [])
            expect = 0 if not kids else 1 + max(self.height[k] for k in kids)
            assert self.height[n] == expect, f"height({n}) wrong"
        # 4: covers valid
        for (p, c), cover in self.cc.items():
            shared = g.chi[p] & g.chi[c]
            u = set()
            for alias in cover:
                u |= query.edges[alias]
            assert shared <= u, f"cc({p},{c}) does not cover"
        # 5: GHD valid with width bound
        g.validate(query)
        assert g.width <= max_width, f"width {g.width} > {max_width}"


def select_inactivation_sets(ext: ExtendedGHD) -> Tuple[List[int], List[int]]:
    """Lemma 16 selection: L' = all active leaves; U' = top-down greedy
    pairwise-non-adjacent unique-c-gc vertices (Lemma 26), excluding any
    vertex adjacent to an already-selected one."""
    leaves = set(ext.active_leaves())
    ucgc = set(ext.unique_cgc())
    g = ext.ghd
    # top-down order over active nodes
    order = [n for n in g.topo_order() if n in ext.active]
    selected: List[int] = []
    forbidden: Set[int] = set()
    for n in order:
        if n in ucgc and n not in forbidden:
            selected.append(n)
            # forbid the unique active child (Lemma 26) and active parent
            forbidden.add(ext.active_children(n)[0])
            p = g.parent[n]
            if p is not None:
                forbidden.add(p)
    return sorted(leaves), selected


def log_gta(
    ghd: GHD,
    query: Query,
    check: bool = False,
    trace: Optional[List[Dict]] = None,
) -> GHD:
    """Main Result 2: returns a GHD with width <= max(w, 3iw) and depth
    min(depth, O(log n))."""
    w = ghd.width
    iw = ghd.intersection_width(query)
    bound = max(w, 3 * iw)
    ext = ExtendedGHD.extend(ghd, query)
    iters = 0
    while ext.active:
        leaves, ucgcs = select_inactivation_sets(ext)
        # unique-c-gc ops first (bottom-up so chains re-resolve consistently)
        ucgcs_bottom_up = sorted(ucgcs, key=lambda n: -ext.ghd.depth_of(n))
        for u in ucgcs_bottom_up:
            ext.inactivate_unique_cgc(u)
        for l in leaves:
            if l in ext.active and not ext.active_children(l):
                ext.inactivate_leaf(l)
        iters += 1
        if trace is not None:
            trace.append(
                {
                    "iter": iters,
                    "active": len(ext.active),
                    "size": ext.ghd.size(),
                    "width": ext.ghd.width,
                    "depth": ext.ghd.depth,
                }
            )
        if check:
            ext.check_invariants(query, bound)
        assert iters <= 4 * max(4, ghd.size()).bit_length() + 8, (
            "Log-GTA failed to converge in O(log n) iterations"
        )
    out = ext.ghd
    out.validate(query)
    assert out.width <= bound
    return out
