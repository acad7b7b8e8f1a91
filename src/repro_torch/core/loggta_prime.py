"""Log-GTA' (paper Appendix D.2): the edge-labelled variant of Log-GTA.

Carries Lambda/X labels on active edges (copies of the child's lam/chi at
extension time).  A unique-c-gc inactivation builds the new vertex from the
*edge* labels, giving width <= 3w without needing intersection width.
Recovers Bodlaender's (TD) and Akatov's (HD) log-depth results, and is how
we realize the ACQ-MR baseline (Sec. 2.2): GYM on Log-GTA'(D) materializes
joins of <= 3w base relations per node == ACQ's shunt of 3 base relations.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .ghd import GHD
from .hypergraph import Query
from .loggta import select_inactivation_sets  # reuse Lemma 16/26 selection


@dataclass
class ExtendedGHDPrime:
    ghd: GHD
    active: Set[int]
    Lam: Dict[Tuple[int, int], FrozenSet[str]]  # edge -> relation aliases
    X: Dict[Tuple[int, int], FrozenSet[str]]  # edge -> attributes
    height: Dict[int, int]
    next_id: int

    @staticmethod
    def extend(ghd: GHD) -> "ExtendedGHDPrime":
        g = ghd.copy()
        Lam = {(p, c): g.lam[c] for p, c in g.tree_edges()}
        X = {(p, c): g.chi[c] for p, c in g.tree_edges()}
        return ExtendedGHDPrime(
            ghd=g, active=set(g.nodes()), Lam=Lam, X=X,
            height={}, next_id=max(g.nodes()) + 1,
        )

    # same helper surface as ExtendedGHD so selection code can be shared
    def active_children(self, n: int) -> List[int]:
        return [c for c in self.ghd.children.get(n, []) if c in self.active]

    def active_leaves(self) -> List[int]:
        return [n for n in self.active if not self.active_children(n)]

    def unique_cgc(self) -> List[int]:
        out = []
        for u in self.active:
            cs = self.active_children(u)
            if len(cs) == 1 and len(self.active_children(cs[0])) == 1:
                out.append(u)
        return out

    def _assign_height(self, n: int) -> None:
        kids = [c for c in self.ghd.children.get(n, []) if c not in self.active]
        self.height[n] = 0 if not kids else 1 + max(self.height[k] for k in kids)

    def inactivate_leaf(self, l: int) -> None:
        p = self.ghd.parent[l]
        if p is not None:
            self.Lam.pop((p, l), None)
            self.X.pop((p, l), None)
        self.active.remove(l)
        self._assign_height(l)

    def inactivate_unique_cgc(self, u: int) -> int:
        g = self.ghd
        c = self.active_children(u)[0]
        gc = self.active_children(c)[0]
        p = g.parent[u]

        lam_pu = self.Lam.get((p, u), frozenset()) if p is not None else frozenset()
        x_pu = self.X.get((p, u), frozenset()) if p is not None else frozenset()
        lam_uc, x_uc = self.Lam[(u, c)], self.X[(u, c)]
        lam_cgc, x_cgc = self.Lam[(c, gc)], self.X[(c, gc)]

        s = self.next_id
        self.next_id += 1
        g.chi[s] = frozenset(x_pu | x_uc | x_cgc)
        g.lam[s] = frozenset(lam_pu | lam_uc | lam_cgc)

        if p is not None:
            g.children[p].remove(u)
            g.children[p].append(s)
        else:
            g.root = s
        g.parent[s] = p
        g.children[s] = [u, c, gc]
        g.children[u].remove(c)
        g.children[c].remove(gc)
        g.parent[u] = s
        g.parent[c] = s
        g.parent[gc] = s

        if p is not None:
            del self.Lam[(p, u)], self.X[(p, u)]
            self.Lam[(p, s)], self.X[(p, s)] = lam_pu, x_pu
        del self.Lam[(u, c)], self.X[(u, c)]
        del self.Lam[(c, gc)], self.X[(c, gc)]
        self.Lam[(s, gc)], self.X[(s, gc)] = lam_cgc, x_cgc

        self.active.add(s)
        self.active.discard(u)
        self.active.discard(c)
        self._assign_height(u)
        self._assign_height(c)
        return s


def log_gta_prime(ghd: GHD, query: Query) -> GHD:
    """Theorem 30: width' <= 3w, depth min(depth, O(log n))."""
    w = ghd.width
    ext = ExtendedGHDPrime.extend(ghd)
    iters = 0
    while ext.active:
        leaves, ucgcs = select_inactivation_sets(ext)  # duck-typed
        for u in sorted(ucgcs, key=lambda n: -ext.ghd.depth_of(n)):
            ext.inactivate_unique_cgc(u)
        for l in leaves:
            if l in ext.active and not ext.active_children(l):
                ext.inactivate_leaf(l)
        iters += 1
        assert iters <= 4 * max(4, ghd.size()).bit_length() + 8
    out = ext.ghd
    out.validate(query)
    assert out.width <= 3 * w
    return out
