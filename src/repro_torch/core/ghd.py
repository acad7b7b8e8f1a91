"""Generalized hypertree decompositions (GHDs), paper Section 3.1.

A GHD of a query hypergraph H is (T, chi, lam):
  1. every hyperedge e is contained in chi(t) for some tree vertex t;
  2. for every attribute v, {t : v in chi(t)} is connected in T  (running
     intersection);
  3. chi(t) is covered by the union of the hyperedges in lam(t).

Width = max |lam(t)|; depth = depth of the rooted tree; intersection width
(the paper's new notion) = max over tree edges (t,t') of the smallest number
of hyperedges covering chi(t) & chi(t').
"""
from __future__ import annotations

import copy
import itertools
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

from .hypergraph import Query, min_edge_cover


@dataclass
class GHD:
    root: int
    parent: Dict[int, Optional[int]]
    children: Dict[int, List[int]]
    chi: Dict[int, FrozenSet[str]]
    lam: Dict[int, FrozenSet[str]]  # aliases of atoms

    # -- construction helpers -------------------------------------------------
    @staticmethod
    def build(
        root: int,
        edges: Iterable[Tuple[int, int]],  # (parent, child)
        chi: Dict[int, Iterable[str]],
        lam: Dict[int, Iterable[str]],
    ) -> "GHD":
        parent: Dict[int, Optional[int]] = {root: None}
        children: Dict[int, List[int]] = {n: [] for n in chi}
        for p, c in edges:
            parent[c] = p
            children[p].append(c)
        for n in chi:
            parent.setdefault(n, None)
        g = GHD(
            root=root,
            parent=parent,
            children=children,
            chi={n: frozenset(v) for n, v in chi.items()},
            lam={n: frozenset(v) for n, v in lam.items()},
        )
        g._check_tree()
        return g

    def _check_tree(self):
        seen = set()
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n in seen:
                raise ValueError("cycle in GHD tree")
            seen.add(n)
            stack.extend(self.children.get(n, []))
        if seen != set(self.chi):
            raise ValueError(
                f"tree nodes {sorted(seen)} != chi nodes {sorted(self.chi)}"
            )

    # -- basic accessors -------------------------------------------------------
    def nodes(self) -> List[int]:
        return list(self.chi.keys())

    def tree_edges(self) -> List[Tuple[int, int]]:
        return [(p, c) for c, p in self.parent.items() if p is not None]

    def copy(self) -> "GHD":
        return GHD(
            root=self.root,
            parent=dict(self.parent),
            children={k: list(v) for k, v in self.children.items()},
            chi=dict(self.chi),
            lam=dict(self.lam),
        )

    def depth_of(self, n: int) -> int:
        d = 0
        while self.parent[n] is not None:
            n = self.parent[n]
            d += 1
        return d

    @property
    def depth(self) -> int:
        """Depth of the tree = max #edges root->leaf (a single node has 0)."""
        best = 0
        stack = [(self.root, 0)]
        while stack:
            n, d = stack.pop()
            best = max(best, d)
            for c in self.children.get(n, []):
                stack.append((c, d + 1))
        return best

    @property
    def width(self) -> int:
        return max(len(l) for l in self.lam.values())

    def size(self) -> int:
        return len(self.chi)

    # -- serialization (snapshots must replay the exact decomposition) --------
    def to_dict(self) -> Dict:
        return {
            "root": self.root,
            "parent": {str(n): p for n, p in self.parent.items()},
            "children": {str(n): list(c) for n, c in self.children.items()},
            "chi": {str(n): sorted(v) for n, v in self.chi.items()},
            "lam": {str(n): sorted(v) for n, v in self.lam.items()},
        }

    @staticmethod
    def from_dict(d: Dict) -> "GHD":
        g = GHD(
            root=int(d["root"]),
            parent={int(n): p for n, p in d["parent"].items()},
            children={int(n): list(c) for n, c in d["children"].items()},
            chi={int(n): frozenset(v) for n, v in d["chi"].items()},
            lam={int(n): frozenset(v) for n, v in d["lam"].items()},
        )
        g._check_tree()
        return g

    # -- subtree / ordering helpers -------------------------------------------
    def topo_order(self) -> List[int]:
        """Root-first order."""
        out: List[int] = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(self.children.get(n, []))
        return out

    def leaves(self) -> List[int]:
        return [n for n in self.nodes() if not self.children.get(n)]

    # -- validity ---------------------------------------------------------------
    def validate(self, query: Query, require_lambda_subset: bool = True) -> None:
        """Raise AssertionError unless this is a valid GHD of ``query``."""
        edges = query.edges
        nodes = set(self.nodes())
        # tree consistency
        for p, c in self.tree_edges():
            assert p in nodes and c in nodes
            assert c in self.children[p]
        # property 1: every hyperedge covered by some chi(t)
        for alias, e in edges.items():
            assert any(e <= self.chi[t] for t in nodes), (
                f"hyperedge {alias}={sorted(e)} not covered by any bag"
            )
        # property 2: running intersection per attribute
        for v in query.vertices:
            holders = {t for t in nodes if v in self.chi[t]}
            if not holders:
                continue
            # connected <=> exactly one holder whose parent is not a holder
            roots = [t for t in holders if self.parent[t] not in holders]
            assert len(roots) == 1, (
                f"attribute {v} bags not connected: {sorted(holders)}"
            )
        # property 3: lambda covers chi
        for t in nodes:
            if require_lambda_subset:
                for alias in self.lam[t]:
                    assert alias in edges, f"unknown alias {alias} in lam({t})"
            cov = set()
            for alias in self.lam[t]:
                cov |= edges[alias]
            assert self.chi[t] <= cov, (
                f"chi({t})={sorted(self.chi[t])} not covered by "
                f"lam({t})={sorted(self.lam[t])}"
            )

    # -- paper statistics --------------------------------------------------------
    def intersection_width(self, query: Query) -> int:
        """Max over adjacent (t,t') of min #hyperedges covering chi(t)&chi(t')."""
        edges = query.edges
        iw = 0
        for p, c in self.tree_edges():
            shared = self.chi[p] & self.chi[c]
            cover = min_edge_cover(shared, edges)
            assert cover is not None
            iw = max(iw, len(cover))
        return iw

    def edge_cover(self, t1: int, t2: int, query: Query) -> FrozenSet[str]:
        """A minimum cover of the shared attributes of adjacent t1,t2."""
        shared = self.chi[t1] & self.chi[t2]
        cover = min_edge_cover(shared, query.edges)
        assert cover is not None
        return cover

    def is_complete(self, query: Query) -> bool:
        assigned = set()
        for l in self.lam.values():
            assigned |= l
        return assigned >= set(query.edges)

    def is_strongly_complete(self, query: Query) -> bool:
        """Every atom R has a node t with R in lam(t) AND attrs(R) <= chi(t).

        This is what GYM's materialization stage needs so that
        ``join_v IDB_v == Q`` where ``IDB_v = proj_chi(v)(join lam(v))``:
        the node t is where atom R is actually *enforced*.
        """
        for alias, e in query.edges.items():
            if not any(
                alias in self.lam[t] and e <= self.chi[t] for t in self.nodes()
            ):
                return False
        return True

    # -- Lemma 7: minimal + complete form ----------------------------------------
    def make_complete(self, query: Query) -> "GHD":
        """Lemma 7: produce a *minimal, complete* GHD with depth <= d+1,
        same width / intersection width, and O(n) nodes.

        Step 1 (minimality): repeatedly delete degree-<=2 vertices that do not
        uniquely cover some hyperedge (leaves are dropped; degree-2 vertices
        are spliced out).
        Step 2 (completeness): for every unassigned hyperedge e, hang a new
        leaf l with chi(l)=lam(l)={e} under some vertex whose bag contains e.
        """
        g = self.copy()
        edges = query.edges

        def uniquely_covers(t: int) -> bool:
            others = [u for u in g.nodes() if u != t]
            for alias, e in edges.items():
                if e <= g.chi[t] and not any(e <= g.chi[u] for u in others):
                    return True
            return False

        changed = True
        while changed and g.size() > 1:
            changed = False
            for t in list(g.nodes()):
                if g.size() == 1:
                    break
                deg = len(g.children.get(t, [])) + (0 if g.parent[t] is None else 1)
                if deg > 2 or uniquely_covers(t):
                    continue
                if deg <= 1 and not (t == g.root and g.children.get(t)):
                    g._remove_leafish(t)
                    changed = True
                elif deg == 2:
                    g._splice_degree2(t)
                    changed = True

        # completeness (strong form: need a node with alias in lam AND
        # attrs <= chi -- what GYM's materialization semantics require)
        nid = max(g.nodes()) + 1
        for alias, e in edges.items():
            if any(alias in g.lam[t] and e <= g.chi[t] for t in g.nodes()):
                continue
            # preferred cheap fix: some node already has e <= chi; just add
            # the alias to its lam (never changes chi, keeps width if room —
            # else hang a new leaf).
            host = next(t for t in g.topo_order() if e <= g.chi[t])
            if len(g.lam[host]) < max(len(l) for l in g.lam.values()):
                g.lam[host] = g.lam[host] | {alias}
            else:
                g.parent[nid] = host
                g.children.setdefault(host, []).append(nid)
                g.children[nid] = []
                g.chi[nid] = frozenset(e)
                g.lam[nid] = frozenset([alias])
                nid += 1
        g.validate(query)
        assert g.is_strongly_complete(query)
        return g

    def _remove_leafish(self, t: int) -> None:
        """Remove a node of degree <=1 (a leaf, or an isolated/root-with-one-child)."""
        p = self.parent[t]
        kids = self.children.get(t, [])
        assert len(kids) + (0 if p is None else 1) <= 1
        if p is not None:
            self.children[p].remove(t)
        elif kids:  # t is root with exactly one child: child becomes root
            c = kids[0]
            self.parent[c] = None
            self.root = c
        del self.parent[t], self.chi[t], self.lam[t]
        self.children.pop(t, None)

    def _splice_degree2(self, t: int) -> None:
        p = self.parent[t]
        kids = self.children.get(t, [])
        if p is None:
            # root with two children: promote one child as root, attach other under it
            assert len(kids) == 2
            a, b = kids
            self.parent[a] = None
            self.root = a
            self.parent[b] = a
            self.children[a].append(b)
        else:
            assert len(kids) == 1
            c = kids[0]
            self.children[p].remove(t)
            self.children[p].append(c)
            self.parent[c] = p
        del self.parent[t], self.chi[t], self.lam[t]
        self.children.pop(t, None)

    def __repr__(self) -> str:  # compact debugging form
        lines = []
        stack = [(self.root, 0)]
        while stack:
            n, d = stack.pop()
            lines.append(
                "  " * d
                + f"[{n}] chi={{{','.join(sorted(self.chi[n]))}}} "
                + f"lam={{{','.join(sorted(self.lam[n]))}}}"
            )
            for c in reversed(self.children.get(n, [])):
                stack.append((c, d + 1))
        return "\n".join(lines)
