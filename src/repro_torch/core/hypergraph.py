"""Hypergraphs and join queries (Section 3.1 of the paper).

A natural join query is a hypergraph: one vertex per attribute, one
hyperedge per relation *atom*.  Atoms carry an ``alias`` (unique within the
query, so self-joins are representable) and the name of the underlying
``rel`` whose data they read.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Atom:
    """One relation occurrence in a query: alias, base-relation name, attrs."""

    alias: str
    rel: str
    attrs: Tuple[str, ...]

    def __post_init__(self):
        if len(set(self.attrs)) != len(self.attrs):
            raise ValueError(f"atom {self.alias}: repeated attribute in {self.attrs}")

    @property
    def attr_set(self) -> FrozenSet[str]:
        return frozenset(self.attrs)


@dataclass
class Query:
    """A full conjunctive (natural-join) query, possibly with self-joins."""

    atoms: List[Atom]
    name: str = "Q"

    def __post_init__(self):
        aliases = [a.alias for a in self.atoms]
        if len(set(aliases)) != len(aliases):
            raise ValueError("atom aliases must be unique")
        self._by_alias = {a.alias: a for a in self.atoms}

    # -- hypergraph view ----------------------------------------------------
    @property
    def vertices(self) -> FrozenSet[str]:
        out = set()
        for a in self.atoms:
            out |= a.attr_set
        return frozenset(out)

    @property
    def edges(self) -> Dict[str, FrozenSet[str]]:
        """alias -> attribute set."""
        return {a.alias: a.attr_set for a in self.atoms}

    def atom(self, alias: str) -> Atom:
        return self._by_alias[alias]

    @property
    def n(self) -> int:
        return len(self.atoms)

    @property
    def output_attrs(self) -> Tuple[str, ...]:
        """Full queries: output schema = all attributes (stable order)."""
        seen: List[str] = []
        for a in self.atoms:
            for v in a.attrs:
                if v not in seen:
                    seen.append(v)
        return tuple(seen)

    def is_connected(self) -> bool:
        if not self.atoms:
            return True
        todo = [self.atoms[0].alias]
        seen = {self.atoms[0].alias}
        while todo:
            cur = self._by_alias[todo.pop()]
            for other in self.atoms:
                if other.alias not in seen and cur.attr_set & other.attr_set:
                    seen.add(other.alias)
                    todo.append(other.alias)
        return len(seen) == len(self.atoms)

    def primal_graph(self) -> Dict[str, set]:
        """Attribute co-occurrence graph (for tree-decomposition heuristics)."""
        adj: Dict[str, set] = {v: set() for v in self.vertices}
        for a in self.atoms:
            for u, v in itertools.combinations(a.attrs, 2):
                adj[u].add(v)
                adj[v].add(u)
        return adj


def min_edge_cover(
    target: FrozenSet[str],
    edges: Dict[str, FrozenSet[str]],
    max_k: Optional[int] = None,
) -> Optional[FrozenSet[str]]:
    """Smallest set of hyperedges (by alias) whose union covers ``target``.

    Exact search by increasing cardinality; the candidates are restricted to
    edges that intersect ``target``.  Used for intersection-width (paper
    Sec. 3.1) where the answer is <= the GHD width, i.e. tiny.
    Returns None if no cover exists (cannot happen for GHD-induced targets).
    """
    if not target:
        return frozenset()
    cands = [(alias, e & target) for alias, e in edges.items() if e & target]
    # Deduplicate by covered set, keeping one representative alias (smallest
    # alias for determinism); dominated candidates are pruned.
    best_for_cover: Dict[FrozenSet[str], str] = {}
    for alias, cov in sorted(cands):
        if cov not in best_for_cover:
            best_for_cover[cov] = alias
    items = sorted(best_for_cover.items(), key=lambda kv: (-len(kv[0]), kv[1]))
    covers = [cov for cov, _ in items]
    aliases = [al for _, al in items]
    limit = max_k if max_k is not None else len(covers)
    for k in range(1, min(limit, len(covers)) + 1):
        for combo in itertools.combinations(range(len(covers)), k):
            u = set()
            for i in combo:
                u |= covers[i]
            if target <= u:
                return frozenset(aliases[i] for i in combo)
    return None
