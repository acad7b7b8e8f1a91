"""The paper's example query families (Table 1, Example 4) and their GHDs
from Figure 1, plus random query generators for property tests.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

from .ghd import GHD
from .hypergraph import Atom, Query


# --------------------------------------------------------------------------
# Table 1 families
# --------------------------------------------------------------------------
def star_query(n: int) -> Query:
    """S_n: S(A_1..A_{n-1}) |><| R_1(A_1,B_1) ... R_{n-1}(A_{n-1},B_{n-1})."""
    assert n >= 2
    hub = Atom("S", "S", tuple(f"A{i}" for i in range(1, n)))
    spokes = [Atom(f"R{i}", f"R{i}", (f"A{i}", f"B{i}")) for i in range(1, n)]
    return Query([hub] + spokes, name=f"S_{n}")


def star_ghd(n: int) -> GHD:
    """Figure 1a: root=S with n-1 leaf children; width 1, depth 1."""
    q = star_query(n)
    chi = {0: q.edges["S"]}
    lam = {0: frozenset(["S"])}
    edges = []
    for i in range(1, n):
        chi[i] = q.edges[f"R{i}"]
        lam[i] = frozenset([f"R{i}"])
        edges.append((0, i))
    g = GHD.build(0, edges, chi, lam)
    g.validate(q)
    return g


def chain_query(n: int) -> Query:
    """C_n: R_1(A_0,A_1) |><| R_2(A_1,A_2) ... R_n(A_{n-1},A_n)."""
    assert n >= 1
    atoms = [Atom(f"R{i}", f"R{i}", (f"A{i-1}", f"A{i}")) for i in range(1, n + 1)]
    return Query(atoms, name=f"C_{n}")


def chain_ghd(n: int) -> GHD:
    """Figure 1b: the path GHD; width 1, depth n-1 (rooted at R_n)."""
    q = chain_query(n)
    chi = {i: q.edges[f"R{i}"] for i in range(1, n + 1)}
    lam = {i: frozenset([f"R{i}"]) for i in range(1, n + 1)}
    edges = [(i + 1, i) for i in range(1, n)]  # parent = next atom
    g = GHD.build(n, edges, chi, lam)
    g.validate(q)
    return g


def chain_ghd_grouped(n: int, group: int) -> GHD:
    """Appendix C / Figure 7a style: group consecutive chain atoms into
    width-``group`` bags -> depth ~ n/group chain GHD of C_n."""
    q = chain_query(n)
    groups: List[List[str]] = []
    for start in range(1, n + 1, group):
        groups.append([f"R{i}" for i in range(start, min(start + group, n + 1))])
    chi: Dict[int, frozenset] = {}
    lam: Dict[int, frozenset] = {}
    for gidx, aliases in enumerate(groups):
        attrs = set()
        for a in aliases:
            attrs |= q.edges[a]
        chi[gidx] = frozenset(attrs)
        lam[gidx] = frozenset(aliases)
    edges = [(g + 1, g) for g in range(len(groups) - 1)]
    g = GHD.build(len(groups) - 1, edges, chi, lam)
    g.validate(q)
    return g


def triangle_chain_query(n_triangles: int) -> Query:
    """TC_n from Table 1 with n = 3*n_triangles atoms.

    Triangle t (0-indexed) spans attributes A_{2t}, A_{2t+1}, A_{2t+2} with
    relations on each pair; consecutive triangles share attribute A_{2t+2}.
    """
    assert n_triangles >= 1
    atoms: List[Atom] = []
    k = 1
    for t in range(n_triangles):
        a, b, c = f"A{2*t}", f"A{2*t+1}", f"A{2*t+2}"
        atoms.append(Atom(f"R{k}", f"R{k}", (a, b))); k += 1
        atoms.append(Atom(f"R{k}", f"R{k}", (a, c))); k += 1
        atoms.append(Atom(f"R{k}", f"R{k}", (b, c))); k += 1
    return Query(atoms, name=f"TC_{3*n_triangles}")


def triangle_chain_ghd(n_triangles: int) -> GHD:
    """Figure 1c: one bag per triangle covered by 2 relations; width 2,
    intersection width 1, depth n/3 - 1."""
    q = triangle_chain_query(n_triangles)
    chi: Dict[int, frozenset] = {}
    lam: Dict[int, frozenset] = {}
    for t in range(n_triangles):
        a, b, c = f"A{2*t}", f"A{2*t+1}", f"A{2*t+2}"
        chi[t] = frozenset({a, b, c})
        # two relations cover the triangle: (a,b) and (b,c)
        lam[t] = frozenset({f"R{3*t+1}", f"R{3*t+3}"})
    edges = [(t + 1, t) for t in range(n_triangles - 1)]
    g = GHD.build(n_triangles - 1, edges, chi, lam)
    g.validate(q)
    return g


def example4_query() -> Query:
    """Example 4: R1(A,B,C) R2(B,F) R3(B,C,D) R4(C,D,E) R5(D,E,G)."""
    return Query(
        [
            Atom("R1", "R1", ("A", "B", "C")),
            Atom("R2", "R2", ("B", "F")),
            Atom("R3", "R3", ("B", "C", "D")),
            Atom("R4", "R4", ("C", "D", "E")),
            Atom("R5", "R5", ("D", "E", "G")),
        ],
        name="Example4",
    )


# --------------------------------------------------------------------------
# Random generators (property tests)
# --------------------------------------------------------------------------
def random_acyclic_query(rng: random.Random, n_atoms: int, max_arity: int = 3) -> Query:
    """Random acyclic query built by growing a join tree: each new atom
    shares a random nonempty attr subset with one existing atom and adds
    fresh attrs."""
    attr_id = 0

    def fresh(k: int) -> List[str]:
        nonlocal attr_id
        out = [f"X{attr_id + i}" for i in range(k)]
        attr_id += k
        return out

    atoms: List[Atom] = []
    first_arity = rng.randint(1, max_arity)
    atoms.append(Atom("T0", "T0", tuple(fresh(first_arity))))
    for i in range(1, n_atoms):
        host = rng.choice(atoms)
        k_shared = rng.randint(1, len(host.attrs))
        shared = rng.sample(list(host.attrs), k_shared)
        k_new = rng.randint(0, max(0, max_arity - k_shared))
        attrs = tuple(shared + fresh(k_new))
        atoms.append(Atom(f"T{i}", f"T{i}", attrs))
    return Query(atoms, name=f"RandAcyc{n_atoms}")


def random_query(rng: random.Random, n_atoms: int, n_attrs: int, max_arity: int = 3) -> Query:
    """Random (usually cyclic) connected query over a fixed attr universe."""
    universe = [f"X{i}" for i in range(n_attrs)]
    atoms: List[Atom] = []
    covered: List[str] = []
    for i in range(n_atoms):
        arity = rng.randint(1, max_arity)
        if covered:
            anchor = [rng.choice(covered)]
        else:
            anchor = []
        rest = rng.sample(universe, k=min(arity, len(universe)))
        attrs = tuple(dict.fromkeys(anchor + rest))[:max_arity]
        atoms.append(Atom(f"T{i}", f"T{i}", attrs))
        covered.extend(a for a in attrs if a not in covered)
    q = Query(atoms, name=f"Rand{n_atoms}")
    return q if q.is_connected() else random_query(rng, n_atoms, n_attrs, max_arity)
