"""Numpy brute-force relational algebra — the oracle for every engine test."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .table import schema_join


def np_join(
    a: np.ndarray, a_schema: Sequence[str], b: np.ndarray, b_schema: Sequence[str]
) -> Tuple[np.ndarray, Tuple[str, ...]]:
    a = np.asarray(a).reshape(-1, len(a_schema))
    b = np.asarray(b).reshape(-1, len(b_schema))
    shared = [x for x in a_schema if x in b_schema]
    ai = [list(a_schema).index(x) for x in shared]
    bi = [list(b_schema).index(x) for x in shared]
    b_keep = [i for i, x in enumerate(b_schema) if x not in set(a_schema)]
    out_schema = schema_join(a_schema, b_schema)
    rows = []
    for ra in a:
        for rb in b:
            if all(ra[i] == rb[j] for i, j in zip(ai, bi)):
                rows.append(list(ra) + [rb[k] for k in b_keep])
    out = np.asarray(rows, dtype=np.int64).reshape(-1, len(out_schema))
    return out, out_schema


def np_semijoin(
    s: np.ndarray, s_schema: Sequence[str], r: np.ndarray, r_schema: Sequence[str]
) -> np.ndarray:
    s = np.asarray(s).reshape(-1, len(s_schema))
    r = np.asarray(r).reshape(-1, len(r_schema))
    shared = [x for x in s_schema if x in r_schema]
    si = [list(s_schema).index(x) for x in shared]
    ri = [list(r_schema).index(x) for x in shared]
    rkeys = {tuple(row[i] for i in ri) for row in r}
    keep = [row for row in s if tuple(row[i] for i in si) in rkeys]
    return np.asarray(keep, dtype=np.int64).reshape(-1, len(s_schema))


def np_dedup(rows: np.ndarray, arity: int) -> np.ndarray:
    rows = np.asarray(rows).reshape(-1, arity)
    return np.unique(rows, axis=0) if rows.size else rows


def np_query_answer(
    atoms: List[Tuple[str, Sequence[str]]], data: Dict[str, np.ndarray]
) -> Tuple[np.ndarray, Tuple[str, ...]]:
    """Full join of atoms [(alias, attrs)] with data[alias] = rows."""
    out, schema = np.asarray(data[atoms[0][0]], np.int64), tuple(atoms[0][1])
    out = out.reshape(-1, len(schema))
    for alias, attrs in atoms[1:]:
        out, schema = np_join(out, schema, data[alias], attrs)
    return out, schema


def canon(rows: np.ndarray) -> set:
    rows = np.asarray(rows)
    return {tuple(int(x) for x in r) for r in rows.reshape(-1, rows.shape[-1])}


def reorder(rows: np.ndarray, schema: Sequence[str], target: Sequence[str]) -> np.ndarray:
    rows = np.asarray(rows).reshape(-1, len(schema))
    idx = [list(schema).index(x) for x in target]
    return rows[:, idx]
