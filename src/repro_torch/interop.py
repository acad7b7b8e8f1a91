"""Carry a plan and a dataset across from the reference package as plain
Python and numpy — never by importing it.

- ``ghd_from_dict``: a ``GHD.to_dict()`` dictionary -> the port's ``GHD``;
- ``query_from_atoms``: ``(alias, rel, attrs)`` triples -> the port's
  ``Query``;
- ``dtable_from_numpy``: a ``(data, valid, schema)`` numpy triple -> a
  ``DTable`` on a given device.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.ghd import GHD
from .core.hypergraph import Atom, Query
from .relational.table import DTable


def ghd_from_dict(d: Dict[str, Any]) -> GHD:
    return GHD.from_dict(d)


def query_from_atoms(
    atoms: Iterable[Tuple[str, str, Sequence[str]]], name: Optional[str] = None
) -> Query:
    q = [Atom(a, r, tuple(attrs)) for a, r, attrs in atoms]
    return Query(q) if name is None else Query(q, name=name)


def dtable_from_numpy(
    data: np.ndarray, valid: np.ndarray, schema: Sequence[str], device="cpu"
) -> DTable:
    return DTable(
        torch.from_numpy(np.array(data, dtype=np.int32)).to(device),
        torch.from_numpy(np.array(valid, dtype=bool)).to(device),
        tuple(schema),
    )
