"""Fixed-capacity relation tables (local and distributed).

``Table``  — one shard: data (cap, arity) int32 + valid (cap,) bool.
``DTable`` — p shards: data (p, cap, arity) + valid (p, cap); axis 0 is the
reducer axis (an explicit leading tensor axis of the SPMD simulation).  On
a mesh a process holds its rank's block, axis 0 at length 1: ``p`` is then
1, the logical reducer count is ``SPMD.p``, and ``to_numpy(spmd)`` gathers
every rank's rows.

Schemas are python tuples of attribute names, so column arithmetic stays
in Python.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def unique_rows(rows: np.ndarray) -> np.ndarray:
    """``np.unique(rows, axis=0)`` of a 2-D integer array: the distinct
    rows in lexicographic order, in ``rows``' dtype.  Where every column's
    span fits, the rows are folded into one int64 key a row (each column's
    offset from its minimum, in mixed radix), whose order is the rows',
    and one 1-D ``np.unique`` of the keys does the work: several times
    faster than the record sort of ``axis=0``."""
    rows = np.asarray(rows)
    if rows.shape[0] == 0 or rows.shape[1] == 0:
        return np.unique(rows, axis=0)
    lo = rows.min(axis=0).astype(np.int64)
    span = rows.max(axis=0).astype(np.int64) - lo + 1
    if float(np.prod(span.astype(np.float64))) >= 2.0**62:
        return np.unique(rows, axis=0)
    key = np.zeros(rows.shape[0], np.int64)
    for j in range(rows.shape[1]):
        key = key * span[j] + (rows[:, j].astype(np.int64) - lo[j])
    key = np.unique(key)
    out = np.empty((key.shape[0], rows.shape[1]), rows.dtype)
    for j in range(rows.shape[1] - 1, -1, -1):
        key, r = np.divmod(key, span[j])
        out[:, j] = r + lo[j]
    return out


def _canon(rows: np.ndarray, arity: int) -> np.ndarray:
    """Valid rows, lexicographically sorted (canonical for comparisons)."""
    if rows.size == 0:
        return rows.reshape(0, arity)
    order = np.lexsort(rows.T[::-1])
    return rows[order]


@dataclasses.dataclass
class Table:
    data: torch.Tensor  # (cap, arity) int32
    valid: torch.Tensor  # (cap,) bool
    schema: Tuple[str, ...]

    @property
    def cap(self) -> int:
        return self.data.shape[-2]

    @property
    def arity(self) -> int:
        return self.data.shape[-1]

    def count(self) -> torch.Tensor:
        return self.valid.sum()

    def col(self, attr: str) -> int:
        return self.schema.index(attr)

    def cols(self, attrs: Sequence[str]) -> Tuple[int, ...]:
        return tuple(self.schema.index(a) for a in attrs)

    @staticmethod
    def from_numpy(
        rows: np.ndarray, schema: Sequence[str], cap: Optional[int] = None,
        device="cpu",
    ) -> "Table":
        rows = np.asarray(rows, dtype=np.int32).reshape(-1, len(schema))
        n = rows.shape[0]
        cap = cap or max(1, n)
        assert n <= cap, f"{n} rows > cap {cap}"
        data = np.zeros((cap, len(schema)), np.int32)
        data[:n] = rows
        valid = np.zeros((cap,), bool)
        valid[:n] = True
        return Table(
            torch.from_numpy(data).to(device), torch.from_numpy(valid).to(device),
            tuple(schema),
        )

    def to_numpy(self) -> np.ndarray:
        """Valid rows, lexicographically sorted (canonical for comparisons)."""
        d = self.data.cpu().numpy()
        v = self.valid.cpu().numpy()
        return _canon(d[v], self.arity)

    def to_set(self) -> set:
        return {tuple(int(x) for x in r) for r in self.to_numpy()}


@dataclasses.dataclass
class DTable:
    data: torch.Tensor  # (p, cap, arity) int32
    valid: torch.Tensor  # (p, cap) bool
    schema: Tuple[str, ...]

    @property
    def p(self) -> int:
        """Shards held here (the rank's block on a mesh: 1)."""
        return self.data.shape[0]

    @property
    def cap(self) -> int:
        return self.data.shape[1]

    @property
    def arity(self) -> int:
        return self.data.shape[2]

    def col(self, attr: str) -> int:
        return self.schema.index(attr)

    def cols(self, attrs: Sequence[str]) -> Tuple[int, ...]:
        return tuple(self.schema.index(a) for a in attrs)

    def count(self) -> torch.Tensor:
        return self.valid.sum()

    def shard(self, i: int) -> Table:
        return Table(self.data[i], self.valid[i], self.schema)

    @staticmethod
    def scatter_numpy(
        rows: np.ndarray, schema: Sequence[str], p: int, cap: Optional[int] = None,
        seed: int = 0, device="cpu",
    ) -> "DTable":
        """Round-robin scatter of rows over p shards (initial 'file system'
        placement; any placement is fine — ops re-shuffle as needed).  Row
        i lands on shard ``i % p`` at offset ``i // p``."""
        rows = np.asarray(rows, dtype=np.int32).reshape(-1, len(schema))
        n = rows.shape[0]
        per = int(np.ceil(n / p)) if n else 1
        cap = cap or max(1, per)
        assert per <= cap or n == 0, f"scatter overflow: {n} rows, p={p}, cap={cap}"
        data = np.zeros((p, cap, len(schema)), np.int32)
        valid = np.zeros((p, cap), bool)
        i = np.arange(n)
        data[i % p, i // p] = rows
        valid[i % p, i // p] = True
        return DTable(
            torch.from_numpy(data).to(device), torch.from_numpy(valid).to(device),
            tuple(schema),
        )

    def to_numpy(self, spmd=None) -> np.ndarray:
        """Valid rows of every shard, sorted; with a mesh ``spmd`` the rows
        of every rank's block, gathered, so each rank returns them all."""
        if spmd is None:
            d, v = self.data.cpu().numpy(), self.valid.cpu().numpy()
        else:
            d, v = spmd.to_host_many(self.data, self.valid)
        return _canon(d.reshape(-1, self.arity)[v.reshape(-1)], self.arity)

    def to_set(self) -> set:
        return {tuple(int(x) for x in r) for r in self.to_numpy()}


def schema_join(a: Sequence[str], b: Sequence[str]) -> Tuple[str, ...]:
    """Output schema of a natural join: a's attrs then b's new attrs."""
    return tuple(a) + tuple(x for x in b if x not in a)


def schema_project(schema: Sequence[str], keep: Sequence[str]) -> Tuple[str, ...]:
    return tuple(a for a in schema if a in set(keep))
