"""Hashing and exact multi-column ordering utilities (per-shard, plain torch).

Every function works over any number of leading batch axes: a table is
``(*B, n, ar)`` with valid ``(*B, n)``, and each segment of ``B`` is
hashed, sorted and ranked on its own.

- ``hash_columns``: 32-bit murmur-style column-combining hash -> reducer
  destinations.  uint32 arithmetic runs in int64 masked to 32 bits
  (torch's CPU ``uint32`` has no ``>>``, ``+`` or ``%``), so the result is
  bit-identical to ``repro.relational.hashing`` on every device.
- ``dense_ranks``: exact dictionary encoding of multi-column keys across
  two operand tables via concat + lexsort + run ids.  Sorts are stable, as
  ``jnp.argsort``'s are; torch has no ``lexsort``, so it is successive
  stable sorts from the minor key to the major key.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

M32 = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLD = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32): split ``c`` in
    16-bit halves so no partial product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """fmix32 from murmur3 (bijective on uint32); int64 in, int64 out."""
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    x = x ^ (x >> 16)
    return x


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> its uint32 value held in int64."""
    return x.to(torch.int64) & M32


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 value held in int64 -> the int32 with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def seed_tensor(
    seed: Union[int, torch.Tensor], batch: Tuple[int, ...], device
) -> torch.Tensor:
    """A python int seed or a ``(*B,)`` seed tensor -> ``(*B,)`` int64 in
    [0, 2**32)."""
    if isinstance(seed, torch.Tensor):
        return seed.to(device=device, dtype=torch.int64).expand(batch) & M32
    return torch.full(batch, int(seed) & M32, dtype=torch.int64, device=device)


def hash_columns(data: torch.Tensor, cols: Sequence[int], seed) -> torch.Tensor:
    """(*B, n, ar) int32, selected cols -> (*B, n) uint32 hash (in int64).

    ``seed`` is a python int or a ``(*B,)`` tensor (one seed per segment)."""
    batch = tuple(data.shape[:-2])
    n = data.shape[-2]
    s = seed_tensor(seed, batch, data.device)
    h = mix32(s).unsqueeze(-1).expand(*batch, n)
    for c in cols:
        h = mix32(h ^ ((mix32(as_u32(data[..., c])) + _GOLD) & M32))
    return h


def dests_for(
    data: torch.Tensor, valid: torch.Tensor, cols: Sequence[int], p: int, seed
) -> torch.Tensor:
    """Reducer destination in [0,p) for valid rows; p for invalid (drop)."""
    h = hash_columns(data, cols, seed)
    d = (h % p).to(torch.int32)
    return torch.where(valid, d, torch.full_like(d, p))


def _lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``jnp.lexsort`` over the last axis: the LAST key is the primary one.
    Successive stable sorts, minor key first."""
    perm = None
    for k in keys:
        kk = k if perm is None else k.gather(-1, perm)
        o = torch.argsort(kk, dim=-1, stable=True)
        perm = o if perm is None else perm.gather(-1, o)
    return perm


def _lexsort_cols(cols: Sequence[torch.Tensor], invalid: torch.Tensor) -> torch.Tensor:
    """Order: valid rows sorted lexicographically by cols, invalid last."""
    return _lexsort(list(reversed(cols)) + [invalid.to(torch.int32)])


def sort_rows(data: torch.Tensor, valid: torch.Tensor, cols: Sequence[int]) -> torch.Tensor:
    """Permutation sorting the table by ``cols`` (invalid rows last)."""
    return _lexsort_cols([data[..., c] for c in cols], ~valid)


def _run_ranks(cols: Sequence[torch.Tensor], invalid: torch.Tensor) -> torch.Tensor:
    """Dense run ids of the rows in lexsort order, scattered back to row
    order: equal (cols, invalid) tuples share an id."""
    n = invalid.shape[-1]
    if n == 0:
        return torch.zeros(invalid.shape, dtype=torch.int32, device=invalid.device)
    order = _lexsort_cols(cols, invalid)
    new_run = torch.zeros(invalid.shape, dtype=torch.bool, device=invalid.device)
    new_run[..., 0] = True
    if n > 1:
        diff = torch.zeros_like(new_run[..., 1:])
        for c in cols:
            sc = c.gather(-1, order)
            diff = diff | (sc[..., 1:] != sc[..., :-1])
        si = invalid.gather(-1, order)
        diff = diff | (si[..., 1:] != si[..., :-1])
        new_run[..., 1:] = diff
    run_id = torch.cumsum(new_run.to(torch.int64), dim=-1) - 1
    return torch.zeros_like(run_id).scatter_(-1, order, run_id).to(torch.int32)


def dense_ranks(
    a_data: torch.Tensor, a_valid: torch.Tensor, a_cols: Sequence[int],
    b_data: torch.Tensor, b_valid: torch.Tensor, b_cols: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact shared dictionary encoding of the key columns of two tables.

    Returns int32 (rank_a, rank_b): equal multi-column keys (across either
    table) get equal ranks; distinct keys get distinct ranks.  Invalid rows
    get rank -1 (a) / -2 (b) so they never match anything.
    """
    assert len(a_cols) == len(b_cols)
    na = a_data.shape[-2]
    neg1 = torch.tensor(-1, dtype=torch.int32, device=a_data.device)
    neg2 = torch.tensor(-2, dtype=torch.int32, device=a_data.device)
    zero = torch.tensor(0, dtype=torch.int32, device=a_data.device)
    if not a_cols:  # zero-attr key (cartesian): every valid row matches
        return torch.where(a_valid, zero, neg1), torch.where(b_valid, zero, neg2)
    cols = [
        torch.cat([a_data[..., ca], b_data[..., cb]], dim=-1)
        for ca, cb in zip(a_cols, b_cols)
    ]
    invalid = torch.cat([~a_valid, ~b_valid], dim=-1)
    ranks = _run_ranks(cols, invalid)
    ra = torch.where(a_valid, ranks[..., :na], neg1)
    rb = torch.where(b_valid, ranks[..., na:], neg2)
    return ra, rb


def self_ranks(data: torch.Tensor, valid: torch.Tensor, cols: Sequence[int]) -> torch.Tensor:
    """Dense ranks of one table's key columns (invalid -> -1)."""
    neg1 = torch.tensor(-1, dtype=torch.int32, device=data.device)
    if not cols:
        return torch.where(valid, torch.zeros_like(neg1), neg1)
    ranks = _run_ranks([data[..., c] for c in cols], ~valid)
    return torch.where(valid, ranks, neg1)
