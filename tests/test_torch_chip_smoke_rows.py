"""``chip_smoke.py``'s numpy helpers for its reference answers, on the CPU:
``unique_rows`` must return exactly what ``np.unique(a, axis=0)`` does
(the same rows, order and dtype) and ``row_key`` must order and equate
rows as they compare lexicographically, so that the script's real-size
data and numpy joins stay what they were with ``np.unique(axis=0)``."""
from __future__ import annotations

import itertools
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as CS  # noqa: E402


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("cols", [0, 1, 2, 5])
@pytest.mark.parametrize("span", [3, 2**31 - 1])
def test_unique_rows_is_np_unique_axis0(dtype, cols, span):
    rng = np.random.default_rng(cols * 7 + (span > 3))
    for n in (0, 1, 2, 17, 400):
        a = rng.integers(-span, span, (n, cols)).astype(dtype)
        a = np.concatenate([a, a[: n // 3]])  # repeated rows
        want = np.unique(a, axis=0)
        got = CS.unique_rows(a)
        assert got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want)
        if len(a):
            key = CS.row_key(a)
            _, inv = np.unique(a, axis=0, return_inverse=True)
            inv = inv.reshape(-1)
            # equal rows <-> equal keys, and keys sort as the rows do
            assert np.array_equal(inv[:, None] == inv[None, :], key[:, None] == key[None, :])
            assert np.array_equal(inv[:, None] < inv[None, :], key[:, None] < key[None, :])


def test_row_key_redensifies_wide_rows():
    """Six columns of full-range values pass 2^62 as a product of their
    distinct counts: the fold re-densifies and stays exact."""
    rng = np.random.default_rng(3)
    a = rng.integers(-(2**31), 2**31 - 1, (3000, 6)).astype(np.int64)
    a = np.concatenate([a, a[::7]])
    assert np.array_equal(CS.unique_rows(a), np.unique(a, axis=0))


def test_np_answer_matches_a_brute_force_join():
    """A three-atom chain with repeated keys: the fold of ``np_join`` equals
    the nested-loop join's distinct rows."""
    from types import SimpleNamespace as NS

    rng = np.random.default_rng(5)
    data = {r: rng.integers(0, 6, (40, 2)).astype(np.int32) for r in ("R1", "R2", "R3")}
    atoms = [NS(rel="R1", attrs=("A", "B")), NS(rel="R2", attrs=("B", "C")),
             NS(rel="R3", attrs=("C", "D"))]
    q = NS(atoms=atoms, output_attrs=("A", "B", "C", "D"))
    rows = {(a, b, c, d) for (a, b), (b2, c), (c2, d)
            in itertools.product(data["R1"].tolist(), data["R2"].tolist(), data["R3"].tolist())
            if b == b2 and c == c2}
    want = np.array(sorted(rows), np.int64)
    assert np.array_equal(CS.np_answer(q, data), want)
