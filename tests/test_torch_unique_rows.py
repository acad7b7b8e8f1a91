"""``relational/table.py::unique_rows``, the base relations' dedup in
``GymDriver`` and ``shares_join``, against ``np.unique(axis=0)``: the same
rows, order and dtype, over arities, value ranges (negative values and
the full int32 span included, where the one-key form does not fit) and
empty and all-equal inputs."""
from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.relational.table import unique_rows  # noqa: E402


def _rows(arity: int, lo: int, hi: int, n: int = 4000, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + arity)
    return rng.integers(lo, hi, size=(n, arity), dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("arity", [1, 2, 3, 4])
@pytest.mark.parametrize("lo,hi", [(0, 3), (-50, 50), (0, 1 << 20), (-(1 << 31), (1 << 31) - 1)],
                         ids=["tiny", "signed", "wide", "int32"])
def test_unique_rows_equals_np_unique(arity, lo, hi):
    a = _rows(arity, lo, hi)
    want, got = np.unique(a, axis=0), unique_rows(a)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("a", [
    np.zeros((0, 3), np.int32),
    np.ones((7, 2), np.int32),
    np.array([[2**31 - 1, -2**31], [-2**31, 2**31 - 1], [0, 0], [0, 0]], np.int32),
], ids=["empty", "all-equal", "extremes"])
def test_unique_rows_edge_cases(a):
    want, got = np.unique(a, axis=0), unique_rows(a)
    assert got.shape == want.shape and got.dtype == want.dtype and np.array_equal(got, want)
