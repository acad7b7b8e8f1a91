"""``repro_torch.relational.hashing`` against ``repro.relational.hashing``:
bit-exact destinations (uint32 arithmetic in int64 on the CPU), dense
ranks and self ranks (stable lexsort as successive stable sorts)."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.relational import hashing as H  # noqa: E402

from repro_torch.relational import hashing as TH  # noqa: E402

I32MAX = 2**31 - 1
I32MIN = -(2**31)


def _rows(seed, n, ar, dom=None):
    rng = np.random.default_rng(seed)
    if dom is None:
        vals = [I32MIN, I32MIN + 1, -7, -1, 0, 1, 3, I32MAX - 1, I32MAX]
        rows = rng.choice(vals, size=(n, ar)).astype(np.int32)
    else:
        rows = rng.integers(-dom, dom, (n, ar)).astype(np.int32)
    return rows, rng.random(n) < 0.75


@pytest.mark.parametrize("p", [1, 3, 4, 7, 8, 31])
def test_dests_for_bit_exact(p):
    rows, valid = _rows(p, 301, 3)
    for cols in ((0,), (2, 1), (0, 1, 2), ()):
        for seed in (0, 13, 7919 * 5, 2**31, 2**32 - 1):
            want = np.asarray(H.dests_for(jnp.asarray(rows), jnp.asarray(valid), cols, p, seed))
            got = TH.dests_for(torch.from_numpy(rows), torch.from_numpy(valid), cols, p, seed)
            np.testing.assert_array_equal(got.numpy(), want)
            # a per-segment seed tensor hashes like the python int
            got_t = TH.dests_for(
                torch.from_numpy(rows)[None], torch.from_numpy(valid)[None], cols, p,
                torch.tensor([seed]),
            )
            np.testing.assert_array_equal(got_t[0].numpy(), want)


def test_hash_columns_and_mix32_bit_exact():
    rows, _ = _rows(1, 64, 2)
    for seed in (0, 1, 2**32 - 1):
        want = np.asarray(H.hash_columns(jnp.asarray(rows), (1, 0), seed))
        got = TH.hash_columns(torch.from_numpy(rows), (1, 0), seed)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    x = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
    np.testing.assert_array_equal(
        TH.mix32(torch.from_numpy(x.astype(np.int64))).numpy(),
        np.asarray(H.mix32(jnp.asarray(x))).astype(np.int64),
    )


@pytest.mark.parametrize("na,nb,ar,dom", [(9, 7, 2, 3), (33, 17, 3, 4), (5, 1, 1, 2)])
def test_dense_ranks_exact(na, nb, ar, dom):
    a, av = _rows(na, na, ar, dom)
    b, bv = _rows(nb + 100, nb, ar + 1, dom)
    for a_cols, b_cols in (((0,), (1,)), (tuple(range(ar)), tuple(range(1, ar + 1))), ((), ())):
        ra, rb = H.dense_ranks(
            jnp.asarray(a), jnp.asarray(av), a_cols, jnp.asarray(b), jnp.asarray(bv), b_cols
        )
        ta, tb = TH.dense_ranks(
            torch.from_numpy(a), torch.from_numpy(av), a_cols,
            torch.from_numpy(b), torch.from_numpy(bv), b_cols,
        )
        assert ta.dtype == torch.int32
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ra))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(rb))


def test_self_ranks_and_sort_rows_exact():
    rows, valid = _rows(4, 40, 3, dom=3)
    for cols in ((0,), (2, 0), (0, 1, 2), ()):
        want = np.asarray(H.self_ranks(jnp.asarray(rows), jnp.asarray(valid), cols))
        got = TH.self_ranks(torch.from_numpy(rows), torch.from_numpy(valid), cols)
        np.testing.assert_array_equal(got.numpy(), want)
    for cols in ((0,), (2, 0), (1, 2, 0)):
        want = np.asarray(H.sort_rows(jnp.asarray(rows), jnp.asarray(valid), cols))
        got = TH.sort_rows(torch.from_numpy(rows), torch.from_numpy(valid), cols)
        np.testing.assert_array_equal(got.numpy(), want)


def test_ranks_over_batch_axes_match_per_segment():
    rows, valid = _rows(6, 3 * 2 * 11, 2, dom=3)
    rows, valid = rows.reshape(3, 2, 11, 2), valid.reshape(3, 2, 11)
    got = TH.self_ranks(torch.from_numpy(rows), torch.from_numpy(valid), (1, 0))
    for i in range(3):
        for j in range(2):
            want = H.self_ranks(jnp.asarray(rows[i, j]), jnp.asarray(valid[i, j]), (1, 0))
            np.testing.assert_array_equal(got[i, j].numpy(), np.asarray(want))
