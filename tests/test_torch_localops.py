"""``repro_torch.relational.localops`` against ``repro.relational.localops``
(the ``'jnp'`` reference) on ragged and all-invalid shards, exactly, with
the port's ``'torch'`` backend on the CPU.  Each port call takes a stack
of shards at once; each shard must answer as the single-shard reference.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.relational import localops as L  # noqa: E402

from repro_torch.relational import localops as TL  # noqa: E402

# (rows per shard of A, of B, valid fraction): ragged, tiny and all-invalid
CASES = [(7, 5, 0.8), (33, 17, 0.7), (12, 9, 0.0), (1, 1, 1.0), (16, 20, 1.0)]
SHARDS = 3


def _tables(seed, n, ar, frac, dom=4):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, dom, (SHARDS, n, ar)).astype(np.int32)
    v = rng.random((SHARDS, n)) < frac
    return d, v


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return jnp.asarray(x)


@pytest.mark.parametrize("na,nb,frac", CASES)
def test_compact_exact(na, nb, frac):
    d, v = _tables(na, na, 3, frac)
    for out_cap in (max(1, na // 2), na, 2 * na + 3):
        od, ov, dropped = TL.compact(_t(d), _t(v), out_cap)
        for s in range(SHARDS):
            wd, wv, wdr = L.compact(_j(d[s]), _j(v[s]), out_cap)
            np.testing.assert_array_equal(od[s].numpy(), np.asarray(wd))
            np.testing.assert_array_equal(ov[s].numpy(), np.asarray(wv))
            assert int(dropped[s]) == int(wdr)


@pytest.mark.parametrize("na,nb,frac", CASES)
def test_join_and_join_count_exact(na, nb, frac):
    a, av = _tables(na, na, 3, frac)
    b, bv = _tables(nb + 50, nb, 2, max(frac, 0.5))
    a_key, b_key, b_keep = (1,), (0,), (1,)
    for out_cap in (4, 64):
        od, ov, over = TL.local_join(_t(a), _t(av), _t(b), _t(bv), a_key, b_key, b_keep, out_cap)
        cnt = TL.local_join_count(_t(a), _t(av), _t(b), _t(bv), a_key, b_key)
        for s in range(SHARDS):
            wd, wv, wo = L.local_join(
                _j(a[s]), _j(av[s]), _j(b[s]), _j(bv[s]), a_key, b_key, b_keep, out_cap
            )
            np.testing.assert_array_equal(od[s].numpy(), np.asarray(wd))
            np.testing.assert_array_equal(ov[s].numpy(), np.asarray(wv))
            assert int(over[s]) == int(wo)
            wc = L.local_join_count(_j(a[s]), _j(av[s]), _j(b[s]), _j(bv[s]), a_key, b_key)
            assert int(cnt[s]) == int(wc)


def test_join_ranked_with_per_segment_keep_columns():
    """The fused path passes b_keep as a (segments, nkeep) tensor."""
    a, av = _tables(1, 10, 2, 0.9)
    b, bv = _tables(2, 8, 3, 0.9)
    keeps = np.array([[1, 2], [2, 1], [0, 2]])
    ra, rb = TL.dense_ranks(_t(a), _t(av), (0,), _t(b), _t(bv), (0,))
    od, ov, over = TL.local_join_ranked(
        _t(a), _t(av), ra, _t(b), _t(bv), rb, torch.from_numpy(keeps), 32
    )
    for s in range(SHARDS):
        wd, wv, wo = L.local_join(
            _j(a[s]), _j(av[s]), _j(b[s]), _j(bv[s]), (0,), (0,), tuple(keeps[s]), 32
        )
        np.testing.assert_array_equal(od[s].numpy(), np.asarray(wd))
        assert int(over[s]) == int(wo)


@pytest.mark.parametrize("na,nb,frac", CASES)
def test_semijoin_intersect_dedup_project_exact(na, nb, frac):
    s_, sv = _tables(na + 7, na, 3, frac)
    r, rv = _tables(nb + 9, nb, 3, max(frac, 0.4))
    sj = TL.local_semijoin_mask(_t(s_), _t(sv), (0, 2), _t(r), _t(rv), (1, 0))
    it = TL.local_intersect_mask(_t(s_), _t(sv), _t(r), _t(rv), (0, 1, 2), (2, 1, 0))
    dd = TL.local_dedup_mask(_t(s_), _t(sv), (0, 1))
    pd, pv = TL.local_project(_t(s_), _t(sv), (2, 0), True)
    pd0, pv0 = TL.local_project(_t(s_), _t(sv), (1,), False)
    for k in range(SHARDS):
        a, av, b, bv = _j(s_[k]), _j(sv[k]), _j(r[k]), _j(rv[k])
        np.testing.assert_array_equal(
            sj[k].numpy(), np.asarray(L.local_semijoin_mask(a, av, (0, 2), b, bv, (1, 0)))
        )
        np.testing.assert_array_equal(
            it[k].numpy(),
            np.asarray(L.local_intersect_mask(a, av, b, bv, (0, 1, 2), (2, 1, 0))),
        )
        np.testing.assert_array_equal(dd[k].numpy(), np.asarray(L.local_dedup_mask(a, av, (0, 1))))
        wd, wv = L.local_project(a, av, (2, 0), True)
        np.testing.assert_array_equal(pd[k].numpy(), np.asarray(wd))
        np.testing.assert_array_equal(pv[k].numpy(), np.asarray(wv))
        wd, wv = L.local_project(a, av, (1,), False)
        np.testing.assert_array_equal(pd0[k].numpy(), np.asarray(wd))
        np.testing.assert_array_equal(pv0[k].numpy(), np.asarray(wv))


def test_backend_registry_and_cuda_backend_refuses_cpu_tensors():
    assert set(TL.LOCAL_BACKENDS) == {"torch", "cuda"}
    assert TL.default_backend("cpu") == "torch"
    with pytest.raises(ValueError, match="unknown local backend"):
        TL.get_local_backend("pallas")
    d, v = _tables(3, 5, 2, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        TL.get_local_backend("cuda").dests(_t(d), _t(v), (0,), 4, 0)
    with pytest.raises(ValueError, match="CUDA"):
        TL.local_semijoin_mask(_t(d), _t(v), (0,), _t(d), _t(v), (0,), backend="cuda")
