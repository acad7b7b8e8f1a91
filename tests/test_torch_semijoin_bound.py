"""The ``bound`` that the semijoin probe's bitmap path rests on, on the CPU.

``local_semijoin_mask`` promises the probe that every key other than
INT32_MAX lies in ``[0, bound)`` with ``bound = n + m`` (the dense ranks
of the n S rows and m R rows).  These tests record each ``bound`` it
passes, on the parity data of ``tests/test_torch_localops.py`` and over
whole ``gym()`` runs, and hold the keys and probes of that call to it:
keys in ``[0, bound)`` or INT32_MAX, probes in ``[-1, bound)``.  They also
hold ``ops.semijoin_probe(..., bound=...)`` on CPU tensors (the plain
version, which ignores ``bound``) to the JAX reference, and the host's
choice of path at the shared-memory limit.  The bitmap kernel itself runs
only on the card (``tests/test_torch_cuda.py``).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.relational import localops as L  # noqa: E402

from repro_torch.core.gym import GymConfig, gym  # noqa: E402
from repro_torch.core.queries import chain_query, star_query, triangle_chain_query  # noqa: E402
from repro_torch.data.synthetic import chain_data_sparse, star_data_sparse, tc_data_sparse  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.kernels import semijoin_probe as SP  # noqa: E402
from repro_torch.relational import localops as TL  # noqa: E402

I32MAX = 2**31 - 1
# the parity data of tests/test_torch_localops.py: (rows per shard of A,
# of B, valid fraction), three shards
CASES = [(7, 5, 0.8), (33, 17, 0.7), (12, 9, 0.0), (1, 1, 1.0), (16, 20, 1.0)]
SHARDS = 3


def _tables(seed, n, ar, frac, dom=4):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, dom, (SHARDS, n, ar)).astype(np.int32)
    v = rng.random((SHARDS, n)) < frac
    return d, v


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture
def probe_calls(monkeypatch):
    """Every (q, keys, bound) the local backends' member_mask is given."""
    calls = []
    for cls in (TL.TorchBackend, TL.CudaBackend):
        orig = cls.member_mask

        def spy(self, q, keys, bound=None, _orig=orig):
            calls.append((q.clone(), keys.clone(), bound))
            return _orig(self, q, keys, bound=bound)

        monkeypatch.setattr(cls, "member_mask", spy)
    return calls


def _assert_keeps_promise(calls):
    assert calls
    for q, keys, bound in calls:
        assert bound == q.shape[-1] + keys.shape[-1]
        valid = keys != I32MAX
        assert bool(((keys[valid] >= 0) & (keys[valid] < bound)).all()), bound
        assert bool(((q >= -1) & (q < bound)).all()), bound


@pytest.mark.parametrize("na,nb,frac", CASES)
def test_local_semijoin_bound_holds_on_localops_parity_data(probe_calls, na, nb, frac):
    s_, sv = _tables(na + 7, na, 3, frac)
    r, rv = _tables(nb + 9, nb, 3, max(frac, 0.4))
    sj = TL.local_semijoin_mask(_t(s_), _t(sv), (0, 2), _t(r), _t(rv), (1, 0))
    it = TL.local_intersect_mask(_t(s_), _t(sv), _t(r), _t(rv), (0, 1, 2), (2, 1, 0))
    assert len(probe_calls) == 2
    _assert_keeps_promise(probe_calls)
    for k in range(SHARDS):
        a, av, b, bv = (jnp.asarray(x[k]) for x in (s_, sv, r, rv))
        np.testing.assert_array_equal(
            sj[k].numpy(), np.asarray(L.local_semijoin_mask(a, av, (0, 2), b, bv, (1, 0)))
        )
        np.testing.assert_array_equal(
            it[k].numpy(),
            np.asarray(L.local_intersect_mask(a, av, b, bv, (0, 1, 2), (2, 1, 0))),
        )


def test_local_semijoin_bound_with_no_key_columns(probe_calls):
    """A zero-column key (every valid row matches) ranks valid rows 0."""
    s_, sv = _tables(1, 6, 2, 0.5)
    r, rv = _tables(2, 4, 2, 0.5)
    got = TL.local_semijoin_mask(_t(s_), _t(sv), (), _t(r), _t(rv), ())
    _assert_keeps_promise(probe_calls)
    for k in range(SHARDS):
        want = L.local_semijoin_mask(
            jnp.asarray(s_[k]), jnp.asarray(sv[k]), (), jnp.asarray(r[k]), jnp.asarray(rv[k]), ()
        )
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))


@pytest.mark.parametrize("family", ["S_8", "C_8", "TC_9"])
def test_gym_semijoin_calls_keep_the_bound(probe_calls, family):
    """Every semijoin of a whole default gym() run (the fused path) passes
    a bound its keys and probes keep (bench_shuffle.py's data, cut)."""
    q, data = {
        "S_8": lambda: (star_query(8), star_data_sparse(8, domain=32, hub_rows=48,
                                                        spoke_extra=16, seed=21)),
        "C_8": lambda: (chain_query(8), chain_data_sparse(8, domain=64, ident=16,
                                                          extra=32, seed=24)),
        "TC_9": lambda: (triangle_chain_query(3), tc_data_sparse(3, domain=48, ident=12,
                                                                  extra=24, seed=22)),
    }[family]()
    gym(q, data, p=4, config=GymConfig(seed=23), device="cpu")
    _assert_keeps_promise(probe_calls)


PROBE_SHAPES = [(1, 1, 1, 2), (3, 130, 257, 387), (2, 0, 5, 5), (2, 13, 0, 13), (4, 40, 23, 63)]


@pytest.mark.parametrize("b,n,m,bound", PROBE_SHAPES)
def test_semijoin_probe_with_bound_on_cpu_is_the_plain_version(b, n, m, bound):
    rng = np.random.default_rng(b * 100 + n + m)
    q = rng.integers(-1, bound, (b, n)).astype(np.int32)
    keys = rng.integers(0, bound, (b, m)).astype(np.int32)
    keys[:, m // 2:] = I32MAX
    got = K.semijoin_probe(_t(q), _t(keys), bound=bound)
    np.testing.assert_array_equal(got.numpy(), SP.semijoin_probe(_t(q), _t(keys)).numpy())
    for i in range(b):
        want = ref.semijoin_probe_ref(jnp.asarray(q[i]), jnp.asarray(keys[i]))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_path_choice_at_the_shared_memory_limit():
    assert SP.MAX_BITMAP_BITS == 1859584
    assert [SP.bitmap_words(b) for b in (0, 1, 128, 129, 1179648)] == [0, 4, 4, 8, 36864]
    assert SP.uses_bitmap(0) and SP.uses_bitmap(1179648) and SP.uses_bitmap(SP.MAX_BITMAP_BITS)
    assert not SP.uses_bitmap(None) and not SP.uses_bitmap(SP.MAX_BITMAP_BITS + 1)
    assert 4 * SP.bitmap_words(SP.MAX_BITMAP_BITS) == SP.MAX_BITMAP_BYTES
