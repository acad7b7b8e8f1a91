"""The port's kernel modules on the CPU: each plain PyTorch version against
``repro.kernels.ref`` and the Pallas kernel in interpret mode, exactly
(all data is int32/bool).  The CUDA kernels themselves run only on the
card: ``chip_smoke.py`` holds each against these plain versions there,
and ``tests/test_torch_cuda.py`` holds them there under the ``cuda``
marker."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.hash_partition import hash_partition as pl_hash  # noqa: E402
from repro.kernels.semijoin_probe import semijoin_probe as pl_probe  # noqa: E402
from repro.kernels.sorted_probe import sorted_probe_ranges as pl_ranges  # noqa: E402

from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.semijoin_probe import table_slots  # noqa: E402

I32MAX = 2**31 - 1
I32MIN = -(2**31)
EDGE_VALS = [I32MAX - 1, I32MIN + 1, I32MIN + 2, -5, -1, 0, 1, 5]


def _probe_arrays(rng, n, m, nvalid):
    q = rng.choice(EDGE_VALS, size=n).astype(np.int32)
    keys = rng.choice(EDGE_VALS, size=m).astype(np.int32)
    keys[nvalid:] = I32MAX
    return q, keys


PROBE_CASES = [
    (1, 1, 1),
    (7, 5, 3),
    (130, 257, 200),  # off every block boundary
    (13, 0, 0),       # empty key table
    (17, 9, 0),       # all-invalid key table
    (0, 5, 5),        # no probes at all
]


@pytest.mark.parametrize("n,m,nvalid", PROBE_CASES)
def test_semijoin_probe_plain_vs_reference(n, m, nvalid):
    rng = np.random.default_rng(n * 31 + m * 7 + nvalid)
    q, keys = _probe_arrays(rng, n, m, nvalid)
    want = np.asarray(ref.semijoin_probe_ref(jnp.asarray(q), jnp.asarray(keys)))
    got = tref.semijoin_probe_ref(torch.from_numpy(q)[None], torch.from_numpy(keys)[None])
    np.testing.assert_array_equal(got[0].numpy(), want)
    pallas = np.asarray(pl_probe(jnp.asarray(q), jnp.asarray(keys), interpret=True))
    np.testing.assert_array_equal(got[0].numpy(), pallas)
    # the switch follows the tensors' device: CPU tensors -> plain version
    np.testing.assert_array_equal(
        K.semijoin_probe(torch.from_numpy(q)[None], torch.from_numpy(keys)[None])[0].numpy(),
        want,
    )


@pytest.mark.parametrize("n,m,nvalid", PROBE_CASES)
def test_sorted_probe_plain_vs_reference(n, m, nvalid):
    rng = np.random.default_rng(n * 37 + m * 11 + nvalid)
    q, keys = _probe_arrays(rng, n, m, nvalid)
    ks = np.sort(keys)
    rlo, rhi = ref.sorted_probe_ranges_ref(jnp.asarray(q), jnp.asarray(ks))
    plo, phi = pl_ranges(jnp.asarray(q), jnp.asarray(ks), interpret=True)
    lo, hi = tref.sorted_probe_ranges_ref(torch.from_numpy(q)[None], torch.from_numpy(ks)[None])
    assert lo.dtype == torch.int32 and hi.dtype == torch.int32
    for got, want in ((lo, rlo), (hi, rhi), (lo, plo), (hi, phi)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_probes_over_many_segments():
    """One call serves B segments (a fused group's shards x instances);
    each segment answers as the single-segment reference does."""
    rng = np.random.default_rng(5)
    b, n, m = 6, 40, 23
    q = rng.integers(-3, 30, (b, n)).astype(np.int32)
    keys = rng.integers(0, 30, (b, m)).astype(np.int32)
    keys[:, 17:] = I32MAX
    keys[4] = I32MAX  # one all-invalid segment
    mask = tref.semijoin_probe_ref(torch.from_numpy(q), torch.from_numpy(keys))
    ks = np.sort(keys, axis=1)
    lo, hi = tref.sorted_probe_ranges_ref(torch.from_numpy(q), torch.from_numpy(ks))
    for i in range(b):
        want = ref.semijoin_probe_ref(jnp.asarray(q[i]), jnp.asarray(keys[i]))
        np.testing.assert_array_equal(mask[i].numpy(), np.asarray(want))
        rlo, rhi = ref.sorted_probe_ranges_ref(jnp.asarray(q[i]), jnp.asarray(ks[i]))
        np.testing.assert_array_equal(lo[i].numpy(), np.asarray(rlo))
        np.testing.assert_array_equal(hi[i].numpy(), np.asarray(rhi))


@pytest.mark.parametrize("p", [1, 3, 4, 7, 8, 31])
def test_hash_partition_plain_vs_reference(p):
    rng = np.random.default_rng(p)
    n, ar = 1041, 3
    rows = rng.choice(EDGE_VALS + [I32MAX, I32MIN], size=(n, ar)).astype(np.int32)
    valid = rng.random(n) < 0.8
    cols = (2, 0)
    trows = torch.from_numpy(np.ascontiguousarray(rows[:, list(cols)]))[None]
    tvalid = torch.from_numpy(valid)[None]
    for seed in (0, 13, 2**31 + 5, 2**32 - 1):
        want = np.asarray(ref.hash_partition_ref(jnp.asarray(rows), jnp.asarray(valid), cols, p, seed))
        got = tref.hash_partition_ref(trows, tvalid, p, torch.tensor([seed]))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), want)
    pallas = pl_hash(jnp.asarray(rows), jnp.asarray(valid), cols, p, 2**32 - 1, interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(pallas))


def test_hash_partition_zero_key_columns_is_seed_only():
    """Zero key columns: every valid row gets the seed-only hash."""
    valid = np.array([True, False, True, True])
    want = np.asarray(ref.hash_partition_ref(
        jnp.zeros((4, 2), jnp.int32), jnp.asarray(valid), (), 7, 99
    ))
    got = tref.hash_partition_ref(
        torch.zeros((1, 4, 0), dtype=torch.int32), torch.from_numpy(valid)[None], 7,
        torch.tensor([99]),
    )
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_hash_partition_per_segment_seeds():
    """Each segment hashes with its own seed (seeds ride as data)."""
    rng = np.random.default_rng(9)
    rows = rng.integers(-50, 50, (4, 33, 2)).astype(np.int32)
    valid = rng.random((4, 33)) < 0.9
    seeds = [0, 7919, 2**32 - 1, 123456789]
    got = tref.hash_partition_ref(
        torch.from_numpy(rows), torch.from_numpy(valid), 8, torch.tensor(seeds)
    )
    for i, s in enumerate(seeds):
        want = ref.hash_partition_ref(jnp.asarray(rows[i]), jnp.asarray(valid[i]), (0, 1), 8, s)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_table_slots_keep_load_at_most_half():
    for m in (0, 1, 2, 3, 1000, 1024, 1025):
        s = table_slots(m)
        assert s & (s - 1) == 0 and s >= max(2, 2 * m)


def test_use_cuda_with_cpu_tensors_raises():
    q = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        K.semijoin_probe(q, q, use_cuda=True)
    with pytest.raises(ValueError, match="CUDA"):
        K.sorted_probe_ranges(q, q, use_cuda=True)
    with pytest.raises(ValueError, match="CUDA"):
        K.hash_partition(q[..., None], q.bool(), 4, torch.zeros(1, dtype=torch.int64), use_cuda=True)
