"""The port's CUDA kernels on the card (``cuda`` marker; skipped without
one — a CUDA kernel has no CPU mode).  This file imports no JAX, so it
runs on a machine with PyTorch alone:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel must equal its plain PyTorch version exactly, and the default
``gym()`` with the ``'cuda'`` backend must equal the ``'torch'`` backend
in rows and ledger."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

I32MAX = 2**31 - 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda_device):
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref

    rng = np.random.default_rng(1)
    b, n, m = 5, 3000, 2100
    q = torch.from_numpy(rng.integers(-1, 4000, (b, n)).astype(np.int32)).to(cuda_device)
    keys = torch.from_numpy(rng.integers(0, 4000, (b, m)).astype(np.int32)).to(cuda_device)
    keys[:, 1500:] = I32MAX
    assert torch.equal(K.semijoin_probe(q, keys), ref.semijoin_probe_ref(q, keys))
    ks = torch.sort(keys, dim=-1).values
    lo, hi = K.sorted_probe_ranges(q, ks)
    rlo, rhi = ref.sorted_probe_ranges_ref(q, ks)
    assert torch.equal(lo, rlo) and torch.equal(hi, rhi)
    rows = torch.from_numpy(rng.integers(-99, 99, (b, n, 3)).astype(np.int32)).to(cuda_device)
    valid = torch.from_numpy(rng.random((b, n)) < 0.8).to(cuda_device)
    seeds = torch.tensor([0, 1, 2**31, 2**32 - 1, 77], device=cuda_device)
    for p in (7, 8):
        assert torch.equal(
            K.hash_partition(rows, valid, p, seeds), ref.hash_partition_ref(rows, valid, p, seeds)
        )


@pytest.mark.cuda
def test_cuda_backend_gym_matches_torch_backend(cuda_device):
    from repro_torch.core.gym import GymConfig, gym
    from repro_torch.core.queries import chain_ghd, chain_query
    from repro_torch.data.synthetic import chain_data_sparse
    from repro_torch.kernels import ops as K

    q, g = chain_query(8), chain_ghd(8)
    data = chain_data_sparse(8, domain=256, ident=64, extra=192, seed=24)
    K.reset_launch_counts()
    rows, schema, led = gym(q, data, ghd=g, p=8, config=GymConfig(seed=23))
    assert all(v > 0 for v in K.launch_counts().values())
    trows, tschema, tled = gym(
        q, data, ghd=g, p=8, config=GymConfig(seed=23, local_backend="torch"), device="cuda"
    )
    assert tuple(schema) == tuple(tschema)
    np.testing.assert_array_equal(rows, trows)
    assert [dataclasses.asdict(r) for r in led.records] == [
        dataclasses.asdict(r) for r in tled.records
    ]
