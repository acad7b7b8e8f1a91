"""The port's CUDA kernels on the card (``cuda`` marker; skipped without
one — a CUDA kernel has no CPU mode).  This file imports no JAX, so it
runs on a machine with PyTorch alone:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each gym kernel and the packed wire's codec kernels must equal their plain
PyTorch versions exactly, the flash attention kernel must agree with its
plain version within the f32/bf16 tolerances stated below, and the default
``gym()``, the grid and hybrid engines, the packed wire, ``plan="auto"``
and the log-depth entry points with the ``'cuda'`` backend must equal the
``'torch'`` backend in rows and ledger."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

I32MAX = 2**31 - 1
GYM_KERNELS = ("hash_partition", "semijoin_probe", "sorted_probe_ranges")


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
    assert all(K.launch_counts()[k] > 0 for k in GYM_KERNELS)
    trows, tschema, tled = gym(
        q, data, ghd=g, p=8, config=GymConfig(seed=23, local_backend="torch"), device="cuda"
    )
    assert tuple(schema) == tuple(tschema)
    np.testing.assert_array_equal(rows, trows)
    assert [dataclasses.asdict(r) for r in led.records] == [
        dataclasses.asdict(r) for r in tled.records
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_matches_plain_version(cuda_device, dtype):
    """Tolerance: f32 1e-4 abs (both accumulate in f32, in another
    order); bf16 1.6e-2 abs at |o| <= 1, relative above (both round an
    f32 result to bf16 once; a value on a rounding boundary may land one
    or two ulps apart)."""
    from repro_torch.kernels import ops as K
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    tol = 1e-4 if dtype == "float32" else 1.6e-2
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(2)
    # (h, kvh, sq, sk, d, causal, window, softcap)
    for h, kvh, sq, sk, d, causal, window, softcap in [
        (8, 8, 130, 130, 64, True, 0, 0.0),
        (8, 4, 70, 200, 128, True, 0, 50.0),
        (8, 1, 200, 70, 256, False, 33, 0.0),
        (4, 2, 129, 1, 16, False, 0, 0.0),
        (2, 1, 96, 16, 80, False, 8, 50.0),  # padded head width, masked rows
    ]:
        q = torch.from_numpy(4 * rng.standard_normal((2, h, sq, d))).to(cuda_device, dt)
        k = torch.from_numpy(rng.standard_normal((2, kvh, sk, d))).to(cuda_device, dt)
        v = torch.from_numpy(rng.standard_normal((2, kvh, sk, d))).to(cuda_device, dt)
        kw = dict(causal=causal, window=window, softcap=softcap)
        K.reset_launch_counts()
        got = flash_attention(q, k, v, **kw).float()
        torch.cuda.synchronize()
        assert K.launch_counts()["flash_attention"] == 1
        want = flash_attention_plain(q, k, v, **kw).float()
        err = ((got - want).abs() / want.abs().clamp(min=1.0)).max().item()
        assert err <= tol, (h, kvh, sq, sk, d, causal, window, softcap, err)
        rows = torch.arange(sq, device=cuda_device)[:, None]
        cols = torch.arange(sk, device=cuda_device)[None, :]
        vis = torch.ones((sq, sk), dtype=torch.bool, device=cuda_device)
        if causal:
            vis &= cols <= rows
        if window > 0:
            vis &= cols > rows - window
        dead = ~vis.any(dim=1)
        assert torch.all(got[:, :, dead] == 0)


def _sorted_segment(rng, m, meff, lo, hi):
    k = np.full(m, I32MAX, np.int32)
    k[:meff] = np.sort(rng.integers(lo, hi, meff))
    return k


# (segments, n, m, valid lengths cycled over the segments): n on and off
# the 1024-probe tile and 4-probe groups; m_eff 0, 1, below the 1024
# splitters, off the splitter stride, the whole segment
SORTED_PROBE_SHAPES = [
    (4, 4096, 4096, (0, 1, 700, 4096)),
    (4, 1027, 4096, (0, 1, 700, 4096)),
    (2, 2**14 + 2, 2**21, (2**20 + 12345, 2**21 - 1)),
    (70000, 6, 3, (0, 1, 2, 3)),  # more segments than a grid's y dimension
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m,meffs", SORTED_PROBE_SHAPES, ids=["tile", "off_tile", "off_stride", "70000_segments"])
def test_cuda_sorted_probe_edge_cases(cuda_device, b, n, m, meffs):
    """Exact: every early out (probes -1 and INT32_MIN + 1 below the first
    key, probes above the last valid key), each valid length and tile edge."""
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref

    rng = np.random.default_rng(b + n)
    hi_val = max(64, 2 * m)
    meff = np.array([meffs[i % len(meffs)] for i in range(b)])[:, None]
    keys = np.sort(np.where(np.arange(m)[None, :] < meff,
                            rng.integers(-50, hi_val, (b, m)), I32MAX), axis=1).astype(np.int32)
    q = rng.integers(-60, hi_val + 60, (b, n)).astype(np.int32)
    q[:, ::7] = -1
    q[:, 3::11] = -(2**31) + 1
    tq, tk = torch.from_numpy(q).to(cuda_device), torch.from_numpy(keys).to(cuda_device)
    K.reset_launch_counts()
    lo, hi = K.sorted_probe_ranges(tq, tk)
    torch.cuda.synchronize()
    assert K.launch_counts()["sorted_probe_ranges"] == 1
    rlo, rhi = ref.sorted_probe_ranges_ref(tq, tk)
    assert torch.equal(lo, rlo) and torch.equal(hi, rhi)


@pytest.mark.cuda
def test_cuda_sorted_probe_equal_run_fills_a_segment(cuda_device):
    from repro_torch.kernels import ops as K

    keys = torch.full((2, 2**20), 5, dtype=torch.int32, device=cuda_device)
    keys[1, 2**19:] = I32MAX
    q = torch.tensor([[5, 4, 6, -1]] * 2, dtype=torch.int32, device=cuda_device)
    lo, hi = K.sorted_probe_ranges(q, keys)
    assert (hi - lo).tolist() == [[2**20, 0, 0, 0], [2**19, 0, 0, 0]]
    assert lo.tolist() == [[0, 0, 2**20, 0], [0, 0, 2**19, 0]]


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(2**16 + 3, 2**10), (1027, 2**20)])
def test_cuda_sorted_probe_empty_key_and_few_distinct(cuda_device, n, m):
    """The cross joins of the grid multiway join: an empty join key ranks
    every valid row 0, so each probe's range is its whole segment; and
    segments of three distinct keys.  Exact against the plain version."""
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref

    meff = np.array([m, m // 8, 1, 0, m - 1, 3])
    keys = np.where(np.arange(m)[None, :] < meff[:, None], 0, I32MAX).astype(np.int32)
    q = np.zeros((6, n), np.int32)
    q[:, ::9] = -1
    tq, tk = torch.from_numpy(q).to(cuda_device), torch.from_numpy(keys).to(cuda_device)
    lo, hi = K.sorted_probe_ranges(tq, tk)
    rlo, rhi = ref.sorted_probe_ranges_ref(tq, tk)
    assert torch.equal(lo, rlo) and torch.equal(hi, rhi)
    assert (hi - lo)[:, 1].tolist() == meff.tolist() and int(lo[:, 1].abs().max()) == 0
    rng = np.random.default_rng(n)
    keys = np.sort(rng.integers(0, 3, (6, m)), axis=1).astype(np.int32)
    keys[:, m - m // 5:] = I32MAX
    tk = torch.from_numpy(keys).to(cuda_device)
    tq = torch.from_numpy(rng.integers(-1, 4, (6, n)).astype(np.int32)).to(cuda_device)
    lo, hi = K.sorted_probe_ranges(tq, tk)
    rlo, rhi = ref.sorted_probe_ranges_ref(tq, tk)
    assert torch.equal(lo, rlo) and torch.equal(hi, rhi)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["grid", "loggta", "acq_mr"])
def test_cuda_grid_and_log_depth_paths_match_torch_backend(cuda_device, plan):
    """``strategy="grid"`` on C_8, and the log-depth entry points (3-atom
    bags, cross bags among them) under the default engine: the 'cuda'
    backend equals the 'torch' backend in rows and ledger, and every gym
    kernel launches."""
    from repro_torch.core import acq_mr as A
    from repro_torch.core.gym import GymConfig, gym
    from repro_torch.core.queries import chain_ghd, chain_query
    from repro_torch.data.synthetic import chain_data_sparse
    from repro_torch.kernels import ops as K

    q, g = chain_query(8), chain_ghd(8)
    if plan == "grid":
        data = chain_data_sparse(8, domain=256, ident=64, extra=192, seed=24)
        run = lambda cfg: gym(q, data, ghd=g, p=8, config=cfg, device="cuda")  # noqa: E731
        kw = dict(strategy="grid")
    else:
        data = chain_data_sparse(8, domain=64, ident=16, extra=24, seed=5)
        entry = A.gym_loggta if plan == "loggta" else A.acq_mr
        run = lambda cfg: entry(q, data, ghd=g, p=8, config=cfg, device="cuda")  # noqa: E731
        kw = {}
    K.reset_launch_counts()
    rows, schema, led = run(GymConfig(seed=23, **kw))
    assert all(K.launch_counts()[k] > 0 for k in GYM_KERNELS)
    trows, tschema, tled = run(GymConfig(seed=23, local_backend="torch", **kw))
    assert tuple(schema) == tuple(tschema)
    np.testing.assert_array_equal(rows, trows)
    assert [dataclasses.asdict(r) for r in led.records] == [
        dataclasses.asdict(r) for r in tled.records
    ]
    assert led.output_tuples > 0


@pytest.mark.cuda
@pytest.mark.parametrize("h,kvh,sq,sk,d,causal,window,softcap", [
    (2, 1, 130, 130, 64, True, 0, 50.0),      # off the 128-row block, group 2
    (2, 2, 70, 200, 128, True, 5, 0.0),       # Sq < Skv, window < a 64-key tile
    (4, 1, 200, 70, 256, False, 0, 50.0),     # Sq > Skv, group 4
    (8, 1, 333, 77, 256, True, 0, 50.0),      # group 8, rows past Skv see all keys
    (16, 8, 4608, 4608, 256, True, 0, 50.0),  # the main path's global layer
])
def test_cuda_flash_attention_bf16_tensor_core_path(cuda_device, h, kvh, sq, sk, d, causal,
                                                    window, softcap):
    """The bf16 wgmma kernel against its plain version: 1.6e-2 abs at |o|
    <= 1, relative above (both round an f32 result to bf16 once; the kernel
    also rounds the weights P to bf16 for its tensor-core product), and
    every fully masked row exactly 0."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    rng = np.random.default_rng(sq + sk + d)
    b = 2
    q = torch.from_numpy(4 * rng.standard_normal((b, h, sq, d))).to(cuda_device, torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal((b, kvh, sk, d))).to(cuda_device, torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((b, kvh, sk, d))).to(cuda_device, torch.bfloat16)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = flash_attention(q, k, v, **kw).float()
    want = flash_attention_plain(q, k, v, **kw).float()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    err = ((got - want).abs() / want.abs().clamp(min=1.0)).max().item()
    assert err <= 1.6e-2, err
    rows = torch.arange(sq, device=cuda_device)[:, None]
    cols = torch.arange(sk, device=cuda_device)[None, :]
    vis = torch.ones((sq, sk), dtype=torch.bool, device=cuda_device)
    if causal:
        vis &= cols <= rows
    if window > 0:
        vis &= cols > rows - window
    assert torch.all(got[:, :, ~vis.any(dim=1)] == 0)


@pytest.mark.cuda
def test_cuda_flash_attention_bf16_unaligned_inputs(cuda_device):
    """Contiguous bf16 views whose base is not 16-byte aligned (the tensor
    maps need it) give the same output as aligned copies."""
    from repro_torch.kernels.flash_attention import flash_attention

    rng = np.random.default_rng(4)
    shapes = [(1, 4, 100, 64), (1, 2, 100, 64), (1, 2, 100, 64)]
    flat = [torch.from_numpy(rng.standard_normal(int(np.prod(s)) + 1)).to(
        cuda_device, torch.bfloat16) for s in shapes]
    q, k, v = (f[1:].view(s) for f, s in zip(flat, shapes))
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    got = flash_attention(q, k, v, causal=True, softcap=50.0)
    want = flash_attention(q.clone(), k.clone(), v.clone(), causal=True, softcap=50.0)
    assert torch.equal(got, want)


def _bitmap_case(rng, b, n, m, bound):
    """Keys in [0, bound) with INT32_MAX padding and one all-padding
    segment; probes over [-1, bound) with 0, bound - 1 and -1 planted."""
    keys = rng.integers(0, max(bound, 1), (b, m)).astype(np.int32)
    keys[:, m // 2:] = I32MAX
    if b > 1:
        keys[1] = I32MAX
    if m > 2 and bound > 0:
        keys[0, :2] = (0, bound - 1)
    q = rng.integers(-1, max(bound, 1), (b, n)).astype(np.int32)
    if n > 3:
        q[:, :3] = (0, bound - 1, -1)
    q[:, 5::7] = -1
    return q, keys


# (segments, n, m, bound): bound off a multiple of 32 and of the 128-bit
# row, n off 4 (the scalar head and tail), n = 0, m = 0, the main path's
# bound n + m, more segments than the card has SMs, the largest bound one
# block's shared memory takes, and one bit past it (the hash path)
BITMAP_SHAPES = [
    (3, 1003, 517, 1003 + 517),
    (5, 4096, 4096, 8192),
    (4, 0, 300, 300),
    (4, 300, 0, 300),
    (2, 2**16 + 3, 2**13, 2**16 + 3 + 2**13),
    (300, 517, 129, 517 + 129),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m,bound", BITMAP_SHAPES,
                         ids=["off_32", "aligned", "n0", "m0", "off_4", "300_segments"])
def test_cuda_semijoin_bitmap_path_matches_plain(cuda_device, b, n, m, bound):
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref

    rng = np.random.default_rng(b * 7 + n + m)
    q, keys = _bitmap_case(rng, b, n, m, bound)
    tq, tk = torch.from_numpy(q).to(cuda_device), torch.from_numpy(keys).to(cuda_device)
    K.reset_launch_counts()
    got = K.semijoin_probe(tq, tk, bound=bound)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.semijoin_probe_ref(tq, tk))
    assert K.semijoin_probe_path_counts() == {"bitmap": int(b * n > 0), "hash": 0}


@pytest.mark.cuda
def test_cuda_semijoin_bitmap_largest_bound_and_one_past(cuda_device):
    """The largest bound that fits one block's shared memory takes the
    bitmap path; one bit more takes the hash path; both equal the plain
    version, with keys and probes at the top of the range."""
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref
    from repro_torch.kernels.semijoin_probe import MAX_BITMAP_BITS

    rng = np.random.default_rng(3)
    for bound, path in ((MAX_BITMAP_BITS, "bitmap"), (MAX_BITMAP_BITS + 1, "hash")):
        q, keys = _bitmap_case(rng, 3, 2**15 + 1, 2**14, bound)
        keys[2, :4] = (bound - 1, bound - 2, bound - 32, bound - 33)
        q[2, -4:] = (bound - 1, bound - 2, bound - 32, bound)
        tq, tk = torch.from_numpy(q).to(cuda_device), torch.from_numpy(keys).to(cuda_device)
        K.reset_launch_counts()
        got = K.semijoin_probe(tq, tk, bound=bound)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.semijoin_probe_ref(tq, tk)), bound
        assert K.semijoin_probe_path_counts()[path] == 1


@pytest.mark.cuda
def test_cuda_semijoin_unaligned_probes_and_no_bound(cuda_device):
    """A probe view off 16 bytes (copied for the bitmap path) and a call
    without bound (the hash path, any int32 keys) equal the plain version."""
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref

    rng = np.random.default_rng(6)
    q, keys = _bitmap_case(rng, 2, 1001, 400, 1401)
    flat = torch.from_numpy(np.concatenate([[7], q.reshape(-1)]).astype(np.int32)).to(cuda_device)
    tq = flat[1:].view(2, 1001)
    tk = torch.from_numpy(keys).to(cuda_device)
    assert tq.is_contiguous() and tq.data_ptr() % 16 != 0
    want = ref.semijoin_probe_ref(tq, tk)
    K.reset_launch_counts()
    assert torch.equal(K.semijoin_probe(tq, tk, bound=1401), want)
    keys[0, :3] = (-(2**31) + 1, I32MAX - 1, -5)
    tk = torch.from_numpy(keys).to(cuda_device)
    assert torch.equal(K.semijoin_probe(tq, tk), ref.semijoin_probe_ref(tq, tk))
    torch.cuda.synchronize()
    assert K.semijoin_probe_path_counts() == {"bitmap": 1, "hash": 1}


_TRAP_SCRIPT = """
import sys, torch
from repro_torch.kernels import ops as K
key = int(sys.argv[1])
q = torch.arange(-1, 100, dtype=torch.int32, device="cuda").reshape(1, 101)
keys = torch.tensor([[3, key, 2**31 - 1]], dtype=torch.int32, device="cuda")
mask = K.semijoin_probe(q, keys, bound=100)
torch.cuda.synchronize()
print("mask", int(mask.sum()))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("key,traps", [(99, False), (100, True), (-5, True)])
def test_cuda_semijoin_bitmap_broken_promise_traps(cuda_device, key, traps):
    """A key outside [0, bound) stops the kernel with a trap: the process
    exits nonzero (run apart, so this process's CUDA context survives)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _TRAP_SCRIPT, str(key)], env=env,
                          capture_output=True, text=True, timeout=300)
    if traps:
        assert proc.returncode != 0 and "mask" not in proc.stdout, proc.stdout
    else:
        assert proc.returncode == 0 and "mask 2" in proc.stdout, proc.stderr[-2000:]


def _planted_pair(dev, p=4, heavy=30, light=10, seed=1):
    """(A, B) join pair with ``heavy`` distinct A rows sharing B = 0 (the
    reference skew tests' planted pair), scattered onto ``dev``."""
    from repro_torch.relational.table import DTable

    rng = np.random.default_rng(seed)
    a = np.stack([rng.permutation(heavy + light),
                  np.concatenate([np.zeros(heavy, int), rng.integers(1, 16, light)])], 1)
    b = np.stack([np.arange(16), rng.integers(0, 9, 16)], 1)
    return (
        DTable.scatter_numpy(np.unique(a.astype(np.int32), axis=0), ("A", "B"), p, cap=16, device=dev),
        DTable.scatter_numpy(np.unique(b.astype(np.int32), axis=0), ("B", "C"), p, cap=8, device=dev),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["join", "semijoin"])
def test_cuda_hybrid_payloads_match_torch_backend(cuda_device, op):
    """Both hybrid payloads (``hybrid_join_many``, ``hybrid_semijoin_many``)
    through their sequential fronts on a planted heavy key: the 'cuda'
    backend equals the 'torch' backend in the output planes and stats,
    the key routes heavy, and the op's kernels launch."""
    from repro_torch.kernels import ops as K
    from repro_torch.relational import ops as R
    from repro_torch.relational.spmd import SPMD

    spmd = SPMD(4, device=cuda_device)
    a, b = _planted_pair(cuda_device)
    fn = R.dist_join_hybrid if op == "join" else R.dist_semijoin_hybrid
    # a join expands its matches with the sorted probe, a semijoin masks
    # with the semijoin probe; both route with hash_partition
    probe = "sorted_probe_ranges" if op == "join" else "semijoin_probe"
    K.reset_launch_counts()
    out, st = fn(spmd, a, b, seed=5, backend="cuda")
    assert K.launch_counts()["hash_partition"] > 0 and K.launch_counts()[probe] > 0
    tout, tst = fn(spmd, a, b, seed=5, backend="torch")
    assert torch.equal(out.data, tout.data) and torch.equal(out.valid, tout.valid)
    assert st == tst and st["heavy"] > 0 and st["dropped"] == 0


@pytest.mark.cuda
def test_cuda_hybrid_engine_planted_star_matches_torch_backend(cuda_device):
    """``strategy="hybrid"`` on the planted heavy-key S_8 of the reference
    skew tests (p = 4): 'cuda' equals 'torch' in rows and every record,
    heavy keys route, no retry, and every gym kernel launches."""
    from repro_torch.core.gym import GymConfig, gym
    from repro_torch.core.queries import star_ghd, star_query
    from repro_torch.data.synthetic import star_data_heavy
    from repro_torch.kernels import ops as K

    q, g = star_query(8), star_ghd(8)
    data = star_data_heavy(8, hub_rows=64, heavy_share=0.8, domain=32, spoke_extra=8, seed=5)
    K.reset_launch_counts()
    rows, schema, led = gym(q, data, ghd=g, p=4, device="cuda",
                            config=GymConfig(strategy="hybrid", seed=3))
    assert all(K.launch_counts()[k] > 0 for k in GYM_KERNELS)
    trows, tschema, tled = gym(q, data, ghd=g, p=4, device="cuda",
                               config=GymConfig(strategy="hybrid", seed=3, local_backend="torch"))
    assert tuple(schema) == tuple(tschema)
    np.testing.assert_array_equal(rows, trows)
    assert [dataclasses.asdict(r) for r in led.records] == [
        dataclasses.asdict(r) for r in tled.records
    ]
    assert led.heavy_tuples > 0 and led.retries == 0


# ------------------------------------------------------ packed wire codec
def _codec_case(rng, col_bits, s, c, occupancy):
    cols = []
    for nb in col_bits:
        if nb == 32:
            col = rng.integers(-(2**31), 2**31, (s, c), dtype=np.int64)
        else:
            col = rng.integers(0, 2**nb, (s, c), dtype=np.int64)
        cols.append(col.astype(np.int32))
    buf = np.stack(cols, axis=-1) if cols else np.zeros((s, c, 0), np.int32)
    if occupancy == "empty":
        valid = np.zeros((s, c), bool)
    elif occupancy == "full":
        valid = np.ones((s, c), bool)
    else:
        valid = rng.random((s, c)) < 0.6
    return buf, valid


CODEC_CASES = [
    # (col_bits, segments, c, occupancy)
    ((), 5, 37, "random"),                 # arity 0: the valid bit alone
    ((32, 32), 3, 64, "random"),           # 32-bit columns, negative values
    ((6,) * 7, 8, 33, "random"),           # c off a multiple of 8
    ((6,) * 7, 8, 0, "random"),            # c = 0
    ((5, 1, 17), 4, 40, "empty"),
    ((5, 1, 17), 4, 40, "full"),
    ((1,), 2, 8, "random"),                # row_bits = 2
    ((32,) * 8, 3, 96, "random"),          # row_bits = 1 + 8 * 32
    ((21,) * 7, 64, 4099, "random"),       # many segments, many warps
]


@pytest.mark.cuda
@pytest.mark.parametrize("col_bits,s,c,occupancy", CODEC_CASES)
def test_cuda_wire_codec_matches_plain_versions(cuda_device, col_bits, s, c, occupancy):
    """The codec kernels' bytes equal the plain bit-plane version's, and
    decode inverts them exactly (decode also equals the plain decode)."""
    from repro_torch.kernels import wire_codec as WC
    from repro_torch.relational import wire as W

    rng = np.random.default_rng(len(col_bits) * 1000 + c)
    buf, valid = _codec_case(rng, col_bits, s, c, occupancy)
    fmt = W.WireFormat(col_bits)
    tb = torch.from_numpy(buf).to(cuda_device)
    tv = torch.from_numpy(valid).to(cuda_device)
    n0 = WC.encode_launches
    got = WC.wire_encode(tb, tv, fmt)
    want = W.wire_encode(tb, tv, fmt)
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    b2, v2 = WC.wire_decode(got, fmt, c)
    pb, pv = W.wire_decode(want, fmt, c)
    assert torch.equal(b2, tb) and torch.equal(v2, tv)
    assert torch.equal(b2, pb) and torch.equal(v2, pv)
    assert WC.encode_launches - n0 == (1 if got.numel() else 0)


@pytest.mark.cuda
def test_cuda_wire_codec_golden_fixture(cuda_device):
    import os

    from repro_torch.kernels import wire_codec as WC
    from repro_torch.relational import wire as W

    z = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "wire_s8_packed.npz"))
    fmt = W.WireFormat(tuple(z["col_bits"].tolist()))
    packed = torch.from_numpy(z["wire"]).to(cuda_device)
    buf, valid = WC.wire_decode(packed, fmt, int(z["c_out"]))
    assert torch.equal(WC.wire_encode(buf, valid, fmt), packed)
    pb, pv = W.wire_decode(packed.cpu(), fmt, int(z["c_out"]))
    assert torch.equal(buf.cpu(), pb) and torch.equal(valid.cpu(), pv)


def _run_both(q, g, data, p, **cfg):
    from repro_torch.core.gym import GymConfig, gym
    from repro_torch.kernels import ops as K

    K.reset_launch_counts()
    out = gym(q, data, ghd=g, p=p, device="cuda", config=GymConfig(**cfg))
    launches = K.launch_counts()
    K.reset_launch_counts()
    ref = gym(q, data, ghd=g, p=p, device="cuda", config=GymConfig(local_backend="torch", **cfg))
    assert sum(K.launch_counts().values()) == 0
    assert tuple(out[1]) == tuple(ref[1])
    np.testing.assert_array_equal(out[0], ref[0])
    assert [dataclasses.asdict(r) for r in out[2].records] == [
        dataclasses.asdict(r) for r in ref[2].records
    ]
    return out, launches


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["hash", "grid", "hybrid"])
def test_cuda_packed_gym_matches_torch_backend(cuda_device, strategy):
    """``wire_format="packed"`` with the 'cuda' backend (codec kernels)
    equals the 'torch' backend (plain codec) in rows and every record, and
    ships fewer payload bytes than the dense run."""
    from repro_torch.core.queries import chain_ghd, chain_query
    from repro_torch.data.synthetic import chain_data_sparse

    q, g = chain_query(8), chain_ghd(8)
    data = chain_data_sparse(8, domain=256, ident=64, extra=192, seed=24)
    (rows, _, led), launches = _run_both(q, g, data, 8, strategy=strategy, seed=23,
                                         wire_format="packed")
    assert all(launches[k] > 0 for k in GYM_KERNELS + ("wire_encode", "wire_decode"))
    (drows, _, dled), _ = _run_both(q, g, data, 8, strategy=strategy, seed=23)
    assert sorted(map(tuple, rows)) == sorted(map(tuple, drows))
    assert led.comm_tuples == dled.comm_tuples and led.payload_bytes < dled.payload_bytes


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["dense", "packed"])
def test_cuda_auto_plan_launches_the_kernels(cuda_device, wire):
    """``plan="auto"`` on the card keeps the 'cuda' backend: the chosen
    plan's ``local_backend`` is None and the kernels launch."""
    from repro_torch.core.gym import GymConfig, GymDriver
    from repro_torch.core.queries import star_ghd, star_query
    from repro_torch.data.synthetic import star_data_sparse
    from repro_torch.kernels import ops as K
    from repro_torch.relational.spmd import SPMD

    q, g = star_query(8), star_ghd(8)
    data = star_data_sparse(8, domain=64, hub_rows=256, spoke_extra=64, seed=21)
    K.reset_launch_counts()
    drv = GymDriver(q, g, data, SPMD(8, device="cuda"),
                    GymConfig(plan="auto", seed=23, wire_format=wire))
    drv.run()
    assert drv.plan.local_backend is None and drv.local_backend == "cuda"
    assert drv.executor.local_backend == "cuda"
    want = GYM_KERNELS + (("wire_encode", "wire_decode") if wire == "packed" else ())
    assert all(K.launch_counts()[k] > 0 for k in want), K.launch_counts()
    _run_both(q, g, data, 8, plan="auto", seed=23, wire_format=wire)
