"""Hash-partition bucketing — the "map" side of every GYM shuffle.

Replaces ``repro/kernels/hash_partition.py::hash_partition`` (the Pallas
``_partition_kernel``).  Problem: a contiguous ``(B, n, nk)`` int32 key
matrix (the key columns already gathered, in hashing order), valid
``(B, n)``, one uint32 seed per segment, p reducers -> dest ``(B, n)``
int32 in [0, p) for valid rows, p for invalid.

Hopper design (``csrc/gym_kernels.cu::hash_partition_kernel``): one
thread per row runs the seeded murmur3 fmix32 chain over its ``nk``
columns in registers and writes one int32 — each input byte is read once
and each output byte written once, so the kernel is bound by memory
bytes (``4*nk + 1`` in, 4 out per row), not by its ~10 integer
operations per column.  The seeds ride as a device tensor (never a
compile-time constant), so reseeded retries reuse the same kernel.  All
``B`` segments (every shard and fused instance) go in one launch.  Zero
key columns is the seed-only hash, as in the plain version.
"""
from __future__ import annotations

import torch

from ..relational.hashing import dests_for, u32_to_i32

#: kernel launches since the last reset (not counting plain-version calls)
launches = 0


def hash_partition_plain(
    keys: torch.Tensor, valid: torch.Tensor, p: int, seeds: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: ``dests_for`` over every key column."""
    return dests_for(keys, valid, tuple(range(keys.shape[-1])), p, seeds)


def hash_partition(
    keys: torch.Tensor, valid: torch.Tensor, p: int, seeds: torch.Tensor
) -> torch.Tensor:
    """Destination reducer per row of ``keys`` (B, n, nk); invalid -> p.

    ``seeds`` (B,) int64 holding uint32 values.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if keys.device.type == "cpu":
        return hash_partition_plain(keys, valid, p, seeds)
    global launches
    from . import build

    if not keys.is_cuda:
        raise ValueError(f"hash_partition: unsupported device {keys.device}")
    if keys.dim() != 3 or keys.dtype != torch.int32 or not keys.is_contiguous():
        raise ValueError(
            f"hash_partition: keys must be contiguous (B, n, nk) int32, got "
            f"{tuple(keys.shape)} {keys.dtype} contiguous={keys.is_contiguous()}"
        )
    b, n, nk = keys.shape
    if (
        valid.shape != (b, n) or valid.dtype != torch.bool
        or valid.device != keys.device or not valid.is_contiguous()
    ):
        raise ValueError(f"hash_partition: valid must be contiguous (B, n) bool on {keys.device}")
    if seeds.shape != (b,) or seeds.device != keys.device:
        raise ValueError(f"hash_partition: seeds must be ({b},) on {keys.device}")
    if not 1 <= p < 2**31:
        raise ValueError(f"hash_partition: bad p={p}")
    out = torch.empty((b, n), dtype=torch.int32, device=keys.device)
    if b * n == 0:
        return out
    seeds32 = u32_to_i32(seeds.to(torch.int64)).contiguous()
    lib = build.load()
    err = lib.gym_hash_partition(
        keys.data_ptr(), valid.data_ptr(), seeds32.data_ptr(), out.data_ptr(),
        b, n, nk, int(p), build.stream_handle(keys.device),
    )
    build.check(err, "gym_hash_partition")
    launches += 1
    return out
