"""Set-membership probe — the inner loop of every semijoin and intersect.

Replaces ``repro/kernels/semijoin_probe.py::semijoin_probe`` (the Pallas
``_probe_kernel``).  Problem: probes q ``(B, n)`` int32 and UNSORTED keys
``(B, m)`` int32 (invalid slots INT32_MAX, never matching) -> mask
``(B, n)`` bool, ``mask[i] = q[i] in keys`` within each segment.  Probes
must be < INT32_MAX (dense ranks are).

Hopper design (``csrc/gym_kernels.cu::set_build_kernel`` and
``set_probe_kernel``): the wrapper allocates one open-addressing hash set
per segment with ``torch.empty`` (a power of two, at least twice the
key count, so the load factor stays at or below 1/2); the launcher
clears it with an async memset, one launch inserts every key with
``atomicCAS`` linear probing, and a second launch probes every query.
O(n + m) work with no sort of the keys, instead of the TPU's O(n·m)
broadcast compare.  Bound by memory bytes: each key and probe is read
once, the table is touched a small constant number of times per access.
"""
from __future__ import annotations

import torch

from .sorted_probe import binary_search

#: kernel launches (build + probe pairs) since the last reset
launches = 0


def semijoin_probe_plain(q: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: sort each segment's keys, binary-search the
    probes, and test the lower bound for equality."""
    m = keys.shape[-1]
    if m == 0:
        return torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    ks = torch.sort(keys, dim=-1).values
    lo = binary_search(ks, q, right=False)
    return (lo < m) & (ks.gather(-1, lo.clamp(max=m - 1)) == q)


def table_slots(m: int) -> int:
    """Hash-set cells per segment: a power of two >= 2m (at least 2)."""
    return 1 << max(1, (2 * m - 1).bit_length())


def semijoin_probe(q: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """mask ``(B, n)`` of probes present in their segment's keys ``(B, m)``.

    CPU tensors take the plain version; CUDA tensors launch the kernels."""
    if q.device.type == "cpu":
        return semijoin_probe_plain(q, keys)
    global launches
    from . import build

    for name, t in (("q", q), ("keys", keys)):
        if (
            not t.is_cuda or t.dim() != 2 or t.dtype != torch.int32
            or not t.is_contiguous() or t.device != q.device
        ):
            raise ValueError(
                f"semijoin_probe: {name} must be a contiguous 2-D int32 "
                f"tensor on {q.device}, got {tuple(t.shape)} {t.dtype} {t.device}"
            )
    b, n = q.shape
    if keys.shape[0] != b:
        raise ValueError(f"semijoin_probe: {b} probe vs {keys.shape[0]} key segments")
    m = keys.shape[1]
    out = torch.empty((b, n), dtype=torch.bool, device=q.device)
    if b * n == 0:
        return out
    slots = table_slots(m)
    table = torch.empty((b, slots), dtype=torch.int32, device=q.device)
    lib = build.load()
    err = lib.gym_semijoin_probe(
        q.data_ptr(), keys.data_ptr(), table.data_ptr(), out.data_ptr(),
        b, n, m, slots, build.stream_handle(q.device),
    )
    build.check(err, "gym_semijoin_probe")
    launches += 1
    return out
