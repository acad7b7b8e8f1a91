"""Set-membership probe — the inner loop of every semijoin and intersect.

Replaces ``repro/kernels/semijoin_probe.py::semijoin_probe`` (the Pallas
``_probe_kernel``).  Problem: probes q ``(B, n)`` int32 and UNSORTED keys
``(B, m)`` int32 (invalid slots INT32_MAX, never matching) -> mask
``(B, n)`` bool, ``mask[i] = q[i] in keys`` within each segment.  Probes
must be < INT32_MAX (dense ranks are).  O(n + m) work on either path,
instead of the TPU's O(n·m) broadcast compare; both are bound by memory
bytes (each probe and key read once, each mask byte written once).

Two Hopper paths (``csrc/gym_kernels.cu``), chosen on the host from the
shapes and ``bound`` alone, with no read from the device:

- **bitmap** (``bitmap_build_kernel`` + ``bitmap_probe_kernel``), when
  the caller passes ``bound`` and a segment's bits fit in one block's
  shared memory (``bound <= MAX_BITMAP_BITS``).  ``bound`` is a promise:
  every key other than INT32_MAX lies in ``[0, bound)``.  The dense ranks
  of ``local_semijoin_mask`` keep it with ``bound = n + m``.  The build
  sets one bit per key in a ``(B, ceil(bound / 128) * 4)`` uint32 bitmap
  (7.9 MiB at the largest main-path call, so it stays in L2); one
  persistent block per SM stages its segment's bits in shared memory and
  answers each probe with one compare (a probe outside ``[0, bound)``,
  such as the -1 of an invalid row, is a miss) and one bit test.  A key
  that breaks the promise stops the kernel with ``__trap()``: the next
  synchronisation raises, and the process's CUDA context is lost; it
  never returns a wrong mask.
- **hash set** (``set_build_kernel`` + ``set_probe_kernel``), for any
  other int32 keys (no ``bound``, or one too large for shared memory):
  one open-addressing set per segment, ``table_slots(m)`` cells (at most
  half full), cleared by an async memset, filled with ``atomicCAS``
  linear probing, then probed.
"""
from __future__ import annotations

from typing import Optional

import torch

from .sorted_probe import binary_search

#: kernel launches (build + probe pairs) since the last reset
launches = 0
#: the same launches by path
path_launches = {"bitmap": 0, "hash": 0}

#: shared memory one block may opt in to on sm_90 (H100, H200): 227 KB
MAX_BITMAP_BYTES = 232448
#: the largest ``bound`` the bitmap path takes (1859584 bits)
MAX_BITMAP_BITS = MAX_BITMAP_BYTES * 8


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


def bitmap_words(bound: int) -> int:
    """uint32 words of a segment's bitmap: ``bound`` bits, rounded up to
    whole 16-byte rows (the probe kernel stages them 16 bytes a copy)."""
    return -(-bound // 128) * 4


def uses_bitmap(bound: Optional[int]) -> bool:
    """Whether a call with this ``bound`` takes the bitmap path."""
    return bound is not None and 4 * bitmap_words(bound) <= MAX_BITMAP_BYTES


def semijoin_probe(
    q: torch.Tensor, keys: torch.Tensor, *, bound: Optional[int] = None
) -> torch.Tensor:
    """mask ``(B, n)`` of probes present in their segment's keys ``(B, m)``.

    ``bound``, if given, promises that every key other than INT32_MAX lies
    in ``[0, bound)``; the plain version ignores it.  CPU tensors take the
    plain version; CUDA tensors launch the kernels."""
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
    if bound is not None and bound < 0:
        raise ValueError(f"semijoin_probe: bound {bound} < 0")
    out = torch.empty((b, n), dtype=torch.bool, device=q.device)
    if b * n == 0:
        return out
    lib = build.load()
    if uses_bitmap(bound):
        if q.data_ptr() % 16:  # the probe kernel reads 16-byte rows
            q = q.clone()
        words = bitmap_words(bound)
        bits = torch.empty((b, words), dtype=torch.int32, device=q.device)
        err = lib.gym_semijoin_bitmap(
            q.data_ptr(), keys.data_ptr(), bits.data_ptr(), out.data_ptr(),
            b, n, m, bound, words, build.stream_handle(q.device),
        )
        build.check(err, "gym_semijoin_bitmap")
        launches += 1
        path_launches["bitmap"] += 1
        return out
    slots = table_slots(m)
    table = torch.empty((b, slots), dtype=torch.int32, device=q.device)
    err = lib.gym_semijoin_probe(
        q.data_ptr(), keys.data_ptr(), table.data_ptr(), out.data_ptr(),
        b, n, m, slots, build.stream_handle(q.device),
    )
    build.check(err, "gym_semijoin_probe")
    launches += 1
    path_launches["hash"] += 1
    return out
