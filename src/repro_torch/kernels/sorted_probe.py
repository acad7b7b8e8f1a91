"""Sorted-probe match ranges — the inner loop of join expansion and exact
join counting.

Replaces ``repro/kernels/sorted_probe.py::sorted_probe_ranges`` (the
Pallas ``_range_kernel``).  Problem: probes q ``(B, n)`` int32 and keys
``(B, m)`` int32 SORTED within each segment (invalid slots INT32_MAX,
sorted to the back) -> ``(lo, hi)`` ``(B, n)`` int32 with
``lo = #{keys < q}`` and ``hi = #{keys <= q}``, i.e. the left/right
``searchsorted`` pair.  Probes must be < INT32_MAX (dense ranks are;
invalid probes are -1 and get lo == hi == 0).

Hopper design (``csrc/gym_kernels.cu::sorted_probe_kernel``), O(n log m)
work instead of the TPU's O(n·m) rank-by-counting broadcast.  A first,
tiny launch finds each segment's valid length ``m_eff`` (the lower bound
of INT32_MAX: padding never counts for a probe below it) and samples at
most 1024 evenly spaced splitters of ``[0, m_eff)`` into a scratch
tensor.  The probe kernel runs a block per group of 1024-probe tiles of
one segment; the block stages the segment's splitters in shared memory,
and each thread takes four probes, 256 apart so that a warp's loads and
stores cover whole lines: a probe below the first key (the -1 invalid
probes) or above the last valid key is answered with no search; the
others run the top of the lower-bound search in shared memory and only
the last ``log2(m_eff / 1024)`` steps in global memory, the four
searches interleaved so that their dependent loads overlap; ``hi``
gallops right from ``lo`` (one read when the probe's key is unique).
Bound: bytes — each probe read once, ``lo`` and ``hi`` written once, the
valid keys read once at most (``12 n + 4 m_eff`` bytes a segment; no
padding key is ever needed); the searches' dependent L2 reads are what
keeps it above that.  The caller sorts the keys (as the reference does
before its probe).
"""
from __future__ import annotations

from typing import Tuple

import torch

#: kernel launches since the last reset (not counting plain-version calls)
launches = 0

#: splitters a segment stages in shared memory (the kernel's ``kSplitters``)
SPLITTERS = 1024


def binary_search(ks: torch.Tensor, q: torch.Tensor, right: bool) -> torch.Tensor:
    """Vectorized lower (``right=False``) or upper bound of each probe in
    its segment's sorted keys: ``(B, m)``, ``(B, n)`` -> ``(B, n)`` int64."""
    m = ks.shape[-1]
    lo = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    hi = torch.full(q.shape, m, dtype=torch.int64, device=q.device)
    if m == 0:
        return lo
    for _ in range(m.bit_length()):
        active = lo < hi
        mid = (lo + hi) // 2
        v = ks.gather(-1, mid.clamp(max=m - 1))
        go = (v <= q) if right else (v < q)
        lo = torch.where(active & go, mid + 1, lo)
        hi = torch.where(active & ~go, mid, hi)
    return lo


def sorted_probe_ranges_plain(
    q: torch.Tensor, keys: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the same two binary searches, vectorized."""
    lo = binary_search(keys, q, right=False).to(torch.int32)
    hi = binary_search(keys, q, right=True).to(torch.int32)
    return lo, hi


def sorted_probe_ranges(
    q: torch.Tensor, keys: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) match ranges of q ``(B, n)`` in sorted keys ``(B, m)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return sorted_probe_ranges_plain(q, keys)
    global launches
    from . import build

    for name, t in (("q", q), ("keys", keys)):
        if (
            not t.is_cuda or t.dim() != 2 or t.dtype != torch.int32
            or not t.is_contiguous() or t.device != q.device
        ):
            raise ValueError(
                f"sorted_probe_ranges: {name} must be a contiguous 2-D int32 "
                f"tensor on {q.device}, got {tuple(t.shape)} {t.dtype} {t.device}"
            )
    b, n = q.shape
    if keys.shape[0] != b:
        raise ValueError(f"sorted_probe_ranges: {b} probe vs {keys.shape[0]} key segments")
    m = keys.shape[1]
    if m >= 2**31:
        raise ValueError(f"sorted_probe_ranges: {m} keys a segment exceed int32 indices")
    lo = torch.empty((b, n), dtype=torch.int32, device=q.device)
    hi = torch.empty((b, n), dtype=torch.int32, device=q.device)
    if b * n == 0:
        return lo, hi
    # scratch of the first launch: each segment's valid length and splitters
    ns_cap = max(1, min(SPLITTERS, m))
    meff = torch.empty((b,), dtype=torch.int32, device=q.device)
    spl = torch.empty((b, ns_cap), dtype=torch.int32, device=q.device)
    lib = build.load()
    err = lib.gym_sorted_probe(
        q.data_ptr(), keys.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        meff.data_ptr(), spl.data_ptr(), b, n, m, ns_cap,
        build.stream_handle(q.device),
    )
    build.check(err, "gym_sorted_probe")
    launches += 1
    return lo, hi
