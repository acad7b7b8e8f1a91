"""SPMD execution of per-shard functions over an explicit reducer axis.

``repro`` maps a per-shard body over the reducer axis with a named-axis
``vmap`` and lets it call ``all_to_all`` on that name.  PyTorch's ``vmap``
has no named-axis collectives, so the port writes every body over an
explicit leading ``p`` axis (the paper's PRAM-style simulation on one
device): an ``all_to_all`` is a swap of the (source, destination) axes
and the shard index is an ``arange``.  ``SPMD.run`` stays the one
dispatch boundary and counts dispatches exactly as the reference does,
because the ledger's dispatch figures are part of parity.
"""
from __future__ import annotations

from typing import Callable

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; the CPU only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU explicitly"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


class SPMD:
    def __init__(self, p: int, mesh=None, device=None):
        """``p`` logical reducers simulated on ``device`` (None = the CUDA
        card).  A device mesh is out of scope for the port."""
        if mesh is not None:
            raise NotImplementedError(
                "repro_torch.SPMD simulates the reducer axis on one device; "
                "a mesh is not supported"
            )
        self.p = p
        self.mesh = None
        self.device = resolve_device(device)
        # program dispatches issued (one per ``run`` call) — the measured
        # counterpart of the ledger's claimed BSP rounds
        self.dispatch_count: int = 0
        # the subset of ``dispatch_count`` that were count-only measure
        # pre-passes (``run(..., measure=True)``)
        self.measure_dispatch_count: int = 0

    def run(self, fn: Callable, *args, measure: bool = False, **statics):
        """Run per-shard ``fn`` (written over the leading reducer axis) as
        one dispatch.  ``measure`` tags a count-only calibration pre-pass.
        Results are device tensors; on CUDA the work is queued
        asynchronously and the host waits only when a caller reads
        values back."""
        self.dispatch_count += 1
        if measure:
            self.measure_dispatch_count += 1
        return fn(*args, **statics)

    def seeds(self, seed: int) -> torch.Tensor:
        """Per-shard seed tensor (uint32 values in int64): hash seeds ride
        as data, one per shard."""
        return torch.full(
            (self.p,), seed & 0xFFFFFFFF, dtype=torch.int64, device=self.device
        )
