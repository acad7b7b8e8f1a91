"""Plain PyTorch oracles for every Hopper kernel of the port.

Each is the plain version kept beside its kernel (one copy of the
reference semantics): the ``'torch'`` local backend runs them, the CPU
tests hold them against ``repro.kernels.ref`` and the Pallas kernels, and
``chip_smoke.py`` holds the CUDA kernels against them on the card."""
from __future__ import annotations

from .hash_partition import hash_partition_plain as hash_partition_ref
from .semijoin_probe import semijoin_probe_plain as semijoin_probe_ref
from .sorted_probe import sorted_probe_ranges_plain as sorted_probe_ranges_ref

__all__ = ["hash_partition_ref", "semijoin_probe_ref", "sorted_probe_ranges_ref"]
