"""Elastic batch planning and the straggler watchdog (a copy of
``repro/train/elastic.py``, which is pure Python).

- ``fit_batch_to_world``: re-plan the per-device batch and accumulation
  when the data-parallel world size changes between runs, keeping the
  global batch (checkpoints hold whole, unsharded tensors, so a restore
  works at any world size);
- ``HeartbeatMonitor``: a wall-clock watchdog that flags steps slower
  than ``factor`` x the running median, the hook a launcher uses for
  speculative re-execution or eviction.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple


@dataclasses.dataclass
class BatchPlan:
    global_batch: int
    accum: int
    per_device_batch: int


def fit_batch_to_world(global_batch: int, dp_world: int, per_device_max: int) -> BatchPlan:
    """Keep the *global* batch (optimization semantics) fixed while the
    world size changes: raise accumulation when fewer devices, lower when
    more.  Requires dp_world | global_batch."""
    if global_batch % dp_world:
        raise ValueError(f"world {dp_world} does not divide the global batch {global_batch}")
    per_step = global_batch // dp_world
    accum = max(1, -(-per_step // per_device_max))
    while per_step % accum:
        accum += 1
    return BatchPlan(global_batch, accum, per_step // accum)


class HeartbeatMonitor:
    """Flags steps slower than ``factor`` x running median."""

    def __init__(self, factor: float = 3.0, window: int = 32):
        self.factor = factor
        self.window = window
        self.durations: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self) -> Tuple[float, bool]:
        if self._t0 is None:
            raise RuntimeError("HeartbeatMonitor.stop() without start()")
        dt = time.monotonic() - self._t0
        self._t0 = None
        hist = sorted(self.durations[-self.window:])
        median = hist[len(hist) // 2] if hist else dt
        straggler = len(hist) >= 8 and dt > self.factor * median
        self.durations.append(dt)
        return dt, straggler
