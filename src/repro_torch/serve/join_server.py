"""Multi-tenant join serving with cross-request fused dispatch.

A single ``gym()`` call amortizes dispatch overhead *within* a query —
round fusion stacks a round's compatible op instances into one SPMD
program and one exchange.  This server amortizes it *across* queries: many
concurrent query instances step round by round on ONE ``SPMD`` (one
device), and each tick buckets every in-flight query's prepared op groups
by ``GroupWork.merge_key`` (``relational.batched.cross_request_key``).  A
bucket with several riders runs as ONE fused dispatch
(``core.physical.dispatch_merged``): the k axis of the ``dist_*_many``
operators spans requests instead of one query's op group, so the kernels
take one launch where a sequential loop takes one per query.

What stays per tenant: every query owns its ``GymDriver`` (seeds,
capacity manager, retry decisions, ``Ledger``), so its rows and
``comm_tuples`` equal a standalone ``gym()`` run (a merged dispatch widens
only padding).  The ``ServerLedger`` aggregate is the per-tenant sum;
fusion's saving shows only in its ``fused_dispatches`` / ``fused_riders``.

What is shared: the ``SPMD`` and one signature-keyed ``CapsCache``
(tenants with equal group signatures warm each other's calibration).

Admission control: at most ``max_in_flight`` queries step at once; the
waiting queue is FIFO-with-aging — effective priority is
``priority - aging * wait_ticks``, so an urgent arrival can jump the queue
but a long-waiting ticket eventually outranks any newcomer.  Scheduling is
tick-based and deterministic (no wall clock).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.caps_cache import CapsCache
from ..core.gym import GymConfig, GymDriver
from ..core.physical import GroupWork, dispatch_merged, dispatch_work
from ..relational.ledger import Ledger, ServerLedger
from ..relational.spmd import SPMD


@dataclasses.dataclass
class JoinTicket:
    """One submitted query instance and its lifecycle state."""

    tenant: str
    query: Any
    ghd: Any
    data: Dict[str, np.ndarray]
    config: Optional[GymConfig]
    priority: float = 0.0  # LOWER = more urgent (0 = normal)
    # -- filled by the server -------------------------------------------
    order: int = -1  # arrival sequence number (FIFO tiebreak)
    submit_tick: int = -1
    admit_tick: int = -1
    finish_tick: int = -1
    driver: Optional[GymDriver] = None
    gen: Any = None  # live ``step_gen`` generator (suspended at a yield)
    works: List[GroupWork] = dataclasses.field(default_factory=list)
    done: bool = False

    @property
    def result(self):
        return self.driver.result if self.driver is not None else None

    def rows(self) -> np.ndarray:
        assert self.done and self.driver is not None
        return self.driver.result.to_numpy()

    @property
    def ledger(self) -> Optional[Ledger]:
        return self.driver.ledger if self.driver is not None else None

    @property
    def wait_ticks(self) -> int:
        """Queue wait (submission to admission)."""
        return max(0, self.admit_tick - self.submit_tick)

    @property
    def latency_ticks(self) -> int:
        """Submission-to-completion in server ticks (the deterministic
        latency metric; wall-clock latency is the bench's concern)."""
        return max(0, self.finish_tick - self.submit_tick)


class JoinServer:
    """Admit, schedule, and fuse many concurrent ``gym`` queries on one
    ``SPMD``, whose device every query runs on (``SPMD(p)`` with no device
    is the CUDA card, and raises without one).

    Drive with ``step()`` (one tick: admit -> bucket -> dispatch ->
    deliver) until it returns False, or call ``drain()``.  Submissions
    may arrive between ticks — the tick loop is the event loop."""

    def __init__(
        self,
        spmd: SPMD,
        *,
        max_in_flight: int = 4,
        aging: float = 1.0,
        caps_cache: Optional[CapsCache] = None,
    ):
        if spmd.mesh is not None:
            raise NotImplementedError("JoinServer: the join server on a mesh is not ported")
        self.spmd = spmd
        self.max_in_flight = int(max_in_flight)
        if self.max_in_flight < 1:
            raise ValueError(f"max_in_flight must be >= 1, got {max_in_flight}")
        self.aging = float(aging)
        # ONE cache for every tenant: signature-keyed, so equal group
        # shapes warm each other and different shapes never collide
        self.caps_cache = caps_cache if caps_cache is not None else CapsCache()
        self.ledger = ServerLedger()
        self.tick = 0
        self._order = itertools.count()
        self._queue: List[JoinTicket] = []
        self._active: List[JoinTicket] = []
        self.completed: List[JoinTicket] = []

    # ------------------------------------------------------------ intake
    def submit(
        self,
        tenant: str,
        query,
        ghd,
        data: Dict[str, np.ndarray],
        config: Optional[GymConfig] = None,
        *,
        priority: float = 0.0,
    ) -> JoinTicket:
        """Enqueue one query instance for ``tenant``; returns its ticket
        (poll ``ticket.done``; ``ticket.rows()`` after completion)."""
        t = JoinTicket(
            tenant=tenant, query=query, ghd=ghd, data=data, config=config,
            priority=float(priority), order=next(self._order),
            submit_tick=self.tick,
        )
        self._queue.append(t)
        return t

    @property
    def in_flight(self) -> int:
        return len(self._active)

    @property
    def queued(self) -> int:
        return len(self._queue)

    def pending_groups(self) -> Dict[Optional[Tuple], List[GroupWork]]:
        """This tick's mergeable work, bucketed by ``merge_key`` (the
        ``None`` bucket = must-dispatch-solo groups) — what ``step()``
        is about to fuse; exposed for tests and introspection."""
        buckets: Dict[Optional[Tuple], List[GroupWork]] = {}
        for t in self._active:
            for w in t.works:
                buckets.setdefault(w.merge_key, []).append(w)
        return buckets

    # -------------------------------------------------------- scheduling
    def _effective(self, t: JoinTicket) -> Tuple[float, int]:
        # FIFO-with-aging: waiting lowers the effective value linearly,
        # so no priority gap outlasts a proportional wait; arrival order
        # breaks ties exactly (pure FIFO at equal priorities)
        return (t.priority - self.aging * (self.tick - t.submit_tick), t.order)

    def _admit(self) -> None:
        while self._queue and len(self._active) < self.max_in_flight:
            t = min(self._queue, key=self._effective)
            self._queue.remove(t)
            t.admit_tick = self.tick
            t.driver = GymDriver(
                t.query, t.ghd, t.data, self.spmd, t.config,
                caps_cache=self.caps_cache,
            )
            self._active.append(t)
            self._start_round(t)

    def _start_round(self, t: JoinTicket) -> None:
        """Open the ticket's next round generator and advance it to its
        first suspended stage.  Yield-free drives (materialization, or
        the final finish step) complete inline and roll into the next
        round — or retire the ticket."""
        while True:
            t.gen = t.driver.step_gen()
            try:
                t.works = next(t.gen)
                return  # suspended: works await this tick's dispatch
            except StopIteration as stop:
                t.gen = None
                t.works = []
                if stop.value:
                    continue  # inline round done, more remain
                self._retire(t)
                return

    def _deliver(self, t: JoinTicket, results) -> None:
        try:
            t.works = t.gen.send(results)
        except StopIteration as stop:
            t.gen = None
            t.works = []
            if stop.value:
                self._start_round(t)
            else:
                self._retire(t)

    def _retire(self, t: JoinTicket) -> None:
        assert t.driver is not None and t.driver.done
        t.done = True
        t.finish_tick = self.tick
        self.ledger.add(t.tenant, t.driver.ledger)
        if t in self._active:
            self._active.remove(t)
        self.completed.append(t)

    # --------------------------------------------------------- tick loop
    def step(self) -> bool:
        """One server tick: admit waiting tickets, bucket every active
        query's pending op groups by ``merge_key``, dispatch each bucket
        (ONE fused program + one ``all_to_all`` when several riders
        share a key), and deliver the de-interleaved results so every
        query advances one stage.  Returns True while work remains."""
        self.tick += 1
        self._admit()
        if not self._active:
            return bool(self._queue)
        buckets: Dict[Tuple, List[Tuple[JoinTicket, int]]] = {}
        solo: List[Tuple[JoinTicket, int]] = []
        for t in self._active:
            for wi, w in enumerate(t.works):
                if w.merge_key is None:
                    solo.append((t, wi))
                else:
                    buckets.setdefault(w.merge_key, []).append((t, wi))
        results: Dict[Tuple[int, int], Any] = {}
        for key in sorted(buckets, key=repr):  # deterministic order
            items = buckets[key]
            works = [t.works[wi] for t, wi in items]
            if len(works) > 1:
                rs = dispatch_merged(works)
                self.ledger.fused_dispatches += 1
                self.ledger.fused_riders += len(works)
            else:
                rs = [dispatch_work(works[0])]
            for (t, wi), r in zip(items, rs):
                results[(id(t), wi)] = r
        for t, wi in solo:
            results[(id(t), wi)] = dispatch_work(t.works[wi])
        # deliver in admission order; _deliver mutates _active on retire
        for t in list(self._active):
            if t.gen is None:
                continue
            t_results = [results[(id(t), wi)] for wi in range(len(t.works))]
            self._deliver(t, t_results)
        return bool(self._queue or self._active)

    def drain(self) -> ServerLedger:
        """Run ticks until every submitted query has completed."""
        while self.step():
            pass
        return self.ledger
