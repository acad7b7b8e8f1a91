"""GYM — Generalized Yannakakis in MapReduce (paper Section 5), on PyTorch.

Given any complete GHD D(T, chi, lam) of a query Q:

  1. *Materialization stage* (Theorem 15): per tree vertex v, compute
     IDB_v = |><|_{R in lam(v)} pi_{attrs(R) & chi(v)}(R) — one Lemma 8
     grid round, or a hash join for a 2-atom bag under the hash engine.  Q' = |><| IDB_v is acyclic and equals Q.
  2. *DYM-d* (Sec. 4.3) on the IDB tree: upward semijoins, downward
     semijoins, join phase — O(d + log n) rounds total.

The driver is a thin schedule walker; lowering, round fusion, capacity
sizing and the abort-retry loop live in ``core.physical``.

Entry point: ``gym(query, data, p=..., config=..., device=...)``.  It runs
on the CUDA card unless the caller passes ``device="cpu"``; with no card
and no device it raises instead of quietly running on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..relational import ops as R
from ..relational.ledger import Ledger
from ..relational.localops import LOCAL_BACKENDS, default_backend
from ..relational.spmd import SPMD, resolve_device
from ..relational.table import DTable
from .ghd import GHD
from .hypergraph import Query
from .physical import ENGINES, HYBRID_ITEM, CapacityManager, PhysicalExecutor
from .physical import pow2 as _pow2
from .planner import Round, get_schedule

#: ROADMAP queue A items that port the features the first slice leaves out
LATER = {
    "plan": "ROADMAP queue A, item 'advisor' (plan='auto')",
    "wire_format": "ROADMAP queue A, item 'packed wire'",
    "save": "ROADMAP queue A, item 'save/load and step_gen'",
}


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------
@dataclasses.dataclass
class GymConfig:
    # 'hash' (hash co-partitioning, skew-sensitive with abort-retry) |
    # 'grid' (paper-faithful Lemmas 8/10, positional, skew-proof); the
    # hybrid engine is not ported yet
    strategy: str = "hash"
    schedule: str = "dym_d"  # 'dym_d' (Sec 4.3) | 'dym_n' (Sec 4.2)
    seed: int = 0
    cap_growth: int = 4  # capacity multiplier on overflow-retry
    max_retries: int = 12
    count_retries_comm: bool = True  # aborted rounds still moved tuples
    fused: bool = True  # one SPMD dispatch per homogeneous op group
    # occupancy-adaptive shuffle: a count-only pre-pass per op group picks
    # tight pow2 exchange capacities instead of worst-case-padded buffers
    calibrate_shuffle: bool = True
    # amortized calibration: a signature-keyed cache of measured caps
    # across rounds, and the next round's combined count pre-pass queued
    # behind the current round's payload work
    caps_cache: bool = True
    prefetch_measures: bool = True
    # shard-local hot loops: 'cuda' (Hopper kernels) | 'torch' (plain
    # PyTorch); None = 'cuda' on a CUDA device, 'torch' on the CPU
    local_backend: Optional[str] = None
    # heavy-hitter sensitivity of the count pre-pass diagnostics
    skew_threshold: Optional[float] = None
    # hard per-shard capacity ceiling (tuples); None derives 64 * M from
    # Assumption 3's M = 4*IN/p
    max_cap_tuples: Optional[int] = None
    wire_format: str = "dense"  # only the dense wire is ported
    plan: str = "manual"  # only manual plans are ported
    # where the query runs: None = the CUDA card (raises without one)
    device: Optional[str] = None

    def __post_init__(self):
        if self.strategy == "hybrid":
            raise NotImplementedError(
                f"strategy='hybrid' is not ported yet ({HYBRID_ITEM})"
            )
        if self.strategy not in ENGINES:
            raise ValueError(
                f"unknown strategy {self.strategy!r}; registered engines: "
                f"{sorted(ENGINES)}"
            )
        if self.wire_format != "dense":
            raise NotImplementedError(
                f"wire_format={self.wire_format!r}: only 'dense' is ported "
                f"({LATER['wire_format']})"
            )
        if self.plan != "manual":
            raise NotImplementedError(
                f"plan={self.plan!r}: only 'manual' is ported ({LATER['plan']})"
            )
        if self.local_backend is not None and self.local_backend not in LOCAL_BACKENDS:
            raise ValueError(
                f"unknown local_backend {self.local_backend!r}; registered "
                f"backends: {sorted(LOCAL_BACKENDS)}"
            )


class GymDriver:
    """GYM execution: materialization + DYM on one SPMD simulation."""

    def __init__(
        self,
        query: Query,
        ghd: GHD,
        data: Dict[str, np.ndarray],
        spmd: SPMD,
        config: Optional[GymConfig] = None,
    ):
        self.query = query
        self.config = config or GymConfig()
        self.spmd = spmd
        dev = spmd.device
        backend = self.config.local_backend or default_backend(dev)
        if backend == "cuda" and dev.type != "cuda":
            raise ValueError(
                f"local_backend='cuda' needs a CUDA device, got {dev}; use "
                "local_backend='torch' (the default on the CPU)"
            )
        self.local_backend = backend
        # dedup base relations once (relations are sets)
        dedup_rows: Dict[str, np.ndarray] = {}
        for atom in query.atoms:
            rows = np.asarray(data[atom.rel], dtype=np.int32).reshape(-1, len(atom.attrs))
            if rows.shape[0]:
                rows = np.unique(rows, axis=0)
            dedup_rows[atom.alias] = rows
        self.ghd = ghd.make_complete(query)
        self.ledger = Ledger()

        # stable per-node schemas: chi in first-seen attr order of the query
        attr_order = {a: i for i, a in enumerate(query.output_attrs)}
        self.node_schema: Dict[int, Tuple[str, ...]] = {
            v: tuple(sorted(self.ghd.chi[v], key=lambda a: attr_order[a]))
            for v in self.ghd.nodes()
        }

        # load base relations (round-robin scatter = the 'networked FS')
        p = spmd.p
        self.base: Dict[str, DTable] = {}
        for atom in query.atoms:
            rows = dedup_rows[atom.alias]
            cap = _pow2(max(1, -(-rows.shape[0] // p)))
            self.base[atom.alias] = DTable.scatter_numpy(
                rows, atom.attrs, p, cap=cap, device=dev
            )
        self._base_counts = {a: int(r.shape[0]) for a, r in dedup_rows.items()}

        cfg = self.config
        self.capman = CapacityManager(
            spmd, growth=cfg.cap_growth, local_backend=backend, max_cap=self._max_cap(),
        )
        for v in self.ghd.nodes():
            self.capman.ensure(v, self._init_cap(v))
        self.executor = PhysicalExecutor(
            spmd,
            cfg.strategy,
            self.capman,
            seed=cfg.seed,
            max_retries=cfg.max_retries,
            count_retries_comm=cfg.count_retries_comm,
            fuse=cfg.fused,
            calibrate=cfg.calibrate_shuffle,
            local_backend=backend,
            skew_threshold=cfg.skew_threshold,
            caps_cache=cfg.caps_cache,
            prefetch=cfg.prefetch_measures,
        )

        self.schedule: List[Round] = get_schedule(cfg.schedule).fn(self.ghd)
        self.tables: Dict[int, DTable] = {}
        # Upward-phase L2 accumulators: node tables stay intact (the
        # downward phase and join phase need the originals)
        self.acc: Dict[int, DTable] = {}
        self.cursor: int = -1  # -1 = materialization pending
        self.done = False
        self.result: Optional[DTable] = None

    def _max_cap(self) -> int:
        """Per-shard capacity ceiling: the configured bound, or 64x the
        Assumption-3 memory M = 4*IN/p (pow2, floored at 2^16)."""
        if self.config.max_cap_tuples is not None:
            return int(self.config.max_cap_tuples)
        total = sum(self._base_counts.values())
        m = 4 * max(1, -(-total // self.spmd.p))
        return _pow2(max(1 << 16, 64 * m))

    # -- capacity heuristics ------------------------------------------------
    def _init_cap(self, v: int) -> int:
        per_shard = max(
            -(-max(1, self._base_counts[a]) // self.spmd.p) for a in self.ghd.lam[v]
        )
        return _pow2(max(4, 4 * per_shard))

    # -- schedule walking ----------------------------------------------------
    def step(self) -> bool:
        """Run one schedule round (with abort-retry); returns True if more."""
        if self.done:
            return False
        if self.cursor < 0:
            (
                tables, comm, padded, heavy, claimed, dispatches,
                measure_dispatches, wire_bytes, useful_bytes,
            ) = self.executor.materialize(
                self.ghd, self.base, self.node_schema, self.ledger
            )
            self.tables = tables
            # the first DYM round's combined count pre-pass queues behind
            # materialization's trailing payload work
            self.executor.prefetch_round(
                self.schedule[0] if self.schedule else None, self.tables, self.acc,
            )
            self.ledger.add_round(
                "materialize",
                [f"IDB({v})<=lam{sorted(self.ghd.lam[v])}" for v in self.ghd.nodes()],
                comm,
                n_rounds=claimed,
                dispatches=dispatches,
                padded=padded,
                heavy=heavy,
                measure_dispatches=measure_dispatches,
                payload_bytes=wire_bytes,
                useful_bytes=useful_bytes,
            )
            self.cursor = 0
            return True
        if self.cursor >= len(self.schedule):
            self._finish()
            return False
        rnd = self.schedule[self.cursor]
        (
            new_tab, new_acc, comm, padded, heavy, claimed, dispatches,
            measure_dispatches, wire_bytes, useful_bytes,
        ) = self.executor.execute_round(rnd, self.tables, self.acc, self.ledger)
        self.tables = {**self.tables, **new_tab}
        self.acc = {**self.acc, **new_acc}
        nxt = self.cursor + 1
        self.executor.prefetch_round(
            self.schedule[nxt] if nxt < len(self.schedule) else None,
            self.tables, self.acc,
        )
        self.ledger.add_round(
            rnd.phase,
            [repr(o) for o in rnd.ops],
            comm,
            n_rounds=claimed,
            dispatches=dispatches,
            padded=padded,
            heavy=heavy,
            measure_dispatches=measure_dispatches,
            payload_bytes=wire_bytes,
            useful_bytes=useful_bytes,
        )
        self.cursor += 1
        if self.cursor >= len(self.schedule):
            self._finish()
            return False
        return True

    def _finish(self) -> None:
        root = self.ghd.root
        out = self.tables[root]
        # canonical output column order
        want = [a for a in self.query.output_attrs if a in out.schema]
        self.result, _ = R.dist_project(self.spmd, out, want)
        self.ledger.output_tuples = int(self.result.valid.sum().item())
        self.done = True

    def run(self) -> DTable:
        while self.step():
            pass
        if not self.done:
            self._finish()
        assert self.result is not None
        return self.result

    # -- features of later slices -------------------------------------------
    def step_gen(self):
        raise NotImplementedError(f"step_gen is not ported yet ({LATER['save']})")

    def save(self, path: str) -> None:
        raise NotImplementedError(f"save is not ported yet ({LATER['save']})")

    def load(self, path: str) -> None:
        raise NotImplementedError(f"load is not ported yet ({LATER['save']})")


# --------------------------------------------------------------------------
# front door
# --------------------------------------------------------------------------
def gym(
    query: Query,
    data: Dict[str, np.ndarray],
    *,
    ghd: Optional[GHD] = None,
    p: int = 4,
    config: Optional[GymConfig] = None,
    device=None,
) -> Tuple[np.ndarray, Tuple[str, ...], Ledger]:
    """Evaluate Q with GYM.  Returns (rows, schema, ledger).

    ``device`` (else ``config.device``) picks where the query runs; None
    means the CUDA card, and raises when there is none."""
    from .decompose import ghd_for

    g = ghd if ghd is not None else ghd_for(query)
    dev = device if device is not None else (config.device if config else None)
    drv = GymDriver(query, g, data, SPMD(p, device=resolve_device(dev)), config)
    out = drv.run()
    return out.to_numpy(), out.schema, drv.ledger
