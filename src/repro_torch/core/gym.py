"""GYM — Generalized Yannakakis in MapReduce (paper Section 5), on PyTorch.

Given any complete GHD D(T, chi, lam) of a query Q:

  1. *Materialization stage* (Theorem 15): per tree vertex v, compute
     IDB_v = |><|_{R in lam(v)} pi_{attrs(R) & chi(v)}(R) — one Lemma 8
     grid round, or a hash join for a 2-atom bag under the hash engine.  Q' = |><| IDB_v is acyclic and equals Q.
  2. *DYM-d* (Sec. 4.3) on the IDB tree: upward semijoins, downward
     semijoins, join phase — O(d + log n) rounds total.

The driver is a thin schedule walker; lowering, round fusion, capacity
sizing and the abort-retry loop live in ``core.physical``.  What remains
here is the resumable state machine: between rounds the full state (node
tables, cursor, ledger, capacities, the caps cache) can be snapshotted to
disk (``save``) and a new driver can resume mid-query (``load``), and
``step_gen`` hands each stage's prepared work to a caller that owns the
dispatch (the join server, ``serve/join_server.py``).

Entry point: ``gym(query, data, p=..., config=..., plan=..., device=...)``.
It runs on the CUDA card unless the caller passes ``device="cpu"``; with
no card and no device it raises instead of quietly running on the CPU.
``gym(..., spmd=SPMD(p, mesh=mesh))`` runs it on a device mesh instead,
one process per reducer (``launch/mesh.py``): every rank holds its block
of each table and returns the whole answer and the same ledger; there
``save`` and ``load`` are collective (every rank calls them with the same
path) and write and read the simulation's snapshot file.
``GymConfig(wire_format="packed")`` ships every exchange bit-packed to the
base relations' value widths (``relational/wire.py``);
``GymConfig(plan="auto")`` lets the cost-based advisor
(``core/optimizer.py``) choose GHD, schedule, engine, fusion and capacity
policy from the data's statistics, and ``plan=<Plan>`` runs a plan the
caller chose.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..relational import ops as R
from ..relational.ledger import Ledger, RoundRecord
from ..relational.localops import LOCAL_BACKENDS, default_backend
from ..relational.spmd import SPMD, spmd_for
from ..relational.table import DTable, unique_rows
from ..relational.wire import WirePolicy, wire_gain
from .ghd import GHD
from .hypergraph import Query
from .physical import ENGINES, CapacityManager, PhysicalExecutor
from .physical import pow2 as _pow2
from .planner import Round, get_schedule


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------
@dataclasses.dataclass
class GymConfig:
    # 'hash' (hash co-partitioning, skew-sensitive with abort-retry) |
    # 'grid' (paper-faithful Lemmas 8/10, positional, skew-proof) |
    # 'hybrid' (hash for light keys, spread/broadcast for heavy keys;
    # forces the count pre-pass on)
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
    # heavy-hitter sensitivity of the count pre-pass (hybrid routing and
    # the capacity ceiling's diagnostics)
    skew_threshold: Optional[float] = None
    # hard per-shard capacity ceiling (tuples); None derives 64 * M from
    # Assumption 3's M = 4*IN/p
    max_cap_tuples: Optional[int] = None
    # exchange encoding: 'dense' ships (p, c_out, arity) int32 buffers +
    # bool valid planes; 'packed' bit-packs rows to the base relations'
    # observed value widths (relational/wire.py) and ships one segmented
    # uint8 buffer per fused group.  Rows, comm_tuples and retries are
    # the same either way; only the wire bytes change.
    wire_format: str = "dense"
    # 'manual' = run exactly the knobs above; 'auto' = let the advisor
    # (core/optimizer.py) pick GHD/schedule/engine/fusion from the data's
    # statistics.  After resolution the field holds the chosen Plan.key.
    plan: str = "manual"
    # where the query runs: None = the CUDA card (raises without one)
    device: Optional[str] = None

    def __post_init__(self):
        if self.strategy not in ENGINES:
            raise ValueError(
                f"unknown strategy {self.strategy!r}; registered engines: "
                f"{sorted(ENGINES)}"
            )
        if self.wire_format not in ("dense", "packed"):
            raise ValueError(
                f"unknown wire_format {self.wire_format!r}; valid: ['dense', 'packed']"
            )
        if self.local_backend is not None and self.local_backend not in LOCAL_BACKENDS:
            raise ValueError(
                f"unknown local_backend {self.local_backend!r}; registered "
                f"backends: {sorted(LOCAL_BACKENDS)}"
            )


class GymDriver:
    """GYM execution: materialization + DYM on one ``SPMD`` (the
    simulation, or this rank's share of a mesh)."""

    def __init__(
        self,
        query: Query,
        ghd: GHD,
        data: Dict[str, np.ndarray],
        spmd: SPMD,
        config: Optional[GymConfig] = None,
        plan=None,  # Optional[optimizer.Plan]: execute this plan directly
        caps_cache=None,  # Optional[CapsCache]: SHARED across drivers
    ):
        self.query = query
        self.config = config or GymConfig()
        self.spmd = spmd
        # a caller-owned CapsCache (the join server passes one cache to
        # every tenant, so equal group signatures warm each other); None
        # keeps the executor's own per-query cache
        self._shared_caps_cache = caps_cache
        # dedup base relations once (relations are sets); the distinct row
        # counts double as the advisor's table statistics
        dedup_rows: Dict[str, np.ndarray] = {}
        for atom in query.atoms:
            rows = np.asarray(data[atom.rel], dtype=np.int32).reshape(-1, len(atom.attrs))
            if rows.shape[0]:
                rows = unique_rows(rows)
            dedup_rows[atom.alias] = rows
        # sound per-attribute bit widths from the base relations' value
        # ranges (joins never create values, so they cover every
        # intermediate); applied only when wire_format == 'packed'
        self._wire_policy = WirePolicy.from_columns(
            [(atom.attrs, dedup_rows[atom.alias]) for atom in query.atoms]
        )
        if plan is None and self.config.plan == "auto":
            plan = self._choose_plan(query, ghd, dedup_rows)
        self.plan = plan
        if plan is not None:
            # the plan decides GHD + engine knobs; config mirrors it
            ghd = plan.ghd
            self.config = plan.to_config(self.config)
        backend = self.local_backend = self._resolve_backend()
        self.ghd = ghd.make_complete(query)
        self.ledger = Ledger()

        # stable per-node schemas: chi in first-seen attr order of the query
        attr_order = {a: i for i, a in enumerate(query.output_attrs)}
        self.node_schema: Dict[int, Tuple[str, ...]] = {
            v: tuple(sorted(self.ghd.chi[v], key=lambda a: attr_order[a]))
            for v in self.ghd.nodes()
        }

        # load base relations (round-robin scatter = the 'networked FS');
        # on a mesh each rank keeps its own block
        p = spmd.p
        self.base: Dict[str, DTable] = {}
        for atom in query.atoms:
            rows = dedup_rows[atom.alias]
            cap = _pow2(max(1, -(-rows.shape[0] // p)))
            self.base[atom.alias] = spmd.device_put(
                DTable.scatter_numpy(rows, atom.attrs, p, cap=cap)
            )
        self._base_counts = {a: int(r.shape[0]) for a, r in dedup_rows.items()}

        cfg = self.config
        self.capman = CapacityManager(
            spmd, growth=cfg.cap_growth, local_backend=backend, max_cap=self._max_cap(),
        )
        for v in self.ghd.nodes():
            self.capman.ensure(v, self._init_cap(v))
        self.executor = self._make_executor()

        self.schedule: List[Round] = get_schedule(cfg.schedule).fn(self.ghd)
        self.tables: Dict[int, DTable] = {}
        # Upward-phase L2 accumulators: node tables stay intact (the
        # downward phase and join phase need the originals)
        self.acc: Dict[int, DTable] = {}
        self.cursor: int = -1  # -1 = materialization pending
        self.done = False
        self.result: Optional[DTable] = None
        self._pending_works: list = []  # what a suspended step_gen yielded

    def _resolve_backend(self) -> str:
        """The config's local backend on this driver's device (None = the
        device's default); ``'cuda'`` off a CUDA device raises."""
        dev = self.spmd.device
        backend = self.config.local_backend or default_backend(dev)
        if backend == "cuda" and dev.type != "cuda":
            raise ValueError(
                f"local_backend='cuda' needs a CUDA device, got {dev}; use "
                "local_backend='torch' (the default on the CPU)"
            )
        return backend

    def _choose_plan(self, query: Query, ghd: GHD, dedup_rows):
        """``plan="auto"``: the advisor's argmin over the candidate plans,
        priced from the deduped base relations' sizes and skew and, for a
        packed run, the packed wire's row compression."""
        from .costs import DEFAULT_DISPATCH_OVERHEAD_SLOTS
        from .optimizer import MachineProfile, choose_plan, skew_share

        cfg = self.config
        stats = {a.rel: int(dedup_rows[a.alias].shape[0]) for a in query.atoms}
        # max single-value column share per relation: the advisor's skew
        # statistic (skewed instances steer to the hybrid engine)
        skew = {a.rel: skew_share(dedup_rows[a.alias]) for a in query.atoms}
        wg = (
            wire_gain([self._wire_policy.format_for(a.attrs) for a in query.atoms])
            if cfg.wire_format == "packed" else 1.0
        )
        return choose_plan(
            query,
            stats,
            # calibrated plans pay their predicted measure dispatches at the
            # dispatch-overhead price, fixed plans the ~p-fold pad factor
            profile=MachineProfile(
                p=self.spmd.p, dispatch_overhead=DEFAULT_DISPATCH_OVERHEAD_SLOTS,
            ),
            hand_ghd=ghd,
            local_backend=cfg.local_backend,
            calibrate_shuffle=cfg.calibrate_shuffle,
            skew=skew,
            skew_threshold=cfg.skew_threshold,
            calibrate_options=(True, False),
            wire_gain=wg,
        )

    def _make_executor(self) -> PhysicalExecutor:
        cfg = self.config
        wp = self._wire_policy if cfg.wire_format == "packed" else None
        kw = dict(
            seed=cfg.seed,
            max_retries=cfg.max_retries,
            count_retries_comm=cfg.count_retries_comm,
            calibrate=cfg.calibrate_shuffle,
            skew_threshold=cfg.skew_threshold,
            # a shared cache instance wins over the boolean knob (but an
            # explicitly disabled cache stays disabled)
            caps_cache=(
                self._shared_caps_cache
                if self._shared_caps_cache is not None and cfg.caps_cache
                else cfg.caps_cache
            ),
            prefetch=cfg.prefetch_measures,
            wire_policy=wp,
        )
        if self.plan is not None:
            # config mirrors the plan by construction; load() clears
            # self.plan before rebuilding, so a restored config never
            # disagrees with this path
            return PhysicalExecutor.from_plan(
                self.spmd, self.plan, self.capman, local_backend=self.local_backend, **kw
            )
        return PhysicalExecutor(
            self.spmd, cfg.strategy, self.capman, fuse=cfg.fused,
            local_backend=self.local_backend, **kw,
        )

    def _max_cap(self) -> int:
        """Per-shard capacity ceiling: the configured bound, or 64x the
        Assumption-3 memory M = 4*IN/p (pow2, floored at 2^16)."""
        if self.config.max_cap_tuples is not None:
            return int(self.config.max_cap_tuples)
        total = sum(self._base_counts.values())
        m = 4 * max(1, -(-total // self.spmd.p))
        return _pow2(max(1 << 16, 64 * m))

    # caps live in the capacity manager; a property for snapshots
    @property
    def caps(self) -> Dict[int, int]:
        return self.capman.caps

    @caps.setter
    def caps(self, value: Dict[int, int]) -> None:
        self.capman.caps = dict(value)

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
        return self._commit_round(
            rnd, self.executor.execute_round(rnd, self.tables, self.acc, self.ledger)
        )

    def _commit_round(self, rnd: Round, out) -> bool:
        """Install a finished round's tables, queue the next round's
        measure prefetch, record the round and advance the cursor; True
        if more rounds remain."""
        (
            new_tab, new_acc, comm, padded, heavy, claimed, dispatches,
            measure_dispatches, wire_bytes, useful_bytes,
        ) = out
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

    def step_gen(self):
        """Reentrant variant of ``step()`` for the serving layer: a
        generator that YIELDS each stage's prepared ``GroupWork`` list and
        RECEIVES the matching ``GroupResult`` list via ``send`` — the
        caller owns the dispatch, so compatible groups from many drivers
        can run as one merged dispatch.  Returns (``StopIteration.value``)
        True if more rounds remain, as ``step()`` does.

        The materialization round runs inline (no yields): it is one-time
        per query, so there is nothing recurring to merge across requests,
        and a driver's first drive may finish without yielding.  Seeds,
        retries and capacity growth stay inside, so an interleaved drive
        equals ``step()``."""
        if self.done:
            return False
        if self.cursor < 0 or self.cursor >= len(self.schedule):
            return self.step()
        rnd = self.schedule[self.cursor]
        gen = self.executor.round_steps(rnd, self.tables, self.acc, self.ledger)
        try:
            works = next(gen)
            while True:
                self._pending_works = works
                results = yield works
                works = gen.send(results)
        except StopIteration as stop:
            out = stop.value
        self._pending_works = []
        return self._commit_round(rnd, out)

    def pending_groups(self):
        """The ``GroupWork`` list an in-flight ``step_gen`` is suspended on
        (empty when none) — what the server's bucketing sees."""
        return list(self._pending_works)

    def _finish(self) -> None:
        root = self.ghd.root
        out = self.tables[root]
        # canonical output column order
        want = [a for a in self.query.output_attrs if a in out.schema]
        self.result, _ = R.dist_project(self.spmd, out, want)
        self.ledger.output_tuples = int(self.spmd.to_host(self.result.valid).sum())
        self.done = True

    def run(self) -> DTable:
        while self.step():
            pass
        if not self.done:
            self._finish()
        assert self.result is not None
        return self.result

    # -- fault tolerance: snapshot / resume ----------------------------------
    def save(self, path: str) -> None:
        """Atomic snapshot of the driver state between rounds, in the
        reference package's npz layout: a ``meta`` JSON string plus
        ``data_k`` / ``valid_k`` (node tables) and ``accdata_k`` /
        ``accvalid_k`` (upward accumulators), int32 and bool, each over the
        whole reducer axis.

        On a mesh ``save`` is collective: every rank calls it with the same
        ``path`` at the same cursor, and ``load`` needs that path to be one
        that every rank can read (a filesystem they share).  The ranks'
        ``meta`` must agree (else every rank raises), the blocks are
        gathered to rank 0 in one gather, rank 0 writes the same file the
        simulation writes, and no rank returns before the file is
        published; if rank 0 fails on the way, every rank raises."""
        meta = {
            "cursor": self.cursor,
            "done": self.done,
            "config": dataclasses.asdict(self.config),
            # the (complete) GHD being executed: an auto/plan run may use
            # another decomposition than the resuming driver was built with
            "ghd": self.ghd.to_dict(),
            "caps": {str(k): v for k, v in self.caps.items()},
            "ledger": {
                "records": [dataclasses.asdict(r) for r in self.ledger.records],
                "output_tuples": self.ledger.output_tuples,
                "retries": self.ledger.retries,
            },
            "schemas": {str(k): list(t.schema) for k, t in self.tables.items()},
            "acc_schemas": {str(k): list(t.schema) for k, t in self.acc.items()},
        }
        if self.executor.caps_cache is not None:
            # keep the amortization warm across resume
            meta["caps_cache"] = self.executor.caps_cache.to_json()
        text = json.dumps(meta)
        if not self.spmd.same_on_every_rank(text):
            raise RuntimeError(f"GymDriver.save({path!r}): the ranks' driver states differ")
        names, blocks = [], []
        for prefix, store in (("", self.tables), ("acc", self.acc)):
            for k, t in store.items():
                names += [f"{prefix}data_{k}", f"{prefix}valid_{k}"]
                blocks += [t.data, t.valid]
        ok = True
        try:
            arrays = self.spmd.to_host_at(*blocks)  # None on every rank but the writer
            if arrays is not None:
                _write_npz(path, meta=text, **dict(zip(names, arrays)))
        except BaseException:
            ok = False
            raise
        finally:
            # every rank waits here for the writer, and learns if it failed
            published = self.spmd.barrier(ok)
        if not published:
            raise RuntimeError(f"GymDriver.save({path!r}): the writing rank failed")

    def load(self, path: str) -> None:
        """Restore a ``save`` snapshot onto this driver's device.  The
        snapshot's GHD and config win (``local_backend`` included, resolved
        against this device as the constructor does); a shared caps cache
        merges the snapshot's entries instead of being replaced.

        On a mesh every rank calls ``load`` with the same ``path`` and keeps
        its own block of each table.  A snapshot taken at another ``p``
        raises: a gym snapshot resumes only at its own reducer count."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            arrays = {k: z[k] for k in z.files if k != "meta"}
        for k, a in arrays.items():
            if a.shape[0] != self.spmd.p:
                raise ValueError(
                    f"GymDriver.load({path!r}): {k} holds {a.shape[0]} reducers' shards, this "
                    f"driver runs {self.spmd.p}; a snapshot resumes only at its own p"
                )
        self.cursor = meta["cursor"]
        self.done = meta["done"]
        if "ghd" in meta:
            # tables, caps and schedule are keyed by the snapshot GHD's nodes
            self.ghd = GHD.from_dict(meta["ghd"])
            attr_order = {a: i for i, a in enumerate(self.query.output_attrs)}
            self.node_schema = {
                v: tuple(sorted(self.ghd.chi[v], key=lambda a: attr_order[a]))
                for v in self.ghd.nodes()
            }
        if "config" in meta:
            # resuming must not change the query's plan, seeds or backend
            # mid-flight; the constructor's in-memory Plan is superseded
            self.config = GymConfig(**meta["config"])
            self.plan = None
            self.local_backend = self._resolve_backend()
            self.capman.local_backend = self.local_backend
            self.capman.growth = self.config.cap_growth
            self.capman.max_cap = self._max_cap()
            self.executor = self._make_executor()
            self.schedule = get_schedule(self.config.schedule).fn(self.ghd)
        # a prefetched measure belongs to the pre-snapshot timeline
        self.executor._pending = None
        cc = self.executor.caps_cache
        if "caps_cache" in meta and cc is not None:
            # a SHARED cache keeps co-tenants' confirmed entries
            cc.load_json(meta["caps_cache"], merge=cc is self._shared_caps_cache)
        self.caps = {int(k): v for k, v in meta["caps"].items()}
        led = Ledger()
        led.records = [RoundRecord(**r) for r in meta["ledger"]["records"]]
        led.output_tuples = meta["ledger"]["output_tuples"]
        led.retries = meta["ledger"]["retries"]
        self.ledger = led

        def table(prefix: str, k: str, schema) -> DTable:
            # the whole table on the host, this process' share on the device
            return self.spmd.device_put(DTable(
                torch.from_numpy(np.asarray(arrays[f"{prefix}data_{k}"], np.int32)),
                torch.from_numpy(np.asarray(arrays[f"{prefix}valid_{k}"], bool)),
                tuple(schema),
            ))

        self.tables = {int(k): table("", k, s) for k, s in meta["schemas"].items()}
        self.acc = {
            int(k): table("acc", k, s) for k, s in meta.get("acc_schemas", {}).items()
        }
        # the final projection is derived state: recompute it for a
        # post-completion snapshot so run() returns the result
        self.result = None
        if self.done:
            self._finish()


def _write_npz(path: str, **arrays) -> None:
    """``np.savez`` to ``path`` through a temporary file in its directory,
    published by one atomic rename."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)  # atomic publish
    except BaseException:
        os.unlink(tmp)
        raise


# --------------------------------------------------------------------------
# front door
# --------------------------------------------------------------------------
def gym(
    query: Query,
    data: Dict[str, np.ndarray],
    *,
    ghd: Optional[GHD] = None,
    p: Optional[int] = None,
    spmd: Optional[SPMD] = None,
    config: Optional[GymConfig] = None,
    plan=None,  # Optional[optimizer.Plan]
    device=None,
) -> Tuple[np.ndarray, Tuple[str, ...], Ledger]:
    """Evaluate Q with GYM.  Returns (rows, schema, ledger).

    Three ways to pick the physical plan: manual (default: ``ghd`` +
    ``GymConfig`` knobs as given); ``config=GymConfig(plan="auto")`` (the
    cost-based advisor enumerates GHD x schedule x engine x fusion
    candidates and executes the argmin; ``ghd``, if given, joins the
    candidates as the 'hand' GHD); ``plan=<Plan>`` (a plan the caller
    already chose, e.g. from ``optimizer.enumerate_plans``).

    ``device`` (else ``config.device``) picks where the query runs; None
    means the CUDA card, and raises when there is none.  ``p`` reducers
    (4 unless given).  ``spmd`` runs the query on that ``SPMD`` instead,
    e.g. one rank of a mesh, ``SPMD(p, mesh=...)``, with its ``p``: every
    rank returns the whole answer."""
    from .decompose import ghd_for

    g = ghd if ghd is not None else (plan.ghd if plan is not None else ghd_for(query))
    if spmd is None and device is None and config is not None:
        device = config.device
    spmd = spmd_for("gym", p, spmd, device)
    drv = GymDriver(query, g, data, spmd, config, plan=plan)
    out = drv.run()
    return out.to_numpy(spmd), out.schema, drv.ledger
