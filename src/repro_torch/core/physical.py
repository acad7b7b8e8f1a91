"""Physical execution layer: logical planner rounds -> fused SPMD dispatches.

The planner (``planner.py``) emits *logical* rounds — sets of independent
semijoin/intersect/join ops that the BSP model (Theorem 15 / Sec. 4.3)
charges as ONE round.  This module keeps that promise:

  1. **Lowering** — each logical ``Op`` becomes a short dataflow of
     *physical* ops (``PhysOp``) over named slots, arranged in stages.
  2. **Grouping** — within a stage, physical ops with the same kind and
     uniform signature (shard shapes, key count, capacity) form a group.
  3. **Fused dispatch** — each group executes as ONE SPMD dispatch via
     the stacked operators in ``relational.batched``.

Engine strategies are a registry (``register_engine``): ``'hash'`` (hash
co-partitioning, comm ~ inputs + outputs, skew-sensitive with
abort-retry), ``'hybrid'`` (hash for light keys, grid-style spread and
broadcast for the heavy keys the count pre-pass flags) and ``'grid'``
(the paper's Lemmas 8/10, positional and skew-proof).  Every engine materializes a GHD bag of more than two atoms
with the Lemma 8 grid multiway join; the hash engine joins 2-atom bags
by hash.  Capacity sizing and the paper's
abort-and-retry semantics live in ``CapacityManager``.

Occupancy-adaptive shuffle (``calibrate=True``, the default): a count-only
pre-pass sizes every exchange with tight pow2 capacities.  Every
measuring group of a stage shares ONE combined count dispatch
(``RoundCounts``), measured capacities persist across rounds in a
``CapsCache``, and the next round's combined pre-pass is queued behind
the current round's payload work (measure prefetch).  The ledger splits
``measure_dispatches`` from payload dispatches.

Packed wire (``wire_policy=``, from ``GymConfig(wire_format="packed")``):
every exchange ships its rows bit-packed to the widths the policy derives
from the base relations (``relational.wire``), each side in the format
``RoutePolicy`` projects onto its schema; the hash join's fused pre-count
then guesses the uniform share rather than 4x it.  ``PhysicalExecutor.
from_plan`` builds an executor from an advisor ``Plan`` (``core/optimizer.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..relational import batched as B
from ..relational import grid as G
from ..relational import ops as R
from ..relational.batched import GroupMeasure
from ..relational.ledger import Ledger
from ..relational.routed import RoutePolicy
from ..relational.shuffle import pow2
from ..relational.skew import DEFAULT_SKEW_THRESHOLD
from ..relational.spmd import SPMD
from ..relational.table import DTable
from ..relational.wire import WireFormat, WirePolicy, count_wire_bytes
from .caps_cache import CapsCache
from .ghd import GHD
from .planner import Op, Round

# --------------------------------------------------------------------------
# engine strategy registry
# --------------------------------------------------------------------------
ENGINES: Dict[str, type] = {}


def register_engine(name: str):
    """Class decorator: make an ``Engine`` subclass selectable by name."""

    def deco(cls):
        ENGINES[name] = cls
        cls.name = name
        return cls

    return deco


def get_engine(
    name: str, spmd: SPMD, local_backend: str = "torch",
    skew_threshold: Optional[float] = None,
    wire_policy: Optional[WirePolicy] = None,
) -> "Engine":
    try:
        cls = ENGINES[name]
    except KeyError:
        raise ValueError(
            f"unknown engine strategy {name!r}; registered: {sorted(ENGINES)}"
        ) from None
    return cls(spmd, local_backend, skew_threshold=skew_threshold, wire_policy=wire_policy)


class Engine:
    """Strategy interface: batched group execution of homogeneous physical
    ops.  Each ``*_many`` method takes k uniform instances plus per-instance
    seeds (and an optional ``xcaps`` measurement) and returns (outputs,
    per-instance stats, claimed BSP rounds).  Intersect and dedup are
    shared by every strategy."""

    name = "?"
    # whether dist_join_count predicts this engine's per-shard join output
    exact_join_presize = False
    # whether the routing is data-dependent and therefore NEEDS the count
    # pre-pass (the executor forces calibrate on for such engines)
    requires_measure = False
    # whether pair measures may re-route under the hybrid heavy-hitter
    # exchange (drives ``measure_finish``'s re-measure)
    hybrid_measure = False

    def __init__(
        self, spmd: SPMD, local_backend: str = "torch",
        skew_threshold: Optional[float] = None,
        wire_policy: Optional[WirePolicy] = None,
    ):
        self.spmd = spmd
        self.local_backend = local_backend
        # the routing policy: wire encoding + heavy-hitter sensitivity,
        # shared by every exchange of the query.  The wire policy (None =
        # dense exchanges) comes from the base relations' value ranges, so
        # any format built from it is sound for every intermediate.
        self.route = RoutePolicy(
            wire_policy=wire_policy,
            skew_threshold=(
                DEFAULT_SKEW_THRESHOLD if skew_threshold is None else skew_threshold
            ),
        )

    @property
    def skew_threshold(self) -> float:
        return self.route.skew_threshold

    @property
    def wire_policy(self) -> Optional[WirePolicy]:
        return self.route.wire_policy

    # -- packed wire formats (delegates to the routing policy) --------------
    def _fmt_for(self, schemas) -> Optional[WireFormat]:
        return self.route.fmt_for(schemas)

    def _pair_fmts(self, lhs, rhs, xcaps, rhs_keys_only: bool = False):
        return self.route.pair_fmts(
            [t.schema for t in lhs], [t.schema for t in rhs], xcaps,
            rhs_keys_only=rhs_keys_only,
        )

    def _single_fmt(self, ts, xcaps):
        return self.route.single_fmt([t.schema for t in ts], xcaps)

    # -- calibration pre-pass ----------------------------------------------
    def measure_group(self, kind: str, lhs, rhs, seeds) -> Optional[GroupMeasure]:
        """ONE count-only dispatch for the whole group (None = kind not
        measurable; the payload then runs with the worst-case defaults)."""
        if kind == "intersect":
            return B.measure_intersect_many(
                self.spmd, lhs, rhs, seeds=seeds, backend=self.local_backend
            )
        if kind == "dedup":
            return B.measure_dedup_many(
                self.spmd, lhs, seeds=seeds, backend=self.local_backend
            )
        return None

    def measure_spec(self, kind: str, lhs, rhs, seeds) -> Optional["B.MeasureSpec"]:
        """This group's slice of the round's COMBINED count pre-pass
        (stacking only, no dispatch)."""
        if kind == "intersect":
            return B.pair_measure_spec(
                self.spmd, lhs, rhs,
                [tuple(range(a.arity)) for a in lhs],
                [b.cols(a.schema) for a, b in zip(lhs, rhs)],
                seeds, dedup_b=False,
            )
        if kind == "dedup":
            return B.single_measure_spec(self.spmd, lhs, seeds)
        return None

    def measure_finish(self, kind: str, lhs, rhs, seeds, m: GroupMeasure) -> GroupMeasure:
        """Engine-specific host-side tail applied to a combined-pass slice."""
        if kind == "intersect":
            return dataclasses.replace(m, out_recv=m.lhs.cap_recv)
        return m  # dedup slices already carry out_recv

    def measure_needs_join_count(self, kind: str) -> bool:
        return False

    # -- per-kind batched ops ----------------------------------------------
    def semijoin_many(self, ss, rs, cap: int, seeds, xcaps=None):
        raise NotImplementedError

    def join_many(self, as_, bs, cap: int, seeds, xcaps=None):
        raise NotImplementedError

    def intersect_many(self, as_, bs, cap: int, seeds, xcaps=None):
        fmts, xcaps = self._pair_fmts(as_, bs, xcaps)
        kw = {"fmts": fmts}
        if xcaps is not None:
            kw["c_out"] = (xcaps.lhs.c_out, xcaps.rhs.c_out)
            kw["cap_recv"] = (max(cap, xcaps.lhs.cap_recv), xcaps.rhs.cap_recv)
        else:
            kw["cap_recv"] = (cap, self.spmd.p * bs[0].cap)
        outs, stats = B.dist_intersect_many(
            self.spmd, as_, bs, seeds=seeds, backend=self.local_backend, **kw
        )
        return outs, stats, 1

    def dedup_many(self, ts, cap: int, seeds, xcaps=None):
        fmt, xcaps = self._single_fmt(ts, xcaps)
        kw = {"cap_recv": cap, "fmt": fmt}
        if xcaps is not None:
            kw["c_out"] = xcaps.lhs.c_out
            kw["cap_recv"] = max(cap, xcaps.lhs.cap_recv)
        outs, stats = B.dist_dedup_many(
            self.spmd, ts, seeds=seeds, backend=self.local_backend, **kw
        )
        return outs, stats, 1

    # -- materialization (one-time per query) ------------------------------
    def _multijoin_grid(self, parts: List[DTable]) -> bool:
        """Whether ``multijoin`` takes the grid path for these parts (those
        pre-passes batch across vertices)."""
        return len(parts) >= 2

    def multijoin_measure_batch(self, parts_list, seeds):
        """Phase A of materialization: the grid-path multijoin calibrations
        of every multi-atom vertex with ONE combined count dispatch
        (``grid_multiway_count``).  Returns {vertex_index: (cal,
        count_pad, count_bytes)} for ``multijoin(cal=...)``."""
        idx = [
            i for i, ps in enumerate(parts_list)
            if len(ps) >= 2 and self._multijoin_grid(ps)
        ]
        if not idx:
            return {}
        cals, pads, byts = G.grid_multiway_count(self.spmd, [parts_list[i] for i in idx])
        return {i: (c, pad, by) for i, c, pad, by in zip(idx, cals, pads, byts)}

    def multijoin(self, parts: List[DTable], cap: int, seed: int, calibrate=False, cal=None):
        if len(parts) == 1:
            return parts[0], {
                "sent": 0, "dropped": 0, "padded": 0, "wire_bytes": 0, "ubytes": 0,
            }, 0
        fmts = (
            None if self.wire_policy is None
            else [self.wire_policy.format_for(t.schema) for t in parts]
        )
        out, st = G.grid_multiway_join(
            self.spmd, parts, out_cap=cap, calibrate=calibrate, cals=cal,
            fmts=fmts, backend=self.local_backend,
        )
        return out, st, 1


@register_engine("hash")
class HashEngine(Engine):
    """Hash co-partitioning (comm ~ inputs + outputs, skew-sensitive;
    overflow triggers the abort-retry path)."""

    exact_join_presize = True

    def measure_group(self, kind, lhs, rhs, seeds):
        if kind == "semijoin":
            return B.measure_semijoin_many(
                self.spmd, lhs, rhs, seeds=seeds, backend=self.local_backend,
                skew_threshold=self.skew_threshold,
            )
        if kind == "join":
            return B.measure_join_many(
                self.spmd, lhs, rhs, seeds=seeds, backend=self.local_backend,
                skew_threshold=self.skew_threshold,
            )
        return Engine.measure_group(self, kind, lhs, rhs, seeds)

    def measure_spec(self, kind, lhs, rhs, seeds):
        if kind in ("semijoin", "join"):
            shareds = [[x for x in a.schema if x in b.schema] for a, b in zip(lhs, rhs)]
            a_keys = [a.cols(sh) for a, sh in zip(lhs, shareds)]
            b_keys = [b.cols(sh) for b, sh in zip(rhs, shareds)]
            if kind == "join":
                # fuse the output pre-count into the same dispatch; the
                # keys-only exchanges ride at a static guess (4x the
                # uniform per-destination share, dense) the counts verify
                # post hoc.  Packed runs ship the key projections
                # bit-packed (an exact count) instead of a hashed column.
                return B.join_pair_measure_spec(
                    self.spmd, lhs, rhs, a_keys, b_keys, seeds,
                    g_a=self._keys_guess(lhs[0].cap),
                    g_b=self._keys_guess(rhs[0].cap),
                    skew_threshold=self.skew_threshold,
                    fmt=self._fmt_for([tuple(sh) for sh in shareds]),
                )
            return B.pair_measure_spec(
                self.spmd, lhs, rhs, a_keys, b_keys, seeds, dedup_b=True,
                skew_threshold=self.skew_threshold,
            )
        return Engine.measure_spec(self, kind, lhs, rhs, seeds)

    def _keys_guess(self, cap: int) -> int:
        per = -(-cap // self.spmd.p)  # ceil: the uniform share
        # Headroom avoids the fallback join_need_many dispatch an
        # undershot guess costs, but every guessed slot ships.  Dense pays
        # 5 bytes a slot elsewhere, so 4x headroom is cheap insurance; a
        # packed run's contract is byte-minimality, so it guesses the
        # uniform share and accepts the (rare, still exact) fallback.
        mult = 1 if self.wire_policy is not None else 4
        return pow2(min(cap, max(8, mult * per)))

    def measure_finish(self, kind, lhs, rhs, seeds, m):
        if kind == "semijoin":
            return B.finish_semijoin_measure(
                self.spmd, lhs, rhs, seeds, m,
                hybrid=self.hybrid_measure, backend=self.local_backend,
            )
        if kind == "join":
            return B.hybridize_join_measure(
                self.spmd, lhs, rhs, seeds, m,
                hybrid=self.hybrid_measure, backend=self.local_backend,
            )
        return Engine.measure_finish(self, kind, lhs, rhs, seeds, m)

    def measure_needs_join_count(self, kind):
        return kind == "join"

    def semijoin_many(self, ss, rs, cap, seeds, xcaps=None):
        fmts, xcaps = self._pair_fmts(ss, rs, xcaps, rhs_keys_only=True)
        kw = {"fmts": fmts}
        if xcaps is not None:
            kw["c_out"] = (xcaps.lhs.c_out, xcaps.rhs.c_out)
            # S receives the output: never below the managed capacity
            kw["cap_recv"] = (max(cap, xcaps.lhs.cap_recv), xcaps.rhs.cap_recv)
        else:
            kw["cap_recv"] = (cap, self.spmd.p * rs[0].cap)
        outs, stats = B.dist_semijoin_many(
            self.spmd, ss, rs, seeds=seeds, backend=self.local_backend, **kw
        )
        return outs, stats, 1

    def join_many(self, as_, bs, cap, seeds, xcaps=None):
        fmts, xcaps = self._pair_fmts(as_, bs, xcaps)
        kw = {"fmts": fmts}
        if xcaps is not None:
            kw["c_out"] = (xcaps.lhs.c_out, xcaps.rhs.c_out)
            kw["cap_recv"] = (xcaps.lhs.cap_recv, xcaps.rhs.cap_recv)
        outs, stats = B.dist_join_many(
            self.spmd, as_, bs, seeds=seeds, out_cap=cap,
            backend=self.local_backend, **kw,
        )
        return outs, stats, 1

    def _multijoin_grid(self, parts):
        return len(parts) != 2  # 2-way takes the hash path below

    def multijoin_measure_batch(self, parts_list, seeds):
        """Grid-path vertices batch as in ``Engine``; the 2-way vertices
        batch their pair-exchange counts into one further combined
        dispatch (``measure_exchange_pairs``)."""
        cal_map = Engine.multijoin_measure_batch(self, parts_list, seeds)
        pidx = [
            i for i, ps in enumerate(parts_list)
            if len(ps) == 2 and [x for x in ps[0].schema if x in ps[1].schema]
        ]
        if pidx:
            items = []
            for i in pidx:
                a, b = parts_list[i]
                shared = [x for x in a.schema if x in b.schema]
                items.append((a, b, shared, shared, seeds[i], (False, False)))
            res = R.measure_exchange_pairs(self.spmd, items, backend=self.local_backend)
            pad = 2 * self.spmd.p * self.spmd.p  # two (p,)-int vectors
            for i, cal in zip(pidx, res):
                cal_map[i] = (cal, pad, count_wire_bytes(self.spmd.p, 2))
        return cal_map

    def multijoin(self, parts, cap, seed, calibrate=False, cal=None):
        if len(parts) == 2:
            kw = {}
            if cal is not None:
                kw["c_out"], kw["cap_recv"] = cal
            shared = [x for x in parts[0].schema if x in parts[1].schema]
            if self.wire_policy is not None and shared:
                # packed runs route the materialization 2-way join through
                # the batched exchange (same shard semantics, fmt-aware
                # wire) — sequential dist_join ships dense only
                fmts, _ = self._pair_fmts([parts[0]], [parts[1]], None)
                outs, stats = B.dist_join_many(
                    self.spmd, [parts[0]], [parts[1]], seeds=[seed],
                    out_cap=cap, fmts=fmts, backend=self.local_backend, **kw,
                )
                return outs[0], stats[0], 1
            out, st = R.dist_join(
                self.spmd, parts[0], parts[1], seed=seed, out_cap=cap,
                calibrate=calibrate, backend=self.local_backend, **kw,
            )
            return out, st, 1
        return Engine.multijoin(self, parts, cap, seed, calibrate, cal)


@register_engine("hybrid")
class HybridEngine(HashEngine):
    """Skew-resilient heavy/light decomposition (``relational.skew``): the
    count pre-pass flags heavy destinations, the payload routes light keys
    through the hash exchange and heavy keys grid-style (one side spread
    over all p reducers, the other broadcast) in the SAME fused dispatch.
    On unskewed groups the measure finds no heavy keys and the payload is
    the hash engine's, bit for bit.

    The routing is data-dependent, so the engine REQUIRES the count
    pre-pass: the executor forces ``calibrate`` on (``requires_measure``)
    even when the config disables the calibrated shuffle."""

    requires_measure = True
    hybrid_measure = True
    # abort-retry pre-sizing stays valid: blown joins only happen on
    # hash-routed groups (hybrid-routed ones pre-floor the exact spread
    # output from the measure), and there the hash placement is the one
    # that blew
    exact_join_presize = True

    def measure_group(self, kind, lhs, rhs, seeds):
        if kind == "semijoin":
            return B.measure_semijoin_many(
                self.spmd, lhs, rhs, seeds=seeds, backend=self.local_backend,
                hybrid=True, skew_threshold=self.skew_threshold,
            )
        if kind == "join":
            return B.measure_join_many(
                self.spmd, lhs, rhs, seeds=seeds, backend=self.local_backend,
                hybrid=True, skew_threshold=self.skew_threshold,
            )
        return Engine.measure_group(self, kind, lhs, rhs, seeds)

    def semijoin_many(self, ss, rs, cap, seeds, xcaps=None):
        if xcaps is None or not xcaps.hybrid_routed:
            return HashEngine.semijoin_many(self, ss, rs, cap, seeds, xcaps)
        fmts, xcaps = self._pair_fmts(ss, rs, xcaps, rhs_keys_only=True)
        outs, stats = B.hybrid_semijoin_many(
            self.spmd, ss, rs, seeds=seeds, heavy=xcaps.heavy,
            c_out=(xcaps.lhs.c_out, xcaps.rhs.c_out),
            cap_recv=(max(cap, xcaps.lhs.cap_recv), xcaps.rhs.cap_recv),
            fmts=fmts, backend=self.local_backend,
        )
        return outs, stats, 1

    def join_many(self, as_, bs, cap, seeds, xcaps=None):
        if xcaps is None or not xcaps.hybrid_routed:
            return HashEngine.join_many(self, as_, bs, cap, seeds, xcaps)
        fmts, xcaps = self._pair_fmts(as_, bs, xcaps)
        outs, stats = B.hybrid_join_many(
            self.spmd, as_, bs, seeds=seeds, out_cap=cap, heavy=xcaps.heavy,
            c_out=(xcaps.lhs.c_out, xcaps.rhs.c_out),
            cap_recv=(xcaps.lhs.cap_recv, xcaps.rhs.cap_recv),
            swap=xcaps.swap_spread, fmts=fmts, backend=self.local_backend,
        )
        return outs, stats, 1

    def multijoin_measure_batch(self, parts_list, seeds):
        # 2-way bags take dist_join_hybrid, whose heavy-hitter routing needs
        # its own per-destination flags — only the grid-path vertices batch
        return Engine.multijoin_measure_batch(self, parts_list, seeds)

    def multijoin(self, parts, cap, seed, calibrate=False, cal=None):
        if len(parts) == 2:
            out, st = R.dist_join_hybrid(
                self.spmd, parts[0], parts[1], seed=seed, out_cap=cap,
                skew_threshold=self.skew_threshold, backend=self.local_backend,
            )
            return out, st, 1
        return Engine.multijoin(self, parts, cap, seed, calibrate, cal)


@register_engine("grid")
class GridEngine(Engine):
    """Paper-faithful Lemmas 8/10 (skew-proof, B(X, M) = X^2/M comm)."""

    def measure_group(self, kind, lhs, rhs, seeds):
        if kind == "semijoin":
            return B.measure_grid_semijoin_many(self.spmd, lhs, rhs)
        if kind == "join":
            return B.measure_grid_join_many(self.spmd, lhs, rhs)
        return Engine.measure_group(self, kind, lhs, rhs, seeds)

    def measure_spec(self, kind, lhs, rhs, seeds):
        if kind == "semijoin":
            return B.grid_rkeys_measure_spec(self.spmd, lhs, rhs)
        if kind == "join":
            return B.grid_pair_measure_spec(self.spmd, lhs, rhs)
        return Engine.measure_spec(self, kind, lhs, rhs, seeds)

    def semijoin_many(self, ss, rs, cap, seeds, xcaps=None):
        fmts, xcaps = self._pair_fmts(ss, rs, xcaps, rhs_keys_only=True)
        kw = {"fmts": fmts}
        if xcaps is not None:
            kw["c_out"] = (xcaps.lhs.c_out, xcaps.rhs.c_out)
            kw["cap_recv"] = (xcaps.lhs.cap_recv, xcaps.rhs.cap_recv)
        outs, stats = B.grid_semijoin_many(
            self.spmd, ss, rs, seeds=seeds, out_cap=cap,
            backend=self.local_backend, **kw,
        )
        return outs, stats, 2

    def join_many(self, as_, bs, cap, seeds, xcaps=None):
        fmts, xcaps = self._pair_fmts(as_, bs, xcaps)
        kw = {"fmts": fmts}
        if xcaps is not None:
            kw["c_out"] = (xcaps.lhs.c_out, xcaps.rhs.c_out)
            kw["cap_recv"] = (xcaps.lhs.cap_recv, xcaps.rhs.cap_recv)
        outs, stats = B.grid_join_many(
            self.spmd, as_, bs, out_cap=cap, backend=self.local_backend, **kw
        )
        return outs, stats, 1


# --------------------------------------------------------------------------
# capacity management (the paper's abort-and-retry, centralized)
# --------------------------------------------------------------------------
class CapacityCeiling(R.Overflow):
    """A capacity would grow past the configured per-shard memory bound."""


class CapacityManager:
    """Per-GHD-node output capacities + overflow policy.

    - ``cap_for(nodes)``: pow2 capacity for an op writing into ``nodes``.
    - ``grow(nodes, dropped)``: multiplicative growth past the observed
      overflow.
    - ``presize_join(a, b, seed)``: EXACT per-shard output count of the
      blown join via a key-only counting dispatch.
    - ``max_cap``: hard per-shard capacity ceiling; growth past it raises
      ``CapacityCeiling`` naming the heavy destination count the last
      count pre-pass saw (``heavy_hint``).
    """

    def __init__(
        self, spmd: SPMD, growth: int = 4, local_backend: str = "torch",
        max_cap: Optional[int] = None,
    ):
        self.spmd = spmd
        self.growth = growth
        self.local_backend = local_backend
        self.caps: Dict[int, int] = {}
        self.max_cap = max_cap
        self.heavy_hint: int = 0

    def _check(self, nodes: Sequence[int], cap: int) -> None:
        if self.max_cap is not None and cap > self.max_cap:
            if self.heavy_hint:
                hint = (
                    f"{self.heavy_hint} heavy destination(s) were flagged by "
                    "this round's count pre-passes — the round is skew-bound, "
                    "and abort-retry doubling cannot fix skew (the heavy key "
                    "lands on one reducer at ANY capacity); switch to "
                    "engine='hybrid' (heavy-hitter routing) or engine='grid' "
                    "(skew-proof)"
                )
            else:
                hint = (
                    "this round's count pre-passes flagged no heavy "
                    "destinations (none measured if calibrate_shuffle is "
                    "off), so the load may genuinely be this large; raise "
                    "GymConfig.max_cap_tuples — or, under skew, switch to "
                    "engine='hybrid' or engine='grid'"
                )
            raise CapacityCeiling(
                f"capacity for node(s) {tuple(nodes)} would grow to {cap} > "
                f"max_cap {self.max_cap} (bound tied to the configured "
                f"per-machine memory M); {hint}"
            )

    def cap_for(self, nodes: Sequence[int]) -> int:
        return pow2(max(self.caps.get(v, 4) for v in nodes))

    def ensure(self, v: int, cap: int) -> None:
        self._check((v,), cap)
        self.caps[v] = max(self.caps.get(v, 0), cap)

    def grow(self, nodes: Sequence[int], dropped: int) -> None:
        for v in nodes:
            cap = pow2(self.caps.get(v, 4) * self.growth + int(dropped))
            self._check((v,), cap)
            self.caps[v] = cap

    def grow_node(self, v: int) -> None:
        cap = pow2(self.caps.get(v, 4) * self.growth)
        self._check((v,), cap)
        self.caps[v] = cap

    def presize_join(self, a: DTable, b: DTable, seed: int) -> int:
        counts = R.dist_join_count(self.spmd, a, b, seed=seed, backend=self.local_backend)
        return pow2(max(4, int(counts.max())))

    def floor(self, nodes: Sequence[int], cap: int) -> None:
        for v in nodes:
            self.ensure(v, cap)


# --------------------------------------------------------------------------
# lowering: logical Op -> staged physical dataflow over named slots
# --------------------------------------------------------------------------
@dataclasses.dataclass
class PhysOp:
    """One physical operator instance.

    Slots: ``tab:v`` (node v's table), ``up:v`` (node v read through its
    upward accumulator if present), ``tmp:j:i`` (temporary i of logical op
    j).  ``cap_nodes`` are the GHD nodes whose managed capacity sizes this
    op's output; ``logical`` indexes the owning logical op for retry blame.
    """

    kind: str  # 'semijoin' | 'join' | 'intersect' | 'dedup'
    out: str
    a: str
    b: Optional[str]
    cap_nodes: Tuple[int, ...]
    logical: int
    seed: int = 0


def _tab(v: int) -> str:
    return f"tab:{v}"


def _up(v: int) -> str:
    return f"up:{v}"


def lower_op(op: Op, j: int) -> Tuple[List[List[PhysOp]], Tuple[str, int, str]]:
    """Lower one logical op: (stages, (store, node, result_slot))."""

    def tmp(i: int) -> str:
        return f"tmp:{j}:{i}"

    k = op.kind
    if k == "semijoin":
        (r,) = op.args
        ops = [[PhysOp("semijoin", tmp(0), _tab(op.target), _up(r), (op.target,), j)]]
        return ops, ("tab", op.target, tmp(0))
    if k == "down_semijoin":
        (s,) = op.args
        ops = [[PhysOp("semijoin", tmp(0), _tab(op.target), _tab(s), (op.target,), j)]]
        return ops, ("tab", op.target, tmp(0))
    if k == "join":
        (r,) = op.args
        ops = [[PhysOp("join", tmp(0), _tab(op.target), _tab(r), (op.target,), j)]]
        return ops, ("tab", op.target, tmp(0))
    if k == "pair_filter":
        s, r2 = op.args
        stages = [
            [
                PhysOp("semijoin", tmp(0), _tab(s), _up(op.target), (s,), j),
                PhysOp("semijoin", tmp(1), _tab(s), _up(r2), (s,), j),
            ],
            [PhysOp("intersect", tmp(2), tmp(0), tmp(1), (s,), j)],
        ]
        return stages, ("acc", op.target, tmp(2))
    if k == "triple_filter":
        s, rb, rc = op.args
        stages = [
            [
                PhysOp("semijoin", tmp(0), _tab(s), _up(op.target), (s,), j),
                PhysOp("semijoin", tmp(1), _tab(s), _up(rb), (s,), j),
                PhysOp("semijoin", tmp(2), _tab(s), _up(rc), (s,), j),
            ],
            [PhysOp("intersect", tmp(3), tmp(0), tmp(1), (s,), j)],
            [PhysOp("intersect", tmp(4), tmp(3), tmp(2), (s,), j)],
        ]
        return stages, ("acc", op.target, tmp(4))
    if k == "pair_join":
        s, r2 = op.args
        nodes = (op.target, s, r2)
        stages = [
            [
                PhysOp("join", tmp(0), _tab(op.target), _tab(s), nodes, j),
                PhysOp("join", tmp(1), _tab(r2), _tab(s), nodes, j),
            ],
            [PhysOp("join", tmp(2), tmp(0), tmp(1), nodes, j)],
        ]
        return stages, ("tab", op.target, tmp(2))
    if k == "triple_join":
        s, rb, rc = op.args
        nodes = (op.target, s, rb, rc)
        stages = [
            [
                PhysOp("join", tmp(0), _tab(op.target), _tab(s), nodes, j),
                PhysOp("join", tmp(1), _tab(rb), _tab(s), nodes, j),
                PhysOp("join", tmp(2), _tab(rc), _tab(s), nodes, j),
            ],
            [PhysOp("join", tmp(3), tmp(0), tmp(1), nodes, j)],
            [PhysOp("join", tmp(4), tmp(3), tmp(2), nodes, j)],
        ]
        return stages, ("tab", op.target, tmp(4))
    raise ValueError(f"unknown op {op.kind}")


def lower_round(rnd: Round) -> Tuple[List[List[PhysOp]], List[Tuple[str, int, str]]]:
    """Zip-merge per-op stage lists: round stage i = all ops' stage i."""
    stages: List[List[PhysOp]] = []
    writes: List[Tuple[str, int, str]] = []
    for j, op in enumerate(rnd.ops):
        op_stages, write = lower_op(op, j)
        while len(stages) < len(op_stages):
            stages.append([])
        for i, st in enumerate(op_stages):
            stages[i].extend(st)
        writes.append(write)
    return stages, writes


# --------------------------------------------------------------------------
# prepared group work: the executor <-> dispatcher interface
# --------------------------------------------------------------------------
@dataclasses.dataclass
class GroupWork:
    """ONE prepared op group, ready to dispatch: operand tables resolved,
    managed capacities pre-floored, calibration attached.  ``mpad`` /
    ``mbytes``: wire cells (and bytes) the group's count pre-pass slices
    shipped, charged to the owning round."""

    kind: str
    ops: List[PhysOp]
    lhs: List[DTable]
    rhs: Optional[List[DTable]]
    seeds: List[int]
    cap: int
    xcaps: Optional[GroupMeasure]
    key: Optional[Tuple]  # caps-cache signature (None when not calibrating)
    engine: Engine
    mpad: int
    mbytes: int


@dataclasses.dataclass
class GroupResult:
    """What dispatching one ``GroupWork`` produced: per-instance outputs
    and stats, the claimed BSP rounds, and the SPMD dispatch deltas."""

    outs: List[DTable]
    stats: List[Dict]
    rounds: int
    dispatches: int
    measure_dispatches: int


def _engine_payload(eng: Engine, kind, lhs, rhs, cap, seeds, xcaps):
    if kind == "dedup":
        return eng.dedup_many(lhs, cap, seeds, xcaps)
    if kind == "semijoin":
        return eng.semijoin_many(lhs, rhs, cap, seeds, xcaps)
    if kind == "join":
        return eng.join_many(lhs, rhs, cap, seeds, xcaps)
    if kind == "intersect":
        return eng.intersect_many(lhs, rhs, cap, seeds, xcaps)
    raise ValueError(f"unknown physical op kind {kind}")


def dispatch_work(w: GroupWork) -> GroupResult:
    """Phase B for ONE group: the payload dispatch at the capacities its
    measure resolved."""
    spmd = w.engine.spmd
    d0, md0 = spmd.dispatch_count, spmd.measure_dispatch_count
    outs, stats, rounds = _engine_payload(
        w.engine, w.kind, w.lhs, w.rhs, w.cap, w.seeds, w.xcaps
    )
    return GroupResult(
        outs, stats, rounds,
        spmd.dispatch_count - d0, spmd.measure_dispatch_count - md0,
    )


# --------------------------------------------------------------------------
# executor
# --------------------------------------------------------------------------
class PhysicalExecutor:
    """Runs lowered rounds (and the materialization stage) with grouping,
    fused dispatch, and the centralized abort-retry loop.

    ``fuse=False`` forces singleton groups — results, stats, seeds and
    retries are bit-identical to the fused path.  ``calibrate=True`` runs
    the two-phase measure -> dispatch schedule (see the module doc)."""

    def __init__(
        self,
        spmd: SPMD,
        strategy: str,
        capman: CapacityManager,
        *,
        seed: int = 0,
        max_retries: int = 12,
        count_retries_comm: bool = True,
        fuse: bool = True,
        calibrate: bool = True,
        local_backend: str = "torch",
        skew_threshold: Optional[float] = None,
        caps_cache: "bool | CapsCache" = True,
        prefetch: bool = True,
        wire_policy: Optional[WirePolicy] = None,
    ):
        self.spmd = spmd
        self.engine = get_engine(
            strategy, spmd, local_backend, skew_threshold, wire_policy=wire_policy
        )
        self.local_backend = local_backend
        self.capman = capman
        self.seed = seed
        self.max_retries = max_retries
        self.count_retries_comm = count_retries_comm
        self.fuse = fuse
        # data-dependent engines (hybrid) cannot route without the count
        # pre-pass: force it on for them regardless of the config knob
        self.calibrate = calibrate or self.engine.requires_measure
        self._seed_ctr = 0
        if isinstance(caps_cache, CapsCache):
            self.caps_cache = caps_cache if self.calibrate else None
        else:
            self.caps_cache = CapsCache() if (caps_cache and self.calibrate) else None
        self.prefetch = bool(prefetch) and self.calibrate
        self._pending: Optional[Dict] = None

    @classmethod
    def from_plan(
        cls,
        spmd: SPMD,
        plan,  # optimizer.Plan
        capman: CapacityManager,
        *,
        local_backend: str,
        seed: int = 0,
        max_retries: int = 12,
        count_retries_comm: bool = True,
        calibrate: bool = True,
        skew_threshold: Optional[float] = None,
        caps_cache: "bool | CapsCache" = True,
        prefetch: bool = True,
        wire_policy: Optional[WirePolicy] = None,
    ) -> "PhysicalExecutor":
        """Build an executor straight from an advisor ``Plan``: engine
        strategy and round fusion come from the plan; the local backend is
        the plan's, else ``local_backend`` (the device's default — the
        plan never turns the card's kernels off)."""
        return cls(
            spmd,
            plan.engine,
            capman,
            seed=seed,
            max_retries=max_retries,
            count_retries_comm=count_retries_comm,
            fuse=plan.fused,
            calibrate=calibrate,
            local_backend=plan.local_backend or local_backend,
            skew_threshold=skew_threshold,
            caps_cache=caps_cache,
            prefetch=prefetch,
            wire_policy=wire_policy,
        )

    def _next_seed(self) -> int:
        self._seed_ctr += 1
        return self.seed + 7919 * self._seed_ctr

    # -- grouping ----------------------------------------------------------
    def _signature(self, op: PhysOp, resolve) -> Tuple:
        a = resolve(op.a)
        sig: Tuple = (op.kind, self.capman.cap_for(op.cap_nodes), a.cap, a.arity)
        if op.b is not None:
            b = resolve(op.b)
            n_shared = sum(1 for x in a.schema if x in set(b.schema))
            sig += (b.cap, b.arity, n_shared)
        return sig

    def _group(self, stage: List[PhysOp], resolve) -> List[List[PhysOp]]:
        groups: Dict[Tuple, List[PhysOp]] = {}
        for i, op in enumerate(stage):
            sig = self._signature(op, resolve)
            if not self.fuse:
                sig += (i,)  # singleton groups: one dispatch per op
            groups.setdefault(sig, []).append(op)
        return list(groups.values())

    def _measure_stage(self, groups, resolve, pending=None):
        """Phase A: resolve a ``GroupMeasure`` for every group of the stage
        with at most ONE fresh combined count dispatch (plus one fused
        keys-only join output count when needed).  Sources, cheapest
        first: ``CapsCache`` hit, the prefetched pending ``RoundCounts``
        (matched by signature AND seeds), one fresh ``RoundCounts``.
        Returns (measures, keys, orphan_padded, orphan_bytes)."""
        n = len(groups)
        if not self.calibrate:
            return [None] * n, [None] * n, 0, 0
        keys = [self._signature(g[0], resolve) for g in groups]
        measures: List[Optional[GroupMeasure]] = [None] * n
        orphan_pad = 0
        orphan_bytes = 0
        todo: List[int] = []
        for gi in range(n):
            m = self.caps_cache.lookup(keys[gi]) if self.caps_cache is not None else None
            if m is not None:
                measures[gi] = m
            else:
                todo.append(gi)
        fresh: List[int] = []  # measured THIS call (cache hits excluded)
        if pending is not None:
            index, counts = pending["index"], pending["counts"]
            matched = {}
            for gi in todo:
                skey = (keys[gi], tuple(op.seed for op in groups[gi]))
                if skey in index:
                    matched[gi] = index[skey]
            if matched:
                pm = counts.measures()
                used = set(matched.values())
                for gi, si in matched.items():
                    measures[gi] = pm[si]
                    fresh.append(gi)
                todo = [gi for gi in todo if gi not in matched]
                orphan_pad += sum(
                    s.count_padded for si, s in enumerate(counts.specs) if si not in used
                )
                orphan_bytes += sum(
                    s.count_bytes for si, s in enumerate(counts.specs) if si not in used
                )
            else:
                # nothing matched (schedule drifted since the prefetch):
                # charge the whole in-flight dispatch, never read it back
                orphan_pad += counts.count_padded
                orphan_bytes += counts.count_bytes

        def operands(gi):
            g = groups[gi]
            kind = g[0].kind
            lhs = [resolve(op.a) for op in g]
            rhs = None if kind == "dedup" else [resolve(op.b) for op in g]
            return kind, lhs, rhs, [op.seed for op in g]

        legacy: List[int] = []
        spec_gis: List[int] = []
        specs: List["B.MeasureSpec"] = []
        for gi in todo:
            kind, lhs, rhs, seeds = operands(gi)
            spec = self.engine.measure_spec(kind, lhs, rhs, seeds)
            if spec is None:
                legacy.append(gi)
            else:
                spec_gis.append(gi)
                specs.append(spec)
        if specs:
            counts = B.RoundCounts(self.spmd, specs, backend=self.local_backend)
            for gi, m in zip(spec_gis, counts.measures()):
                measures[gi] = m
                fresh.append(gi)
        for gi in legacy:
            kind, lhs, rhs, seeds = operands(gi)
            measures[gi] = self.engine.measure_group(kind, lhs, rhs, seeds)
        fresh.sort()
        for gi in fresh:
            kind, lhs, rhs, seeds = operands(gi)
            measures[gi] = self.engine.measure_finish(kind, lhs, rhs, seeds, measures[gi])
        # exact keys-only output pre-count for the fresh join groups the
        # combined pass could NOT resolve: hybrid re-routed groups (the
        # light-placement count is void) and groups whose hashed-key guess
        # proved too small
        join_gis = [
            gi for gi in fresh
            if groups[gi][0].kind == "join"
            and self.engine.measure_needs_join_count("join")
            and measures[gi].out_need is None
        ]
        if join_gis:
            items = []
            for gi in join_gis:
                _, lhs, rhs, seeds = operands(gi)
                items.append((lhs, rhs, seeds, measures[gi]))
            fmts = [
                self.engine._fmt_for([
                    tuple(x for x in a.schema if x in set(b.schema))
                    for a, b in zip(lhs, rhs)
                ]) if self.engine.wire_policy is not None else None
                for lhs, rhs, _, _ in items
            ]
            needs = B.join_need_many(
                self.spmd, items, fmts=fmts, backend=self.local_backend
            )
            for gi, m in zip(join_gis, needs):
                measures[gi] = m
        if self.caps_cache is not None:
            for gi in fresh + legacy:
                if measures[gi] is not None:
                    self.caps_cache.store(keys[gi], measures[gi])
        for m in measures:
            if m is not None and m.n_heavy:
                self.capman.heavy_hint = max(self.capman.heavy_hint, m.n_heavy)
        return measures, keys, orphan_pad, orphan_bytes

    def prepare_group(self, ops_g: List[PhysOp], resolve, xcaps, key) -> GroupWork:
        """Bind one measured group to a dispatchable ``GroupWork``,
        pre-flooring managed capacities the measurement proves too small."""
        seeds = [op.seed for op in ops_g]
        lhs = [resolve(op.a) for op in ops_g]
        kind = ops_g[0].kind
        rhs = None if kind == "dedup" else [resolve(op.b) for op in ops_g]
        if xcaps is not None:
            need = max(xcaps.out_recv or 0, xcaps.out_need or 0)
            if need:
                for op in ops_g:
                    self.capman.floor(op.cap_nodes, need)
        cap = self.capman.cap_for(ops_g[0].cap_nodes)
        return GroupWork(
            kind=kind, ops=list(ops_g), lhs=lhs, rhs=rhs, seeds=seeds,
            cap=cap, xcaps=xcaps, key=key, engine=self.engine,
            mpad=xcaps.padded if xcaps is not None else 0,
            mbytes=xcaps.wire_bytes if xcaps is not None else 0,
        )

    # -- one schedule round ------------------------------------------------
    def execute_round(self, rnd: Round, tables, acc, ledger: Ledger):
        """Run one logical round (with abort-retry) to completion, every
        yielded group dispatched solo, immediately.  Returns
        (new_tables, new_acc, comm, padded, heavy, claimed_rounds,
        dispatches, measure_dispatches, payload_bytes, useful_bytes)."""
        gen = self.round_steps(rnd, tables, acc, ledger)
        try:
            works = next(gen)
            while True:
                works = gen.send([dispatch_work(w) for w in works])
        except StopIteration as stop:
            return stop.value

    def round_steps(self, rnd: Round, tables, acc, ledger: Ledger):
        """Reentrant round execution: a generator that YIELDS each stage's
        prepared ``GroupWork`` list and RECEIVES the matching
        ``GroupResult`` list via ``send``.  Seeds, retry decisions,
        capacity growth and caps-cache fills all stay inside."""
        stages, writes = lower_round(rnd)
        # slot liveness: tmp slots die after their last reading stage
        last_use: Dict[str, int] = {}
        for i, stage in enumerate(stages):
            for op in stage:
                for nm in (op.a, op.b):
                    if nm is not None and nm.startswith("tmp:"):
                        last_use[nm] = i
        keep = {slot for _, _, slot in writes}
        pending = self._pending
        self._pending = None
        disp_total = pending["dispatches"] if pending is not None else 0
        meas_total = pending["measure_dispatches"] if pending is not None else 0
        attempt = 0
        comm_total = padded_total = heavy_total = bytes_total = ubytes_total = 0
        while True:
            attempt += 1
            assert attempt <= self.max_retries, f"round {rnd.phase}: too many retries"
            self.capman.heavy_hint = 0
            slots: Dict[str, DTable] = {}

            def resolve(name: str) -> DTable:
                if name.startswith("tab:"):
                    return tables[int(name[4:])]
                if name.startswith("up:"):
                    v = int(name[3:])
                    return acc.get(v, tables[v])
                return slots[name]

            comm = padded = heavy = wireb = ub = claimed = 0
            dropped_by_logical: Dict[int, int] = {}
            blown_joins: List[Tuple[PhysOp, DTable, DTable]] = []
            fills: Dict[Tuple, List] = {}
            for i, stage in enumerate(stages):
                # seeds advance per attempt in lowering order, independent
                # of grouping — fused and sequential execution stay identical
                for op in stage:
                    op.seed = self._next_seed()
                stage_claimed = 0
                groups = self._group(stage, resolve)
                use_pending = pending if (i == 0 and attempt == 1) else None
                d0 = self.spmd.dispatch_count
                md0 = self.spmd.measure_dispatch_count
                measures, keys, orphan_pad, orphan_b = self._measure_stage(
                    groups, resolve, use_pending
                )
                disp_total += self.spmd.dispatch_count - d0
                meas_total += self.spmd.measure_dispatch_count - md0
                padded += orphan_pad
                wireb += orphan_b
                works = [
                    self.prepare_group(ops_g, resolve, xcaps, key)
                    for ops_g, xcaps, key in zip(groups, measures, keys)
                ]
                results = yield works
                assert results is not None and len(results) == len(works), (
                    "round_steps: send() one GroupResult per yielded GroupWork"
                )
                for w, res in zip(works, results):
                    padded += w.mpad
                    wireb += w.mbytes
                    disp_total += res.dispatches
                    meas_total += res.measure_dispatches
                    stage_claimed = max(stage_claimed, res.rounds)
                    g_sent, g_drop = 0, False
                    for oi, (op, out, st) in enumerate(zip(w.ops, res.outs, res.stats)):
                        slots[op.out] = out
                        comm += st["sent"]
                        padded += st.get("padded", 0)
                        heavy += st.get("heavy", 0)
                        wireb += st.get("wire_bytes", 0)
                        ub += st.get("ubytes", 0)
                        g_sent = max(g_sent, st["sent"])
                        if st["dropped"]:
                            g_drop = True
                            dropped_by_logical[op.logical] = (
                                dropped_by_logical.get(op.logical, 0) + st["dropped"]
                            )
                            if op.kind == "join" and self.engine.exact_join_presize:
                                blown_joins.append((op, w.lhs[oi], w.rhs[oi]))
                    if self.caps_cache is not None and w.key is not None:
                        f = fills.setdefault(w.key, [0, False])
                        f[0] = max(f[0], g_sent)
                        f[1] = f[1] or g_drop
                claimed += stage_claimed
                for nm, li in last_use.items():
                    if li == i and nm not in keep:
                        slots.pop(nm, None)
            if self.count_retries_comm or not dropped_by_logical:
                comm_total += comm
                padded_total += padded
                heavy_total += heavy
                bytes_total += wireb
                ubytes_total += ub
            if not dropped_by_logical:
                if self.caps_cache is not None:
                    for key, (s, dr) in fills.items():
                        self.caps_cache.observe(key, s, dr)
                break
            ledger.retries += 1
            if self.caps_cache is not None:
                # a failed attempt invalidates EVERY signature it touched
                for key in fills:
                    self.caps_cache.invalidate(key)
            for j, d in dropped_by_logical.items():
                lop = rnd.ops[j]
                self.capman.grow((lop.target, *lop.args), d)
            d0 = self.spmd.dispatch_count
            md0 = self.spmd.measure_dispatch_count
            for op, a, b in blown_joins:
                lop = rnd.ops[op.logical]
                self.capman.floor(
                    (lop.target, *lop.args), self.capman.presize_join(a, b, op.seed)
                )
            disp_total += self.spmd.dispatch_count - d0
            meas_total += self.spmd.measure_dispatch_count - md0
        new_tab: Dict[int, DTable] = {}
        new_acc: Dict[int, DTable] = {}
        for store, node, slot in writes:
            (new_tab if store == "tab" else new_acc)[node] = slots[slot]
        return (
            new_tab, new_acc, comm_total, padded_total, heavy_total,
            max(1, claimed), disp_total, meas_total, bytes_total, ubytes_total,
        )

    # -- measure prefetch (overlap) ----------------------------------------
    def prefetch_round(self, rnd: Optional[Round], tables, acc) -> None:
        """Queue the NEXT round's stage-0 combined count pre-pass behind
        THIS round's payload work.  Seeds are PEEKED (the counter is not
        advanced), reproducing what the next ``execute_round``'s first
        attempt assigns; unconsumed slices are charged and discarded."""
        self._pending = None
        if rnd is None or not self.prefetch:
            return
        stages, _ = lower_round(rnd)
        if not stages:
            return
        stage0 = stages[0]
        if any(
            nm is not None and nm.startswith("tmp:")
            for op in stage0 for nm in (op.a, op.b)
        ):
            return

        def resolve(name: str) -> DTable:
            if name.startswith("tab:"):
                return tables[int(name[4:])]
            v = int(name[3:])
            return acc.get(v, tables[v])

        for i, op in enumerate(stage0):
            op.seed = self.seed + 7919 * (self._seed_ctr + i + 1)
        d0 = self.spmd.dispatch_count
        md0 = self.spmd.measure_dispatch_count
        index: Dict[Tuple, int] = {}
        specs: List["B.MeasureSpec"] = []
        for g in self._group(stage0, resolve):
            key = self._signature(g[0], resolve)
            if self.caps_cache is not None and key in self.caps_cache:
                continue  # the next round will hit the cache for free
            kind = g[0].kind
            lhs = [resolve(op.a) for op in g]
            rhs = None if kind == "dedup" else [resolve(op.b) for op in g]
            spec = self.engine.measure_spec(kind, lhs, rhs, [op.seed for op in g])
            if spec is None:
                continue
            index[(key, tuple(op.seed for op in g))] = len(specs)
            specs.append(spec)
        if not specs:
            return
        counts = B.RoundCounts(self.spmd, specs, backend=self.local_backend)
        self._pending = {
            "counts": counts,
            "index": index,
            "dispatches": self.spmd.dispatch_count - d0,
            "measure_dispatches": self.spmd.measure_dispatch_count - md0,
        }

    # -- materialization (Theorem 15 stage 1) ------------------------------
    def materialize(self, ghd: GHD, base: Dict[str, DTable], node_schema, ledger: Ledger):
        """Compute IDB_v per tree vertex (one grid round, or a hash join for
        a 2-atom bag under the hash engine), with the centralized retry
        loop.  Returns (tables, comm, padded, heavy,
        claimed_rounds, dispatches, measure_dispatches, payload_bytes,
        useful_bytes)."""
        d0 = self.spmd.dispatch_count
        md0 = self.spmd.measure_dispatch_count
        comm = padded = heavy = wireb = ubytes = 0
        dropped_any = True
        attempt = 0
        max_engine_rounds = 0
        tables: Dict[int, DTable] = {}
        while dropped_any:
            attempt += 1
            assert attempt <= self.max_retries, "materialization: too many retries"
            self.capman.heavy_hint = 0
            dropped_any = False
            comm_try = padded_try = heavy_try = bytes_try = ubytes_try = 0
            tables = {}
            max_engine_rounds = 0
            verts = list(ghd.nodes())
            parts_by_v: Dict[int, List[DTable]] = {}
            dedup_by_v: Dict[int, bool] = {}
            for v in verts:
                parts: List[DTable] = []
                need_dedup = False
                for alias in sorted(ghd.lam[v]):
                    t = base[alias]
                    keep = [a for a in t.schema if a in ghd.chi[v]]
                    proj, _ = R.dist_project(self.spmd, t, keep, dedup=True)
                    if len(keep) < len(t.schema):
                        need_dedup = True  # strict projection: cross-shard dups
                    parts.append(proj)
                parts_by_v[v] = parts
                dedup_by_v[v] = need_dedup
            mj_seeds = [self._next_seed() for _ in verts]
            cal_map = (
                self.engine.multijoin_measure_batch(
                    [parts_by_v[v] for v in verts], mj_seeds
                )
                if self.calibrate
                else {}
            )
            for vi, v in enumerate(verts):
                parts = parts_by_v[v]
                need_dedup = dedup_by_v[v]
                vcal = cal_map.get(vi)
                cap = self.capman.cap_for((v,))
                out, st, er = self.engine.multijoin(
                    parts, cap, mj_seeds[vi], calibrate=self.calibrate,
                    cal=None if vcal is None else vcal[0],
                )
                sent, drop = st["sent"], st["dropped"]
                pad = st.get("padded", 0)
                wb = st.get("wire_bytes", 0)
                ubytes_try += st.get("ubytes", 0)
                if vcal is not None:
                    pad += vcal[1]
                    wb += vcal[2]
                heavy_try += st.get("heavy", 0)
                if need_dedup:
                    seeds = [self._next_seed()]
                    dkey = ("mat_dedup", out.cap, out.arity, cap)
                    dx = None
                    if self.calibrate:
                        if self.caps_cache is not None:
                            dx = self.caps_cache.lookup(dkey)
                        if dx is None:
                            dx = self.engine.measure_group("dedup", [out], None, seeds)
                            if self.caps_cache is not None and dx is not None:
                                self.caps_cache.store(dkey, dx)
                    if dx is not None:
                        pad += dx.padded
                        wb += dx.wire_bytes
                        if dx.out_recv and dx.out_recv > cap:
                            self.capman.ensure(v, dx.out_recv)
                            cap = self.capman.cap_for((v,))
                    outs, dstats, r2 = self.engine.dedup_many([out], cap, seeds, dx)
                    out = outs[0]
                    sent += dstats[0]["sent"]
                    drop += dstats[0]["dropped"]
                    pad += dstats[0].get("padded", 0)
                    wb += dstats[0].get("wire_bytes", 0)
                    ubytes_try += dstats[0].get("ubytes", 0)
                    er += r2
                    if self.caps_cache is not None:
                        self.caps_cache.observe(
                            dkey, dstats[0]["sent"], bool(dstats[0]["dropped"])
                        )
                if drop:
                    dropped_any = True
                    self.capman.grow_node(v)
                comm_try += sent
                padded_try += pad
                bytes_try += wb
                # canonicalize column order to node schema
                tables[v], _ = R.dist_project(self.spmd, out, node_schema[v])
                max_engine_rounds = max(max_engine_rounds, er)
            if self.count_retries_comm or not dropped_any:
                comm += comm_try
                padded += padded_try
                heavy += heavy_try
                wireb += bytes_try
                ubytes += ubytes_try
            if dropped_any:
                ledger.retries += 1
        for v in tables:
            self.capman.ensure(v, tables[v].cap)
        return (
            tables, comm, padded, heavy, max(1, max_engine_rounds),
            self.spmd.dispatch_count - d0,
            self.spmd.measure_dispatch_count - md0,
            wireb, ubytes,
        )
