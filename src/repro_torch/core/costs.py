"""Analytic cost formulas from the paper, plus the calibrated per-plan
cost model behind the advisor in ``core/optimizer.py``.

Two layers live here:

1. **Closed-form worst-case formulas** (Tables 2 & 3, Lemmas 8-11,
   Theorems 12/14/15/23) — used by the benchmarks to place measured
   ledger numbers next to the paper's predictions.
2. **Per-schedule cost entries** (``predict_plan_cost``) — walk an
   actual planner schedule op-by-op under per-engine communication
   formulas and the matching-database size assumption (Appendix A), so
   candidate plans with the *same* asymptotics still get distinguishable
   scores.  Constants are calibrated from measured ``Ledger`` numbers
   via ``fit_calibration`` (records exported by
   ``Ledger.calibration_record``).

Every formula cites its paper source inline; ``benchmarks/report.py``
renders the column -> formula provenance table from the same citations.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

from ..relational.skew import DEFAULT_SKEW_THRESHOLD
from .ghd import GHD
from .hypergraph import Query


def B(X: float, M: float) -> float:
    """The paper's B(X, M) = X^2 / M (Assumption 4, Sec. 3.3): the
    communication of sorting/hashing X tuples across machines with
    memory M each."""
    return X * X / M


def lemma8_join_comm(sizes, M: float, out: float) -> float:
    """Lemma 8 (Sec. 3.3): one-round grid join of w relations costs
    O((sum |R_i|)^w / M^(w-1) + OUT) communication."""
    s = float(sum(sizes))
    w = len(sizes)
    return s**w / M ** (w - 1) + out


def lemma10_semijoin_comm(r: float, s: float, M: float) -> float:
    """Lemma 10 (Sec. 3.3): skew-proof grid semijoin S |>< R in O(1)
    rounds and O(B(|R| + |S|, M)) communication."""
    return B(r + s, M)


def gym_comm(n: int, IN: float, OUT: float, M: float, w: int) -> float:
    """Theorem 15 (Sec. 5): GYM on a width-w GHD communicates
    O(n * B(IN^w + OUT, M))."""
    return n * B(IN**w + OUT, M)


def gym_rounds(d: int, n: int) -> float:
    """Theorem 15 (Sec. 5, via Theorem 14's DYM-d): O(d + log n) rounds
    on a depth-d GHD of n vertices."""
    return d + math.log2(max(2, n))


def gym_loggta_comm(
    n: int, IN: float, OUT: float, M: float, w: int, iw: int
) -> float:
    """Theorem 23 (Sec. 6): GYM on the Log-GTA transform runs in
    O(log n) rounds with O(n * B(IN^max(w,3iw) + OUT, M)) communication."""
    return n * B(IN ** max(w, 3 * iw) + OUT, M)


def acqmr_comm(n: int, IN: float, OUT: float, M: float, w: int) -> float:
    """Sec. 2.2 (ACQ-MR baseline, realized via Log-GTA', Appendix D.2 /
    Theorem 30): O(n * B(IN^{3w} + OUT, M))."""
    return n * B(IN ** (3 * w) + OUT, M)


def shares_comm_star(n: int, IN: float, M: float, OUT: float) -> float:
    """Table 2 (S_n via one-round Shares, Sec. 2.3):
    O(IN^{n/2} / M^{n/2} + OUT) worst case."""
    half = n / 2.0
    return IN**half / M**half + OUT


def shares_comm_tc(n: int, IN: float, M: float, OUT: float) -> float:
    """Table 3 (TC_n via one-round Shares, Sec. 2.3):
    O(IN^{n/6} / M^{n/6} + OUT) worst case."""
    sixth = n / 6.0
    return IN**sixth / M**sixth + OUT


def one_round_chain_lower_bound(n: int, IN: float, M: float) -> float:
    """Sec. 1: any 1-round algorithm for C_n needs >= (IN/M)^{n/4} comm."""
    return (IN / M) ** (n / 4.0)


def predicted_table(
    query: Query, ghd: GHD, IN: float, OUT: float, M: float
) -> Dict[str, float]:
    """Paper worst-case predictions for one (query, GHD) pair: GYM
    (Theorem 15), GYM(Log-GTA) (Theorem 23), and ACQ-MR (Sec. 2.2),
    keyed by the GHD statistics of Sec. 3.1 (width / intersection width /
    depth)."""
    w = ghd.width
    iw = ghd.intersection_width(query)
    n = query.n
    d = ghd.depth
    return {
        "width": w,
        "iw": iw,
        "depth": d,
        "gym_rounds": gym_rounds(d, n),
        "gym_comm": gym_comm(n, IN, OUT, M, w),
        "gym_loggta_rounds": gym_rounds(int(math.log2(max(2, 4 * n))) + 1, n),
        "gym_loggta_comm": gym_loggta_comm(n, IN, OUT, M, w, iw),
        "acqmr_comm": acqmr_comm(n, IN, OUT, M, w),
    }


# ==========================================================================
# Per-schedule cost entries (the advisor's model, Sec. 4.2/4.3 schedules
# priced per engine) + calibration from measured ledgers
# ==========================================================================

#: Physical-stage decomposition of each logical planner op (mirrors
#: ``core.physical.lower_op``): per stage, the physical op kind and how
#: many instances of it the lowering emits.  The advisor charges one BSP
#: round per stage, exactly as the executor's lowering does, and uses
#: the instance counts to estimate sequential dispatches.
OP_STAGES: Dict[str, Sequence] = {
    "semijoin": (("semijoin", 1),),
    "down_semijoin": (("semijoin", 1),),
    "join": (("join", 1),),
    "pair_filter": (("semijoin", 2), ("intersect", 1)),
    "triple_filter": (("semijoin", 3), ("intersect", 1), ("intersect", 1)),
    "pair_join": (("join", 2), ("join", 1)),
    "triple_join": (("join", 3), ("join", 1), ("join", 1)),
}


def join_size_estimate(a: float, b: float, shared: bool = True) -> float:
    """Matching-database join-size estimate (Appendix A): on (near-)
    partial-permutation inputs every pairwise join output stays O(max of
    the inputs).  This is the regime the paper measures in, and the
    advisor's calibration absorbs the constant.

    ``shared=False`` means the operands have NO common attribute — the
    join is a cartesian product (|a| * |b|), which is how C-GTA's
    pair-merged leaf bags can blow up a careless plan; pricing it
    honestly is what steers the advisor away from those GHDs."""
    if not shared:
        return a * b
    return max(a, b)


def shuffle_pad_factor(p: int, calibrated: bool, wire_gain: float = 1.0) -> float:
    """Predicted inflation of wire slots over useful tuples for one hash
    exchange on a p-shard SPMD.

    The physical shuffle ships the dense ``(p, c_out)`` bucket buffer per
    shard (``relational.shuffle``).  With a FIXED global capacity, c_out
    is the worst-case shard cap, so the fleet ships ~p x the useful
    volume (each shard pays all p buckets at full depth).  With the
    count-calibrated pre-pass c_out hugs the true max bucket, leaving
    only the pow2 rounding loss (< 2x) plus per-bucket remainders.  The
    paper prices *useful* tuples (Sec. 3.2); this factor converts that to
    what the wire actually carries, so the advisor can rank by shipped
    slots (``predict_plan_cost(..., calibrate_shuffle=...)``).

    ``wire_gain`` (>= 1) reprices the PACKED wire format: the mean
    dense-bits/packed-bits row compression of the query's exchange
    formats (``relational.wire.wire_gain``).  The packed codec shrinks
    every shipped slot — occupied or padding — by that ratio, so the
    pad factor divides through; 1.0 (dense) recovers the slot prices
    above."""
    base = 2.0 if calibrated else 2.0 * float(max(1, p))
    return base / max(1.0, float(wire_gain))


# Wire-slot-equivalent price of ONE extra program dispatch (launch latency
# + compile-cache probe + the host sync a measure implies), used by
# ``predict_plan_cost`` to reprice calibration: the count pre-pass buys a
# ~p-fold pad reduction but costs measure dispatches, and on small inputs
# the dispatches dominate.  Fit loosely to the shuffle benchmarks (an
# extra dispatch costs on the order of a few-thousand-slot exchange).
DEFAULT_DISPATCH_OVERHEAD_SLOTS = 2048.0


def grid_replication(p: int, w: int = 2) -> float:
    """Per-tuple replication of a w-way grid op on p reducers: each
    relation is sent to p^((w-1)/w) grid cells (Lemma 8's g_i sizing).
    This is the engine-accurate instantiation of B(X, M) for a FIXED
    p-shard SPMD: with the grid sized to memory M the two coincide
    (sqrt(p) * X = X^2/M exactly when sqrt(p) = X/M, Sec. 3.3)."""
    return float(max(1, p)) ** ((w - 1) / w)


def skew_amplification(
    p: int, share: float, threshold: Optional[float] = None
) -> float:
    """Max-over-mean per-destination load of a hash exchange when one key
    carries ``share`` of the rows: the hot reducer holds ~``share`` of
    the relation against the 1/p balanced mean, so the BSP round is paced
    (and the calibrated send bucket sized) by ``p * share``, not by the
    mean.

    Gated on the SAME threshold the engine's heavy-hitter detection uses
    (``threshold``, defaulting to the engine default
    ``relational.skew.DEFAULT_SKEW_THRESHOLD``): a max/mean ratio the
    pow2-calibrated shuffle absorbs without flagging anything heavy is
    not an amplification — 1.0 there, the full ``p * share`` beyond."""
    t = DEFAULT_SKEW_THRESHOLD if threshold is None else float(threshold)
    amp = float(max(1, p)) * float(share)
    return amp if amp > t else 1.0


def _heavy_share(p: int, share: float, threshold: Optional[float] = None) -> float:
    """The share that actually routes heavy under the detection
    threshold: 0 below it (hybrid == hash there), ``share`` beyond."""
    t = DEFAULT_SKEW_THRESHOLD if threshold is None else float(threshold)
    return float(share) if float(max(1, p)) * float(share) > t else 0.0


def engine_op_comm(
    engine: str,
    kind: str,
    left: float,
    right: float,
    p: int,
    skew_l: float = 0.0,
    skew_r: float = 0.0,
    skew_threshold: Optional[float] = None,
) -> float:
    """Predicted shuffle communication of ONE physical op under an engine
    on a p-shard SPMD.

    - ``'grid'`` (paper-faithful): semijoins by Lemma 10 (grid round +
      mark dedup), pairwise joins by Lemma 8 with w=2 — skew-proof, at
      the cost of ~sqrt(p) per-tuple replication (``grid_replication``).
    - ``'hash'`` (beyond-paper co-partitioning): every op shuffles its
      inputs once — but priced by the MAX per-destination load, not the
      mean: a heavy key amplifies the effective cost by ``p * share``
      (``skew_amplification``; ``skew_l``/``skew_r`` are each side's max
      single-key share, 0 when unknown, reducing to left + right).
    - ``'hybrid'`` (heavy/light decomposition, ``relational.skew``):
      light keys price as hash at balanced load; heavy left rows spread
      positionally (still 1x); heavy right rows broadcast p-ways — so
      skew costs ``p * skew_r * right`` extra replication instead of
      amplifying the whole exchange.
    - ``intersect`` / ``dedup`` are hash-implemented under every engine
      (see ``core.physical.Engine``) and key on full distinct rows, so
      no single heavy column value can skew them — they price as plain
      hash ops, unamplified, under every engine.  A semijoin's RIGHT
      side likewise ships its deduplicated key projection (one row per
      key), so only its left side can amplify.

    ``skew_threshold`` is the execution's ``GymConfig.skew_threshold``,
    so the model's amplification gate matches the engine that will run.
    """
    if engine == "grid":
        rep = grid_replication(p, 2)
        if kind == "semijoin":
            # Lemma 10: grid round replicates both sides; round 2 dedups
            # the marked left side with a hash pass
            return rep * (left + right) + left
        if kind == "join":
            return rep * (left + right)
        return left + right
    if kind not in ("semijoin", "join"):
        return left + right
    if kind == "semijoin":
        skew_r = 0.0  # R ships one row per key after dedup
    if engine == "hybrid":
        heavy = _heavy_share(p, skew_r, skew_threshold)
        return left + right + float(max(1, p)) * heavy * right
    return left * skew_amplification(p, skew_l, skew_threshold) + (
        right * skew_amplification(p, skew_r, skew_threshold)
    )


def materialization_comm(
    engine: str,
    parts: Sequence[float],
    part_attrs: Sequence,  # attribute sets aligned with ``parts``
    p: int,
):
    """Stage-1 (Theorem 15) cost of computing one IDB_v = |><| lam(v).
    Returns ``(comm, size_estimate_of_IDB_v)``.

    Single-atom bags materialize by projection only (no shuffle).  Grid
    materializes in one Lemma 8 round over all w parts (w-way grid
    replication); hash runs a left-deep cascade in sorted-alias order
    (matching ``PhysicalExecutor.materialize``), shuffling each pairwise
    join's inputs — except attribute-disjoint steps, which the hash
    engine executes as a broadcast cross join (right side replicated
    p ways, left stays put).  The size cascade and the comm cascade walk
    the same (part, attrs) sequence so the two can never drift apart."""
    cur = float(parts[0])
    if len(parts) <= 1:
        return 0.0, cur
    total = 0.0
    seen = set(part_attrs[0])
    for nxt, nat in zip(parts[1:], part_attrs[1:]):
        shared = bool(seen & set(nat))
        if engine != "grid":
            total += cur + nxt if shared else p * nxt  # else: broadcast
        cur = join_size_estimate(cur, nxt, shared=shared)
        seen |= set(nat)
    if engine == "grid":
        total = grid_replication(p, len(parts)) * float(sum(parts)) + cur
    return total, cur


def predict_plan_cost(
    query: Query,
    ghd: GHD,
    rounds,  # List[planner.Round]
    engine: str,
    alias_sizes: Mapping[str, float],
    p: int,
    calibration: Optional["CostCalibration"] = None,
    calibrate_shuffle: bool = True,
    alias_skew: Optional[Mapping[str, float]] = None,
    skew_threshold: Optional[float] = None,
    dispatch_overhead: float = 0.0,
    dispatches: float = 0.0,
    measure_dispatches: float = 0.0,
    wire_gain: float = 1.0,
) -> Dict[str, float]:
    """Walk one planner schedule op-by-op and price it under ``engine``
    on a p-shard SPMD.

    Returns ``{"comm", "rounds", "ops", "out_est", "wire"}`` where

    - ``comm`` = materialization (Theorem 15 stage 1) + per-op shuffle
      (Lemma 8/10 grid replication for grid, inputs-sized for hash) +
      the estimated output (the paper counts reducer output as
      communication, Sec. 3.2), scaled by the calibration's per-engine
      constant when given;
    - ``rounds`` = claimed BSP rounds: 1 for materialization plus, per
      logical round, the max over its ops of the stage count (grid
      semijoin stages claim 2 rounds each, per Lemma 10);
    - ``wire`` = predicted SLOTS shipped: the shuffled volume inflated by
      ``shuffle_pad_factor`` (fixed capacities pad ~p x; the
      count-calibrated pre-pass pads < 2x) plus the un-padded output,
      plus — when ``dispatch_overhead`` > 0 — a slot-equivalent charge of
      ``dispatch_overhead * (dispatches + measure_dispatches)`` pricing
      program-launch latency.  This is how calibrated-vs-fixed becomes a
      per-query decision: calibration shrinks the pad factor but adds
      measure dispatches, and tiny inputs can lose the trade.  This is
      what the advisor ranks by — the wire carries slots, not the
      paper's useful tuples.  ``wire_gain`` > 1 (the packed wire
      format's mean row compression) deflates the pad factor, so a
      packed execution reprices calibrated-vs-fixed honestly.

    Node sizes evolve under the matching-database assumption
    (``join_size_estimate``); semijoins never grow a table, so sizes are
    upper bounds there.  ``alias_skew`` (max single-key share per base
    relation, e.g. ``optimizer.skew_share``) propagates through the node
    walk as the max over contributing relations, pricing the hash engine
    by its hot reducer and the hybrid engine by its broadcast overhead.
    """
    skew_in = alias_skew or {}

    def op_comm(kind: str, l: float, r: float, sl: float, sr: float) -> float:
        return engine_op_comm(
            engine, kind, l, r, p, sl, sr, skew_threshold=skew_threshold
        )

    # --- stage 1: per-node IDB materialization (Theorem 15) -------------
    est: Dict[int, float] = {}
    skw: Dict[int, float] = {}
    comm = 0.0
    for v in ghd.nodes():
        aliases = sorted(ghd.lam[v])
        parts = [float(alias_sizes[a]) for a in aliases]
        part_attrs = [query.edges[a] for a in aliases]
        mat_comm, out_v = materialization_comm(engine, parts, part_attrs, p)
        comm += mat_comm
        # strict projection (chi(v) drops columns of some atom) forces a
        # cross-shard dedup pass: one more shuffle of the node table
        if any(query.edges[a] - ghd.chi[v] for a in aliases):
            comm += out_v
        est[v] = out_v
        skw[v] = max((float(skew_in.get(a, 0.0)) for a in aliases), default=0.0)

    # --- stage 2: the DYM schedule op walk (Sec. 4.2 / 4.3) -------------
    claimed = 1  # materialization
    n_ops = 0
    for rnd in rounds:
        round_claim = 1
        for op in rnd.ops:
            n_ops += 1
            k, t = op.kind, op.target
            round_claim = max(
                round_claim,
                sum(
                    2 if engine == "grid" and sk == "semijoin" else 1
                    for sk, _ in OP_STAGES[k]
                ),
            )
            if k in ("semijoin", "down_semijoin"):
                r = op.args[0]
                comm += op_comm("semijoin", est[t], est[r], skw[t], skw[r])
            elif k == "join":
                r = op.args[0]
                comm += op_comm("join", est[t], est[r], skw[t], skw[r])
                est[t] = join_size_estimate(est[t], est[r])
                skw[t] = max(skw[t], skw[r])
            elif k == "pair_filter":
                s, r2 = op.args
                comm += op_comm("semijoin", est[s], est[t], skw[s], skw[t])
                comm += op_comm("semijoin", est[s], est[r2], skw[s], skw[r2])
                comm += op_comm("intersect", est[s], est[s], skw[s], skw[s])
            elif k == "triple_filter":
                s, rb, rc = op.args
                for other in (t, rb, rc):
                    comm += op_comm(
                        "semijoin", est[s], est[other], skw[s], skw[other]
                    )
                comm += 2 * op_comm("intersect", est[s], est[s], skw[s], skw[s])
            elif k == "pair_join":
                s, r2 = op.args
                comm += op_comm("join", est[t], est[s], skw[t], skw[s])
                comm += op_comm("join", est[r2], est[s], skw[r2], skw[s])
                j1 = join_size_estimate(est[t], est[s])
                j2 = join_size_estimate(est[r2], est[s])
                sk12 = max(skw[t], skw[s], skw[r2])
                comm += op_comm("join", j1, j2, sk12, sk12)
                est[t] = join_size_estimate(j1, j2)
                skw[t] = sk12
            elif k == "triple_join":
                s, rb, rc = op.args
                j1 = join_size_estimate(est[t], est[s])
                j2 = join_size_estimate(est[rb], est[s])
                j3 = join_size_estimate(est[rc], est[s])
                comm += op_comm("join", est[t], est[s], skw[t], skw[s])
                comm += op_comm("join", est[rb], est[s], skw[rb], skw[s])
                comm += op_comm("join", est[rc], est[s], skw[rc], skw[s])
                skj = max(skw[t], skw[s], skw[rb], skw[rc])
                comm += op_comm("join", j1, j2, skj, skj)
                j12 = join_size_estimate(j1, j2)
                comm += op_comm("join", j12, j3, skj, skj)
                est[t] = join_size_estimate(j12, j3)
                skw[t] = skj
            else:  # pragma: no cover - planner emits only the kinds above
                raise ValueError(f"unknown logical op kind {k!r}")
        claimed += round_claim

    out_est = est[ghd.root]
    shuffled = comm  # everything priced so far moved through an exchange
    comm += out_est  # Sec. 3.2: output tuples count as communication
    if calibration is not None:
        comm = calibration.apply(engine, comm)
        shuffled = calibration.apply(engine, shuffled)
    # the wire ships padded slots for the shuffled part; the output is
    # written compacted, so it rides un-inflated (same calibration scale
    # as ``comm`` so the two stay comparable)
    wire = shuffled * shuffle_pad_factor(p, calibrate_shuffle, wire_gain) + (
        comm - shuffled
    )
    overhead = float(dispatch_overhead) * (
        float(dispatches) + float(measure_dispatches)
    )
    wire += overhead
    return {
        "comm": comm,
        "rounds": float(claimed),
        "ops": float(n_ops),
        "out_est": out_est,
        "wire": wire,
        "dispatch_overhead": overhead,
    }


# --------------------------------------------------------------------------
# calibration: fit the model's constants from measured Ledger numbers
# --------------------------------------------------------------------------
@dataclasses.dataclass
class CostCalibration:
    """Multiplicative per-engine constants for ``predict_plan_cost``.

    The paper's formulas are O(.)-bounds; a real engine has constants
    (replication factors, dedup passes, retry re-sends).  We fit one
    scalar per engine as the geometric mean of measured/predicted
    communication over a set of executed plans — the log-space least
    squares solution for a single multiplicative constant — so the model
    keeps its *shape* and only its scale is learned.
    """

    comm_scale: Dict[str, float] = dataclasses.field(default_factory=dict)
    samples: int = 0

    def comm_factor(self, engine: str) -> float:
        return self.comm_scale.get(engine, 1.0)

    def apply(self, engine: str, predicted_comm: float) -> float:
        return predicted_comm * self.comm_factor(engine)

    def to_dict(self) -> Dict:
        return {"comm_scale": dict(self.comm_scale), "samples": self.samples}

    @staticmethod
    def from_dict(d: Mapping) -> "CostCalibration":
        return CostCalibration(
            comm_scale={k: float(v) for k, v in d.get("comm_scale", {}).items()},
            samples=int(d.get("samples", 0)),
        )


def fit_calibration(records: Iterable[Mapping]) -> CostCalibration:
    """Fit a ``CostCalibration`` from ``Ledger.calibration_record`` dicts.

    Each record needs ``engine``, ``predicted_comm`` (uncalibrated model
    output) and ``measured_comm`` (the ledger's ground truth).  Records
    with non-positive entries are skipped."""
    logs: Dict[str, List[float]] = {}
    n = 0
    for r in records:
        pred = float(r.get("predicted_comm", 0.0))
        meas = float(r.get("measured_comm", 0.0))
        if pred <= 0.0 or meas <= 0.0:
            continue
        logs.setdefault(str(r["engine"]), []).append(math.log(meas / pred))
        n += 1
    scale = {e: math.exp(sum(v) / len(v)) for e, v in logs.items()}
    return CostCalibration(comm_scale=scale, samples=n)


def prediction_error(predicted: float, measured: float) -> float:
    """Symmetric relative error in log space: |log(pred / measured)|.

    This is the quantity the calibration fit minimizes, so 'calibration
    reduces prediction error' is a statement about this metric."""
    assert predicted > 0 and measured > 0
    return abs(math.log(predicted / measured))
