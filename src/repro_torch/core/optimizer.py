"""Cost-based plan advisor: enumerate (GHD x schedule x engine x fusion)
candidates, score them with the paper's formulas (``core/costs.py``),
and return the argmin as an executable ``Plan``.

The paper's headline contribution is a *spectrum* of round/communication
tradeoffs: the same query runs as O(n)-round DYM on a width-w GHD
(Theorem 12), O(log n)-round GYM on a Log-GTA decomposition of width
max(w, 3iw) (Theorem 23), or anywhere in between via C-GTA (Theorem 25).
This module turns that spectrum into a decision:

  1. **GHD candidates** — the hand GHD (if given), the generic
     ``ghd_for`` construction, Log-GTA (Sec. 6), Log-GTA' (Appendix
     D.2), and one C-GTA pass composed with Log-GTA (Sec. 7), deduped by
     structural signature.
  2. **Schedules** — every entry of ``planner.SCHEDULES`` (``dym_n``:
     Sec. 4.2 / Theorem 12; ``dym_d``: Sec. 4.3 / Theorem 14).
  3. **Engines** — the ``core.physical`` strategy registry: ``'hash'``
     (comm ~ inputs+outputs, skew-sensitive), ``'grid'`` (Lemmas 8/10,
     skew-proof, B(X, M) = X^2/M), and ``'hybrid'`` (heavy-hitter
     routing on the count pre-pass: hash for light keys, grid-style
     spread/broadcast for heavy ones).  With a ``skew`` statistic
     (``skew_share`` / ``skew_from_data``) the model prices hash by its
     MAX per-destination load, so skewed instances steer to hybrid; ties
     on uniform data resolve to hash by key order.
  4. **Fusion** — one SPMD dispatch per homogeneous op group, or one
     per op.  Identical comm/rounds; distinguished by the predicted
     dispatch count.

Scoring walks the *actual* schedule op-by-op (``predict_plan_cost``)
under a machine profile (p, M) and an optional ``CostCalibration``
fitted from measured ``Ledger`` numbers.  Ranking is lexicographic:
predicted WIRE slots (communication inflated by the shuffle pad factor
for the configured capacity policy — what the all_to_all actually
ships), then calibrated predicted communication, then claimed BSP
rounds, then predicted dispatches — the paper's two cost metrics
(Sec. 3.2) seen through the physical shuffle, plus the engine's own
measure of dispatch overhead.

``explain()`` renders the full candidate table (plain text or markdown,
with predicted-vs-measured error when ledgers are supplied), so the
advisor doubles as the repo's teaching tool.  ``GymConfig(plan="auto")``
runs ``choose_plan`` inside ``GymDriver`` and executes the winner.

This is the reference package's advisor, float for float (the ranking
breaks ties on these floats, so the chosen key is the reference's).  A
plan's ``local_backend`` is one of the port's backends, ``'torch'`` or
``'cuda'``, or None — the executing device's default, so an advisor
decision never turns the card's kernels off.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .cgta import cgta
from .costs import (
    OP_STAGES,
    CostCalibration,
    predict_plan_cost,
)
from .decompose import ghd_for
from .ghd import GHD
from .hypergraph import Query
from .loggta import log_gta
from .loggta_prime import log_gta_prime
from .planner import SCHEDULES, Round, get_schedule


# --------------------------------------------------------------------------
# inputs: machine profile + table statistics
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MachineProfile:
    """The paper's machine model (Sec. 3.2): p machines with M tuples of
    memory each.  ``M=None`` derives a default from the input size —
    4 * IN / p, floored — matching Assumption 3 (inputs fit with room to
    rehash)."""

    p: int = 4
    M: Optional[float] = None
    # wire-slot-equivalent price of one program dispatch (see
    # ``costs.DEFAULT_DISPATCH_OVERHEAD_SLOTS``); 0 keeps the classic
    # pure-volume ranking.  Nonzero lets the advisor charge the count
    # pre-pass for its dispatches and decide calibrated-vs-fixed per
    # query (``enumerate_plans(calibrate_options=...)``).
    dispatch_overhead: float = 0.0

    def memory(self, total_input: float) -> float:
        if self.M is not None:
            return float(self.M)
        return max(16.0, 4.0 * float(total_input) / max(1, self.p))


def skew_share(rows: np.ndarray) -> float:
    """Max single-value column share of a relation: the fraction of rows
    carrying the most frequent value of any one column — the ``share``
    that ``costs.skew_amplification`` turns into a hot-reducer load
    factor.  0.0 for empty relations; ~1/|domain| on uniform data."""
    rows = np.asarray(rows)
    if rows.size == 0:
        return 0.0
    rows = rows.reshape(rows.shape[0], -1)
    n = rows.shape[0]
    share = 0.0
    for c in range(rows.shape[1]):
        _, counts = np.unique(rows[:, c], return_counts=True)
        share = max(share, float(counts.max()) / n)
    return share


def skew_from_data(
    query: Query, data: Mapping[str, np.ndarray]
) -> Dict[str, float]:
    """Per-relation ``skew_share`` under the SAME cast+dedup ``GymDriver``
    applies on load (mirrors ``stats_from_data``)."""
    out: Dict[str, float] = {}
    for atom in query.atoms:
        if atom.rel in out:
            continue
        rows = np.asarray(data[atom.rel], dtype=np.int32).reshape(
            -1, len(atom.attrs)
        )
        if rows.shape[0]:
            rows = np.unique(rows, axis=0)
        out[atom.rel] = skew_share(rows)
    return out


def stats_from_data(query: Query, data: Mapping[str, np.ndarray]) -> Dict[str, int]:
    """Table-size statistics (distinct rows per base relation) — the
    driver casts to int32 and dedups relations on load
    (``GymDriver.__init__``), so the SAME cast+dedup here guarantees the
    advisor scores exactly the tables the engine will see."""
    sizes: Dict[str, int] = {}
    for atom in query.atoms:
        if atom.rel in sizes:
            continue
        rows = np.asarray(data[atom.rel], dtype=np.int32).reshape(
            -1, len(atom.attrs)
        )
        sizes[atom.rel] = (
            int(np.unique(rows, axis=0).shape[0]) if rows.shape[0] else 0
        )
    return sizes


# --------------------------------------------------------------------------
# the Plan: a fully-resolved, directly-executable choice
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Plan:
    """One point on the paper's tradeoff spectrum, resolved to something
    ``GymDriver`` can execute: a complete GHD plus the engine knobs.

    ``key`` is the stable identity (``source|schedule|engine|fusion``)
    used by explain() tables, measured-ledger joins, and snapshots
    (``GymConfig.plan`` records it so resume stays on the same plan).
    """

    key: str
    ghd_source: str  # 'hand' | 'auto' | 'loggta' | 'loggta_prime' | 'cgta1'
    schedule: str  # planner.SCHEDULES name
    engine: str  # physical.ENGINES name
    fused: bool
    # 'torch' | 'cuda', or None: the executing device's default (the
    # kernels on the card, the plain versions on the CPU)
    local_backend: Optional[str]
    ghd: GHD  # complete (Lemma 7) form
    width: int
    depth: int
    iw: int
    nodes: int
    predicted_comm: float
    predicted_wire: float  # comm inflated by the shuffle pad factor
    predicted_rounds: float
    predicted_dispatches: float
    out_est: float
    calibrated: bool
    # the shuffle capacity policy this plan was priced under, when the
    # enumeration competed calibrated against fixed
    # (``calibrate_options``); None = the policy wasn't part of the
    # decision and the executing config's own knob stands.
    calibrate_shuffle: Optional[bool] = None
    # predicted count-pre-pass dispatches under amortized calibration
    # (0 for fixed-capacity plans)
    predicted_measure_dispatches: float = 0.0

    def to_config(self, base=None):
        """A ``GymConfig`` with this plan's choices applied (engine,
        schedule, fusion, backend) and ``plan`` set to the key so
        snapshots round-trip the decision."""
        from .gym import GymConfig

        base = base if base is not None else GymConfig()
        cfg = dataclasses.replace(
            base,
            strategy=self.engine,
            schedule=self.schedule,
            fused=self.fused,
            local_backend=self.local_backend,
            plan=self.key,
        )
        if self.calibrate_shuffle is not None:
            cfg = dataclasses.replace(
                cfg, calibrate_shuffle=self.calibrate_shuffle
            )
        return cfg


def _plan_order(p: Plan) -> Tuple:
    # ranked by what the wire actually carries (padded slots), then the
    # paper's two metrics, then dispatch overhead
    return (
        p.predicted_wire,
        p.predicted_comm,
        p.predicted_rounds,
        p.predicted_dispatches,
        p.key,
    )


# --------------------------------------------------------------------------
# candidate enumeration
# --------------------------------------------------------------------------
def candidate_ghds(
    query: Query, hand_ghd: Optional[GHD] = None
) -> List[Tuple[str, GHD]]:
    """The GHD leg of the spectrum, all in complete (Lemma 7) form:
    hand / auto (GYO or min-fill) / Log-GTA / Log-GTA' / C-GTA+Log-GTA.
    Structurally identical candidates are deduped (first source wins, so
    'hand' shadows an identical 'auto')."""
    out: List[Tuple[str, GHD]] = []
    seen: set = set()

    def add(source: str, g: GHD) -> None:
        try:
            gc = g.make_complete(query)
        except (AssertionError, ValueError):
            return
        sig = tuple(
            sorted(
                (tuple(sorted(gc.chi[v])), tuple(sorted(gc.lam[v])))
                for v in gc.nodes()
            )
        ) + (gc.depth,)
        if sig in seen:
            return
        seen.add(sig)
        out.append((source, gc))

    if hand_ghd is not None:
        add("hand", hand_ghd)
    add("auto", ghd_for(query))
    if not out:
        raise ValueError(
            f"no valid GHD candidate for query {query.name!r}: the hand GHD "
            "(if any) and the constructed one both failed completion"
        )
    base = out[0][1]  # best-known starting point for the transforms
    for source, transform in (
        ("loggta", lambda g: log_gta(g, query)),
        ("loggta_prime", lambda g: log_gta_prime(g, query)),
        ("cgta1", lambda g: cgta(g, query, passes=1)),
    ):
        try:
            add(source, transform(base.copy()))
        except (AssertionError, ValueError):
            continue  # transform not applicable (e.g. trivial trees)
    return out


def _predicted_dispatches(rounds: Sequence[Round], fused: bool) -> float:
    """Schedule-phase dispatch estimate: fused execution issues ~one SPMD
    program per (stage, op kind) group; sequential issues one per
    physical op (``costs.OP_STAGES`` carries the per-stage instance
    counts of ``physical.lower_op``).  Materialization is counted as one
    — a deliberate simplification (its dispatch count varies per bag), so
    this column is a relative tie-break, not a measured-dispatch
    prediction."""
    total = 1.0  # materialization
    for rnd in rounds:
        per_stage: Dict[int, List] = {}
        for op in rnd.ops:
            for i, (sk, n_ops) in enumerate(OP_STAGES[op.kind]):
                per_stage.setdefault(i, []).append((sk, n_ops))
        for stage in per_stage.values():
            if fused:
                total += len({sk for sk, _ in stage})
            else:
                total += sum(n for _, n in stage)
    return total


def _predicted_measure_dispatches(rounds: Sequence[Round]) -> float:
    """Count-pre-pass dispatch estimate under AMORTIZED calibration: a
    stage shape pays one combined count dispatch (plus one fused
    keys-only output pre-count when it joins) the FIRST time it appears
    in a phase; repeats of the same shape hit the cross-round
    ``CapsCache`` for free.  Materialization's own measure counts one.
    Mirrors ``physical.PhysicalExecutor._measure_stage`` the way
    ``_predicted_dispatches`` mirrors the payload schedule."""
    total = 1.0  # materialization measure
    seen: set = set()
    for rnd in rounds:
        per_stage: Dict[int, set] = {}
        for op in rnd.ops:
            for i, (sk, _n) in enumerate(OP_STAGES[op.kind]):
                per_stage.setdefault(i, set()).add(sk)
        for i, kinds in per_stage.items():
            sig = (rnd.phase, i, frozenset(kinds))
            if sig in seen:
                continue
            seen.add(sig)
            total += 1.0
            if "join" in kinds:
                total += 1.0  # the fused join-output count pass
    return total


def enumerate_plans(
    query: Query,
    stats: Mapping[str, int],
    *,
    profile: Optional[MachineProfile] = None,
    hand_ghd: Optional[GHD] = None,
    calibration: Optional[CostCalibration] = None,
    local_backend: Optional[str] = None,
    engines: Sequence[str] = ("hash", "grid", "hybrid"),
    schedules: Optional[Sequence[str]] = None,
    fused_options: Sequence[bool] = (True, False),
    calibrate_shuffle: bool = True,
    skew: Optional[Mapping[str, float]] = None,
    skew_threshold: Optional[float] = None,
    calibrate_options: Optional[Sequence[bool]] = None,
    wire_gain: float = 1.0,
) -> List[Plan]:
    """Score every candidate plan; returns them best-first (by predicted
    wire slots under the given shuffle mode, see ``_plan_order``).

    ``wire_gain`` is the executing wire format's mean row compression
    ratio (``relational.wire.wire_gain``): 1.0 for the dense exchange,
    > 1 when ``GymConfig.wire_format == "packed"``.  It deflates the
    shuffle pad factor so a packed execution's plan ranking reflects
    the bytes its wire will actually carry.

    ``skew`` maps relation names to their max single-key share
    (``skew_from_data``); without it every engine prices at balanced
    load and hybrid ties with hash (hash wins the tie by key order).

    ``calibrate_options``: None (default) prices every plan under the
    single ``calibrate_shuffle`` mode and leaves the executing config's
    knob alone.  A sequence like ``(True, False)`` makes the capacity
    policy part of the decision: each candidate is scored per mode
    (key suffix ``|cal`` / ``|fixed``), the calibrated variant paying
    its predicted measure dispatches at ``profile.dispatch_overhead``
    wire slots each, the fixed variant paying the ~p-fold pad factor.
    The hybrid engine requires the pre-pass and never enumerates
    ``|fixed``."""
    profile = profile or MachineProfile()
    schedules = tuple(schedules) if schedules is not None else tuple(sorted(SCHEDULES))
    alias_sizes = {a.alias: float(stats[a.rel]) for a in query.atoms}
    alias_skew = (
        {a.alias: float(skew.get(a.rel, 0.0)) for a in query.atoms}
        if skew is not None
        else None
    )
    plans: List[Plan] = []
    for source, g in candidate_ghds(query, hand_ghd):
        width, depth, nodes = g.width, g.depth, g.size()
        iw = g.intersection_width(query)
        for sched in schedules:
            rounds = get_schedule(sched).fn(g)
            meas_est = _predicted_measure_dispatches(rounds)
            for engine in engines:
                if calibrate_options is None:
                    modes: List[Tuple[bool, str]] = [(calibrate_shuffle, "")]
                else:
                    modes = [
                        (bool(m), "|cal" if m else "|fixed")
                        for m in calibrate_options
                        # data-dependent routing NEEDS the pre-pass: the
                        # executor would force it back on anyway
                        if m or engine != "hybrid"
                    ]
                for fused in fused_options:
                    disp = _predicted_dispatches(rounds, fused)
                    for mode, suffix in modes:
                        meas = meas_est if mode else 0.0
                        cost = predict_plan_cost(
                            query, g, rounds, engine, alias_sizes,
                            profile.p, calibration,
                            calibrate_shuffle=mode,
                            alias_skew=alias_skew,
                            skew_threshold=skew_threshold,
                            dispatch_overhead=profile.dispatch_overhead,
                            dispatches=disp,
                            measure_dispatches=meas,
                            wire_gain=wire_gain,
                        )
                        plans.append(
                            Plan(
                                key=f"{source}|{sched}|{engine}|"
                                + ("fused" if fused else "seq")
                                + suffix,
                                ghd_source=source,
                                schedule=sched,
                                engine=engine,
                                fused=fused,
                                local_backend=local_backend,
                                ghd=g,
                                width=width,
                                depth=depth,
                                iw=iw,
                                nodes=nodes,
                                predicted_comm=cost["comm"],
                                predicted_wire=cost["wire"],
                                predicted_rounds=cost["rounds"],
                                predicted_dispatches=disp,
                                out_est=cost["out_est"],
                                calibrated=calibration is not None,
                                calibrate_shuffle=(
                                    None if calibrate_options is None else mode
                                ),
                                predicted_measure_dispatches=meas,
                            )
                        )
    plans.sort(key=_plan_order)
    return plans


def choose_plan(
    query: Query,
    stats: Mapping[str, int],
    *,
    profile: Optional[MachineProfile] = None,
    hand_ghd: Optional[GHD] = None,
    calibration: Optional[CostCalibration] = None,
    local_backend: Optional[str] = None,
    calibrate_shuffle: bool = True,
    skew: Optional[Mapping[str, float]] = None,
    skew_threshold: Optional[float] = None,
    calibrate_options: Optional[Sequence[bool]] = None,
    wire_gain: float = 1.0,
) -> Plan:
    """The advisor's decision: argmin over the candidate plans by
    (predicted wire slots under the configured shuffle mode, calibrated
    predicted comm, claimed rounds, predicted dispatches).  Pass the
    execution's ``GymConfig.calibrate_shuffle`` so the pad factor the
    ranking uses matches the shuffle the plan will actually run on, and
    ``skew`` (``skew_from_data``) so skewed instances price hash by its
    hot reducer and steer to the hybrid engine.  ``calibrate_options``
    (e.g. ``(True, False)`` with a nonzero ``profile.dispatch_overhead``)
    additionally lets the advisor decide per query whether the count
    pre-pass pays for itself (see ``enumerate_plans``)."""
    plans = enumerate_plans(
        query,
        stats,
        profile=profile,
        hand_ghd=hand_ghd,
        calibration=calibration,
        local_backend=local_backend,
        calibrate_shuffle=calibrate_shuffle,
        skew=skew,
        skew_threshold=skew_threshold,
        calibrate_options=calibrate_options,
        wire_gain=wire_gain,
    )
    assert plans, "no executable plan candidates"
    return plans[0]


# --------------------------------------------------------------------------
# explain(): the candidate table as a teaching tool
# --------------------------------------------------------------------------
def _measured_comm(entry) -> Optional[float]:
    if entry is None:
        return None
    if hasattr(entry, "comm_tuples"):  # a Ledger
        return float(entry.comm_tuples)
    return float(entry)


def _measured_padded(entry) -> Optional[Tuple[float, float]]:
    """(padded_slots, payload_efficiency) from a Ledger entry, or None for
    plain measured-comm numbers (which carry no wire accounting)."""
    if entry is None or not hasattr(entry, "padded_slots"):
        return None
    return float(entry.padded_slots), float(entry.payload_efficiency)


def _render_table(header: List[str], rows: List[List[str]], fmt: str) -> str:
    if fmt == "markdown":
        lines = [
            "| " + " | ".join(header) + " |",
            "|" + "|".join("---" for _ in header) + "|",
        ]
        lines += ["| " + " | ".join(r) + " |" for r in rows]
        return "\n".join(lines)
    widths = [
        max(len(header[i]), *(len(r[i]) for r in rows)) if rows else len(header[i])
        for i in range(len(header))
    ]
    lines = ["  ".join(h.ljust(w) for h, w in zip(header, widths)).rstrip()]
    lines.append("  ".join("-" * w for w in widths))
    lines += [
        "  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip() for r in rows
    ]
    return "\n".join(lines)


def _fmt_num(x: float) -> str:
    if x >= 1e6 or (x != 0 and x < 0.01):
        return f"{x:.3g}"
    if float(x).is_integer():
        return str(int(x))
    return f"{x:.1f}"


def explain(
    query: Query,
    stats: Mapping[str, int],
    *,
    hand_ghd: Optional[GHD] = None,
    profile: Optional[MachineProfile] = None,
    p: Optional[int] = None,
    M: Optional[float] = None,
    calibration: Optional[CostCalibration] = None,
    measured: Optional[Mapping[str, object]] = None,
    local_backend: Optional[str] = None,
    calibrate_shuffle: bool = True,
    skew: Optional[Mapping[str, float]] = None,
    fmt: str = "text",
) -> str:
    """Render the advisor's full candidate table.

    ``measured`` maps plan keys to ``Ledger`` objects (or plain measured
    comm numbers); when given, the table grows measured-comm,
    prediction-error, and wire-level (``meas_padded`` slots shipped /
    ``eff`` payload efficiency) columns, turning explain() into the
    predicted-vs-measured report of ``benchmarks/bench_optimizer.py``.
    Output is deterministic for fixed inputs (stable ordering and
    formatting), which the tests pin.
    """
    assert fmt in ("text", "markdown"), fmt
    profile = profile or MachineProfile(p=p if p is not None else 4, M=M)
    plans = enumerate_plans(
        query,
        stats,
        profile=profile,
        hand_ghd=hand_ghd,
        calibration=calibration,
        local_backend=local_backend,
        calibrate_shuffle=calibrate_shuffle,
        skew=skew,
    )
    chosen = plans[0]
    with_measured = measured is not None
    header = [
        "plan",
        "ghd(w/iw/d/n)",
        "pred_rounds",
        "pred_comm",
        "pred_wire",
        "pred_dispatches",
    ]
    if with_measured:
        header += ["meas_comm", "err", "meas_padded", "eff"]
    rows = []
    for pl in plans:
        mark = "*" if pl.key == chosen.key else " "
        row = [
            f"{mark} {pl.key}",
            f"{pl.width}/{pl.iw}/{pl.depth}/{pl.nodes}",
            _fmt_num(pl.predicted_rounds),
            _fmt_num(pl.predicted_comm),
            _fmt_num(pl.predicted_wire),
            _fmt_num(pl.predicted_dispatches),
        ]
        if with_measured:
            entry = measured.get(pl.key)
            meas = _measured_comm(entry)
            if meas is None:
                row += ["-", "-"]
            else:
                err = (pl.predicted_comm - meas) / max(1.0, meas)
                row += [_fmt_num(meas), f"{100 * err:+.0f}%"]
            pad = _measured_padded(entry)
            if pad is None:
                row += ["-", "-"]
            else:
                row += [_fmt_num(pad[0]), f"{pad[1]:.2f}"]
        rows.append(row)
    total_in = sum(float(stats[a.rel]) for a in query.atoms)
    cal = (
        "none"
        if calibration is None
        else " ".join(
            f"{e}x{s:.3g}" for e, s in sorted(calibration.comm_scale.items())
        )
        or "identity"
    )
    body = _render_table(header, rows, fmt)
    footer = (
        f"query={query.name} atoms={query.n} IN={_fmt_num(total_in)} "
        f"profile: p={profile.p} M={_fmt_num(profile.memory(total_in))} "
        f"calibration: {cal}\n"
        f"chosen: {chosen.key} — lowest predicted wire slots (comm x "
        f"shuffle pad factor), then predicted comm, then claimed BSP "
        f"rounds ({get_schedule(chosen.schedule).paper}, "
        f"{get_schedule(chosen.schedule).claimed_rounds}), then dispatches"
    )
    return body + "\n" + footer
