"""BSP cost accounting: rounds and tuples communicated (the paper's two
cost metrics, Sec. 3.2), plus the wire-level padded-slot accounting behind
the occupancy-adaptive shuffle.  One ledger per query execution.

``comm_tuples`` counts *useful* tuples moved — the unit of the paper's
bounds.  The physical shuffle, however, ships dense ``(p, c_out, arity)``
slot buffers per ``all_to_all``, so the wire carries ``padded_slots``
int32 CELLS (slot rows x row width — width-weighted so keys-only
exchanges and the count pre-pass's own traffic are priced honestly).
``payload_efficiency`` (useful tuples per shipped cell) is the measured
quality of the capacity calibration; it is a tuples/cells ratio, so
compare it across capacity policies on the SAME query, not across
queries of different arity.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class RoundRecord:
    index: int
    phase: str
    ops: List[str]
    comm_tuples: int
    note: str = ""
    n_rounds: int = 1  # CLAIMED engine BSP rounds (parallel ops: the max)
    dispatches: int = 0  # MEASURED SPMD program dispatches (0 = not measured)
    padded_slots: int = 0  # MEASURED dense all_to_all slots shipped
    heavy_tuples: int = 0  # tuple-sends routed via the heavy-hitter path
    # the subset of ``dispatches`` that were count-only measure pre-passes.
    # Defaulted so pre-split snapshots (``RoundRecord(**r)``) keep loading.
    measure_dispatches: int = 0
    # byte-true wire accounting: ``payload_bytes`` is what the exchange
    # buffers actually occupied on the wire this round (packed bit-stream
    # bytes under the packed format, dense int32 cells + valid flags
    # otherwise — including count pre-pass vectors and keys-only
    # exchanges), ``useful_bytes`` the dense-int32 bytes of the useful
    # tuples inside them.  Defaulted so pre-wire snapshots keep loading.
    payload_bytes: int = 0
    useful_bytes: int = 0
    # routed-exchange stats shared with the MoE customer of
    # ``relational.routed``: tuples (token pairs) the round dropped at a
    # capacity — always 0 on join rounds, which abort-retry instead of
    # dropping — and the number of destinations (experts) the round's
    # count pre-pass flagged heavy.  Defaulted so pre-MoE snapshots
    # (``RoundRecord(**r)``) keep loading.
    dropped_tuples: int = 0
    heavy_dests: int = 0


class Ledger:
    def __init__(self) -> None:
        self.records: List[RoundRecord] = []
        self.output_tuples: int = 0
        self.retries: int = 0

    @property
    def rounds(self) -> int:
        return sum(r.n_rounds for r in self.records)

    @property
    def measured_dispatches(self) -> int:
        """Total SPMD program dispatches actually issued across rounds.

        ``rounds`` is what the schedule *claims* under the BSP model (a
        round of k parallel ops counts once); this is what the engine
        *did*.  With round fusion the two converge; without it this is
        ~ops-per-round times larger."""
        return sum(r.dispatches for r in self.records)

    @property
    def measure_dispatches(self) -> int:
        """Count-only calibration pre-pass dispatches — the price of
        measured capacities.  The amortized-calibration layer (combined
        per-round count dispatch + ``CapsCache`` + prefetch) bounds this at
        ~one per executed round instead of one per op group."""
        return sum(r.measure_dispatches for r in self.records)

    @property
    def payload_dispatches(self) -> int:
        """Dispatches that moved actual operator payload (total minus the
        measure pre-passes) — tracks the schedule, not the calibration
        policy."""
        return self.measured_dispatches - self.measure_dispatches

    @property
    def comm_tuples(self) -> int:
        """Total communication: shuffled tuples + output tuples (the paper
        counts reducer output as communication)."""
        return sum(r.comm_tuples for r in self.records) + self.output_tuples

    @property
    def shuffle_tuples(self) -> int:
        return sum(r.comm_tuples for r in self.records)

    @property
    def useful_tuples(self) -> int:
        """Alias of ``shuffle_tuples`` in wire terms: the occupied slots of
        the shipped exchange buffers."""
        return self.shuffle_tuples

    @property
    def padded_slots(self) -> int:
        """Dense ``all_to_all`` cells the wire actually shipped: every
        exchange pays ``p * c_out * arity`` int32 cells per shard, full or
        empty — including the count pre-pass's own count vectors and
        keys-only output-count exchanges."""
        return sum(r.padded_slots for r in self.records)

    @property
    def heavy_tuples(self) -> int:
        """Tuple-sends the hybrid engine routed through the heavy-hitter
        path (position-partitioned spreads + broadcast replicas).  Zero
        under the hash/grid engines and on unskewed instances — the
        hybrid engine's routing is data-dependent, and this is its
        measured heavy/light split."""
        return sum(r.heavy_tuples for r in self.records)

    @property
    def light_tuples(self) -> int:
        """Shuffled tuples that kept the plain hash routing."""
        return self.shuffle_tuples - self.heavy_tuples

    @property
    def dropped_tuples(self) -> int:
        """Tuples lost to a capacity across all rounds.  The join engines
        hold this at 0 by construction (overflow aborts and retries with
        doubled capacities); the MoE customer reports it explicitly —
        calibrated dispatch proves 0 when the measured counts fit, and
        capacity-ceilinged dispatch surfaces the exact overflow instead
        of the dense scatter's silent truncation."""
        return sum(r.dropped_tuples for r in self.records)

    @property
    def heavy_dests(self) -> int:
        """Destinations (reducers / experts) the count pre-pass flagged
        heavy, summed over rounds — the routed-exchange sibling of
        ``heavy_tuples`` (which counts the tuple-sends those destinations
        attracted)."""
        return sum(r.heavy_dests for r in self.records)

    @property
    def payload_bytes(self) -> int:
        """Bytes the wire actually shipped across all exchanges — the
        byte-true sibling of ``padded_slots``.  Unlike the slot metric
        (which prices every exchange at dense int32 width regardless of
        encoding), this reflects the configured wire format: packed
        exchanges charge their bit-stream byte size, dense exchanges
        charge ``4*arity + 1`` bytes per slot, and the count pre-pass's
        vectors charge their 4 bytes per counter."""
        return sum(r.payload_bytes for r in self.records)

    @property
    def useful_bytes(self) -> int:
        """Dense-int32 bytes of the useful tuples inside the shipped
        exchange buffers (4 bytes per cell of every occupied slot) —
        identical across wire formats, so ``payload_efficiency_bytes``
        ratios are comparable packed-vs-dense on the same query."""
        return sum(r.useful_bytes for r in self.records)

    @property
    def payload_efficiency_bytes(self) -> float:
        """useful_bytes per shipped wire byte (1.0 when nothing was
        shipped) — the byte-true quality of the exchange encoding.  Can
        exceed 1.0 under the packed format: a 6-bit column ships fewer
        wire bits than its 32-bit useful-payload accounting."""
        pb = self.payload_bytes
        return self.useful_bytes / pb if pb else 1.0

    @property
    def payload_efficiency(self) -> float:
        """useful_tuples per shipped cell — the measured quality of the
        shipped exchange buffers (1.0 when nothing was shuffled).  A
        tuples/cells ratio: compare across capacity policies on the same
        query, not across queries of different arity."""
        pad = self.padded_slots
        return self.useful_tuples / pad if pad else 1.0

    def add_round(
        self,
        phase: str,
        ops: List[str],
        comm: int,
        note: str = "",
        n_rounds: int = 1,
        dispatches: int = 0,
        padded: int = 0,
        heavy: int = 0,
        measure_dispatches: int = 0,
        payload_bytes: int = 0,
        useful_bytes: int = 0,
        dropped: int = 0,
        heavy_dests: int = 0,
    ) -> None:
        self.records.append(
            RoundRecord(
                len(self.records), phase, list(ops), int(comm), note, n_rounds,
                int(dispatches), int(padded), int(heavy),
                int(measure_dispatches), int(payload_bytes),
                int(useful_bytes), int(dropped), int(heavy_dests),
            )
        )

    def rounds_in_phase(self, phase: str) -> int:
        return sum(r.n_rounds for r in self.records if r.phase == phase)

    def comm_in_phase(self, phase: str) -> int:
        return sum(r.comm_tuples for r in self.records if r.phase == phase)

    def calibration_record(
        self,
        *,
        engine: str,
        schedule: str = "",
        query: str = "",
        predicted_comm: float = 0.0,
        predicted_rounds: float = 0.0,
    ) -> Dict[str, Any]:
        """One measured sample for ``core.costs.fit_calibration``.

        Pairs this execution's ground truth (comm_tuples, rounds,
        retries) with the advisor's *uncalibrated* predictions so the
        per-engine constants of the cost model can be fitted from real
        runs."""
        return {
            "engine": engine,
            "schedule": schedule,
            "query": query,
            "predicted_comm": float(predicted_comm),
            "predicted_rounds": float(predicted_rounds),
            "measured_comm": int(self.comm_tuples),
            "measured_shuffle": int(self.shuffle_tuples),
            "measured_rounds": int(self.rounds),
            "measured_dispatches": int(self.measured_dispatches),
            "measure_dispatches": int(self.measure_dispatches),
            "payload_dispatches": int(self.payload_dispatches),
            "measured_padded": int(self.padded_slots),
            "measured_heavy": int(self.heavy_tuples),
            "payload_efficiency": float(self.payload_efficiency),
            "payload_bytes": int(self.payload_bytes),
            "useful_bytes": int(self.useful_bytes),
            "payload_efficiency_bytes": float(self.payload_efficiency_bytes),
            "measured_dropped": int(self.dropped_tuples),
            "measured_heavy_dests": int(self.heavy_dests),
            "output_tuples": int(self.output_tuples),
            "retries": int(self.retries),
        }

    def summary(self) -> Dict[str, Any]:
        phases: Dict[str, Dict[str, int]] = {}
        for r in self.records:
            ph = phases.setdefault(
                r.phase,
                {
                    "rounds": 0,
                    "comm": 0,
                    "dispatches": 0,
                    "measure_dispatches": 0,
                    "padded": 0,
                    "heavy": 0,
                    "payload_bytes": 0,
                    "useful_bytes": 0,
                    "dropped": 0,
                    "heavy_dests": 0,
                },
            )
            ph["rounds"] += r.n_rounds
            ph["comm"] += r.comm_tuples
            ph["dispatches"] += r.dispatches
            ph["measure_dispatches"] += r.measure_dispatches
            ph["padded"] += r.padded_slots
            ph["heavy"] += r.heavy_tuples
            ph["payload_bytes"] += r.payload_bytes
            ph["useful_bytes"] += r.useful_bytes
            ph["dropped"] += r.dropped_tuples
            ph["heavy_dests"] += r.heavy_dests
        return {
            "rounds": self.rounds,
            "measured_dispatches": self.measured_dispatches,
            "measure_dispatches": self.measure_dispatches,
            "payload_dispatches": self.payload_dispatches,
            "comm_tuples": self.comm_tuples,
            "shuffle_tuples": self.shuffle_tuples,
            "padded_slots": self.padded_slots,
            "heavy_tuples": self.heavy_tuples,
            "light_tuples": self.light_tuples,
            "dropped_tuples": self.dropped_tuples,
            "heavy_dests": self.heavy_dests,
            "payload_efficiency": round(self.payload_efficiency, 4),
            "payload_bytes": self.payload_bytes,
            "useful_bytes": self.useful_bytes,
            "payload_efficiency_bytes": round(self.payload_efficiency_bytes, 4),
            "output_tuples": self.output_tuples,
            "retries": self.retries,
            "phases": phases,
        }

    def __repr__(self) -> str:
        s = self.summary()
        heavy = f", heavy={s['heavy_tuples']}" if s["heavy_tuples"] else ""
        if s["heavy_dests"]:
            heavy += f", heavy_dests={s['heavy_dests']}"
        if s["dropped_tuples"]:
            heavy += f", dropped={s['dropped_tuples']}"
        lines = [
            f"Ledger(rounds={s['rounds']}, dispatches={s['measured_dispatches']}, "
            f"comm={s['comm_tuples']}, out={s['output_tuples']}, "
            f"padded={s['padded_slots']}, eff={s['payload_efficiency']}, "
            f"bytes={s['payload_bytes']}, "
            f"eff_bytes={s['payload_efficiency_bytes']}, "
            f"retries={s['retries']}{heavy})"
        ]
        for ph, v in s["phases"].items():
            lines.append(
                f"  {ph}: rounds={v['rounds']} dispatches={v['dispatches']} "
                f"comm={v['comm']} padded={v['padded']}"
            )
        return "\n".join(lines)


class ServerLedger:
    """Multi-tenant accounting for the serving layer: every completed
    query's per-tenant ``Ledger`` plus the server-level fusion counters.

    The aggregate IS the per-tenant sum — cross-request fusion changes how
    work is packed into SPMD programs, never what each query's wire moved
    (each tenant's rows, ``comm_tuples``, and byte accounting stay those
    of a standalone run, Lemma-2-auditable per request).  What fusion
    saves shows up only in the dispatch split: a merged dispatch charges
    its ONE program launch to the first rider, and ``fused_dispatches`` /
    ``fused_riders`` record how many launches the merge avoided."""

    def __init__(self) -> None:
        self.tenants: Dict[str, List[Ledger]] = {}
        # merged payload dispatches issued / rider groups that shared one
        self.fused_dispatches: int = 0
        self.fused_riders: int = 0

    def add(self, tenant: str, ledger: Ledger) -> None:
        self.tenants.setdefault(tenant, []).append(ledger)

    def _all(self) -> List[Ledger]:
        return [led for leds in self.tenants.values() for led in leds]

    @property
    def queries(self) -> int:
        return len(self._all())

    @property
    def comm_tuples(self) -> int:
        return sum(led.comm_tuples for led in self._all())

    @property
    def padded_slots(self) -> int:
        return sum(led.padded_slots for led in self._all())

    @property
    def payload_bytes(self) -> int:
        return sum(led.payload_bytes for led in self._all())

    @property
    def measured_dispatches(self) -> int:
        return sum(led.measured_dispatches for led in self._all())

    @property
    def retries(self) -> int:
        return sum(led.retries for led in self._all())

    @property
    def dispatches_saved(self) -> int:
        """Payload program launches cross-request fusion avoided: riders
        that shared a merged dispatch instead of launching their own."""
        return self.fused_riders - self.fused_dispatches

    def tenant_summary(self, tenant: str) -> Dict[str, Any]:
        leds = self.tenants.get(tenant, [])
        return {
            "tenant": tenant,
            "queries": len(leds),
            "comm_tuples": sum(l.comm_tuples for l in leds),
            "output_tuples": sum(l.output_tuples for l in leds),
            "padded_slots": sum(l.padded_slots for l in leds),
            "payload_bytes": sum(l.payload_bytes for l in leds),
            "dispatches": sum(l.measured_dispatches for l in leds),
            "retries": sum(l.retries for l in leds),
        }

    def summary(self) -> Dict[str, Any]:
        return {
            "queries": self.queries,
            "comm_tuples": self.comm_tuples,
            "padded_slots": self.padded_slots,
            "payload_bytes": self.payload_bytes,
            "dispatches": self.measured_dispatches,
            "retries": self.retries,
            "fused_dispatches": self.fused_dispatches,
            "fused_riders": self.fused_riders,
            "dispatches_saved": self.dispatches_saved,
            "tenants": {t: self.tenant_summary(t) for t in sorted(self.tenants)},
        }

    def __repr__(self) -> str:
        s = self.summary()
        return (
            f"ServerLedger(queries={s['queries']}, comm={s['comm_tuples']}, "
            f"dispatches={s['dispatches']}, "
            f"saved={s['dispatches_saved']}, retries={s['retries']})"
        )
