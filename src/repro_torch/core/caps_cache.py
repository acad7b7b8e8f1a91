"""Cross-round capacity cache: amortizing the calibration pre-pass.

PR 4/5 made exchange capacities measured instead of guessed, but paid a
count dispatch per op group per round.  DYM schedules re-execute the same
op-group SHAPES round after round (the paper's multiround structure), and
pow2 bucketing makes the measured capacities stable whenever the data
volume is — so the measured ``SideCaps`` of a group signature can be
carried across rounds and re-measured only when the observed payload fill
drifts.

Safety model (what the property tests pin):

- a cached cap is only ever an OLD measurement applied to NEW data, so it
  can undercount.  Undercounts are caught by the payload exchange itself —
  rows overflowing a bucket are counted ``dropped``, the executor aborts
  the round, invalidates every cache entry the attempt touched, and
  retries with fresh measures (the paper's abort-and-retry).  Rows are
  bit-identical either way; a stale cache costs a retry, never wrongness.
- entries must be CONFIRMED before they serve hits: the first recurrence
  of a signature still measures fresh (the measure doubles as a free
  validation — if the stored caps cover the fresh counts, the
  distribution is stable and the entry is promoted).  Exchange routing is
  seed-dependent and seeds advance every round, so a single observation
  says nothing about the next round's per-destination maxima; demanding
  one successful revalidation before trusting an entry keeps stale-cap
  retries out of the common case instead of merely recovering from them.
- heavy-hitter measures are NEVER cached: the hybrid payload needs the
  per-destination heavy flags, which are seed- and data-bound in a way
  capacities are not.  Skewed groups re-measure every round (they are the
  rare case the skew threshold already isolates).
- a watermark band invalidates entries whose observed fill drifts from
  the baseline recorded when the entry was created: growth past the
  baseline means the caps may be about to undercount (invalidate BEFORE
  the drop, usually), and shrink far below it means the caps are now
  wastefully padded (re-tighten).

The cache is part of the executor's snapshot state: save/resume keeps the
amortization warm instead of re-measuring the first post-resume round.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from ..relational.batched import GroupMeasure, SideCaps

# watermark band defaults: invalidate when a round's max per-instance
# sent EXCEEDS the baseline (the caps were measured for at most that
# fill), or falls below a quarter of it (pow2 gives ≤2x headroom, so a
# 4x shrink means at least one wasted pow2 notch).
DEFAULT_GROWTH = 1.0
DEFAULT_SHRINK = 0.25


@dataclasses.dataclass
class CacheEntry:
    lhs: Tuple[int, int]  # (c_out, cap_recv)
    rhs: Optional[Tuple[int, int]]
    out_recv: Optional[int]
    out_need: Optional[int]
    sent0: Optional[int] = None  # fill baseline (first observed round)
    confirmed: bool = False  # caps covered a later fresh measure at least once
    hits: int = 0


class CapsCache:
    """Measured ``SideCaps`` keyed by op-group signature.

    Keys are the executor's group signatures (kind + shard shapes +
    managed output capacity) WITHOUT the per-op index, so sequential
    singleton groups of the same shape share an entry (merged by
    elementwise max, still safe: caps only grow under merge)."""

    def __init__(
        self,
        *,
        growth: float = DEFAULT_GROWTH,
        shrink: float = DEFAULT_SHRINK,
    ):
        self.growth = float(growth)
        self.shrink = float(shrink)
        self._entries: Dict[Tuple, CacheEntry] = {}
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return tuple(key) in self._entries

    def entry(self, key) -> Optional[CacheEntry]:
        return self._entries.get(tuple(key))

    # ----------------------------------------------------------- lookup
    def lookup(self, key) -> Optional[GroupMeasure]:
        """Return a zero-cost ``GroupMeasure`` for a cached signature, or
        None (measure needed).  Unconfirmed entries never hit — their next
        fresh measure is the validation that promotes them (see
        ``store``).  Hits serve the stored caps with ONE pow2 notch of
        headroom (x2): the entry only proved stability on PAST rounds,
        and a single-notch demand drift between observations is the
        common growth mode — the notch absorbs it where the bare caps
        would abort the round.  A hit ships nothing: ``padded == 0``,
        and no heavy surface (heavy groups are never stored)."""
        e = self._entries.get(tuple(key))
        if e is None or not e.confirmed:
            self.misses += 1
            return None
        self.hits += 1
        e.hits += 1
        return GroupMeasure(
            lhs=SideCaps(2 * e.lhs[0], 2 * e.lhs[1]),
            rhs=SideCaps(2 * e.rhs[0], 2 * e.rhs[1])
            if e.rhs is not None
            else None,
            out_recv=None if e.out_recv is None else 2 * e.out_recv,
            out_need=None if e.out_need is None else 2 * e.out_need,
            padded=0,
        )

    # ------------------------------------------------------------ store
    def store(self, key, m: GroupMeasure) -> bool:
        """Insert a fresh measurement; refuses heavy/hybrid measures (the
        payload needs their per-destination flags, which don't cache).
        Storing over a live entry merges by elementwise max — two
        same-signature groups in one stage stay mutually safe — and acts
        as the entry's validation: if the live caps already covered the
        fresh measure, the signature's fill is stable across seeds and
        the entry is promoted to serve hits."""
        if m.n_heavy or m.hybrid_routed:
            return False
        key = tuple(key)
        lhs = (m.lhs.c_out, m.lhs.cap_recv)
        rhs = (m.rhs.c_out, m.rhs.cap_recv) if m.rhs is not None else None
        prev = self._entries.get(key)
        if prev is not None:
            covered = lhs[0] <= prev.lhs[0] and lhs[1] <= prev.lhs[1]
            if rhs is not None and prev.rhs is not None:
                covered = covered and rhs[0] <= prev.rhs[0] and rhs[1] <= prev.rhs[1]
            covered = covered and (
                m.out_recv is None
                or (prev.out_recv is not None and m.out_recv <= prev.out_recv)
            )
            covered = covered and (
                m.out_need is None
                or (prev.out_need is not None and m.out_need <= prev.out_need)
            )
            lhs = (max(lhs[0], prev.lhs[0]), max(lhs[1], prev.lhs[1]))
            if rhs is not None and prev.rhs is not None:
                rhs = (max(rhs[0], prev.rhs[0]), max(rhs[1], prev.rhs[1]))
            out_recv = _opt_max(m.out_recv, prev.out_recv)
            out_need = _opt_max(m.out_need, prev.out_need)
            sent0 = prev.sent0
            confirmed = bool(covered)
        else:
            out_recv, out_need, sent0 = m.out_recv, m.out_need, None
            confirmed = False
        self._entries[key] = CacheEntry(
            lhs, rhs, out_recv, out_need, sent0, confirmed
        )
        return True

    # ---------------------------------------------------- fill feedback
    def observe(self, key, max_sent: int, dropped: bool) -> None:
        """Feed back one round's payload fill for a signature: the first
        observation sets the watermark baseline; later ones invalidate on
        drops (the caps provably undercounted) or when the fill leaves
        the ``[shrink * sent0, growth * sent0]`` band."""
        key = tuple(key)
        e = self._entries.get(key)
        if e is None:
            return
        if dropped:
            self.invalidate(key)
            return
        if e.sent0 is None:
            e.sent0 = int(max_sent)
            return
        if max_sent > self.growth * e.sent0 or max_sent < self.shrink * e.sent0:
            self.invalidate(key)

    def invalidate(self, key) -> None:
        if self._entries.pop(tuple(key), None) is not None:
            self.invalidations += 1

    def clear(self) -> None:
        self._entries.clear()

    # ------------------------------------------------------- snapshot IO
    def to_json(self) -> List[List[Any]]:
        return [
            [
                list(k),
                {
                    "lhs": list(e.lhs),
                    "rhs": list(e.rhs) if e.rhs is not None else None,
                    "out_recv": e.out_recv,
                    "out_need": e.out_need,
                    "sent0": e.sent0,
                    "confirmed": e.confirmed,
                },
            ]
            for k, e in sorted(self._entries.items(), key=lambda kv: repr(kv[0]))
        ]

    def load_json(self, data: List[List[Any]], merge: bool = False) -> None:
        """Restore snapshot entries.  ``merge=True`` (the serving layer,
        restoring one tenant into a cache SHARED by others) keeps any
        live entry that already covers a restored signature — a restore
        must never clobber what co-tenants have since measured and
        confirmed; fresh signatures load as usual."""
        loaded = {
            tuple(k): CacheEntry(
                lhs=tuple(v["lhs"]),
                rhs=tuple(v["rhs"]) if v["rhs"] is not None else None,
                out_recv=v["out_recv"],
                out_need=v["out_need"],
                sent0=v["sent0"],
                confirmed=bool(v.get("confirmed", False)),
            )
            for k, v in data
        }
        if not merge:
            self._entries = loaded
            return
        for k, e in loaded.items():
            self._entries.setdefault(k, e)

    def stats(self) -> Dict[str, int]:
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "invalidations": self.invalidations,
        }


def _opt_max(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None:
        return b
    if b is None:
        return a
    return max(a, b)
