"""BSP round planner for distributed Yannakakis (paper Sections 4.2, 4.3).

The planner is pure tree algorithmics: given a (materialized) join tree it
emits a round-by-round schedule of semijoin/intersection/join operations.
The executor (``gym.py``) runs each schedule round as one BSP round-group
and the ledger accounts actual engine rounds + tuples moved.

Schedules (both registered in ``SCHEDULES`` with their paper metadata,
which is what the plan advisor in ``core/optimizer.py`` enumerates):
  - ``dym_n_schedule``: the serial Yannakakis order (Sec. 4.1/4.2,
    Theorem 12): 2(n-1) semijoins one-at-a-time, then n-1 bottom-up
    joins -> O(n) rounds, O(n * B(IN + OUT, M)) communication.
  - ``dym_d_schedule``: the parallel-contraction order (Sec. 4.3,
    Theorem 14): upward semijoin phase + downward semijoin phase + join
    phase, each contracting all eligible leaves per iteration
    -> O(d + log n) rounds at the same communication bound.

Op kinds (target := result):
  semijoin      (S, R)          S := S |>< R                [upward L1]
  pair_filter   (R1, S, R2)     R1 := (S |>< R1) ^ (S |>< R2)  [upward L2]
  triple_filter (R1, S, R2, R3) R1 := ^ of three semijoins  [upward L2 odd]
  down_semijoin (R, S)          R := R |>< S                [downward]
  join          (S, R)          S := S |><| R               [join L1]
  pair_join     (R1, S, R2)     R1 := (R1|><|S) |><| (R2|><|S)  [join L2]
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

from .ghd import GHD


@dataclasses.dataclass(frozen=True)
class Op:
    kind: str
    target: int
    args: Tuple[int, ...]  # other participating nodes

    def __repr__(self) -> str:
        return f"{self.kind}({self.target};{','.join(map(str, self.args))})"


@dataclasses.dataclass
class Round:
    phase: str  # 'upward' | 'downward' | 'join'
    ops: List[Op]


@dataclasses.dataclass
class _Tree:
    """Mutable contraction scratch tree."""

    parent: Dict[int, Optional[int]]
    children: Dict[int, List[int]]
    root: int

    @staticmethod
    def of(g: GHD) -> "_Tree":
        return _Tree(
            parent=dict(g.parent),
            children={k: list(v) for k, v in g.children.items()},
            root=g.root,
        )

    def remove_leaf(self, n: int) -> None:
        p = self.parent[n]
        if p is not None:
            self.children[p].remove(n)
        del self.parent[n]
        self.children.pop(n, None)

    def leaves(self) -> List[int]:
        return [n for n in self.parent if not self.children.get(n)]

    def size(self) -> int:
        return len(self.parent)


def _contraction_rounds(g: GHD, phase: str, join: bool) -> List[Round]:
    """One upward pass (Sec. 4.3 induction): per iteration, group current
    leaves by parent; parents with one leaf child absorb it (L1-style,
    single writer); parents with >= 2 leaf children get their leaves paired
    (odd count -> one triple), no write to the parent."""
    t = _Tree.of(g)
    rounds: List[Round] = []
    guard = 0
    while t.size() > 1:
        guard += 1
        assert guard <= 2 * t.size() + 64, "contraction failed to terminate"
        by_parent: Dict[int, List[int]] = {}
        for l in t.leaves():
            p = t.parent[l]
            if p is None:
                continue
            by_parent.setdefault(p, []).append(l)
        ops: List[Op] = []
        for p, ls in sorted(by_parent.items()):
            ls = sorted(ls)
            if len(ls) == 1:
                l = ls[0]
                ops.append(Op("join" if join else "semijoin", p, (l,)))
                t.remove_leaf(l)
            else:
                i = 0
                # pairs; if odd, the last group is a triple
                while len(ls) - i >= 2:
                    if len(ls) - i == 3:
                        a, b, c = ls[i], ls[i + 1], ls[i + 2]
                        ops.append(
                            Op(
                                "triple_join" if join else "triple_filter",
                                a,
                                (p, b, c),
                            )
                        )
                        t.remove_leaf(b)
                        t.remove_leaf(c)
                        i += 3
                    else:
                        a, b = ls[i], ls[i + 1]
                        ops.append(
                            Op("pair_join" if join else "pair_filter", a, (p, b))
                        )
                        t.remove_leaf(b)
                        i += 2
        assert ops, "no progress in contraction"
        rounds.append(Round(phase, ops))
    return rounds


def _downward_rounds(g: GHD) -> List[Round]:
    """Per depth level (top-down), every child semijoins with its parent —
    all children at a level in parallel: O(d) rounds."""
    levels: Dict[int, List[int]] = {}
    stack = [(g.root, 0)]
    while stack:
        n, d = stack.pop()
        for c in g.children.get(n, []):
            levels.setdefault(d + 1, []).append(c)
            stack.append((c, d + 1))
    rounds = []
    for d in sorted(levels):
        ops = [Op("down_semijoin", c, (g.parent[c],)) for c in sorted(levels[d])]
        rounds.append(Round("downward", ops))
    return rounds


def dym_d_schedule(g: GHD) -> List[Round]:
    """Sec. 4.3 / Theorem 14: O(d + log n) upward contraction rounds +
    O(d) downward rounds + O(d + log n) join contraction rounds."""
    return (
        _contraction_rounds(g, "upward", join=False)
        + _downward_rounds(g)
        + _contraction_rounds(g, "join", join=True)
    )


def dym_n_schedule(g: GHD) -> List[Round]:
    """Sec. 4.2 / Theorem 12 (serial Yannakakis order): one op per round,
    3(n-1) rounds total on an n-node GHD.

    Upward: recursive leaf-at-a-time semijoins into parents; Downward:
    reverse order parent->child semijoins; Join: bottom-up one at a time.
    """
    # upward: repeatedly pick any leaf, semijoin into parent
    t = _Tree.of(g)
    up: List[Round] = []
    order: List[Tuple[int, int]] = []  # (leaf, parent) removal order
    while t.size() > 1:
        l = min(t.leaves(), key=lambda n: (n != t.root, n))
        if t.parent[l] is None:  # only the root left as a "leaf"
            break
        p = t.parent[l]
        up.append(Round("upward", [Op("semijoin", p, (l,))]))
        order.append((l, p))
        t.remove_leaf(l)
    # downward: reverse order, R := R |>< S
    down = [
        Round("downward", [Op("down_semijoin", l, (p,))]) for l, p in reversed(order)
    ]
    # join phase: bottom-up, one join per round
    t2 = _Tree.of(g)
    joins: List[Round] = []
    while t2.size() > 1:
        l = min(t2.leaves())
        p = t2.parent[l]
        joins.append(Round("join", [Op("join", p, (l,))]))
        t2.remove_leaf(l)
    return up + down + joins


# --------------------------------------------------------------------------
# schedule registry: paper metadata the plan advisor enumerates over
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ScheduleInfo:
    """One named schedule with its claimed paper bounds.

    ``round_bound(g)`` is the *claimed* worst-case round count on GHD
    ``g`` (with the same constants the round-bound tests assert);
    ``fn(g)`` emits the actual rounds.  The advisor uses ``fn`` for
    exact per-plan costing and ``round_bound``/``claimed_rounds`` for
    the explain() teaching columns.
    """

    name: str
    fn: Callable[[GHD], List["Round"]]
    paper: str  # section / theorem this schedule implements
    claimed_rounds: str  # the O(.) round bound, human-readable
    round_bound: Callable[[GHD], int]


def _dym_n_bound(g: GHD) -> int:
    # Theorem 12: 2(n-1) semijoin rounds + (n-1) join rounds
    return 3 * max(1, g.size() - 1)


def _dym_d_bound(g: GHD) -> int:
    # Theorem 14: O(d + log n) per phase, 3 phases (constants as asserted
    # by tests/test_gym_engine.py round-bound tests)
    return 3 * (g.depth + int(math.ceil(math.log2(max(2, g.size())))) + 2)


SCHEDULES: Dict[str, ScheduleInfo] = {
    "dym_n": ScheduleInfo(
        name="dym_n",
        fn=dym_n_schedule,
        paper="Sec. 4.2 / Theorem 12",
        claimed_rounds="O(n)",
        round_bound=_dym_n_bound,
    ),
    "dym_d": ScheduleInfo(
        name="dym_d",
        fn=dym_d_schedule,
        paper="Sec. 4.3 / Theorem 14",
        claimed_rounds="O(d + log n)",
        round_bound=_dym_d_bound,
    ),
}


def get_schedule(name: str) -> ScheduleInfo:
    try:
        return SCHEDULES[name]
    except KeyError:
        raise ValueError(
            f"unknown schedule {name!r}; registered: {sorted(SCHEDULES)}"
        ) from None


def schedule_stats(rounds: List[Round]) -> Dict[str, int]:
    out: Dict[str, int] = {"rounds": len(rounds), "ops": 0}
    for r in rounds:
        out["ops"] += len(r.ops)
        out[r.phase] = out.get(r.phase, 0) + 1
    return out
