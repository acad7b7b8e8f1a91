"""The port's log-depth GHD constructors against the reference's.

``repro_torch.core.{loggta,loggta_prime,cgta}`` must return the reference's
GHD exactly — ``GHD.to_dict()`` equal, node ids and child order included,
because round seeds and node schemas follow node ids.  Pure Python on both
sides (no JAX compile).
"""
from __future__ import annotations

import random

import pytest

pytest.importorskip("torch")

from repro.core import cgta as JC  # noqa: E402
from repro.core import loggta as JL  # noqa: E402
from repro.core import loggta_prime as JLP  # noqa: E402
from repro.core.decompose import gyo_join_tree  # noqa: E402
from repro.core.queries import (  # noqa: E402
    chain_ghd,
    chain_query,
    random_acyclic_query,
    star_ghd,
    star_query,
    triangle_chain_ghd,
    triangle_chain_query,
)

from repro_torch.core import cgta as TC  # noqa: E402
from repro_torch.core import loggta as TL  # noqa: E402
from repro_torch.core import loggta_prime as TLP  # noqa: E402
from repro_torch.interop import ghd_from_dict, query_from_atoms  # noqa: E402

PLANS = {
    "C_8": lambda: (chain_query(8), chain_ghd(8)),
    "C_16": lambda: (chain_query(16), chain_ghd(16)),
    "C_32": lambda: (chain_query(32), chain_ghd(32)),
    "TC_9": lambda: (triangle_chain_query(3), triangle_chain_ghd(3)),
    # Figure 6 of the paper: TC_15, five triangles, depth 4
    "TC_15": lambda: (triangle_chain_query(5), triangle_chain_ghd(5)),
    "S_8": lambda: (star_query(8), star_ghd(8)),
}


def _random_plans():
    out = {}
    for seed in range(8):
        rng = random.Random(1000 + seed)
        q = random_acyclic_query(rng, 4 + 3 * seed)
        out[f"rand{seed}"] = (lambda q=q: (q, gyo_join_tree(q)))
    return out


PLANS.update(_random_plans())


def _port(q, g):
    tq = query_from_atoms([(a.alias, a.rel, a.attrs) for a in q.atoms], name=q.name)
    return tq, ghd_from_dict(g.to_dict())


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize(
    "transform",
    ["log_gta", "log_gta_prime", "cgta_pass", "cgta2"],
)
def test_transform_matches_reference(plan, transform):
    q, g = PLANS[plan]()
    tq, tg = _port(q, g)
    if transform == "log_gta":
        want, got = JL.log_gta(g, q, check=True), TL.log_gta(tg, tq, check=True)
    elif transform == "log_gta_prime":
        want, got = JLP.log_gta_prime(g, q), TLP.log_gta_prime(tg, tq)
    elif transform == "cgta_pass":
        want, got = JC.cgta_pass(g, q), TC.cgta_pass(tg, tq)
    else:
        want, got = JC.cgta(g, q, passes=2), TC.cgta(tg, tq, passes=2)
    assert got.to_dict() == want.to_dict()
    got.validate(tq)


def test_log_depth_plans_of_the_chip_phase():
    """The plans the chip's logdepth phase runs: C_16 goes from depth 15 to
    4 under both Log-GTA and Log-GTA' (3-atom bags, among them the cross
    bag pi_A4(R4) x pi_A6(R6) x pi_A8(R8)), C_32 to 5, TC_15 from 4 to 2."""
    q, g = PLANS["C_16"]()
    tq, tg = _port(q, g)
    lg, lgp = TL.log_gta(tg, tq), TLP.log_gta_prime(tg, tq)
    assert (tg.depth, lg.depth, lgp.depth) == (15, 4, 4)
    assert max(len(lam) for lam in lg.lam.values()) == 3
    assert (lg.chi[24], lg.lam[24]) == ({"A4", "A6", "A8"}, {"R4", "R6", "R8"})
    assert TL.log_gta(*reversed(_port(*PLANS["C_32"]()))).depth == 5
    tq5, tg5 = _port(*PLANS["TC_15"]())
    assert tg5.depth == 4
    assert TL.log_gta(tg5, tq5).depth == 2


def test_extended_ghd_inactivation_sets_match():
    q, g = PLANS["C_16"]()
    tq, tg = _port(q, g)
    je, te = JL.ExtendedGHD.extend(g, q), TL.ExtendedGHD.extend(tg, tq)
    assert TL.select_inactivation_sets(te) == JL.select_inactivation_sets(je)
