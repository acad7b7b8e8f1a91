"""ACQ-MR (paper Sec. 2.2): the MR simulation of the ACQ PRAM algorithm.

Per the paper, ACQ-MR is realized as GYM running on the Log-GTA' transform
of the input GHD: every new vertex materializes a join of <= 3w *base*
relations (ACQ's shunt of three relations), giving Theta(log n) rounds and
O(n B(IN^{3w} + OUT, M)) communication — always matched, and sometimes
beaten, by GYM(Log-GTA) whose new vertices only need max(w, 3iw) relations.

Both entry points run on the CUDA card unless the caller passes
``device="cpu"``, as ``gym()`` does, or on a device mesh with
``spmd=SPMD(p, mesh=...)``, one process a reducer (every rank calls with
the same arguments and returns the whole answer).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..relational.ledger import Ledger
from ..relational.spmd import SPMD
from .decompose import ghd_for
from .ghd import GHD
from .gym import GymConfig, gym
from .hypergraph import Query
from .loggta import log_gta
from .loggta_prime import log_gta_prime


def acq_mr(
    query: Query,
    data: Dict[str, np.ndarray],
    *,
    ghd: Optional[GHD] = None,
    p: Optional[int] = None,
    spmd: Optional[SPMD] = None,
    config: Optional[GymConfig] = None,
    device=None,
) -> Tuple[np.ndarray, Tuple[str, ...], Ledger]:
    """Evaluate Q via GYM on Log-GTA'(D): the ACQ-MR baseline."""
    g = ghd if ghd is not None else ghd_for(query)
    g3 = log_gta_prime(g.make_complete(query), query)
    return gym(query, data, ghd=g3, p=p, spmd=spmd, config=config, device=device)


def gym_loggta(
    query: Query,
    data: Dict[str, np.ndarray],
    *,
    ghd: Optional[GHD] = None,
    p: Optional[int] = None,
    spmd: Optional[SPMD] = None,
    config: Optional[GymConfig] = None,
    device=None,
) -> Tuple[np.ndarray, Tuple[str, ...], Ledger]:
    """GYM(Log-GTA(D)): log-round GYM with width <= max(w, 3iw)."""
    g = ghd if ghd is not None else ghd_for(query)
    g2 = log_gta(g.make_complete(query), query)
    return gym(query, data, ghd=g2, p=p, spmd=spmd, config=config, device=device)
