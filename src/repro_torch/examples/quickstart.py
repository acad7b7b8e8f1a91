"""Quickstart: evaluate a join with GYM, inspect the BSP cost ledger, and
compare against the one-round Shares baseline (the port of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from ..core.gym import GymConfig, gym
from ..core.hypergraph import Atom, Query
from ..core.queries import triangle_chain_ghd, triangle_chain_query
from ..core.shares import shares_join


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu | cuda (default: the CUDA card)")
    dev = ap.parse_args(argv).device

    # --- 1. a simple acyclic query: users |><| orders |><| items --------
    q = Query(
        [
            Atom("users", "users", ("uid", "region")),
            Atom("orders", "orders", ("uid", "item")),
            Atom("items", "items", ("item", "price")),
        ],
        name="UsersOrdersItems",
    )
    rng = np.random.default_rng(0)
    data = {
        "users": np.stack([np.arange(20), rng.integers(0, 4, 20)], 1),
        "orders": np.stack([rng.integers(0, 20, 50), rng.integers(0, 10, 50)], 1),
        "items": np.stack([np.arange(10), rng.integers(1, 100, 10)], 1),
    }
    rows, schema, ledger = gym(q, data, p=4, device=dev)
    print(f"[gym] {q.name}: {len(rows)} result rows, schema={schema}")
    print(ledger)

    # --- 2. a cyclic query (TC_6, width 2) via grid (paper-faithful) ops
    q2 = triangle_chain_query(2)
    data2 = {
        f"R{i}": np.stack([rng.integers(0, 4, 30), rng.integers(0, 4, 30)], 1)
        for i in range(1, 7)
    }
    rows2, _, led2 = gym(q2, data2, ghd=triangle_chain_ghd(2), p=4,
                         config=GymConfig(strategy="grid"), device=dev)
    print(f"\n[gym/grid] {q2.name}: {len(rows2)} rows")
    print(led2)

    # --- 3. the same query with one-round Shares ------------------------
    rows3, _, led3 = shares_join(q2, data2, p=8, device=dev)
    assert {tuple(r) for r in rows3} == {tuple(r) for r in rows2}
    print(f"\n[shares] {q2.name}: {len(rows3)} rows in {led3.rounds} round, "
          f"comm={led3.comm_tuples} tuples (vs GYM {led2.comm_tuples})")


if __name__ == "__main__":
    main()
