"""Multi-tenant join serving: submit a mixed workload of GYM queries to
one ``JoinServer``, let it fuse compatible rounds across requests into
shared SPMD dispatches, and read back per-tenant cost ledgers (the port of
``examples/serve_joins.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_joins [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from ..core.gym import GymConfig
from ..core.queries import chain_ghd, chain_query, star_ghd, star_query
from ..data.synthetic import chain_data_sparse, star_data_sparse
from ..relational.spmd import SPMD
from ..serve.join_server import JoinServer


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu | cuda (default: the CUDA card)")
    dev = ap.parse_args(argv).device
    server = JoinServer(SPMD(4, device=dev), max_in_flight=4)

    # --- 1. three tenants, two query shapes -----------------------------
    # alice and bob run the same star join on their own data snapshots
    # (their rounds share schema signatures, so the server fuses them into
    # one SPMD dispatch per stage); carol's chain join rides alongside solo
    star = (star_query(4), star_ghd(4))
    chain = (chain_query(4), chain_ghd(4))
    sdata = star_data_sparse(4, domain=32, hub_rows=64, spoke_extra=16, seed=7)
    cdata = chain_data_sparse(4, domain=64, ident=16, extra=48, seed=9)
    tickets = [
        server.submit("alice", *star, sdata, GymConfig(seed=3)),
        server.submit("bob", *star, sdata, GymConfig(seed=3)),
        server.submit("carol", *chain, cdata, GymConfig(seed=3), priority=-1.0),
    ]

    # --- 2. drive every admitted query round by round to completion -----
    aggregate = server.drain()
    for t in tickets:
        print(f"[{t.tenant}] {len(t.rows())} rows, "
              f"admitted@tick {t.admit_tick}, finished@tick {t.finish_tick}")
        print(f"    {t.ledger}")

    # --- 3. the server ledger reconciles exactly with the tenant ledgers
    tenant_leds = [led for leds in aggregate.tenants.values() for led in leds]
    assert aggregate.comm_tuples == sum(led.comm_tuples for led in tenant_leds)
    print(f"\n[server] {aggregate.queries} queries, comm={aggregate.comm_tuples} tuples, "
          f"{aggregate.fused_dispatches} fused dispatches covered {aggregate.fused_riders} "
          f"rider groups ({aggregate.dispatches_saved} dispatches saved)")


if __name__ == "__main__":
    main()
