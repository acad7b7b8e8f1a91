"""Fault tolerance: stop a GYM query mid-flight, resume it from the
round-level snapshot in a fresh driver, and check that the answer is the
uninterrupted run's (the port of ``examples/gym_fault_tolerance.py``).

    PYTHONPATH=src python -m repro_torch.examples.gym_fault_tolerance [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

from ..core.decompose import ghd_for
from ..core.gym import GymConfig, GymDriver, gym
from ..core.queries import chain_query
from ..data.synthetic import chain_data_sparse
from ..relational.spmd import SPMD


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu | cuda (default: the CUDA card)")
    dev = ap.parse_args(argv).device

    q = chain_query(6)
    data = chain_data_sparse(6, seed=5)

    # ground truth in one uninterrupted run
    want, _, _ = gym(q, data, p=4, config=GymConfig(seed=9), device=dev)
    want = {tuple(r) for r in want}

    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "gym_ft_snapshot.npz")
        # run 1: a few BSP round-groups, a snapshot after each, then a "crash"
        drv = GymDriver(q, ghd_for(q), data, SPMD(4, device=dev), GymConfig(seed=9))
        total = len(drv.schedule) + 1
        crash_after = 4
        for _ in range(crash_after):
            drv.step()
            drv.save(snap)
        print(f"[run 1] executed {crash_after}/{total} round-groups, snapshot at "
              f"cursor={drv.cursor}; simulating crash now")
        del drv

        # run 2: a fresh driver resumes from the snapshot and finishes
        drv2 = GymDriver(q, ghd_for(q), data, SPMD(4, device=dev), GymConfig(seed=9))
        drv2.load(snap)
        print(f"[run 2] resumed at cursor={drv2.cursor}")
        got = drv2.run().to_set()
    assert got == want, "resumed answer differs!"
    print(f"[run 2] finished: {len(got)} rows, identical to the uninterrupted run")
    print(drv2.ledger)


if __name__ == "__main__":
    main()
