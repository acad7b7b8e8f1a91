"""Seconds the base relations' host dedup and ``GymDriver``'s whole host
set-up take, on the CPU, for random two-column int32 relations:

    PYTHONPATH=src python3 tools/dedup_timing.py [--rows N] [--relations K] [--reps R]

For one relation of ``N`` rows (default 2^20): ``np.unique(axis=0)`` (a
record sort) against ``relational/table.py::unique_rows`` (one int64 key a
row, one 1-D ``np.unique``), best of ``R``; then the set-up of a C_K ``GymDriver``
(``chain_query(K)``, ``K`` relations of ``N / K`` rows each, p = 8) on
``device="cpu"``.  Prints one ``DEDUP`` line.  It runs on the CPU only:
the set-up on the card's host also uploads the tables.
"""
import argparse
import time

import numpy as np


def best(fn, reps: int) -> float:
    out = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out = min(out, time.perf_counter() - t0)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--relations", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    from repro_torch.core import queries as Q
    from repro_torch.core.gym import GymConfig, GymDriver
    from repro_torch.relational.spmd import SPMD
    from repro_torch.relational.table import unique_rows

    rng = np.random.default_rng(0)
    rows = rng.integers(0, 1 << 20, size=(args.rows, 2)).astype(np.int32)
    assert np.array_equal(np.unique(rows, axis=0), unique_rows(rows))
    record = best(lambda: np.unique(rows, axis=0), args.reps)
    keyed = best(lambda: unique_rows(rows), args.reps)

    k = args.relations
    n = args.rows // k
    data = {f"R{i}": rng.integers(0, 1 << 20, size=(n, 2)).astype(np.int32) for i in range(1, k + 1)}
    q, g = Q.chain_query(k), Q.chain_ghd(k)
    setup = best(lambda: GymDriver(q, g, data, SPMD(8, device="cpu"), GymConfig(seed=23)), args.reps)
    print(f"DEDUP rows={args.rows} np_unique_axis0_s={record:.4f} unique_rows_s={keyed:.4f} "
          f"C_{k} driver set-up ({k} x {n} rows, p = 8, cpu) s={setup:.4f}", flush=True)


if __name__ == "__main__":
    main()
