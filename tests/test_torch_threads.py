"""The port's tests share the host's cores among pytest-xdist's workers.

Each worker imports every test module while it collects, before any test
runs, so this module sets each worker's torch intra-op threads to its
share of the host's cores (at least one): torch's default, a thread a
core in every worker, oversubscribes the host several times over, and
its spinning threads slow every worker, the JAX package's tests too.  A
run without workers keeps torch's default.
"""
from __future__ import annotations

import os

import pytest

torch = pytest.importorskip("torch")

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
SHARE = max(1, (os.cpu_count() or 1) // WORKERS) if WORKERS else None
if SHARE is not None:
    torch.set_num_threads(SHARE)


def test_each_worker_takes_its_share_of_the_cores():
    if SHARE is None:
        pytest.skip("not under pytest-xdist: torch keeps its default threads")
    assert torch.get_num_threads() == SHARE
