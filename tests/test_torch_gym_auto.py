"""``GymConfig(plan="auto")`` end to end in the port against the JAX
reference: the advisor's chosen plan key, rows (order included), schema,
every ``RoundRecord``, retries and output tuples must be equal, and the
chosen plan must keep the device's default backend (``local_backend``
None: the plain versions here on the CPU, the kernels on the card).

Cases: ``tests/test_optimizer.py``'s S_8 (dense wire) and TC_9 (packed
wire) at p = 4; the planted skew is in ``test_torch_gym_auto_skew.py``.
"""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from test_torch_optimizer import CASES, _port_drive, _ref_drive, _same  # noqa: E402


def check_auto_plan(name, wire):
    q, g, data = CASES[name]
    rdrv, ref = _ref_drive(q, g, data, 4, plan="auto", seed=5, wire_format=wire)
    tdrv, port = _port_drive(q, g, data, 4, plan="auto", seed=5, wire_format=wire)
    assert tdrv.plan.key == rdrv.plan.key == tdrv.config.plan
    assert tdrv.plan.local_backend is None and tdrv.local_backend == "torch"
    assert tdrv.executor.engine.name == rdrv.plan.engine
    assert (tdrv.executor.engine.wire_policy is not None) == (wire == "packed")
    _same(port, ref)
    return tdrv


@pytest.mark.parametrize("name,wire", [("S_8", "dense"), ("TC_9", "packed")])
def test_auto_plan_gym_matches_reference(name, wire):
    check_auto_plan(name, wire)
