"""The packed wire on the sequential (``fused=False``, one dispatch per
physical op) and fixed-capacity (``calibrate_shuffle=False``) paths, in
the port against the reference's packed runs (see
``test_torch_gym_packed.py`` for what is compared).

The chain case runs in the default selection under every engine; the
star and triangle-chain cases are marked slow (their sequential runs make
the reference compile one program per op shape, minutes in all).  The
reference's runs are made once per module.
"""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from repro.relational.spmd import SPMD  # noqa: E402
from test_torch_gym_hybrid import assert_same_run  # noqa: E402
from test_torch_gym_packed import (  # noqa: E402
    P,
    assert_packed_keeps_dense_invariants,
    port_run,
    ref_run,
)
from test_wire_format import CASES  # noqa: E402

ENGINES = ("hash", "grid", "hybrid")
MODES = {"seq": dict(fused=False), "fixed": dict(calibrate_shuffle=False)}
PARAMS = [
    pytest.param(name, mode, engine, marks=() if name == "chain" else pytest.mark.slow)
    for name in sorted(CASES) for mode in sorted(MODES) for engine in ENGINES
]

_REF = {}


def _ref(name, mode, engine):
    if (name, mode, engine) not in _REF:
        spmd = _REF.setdefault("spmd", SPMD(P))
        _REF[name, mode, engine] = ref_run(
            spmd, *CASES[name](), strategy=engine, wire_format="packed", **MODES[mode]
        )
    return _REF[name, mode, engine]


@pytest.mark.parametrize("name,mode,engine", PARAMS)
def test_packed_seq_and_fixed_match_reference(name, mode, engine):
    q, g, data = CASES[name]()
    assert_same_run(
        port_run(q, g, data, strategy=engine, wire_format="packed", **MODES[mode]),
        _ref(name, mode, engine),
    )


@pytest.mark.parametrize("name,mode,engine", PARAMS)
def test_packed_seq_and_fixed_keep_dense_invariants(name, mode, engine):
    q, g, data = CASES[name]()
    assert_packed_keeps_dense_invariants(
        q, g, data, (name, mode, engine), strategy=engine, **MODES[mode]
    )
