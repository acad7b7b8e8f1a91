"""``GymConfig(plan="auto")`` on ``tests/test_skew_hybrid.py``'s planted
heavy-key star at p = 4, in the port against the JAX reference (see
``test_torch_gym_auto.py`` for what is compared): the advisor must choose
the hybrid engine, as the reference's does."""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from test_torch_gym_auto import check_auto_plan  # noqa: E402


def test_auto_plan_on_planted_skew_matches_reference():
    assert check_auto_plan("skewed", "dense").plan.engine == "hybrid"
