"""Snapshot / resume parity of the hybrid engine's case: the port's
resumed driver against the reference's resumed driver, and the reference's
snapshot file resumed in the port (see ``test_torch_snapshot.py``)."""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from test_torch_snapshot import check_reference_snapshot, check_resume, reference  # noqa: E402,F401


@pytest.mark.parametrize("name", ["hybrid"])
def test_resume_matches_reference(name, reference, tmp_path):  # noqa: F811
    check_resume(name, reference, tmp_path)


@pytest.mark.parametrize("name", ["hybrid"])
def test_reference_snapshot_resumes_in_port(name, reference, tmp_path):  # noqa: F811
    check_reference_snapshot(name, reference, tmp_path)
