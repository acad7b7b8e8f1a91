"""The port's examples (``repro_torch.examples.*``, one for each of the
reference's ``examples/*.py``) run on the CPU: each ends in asserts of its
own; the four join examples print their cost ledgers, as
``tests/test_examples.py`` checks for the reference's; ``serve_decode``
generates over its three architectures (attention KV, recurrent state,
cross-KV); ``train_lm --tiny`` takes two steps."""
from __future__ import annotations

import importlib

import pytest

pytest.importorskip("torch")


@pytest.mark.parametrize("name", ["quickstart", "gym_fault_tolerance", "serve_joins", "moe_routing"])
def test_join_example_runs_clean(name, capsys):
    importlib.import_module(f"repro_torch.examples.{name}").main(["--device", "cpu"])
    assert "Ledger(" in capsys.readouterr().out  # every example prints its cost ledger


def test_serve_decode_runs_its_three_architectures(capsys):
    from repro_torch.examples import serve_decode

    serve_decode.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for arch in ("smollm-360m", "xlstm-125m", "whisper-small"):
        assert f"{arch:14s} generated: [[" in out
    assert out.rstrip().endswith("ok")


def test_train_lm_tiny(tmp_path, capsys):
    from repro_torch.examples import train_lm

    train_lm.main(["--tiny", "--steps", "2", "--device", "cpu", "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert "step    1 loss" in out and out.rstrip().endswith("done")
