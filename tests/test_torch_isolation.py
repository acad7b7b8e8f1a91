"""Guards of the PyTorch port's isolation from the JAX package.

- importing ``repro_torch`` and every submodule leaves ``jax`` (and the
  reference package) out of ``sys.modules`` — checked in a fresh process;
- no module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or ``repro`` (AST scan);
- without a CUDA card, ``gym`` with no device raises instead of quietly
  running on the CPU, and the ``'cuda'`` backend refuses CPU tensors.
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_modules_exist():
    names = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    for mod in (
        "core/gym.py", "core/physical.py", "core/caps_cache.py", "core/planner.py",
        "relational/batched.py", "relational/ops.py", "relational/routed.py",
        "relational/localops.py", "relational/hashing.py", "relational/spmd.py",
        "kernels/hash_partition.py", "kernels/semijoin_probe.py",
        "kernels/sorted_probe.py", "kernels/build.py", "data/synthetic.py",
        "interop.py", "kernels/flash_attention.py", "kernels/ops.py", "kernels/ref.py",
        "models/common.py", "models/attention.py", "models/mlp.py",
        "models/moe_routing.py", "models/transformer.py", "models/ssm.py", "models/xlstm.py", "configs/registry.py", "configs/gemma2_9b.py",
        "serve/decode.py", "launch/serve.py", "relational/grid.py", "core/loggta.py",
        "core/loggta_prime.py", "core/cgta.py", "core/acq_mr.py", "core/shares.py",
        "relational/wire.py", "relational/shuffle.py", "kernels/wire_codec.py",
        "core/costs.py", "core/optimizer.py", "serve/join_server.py",
        "kernels/chunked.py", "train/optim.py", "train/compression.py", "train/step.py",
        "train/checkpoint.py", "train/elastic.py", "data/pipeline.py", "launch/train.py",
        "models/whisper.py", "examples/quickstart.py", "examples/gym_fault_tolerance.py",
        "examples/serve_joins.py", "examples/moe_routing.py", "examples/serve_decode.py",
        "examples/train_lm.py", "launch/dryrun.py", "launch/roofline.py",
    ):
        assert mod in names, mod
    assert (PKG / "csrc" / "gym_kernels.cu").exists()
    assert (PKG / "csrc" / "flash_attention.cu").exists()
    assert (PKG / "csrc" / "wire_codec.cu").exists()


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative: stays inside repro_torch
                continue
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {n}"


def test_import_leaves_jax_out():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py")
        if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        "import repro_torch\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr


def test_default_device_needs_cuda():
    from repro_torch.core.gym import GymConfig, gym
    from repro_torch.core.queries import chain_query

    data = {"R1": np.array([[0, 1]], np.int32), "R2": np.array([[1, 2]], np.int32)}
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        gym(chain_query(2), data, p=2)
    with pytest.raises(ValueError, match="cuda"):
        gym(chain_query(2), data, p=2, device="cpu",
            config=GymConfig(local_backend="cuda"))
    rows, schema, led = gym(chain_query(2), data, p=2, device="cpu")
    assert rows.tolist() == [[0, 1, 2]] and led.output_tuples == 1


def test_later_slices_raise(tmp_path):
    from repro_torch.core.gym import GymConfig
    from repro_torch.core.queries import chain_query
    from repro_torch.relational.spmd import SPMD

    # the packed wire, the advisor and save/load/step_gen are ported
    assert GymConfig(wire_format="packed").wire_format == "packed"
    assert GymConfig(plan="auto").plan == "auto"
    from repro_torch.core.gym import GymDriver
    from repro_torch.core.queries import chain_ghd

    drv = GymDriver(
        chain_query(2), chain_ghd(2),
        {"R1": np.array([[0, 1]], np.int32), "R2": np.array([[1, 2]], np.int32)},
        SPMD(2, device="cpu"), GymConfig(wire_format="packed", plan="auto"),
    )
    assert drv.plan is not None and drv.plan.local_backend is None
    assert drv.step()  # materialization; then snapshot, resume, finish
    snap = str(tmp_path / "snap.npz")
    drv.save(snap)
    resumed = GymDriver(
        chain_query(2), chain_ghd(2),
        {"R1": np.array([[0, 1]], np.int32), "R2": np.array([[1, 2]], np.int32)},
        SPMD(2, device="cpu"), GymConfig(),
    )
    resumed.load(snap)
    assert resumed.config.plan == drv.config.plan and resumed.config.wire_format == "packed"
    assert resumed.run().to_numpy().tolist() == [[0, 1, 2]]
    assert drv.run().to_numpy().tolist() == [[0, 1, 2]]
    # the grid and hybrid engines are ported; the hybrid engine forces
    # the count pre-pass on and runs
    assert GymConfig(strategy="grid").strategy == "grid"
    from repro_torch.core.gym import gym
    from repro_torch.core.physical import ENGINES

    assert ENGINES["hybrid"].requires_measure
    rows, _, led = gym(
        chain_query(2), {"R1": np.array([[0, 1]], np.int32), "R2": np.array([[1, 2]], np.int32)},
        p=2, device="cpu", config=GymConfig(strategy="hybrid", calibrate_shuffle=False),
    )
    assert rows.tolist() == [[0, 1, 2]] and led.measure_dispatches > 0
    with pytest.raises(NotImplementedError):
        SPMD(4, mesh=object(), device="cpu")


def test_bag_of_three_atoms_names_the_grid_item():
    """A bag of three atoms once raised, naming the grid engine's ROADMAP
    item; the grid multiway join now materializes it."""
    from repro_torch.core.gym import gym
    from repro_torch.core.queries import chain_ghd_grouped, chain_query

    data = {f"R{i}": np.array([[i, i + 1]], np.int32) for i in range(1, 5)}
    rows, _, led = gym(chain_query(4), data, ghd=chain_ghd_grouped(4, 3), p=2, device="cpu")
    assert rows.tolist() == [[1, 2, 3, 4, 5]] and led.output_tuples == 1
