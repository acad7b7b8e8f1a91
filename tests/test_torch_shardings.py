"""The port's LM mesh layer (``repro_torch.launch.mesh``' LM meshes,
``repro_torch.launch.shardings``) and the dry run's per-device bytes
(``repro_torch.launch.dryrun --mesh``) against the reference's
(``repro.launch.mesh``, ``repro.launch.shardings``), on the CPU, with no
rank and no device:

- every leaf's spec of every config of ``CONFIGS`` at full width, on
  ``(16, 16)``, ``(2, 16, 16)``, ``(2, 2)``, ``(1, 4)`` and ``(4, 1)``:
  parameters (with and without ``serve_tp_only``), AdamW's and
  Adafactor's state, each cell's batch, decode tokens and caches.  The
  reference runs its own rules in-process on a
  ``jax.sharding.AbstractMesh`` over ``init_shapes`` and ShapeDtypeStructs;
  the port's leaf is one layer of the reference's stacked leaf, so the
  reference's spec is compared with its stack dim dropped.  The one
  difference is F6 (ROADMAP C): on kimi-k2's shared expert the reference
  shards the stack's layer axis wherever ``"model"`` divides its 60
  layers, and the port keeps the other dims' placements;
- the stacked sLSTM ``r`` (the rule reads the stacked shape);
- ``placements`` of a spec, ``dp_axes``, the production mesh shapes,
  ``constrain`` on a plain tensor (on a DTensor: ``test_torch_lm_mesh.py``);
- every cell's per-device argument bytes on ``single`` and ``multi``
  against the sum of shard bytes under the reference's specs, and the
  CLI's ``--mesh`` keys.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import SHAPES as R_SHAPES  # noqa: E402
from repro.configs import get_config as r_get_config  # noqa: E402
from repro.configs import get_model as r_get_model  # noqa: E402
from repro.configs import input_specs as r_input_specs  # noqa: E402
from repro.launch import mesh as r_mesh  # noqa: E402
from repro.launch import shardings as RSH  # noqa: E402
from repro.launch.dryrun import _opt_for as r_opt_for  # noqa: E402
from repro.train import OptConfig as ROptConfig  # noqa: E402
from repro.train import TrainConfig as RTrainConfig  # noqa: E402
from repro.train import init_train_state_shapes as r_init_train_state_shapes  # noqa: E402

from repro_torch.configs import CONFIGS, cells, get_model, input_specs  # noqa: E402
from repro_torch.interop import _at, _lm_paths  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import shardings as SH  # noqa: E402
from repro_torch.launch.mesh import MeshShape, dp_axes, production_mesh_shape  # noqa: E402
from repro_torch.train import OptConfig, TrainConfig, init_train_state  # noqa: E402

ARCHS = list(CONFIGS)
CELLS = list(cells())
MESHES = [(16, 16), (2, 16, 16), (2, 2), (1, 4), (4, 1)]
KIMI = "kimi-k2-1t-a32b"


def _names(sizes):
    return ("pod", "data", "model") if len(sizes) == 3 else ("data", "model")


def _pair(sizes):
    return AbstractMesh(sizes, _names(sizes)), MeshShape(_names(sizes), sizes)


class Arch:
    """One config in both packages, shapes only: the reference's
    ``init_shapes`` and optimizer states, the port's meta model and its
    optimizer states, and each cell's inputs."""

    def __init__(self, arch: str):
        self.cfg = CONFIGS[arch]
        rm = r_get_model(r_get_config(arch))
        self.rparams = rm.init_shapes()
        self.ropt = {k: r_init_train_state_shapes(rm, RTrainConfig(opt=ROptConfig(kind=k)))[1]
                     for k in ("adamw", "adafactor")}
        # the dry run's optimizer (bf16 AdamW moments, or Adafactor)
        dry = r_opt_for(arch)
        self.rdry = (self.ropt["adafactor"] if dry.kind == "adafactor" else
                     r_init_train_state_shapes(rm, RTrainConfig(opt=dry, remat=True))[1])
        model = get_model(self.cfg, "meta")
        self.params = dict(model.named_parameters())
        self.opt = {k: init_train_state(model, TrainConfig(opt=OptConfig(kind=k)))
                    for k in ("adamw", "adafactor")}
        self.cells = [s for a, s in CELLS if a == arch]
        self.rin = {s: r_input_specs(r_get_config(arch), s) for s in self.cells}
        self.pin = {s: input_specs(self.cfg, s) for s in self.cells}


@pytest.fixture(scope="module")
def archs():
    return {}


def _arch(archs, arch) -> Arch:
    if arch not in archs:
        archs[arch] = Arch(arch)
    return archs[arch]


class Diff:
    """The port's spec of a leaf against the reference's, whose stack dim
    (one more dim than the port's leaf) is dropped; F6 collects the leaves
    where the reference shards that dim."""

    def __init__(self):
        self.bad, self.f6 = [], []

    def __call__(self, what, got, ref, nd):
        ref = tuple(ref)
        if len(ref) == nd + 1:
            if ref[0] is not None:
                self.f6.append(what)
            ref = ref[1:]
        if tuple(got) != ref:
            self.bad.append((what, ref, got))


@pytest.mark.parametrize("sizes", MESHES, ids=["x".join(map(str, m)) for m in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(archs, arch, sizes):
    a = _arch(archs, arch)
    cfg = a.cfg
    am, ms = _pair(sizes)
    diff = Diff()
    for tp_only in (False, True):
        want = RSH.param_specs(a.rparams, am, serve_tp_only=tp_only)
        got = SH.param_specs(cfg, a.params, ms, serve_tp_only=tp_only)
        assert set(got) == set(a.params)
        for name, path, _ in _lm_paths(cfg, a.rparams):
            diff(("params", tp_only, name), got[name], _at(want, path), a.params[name].dim())
    for kind, opt in a.opt.items():
        ropt = a.ropt[kind]
        want = RSH.opt_state_specs(ropt, None, am)
        got = SH.opt_state_specs(cfg, opt, ms)
        assert tuple(want["step"]) == got["step"] == ()
        for part in ("m", "v"):
            if part in ropt:
                for name, path, _ in _lm_paths(cfg, ropt[part]):
                    diff((part, name), got[part][name], _at(want[part], path), opt[part][name].dim())
        if "f" in ropt:
            for name, path, _ in _lm_paths(cfg, a.rparams):
                for j, t in opt["f"][name].items():
                    diff(("f", name, j), got["f"][name][j], _at(want["f"], path)[j], t.dim())
    for shape in a.cells:
        rin, pin = a.rin[shape], a.pin[shape]
        if "batch" in rin:
            want = RSH.batch_specs(rin["batch"], am)
            got = SH.batch_specs(pin["batch"], ms)
            assert set(got) == set(want)
            for k in want:
                diff((shape, k), got[k], want[k], pin["batch"][k].dim())
            continue
        diff((shape, "tokens"), SH.batch_specs({"t": pin["tokens"]}, ms)["t"],
             RSH.batch_specs({"t": rin["tokens"]}, am)["t"], 1)
        want = RSH.cache_specs(rin["caches"], am)
        got = SH.cache_specs(cfg, pin["caches"], ms)
        assert tuple(want["len"]) == got["len"] == ()
        if "layers" not in got:  # whisper's caches are stacked in both packages
            for part in ("cross", "self"):
                for k, t in pin["caches"][part].items():
                    diff((shape, part, k), got[part][k], want[part][k], t.dim())
            continue
        i = 0
        for s, (_, count) in enumerate(cfg.segments()):
            for _ in range(count):
                for k, t in pin["caches"]["layers"][i].items():
                    diff((shape, i, k), got["layers"][i][k], want["segments"][s][k], t.dim())
                i += 1
        assert i == len(got["layers"])
    assert not diff.bad, diff.bad[:5]
    # F6: kimi-k2's shared expert, wherever 'model' divides its 60 stacked layers
    want_f6 = set()
    if arch == KIMI and 60 % dict(ms.shape)["model"] == 0:
        shared = [n for n in a.params if ".moe.shared.w" in n]
        want_f6 = ({("params", tp, n) for n in shared for tp in (False, True)}
                   | {(part, n) for n in shared for part in ("m", "v")})
    assert set(diff.f6) == want_f6


def test_f6_kimi_shared_expert_layer_axis(archs):
    """F6 pinned: on (2, 2) the reference places kimi-k2's stacked shared
    expert ``wg (60, 7168, 2048)`` as ``P('model', 'data', None)``, its
    layer axis as if it held experts; the port keeps ``('data', None)``.
    On (16, 16), where 16 does not divide 60, both take the Megatron
    branch."""
    a = _arch(archs, KIMI)
    path = ("segments", 1, "moe", "shared", "wg")
    assert tuple(_at(a.rparams, path).shape) == (60, 7168, 2048)
    name = "layers.1.moe.shared.wg"
    for sizes, ref, port in (((2, 2), ("model", "data", None), ("data", None)),
                             ((16, 16), (None, "data", "model"), ("data", "model"))):
        am, ms = _pair(sizes)
        assert tuple(_at(RSH.param_specs(a.rparams, am), path)) == ref
        assert SH.param_specs(a.cfg, {name: a.params[name]}, ms)[name] == port


def test_stacked_slstm_r_replicates(archs):
    """xlstm-125m's sLSTM ``r`` is ``(1, 4, 192, 768)`` stacked: the
    ``nd == 3`` rule never matches it and 192 x 768 < 2**20, so the
    reference replicates it.  The port's per-layer ``(4, 192, 768)`` leaf
    is judged on that stacked shape and replicates too, where the rule on
    the per-layer shape would shard its heads on 'model'."""
    a = _arch(archs, "xlstm-125m")
    am, ms = _pair((2, 2))
    path = ("segments", 1, "slstm", "r")
    assert tuple(_at(a.rparams, path).shape) == (1, 4, 192, 768)
    assert tuple(_at(RSH.param_specs(a.rparams, am), path)) == (None,) * 4
    name = "layers.3.slstm.r"
    assert tuple(a.params[name].shape) == (4, 192, 768)
    assert SH.param_specs(a.cfg, {name: a.params[name]}, ms)[name] == (None,) * 3
    assert SH.param_spec(path[2:], (4, 192, 768), ms) == ("model", None, None)


def test_mesh_shapes_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    single, multi = production_mesh_shape(), production_mesh_shape(multi_pod=True)
    for ms, sizes in ((single, (16, 16)), (multi, (2, 16, 16))):
        am = AbstractMesh(sizes, _names(sizes))
        assert ms.axis_names == tuple(am.axis_names) and dict(ms.shape) == dict(am.shape)
        assert dp_axes(ms) == r_mesh.dp_axes(am)
    assert (single.size, multi.size) == (256, 512)
    assert SH.placements((("pod", "data"), "model"), multi) == (Shard(0), Shard(0), Shard(1))
    assert SH.placements((None, "data"), single) == (Shard(1), Replicate())
    assert SH.placements((), single) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="out of the mesh's order"):
        SH.placements((("data", "pod"),), multi)
    assert SH.shard_shape((64, 48, 7), (("pod", "data"), "model"), multi) == (2, 3, 7)


def test_constrain_is_a_no_op_off_a_mesh():
    x = torch.randn(8, 4)
    assert SH.constrain(x, ("pod", "data"), "model") is x
    assert SH.constrain(x) is x


def _ref_shard_bytes(tree, specs, am) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    sp = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(sp)
    total = 0
    for leaf, spec in zip(leaves, sp):
        spec = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        n = 1
        for dim, entry in zip(leaf.shape, spec):
            assert dim % RSH._axsize(am, entry) == 0
            n *= dim // RSH._axsize(am, entry)
        total += n * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}|{s}" for a, s in CELLS])
def test_dryrun_per_device_bytes_match_reference(archs, arch, shape):
    """Each part's per-device bytes on ``single`` and ``multi``, from the
    port's placements, equal the sum of shard bytes under the reference's
    specs of the reference's own trees (train: ``_opt_for``'s state)."""
    a = _arch(archs, arch)
    kind = R_SHAPES[shape][2]
    rin = a.rin[shape]
    got = D.mesh_cells(arch, shape, ["single", "multi"])
    for m, sizes in (("single", (16, 16)), ("multi", (2, 16, 16))):
        am = AbstractMesh(sizes, _names(sizes))
        if kind == "train":
            opt = a.rdry
            want = {"params": _ref_shard_bytes(a.rparams, RSH.param_specs(a.rparams, am), am),
                    "opt_state": _ref_shard_bytes(opt, RSH.opt_state_specs(opt, None, am), am),
                    "batch": _ref_shard_bytes(rin["batch"], RSH.batch_specs(rin["batch"], am), am)}
        else:
            pbytes = sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
                         for x in jax.tree_util.tree_leaves(a.rparams))
            tp_only = pbytes // am.shape["model"] <= 8 << 30
            want = {"params": _ref_shard_bytes(
                a.rparams, RSH.param_specs(a.rparams, am, serve_tp_only=tp_only), am)}
            assert got[m]["serve_tp_only"] == tp_only
            if kind == "prefill":
                want["batch"] = _ref_shard_bytes(rin["batch"], RSH.batch_specs(rin["batch"], am), am)
            else:
                tok = {"t": rin["tokens"]}
                want["caches"] = _ref_shard_bytes(rin["caches"], RSH.cache_specs(rin["caches"], am), am)
                want["batch"] = _ref_shard_bytes(tok, RSH.batch_specs(tok, am), am)
        rec = got[m]
        assert rec["memory"]["argument_bytes_per_device"] == want, m
        assert rec["memory"]["argument_size_in_bytes"] == sum(want.values())
        assert (rec["chips"], rec["mesh"]) == (am.size, m)
        assert rec["fits"] == (sum(want.values()) <= D.FIT_SHARE * D.rf.HBM_BYTES)


def test_cli_mesh_keys(tmp_path, capsys):
    out = tmp_path / "dry.json"
    D.main(["--arch", "smollm-360m", "--shape", "decode_32k", "--mesh", "both", "--out", str(out)])
    db = json.loads(out.read_text())
    assert set(db) == {"smollm-360m|decode_32k|single", "smollm-360m|decode_32k|multi"}
    assert [db[k]["chips"] for k in sorted(db)] == [512, 256]
    assert "argument_bytes_per_device=" in capsys.readouterr().out
    D.main(["--arch", "smollm-360m", "--shape", "decode_32k", "--mesh", "single", "--out", str(out)])
    assert "[skip] smollm-360m|decode_32k|single" in capsys.readouterr().out
