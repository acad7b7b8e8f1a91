"""The one-card dry run (``repro_torch.launch.dryrun``) and roofline
(``repro_torch.launch.roofline``) against the reference's
(``repro.launch.dryrun``, ``repro.launch.roofline``), on the CPU:

- parameter counts and active parameter counts of every arch at full size
  (meta models against ``jax.eval_shape``), kimi-k2's shared experts by the
  port's rule (ROADMAP C, F5);
- every cell's argument bytes (parameters, optimizer state under
  ``_opt_for``, caches, batch) against the reference's sums over its
  ShapeDtypeStructs;
- the flash operator's flop formula under ``FlopCounterMode`` on ``meta``
  (registered by the dry run, not at the kernels' import), and
  ``visible_pairs`` in closed form against a numpy count;
- the peak tracker on a hand-reckoned chain of operators;
- ``run_cell`` on every reduced config, and the verdicts of three
  full-size cells (gemma2-9b's prefill flops, whisper-small ``decode_32k``
  does not fit, zamba2-7b ``long_500k`` fits); the CLI's result file.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import SHAPES as R_SHAPES  # noqa: E402
from repro.configs import cells as r_cells  # noqa: E402
from repro.configs import get_config as r_get_config  # noqa: E402
from repro.configs import get_model as r_get_model  # noqa: E402
from repro.configs import input_specs as r_input_specs  # noqa: E402
from repro.launch import roofline as r_rf  # noqa: E402
from repro.launch.dryrun import _opt_for as r_opt_for  # noqa: E402
from repro.train import TrainConfig as RTrainConfig  # noqa: E402
from repro.train import init_train_state_shapes as r_init_train_state_shapes  # noqa: E402

from repro_torch.configs import CONFIGS, SHAPES, cells, get_config, get_model, input_specs  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import roofline as rf  # noqa: E402
from repro_torch.train import TrainConfig, init_train_state  # noqa: E402

CELLS = list(cells())
ARCHS = list(CONFIGS)


def _sds_bytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
               for x in jax.tree_util.tree_leaves(tree) if hasattr(x, "shape"))


@pytest.fixture(scope="module")
def reference():
    """The reference's parameter shapes a arch and argument bytes a cell."""
    shapes, args = {}, {}
    for arch, shape in r_cells():
        cfg, model = r_get_config(arch), r_get_model(r_get_config(arch))
        if arch not in shapes:
            shapes[arch] = model.init_shapes()
        kind = R_SHAPES[shape][2]
        specs = r_input_specs(cfg, shape)
        if kind == "train":
            params, opt = r_init_train_state_shapes(model, RTrainConfig(opt=r_opt_for(arch), remat=True))
            args[arch, shape] = dict(params=_sds_bytes(params), opt_state=_sds_bytes(opt),
                                     batch=_sds_bytes(specs["batch"]))
        elif kind == "prefill":
            args[arch, shape] = dict(params=_sds_bytes(shapes[arch]), batch=_sds_bytes(specs["batch"]))
        else:
            args[arch, shape] = dict(params=_sds_bytes(shapes[arch]), caches=_sds_bytes(specs["caches"]),
                                     batch=_sds_bytes(specs["tokens"]))
    return shapes, args


@pytest.fixture(scope="module")
def port_params():
    return {a: dict(get_model(get_config(a), "meta").named_parameters()) for a in ARCHS}


def test_cells_match_the_reference():
    assert CELLS == list(r_cells()) and len(CELLS) == 32


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(reference, port_params, arch):
    assert rf.param_count(port_params[arch]) == r_rf.param_count(reference[0][arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_active_param_count(reference, port_params, arch):
    """Equal to the reference's, except that the port counts kimi-k2's
    always-active shared experts whole, where the reference scales them by
    topk / n_experts (F5): the difference is exactly their weights' share
    the reference drops."""
    cfg = get_config(arch)
    got = rf.active_param_count(cfg, port_params[arch])
    want = r_rf.active_param_count(r_get_config(arch), reference[0][arch])
    if not cfg.n_shared_experts:
        assert got == want
        return
    shared = [int(np.prod(leaf.shape)) for path, leaf in
              jax.tree_util.tree_flatten_with_path(reference[0][arch])[0]
              if "shared" in jax.tree_util.keystr(path)
              and jax.tree_util.keystr(path).split("'")[-2] in ("wi", "wg", "wo")]
    k, e = cfg.topk, cfg.n_experts
    assert arch == "kimi-k2-1t-a32b" and (k, e) == (8, 384) and shared
    assert got - want == sum(n - n * k // e for n in shared)
    assert got - want == pytest.approx(sum(shared) * (1 - k / e), abs=1.0)
    assert want == 30_805_591_040  # the reference's figure, F5


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}|{s}" for a, s in CELLS])
def test_argument_bytes_match_reference(reference, arch, shape):
    """Parameters, optimizer state, caches and batch, each storage once.
    The one difference: the reference's cache length is an int32 scalar
    on the device, the port's a Python int on the host."""
    cfg = get_config(arch)
    kind = SHAPES[shape][2]
    model = get_model(cfg, "meta")
    specs = input_specs(cfg, shape)
    got = {"params": D.storage_bytes(model.parameters())}
    if kind == "train":
        opt = init_train_state(model, TrainConfig(opt=D._opt_for(arch), remat=True))
        got.update(opt_state=D.storage_bytes(D.leaf_tensors(opt)),
                   batch=D.storage_bytes(D.leaf_tensors(specs["batch"])))
    elif kind == "prefill":
        got["batch"] = D.storage_bytes(D.leaf_tensors(specs["batch"]))
    else:
        assert isinstance(specs["caches"]["len"], int)
        got.update(caches=D.storage_bytes(D.leaf_tensors(specs["caches"])) + 4,
                   batch=D.storage_bytes([specs["tokens"]]))
    assert got == reference[1][arch, shape]


def _np_visible(sq, sk, causal, window):
    rows = np.arange(sq, dtype=np.int64)
    hi = np.minimum(sk, rows + 1) if causal else np.full(sq, sk, np.int64)
    lo = np.maximum(0, rows - window + 1) if window > 0 else np.zeros(sq, np.int64)
    return int(np.maximum(0, hi - lo).sum())


def test_visible_pairs_closed_form():
    sizes = (0, 1, 2, 3, 5, 17, 64, 100, 130)
    for sq in sizes:
        for sk in sizes:
            for causal in (True, False):
                for window in (0, 1, 2, 7, 37, 64, 200):
                    assert FA.visible_pairs(sq, sk, causal, window) == _np_visible(sq, sk, causal, window)
    for args in ((4608, 4608, True, 4096), (1, 32768, False, 0), (32768, 32768, True, 0)):
        assert FA.visible_pairs(*args) == _np_visible(*args)
    assert FA.visible_pairs(524288, 524288, True, 0) == 524288 * 524289 // 2


@pytest.mark.parametrize("sq,sk,causal,window,d", [
    (64, 64, True, 0, 64), (64, 64, True, 9, 128), (64, 64, False, 0, 256), (40, 96, True, 0, 64),
    (96, 40, False, 13, 128), (1, 300, False, 0, 64),
], ids=["causal", "window", "non_causal", "sq_lt_skv", "sq_gt_skv_window", "one_query"])
def test_flop_formula_on_meta(sq, sk, causal, window, d):
    """The wrapper on ``meta`` reaches the operator's fake once, and
    ``FlopCounterMode`` counts 4 B H D a visible pair; nothing launches."""
    from torch.utils.flop_counter import FlopCounterMode

    b, h, kvh = 2, 8, 4
    q = torch.empty((b, h, sq, d), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((b, kvh, sk, d), dtype=torch.bfloat16, device="meta")
    K.reset_launch_counts()
    tracker = D.StepTracker()
    with FlopCounterMode(display=False) as fc, tracker:
        out = K.attention(q, kv, kv, causal=causal, window=window, use_cuda=True)
    assert out.shape == q.shape and out.device.type == "meta" and out.dtype == q.dtype
    assert fc.get_total_flops() == 4 * b * h * d * _np_visible(sq, sk, causal, window)
    assert tracker.calls[D.FLASH_OP] == 1 and K.launch_counts()["flash_attention"] == 0


def test_meta_reaches_only_the_flash_operator():
    """``use_cuda=True`` accepts meta for attention (zamba2's D = 112 is
    padded to 128 in the wrapper, which the flop count sees) and the gym
    wrappers refuse it; CPU tensors are refused as before."""
    from torch.utils.flop_counter import FlopCounterMode

    q = torch.empty((1, 2, 16, 112), dtype=torch.bfloat16, device="meta")
    with FlopCounterMode(display=False) as fc:
        out = K.attention(q, q, q, causal=True, use_cuda=True)
    assert out.shape == q.shape and fc.get_total_flops() == 4 * 2 * 128 * _np_visible(16, 16, True, 0)
    keys = torch.empty((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        K.semijoin_probe(keys, keys, use_cuda=True)
    with pytest.raises(ValueError, match="CUDA"):
        K.attention(torch.zeros((1, 2, 4, 16)), torch.zeros((1, 1, 4, 16)),
                    torch.zeros((1, 1, 4, 16)), use_cuda=True)


def test_kernels_import_without_the_flop_counter():
    """Importing the kernels (as the trap check's child process and every
    serving process do) leaves ``torch.utils.flop_counter`` unimported; the
    dry run registers the flash formula when it is imported."""
    import os
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(__file__), "..", "src")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import repro_torch.kernels.ops; "
            "print('torch.utils.flop_counter' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code, src], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "False", out.stderr[-2000:]
    assert FA._flop_formula_registered


def test_peak_tracker_on_a_hand_reckoned_chain():
    """Arguments 4000 B; b = a * 2 (4000), c = b + 1 (4000), b dies, d =
    cat(c, c) (8000), then a view and an in-place op (no new storage),
    e = d.sum() (4): with no slack the peak is 4000 + 4000 + 8000 + 4
    (b died before the cat); and the bytes every operator but the view read
    and wrote.  With the default slack the recorded peak stays within it."""
    a = torch.empty(1000, device="meta")
    tracker = D.StepTracker(slack=0.0)
    assert tracker.start([a, a[:10]]) == 4000
    with tracker:
        b = a * 2
        c = b + 1
        del b
        d = torch.cat([c, c])
        d.view(2, 1000).add_(1)
        e = d.sum()
    assert tracker.peak == 16004
    assert tracker.bytes_accessed == (4000 + 4000) + (4000 + 4000) + (8000 + 8000) + (8000 + 8000) + (8000 + 4)
    del c, d, e
    tracker._sweep()
    assert tracker.current == 4000
    loose = D.StepTracker()
    loose.start([a])
    with loose:
        c = a + 1
        d = torch.cat([c, c])
        e = d.sum()
    assert 16004 / (1 + loose.slack) <= loose.peak <= 16004


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}|{s}" for a, s in CELLS])
def test_run_cell_on_reduced_configs(arch, shape):
    """Every cell's step on meta at a reduced config: ``ok``, the flash
    fake once per attention call in prefill, and flops at least the model
    flops.  At 1024 positions the attention's work covers what the
    model-flops convention counts for work a step does not run (the table
    at every prefill position, whisper's decoder in prefill and encoder in
    decode); xlstm-125m has no attention and takes 32 positions, its sLSTM
    running a step at a time."""
    cfg = reduced_config(get_config(arch))
    seq = 32 if arch == "xlstm-125m" else 1024
    rec = D.run_cell(arch, shape, {"cfg": cfg, "batch": 2, "seq": seq}, max_batch=False)
    assert rec["status"] == "ok" and rec["batch"] == 2 and rec["seq"] == seq
    assert rec["cost"]["flops"] >= rec["roofline"]["model_flops"] > 0
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] <= mem["peak_bytes"] and rec["fits"]
    attn = sum(k in ("attn", "local", "moe", "shared_attn") for k in cfg.blocks())
    if rec["kind"] == "prefill":
        assert rec["flash_calls"] == (cfg.enc_layers + cfg.n_layers if cfg.encdec else attn)
    elif rec["kind"] == "decode":
        assert rec["flash_calls"] == (cfg.n_layers if cfg.encdec else 0)
    else:
        assert rec["flash_calls"] == 0


def test_gemma2_prefill_flops_count_the_kernel_not_the_plain_loop(monkeypatch):
    """gemma2-9b ``prefill_32k`` at batch 1 on meta with the 'cuda'
    backend: the flash fake once a layer, the plain version never, and
    flops within 1% of the hand count (the layers' 2 (N - d V) a token,
    the last position's logits, the formula over 21 causal and 21
    window-4096 layers)."""
    def refuse(*a, **k):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(FA, "flash_attention_plain", refuse)
    cfg = get_config("gemma2-9b")
    rec = D.run_cell("gemma2-9b", "prefill_32k", {"batch": 1}, max_batch=False)
    s, d, v = 32768, cfg.d_model, cfg.vocab
    attn = sum(4 * cfg.n_heads * cfg.hd * FA.visible_pairs(s, s, True, cfg.window if k == "local" else 0)
               for k in cfg.blocks())
    hand = 2 * (rec["n_params"] - d * v) * s + 2 * d * v + attn
    assert rec["flash_calls"] == 42 and cfg.blocks().count("local") == 21
    assert abs(rec["cost"]["flops"] / hand - 1) < 1e-2
    assert rec["cost"]["flops"] < 1e15  # not the plain loop's 1284 TFLOP


def test_whisper_decode_32k_does_not_fit_and_its_max_batch():
    """128 sequences of 32768 frames' cross caches take 154.6 GB; the
    card holds 48 at 0.69-0.71 of its memory (``chip_smoke.py``'s (c)),
    and batch 64 was reckoned at 0.92."""
    rec = D.run_cell("whisper-small", "decode_32k")
    assert not rec["fits"] and 48 <= rec["max_batch"] <= 63
    assert rec["memory"]["argument_bytes"]["caches"] > 150e9


def test_zamba2_long_500k_fits():
    rec = D.run_cell("zamba2-7b", "long_500k")
    assert rec["fits"] and rec["max_batch"] == 1 and rec["flash_calls"] == 0
    assert rec["memory"]["peak_bytes"] <= D.FIT_SHARE * rf.HBM_BYTES


def test_cli_accumulates_results(tmp_path, capsys):
    out = tmp_path / "dryrun.json"
    argv = ["--arch", "xlstm-125m", "--shape", "decode_32k", "--out", str(out)]
    D.main(argv)
    rec = json.loads(out.read_text())["xlstm-125m|decode_32k"]
    assert rec["status"] == "ok" and rec["chips"] == 1 and rec["fits"]
    assert set(rec["roofline"]) >= {"compute_s", "memory_s", "dominant", "bound_s", "model_flops",
                                    "useful_flops_frac", "roofline_frac"}
    D.main(argv)
    assert "[skip] xlstm-125m|decode_32k" in capsys.readouterr().out
    D.main(argv + ["--force"])
    assert "[done] xlstm-125m|decode_32k" in capsys.readouterr().out


def test_roofline_terms():
    t = rf.roofline_terms(989e12, 3.35e12 * 0.5, model_flops=494.5e12)
    assert t["compute_s"] == pytest.approx(1.0) and t["memory_s"] == pytest.approx(0.5)
    assert t["dominant"] == "compute_s" and t["bound_s"] == pytest.approx(1.0)
    assert t["useful_flops_frac"] == pytest.approx(0.5) and t["roofline_frac"] == pytest.approx(0.5)
    assert rf.model_flops_train(10, 3) == 180.0 and rf.model_flops_decode(10, 3) == 60.0


def test_roofline_collective_term():
    """On a mesh the flops, bytes and collective bytes are global (one
    rank's times ``chips``), each term over ``chips`` times its rate; the
    collective term's rate is ``LINK_BW``."""
    chips = 4
    t = rf.roofline_terms(989e12 * chips, 3.35e12 * chips * 0.5, rf.LINK_BW * chips * 2.0, chips)
    assert t["compute_s"] == pytest.approx(1.0) and t["memory_s"] == pytest.approx(0.5)
    assert t["collective_s"] == pytest.approx(2.0)
    assert t["dominant"] == "collective_s" and t["bound_s"] == pytest.approx(2.0)
    assert rf.roofline_terms(989e12, 0.0)["collective_s"] == 0.0
