"""The port's Mixture-of-Experts layer and its two dispatch routes on the
CPU against the JAX package.

The layer cases run reduced kimi-k2 (4 experts, top-2, a shared expert)
in f32 with ``capacity_factor = e`` so the dense route cannot drop, as
``tests/test_moe_routing.py`` does; its hot-expert case keeps the
config's 1.25.  The reference's ``init_moe`` / ``DecoderLM.init``
parameters are carried across as numpy (``interop.lm_params_from_numpy``
for whole models), and the inputs are made with numpy from a seed.

- routing decisions exactly (``flat_e``, ``flat_tok``), gate weights
  within 1e-6;
- plans (``e, k, tpp, cap_send, cap_recv, heavy``) and the routed,
  dropped and heavy counts exactly, on random, planted-hot and zipf-hot
  inputs and under a receive ceiling;
- layer outputs within 1e-5 (f32 on both sides, products and sums in
  another order), both routes;
- the reference's own scenarios (dense vs calibrated, the sound plan,
  the hot expert, the receive ceiling, the plan's hash, the ledger);
- loss gradients of both routes against the reference's (the calibrated
  route's two exchanges stop no gradient), one train step per route with
  ``moe_metrics`` against the reference's ``make_train_step`` (loss and
  metrics; parameters and state by ``tests/test_torch_train.py``'s step
  rule), ``accum=4``'s routed count;
- greedy ``generate`` per route: tokens equal, logits within the
  reference test's 5e-5 abs / 5e-4 rel; reduced grok-1's logits;
- MoE trees through ``lm_params_from_numpy``, Adafactor and checkpoints
  in both directions (f32: the reference cannot restore bf16 leaves);
- ``launch/serve.py`` and ``launch/train.py`` on both MoE archs.

The reference's results are computed once per module (fixtures).  The
reference's train step runs without its mesh placement, which fails on
the reference side for a reason that is not MoE's (ROADMAP C).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import CONFIGS as JCONFIGS  # noqa: E402
from repro.configs import get_model as jget_model  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.models import moe_routing as jmr  # noqa: E402
from repro.models.common import rms_norm as jrms_norm  # noqa: E402
from repro.models.mlp import init_moe as jinit_moe  # noqa: E402
from repro.models.mlp import moe_forward_stats as jmoe_forward_stats  # noqa: E402
from repro.relational import Ledger as JLedger  # noqa: E402
from repro.serve.decode import generate as jgenerate  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro.train import optim as joptim  # noqa: E402

from repro_torch.configs import get_config, get_model, reduced_config  # noqa: E402
from repro_torch.data.synthetic import zipf_hot_batch  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    checkpoint_from_reference, checkpoint_to_reference, lm_params_from_numpy,
    train_state_from_numpy,
)
from repro_torch.models import moe_routing as mr  # noqa: E402
from repro_torch.models.mlp import init_moe, moe_forward, moe_forward_stats  # noqa: E402
from repro_torch.relational.ledger import Ledger  # noqa: E402
from repro_torch.serve.decode import generate  # noqa: E402
from repro_torch.train import OptConfig, TrainConfig, init_train_state, make_train_step  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.step import state_tree  # noqa: E402

KIMI, GROK = "kimi-k2-1t-a32b", "grok-1-314b"
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
W_TOL = dict(atol=1e-6, rtol=0)
GEN_TOL = dict(atol=5e-5, rtol=5e-4)  # the reference's serving-route test
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)  # tests/test_torch_train.py
STEP_LR = 1e-3
STEP_FEW = (1e-3, 2 * STEP_LR + 1e-5)  # tests/test_torch_train.py's step rule
STATS = ("routed", "dropped", "heavy")
B, S = 2, 16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(arch=KIMI, no_drop=True):
    """(reference config, port config): reduced, f32, ``capacity_factor =
    e`` when ``no_drop``."""
    jcfg, cfg = jreduced(JCONFIGS[arch]), reduced_config(get_config(arch))
    if no_drop:
        jcfg = dataclasses.replace(jcfg, capacity_factor=float(jcfg.n_experts))
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    return jcfg, cfg


def _port_plan(plan) -> mr.MoEPlan:
    return mr.MoEPlan(**dataclasses.asdict(plan))


def _port_moe(cfg, tree):
    """The port's MoE parameters holding the reference's ``tree``."""
    p = init_moe(torch.Generator().manual_seed(0), cfg)
    with torch.no_grad():
        for name, t in p.named_parameters():
            leaf = tree
            for key in name.split("."):
                leaf = leaf[key]
            t.copy_(torch.from_numpy(np.array(leaf)))
    return p


def _stats(st):
    return {k: int(st[k]) for k in STATS}


def _random_x(d, seed, b=B, s=S):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _hot_x(d, b=2, s=32, seed=99):
    """Near-identical tokens: every token picks the same k experts (the
    reference's planted skew input)."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((1, 1, d)).astype(np.float32)
    return (base + 0.01 * rng.standard_normal((b, s, d))).astype(np.float32)


# ------------------------------------------------------------ the layer
_jlayer = jax.jit(jmoe_forward_stats, static_argnums=2)


class LayerCase:
    """One input through the reference layer: its routing decisions, plan
    and each route's output and stats."""

    def __init__(self, jcfg, cfg, p, tree, x, threshold=None, ceiling=None):
        self.jcfg, self.cfg, self.tree, self.x = jcfg, cfg, tree, x
        b, s, d = x.shape
        xj = jnp.asarray(x)
        xf = jrms_norm(xj, p["ln"], jcfg.norm_eps).reshape(b * s, d)
        self.xf = np.array(xf)
        self.pairs = [np.asarray(a) for a in jmr.router_pairs(p, xf, jcfg)]
        self.plan, self.info = jmr.calibrate_moe(p, xf, jcfg, threshold=threshold,
                                                 cap_recv_ceiling=ceiling)
        self.sound = jmr.MoEPlan.sound(b * s, jcfg.topk, jcfg.n_experts)
        self.out = {}
        for name, c in (("dense", jcfg), ("calibrated", jmr.apply_plan(jcfg, self.plan)),
                        ("sound", jmr.apply_plan(jcfg, self.sound))):
            y, st = _jlayer(p, xj, c)
            self.out[name] = (np.asarray(y), _stats(st))

    def port_cfg(self, route):
        plan = {"calibrated": self.plan, "sound": self.sound}.get(route)
        return self.cfg if plan is None else mr.apply_plan(self.cfg, _port_plan(plan))


@pytest.fixture(scope="module")
def layer_cases():
    jcfg, cfg = _cfgs()
    p = jinit_moe(jax.random.PRNGKey(0), jcfg)
    tree = _np(p)
    d = cfg.d_model
    hj, hc = _cfgs(no_drop=False)  # capacity factor 1.25
    hp = jinit_moe(jax.random.PRNGKey(5), hj)
    return {
        "random": LayerCase(jcfg, cfg, p, tree, _random_x(d, 1)),
        "hot": LayerCase(hj, hc, hp, _np(hp), _hot_x(d), threshold=1.5),
        "zipf": LayerCase(hj, hc, hp, _np(hp), zipf_hot_batch(cfg.n_experts, d, 2, 32),
                          threshold=1.5),
        "ceiling": LayerCase(jcfg, cfg, p, tree, _random_x(d, 7), threshold=1e9, ceiling=16),
    }


CASES = ["random", "hot", "zipf", "ceiling"]


@pytest.mark.parametrize("case", CASES)
def test_router_pairs_match_reference(layer_cases, case):
    c = layer_cases[case]
    got = mr.router_pairs(_port_moe(c.cfg, c.tree), torch.from_numpy(c.xf), c.cfg)
    want_e, want_w, want_tok = c.pairs
    assert np.array_equal(got[0].numpy(), want_e) and np.array_equal(got[2].numpy(), want_tok)
    np.testing.assert_allclose(got[1].numpy(), want_w, **W_TOL)


def test_router_ties_go_to_the_lower_expert():
    """Equal gates: the lower expert index first, as jax.lax.top_k."""
    _, cfg = _cfgs()
    p = {"router": torch.zeros((cfg.d_model, cfg.n_experts))}
    xf = torch.ones((3, cfg.d_model))
    flat_e, flat_w, _ = mr.router_pairs(p, xf, cfg)
    assert flat_e.tolist() == [0, 1] * 3
    np.testing.assert_allclose(flat_w.numpy(), 0.5, atol=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_calibrate_moe_matches_reference(layer_cases, case):
    c = layer_cases[case]
    th, ceil = {"hot": (1.5, None), "zipf": (1.5, None), "ceiling": (1e9, 16)}.get(case, (None, None))
    plan, info = mr.calibrate_moe(_port_moe(c.cfg, c.tree), torch.from_numpy(c.xf), c.cfg,
                                  threshold=th, cap_recv_ceiling=ceil)
    assert dataclasses.asdict(plan) == dataclasses.asdict(c.plan)
    assert np.array_equal(info["arrivals"], c.info["arrivals"])
    assert np.array_equal(info["out_counts"], np.asarray(c.info["out_counts"]))
    if case in ("hot", "zipf"):
        assert plan.heavy  # the hot experts were flagged
    if case == "ceiling":
        assert plan.cap_recv == 16 and not plan.heavy


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("route", ["dense", "calibrated", "sound"])
def test_layer_matches_reference(layer_cases, case, route):
    c = layer_cases[case]
    y, st = moe_forward_stats(_port_moe(c.cfg, c.tree), torch.from_numpy(c.x), c.port_cfg(route))
    want_y, want_st = c.out[route]
    assert _stats(st) == want_st
    np.testing.assert_allclose(y.numpy(), want_y, **LAYER_TOL)


# ---------------------------------------- the reference's scenarios, ported
def test_calibrated_matches_dense_when_no_drop(layer_cases):
    c = layer_cases["random"]
    p, x = _port_moe(c.cfg, c.tree), torch.from_numpy(c.x)
    yd, sd = moe_forward_stats(p, x, c.cfg)
    plan, _ = mr.calibrate_moe(p, torch.from_numpy(c.xf), c.cfg)
    yc, sc = moe_forward_stats(p, x, mr.apply_plan(c.cfg, plan))
    assert int(sd["dropped"]) == int(sc["dropped"]) == 0
    assert int(sc["routed"]) == int(sd["routed"]) == B * S * c.cfg.topk
    np.testing.assert_allclose(yd.numpy(), yc.numpy(), atol=2e-5, rtol=2e-5)
    assert torch.equal(moe_forward(p, x, mr.apply_plan(c.cfg, plan)), yc)


def test_sound_plan_needs_no_measure(layer_cases):
    c = layer_cases["random"]
    p, x = _port_moe(c.cfg, c.tree), torch.from_numpy(c.x)
    plan = mr.MoEPlan.sound(B * S, c.cfg.topk, c.cfg.n_experts)
    yd, _ = moe_forward_stats(p, x, c.cfg)
    yc, sc = moe_forward_stats(p, x, mr.apply_plan(c.cfg, plan))
    assert int(sc["dropped"]) == 0
    np.testing.assert_allclose(yd.numpy(), yc.numpy(), atol=2e-5, rtol=2e-5)


def _dense_expected_drops(flat_e, cfg, t):
    cap = max(1, int(cfg.capacity_factor * t * cfg.topk / cfg.n_experts))
    arr = np.bincount(flat_e, minlength=cfg.n_experts)
    return int(np.maximum(arr - cap, 0).sum()), arr


@pytest.mark.parametrize("case", ["hot", "zipf"])
def test_hot_expert_dense_drops_calibrated_does_not(layer_cases, case):
    c = layer_cases[case]
    p, x = _port_moe(c.cfg, c.tree), torch.from_numpy(c.x)
    t = c.xf.shape[0]
    flat_e = mr.router_pairs(p, torch.from_numpy(c.xf), c.cfg)[0].numpy()
    want_drop, arrivals = _dense_expected_drops(flat_e, c.cfg, t)
    assert want_drop > 0, arrivals
    _, sd = moe_forward_stats(p, x, c.cfg)
    assert int(sd["dropped"]) == want_drop
    assert int(sd["routed"]) == t * c.cfg.topk - want_drop
    plan, info = mr.calibrate_moe(p, torch.from_numpy(c.xf), c.cfg, threshold=1.5)
    assert plan.heavy, info
    _, sc = moe_forward_stats(p, x, mr.apply_plan(c.cfg, plan))
    assert int(sc["dropped"]) == 0 and int(sc["routed"]) == t * c.cfg.topk
    assert int(sc["heavy"]) >= int(arrivals[plan.heavy[0]])


def test_recv_ceiling_reports_exact_drops(layer_cases):
    c = layer_cases["ceiling"]
    p = _port_moe(c.cfg, c.tree)
    plan, _ = mr.calibrate_moe(p, torch.from_numpy(c.xf), c.cfg, threshold=1e9,
                               cap_recv_ceiling=16)
    flat_e = mr.router_pairs(p, torch.from_numpy(c.xf), c.cfg)[0].numpy()
    arr = np.bincount(flat_e, minlength=c.cfg.n_experts)
    want = int(np.maximum(arr - plan.cap_recv, 0).sum())
    assert want > 0, arr
    _, sc = moe_forward_stats(p, torch.from_numpy(c.x), mr.apply_plan(c.cfg, plan))
    assert int(sc["dropped"]) == want == c.out["calibrated"][1]["dropped"]


def test_plan_is_hashable_and_static():
    plan = mr.MoEPlan(e=4, k=2, tpp=8, cap_send=8, cap_recv=32, heavy=(1,))
    assert hash(plan) == hash(mr.MoEPlan(e=4, k=2, tpp=8, cap_send=8, cap_recv=32, heavy=(1,)))
    jplan = jmr.MoEPlan(e=4, k=2, tpp=8, cap_send=8, cap_recv=32, heavy=(1,))
    assert (plan.ret_cap_send, plan.ret_cap_recv) == (jplan.ret_cap_send, jplan.ret_cap_recv) == (16, 16)
    hash(mr.apply_plan(_cfgs()[1], plan))
    for t, k, e in ((64, 2, 4), (4096, 2, 8), (2, 2, 8), (4096, 8, 384)):
        assert dataclasses.asdict(mr.MoEPlan.sound(t, k, e)) == dataclasses.asdict(
            jmr.MoEPlan.sound(t, k, e))
    with pytest.raises(ValueError, match="plan sized"):
        mr._shard_pairs(mr.MoEPlan.sound(4, 2, 4), 8, torch.zeros(16, dtype=torch.long),
                        torch.zeros((16, 1)))


def test_calibration_ledger_record(layer_cases):
    """The ledger of one calibrated and one dense round equals the
    reference's, and so do both byte counts."""
    c = layer_cases["random"]
    d, t = c.cfg.d_model, c.xf.shape[0]
    sc, sd = c.out["calibrated"][1], c.out["dense"][1]
    led, jled = Ledger(), JLedger()
    mr.record_moe_round(led, sc, plan=_port_plan(c.plan), d=d, note="calibrated")
    mr.record_dense_round(led, sd, cfg=c.cfg, t=t, d=d, note="dense")
    jmr.record_moe_round(jled, sc, plan=c.plan, d=d, note="calibrated")
    jmr.record_dense_round(jled, sd, cfg=c.jcfg, t=t, d=d, note="dense")
    s = led.summary()
    assert s == jled.summary()
    assert s["comm_tuples"] == sc["routed"] + sd["routed"] and s["dropped_tuples"] == 0
    assert s["payload_bytes"] > 0 and s["useful_bytes"] > 0 and "heavy_dests" in s
    assert "Ledger(" in repr(led)
    for plan in (c.plan, c.sound):
        assert mr.calibrated_dispatch_bytes(_port_plan(plan), d) == jmr.calibrated_dispatch_bytes(plan, d)
    assert mr.dense_scatter_bytes(c.cfg, t, d) == jmr.dense_scatter_bytes(c.jcfg, t, d)


# ------------------------------------------------------------ the model
def _batch(cfg, seed, b=4, s=16):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab, (b, s)).astype(np.int32) for k in ("tokens", "targets")}


@pytest.fixture(scope="module")
def kimi():
    """Reduced kimi (f32, capacity factor e): the reference's params, one
    train step per route with moe_metrics, the dense loss gradients, and
    greedy ``generate`` per route."""
    jcfg, cfg = _cfgs()
    jm = jget_model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    batch = _batch(cfg, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    plan = jmr.MoEPlan.sound(4 * 16, jcfg.topk, jcfg.n_experts)
    jcm = jget_model(jmr.apply_plan(jcfg, plan))
    out = {"jcfg": jcfg, "cfg": cfg, "tree": _np(params), "batch": batch, "plan": plan}
    opt = joptim.OptConfig(lr=STEP_LR, warmup=1)
    state0 = joptim.opt_init(opt, params)
    for name, model in (("dense", jm), ("calibrated", jcm)):
        tcfg = JTrainConfig(opt=opt, moe_metrics=True)
        p1, s1, m = jax.jit(jmake_train_step(model, tcfg))(params, state0, jb)
        out[name] = (_np(p1), _np(s1), {k: np.asarray(v) for k, v in m.items()})
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(params, jb)
    out["grads"] = (float(loss), _np(grads))
    prompt = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 8)).astype(np.int32)
    gplan = jmr.MoEPlan.sound(2 * 8, jcfg.topk, jcfg.n_experts)
    out["prompt"], out["gen_plan"] = prompt, gplan
    for name, model in (("dense", jm), ("calibrated", jget_model(jmr.apply_plan(jcfg, gplan)))):
        toks, lg = jgenerate(model, params, jnp.asarray(prompt), steps=4, return_logits=True)
        out[f"gen_{name}"] = (np.asarray(toks), np.asarray(lg))
    return out


def _port_model(k, route="dense", plan=None):
    cfg = k["cfg"] if route == "dense" else mr.apply_plan(k["cfg"], _port_plan(plan or k["plan"]))
    model = get_model(cfg, "cpu")
    model.load_state_dict(lm_params_from_numpy(cfg, k["tree"]))
    return model


def test_moe_param_names_and_shapes(kimi):
    """``lm_params_from_numpy`` carries the nested shared expert
    (``moe.shared.*``) and every MoE leaf; the state dict is the port's
    own, name for name and shape for shape."""
    cfg = kimi["cfg"]
    sd = lm_params_from_numpy(cfg, kimi["tree"])
    model = get_model(cfg, "cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in sd.items()}
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    assert sd["layers.2.moe.wi"].shape == (e, d, f) and sd["layers.3.moe.wo"].shape == (e, f, d)
    assert sd["layers.2.moe.router"].shape == (d, e)
    assert {f"layers.3.moe.shared.{w}" for w in ("ln", "wg", "wi", "wo")} <= set(sd)
    assert np.array_equal(sd["layers.3.moe.shared.wg"].numpy(),
                          kimi["tree"]["segments"][1]["moe"]["shared"]["wg"][1])
    leaves = dict((names[0], (names, st)) for names, st in model.param_leaves())
    assert leaves["layers.2.moe.shared.wg"] == (("layers.2.moe.shared.wg", "layers.3.moe.shared.wg"), True)


@pytest.mark.parametrize("route", ["dense", "calibrated"])
def test_grads_match_reference(kimi, route):
    """Loss and every gradient of both routes against the reference's
    dense loss (equal on this no-drop input): the calibrated route's
    exchanges pass the gradient through."""
    want_l, want_g = kimi["grads"]
    want_g = lm_params_from_numpy(kimi["cfg"], want_g)
    model = _port_model(kimi, route)
    model.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in kimi["batch"].items()}
    loss, st = model.loss_and_stats(batch)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()], allow_unused=True)
    np.testing.assert_allclose(loss.item(), want_l, rtol=1e-5)
    assert _stats(st) == {"routed": 2 * 64 * 2, "dropped": 0, "heavy": 0}
    for k, g in zip(names, grads):
        if g is None:  # the shared expert's norm gain: the reference's grad is 0
            assert k.endswith("moe.shared.ln") and not want_g[k].any(), k
            continue
        np.testing.assert_allclose(g.numpy(), want_g[k].numpy(), err_msg=k, **GRAD_TOL)
    router = dict(zip(names, grads))["layers.2.moe.router"]
    assert float(router.abs().max()) > 0  # the gate weights carry a gradient back


def _assert_step(model, state, ptree, stree, cfg):
    """Parameters and optimizer state against the reference's trees: all
    but ``STEP_FEW[0]`` of the elements within GRAD_TOL, those within
    ``STEP_FEW[1]``."""
    want_p, want_s = train_state_from_numpy(cfg, ptree, stree)
    assert int(state["step"]) == int(want_s["step"])
    pairs = [(k, p.detach(), want_p[k]) for k, p in model.named_parameters()]
    for part in ("m", "v"):
        pairs += [(k, state[part][k], want_s[part][k]) for k in want_s[part]]
    bad = total = 0
    for k, got, exp in pairs:
        got, exp = got.float().numpy(), exp.float().numpy()
        bad += int((~np.isclose(got, exp, **GRAD_TOL)).sum())
        total += got.size
        assert np.abs(got - exp).max() <= STEP_FEW[1], k
    assert bad <= STEP_FEW[0] * total, (bad, total)


@pytest.mark.parametrize("route", ["dense", "calibrated"])
def test_train_step_matches_reference(kimi, route):
    ptree, stree, wm = kimi[route]
    tcfg = TrainConfig(opt=OptConfig(lr=STEP_LR, warmup=1), moe_metrics=True)
    model = _port_model(kimi, route)
    state = init_train_state(model, tcfg)
    m = make_train_step(model, tcfg)(state, {k: torch.from_numpy(v) for k, v in kimi["batch"].items()})
    assert m["loss"].item() == pytest.approx(float(wm["loss"]), rel=1e-5)
    assert m["grad_norm"].item() == pytest.approx(float(wm["grad_norm"]), rel=1e-4)
    n_moe = sum(1 for b in kimi["cfg"].blocks() if b == "moe")
    got = {k: int(m[f"moe_{k}"]) for k in STATS}
    assert got == {k: int(wm[f"moe_{k}"]) for k in STATS} == {
        "routed": 4 * 16 * 2 * n_moe, "dropped": 0, "heavy": 0}
    _assert_step(model, state, ptree, stree, kimi["cfg"])


def test_accumulation_carries_the_moe_counts(kimi):
    """accum=4 sums the four microbatches' counts: those of the reference's
    whole-batch step (the sound plan covers a microbatch too)."""
    tcfg = TrainConfig(opt=OptConfig(lr=STEP_LR, warmup=1), accum=4, moe_metrics=True)
    model = _port_model(kimi, "calibrated")
    state = init_train_state(model, tcfg)
    m = make_train_step(model, tcfg)(state, {k: torch.from_numpy(v) for k, v in kimi["batch"].items()})
    wm = kimi["calibrated"][2]
    assert {k: int(m[f"moe_{k}"]) for k in STATS} == {k: int(wm[f"moe_{k}"]) for k in STATS}
    assert m["loss"].item() == pytest.approx(float(wm["loss"]), rel=1e-5)


def test_train_step_refuses_a_parameter_the_loss_does_not_reach(kimi):
    """Only the shared expert's norm gain may come back without a
    gradient: any other such parameter (here one the loss never reads,
    as a detached payload would leave it) stops the step."""
    tcfg = TrainConfig(opt=OptConfig(lr=STEP_LR, warmup=1), moe_metrics=True)
    model = _port_model(kimi, "calibrated")
    model.layers[2].register_parameter("stray", torch.nn.Parameter(torch.zeros(3)))
    state = init_train_state(model, tcfg)
    step = make_train_step(model, tcfg)
    with pytest.raises(RuntimeError, match=r"does not reach \['layers\.2\.stray'\]"):
        step(state, {k: torch.from_numpy(v) for k, v in kimi["batch"].items()})


@pytest.mark.parametrize("route", ["dense", "calibrated"])
def test_generate_matches_reference(kimi, route):
    want_t, want_l = kimi[f"gen_{route}"]
    model = _port_model(kimi, route, plan=kimi["gen_plan"])
    toks, lg = generate(model, torch.from_numpy(kimi["prompt"]), steps=4, return_logits=True)
    assert np.array_equal(toks.numpy(), want_t)
    np.testing.assert_allclose(lg.numpy(), want_l, **GEN_TOL)


def test_with_config_shares_the_weights(kimi):
    """The calibrated route over the dense model's own tensors: no second
    copy, and the same tokens as a model loaded separately."""
    dense = _port_model(kimi)
    cal = dense.with_config(mr.apply_plan(dense.cfg, _port_plan(kimi["gen_plan"])))
    for (k, a), (_, b) in zip(dense.state_dict().items(), cal.state_dict().items()):
        assert a.data_ptr() == b.data_ptr(), k
    assert cal.device == dense.device and cal.layers[2].cfg.moe_route == "calibrated"
    toks = generate(cal, torch.from_numpy(kimi["prompt"]), steps=4)
    assert np.array_equal(toks.numpy(), kimi["gen_calibrated"][0])


def test_grok_forward_matches_reference():
    jcfg, cfg = _cfgs(GROK, no_drop=False)
    assert cfg.blocks() == ("moe", "moe") and not cfg.tie_embeddings and cfg.attn_softcap
    jm = jget_model(jcfg)
    params = jm.init(jax.random.PRNGKey(4))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    want = np.asarray(jax.jit(jm.logits)(params, jnp.asarray(tokens)))
    model = get_model(cfg, "cpu")
    model.load_state_dict(lm_params_from_numpy(cfg, _np(params)))
    np.testing.assert_allclose(model.logits(torch.from_numpy(tokens)).numpy(), want,
                               atol=1e-4, rtol=1e-4)


# ------------------------------------------------- optimizer, checkpoints
def test_adafactor_on_moe_leaves_matches_reference(kimi):
    """Adafactor factors the stacked ``(L, e, d, f)`` expert leaves and the
    ``(L, d, e)`` router as the reference does: parameters and state after
    two updates with the same numpy gradients within 1e-6."""
    kw = dict(kind="adafactor", lr=1e-2, warmup=1)
    jcfg, cfg = joptim.OptConfig(**kw), OptConfig(**kw)
    model = _port_model(kimi)
    params = dict(model.named_parameters())
    state = optim.opt_init(cfg, params, model.param_leaves())
    jp = jax.tree_util.tree_map(jnp.asarray, kimi["tree"])
    js = joptim.opt_init(jcfg, jp)
    jupd = jax.jit(lambda g, s, p: joptim.opt_update(jcfg, g, s, p))
    rng = np.random.default_rng(7)
    for _ in range(2):
        g = jax.tree_util.tree_map(
            lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32), kimi["tree"])
        jp, js = jupd(g, js, jp)
        optim.opt_update(cfg, lm_params_from_numpy(kimi["cfg"], g), state, params,
                         model.param_leaves())
    want_p, want_s = train_state_from_numpy(kimi["cfg"], _np(jp), _np(js))
    e, d, f = kimi["cfg"].n_experts, kimi["cfg"].d_model, kimi["cfg"].moe_d_ff
    assert state["f"]["layers.2.moe.wi"]["r"].shape == (e, d)
    assert state["f"]["layers.2.moe.wi"]["c"].shape == (e, f)
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), want_p[k].numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=k)
        for key, t in state["f"][k].items():
            np.testing.assert_allclose(t.numpy(), want_s["f"][k][key].numpy(), atol=1e-6,
                                       rtol=1e-6, err_msg=f"{k}/{key}")


def test_moe_checkpoints_both_ways(kimi, tmp_path):
    """The port's MoE train state (one dense step) through
    ``checkpoint_to_reference`` restores in the reference bit for bit, and
    the reference's step-1 state through ``checkpoint_from_reference``
    restores in the port bit for bit."""
    cfg, jcfg = kimi["cfg"], kimi["jcfg"]
    tcfg = TrainConfig(opt=OptConfig(lr=STEP_LR, warmup=1))
    model = _port_model(kimi)
    state = init_train_state(model, tcfg)
    make_train_step(model, tcfg)(state, {k: torch.from_numpy(v) for k, v in kimi["batch"].items()})
    src, dst = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save(src, 1, state_tree(model, state), extra={"next_step": 1})
    assert checkpoint_to_reference(cfg, src, dst) == 1
    jp = jax.tree_util.tree_map(jnp.asarray, kimi["tree"])
    like = {"params": jp, "opt": joptim.opt_init(joptim.OptConfig(), jp)}
    restored, extra = jckpt.restore(dst, like)
    assert extra == {"next_step": 1}
    want_p, want_s = train_state_from_numpy(cfg, _np(restored["params"]), _np(restored["opt"]))
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), want_p[k]), k
        assert torch.equal(state["m"][k], want_s["m"][k]) and torch.equal(state["v"][k], want_s["v"][k]), k
    # the reference's own step-1 state into the port
    ptree, stree, _ = kimi["dense"]
    jsrc, pdst = str(tmp_path / "ref1"), str(tmp_path / "port1")
    jckpt.save(jsrc, 1, {"params": ptree, "opt": stree}, extra={"next_step": 1})
    assert checkpoint_from_reference(cfg, jsrc, pdst) == 1
    fresh = get_model(cfg, "cpu")
    st = init_train_state(fresh, tcfg)
    got, _ = ckpt.restore(pdst, state_tree(fresh, st))
    want_p, want_s = train_state_from_numpy(cfg, ptree, stree)
    for k, t in got["params"].items():
        assert torch.equal(t, want_p[k]), k
    for k, t in got["opt"]["v"].items():
        assert torch.equal(t, want_s["v"][k]), k


# -------------------------------------------------------------- dtypes, CLI
def test_bf16_model_keeps_an_f32_router():
    cfg = dataclasses.replace(reduced_config(get_config(GROK)), dtype="bfloat16")
    model = get_model(cfg, "cpu")
    sd = model.state_dict()
    assert sd["layers.0.moe.router"].dtype == torch.float32
    assert sd["layers.0.moe.wi"].dtype == torch.bfloat16
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup=1), moe_metrics=True)
    state = init_train_state(model, tcfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=3, b=2, s=8).items()}
    m = make_train_step(model, tcfg)(state, batch)
    assert np.isfinite(m["loss"].item()) and int(m["moe_routed"]) + int(m["moe_dropped"]) == 2 * 8 * 2 * 2
    assert model.state_dict()["layers.0.moe.router"].dtype == torch.float32


@pytest.mark.parametrize("arch", [GROK, KIMI])
def test_serve_and_train_cli_on_moe_archs(arch, tmp_path, capsys):
    from repro_torch.launch import serve, train

    toks = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt", "8", "--steps", "3"])
    assert tuple(toks.shape) == (2, 3)
    run = train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
                      "--batch", "2", "--seq", "16", "--ckpt", str(tmp_path / "run")])
    assert len(run["losses"]) == 2 and all(np.isfinite(run["losses"]))
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "tok/s" in out and "[done]" in out
