"""Dry run: trace every (architecture x input shape) cell's step on
``meta`` tensors and record whether it fits one H100, its flops and
bytes, its roofline bound and the share of it that is model flops, or,
on the reference's production meshes, each device's share of the step's
arguments (counterpart of ``repro/launch/dryrun.py``):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --cells all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b --shape prefill_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both --cells all

It runs on the CPU and needs no card: a model built on ``meta`` holds
shapes and dtypes only, and the step runs its real code path eagerly on
them, the ``'cuda'`` backend included, whose flash attention reaches the
operator's fake (``kernels/flash_attention.py``).  Results accumulate,
crash-safe, in ``dryrun_results_torch.json`` at the repo root (``--out``),
keyed ``arch|shape`` (``arch|shape|single`` on a mesh); an ``ok`` cell is
skipped unless ``--force``.

``--mesh``: ``one`` (the default) is the one-card run below; ``single``
and ``multi`` (``both``: the two) run the reference's ``run_cell(arch,
shape, mesh_kind)`` on the ``(16, 16)`` or ``(2, 16, 16)`` production
mesh (``mesh_cell``):

- each cell's **per-device** argument bytes: parameters, optimizer
  state, batch and caches, each leaf its shard under
  ``launch/shardings.py``'s placements (a prefill or decode cell's
  parameters TP-only when the model fits 8 GiB a ``"model"`` shard, as in
  the reference), and ``args_fit``, those bytes at most ``FIT_SHARE`` of
  ``HBM_BYTES`` (``mesh_cells``: arithmetic on shapes, no rank);
- a trace of **rank 0** of the partitioned step on ``meta`` under a fake
  process group of 256 or 512 ranks (``launch/mesh.py::fake_mesh``):
  train, ``make_mesh_train_step``'s ``on_slices``; prefill and decode,
  ``serve/mesh.py::MeshServer`` on the serving placements, the KV caches
  under ``cache_spec``.  It records the per-device reckoned peak
  (``StepTracker``, as below) and ``fits`` on it, flops and bytes
  accessed, the collective bytes by kind and mesh axis
  (``shardings.counting``) and their global totals (x chips, as the
  reference's ``dryrun.py:146-152``), the three roofline terms, and the
  leaves gathered whole over ``"model"`` (a split that is not
  head-aligned, or a block that computes replicated).

What a cell runs (``run_cell``): train, ``make_train_step`` under
``TrainConfig(opt=_opt_for(arch), remat=True)`` on ``input_specs``'
batch, with the backend the card's training takes (the flash kernel has
no backward: the chunked scan at 2048 keys and more); prefill,
``model.prefill(batch)``; decode, ``model.decode_step(caches, tokens)``.
``overrides`` may set ``batch``, ``seq``, ``s_cache`` (prefill's KV cache),
``tcfg`` (a ``TrainConfig``) and ``cfg`` (an ``ArchConfig`` in place of
the arch's, for reduced configs).

What it records, and where it comes from (``StepTracker``, a
``TorchDispatchMode``, under ``FlopCounterMode``):

- ``memory``: the argument bytes (parameters, optimizer state, caches,
  batch: each storage once), the output bytes, and the **reckoned peak**:
  the arguments plus every storage an operator makes, each counted from
  its operator until it dies (``StorageWeakRef``), plus the known
  temporaries a kernel makes inside one operator (``HIDDEN_TEMPS``), which
  no meta operator shows;
- ``cost``: ``flops`` as ``FlopCounterMode`` counts them (matrix products,
  SDPA and the flash operator's formula; no element-wise work, unlike
  XLA's count), and ``bytes accessed``, the sum of every dispatched
  operator's input and output bytes except views: the eager program's
  traffic, which exceeds XLA's count over fused kernels;
- ``roofline`` on one H100 (``launch/roofline.py``), ``fits`` (the peak at
  most ``FIT_SHARE`` of ``HBM_BYTES``) and ``max_batch``, the largest batch
  up to the cell's own that fits: from the peak's line through batch 1
  and the cell's batch, confirmed by a run at that batch.

"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback
from collections import Counter
from typing import Any, Dict, Iterable, Optional, Sequence

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import SHAPES, cells, get_config, get_model, input_specs
from ..kernels import flash_attention as _fa
from ..train import OptConfig, TrainConfig, init_train_state, make_train_step
from . import roofline as rf
from . import shardings as sh
from .mesh import fake_mesh, production_mesh_shape

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..", "dryrun_results_torch.json")
#: the share of the card a cell's peak may take (the chip phases' rule,
#: ``chip_smoke.py``'s SERVE_PEAK_SHARE_MAX and LONG_PEAK_SHARE_MAX)
FIT_SHARE = 0.9
FLASH_OP = torch.ops.repro_torch.flash_attention.default  # registered by _fa
_fa.register_flop_formula()
#: temporaries a kernel allocates inside one operator, which meta tensors
#: do not show, by operator: ``logsumexp`` forms ``(x - max).exp_()`` at
#: its input's size (ATen's ``logsumexp_out_impl``)
HIDDEN_TEMPS = {
    torch.ops.aten.logsumexp.default: lambda args: _nbytes(args[0]),
}


def _opt_for(arch: str) -> OptConfig:
    # factored second moment for the giant MoEs (state memory), AdamW else
    if arch in ("kimi-k2-1t-a32b", "grok-1-314b"):
        return OptConfig(kind="adafactor")
    return OptConfig(kind="adamw", moments_dtype="bfloat16")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def leaf_tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def storage_bytes(tensors: Iterable[torch.Tensor]) -> int:
    """Bytes of the distinct storages under ``tensors`` (views and shared
    tensors count once)."""
    seen: Dict[int, int] = {}
    for t in tensors:
        st = t.untyped_storage()
        seen.setdefault(StorageWeakRef(st).cdata, st.nbytes())
    return sum(seen.values())


class StepTracker(TorchDispatchMode):
    """Live bytes, their peak, the bytes operators read and write, and the
    calls of each operator, over the operators dispatched inside it.

    ``start(tensors)`` counts the arguments' storages as live.  Each
    operator's new output storages join the live set; a storage leaves it
    when it dies (its ``StorageWeakRef`` expires).  No hook reports a
    storage's death, so dead storages are swept (each live storage asked
    once) only when the running count, which still holds the dead ones,
    passes the peak by more than ``slack`` of it: the recorded peak is a
    swept, exact count, at least ``1 / (1 + slack)`` of the true peak, and
    a step whose memory grows steadily sweeps about ``ln(growth) /
    slack`` times instead of once an operator."""

    def __init__(self, slack: float = 1e-3):
        super().__init__()
        self.slack = slack
        self.live: Dict[int, tuple] = {}
        self.current = 0
        self.peak = 0
        self.bytes_accessed = 0
        self.calls: Counter = Counter()

    def start(self, tensors: Iterable[torch.Tensor]) -> int:
        """Count ``tensors``' storages as live; returns their bytes."""
        before = self.current
        self._add(tensors)
        self.peak = max(self.peak, self.current)
        return self.current - before

    def _add(self, tensors: Iterable[torch.Tensor]) -> None:
        for t in tensors:
            st = t.untyped_storage()
            ref = StorageWeakRef(st)
            if ref.cdata not in self.live:
                nb = st.nbytes()
                self.live[ref.cdata] = (ref, nb)
                self.current += nb

    def _sweep(self) -> None:
        dead = [k for k, (ref, _) in self.live.items() if ref.expired()]
        for k in dead:
            self.current -= self.live.pop(k)[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.calls[func] += 1
        outs = leaf_tensors(out)
        if not func.is_view:
            self.bytes_accessed += sum(map(_nbytes, leaf_tensors((args, kwargs)))) + sum(map(_nbytes, outs))
        self._add(outs)
        hidden = HIDDEN_TEMPS[func](args) if func in HIDDEN_TEMPS else 0
        if self.current + hidden > self.peak * (1.0 + self.slack):
            self._sweep()
            self.peak = max(self.peak, self.current + hidden)
        return out


def _step(model, cfg, kind: str, shape: str, b: int, s: int, s_cache: Optional[int],
          tcfg: Optional[TrainConfig]):
    """(the step as a function of nothing, its arguments by part)."""
    specs = input_specs(cfg, shape, batch=b, seq=s)
    params = list(model.parameters())
    if kind == "train":
        opt = init_train_state(model, tcfg)
        step = make_train_step(model, tcfg)
        batch = specs["batch"]
        return (lambda: step(opt, batch)), {"params": params, "opt_state": leaf_tensors(opt),
                                             "batch": leaf_tensors(batch)}
    if kind == "prefill":
        batch = specs["batch"]
        kw = {} if s_cache is None else {"s_cache": s_cache}
        return (lambda: model.prefill(batch, **kw)), {"params": params, "batch": leaf_tensors(batch)}
    caches, tokens = specs["caches"], specs["tokens"]
    return (lambda: model.decode_step(caches, tokens)), {
        "params": params, "caches": leaf_tensors(caches), "batch": [tokens]}


def _trace(arch: str, shape: str, cfg, b: int, s: int, s_cache, tcfg) -> Dict:
    """One traced step of the cell at batch ``b``: the raw counts."""
    _, _, kind = SHAPES[shape]
    model = get_model(cfg, "meta", backend=None if kind == "train" else "cuda")
    run, parts = _step(model, cfg, kind, shape, b, s, s_cache, tcfg)
    arg_bytes = {k: storage_bytes(v) for k, v in parts.items()}
    tracker = StepTracker()
    gc_was = gc.isenabled()
    gc.disable()  # the cyclic collector's passes over a trace's many objects cost a quarter of it
    t0 = time.perf_counter()
    try:
        with FlopCounterMode(display=False) as flops, tracker:
            tracker.start(t for v in parts.values() for t in v)
            del parts
            out = run()
    finally:
        if gc_was:
            gc.enable()
    trace_s = time.perf_counter() - t0
    named = dict(model.named_parameters())
    return dict(
        named=named, trace_s=trace_s, arg_bytes=arg_bytes,
        out_bytes=storage_bytes(leaf_tensors(out)), peak=tracker.peak,
        flops=float(flops.get_total_flops()), bytes_accessed=float(tracker.bytes_accessed),
        flash_calls=tracker.calls[FLASH_OP],
    )


def run_cell(arch: str, shape: str, overrides: Optional[Dict] = None, *,
             max_batch: bool = True) -> Dict:
    """The dry-run record of one cell (see the module doc); ``max_batch``
    False skips the batch search (``max_batch`` is then None unless the
    cell fits)."""
    ov = dict(overrides or {})
    cfg = ov.pop("cfg", None) or get_config(arch)
    s, b, kind = SHAPES[shape]
    b, s = int(ov.pop("batch", b)), int(ov.pop("seq", s))
    s_cache = ov.pop("s_cache", None)
    tcfg = ov.pop("tcfg", None) or TrainConfig(opt=_opt_for(arch), remat=True)
    if ov:
        raise ValueError(f"run_cell: unknown overrides {sorted(ov)}")
    if kind != "train":
        tcfg = None
    limit = FIT_SHARE * rf.HBM_BYTES

    r = _trace(arch, shape, cfg, b, s, s_cache, tcfg)
    n_act = rf.active_param_count(cfg, r["named"])
    if kind == "train":
        tokens = b * (s // cfg.dec_ratio if cfg.encdec else s)
        mf = rf.model_flops_train(n_act, tokens)
    else:
        mf = rf.model_flops_decode(n_act, b * s if kind == "prefill" else b)
    fits = r["peak"] <= limit
    mb = b if fits else None
    if not fits and max_batch:
        mb = _max_batch(arch, shape, cfg, b, s, s_cache, tcfg, r["peak"], limit)
    args = sum(r["arg_bytes"].values())
    return {
        "arch": arch, "shape": shape, "chips": 1, "status": "ok",
        "batch": b, "seq": s, "s_cache": s_cache, "kind": kind,
        "trace_s": round(r["trace_s"], 3),
        "n_params": rf.param_count(r["named"]), "n_active_params": int(n_act),
        "memory": {
            "argument_bytes": r["arg_bytes"], "argument_size_in_bytes": args,
            "output_size_in_bytes": r["out_bytes"], "peak_bytes": r["peak"],
        },
        "cost": {"flops": r["flops"], "bytes accessed": r["bytes_accessed"]},
        "roofline": rf.roofline_terms(r["flops"], r["bytes_accessed"], model_flops=mf),
        "flash_calls": r["flash_calls"],
        "fits": bool(fits), "max_batch": mb,
    }


def _max_batch(arch, shape, cfg, b, s, s_cache, tcfg, peak_b, limit) -> int:
    """The largest batch in [0, b) whose reckoned peak fits ``limit``, from
    the peak's line through batch 1 and ``b``, confirmed by a run there."""
    peak_1 = _trace(arch, shape, cfg, 1, s, s_cache, tcfg)["peak"] if b > 1 else peak_b
    if peak_1 > limit:
        return 0
    slope = (peak_b - peak_1) / (b - 1)
    guess = b - 1 if slope <= 0 else max(1, min(b - 1, 1 + int((limit - peak_1) // slope)))
    for cand in range(guess, 0, -1):
        if cand == 1 or _trace(arch, shape, cfg, cand, s, s_cache, tcfg)["peak"] <= limit:
            return cand
    return 1


# ------------------------------------------------------- on a mesh
#: ``--mesh`` kinds: the reference's production meshes
MESHES = {"single": production_mesh_shape(), "multi": production_mesh_shape(multi_pod=True)}


def shard_bytes(tree, specs, mesh) -> int:
    """One device's bytes of ``tree``'s tensors under ``specs`` (the same
    structure) on ``mesh``: each distinct storage once."""
    seen: Dict[int, int] = {}

    def one(t, spec):
        if isinstance(t, torch.Tensor):
            n = 1
            for d in sh.shard_shape(t.shape, spec, mesh):
                n *= d
            seen.setdefault(StorageWeakRef(t.untyped_storage()).cdata, n * t.element_size())

    sh._map(one, tree, specs)
    return sum(seen.values())


def mesh_cells(arch: str, shape: str, mesh_kinds: Sequence,
               overrides: Optional[Dict] = None) -> Dict[Any, Dict]:
    """The per-device record of one cell on each of ``mesh_kinds`` (see
    the module doc), keyed by it: a kind of ``MESHES`` or any
    ``MeshShape``, all from one meta model; ``overrides`` as
    ``run_cell``'s.  The reference's decode cache length is an int32 on
    every device: 4 bytes beside the caches."""
    from ..serve.mesh import serve_tp_only
    ov = dict(overrides or {})
    cfg = ov.pop("cfg", None) or get_config(arch)
    s, b, kind = SHAPES[shape]
    b, s = int(ov.pop("batch", b)), int(ov.pop("seq", s))
    tcfg = ov.pop("tcfg", None) or TrainConfig(opt=_opt_for(arch), remat=True)
    if ov:
        raise ValueError(f"mesh_cells: unknown overrides {sorted(ov)}")
    model = get_model(cfg, "meta")
    params = dict(model.named_parameters())
    specs = input_specs(cfg, shape, batch=b, seq=s)
    opt = init_train_state(model, tcfg) if kind == "train" else None
    out = {}
    for mesh_kind in mesh_kinds:
        ms = MESHES[mesh_kind] if isinstance(mesh_kind, str) else mesh_kind
        tp_only = None
        if kind == "train":
            parts = {"params": (params, sh.param_specs(cfg, params, ms)),
                     "opt_state": (opt, sh.opt_state_specs(cfg, opt, ms)),
                     "batch": (specs["batch"], sh.batch_specs(specs["batch"], ms))}
        else:
            tp_only = serve_tp_only(params, ms)
            parts = {"params": (params, sh.param_specs(cfg, params, ms, serve_tp_only=tp_only))}
            if kind == "prefill":
                parts["batch"] = (specs["batch"], sh.batch_specs(specs["batch"], ms))
            else:
                tok = {"t": specs["tokens"]}
                parts["caches"] = (specs["caches"], sh.cache_specs(cfg, specs["caches"], ms))
                parts["batch"] = (tok, sh.batch_specs(tok, ms))
        per = {k: shard_bytes(tree, sp, ms) for k, (tree, sp) in parts.items()}
        if "caches" in per:
            per["caches"] += 4
        total = sum(per.values())
        out[mesh_kind] = {
            "arch": arch, "shape": shape, "chips": ms.size,
            "mesh": mesh_kind if isinstance(mesh_kind, str) else "x".join(map(str, ms.sizes)),
            "axes": dict(ms.shape), "status": "ok", "batch": b, "seq": s, "kind": kind,
            "n_params": rf.param_count(params), "serve_tp_only": tp_only,
            "memory": {"argument_bytes_per_device": per, "argument_size_in_bytes": total},
            "fits": total <= FIT_SHARE * rf.HBM_BYTES,
        }
    return out


def _placed(t: torch.Tensor, mesh, spec) -> Any:
    """A ``meta`` DTensor on ``mesh`` holding a ``meta`` local shard of
    ``t`` under ``spec``."""
    from torch.distributed.tensor import DTensor

    pl = sh.placements(spec, mesh)
    mine = torch.empty(sh.shard_shape(t.shape, spec, mesh), dtype=t.dtype, device="meta")
    return DTensor.from_local(mine, mesh, pl, run_check=False, shape=t.shape,
                              stride=sh._contiguous_stride(t.shape))


def _meta_slice(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    return torch.empty(sh.shard_shape(t.shape, spec, mesh), dtype=t.dtype, device="meta")


def _local_caches(cfg, caches: Dict, ms, kv) -> Dict:
    """A rank's ``meta`` decode caches: a decoder LM's KV caches under
    their ``cache_spec`` where the serving path splits them (``kv``), its
    batch slice elsewhere (recurrent states and an encoder-decoder's
    caches stay whole over ``"model"``: their blocks compute replicated)."""
    specs = sh.cache_specs(cfg, caches, ms)

    def one(t, spec, keep_model):
        if not keep_model:
            spec = tuple(None if e == "model" else e for e in spec)
        return _meta_slice(t, spec, ms)

    if "layers" not in caches:
        return {part: val if part == "len" else {k: one(t, specs[part][k], False) for k, t in val.items()}
                for part, val in caches.items()}
    return {"layers": [{k: one(t, sp[k], kv is not None and k in ("k", "v")) for k, t in layer.items()}
                       for layer, sp in zip(caches["layers"], specs["layers"])],
            "len": caches["len"]}


def mesh_trace(arch: str, shape: str, mesh_kind, overrides: Optional[Dict] = None) -> Dict:
    """Rank 0's trace of the cell's partitioned step on ``mesh_kind`` (a
    kind of ``MESHES`` or a ``MeshShape``): the per-device peak, flops,
    bytes accessed, collective bytes and the leaves gathered over
    ``"model"`` (see the module doc).  ``overrides`` as ``run_cell``'s."""
    from ..serve.mesh import MeshServer
    from ..train import make_mesh_train_step
    from ..train.step import release_params

    ov = dict(overrides or {})
    cfg = ov.pop("cfg", None) or get_config(arch)
    s, b, kind = SHAPES[shape]
    b, s = int(ov.pop("batch", b)), int(ov.pop("seq", s))
    tcfg = ov.pop("tcfg", None) or TrainConfig(opt=_opt_for(arch), remat=True)
    if ov:
        raise ValueError(f"mesh_trace: unknown overrides {sorted(ov)}")
    ms = MESHES[mesh_kind] if isinstance(mesh_kind, str) else mesh_kind
    specs = input_specs(cfg, shape, batch=b, seq=s)
    model = get_model(cfg, "meta", backend=None if kind == "train" else "cuda")
    named = {k: p.detach() for k, p in model.named_parameters()}
    n_act = rf.active_param_count(cfg, named)
    with fake_mesh(ms) as mesh:
        if kind == "train":
            opt = init_train_state(model, tcfg)
            done: Dict[int, Any] = {}

            def place(t, spec):  # a tensor met twice (Adafactor's shared c) placed once
                if id(t) not in done:
                    done[id(t)] = _placed(t, mesh, spec)
                return done[id(t)]

            state = {"params": sh._map(place, named, sh.param_specs(cfg, named, ms)),
                     "opt": sh._map(place, opt, sh.opt_state_specs(cfg, opt, ms))}
            del opt
            release_params(model)
            step = make_mesh_train_step(model, tcfg, mesh)
            batch = specs["batch"]
            bspecs = sh.batch_specs(batch, ms)
            mine = {k: _meta_slice(v, bspecs[k], ms) for k, v in batch.items()}
            dims = sh.batch_dims(batch, ms)
            args = leaf_tensors({k: [sh.local(t) for t in sh._leaves(v)] for k, v in state.items()})
            run = lambda: step.on_slices(state, [mine], dims)  # noqa: E731
            args += list(mine.values())
            tokens = b * (s // cfg.dec_ratio if cfg.encdec else s)
            mf = rf.model_flops_train(n_act, tokens)
        else:
            srv = MeshServer(model, mesh)
            args = [p.detach() for p in model.parameters()]
            if kind == "prefill":
                batch = specs["batch"]
                bspecs = sh.batch_specs(batch, ms)
                mine = {k: _meta_slice(v, bspecs[k], ms) for k, v in batch.items()}
                dims = sh.batch_dims(batch, ms)
                run = lambda: srv.prefill_slice(mine, dims)  # noqa: E731
                args += list(mine.values())
                mf = rf.model_flops_decode(n_act, b * s)
            else:
                caches, tokens = specs["caches"], specs["tokens"]
                srv.set_slice(sh.batch_dims({"tokens": tokens}, ms), s)
                mine_c = _local_caches(cfg, caches, ms, srv.kv)
                tok = _meta_slice(tokens, sh.batch_spec("t", tokens.shape, ms), ms)
                run = lambda: srv.decode_step(mine_c, tok)  # noqa: E731
                args += leaf_tensors(mine_c) + [tok]
                mf = rf.model_flops_decode(n_act, b)
        tracker = StepTracker()
        gc_was = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        try:
            with FlopCounterMode(display=False) as flops, tracker, sh.counting() as coll:
                arg_bytes = tracker.start(args)
                del args
                out = run()
        finally:
            if gc_was:
                gc.enable()
        trace_s = time.perf_counter() - t0
        out_bytes = storage_bytes(leaf_tensors(out))
        del out
    names = {id(p): k for k, p in model.named_parameters()}
    gathered = sorted({_layerless(names[i]) for i in coll.model_gathered if i in names})
    return dict(trace_s=trace_s, arg_bytes=arg_bytes, out_bytes=out_bytes, peak=tracker.peak,
                flops=float(flops.get_total_flops()), bytes_accessed=float(tracker.bytes_accessed),
                coll=coll, model_gathered=gathered, model_flops=mf, n_active=n_act,
                flash_calls=tracker.calls[FLASH_OP])


def _layerless(name: str) -> str:
    """A parameter name with its layer index as ``*`` (``layers.*.attn.wq``)."""
    return ".".join("*" if part.isdigit() else part for part in name.split("."))


def mesh_cell(arch: str, shape: str, mesh_kind, overrides: Optional[Dict] = None) -> Dict:
    """The reference's ``run_cell(arch, shape, mesh_kind)``: ``mesh_cells``'
    per-device argument bytes and ``mesh_trace``'s figures in one record
    (see the module doc); ``fits`` on the traced peak, ``args_fit`` on the
    argument bytes."""
    rec = mesh_cells(arch, shape, [mesh_kind], overrides)[mesh_kind]
    t = mesh_trace(arch, shape, mesh_kind, overrides)
    chips = rec["chips"]
    per_kind = t["coll"].by_kind()
    coll_global = {k: v * chips for k, v in per_kind.items()}
    rec["args_fit"] = rec.pop("fits")
    rec["memory"].update(traced_argument_bytes=t["arg_bytes"], output_size_in_bytes=t["out_bytes"],
                         peak_bytes_per_device=t["peak"])
    rec.update(
        trace_s=round(t["trace_s"], 3), n_active_params=int(t["n_active"]),
        cost_per_device={"flops": t["flops"], "bytes accessed": t["bytes_accessed"]},
        collective_bytes_per_device=t["coll"].by_axis(),
        collective_bytes_global=coll_global,
        roofline=rf.roofline_terms(t["flops"] * chips, t["bytes_accessed"] * chips,
                                   float(sum(coll_global.values())), chips,
                                   model_flops=t["model_flops"]),
        model_gathered=t["model_gathered"], flash_calls=t["flash_calls"],
        fits=t["peak"] <= FIT_SHARE * rf.HBM_BYTES,
    )
    return rec


# --------------------------------------------------------------------- CLI
def _load(path: str) -> Dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _save(db: Dict, path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(db, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--cells", default=None, help="'all' = every enabled cell")
    ap.add_argument("--mesh", default="one", choices=["one", "single", "multi", "both"],
                    help="one card (default), or per device on a production mesh")
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    if args.cells == "all":
        todo = list(cells())
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    else:
        ap.error("give --cells all, or --arch and --shape")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    path = os.path.abspath(args.out)
    db = _load(path)
    for arch, shape in todo:
        for m in meshes:
            key = f"{arch}|{shape}" if m == "one" else f"{arch}|{shape}|{m}"
            if db.get(key, {}).get("status") == "ok" and not args.force:
                print(f"[skip] {key}", flush=True)
                continue
            print(f"[run ] {key}", flush=True)
            try:
                res = run_cell(arch, shape) if m == "one" else mesh_cell(arch, shape, m)
            except Exception as e:  # noqa: BLE001 - the record keeps the error
                res = {"arch": arch, "shape": shape, "mesh": m,
                       "chips": 1 if m == "one" else MESHES[m].size, "status": "error",
                       "error": f"{type(e).__name__}: {e}", "trace": traceback.format_exc()[-2000:]}
            db = _load(path)  # re-merge (parallel runners)
            db[key] = res
            _save(db, path)
            if res["status"] != "ok":
                print(f"[FAIL] {key}: {res['error']}", flush=True)
            elif m == "one":
                r = res["roofline"]
                print(f"[done] {key} trace={res['trace_s']}s peak={res['memory']['peak_bytes']} "
                      f"fits={res['fits']} max_batch={res['max_batch']} dominant={r['dominant']} "
                      f"bound={r['bound_s']:.4g}s", flush=True)
            else:
                r = res["roofline"]
                print(f"[done] {key} chips={res['chips']} trace={res['trace_s']}s "
                      f"argument_bytes_per_device={res['memory']['argument_size_in_bytes']} "
                      f"peak_per_device={res['memory']['peak_bytes_per_device']} fits={res['fits']} "
                      f"collective_bytes_global={sum(res['collective_bytes_global'].values()):.4g} "
                      f"dominant={r['dominant']} bound={r['bound_s']:.4g}s", flush=True)
    return db


if __name__ == "__main__":
    main()
