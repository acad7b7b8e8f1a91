"""One-card dry run: trace every (architecture x input shape) cell's step
on ``meta`` tensors and record whether it fits one H100, its flops and
bytes, its roofline bound and the share of it that is model flops
(counterpart of ``repro/launch/dryrun.py``, one card, no mesh):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --cells all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b --shape prefill_32k

It runs on the CPU and needs no card: a model built on ``meta`` holds
shapes and dtypes only, and the step runs its real code path eagerly on
them, the ``'cuda'`` backend included, whose flash attention reaches the
operator's fake (``kernels/flash_attention.py``).  Results accumulate,
crash-safe, in ``dryrun_results_torch.json`` at the repo root (``--out``),
keyed ``arch|shape``; an ``ok`` cell is skipped unless ``--force``.

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

The reference's ``--mesh`` and its sharding rules have no counterpart.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback
from collections import Counter
from typing import Dict, Iterable, Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import SHAPES, cells, get_config, get_model, input_specs
from ..kernels import flash_attention as _fa
from ..train import OptConfig, TrainConfig, init_train_state, make_train_step
from . import roofline as rf

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
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    if args.cells == "all":
        todo = list(cells())
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    else:
        ap.error("give --cells all, or --arch and --shape")
    path = os.path.abspath(args.out)
    db = _load(path)
    for arch, shape in todo:
        key = f"{arch}|{shape}"
        if db.get(key, {}).get("status") == "ok" and not args.force:
            print(f"[skip] {key}", flush=True)
            continue
        print(f"[run ] {key}", flush=True)
        try:
            res = run_cell(arch, shape)
        except Exception as e:  # noqa: BLE001 - the record keeps the error
            res = {"arch": arch, "shape": shape, "chips": 1, "status": "error",
                   "error": f"{type(e).__name__}: {e}", "trace": traceback.format_exc()[-2000:]}
        db = _load(path)  # re-merge (parallel runners)
        db[key] = res
        _save(db, path)
        if res["status"] == "ok":
            r = res["roofline"]
            print(f"[done] {key} trace={res['trace_s']}s peak={res['memory']['peak_bytes']} "
                  f"fits={res['fits']} max_batch={res['max_batch']} dominant={r['dominant']} "
                  f"bound={r['bound_s']:.4g}s", flush=True)
        else:
            print(f"[FAIL] {key}: {res['error']}", flush=True)
    return db


if __name__ == "__main__":
    main()
