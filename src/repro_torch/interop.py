"""Carry a plan and a dataset across from the reference package as plain
Python and numpy — never by importing it.

- ``ghd_from_dict``: a ``GHD.to_dict()`` dictionary -> the port's ``GHD``;
- ``query_from_atoms``: ``(alias, rel, attrs)`` triples -> the port's
  ``Query``;
- ``dtable_from_numpy``: a ``(data, valid, schema)`` numpy triple -> a
  ``DTable`` on a given device;
- ``lm_params_from_numpy``: the reference ``DecoderLM.init`` or
  ``WhisperModel.init`` param tree, converted to numpy -> the port's
  model's state dict;
- ``train_state_from_numpy``: the reference's ``(params, opt_state)`` ->
  the port's state dict and optimizer state;
- ``wire_policy_from_tuple``: a ``WirePolicy.attr_bits`` tuple -> the
  port's ``WirePolicy``;
- ``plan_from_fields``: an advisor ``Plan``'s fields (its GHD as a
  ``GHD.to_dict()`` dictionary) -> the port's ``Plan``;
- ``snapshot_from_reference``: a reference ``GymDriver.save`` snapshot ->
  one the port's ``GymDriver.load`` reads (the layout is the same; only
  the backend name differs);
- ``checkpoint_from_reference`` / ``checkpoint_to_reference``: a training
  checkpoint in one package's keys -> the other's (the layout is the same;
  the reference stacks a segment's, the encoder's or the decoder's layers
  in one leaf).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.ghd import GHD
from .core.hypergraph import Atom, Query
from .core.optimizer import Plan
from .models.common import ArchConfig
from .relational.table import DTable
from .relational.wire import WirePolicy


def ghd_from_dict(d: Dict[str, Any]) -> GHD:
    return GHD.from_dict(d)


def query_from_atoms(
    atoms: Iterable[Tuple[str, str, Sequence[str]]], name: Optional[str] = None
) -> Query:
    q = [Atom(a, r, tuple(attrs)) for a, r, attrs in atoms]
    return Query(q) if name is None else Query(q, name=name)


def dtable_from_numpy(
    data: np.ndarray, valid: np.ndarray, schema: Sequence[str], device="cpu"
) -> DTable:
    return DTable(
        torch.from_numpy(np.array(data, dtype=np.int32)).to(device),
        torch.from_numpy(np.array(valid, dtype=bool)).to(device),
        tuple(schema),
    )


def _subpaths(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    """Key paths of the leaves of a nested dict (a MoE part nests its
    shared expert's MLP: ``("moe", "shared", "wg")``)."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _subpaths(val, prefix + (key,))
        else:
            yield prefix + (key,)


def _stacks(cfg: ArchConfig):
    """``(reference key path, port name of layer i, layer count)`` of each
    stack of layers that the reference holds in one subtree, its leaves
    with the layer on axis 0: a decoder's segments (``cfg.segments()``;
    zamba2's shared-block segments are empty placeholders, which hold no
    leaf but still count their layers), or an encoder-decoder's ``enc``
    and ``dec``."""
    if cfg.encdec:
        return [(("enc",), "enc.{}".format, cfg.enc_layers or cfg.n_layers),
                (("dec",), "dec.{}".format, cfg.n_layers)]
    out, first = [], 0
    for s, (_, count) in enumerate(cfg.segments()):
        out.append((("segments", s), lambda i, f=first: f"layers.{f + i}", count))
        first += count
    return out


def _lm_paths(cfg: ArchConfig, tree: Dict[str, Any]):
    """``(port name, key path, layer)`` of every leaf of a reference
    ``DecoderLM.init`` or ``WhisperModel.init`` tree: a stacked leaf
    (``_stacks``) holds its layers on axis 0 (``layer`` is the slice),
    the others are whole (``layer`` None): the tables, the final norms,
    and zamba2's shared block, one unstacked ``shared_attn`` subtree
    (``shared_attn.*`` in the port)."""
    stacks = _stacks(cfg)
    roots = {ref[0] for ref, _, _ in stacks}
    for sub in _subpaths({k: v for k, v in tree.items() if k not in roots}):
        yield ".".join(sub), sub, None
    for ref, port, count in stacks:
        for sub in _subpaths(_at(tree, ref)):  # ("attn", "wq"), ("moe", "shared", "wg")
            for i in range(count):
                yield f"{port(i)}." + ".".join(sub), ref + sub, i


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _lm_leaves(cfg: ArchConfig, tree: Dict[str, Any]):
    """``(port name, leaf, layer)`` of every leaf of ``tree`` (``_lm_paths``)."""
    for name, path, i in _lm_paths(cfg, tree):
        yield name, _at(tree, path), i


def _tensor(arr, device) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def lm_params_from_numpy(
    cfg: ArchConfig, tree: Dict[str, Any], device="cpu"
) -> Dict[str, torch.Tensor]:
    """The reference's ``DecoderLM.init`` or ``WhisperModel.init`` tree
    (numpy leaves) -> a state dict for ``get_model(cfg).load_state_dict``.

    The reference stacks each run of equal block kinds (``cfg.segments()``),
    or an encoder-decoder's ``enc`` and ``dec`` layers, on a leading layer
    axis; the port has one module per layer, so layer ``i`` of a stack is
    slice ``i`` of each leaf.  The output table is
    the embedding's unless the tree holds ``unembed``."""
    return {
        name: _tensor(leaf if i is None else np.asarray(leaf)[i], device)
        for name, leaf, i in _lm_leaves(cfg, tree)
    }


def train_state_from_numpy(
    cfg: ArchConfig, params_tree: Dict[str, Any], opt_tree: Dict[str, Any], device="cpu"
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """The reference's ``(params, opt_state)`` (numpy leaves) -> the
    port's model state dict and optimizer state (``train/optim.py``).

    AdamW's ``m``/``v`` and Adafactor's ``f/{r,c,v}`` are unstacked as the
    parameters are, except the column statistic ``c`` of a stacked vector
    (a norm's gain): it spans the stack's layers, and each layer gets
    it whole."""
    state: Dict[str, Any] = {
        "step": torch.tensor(int(np.asarray(opt_tree["step"])), dtype=torch.int32, device=device)
    }
    for part in ("m", "v"):
        if part in opt_tree:
            state[part] = lm_params_from_numpy(cfg, opt_tree[part], device)
    if "f" in opt_tree:
        f = {}
        for name, path, i in _lm_paths(cfg, params_tree):
            leaf, fl = _at(params_tree, path), _at(opt_tree["f"], path)
            shared_c = i is not None and np.ndim(leaf) == 2  # a stacked vector
            f[name] = {
                k: _tensor(a if i is None or (k == "c" and shared_c) else np.asarray(a)[i], device)
                for k, a in fl.items()
            }
        state["f"] = f
    return lm_params_from_numpy(cfg, params_tree, device), state


def wire_policy_from_tuple(
    attr_bits: Iterable[Tuple[str, int]], *, default_bits: int = 32, codec: str = "raw"
) -> WirePolicy:
    return WirePolicy(
        tuple((str(a), int(b)) for a, b in attr_bits), default_bits=int(default_bits),
        codec=codec,
    )


def plan_from_fields(
    fields: Dict[str, Any], ghd: Dict[str, Any], *, local_backend: Optional[str] = None
) -> Plan:
    """A ``Plan`` from another package's plan fields (plain Python values)
    and its GHD's ``to_dict()``.  The backend names do not carry over, so
    ``local_backend`` (None: the executing device's default) replaces the
    source's."""
    kw = {k: v for k, v in fields.items() if k not in ("ghd", "local_backend")}
    return Plan(ghd=GHD.from_dict(ghd), local_backend=local_backend, **kw)


def snapshot_from_reference(src: str, dst: str) -> None:
    """Copy the reference package's driver snapshot ``src`` to ``dst``,
    rewriting only its config's ``local_backend`` to None (the resuming
    device's default): the reference's backend names (``'jnp'`` /
    ``'pallas'``) do not carry over.  Tables, cursor, GHD, capacities,
    ledger and caps cache stay as written."""
    with np.load(src, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        arrays = {k: z[k] for k in z.files if k != "meta"}
    if "config" in meta:
        meta["config"]["local_backend"] = None
    with open(dst, "wb") as f:
        np.savez(f, meta=json.dumps(meta), **arrays)


def _reference_names(cfg: ArchConfig, manifest: Dict[str, Any]):
    """Map a reference training checkpoint of a ``cfg`` model onto the
    port's keys: yields ``(reference key, port key, layer or None,
    shared)``.  Layer counts come from ``cfg`` (``_stacks``): an empty
    placeholder segment (zamba2's shared block) holds no key to count.
    ``shared`` marks the column statistic of a stacked vector, which every
    layer gets whole."""
    shapes = manifest["shapes"]
    stacks = [(tuple(str(r) for r in ref), port, count) for ref, port, count in _stacks(cfg)]
    for key in manifest["keys"]:
        parts = key.split("/")
        if parts[0] == "opt" and parts[1] == "step":
            yield key, key, None, False
            continue
        head = parts[:1] if parts[0] == "params" else parts[:2]  # params | opt/m | opt/f
        rest = parts[len(head):]
        tail = ""
        if head == ["opt", "f"]:
            rest, tail = rest[:-1], "/" + rest[-1]
        stack = next((st for st in stacks if tuple(rest[:len(st[0])]) == st[0]), None)
        if stack is None:
            yield key, "/".join(head + [".".join(rest)]) + tail, None, False
            continue
        ref, port, count = stack
        name = ".".join(rest[len(ref):])  # moe/shared/wg nests
        shared = tail == "/c" and len(shapes["/".join(["params"] + rest)]) == 2
        for i in range(count):
            yield key, "/".join(head + [f"{port(i)}.{name}"]) + tail, (None if shared else i), shared


def checkpoint_from_reference(cfg: ArchConfig, src: str, dst: str,
                              step: Optional[int] = None) -> int:
    """Copy the reference's training checkpoint of a ``cfg`` model under
    ``src`` (its latest step, or ``step``) into the port's layout under
    ``dst``; returns the step.  Segment leaves are unstacked into
    per-layer keys (as ``train_state_from_numpy`` does), the shared
    block's leaves go to ``shared_attn.*``; leaves, dtypes (bf16 bits
    included), ``step`` and ``extra`` are kept."""
    from .train import checkpoint as ckpt

    path, manifest = ckpt.read_manifest(src, step)
    arrays, dtypes = {}, {}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for key, port, i, _ in _reference_names(cfg, manifest):
            a = z[key]
            arrays[port] = a if i is None else np.ascontiguousarray(a[i])
            dtypes[port] = manifest["dtypes"][key]
    ckpt.write(dst, manifest["step"], arrays, dtypes, manifest["extra"])
    return manifest["step"]


def _split_port_key(key: str):
    """``params/<name>``, ``opt/step``, ``opt/{m,v}/<name>``,
    ``opt/f/<name>/{r,c,v}`` -> ``(head, name, tail)``."""
    parts = key.split("/")
    if parts[0] == "params":
        return parts[:1], parts[1], ""
    if parts[1] == "step":
        return parts[:1], "step", ""
    return parts[:2], parts[2], ("/" + parts[3] if len(parts) > 3 else "")


def checkpoint_to_reference(cfg: ArchConfig, src: str, dst: str,
                            step: Optional[int] = None) -> int:
    """Inverse of ``checkpoint_from_reference``: the port's training
    checkpoint of a ``cfg`` model under ``src`` -> the reference's layout
    under ``dst`` (each stack's layers (``_stacks``) stacked back on axis
    0, a stacked vector's shared ``c`` once, ``shared_attn.*`` as the one
    ``shared_attn`` subtree); returns the step.  The segment indices
    count the shared block's empty placeholder segments, which hold no
    key, as the reference's ``save`` writes them."""
    from .train import checkpoint as ckpt

    path, manifest = ckpt.read_manifest(src, step)
    layer_of = {}  # a port layer's name -> (its stack's reference key parts, layer)
    for ref, port, count in _stacks(cfg):
        for i in range(count):
            layer_of[port(i)] = ([str(r) for r in ref], i)
    groups: Dict[str, list] = {}
    for key in manifest["keys"]:
        head, name, tail = _split_port_key(key)
        parts = name.split(".")
        stacked = layer_of.get(".".join(parts[:2]))
        if stacked is not None:
            ref_parts, i = stacked
            ref = "/".join(head + ref_parts + parts[2:]) + tail
            shared = tail == "/c" and len(manifest["shapes"][f"params/{name}"]) == 1
        else:
            ref, i, shared = "/".join(head + parts) + tail, None, False
        groups.setdefault(ref, []).append((i, key, shared))
    arrays, dtypes = {}, {}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for ref, members in groups.items():
            members.sort(key=lambda m: -1 if m[0] is None else m[0])
            i, key, shared = members[0]
            if i is None or shared:
                arrays[ref] = z[key]
            else:
                arrays[ref] = np.stack([z[k] for _, k, _ in members])
            dtypes[ref] = manifest["dtypes"][key]
    ckpt.write(dst, manifest["step"], arrays, dtypes, manifest["extra"])
    return manifest["step"]
