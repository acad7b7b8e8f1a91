"""Atomic, resumable checkpoints (counterpart of
``repro/train/checkpoint.py``, in its on-disk layout).

Layout: ``<dir>/step_<n:08d>/arrays.npz`` + ``manifest.json`` (``step``,
``keys``, ``shapes``, ``dtypes``, ``extra``), written into a temp dir and
moved into place with ``os.replace``, then an atomic ``latest`` pointer
file.  A tree is nested dicts (and lists) of tensors or numpy arrays; a
leaf's key is its path joined by ``/`` (``params/layers.0.attn.wq``).

numpy has no bfloat16 without ``ml_dtypes``, and neither this package
nor the card's machine has it.  A bf16 leaf is stored as its 16 bits in
numpy's two-byte void type, which is how ``ml_dtypes``' bfloat16 lands in
an ``.npy`` file (so the reference's bf16 leaves have the same bytes),
with ``"bfloat16"`` in ``dtypes``; ``restore`` reads such a leaf, from
either package, by its bits.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

BF16 = "bfloat16"


def _flatten_with_names(tree, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat: Dict[str, Any] = {}
    for k, v in items:
        flat.update(_flatten_with_names(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _unflatten_like(tree, flat: Dict[str, Any], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_like(v, flat, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return flat[prefix]


def to_numpy(x, copy: bool = False) -> Tuple[np.ndarray, str]:
    """A leaf on the host: ``(array, dtype name)``, bf16 as its bits.  A
    CPU leaf's array shares its memory unless ``copy``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=copy)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.dtype("V2")), BF16
        return x.numpy(), str(x.numpy().dtype)
    a = np.array(x, copy=copy)
    return a, str(a.dtype)


def from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    """Inverse of ``to_numpy`` (sharing ``a``'s memory): a bf16 leaf, as
    two-byte void or uint16 bits, by its bits."""
    if not a.flags.c_contiguous:
        a = a.copy()
    if dtype == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def write(ckpt_dir: str, step: int, arrays: Dict[str, np.ndarray], dtypes: Dict[str, str],
          extra: Optional[Dict] = None) -> str:
    """Write host arrays as checkpoint ``step`` and repoint ``latest``;
    returns the checkpoint's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays),
        "shapes": {k: list(a.shape) for k, a in arrays.items()},
        "dtypes": dict(dtypes),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):  # overwrite-resume case
        shutil.rmtree(final)
    os.replace(tmp, final)
    # atomic latest pointer
    fd, ptmp = tempfile.mkstemp(dir=ckpt_dir)
    with os.fdopen(fd, "w") as f:
        f.write(os.path.basename(final))
    os.replace(ptmp, os.path.join(ckpt_dir, "latest"))
    return final


def _host(tree, copy: bool = False) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    arrays, dtypes = {}, {}
    for k, v in _flatten_with_names(tree).items():
        arrays[k], dtypes[k] = to_numpy(v, copy)
    return arrays, dtypes


def save(ckpt_dir: str, step: int, tree, extra: Optional[Dict] = None) -> str:
    """Atomic checkpoint of ``tree`` (see the module doc)."""
    arrays, dtypes = _host(tree)
    return write(ckpt_dir, step, arrays, dtypes, extra)


def save_async(ckpt_dir: str, step: int, tree, extra: Optional[Dict] = None) -> threading.Thread:
    """Background save: copies the tree to host memory now (this waits
    for the device), writes on a thread.  ``join()`` the thread before
    exit."""
    arrays, dtypes = _host(tree, copy=True)  # no views of live tensors
    t = threading.Thread(target=write, args=(ckpt_dir, step, arrays, dtypes, extra))
    t.start()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[-1])


def read_manifest(ckpt_dir: str, step: Optional[int] = None) -> Tuple[str, Dict]:
    """``(step dir, manifest)`` of checkpoint ``step`` (None: the latest)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        return path, json.load(f)


def restore(ckpt_dir: str, tree_like, step: Optional[int] = None, *,
            partial: bool = False) -> Tuple[Any, Dict]:
    """Restore into the structure of ``tree_like``: ``(tree, extra)``, each
    leaf a tensor with its ``like``'s dtype on its device.  Keys and shapes
    are checked; the keys must equal the checkpoint's, or with ``partial``
    be among them (a server reads ``{"params"}`` of a training checkpoint)."""
    path, manifest = read_manifest(ckpt_dir, step)
    like = _flatten_with_names(tree_like)
    have = set(manifest["keys"])
    missing, extra_keys = sorted(set(like) - have), sorted(have - set(like))
    if missing or (extra_keys and not partial):
        raise KeyError(
            f"checkpoint/tree key mismatch: missing={missing[:4]} extra={extra_keys[:4]}"
        )
    out = {}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for name, ref in like.items():
            arr = z[name]
            if list(arr.shape) != list(ref.shape):
                raise ValueError(f"{name}: checkpoint shape {arr.shape}, tree {tuple(ref.shape)}")
            t = from_numpy(arr, manifest["dtypes"].get(name, str(arr.dtype)))
            out[name] = t.to(device=ref.device, dtype=ref.dtype)
    return _unflatten_like(tree_like, out), manifest["extra"]
