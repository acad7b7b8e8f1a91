"""Carry a plan and a dataset across from the reference package as plain
Python and numpy — never by importing it.

- ``ghd_from_dict``: a ``GHD.to_dict()`` dictionary -> the port's ``GHD``;
- ``query_from_atoms``: ``(alias, rel, attrs)`` triples -> the port's
  ``Query``;
- ``dtable_from_numpy``: a ``(data, valid, schema)`` numpy triple -> a
  ``DTable`` on a given device;
- ``lm_params_from_numpy``: the reference ``DecoderLM.init`` param tree,
  converted to numpy -> the port's ``DecoderLM`` state dict;
- ``wire_policy_from_tuple``: a ``WirePolicy.attr_bits`` tuple -> the
  port's ``WirePolicy``;
- ``plan_from_fields``: an advisor ``Plan``'s fields (its GHD as a
  ``GHD.to_dict()`` dictionary) -> the port's ``Plan``;
- ``snapshot_from_reference``: a reference ``GymDriver.save`` snapshot ->
  one the port's ``GymDriver.load`` reads (the layout is the same; only
  the backend name differs).
"""
from __future__ import annotations

import json
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


def lm_params_from_numpy(
    cfg: ArchConfig, tree: Dict[str, Any], device="cpu"
) -> Dict[str, torch.Tensor]:
    """The reference's ``DecoderLM.init`` tree (numpy leaves) -> a state
    dict for ``repro_torch.models.DecoderLM(cfg).load_state_dict``.

    The reference stacks each run of equal block kinds (``cfg.segments()``)
    on a leading layer axis; the port has one module per layer, so layer
    ``i`` of a segment is slice ``i`` of each leaf.  The output table is
    the embedding's unless the tree holds ``unembed``."""
    state: Dict[str, torch.Tensor] = {}

    def put(name: str, arr) -> None:
        state[name] = torch.from_numpy(np.array(arr, copy=True)).to(device)

    put("embed.table", tree["embed"]["table"])
    put("final_ln", tree["final_ln"])
    if "unembed" in tree:
        put("unembed.table", tree["unembed"]["table"])
    layer = 0
    for (_, count), seg in zip(cfg.segments(), tree["segments"]):
        for i in range(count):
            for part, leaves in seg.items():  # "attn" / "mlp"
                for key, arr in leaves.items():
                    put(f"layers.{layer + i}.{part}.{key}", np.asarray(arr)[i])
        layer += count
    return state


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
