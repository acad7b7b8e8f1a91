"""The reducer mesh: one process per reducer over ``torch.distributed``.

The counterpart of ``jax.make_mesh((p,), ("r",))`` for the gym's reducer
axis (the reference's LM meshes and their sharding rules are not part of
the port).  A rank passes the mesh to ``SPMD(p, mesh=mesh)`` and runs the
same ``gym(...)`` call as every other rank; each holds its block of the
reducer axis and gets the whole answer back.

- ``make_reducer_mesh(p)``: in a process that ``torchrun --nproc-per-node
  <p>`` started (it reads the rank and the rendezvous from the
  environment), or after the caller's own ``init_process_group``.
- ``spawn_reducers(fn, p, ...)``: starts the ``p`` ranks itself
  (``torch.multiprocessing`` spawn, a ``FileStore`` in a temporary
  directory, so no network is needed) and returns ``fn``'s value on every
  rank.

An NCCL mesh takes one card a rank and refuses more ranks than there are
cards; ``gloo`` runs any number of ranks, on the CPU or sharing one card.
"""
from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from typing import Any, Callable, List, Optional, Sequence

import torch

from ..relational.spmd import AXIS, check_cards


def make_reducer_mesh(p: int, device_type: str = "cuda", backend=None):
    """The one-dimension ``"r"`` mesh of size ``p`` over the default
    process group, which is initialized from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ...) when none exists:
    NCCL on ``'cuda'``, gloo on ``'cpu'`` unless ``backend`` says."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    backend = backend or (
        dist.get_backend() if dist.is_initialized()
        else ("nccl" if device_type == "cuda" else "gloo")
    )
    ranks_here = int(os.environ.get("LOCAL_WORLD_SIZE", p))
    check_cards(backend, device_type, ranks_here)
    if device_type == "cuda":
        # before the group exists, so NCCL binds the rank's own card
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    if not dist.is_initialized():
        dist.init_process_group(backend)
    if dist.get_world_size() != p:
        raise ValueError(f"a reducer mesh of {p} needs {p} ranks, the group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, (p,), mesh_dim_names=(AXIS,))


def _rank_main(rank: int, fn, p: int, backend: str, device_type: str, store: str,
               out_dir: str, args) -> None:
    import torch.distributed as dist

    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(p)
    # the host's cores shared out, as torchrun does: p ranks each with
    # every core's intra-op threads oversubscribe the host
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // p))
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, store=dist.FileStore(store, p), rank=rank, world_size=p
    )
    try:
        out = fn(make_reducer_mesh(p, device_type, backend), *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_reducers(
    fn: Callable[..., Any], p: int, *, backend: Optional[str] = None,
    device_type: str = "cuda", args: Sequence = (),
) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``p`` new processes, one a reducer, and
    return its (picklable) values in rank order.  The ranks run on the
    card unless ``device_type="cpu"`` asks for the CPU; ``backend`` is
    NCCL on ``'cuda'`` and gloo on ``'cpu'`` unless it says (gloo lets
    ``p`` ranks share one card).  ``fn`` must be a module-level function;
    a failing rank stops the others and raises here."""
    import torch.multiprocessing as mp

    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    check_cards(backend, device_type, p)
    tmp = tempfile.mkdtemp(prefix="reducers-")
    try:
        mp.spawn(
            _rank_main,
            args=(fn, p, backend, device_type, os.path.join(tmp, "store"), tmp, tuple(args)),
            nprocs=p, join=True,
        )
        outs = []
        for r in range(p):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        return outs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
