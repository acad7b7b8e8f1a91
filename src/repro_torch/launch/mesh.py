"""The port's device meshes over ``torch.distributed``: the gym's reducer
mesh, one process per reducer, and the LM meshes of the reference's
``launch/mesh.py``, whose placements ``launch/shardings.py`` gives.

The reducer mesh is the counterpart of ``jax.make_mesh((p,), ("r",))``
for the gym's reducer axis.  A rank passes the mesh to ``SPMD(p,
mesh=mesh)`` and makes the same call as every other rank; each holds its
block of the reducer axis and gets the whole answer back.  Every gym entry
point takes such an ``SPMD``: ``gym``, ``shares_join``, ``gym_loggta`` and
``acq_mr`` (``spmd=``), ``GymDriver`` (its ``step``/``step_gen``/``run``
and the collective ``save``/``load``) and ``JoinServer``; so does
``train/compression.py::int8_allreduce`` (``group=mesh``).

- ``make_reducer_mesh(p)``: in a process that ``torchrun --nproc-per-node
  <p>`` started (it reads the rank and the rendezvous from the
  environment), or after the caller's own ``init_process_group``.
- ``spawn_reducers(fn, p, ...)``: starts the ``p`` ranks itself
  (``torch.multiprocessing`` spawn, a ``FileStore`` in a temporary
  directory, so no network is needed) and returns ``fn``'s value on every
  rank.

The LM meshes are one more ``init_device_mesh`` over the same world:

- ``make_production_mesh(multi_pod=)``: ``(16, 16)`` ``("data", "model")``
  over 256 ranks, or ``(2, 16, 16)`` ``("pod", "data", "model")`` over 512;
- ``make_debug_mesh(data, model)``: ``("data", "model")`` over
  ``data * model`` ranks;
- ``MeshShape`` and ``production_mesh_shape``: the same names and sizes
  without devices, which the sharding rules and the dry run read (the
  reference's rules read only ``mesh.shape[axis]`` and ``axis_names``);
- ``dp_axes(mesh)``: the data-parallel (FSDP) axes of either.

An NCCL mesh takes one card a rank and refuses more ranks than there are
cards; ``gloo`` runs any number of ranks, on the CPU or sharing one card.
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..relational.spmd import AXIS, check_cards

# seconds a rank waits in one collective before it raises: ranks that stray
# from one another (different calls, or a rank that died) fail instead of
# hanging
COLLECTIVE_TIMEOUT_S = 300


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)


def _world(what: str, size: int, device_type: str, backend=None) -> None:
    """Check that the default process group has ``size`` ranks for
    ``what``; the group is initialized from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ...) when none exists: NCCL on
    ``'cuda'``, gloo on ``'cpu'`` unless ``backend`` says, each collective
    bounded by ``COLLECTIVE_TIMEOUT_S``."""
    import torch.distributed as dist

    backend = backend or (
        dist.get_backend() if dist.is_initialized()
        else ("nccl" if device_type == "cuda" else "gloo")
    )
    ranks_here = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    check_cards(backend, device_type, ranks_here)
    if device_type == "cuda":
        # before the group exists, so NCCL binds the rank's own card
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    if not dist.is_initialized():
        dist.init_process_group(backend, timeout=_timeout())
    if dist.get_world_size() != size:
        raise ValueError(f"{what} needs {size} ranks, the group has {dist.get_world_size()}")


def make_reducer_mesh(p: int, device_type: str = "cuda", backend=None):
    """The one-dimension ``"r"`` mesh of size ``p`` over the default
    process group (``_world``)."""
    from torch.distributed.device_mesh import init_device_mesh

    _world(f"a reducer mesh of {p}", p, device_type, backend)
    return init_device_mesh(device_type, (p,), mesh_dim_names=(AXIS,))


# ------------------------------------------------------------- LM meshes
class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without devices: what the sharding
    rules read of a mesh, at any size on one process."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """Single pod: ``(16, 16)`` ``("data", "model")``, 256 devices.
    Multi-pod: ``(2, 16, 16)`` ``("pod", "data", "model")``, 512."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def mesh_shape(mesh) -> MeshShape:
    """The ``MeshShape`` of a ``DeviceMesh`` (a ``MeshShape`` is its own)."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.mesh_dim_names or ()), tuple(int(s) for s in mesh.shape))


def _lm_mesh(ms: MeshShape, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    _world(f"the mesh {dict(ms.shape)}", ms.size, device_type)
    return init_device_mesh(device_type, ms.sizes, mesh_dim_names=ms.axis_names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production ``DeviceMesh`` (``production_mesh_shape``) over the
    default process group (``_world``); raises unless the group has 256
    ranks (512 with ``multi_pod``)."""
    return _lm_mesh(production_mesh_shape(multi_pod=multi_pod), device_type)


def make_debug_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """A ``(data, model)`` ``("data", "model")`` ``DeviceMesh`` over the
    default process group of ``data * model`` ranks (``_world``)."""
    return _lm_mesh(MeshShape(("data", "model"), (int(data), int(model))), device_type)


def dp_axes(mesh) -> tuple:
    """The data-parallel (FSDP) axes of a mesh: ``("pod", "data")`` or
    ``("data",)``."""
    return tuple(a for a in mesh_shape(mesh).axis_names if a in ("pod", "data"))


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
        backend, store=dist.FileStore(store, p), rank=rank, world_size=p, timeout=_timeout(),
    )
    try:
        out = fn(make_reducer_mesh(p, device_type, backend), *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        # no rank tears its connections down while a peer still uses them
        dist.barrier()
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
    a failing rank stops the others and raises here.  Each collective wait
    is bounded by ``COLLECTIVE_TIMEOUT_S``."""
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
