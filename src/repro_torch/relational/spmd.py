"""SPMD execution of per-shard functions: one code path, two runtimes.

``repro`` maps a per-shard body over the reducer axis with a named-axis
``vmap`` and lets it call ``all_to_all`` on that name.  PyTorch's ``vmap``
has no named-axis collectives, so the port writes every body over an
explicit leading reducer axis and lets it call this module's collectives
(``all_to_all``, ``axis_index``) instead of swapping axes inline:

- simulation (``mesh=None``, the default): one process holds all ``p``
  shards on one device (the paper's PRAM-style simulation); an
  ``all_to_all`` is a swap of the (source, destination) axes and the
  shard index is an ``arange``.
- production (``mesh=`` a ``torch.distributed`` ``DeviceMesh`` with one
  dimension ``"r"`` of size ``p``, one process per reducer): each rank
  holds its block of the reducer axis, the leading axis at length 1 as
  ``shard_map``'s ``P("r")`` gives it, so the same bodies run on a block;
  an ``all_to_all`` is ``all_to_all_single`` over the ``"r"`` group and
  the shard index is the rank.  Host reads go through ``to_host``, which
  gathers the blocks first, so every rank takes the same decisions.

``SPMD.run`` stays the one dispatch boundary and counts dispatches exactly
as the reference does, on every rank alike, because the ledger's dispatch
figures are part of parity.
"""
from __future__ import annotations

import contextvars
import os
from typing import Callable, Optional

import numpy as np
import torch

#: the reducer axis' name (the mesh dimension a production ``SPMD`` runs on)
AXIS = "r"

# the mesh ``SPMD`` whose ``run`` is executing a body: the counterpart of
# the axis name that ``vmap``/``shard_map`` put in scope for the body
_CURRENT: contextvars.ContextVar[Optional["SPMD"]] = contextvars.ContextVar(
    "repro_torch_spmd", default=None
)


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; the CPU only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU explicitly"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


def _mesh_device(mesh, device) -> torch.device:
    """The rank's own device on ``mesh``: the mesh's device type decides
    (a CPU mesh is one that was asked for); ``device``, if given, must
    agree with it."""
    if mesh.device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    elif mesh.device_type == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"unsupported mesh device type {mesh.device_type!r}")
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device {device!r} disagrees with the mesh's {mesh.device_type!r}")
    return dev


def check_cards(backend: str, device_type: str, ranks_here: int) -> None:
    """Refuse a mesh this host cannot hold: a ``'cuda'`` mesh without a
    card, or an NCCL mesh with more ranks on the host than visible cards
    (NCCL takes one card a rank; gloo may share one)."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a 'cuda' mesh needs a CUDA device and none is available")
    if backend == "nccl" and ranks_here > torch.cuda.device_count():
        raise RuntimeError(
            f"an NCCL mesh takes one card a rank: {ranks_here} ranks on this host, "
            f"{torch.cuda.device_count()} visible cards (backend='gloo' shares a card)"
        )


class SPMD:
    def __init__(self, p: int, mesh=None, device=None):
        """``p`` logical reducers.  Without ``mesh`` they are simulated on
        ``device`` (None = the CUDA card).  With ``mesh`` (a
        ``DeviceMesh`` whose ``"r"`` dimension has size ``p``) this process
        is one reducer, on the rank's own device."""
        self.p = p
        self.mesh = mesh
        self.group = None
        self.rank: Optional[int] = None
        self.backend: Optional[str] = None
        self._staged = False
        if mesh is None:
            self.device = resolve_device(device)
        else:
            import torch.distributed as dist
            from torch.distributed.device_mesh import DeviceMesh

            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a DeviceMesh, got {type(mesh).__name__}")
            names = tuple(mesh.mesh_dim_names or ())
            if names != (AXIS,) or mesh.size(0) != p:
                raise ValueError(
                    f"SPMD({p}) needs a one-dimension mesh {AXIS!r} of size {p}, got "
                    f"dimensions {names} of shape {tuple(mesh.shape)}"
                )
            self.group = mesh.get_group(AXIS)
            self.rank = mesh.get_local_rank(AXIS)
            self.backend = dist.get_backend(self.group)
            check_cards(self.backend, mesh.device_type, int(os.environ.get("LOCAL_WORLD_SIZE", p)))
            self.device = _mesh_device(mesh, device)
            # gloo moves host tensors only: a card's block is staged
            # through pinned host memory around each collective
            self._staged = self.backend == "gloo" and self.device.type == "cuda"
        # program dispatches issued (one per ``run`` call) — the measured
        # counterpart of the ledger's claimed BSP rounds
        self.dispatch_count: int = 0
        # the subset of ``dispatch_count`` that were count-only measure
        # pre-passes (``run(..., measure=True)``)
        self.measure_dispatch_count: int = 0

    @property
    def shards(self) -> int:
        """Length of the reducer axis this process holds: ``p`` in the
        simulation, 1 (the rank's block) on a mesh."""
        return self.p if self.mesh is None else 1

    def run(self, fn: Callable, *args, measure: bool = False, **statics):
        """Run per-shard ``fn`` (written over the leading reducer axis) as
        one dispatch.  ``measure`` tags a count-only calibration pre-pass.
        Results are device tensors; on CUDA the work is queued
        asynchronously and the host waits only when a caller reads
        values back.  On a mesh every tensor argument must be the rank's
        block, and ``fn``'s collectives run over the ``"r"`` group."""
        self.dispatch_count += 1
        if measure:
            self.measure_dispatch_count += 1
        if self.mesh is None:
            return fn(*args, **statics)
        for a in args:
            if isinstance(a, torch.Tensor) and a.shape[:1] != (1,):
                raise ValueError(
                    f"{fn.__name__}: an argument of shape {tuple(a.shape)} is not a "
                    "(1, ...) block of the reducer axis"
                )
        token = _CURRENT.set(self)
        try:
            return fn(*args, **statics)
        finally:
            _CURRENT.reset(token)

    def seeds(self, seed: int) -> torch.Tensor:
        """Per-shard seed tensor (uint32 values in int64): hash seeds ride
        as data, one per shard of this process' block."""
        return torch.full(
            (self.shards,), seed & 0xFFFFFFFF, dtype=torch.int64, device=self.device
        )

    def device_put(self, tree):
        """Place a host-built global value (a ``DTable`` or a tensor whose
        leading axis is the reducer axis) on this process' device: all of
        it in the simulation, the rank's block on a mesh."""
        from .table import DTable

        if isinstance(tree, DTable):
            return DTable(self.device_put(tree.data), self.device_put(tree.valid), tree.schema)
        if self.mesh is not None:
            assert tree.shape[0] == self.p, (tuple(tree.shape), self.p)
            tree = tree[self.rank: self.rank + 1]
        return tree.to(self.device)

    # -- collectives over the "r" group ---------------------------------------
    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` where the collective can take it: a pinned host copy for
        gloo on a card, ``x`` itself otherwise."""
        if not self._staged:
            return x
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)
        return h

    def _all_to_all(self, x: torch.Tensor, dst_dim: int) -> torch.Tensor:
        import torch.distributed as dist

        y = self._stage(x.movedim(dst_dim, 0).contiguous())
        assert y.shape[0] == self.p, (tuple(x.shape), dst_dim, self.p)
        out = torch.empty_like(y)
        dist.all_to_all_single(out, y, group=self.group)
        return out.to(self.device).movedim(0, dst_dim)

    def to_host(self, x) -> np.ndarray:
        """The one host read of a per-shard value: a numpy array over the
        whole reducer axis.  On a mesh the rank's ``(1, ...)`` block is
        gathered along ``"r"`` first, so every rank sees the global array.
        A numpy value is already on the host and passes through."""
        if not isinstance(x, torch.Tensor):
            return np.asarray(x)
        if self.mesh is None:
            return x.cpu().numpy()
        import torch.distributed as dist

        assert x.shape[:1] == (1,), f"to_host of a non-block tensor {tuple(x.shape)}"
        y = x.detach().cpu().contiguous() if self._staged else x.detach().contiguous()
        parts = [torch.empty_like(y) for _ in range(self.p)]
        dist.all_gather(parts, y, group=self.group)
        return torch.cat(parts, dim=0).cpu().numpy()

    def to_host_many(self, *xs) -> list:
        """``to_host`` of several per-shard values with one gather on a
        mesh: the integer blocks ride flattened in one int64 buffer and
        come back in their own shapes and dtypes (the simulation reads
        each as ``to_host`` does)."""
        if self.mesh is None or not all(
            isinstance(x, torch.Tensor) and not x.is_floating_point() for x in xs
        ):
            return [self.to_host(x) for x in xs]
        flat = torch.cat([x.detach().reshape(1, -1).to(torch.int64) for x in xs], dim=1)
        whole = self.to_host(flat)
        out, off = [], 0
        for x in xs:
            n = x[0].numel()
            dtype = torch.empty((), dtype=x.dtype).numpy().dtype
            out.append(whole[:, off: off + n].reshape((self.p,) + tuple(x.shape[1:])).astype(dtype))
            off += n
        return out


def all_to_all(x: torch.Tensor, dst_dim: int) -> torch.Tensor:
    """Ship every shard's slice ``d`` along ``dst_dim`` to shard ``d``:
    shard ``s``'s slice ``d`` becomes shard ``d``'s slice ``s`` (the
    reference's ``all_to_all(split_axis=concat_axis)``).  ``x`` leads with
    the reducer axis; ``dst_dim`` indexes the destination axis.  Without a
    mesh, a swap of the two axes; on one, ``all_to_all_single`` on the
    rank's block over the ``"r"`` group."""
    cur = _CURRENT.get()
    if cur is None:
        return x.transpose(0, dst_dim)
    return cur._all_to_all(x, dst_dim)


def axis_index(p: int, like: torch.Tensor) -> torch.Tensor:
    """Each shard's index along the reducer axis, shaped to broadcast
    against ``like`` (whose first axis is the reducer axis): an ``arange``
    over ``p`` without a mesh, the rank on one."""
    tail = (1,) * (like.dim() - 1)
    cur = _CURRENT.get()
    if cur is None:
        return torch.arange(p, device=like.device).view((p,) + tail)
    return torch.full((1,) + tail, cur.rank, dtype=torch.int64, device=like.device)

