"""Sharding rules: FSDP over ``("pod", "data")`` and TP/EP over ``"model"``
(counterpart of ``repro/launch/shardings.py``), with placements on a
``torch.distributed`` ``DeviceMesh`` as their output.

The rules are the reference's, path-name based with divisibility-checked
fallbacks: a dim is sharded only on an axis whose size divides it, else
the rule degrades (sub-axis, then replicated).  Each returns a *spec* a
leaf: one entry a dim, ``None``, an axis name or a tuple of axis names,
as ``PartitionSpec`` holds them.  They read only a mesh's axis names and
sizes, so they take a ``DeviceMesh`` or a device-free ``MeshShape``
(``launch/mesh.py``) and run at 256 or 512 devices on one process.

The reference holds a segment's layers stacked on a leading axis; the
port has one module a layer (``interop._stacks``).  Every rule is
evaluated on the reference's stacked shape, with the stack's layer count
in front, and that dim is then dropped, so every layer of a stack gets
the same placements.  Where the reference shards the stacked axis itself
(kimi-k2's shared expert wherever ``"model"`` divides the layer count,
ROADMAP C, F6) the port keeps the other dims' placements.

- ``param_specs``, ``opt_state_specs``, ``batch_specs``, ``cache_specs``:
  the specs of the port's trees (parameters by name, ``train/optim.py``'s
  state, a batch dict, ``DecoderLM``'s or ``WhisperModel``'s caches);
- ``placements``, ``named``, ``place``: a spec as ``Shard(d)`` /
  ``Replicate()`` a mesh dim (a dim sharded over ``("pod", "data")`` is
  ``Shard(d)`` on both), a tree of them, and a tree placed as DTensors
  from each rank's slice (every rank holds the whole tree; no collective);
- ``whole_tree``, ``gather_tree`` (``gather_full`` for one tensor),
  ``reduce_to``, ``all_reduce``: the collectives a placed train step and
  a checkpoint need, on the mesh's own groups or to rank 0, the
  gathers bucketed over many tensors' bytes (gloo moves a card's tensors
  through pinned host memory, as ``relational/spmd.py`` does, and no
  bf16: the bytes travel as uint8);
- ``constrain``: the reference's best-effort activation constraint, on a
  DTensor's own mesh (the reference's ambient abstract mesh has no torch
  counterpart) and a no-op on a plain tensor;
- ``batch_split``: the mesh dims a train step splits the batch over, in
  scope for the MoE dispatch, whose capacity and arrival order are the
  whole batch's (``models/mlp.py``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, NamedTuple, Optional, Sequence, Tuple

import torch

from .mesh import MeshShape, dp_axes, mesh_shape

# parameter-name classes
_IN = {"wq", "wk", "wv", "wi", "wg", "w_in", "w_up", "w_if", "router"}
_OUT = {"wo", "w_out", "w_down"}

Spec = Tuple[Any, ...]


def _axsize(mesh: MeshShape, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _fit(mesh: MeshShape, dim: int, *candidates):
    """First candidate axis (or axis tuple) whose size divides dim."""
    for c in candidates:
        if c is None:
            continue
        if dim % _axsize(mesh, c) == 0:
            return c
    return None


# ------------------------------------------------- the rules, on key paths
def _canon(spec) -> Spec:
    """A one-axis tuple as its axis name, as ``PartitionSpec`` keeps it."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _leaf_name(path) -> str:
    return str(path[-1])


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def param_spec(path, shape: Sequence[int], mesh, serve_tp_only: bool = False) -> Spec:
    """The spec of one parameter leaf at the reference's key ``path`` and
    (stacked) ``shape``.

    ``serve_tp_only``: the inference layout for models that fit
    TP-sharded, no FSDP dim, so no per-layer weight gathers."""
    mesh = mesh_shape(mesh)
    name = _leaf_name(path)
    ps = _path_str(path)
    fsdp = None if serve_tp_only else dp_axes(mesh)
    tp = "model"
    nd = len(shape)
    spec = [None] * nd
    if nd == 0:
        return ()
    is_moe = "moe" in ps and name in ("wi", "wg", "wo")

    def place(dim_idx: int, *cands):
        spec[dim_idx] = _fit(mesh, shape[dim_idx], *cands)

    if is_moe and nd >= 3:
        # (..., E, d, f) or (..., E, f, d): experts -> EP on model
        place(nd - 3, tp, fsdp)
        if spec[nd - 3] == tp:  # EP engaged
            place(nd - 2, fsdp if name in _IN else None)
            if name in _OUT:
                place(nd - 1, fsdp)
        else:  # E indivisible by 'model' (grok 8e vs 16): megatron-style FF
            if name in _IN:  # (E, d, f): f -> tp
                place(nd - 2, fsdp)
                place(nd - 1, tp)
            else:  # (E, f, d): f -> tp
                place(nd - 2, tp)
                place(nd - 1, fsdp)
        return _canon(spec)
    if name == "table":  # (V, D) embeddings
        place(0, tp, fsdp)
        place(1, fsdp if spec[0] != fsdp else None)
        return _canon(spec)
    if name == "r" and nd == 3:  # sLSTM recurrent (H, hd, 4hd)
        place(0, tp)
        return _canon(spec)
    if name == "conv":  # (k, ch) depthwise conv
        place(nd - 1, tp)
        return _canon(spec)
    if name in _IN and nd >= 2:
        place(nd - 2, fsdp)
        place(nd - 1, tp)
        return _canon(spec)
    if name in _OUT and nd >= 2:
        place(nd - 2, tp)
        place(nd - 1, fsdp)
        return _canon(spec)
    # norms, biases, gates: replicate; any big unmatched matrix: best-effort
    if nd >= 2 and shape[-1] * shape[-2] >= 1 << 20:
        place(nd - 1, tp)
        place(nd - 2, fsdp)
    return _canon(spec)


def opt_leaf_spec(path, shape: Sequence[int], mesh) -> Spec:
    """The spec of one optimizer-state leaf at the reference's key
    ``path`` (``m/<param path>``, ``v/<...>``, ``f/<...>/{r,c,v}``,
    ``step``): a moment inherits its parameter's spec; factored vectors,
    small second moments and the step replicate.  As in the reference, a
    leaf whose parameter is itself named ``r`` or ``c`` (the sLSTM's
    ``r``) replicates too."""
    if _path_str(path) == "step":
        return ()
    sub = path[1:]
    if sub and _leaf_name(sub) in ("r", "c"):
        return ()  # factored vectors: small, replicate
    if sub and _leaf_name(sub) == "v" and len(shape) <= 1:
        return ()
    return param_spec(sub if sub else path, shape, mesh)


def batch_spec(name: str, shape: Sequence[int], mesh) -> Spec:
    """A batch leaf: its batch axis over the FSDP axes, else ``"data"``
    (axis 1 of a ``(3, B, S)`` M-RoPE ``pos``)."""
    mesh = mesh_shape(mesh)
    fsdp = dp_axes(mesh)
    if name == "pos" and len(shape) == 3:  # (3, B, S)
        return _canon((None, _fit(mesh, shape[1], fsdp, "data"), None))
    s = [None] * len(shape)
    if len(shape) >= 1:
        s[0] = _fit(mesh, shape[0], fsdp, "data")
    return _canon(s)


def cache_spec(name: str, shape: Sequence[int], mesh) -> Spec:
    """A decode cache leaf, stacked ``(L, B, ...)``: batch over the FSDP
    axes when it divides, heads/channels over ``"model"``, else the
    sequence over ``"model"``."""
    mesh = mesh_shape(mesh)
    fsdp = dp_axes(mesh)
    tp = "model"
    nd = len(shape)
    if nd == 0:
        return ()
    s = [None] * nd
    if name in ("k", "v") and nd == 5:  # (L, B, KV, S, hd)
        s[1] = _fit(mesh, shape[1], fsdp, "data")
        s[2] = _fit(mesh, shape[2], tp)
        if s[2] is None:
            s[3] = _fit(mesh, shape[3], tp)
        return _canon(s)
    if name in ("k", "v") and nd == 4:  # whisper (L?, B, KV, S, hd) alt
        s[0] = _fit(mesh, shape[0], fsdp, "data")
        s[1] = _fit(mesh, shape[1], tp)
        return _canon(s)
    if nd >= 3:  # recurrent states (L, B, H, ...) / conv (L, B, k, ch)
        s[1] = _fit(mesh, shape[1], fsdp, "data")
        if name == "conv":
            s[nd - 1] = _fit(mesh, shape[nd - 1], tp)
        else:
            s[2] = _fit(mesh, shape[2], tp)
        return _canon(s)
    return _canon(s)


# ------------------------------------------------ the port's trees
def _stack_of(cfg) -> Dict[str, Tuple[Tuple[str, ...], int]]:
    """A port layer's name prefix (``layers.5``, ``dec.3``) -> the
    reference's key path of its stack and the stack's layer count."""
    from ..interop import _stacks

    out = {}
    for ref, port, count in _stacks(cfg):
        for i in range(count):
            out[port(i)] = (tuple(str(r) for r in ref), count)
    return out


def reference_path(stacks, name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """The reference's key path of the port's parameter ``name`` and its
    stack's layer count (None for an unstacked leaf)."""
    parts = name.split(".")
    hit = stacks.get(".".join(parts[:2]))
    if hit is None:
        return tuple(parts), None
    return hit[0] + tuple(parts[2:]), hit[1]


def _unstacked(rule, path, shape, count) -> Spec:
    """``rule`` on the stacked shape, the stack's dim dropped."""
    shape = tuple(int(s) for s in shape)
    if count is None:
        return rule(path, shape)
    return rule(path, (count,) + shape)[1:]


def param_specs(cfg, params: Dict[str, torch.Tensor], mesh, serve_tp_only: bool = False
                ) -> Dict[str, Spec]:
    """The spec of each of ``cfg``'s model's parameters, by name."""
    mesh = mesh_shape(mesh)
    stacks = _stack_of(cfg)
    rule = lambda p, s: param_spec(p, s, mesh, serve_tp_only)  # noqa: E731
    out = {}
    for k, p in params.items():
        path, count = reference_path(stacks, k)
        out[k] = _unstacked(rule, path, p.shape, count)
    return out


def opt_state_specs(cfg, opt_state: Dict, mesh) -> Dict:
    """Specs in the structure of ``train/optim.py``'s state: AdamW's
    ``m``/``v`` and Adafactor's ``f/<name>/{r,c,v}`` by the reference's
    rule for their stacked leaf, ``step`` replicated."""
    mesh = mesh_shape(mesh)
    stacks = _stack_of(cfg)
    rule = lambda p, s: opt_leaf_spec(p, s, mesh)  # noqa: E731
    out: Dict[str, Any] = {}
    for part, val in opt_state.items():
        if part == "step":
            out[part] = ()
        elif part in ("m", "v"):
            out[part] = {}
            for k, t in val.items():
                path, count = reference_path(stacks, k)
                out[part][k] = _unstacked(rule, (part,) + path, t.shape, count)
        else:  # f: {name: {r, c} or {v}}
            out[part] = {}
            for k, fs in val.items():
                path, count = reference_path(stacks, k)
                # a stacked vector's c spans the layers, and replicates
                # as every factored vector does: its rule needs no count
                out[part][k] = {j: _unstacked(rule, (part,) + path + (j,), t.shape,
                                              None if j in ("r", "c") else count)
                                for j, t in fs.items()}
    return out


def batch_specs(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, Spec]:
    mesh = mesh_shape(mesh)
    return {k: batch_spec(k, v.shape, mesh) for k, v in batch.items()}


def cache_specs(cfg, caches: Dict, mesh) -> Dict:
    """Specs in the structure of the port's caches: ``DecoderLM``'s
    ``{"layers": [a dict a layer], "len"}``, each layer by its stack's
    rule, or ``WhisperModel``'s ``{"cross", "self", "len"}``, already
    stacked as the reference's; ``len`` (a Python int) gets ``()``."""
    mesh = mesh_shape(mesh)
    rule = lambda p, s: cache_spec(p[-1], s, mesh)  # noqa: E731
    if "layers" not in caches:
        return {part: () if part == "len" else {k: rule((k,), t.shape) for k, t in val.items()}
                for part, val in caches.items()}
    counts = [count for _, count in cfg.segments() for _ in range(count)]
    return {
        "layers": [{k: _unstacked(rule, (k,), t.shape, n) for k, t in layer.items()}
                   for layer, n in zip(caches["layers"], counts)],
        "len": (),
    }


# ------------------------------------------------------- placements
def placements(spec: Spec, mesh) -> tuple:
    """A spec as DTensor placements, one a mesh dim: ``Shard(d)`` where
    the dim's axis shards tensor dim ``d``, else ``Replicate()``.  A dim
    sharded over several axes lists them in mesh order (the reference's
    FSDP tuple), each its ``Shard(d)``."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_shape(mesh).axis_names
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} out of the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: axis {names[i]!r} shards two dims")
            out[i] = Shard(d)
    return tuple(out)


class Sharding(NamedTuple):
    """Where a leaf lives: a mesh and its placements (the counterpart of
    ``NamedSharding``)."""

    mesh: Any
    placements: tuple


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists (a spec, a tuple,
    is a leaf)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def named(mesh, specs):
    """A tree of specs -> a tree of ``Sharding`` on ``mesh``."""
    return _map(lambda s: Sharding(mesh, placements(s, mesh)), specs)


def shard_of(t: torch.Tensor, mesh, pl: Sequence) -> torch.Tensor:
    """This rank's slice of the whole tensor ``t`` under placements ``pl``
    (a copy): mesh dims in order, each splitting its tensor dim evenly."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(pl):
        if p.is_shard():
            n = t.shape[p.dim] // mesh.size(i)
            t = t.narrow(p.dim, coord[i] * n, n)
    return t.clone()


def place(tree, shardings):
    """Each tensor leaf of ``tree`` placed as a DTensor by its
    ``Sharding`` (None: kept as it is), from this rank's slice of the whole
    tensor every rank holds; a tensor met twice (Adafactor's shared ``c``)
    is placed once.  Other leaves (a cache's ``len``) are kept."""
    from torch.distributed.tensor import DTensor

    done: Dict[int, Any] = {}

    def one(t, sh):
        if not isinstance(t, torch.Tensor) or sh is None:
            return t
        key = id(t)
        if key not in done:
            whole = gather_full(t).detach()
            done[key] = DTensor.from_local(shard_of(whole, sh.mesh, sh.placements), sh.mesh,
                                           sh.placements, run_check=False, shape=whole.shape,
                                           stride=_contiguous_stride(whole.shape))
        return done[key]

    return _map(one, tree, shardings)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def is_placed(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local(x):
    """A DTensor's local shard itself (no autograd view); any other value
    as it is."""
    if not is_placed(x):
        return x
    with torch.no_grad():
        return x.to_local()


def resident_bytes(tree) -> int:
    """Bytes of the distinct local storages of ``tree``'s tensors: what
    this rank holds of it."""
    seen: Dict[int, int] = {}
    for t in _leaves(tree):
        if isinstance(t, torch.Tensor):
            st = local(t).untyped_storage()
            seen.setdefault(st.data_ptr() if st.nbytes() else id(st), st.nbytes())
    return sum(seen.values())


def _leaves(tree) -> Iterator:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of a ``shape`` leaf under ``spec``
    (a spec shorter than the shape replicates the dims it leaves out)."""
    mesh = mesh_shape(mesh)
    return tuple(int(s) // _axsize(mesh, e) for s, e in zip(shape, spec)) + tuple(shape[len(spec):])


# ------------------------------------------------------- collectives
def _staged(group, x: torch.Tensor) -> bool:
    """Whether ``x`` crosses ``group`` (None: the default group) through
    host memory: gloo with a card's tensor."""
    import torch.distributed as dist

    return dist.get_backend(group) == "gloo" and x.device.type == "cuda"


def _host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


#: the bytes a rank hands one bucketed gather (bounds the staging memory)
BUCKET_BYTES = 1 << 28


def _buckets(items):
    """``[(key, tensor)]`` in runs of at most ``BUCKET_BYTES`` (at least one
    item a run)."""
    out, cur, size = [], [], 0
    for k, t in items:
        n = t.numel() * t.element_size()
        if cur and size + n > BUCKET_BYTES:
            out.append(cur)
            cur, size = [], 0
        cur.append((k, t))
        size += n
    if cur:
        out.append(cur)
    return out


def _span(t: torch.Tensor) -> int:
    """``t``'s bytes in a packed buffer: padded to 16, so that every
    tensor's view of its slice is aligned for its dtype."""
    return -(-t.numel() * t.element_size() // 16) * 16


def _pack(ts) -> torch.Tensor:
    """The bytes of ``ts`` end to end (uint8, each ``_span`` long)."""
    buf = torch.zeros(sum(_span(t) for t in ts), dtype=torch.uint8, device=ts[0].device)
    off = 0
    for t in ts:
        n = t.numel() * t.element_size()
        buf[off: off + n] = t.contiguous().reshape(-1).view(torch.uint8)
        off += _span(t)
    return buf


def _unpack(buf: torch.Tensor, likes) -> list:
    """Tensors shaped and typed as ``likes`` over ``buf``'s bytes (views)."""
    out, off = [], 0
    for t in likes:
        n = t.numel() * t.element_size()
        out.append(buf[off: off + n].view(t.dtype).reshape(t.shape))
        off += _span(t)
    return out


def _all_gather_bytes(buf: torch.Tensor, mesh, i: int) -> list:
    """Every rank's ``buf`` over mesh dim ``i``'s group, in its order, on
    ``buf``'s device."""
    import torch.distributed as dist

    group = mesh.get_group(i)
    h = _host(buf) if _staged(group, buf) else buf
    parts = [torch.empty_like(h) for _ in range(mesh.size(i))]
    dist.all_gather(parts, h, group=group)
    return [p.to(buf.device) for p in parts]


def _gather_bytes(buf: torch.Tensor) -> Optional[list]:
    """Every rank's ``buf`` (of the default group), on rank 0 only (on
    ``buf``'s device); None elsewhere."""
    import torch.distributed as dist

    h = _host(buf) if _staged(None, buf) else buf
    parts = [torch.empty_like(h) for _ in range(dist.get_world_size())] if dist.get_rank() == 0 else None
    dist.gather(h, parts, dst=0)
    return None if parts is None else [p.to(buf.device) for p in parts]


def _region(shape, placements, mesh, coord) -> tuple:
    """The slices of the whole tensor that the rank at ``coord`` holds."""
    lo, size = [0] * len(shape), list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            size[p.dim] //= mesh.size(i)
            lo[p.dim] += coord[i] * size[p.dim]
    return tuple(slice(a, a + n) for a, n in zip(lo, size))


def whole_tree(shards: Dict[str, torch.Tensor], pls: Dict[str, Sequence], mesh
               ) -> Dict[str, torch.Tensor]:
    """The whole tensors of this rank's ``shards`` under placements
    ``pls``, on every rank: for each mesh dim, the last first, one
    all-gather of the bytes of every shard it splits (in buckets)."""
    out = dict(shards)
    for i in reversed(range(mesh.ndim)):
        keys = [k for k in out if pls[k][i].is_shard()]
        for bucket in _buckets([(k, out[k]) for k in keys]):
            likes = [t for _, t in bucket]
            parts = [_unpack(p, likes) for p in _all_gather_bytes(_pack(likes), mesh, i)]
            for j, (k, _) in enumerate(bucket):
                out[k] = torch.cat([part[j] for part in parts], dim=pls[k][i].dim)
    return out


def gather_tree(tree: Dict[str, Any]) -> Optional[Dict[str, torch.Tensor]]:
    """The whole tensors of a flat dict of DTensors (plain tensors, which
    every rank holds whole, pass as replicated), on rank 0 of the default
    group only (None elsewhere): one ``gather`` of every rank's shards'
    bytes (in buckets), assembled by each rank's coordinate."""
    import torch.distributed as dist

    out = {} if dist.get_rank() == 0 else None
    for bucket in _buckets([(k, local(v)) for k, v in tree.items()]):
        likes = [t for _, t in bucket]
        parts = _gather_bytes(_pack(likes))
        if parts is None:
            continue
        for (k, mine), in_order in zip(bucket, zip(*[_unpack(p, likes) for p in parts])):
            x = tree[k]
            if not is_placed(x):
                out[k] = in_order[0].clone()
                continue
            whole = torch.empty(x.shape, dtype=mine.dtype, device=mine.device)
            for r, shard in enumerate(in_order):
                coord = [int(c) for c in (x.device_mesh.mesh == r).nonzero()[0]]
                whole[_region(x.shape, x.placements, x.device_mesh, coord)] = shard
            out[k] = whole
    return out


def gather_full(x):
    """The whole tensor of a DTensor on every rank of its mesh (a
    collective, ``whole_tree``); a plain tensor as it is."""
    if not is_placed(x):
        return x
    return whole_tree({"x": local(x)}, {"x": x.placements}, x.device_mesh)["x"]


def reduce_to(g: torch.Tensor, pl: Sequence, mesh, dims: Sequence[int]) -> torch.Tensor:
    """This rank's shard, under placements ``pl``, of the sum of ``g`` over
    the ranks of mesh dims ``dims`` (each holding a whole ``g``, the same
    along the other dims): mesh dims in order, a dim of ``dims`` reduces
    and scatters where it shards (reduce-scatter) and reduces where it
    replicates (all-reduce), any other dim takes its slice."""
    coord = mesh.get_coordinate()
    out = g
    for i, p in enumerate(pl):
        if i in dims:
            out = _reduce_scatter(out, mesh, i, p.dim) if p.is_shard() else all_reduce(out, mesh, [i])
        elif p.is_shard():
            n = out.shape[p.dim] // mesh.size(i)
            out = out.narrow(p.dim, coord[i] * n, n)
    return out.contiguous()


def replicas(pl: Sequence, mesh) -> int:
    """How many ranks hold the same shard under placements ``pl``."""
    n = 1
    for i, p in enumerate(pl):
        if not p.is_shard():
            n *= mesh.size(i)
    return n


def _reduce_scatter(x: torch.Tensor, mesh, i: int, dim: int) -> torch.Tensor:
    """``x`` summed over mesh dim ``i``'s group, this rank keeping its
    chunk of tensor dim ``dim``."""
    import torch.distributed as dist

    group = mesh.get_group(i)
    h = x.movedim(dim, 0).contiguous()
    h = _host(h) if _staged(group, x) else h
    out = torch.empty((h.shape[0] // mesh.size(i),) + tuple(h.shape[1:]), dtype=h.dtype,
                      device=h.device)
    dist.reduce_scatter_tensor(out, h, group=group)
    return out.to(x.device).movedim(0, dim)


def all_reduce(x: torch.Tensor, mesh, dims: Sequence[int], op: str = "sum") -> torch.Tensor:
    """``x`` summed (``op="sum"``) or maximized over the ranks of the mesh
    dims ``dims`` (a new tensor; ``x`` as it is over no dim)."""
    import torch.distributed as dist

    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    for i in dims:
        group = mesh.get_group(i)
        h = _host(x) if _staged(group, x) else x.clone()
        dist.all_reduce(h, op=red, group=group)
        x = h.to(x.device)
    return x


# ---------------------------------------------------- the batch split
class BatchSplit(NamedTuple):
    """The mesh dims a train step splits its batch's leading axis over
    (``batch_specs``): each rank runs the forward on its slice, and the
    slices lie in the order of those dims' coordinates."""

    mesh: Any
    dims: Tuple[int, ...]

    @property
    def parts(self) -> int:
        n = 1
        for i in self.dims:
            n *= self.mesh.size(i)
        return n

    def arrivals(self, counts: torch.Tensor, t: int) -> Tuple[torch.Tensor, int]:
        """``(before, t_all)`` for a rank holding ``t`` tokens whose pairs
        come ``counts[e]`` a expert: the pairs of each expert on the slices
        before this rank's, and the tokens of all slices.  One all-gather
        over the world (every rank of a replica group agrees)."""
        import torch.distributed as dist

        mesh = self.mesh
        row = torch.cat([counts.new_tensor([t]), counts.detach()]).to(torch.int64)
        row = _host(row) if _staged(None, row) else row  # NCCL takes it on the card
        rows = [torch.empty_like(row) for _ in range(dist.get_world_size())]
        dist.all_gather(rows, row)
        grid = torch.stack(rows).cpu()[mesh.mesh.flatten()].reshape(tuple(mesh.mesh.shape) + (-1,))
        coord = mesh.get_coordinate()
        at = tuple(slice(None) if i in self.dims else coord[i] for i in range(mesh.ndim))
        mine = 0
        for i in self.dims:
            mine = mine * mesh.size(i) + coord[i]
        slices = grid[at].reshape(self.parts, -1)
        before = slices[:mine, 1:].sum(0).to(counts.device)
        return before, int(slices[:, 0].sum())


_SPLIT: Optional[BatchSplit] = None  # a module global: autograd's threads read it too


@contextlib.contextmanager
def batch_split(split: Optional[BatchSplit]):
    """``split`` in scope for the code under it (the forward and the
    backward's recomputation): what ``current_split`` returns."""
    global _SPLIT
    before, _SPLIT = _SPLIT, split
    try:
        yield
    finally:
        _SPLIT = before


def current_split() -> Optional[BatchSplit]:
    return _SPLIT


# ------------------------------------------------------------ constrain
def constrain(x, *spec):
    """Best-effort sharding constraint: ``x`` redistributed to ``spec``
    when it is a DTensor whose mesh has the named axes, on dims the axis
    size divides; anything else is returned as it is."""
    if not is_placed(x):
        return x
    mesh = x.device_mesh
    ms = mesh_shape(mesh)
    names = set(ms.axis_names)

    def ok(s, dim):
        if s is None:
            return None
        if isinstance(s, tuple):
            sub = tuple(a for a in s if a in names)
            if not sub:
                return None
            return sub if dim % _axsize(ms, sub) == 0 else None
        if s not in names:
            return None
        return s if dim % ms.shape[s] == 0 else None

    fixed = tuple(ok(s, d) for s, d in zip(spec, x.shape))
    if all(s is None for s in fixed):
        return x
    return x.redistribute(mesh, placements(fixed, mesh))
