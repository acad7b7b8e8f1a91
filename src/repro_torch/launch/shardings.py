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
  ``all_reduce``: the collectives a placed state and a checkpoint need,
  on the mesh's own groups or to rank 0, the gathers bucketed over many
  tensors' bytes (gloo moves a card's tensors through pinned host memory,
  as ``relational/spmd.py`` does, and no bf16: the bytes travel as uint8);
- ``Counter`` and ``counting``: every collective's result bytes by kind
  and mesh axis, on the card, the CPU and ``meta`` alike (on ``meta`` a
  collective counts and calls no process group: the dry run's trace);
- ``Partition``, ``partitioned``, ``fetch``: the partitioned step's view
  of a model's parameters, each layer's gathered inside its own call, the
  gradients sent back into each rank's shards (``reduce_replicated`` for
  the leaves the data axes replicate); Megatron's f and g
  (``col_product``, ``row_product``, ``to_model``, ``from_model``), the
  ``"model"`` regions' sums in f32, or in f64 where they round to bf16
  (``_model_sum``: the rounding then does not depend on the order the
  collective adds in); serving's vocab-parallel tables
  (``vocab_embed``, ``vocab_logits``) and activation gathers
  (``gather_model``);
- ``constrain``: the reference's best-effort activation constraint, on a
  DTensor's own mesh (the reference's ambient abstract mesh has no torch
  counterpart) and a no-op on a plain tensor;
- ``batch_split``: the mesh dims a train step splits the batch over, in
  scope for the MoE dispatch, whose capacity and arrival order are the
  whole batch's (``models/mlp.py``); ``batch_dims`` and ``batch_slices``
  (over ``split_batch``'s microbatches): those dims and this rank's
  slices, for the train step and mesh serving alike.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

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
    ``buf``'s device (on ``meta``: empty tensors, no collective)."""
    import torch.distributed as dist

    _count("all-gather", _axis(mesh, i), mesh.size(i) * _nbytes(buf))
    if buf.is_meta:
        return [torch.empty_like(buf) for _ in range(mesh.size(i))]
    group = mesh.get_group(i)
    if not _staged(group, buf):
        parts = [torch.empty_like(buf) for _ in range(mesh.size(i))]
        dist.all_gather(parts, buf, group=group)
        return parts
    # into one pinned buffer, which goes to the card in one copy: a copy a
    # part would wait on the card once a part, behind every rank sharing it
    out = torch.empty((mesh.size(i),) + tuple(buf.shape), dtype=buf.dtype, pin_memory=True)
    dist.all_gather(list(out.unbind(0)), _host(buf), group=group)
    return list(out.to(buf.device, non_blocking=True).unbind(0))


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

    n = mesh.size(i)
    _count("reduce-scatter", _axis(mesh, i), _nbytes(x) // n)
    if x.is_meta:
        shape = list(x.shape)
        shape[dim] //= n
        return x.new_empty(shape)
    group = mesh.get_group(i)
    h = x.movedim(dim, 0).contiguous()
    staged = _staged(group, x)
    h = _host(h) if staged else h
    out = torch.empty((h.shape[0] // mesh.size(i),) + tuple(h.shape[1:]), dtype=h.dtype,
                      device=h.device, pin_memory=staged)
    dist.reduce_scatter_tensor(out, h, group=group)
    return out.to(x.device, non_blocking=True).movedim(0, dim)


def all_reduce(x: torch.Tensor, mesh, dims: Sequence[int], op: str = "sum") -> torch.Tensor:
    """``x`` summed (``op="sum"``) or maximized over the ranks of the mesh
    dims ``dims`` (a new tensor; ``x`` as it is over no dim)."""
    import torch.distributed as dist

    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    for i in dims:
        _count("all-reduce", _axis(mesh, i), _nbytes(x))
        if x.is_meta:
            x = torch.empty_like(x)
            continue
        group = mesh.get_group(i)
        h = _host(x) if _staged(group, x) else x.clone()
        dist.all_reduce(h, op=red, group=group)
        x = h.to(x.device, non_blocking=True)
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
        world = mesh_shape(mesh).size
        _count("all-gather", "+".join(mesh_shape(mesh).axis_names), world * 8 * (counts.numel() + 1))
        if counts.is_meta:  # a traced step: nothing to rank, the batch's size known
            return torch.zeros_like(counts), t * self.parts
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


def split_batch(batch: Dict[str, torch.Tensor], accum: int):
    """``accum`` microbatches of ``batch``: every entry split on its batch
    axis, which is axis 1 of a ``(3, B, S)`` M-RoPE ``pos`` and axis 0
    otherwise."""
    out = [dict() for _ in range(accum)]
    for k, v in batch.items():
        axis = 1 if k == "pos" and v.dim() == 3 else 0
        if v.shape[axis] % accum:
            raise ValueError(f"batch {k} {tuple(v.shape)}: axis {axis} not divisible by {accum}")
        for mb, part in zip(out, torch.chunk(v, accum, dim=axis)):
            mb[k] = part
    return out


def batch_dims(batch: Dict[str, torch.Tensor], mesh) -> Tuple[int, ...]:
    """The mesh dims of two or more ranks that split ``batch`` (the batch
    axis of its ``tokens``, or of its first entry, under ``batch_specs``)."""
    key = "tokens" if "tokens" in batch else next(iter(batch))
    spec = batch_specs({key: batch[key]}, mesh)[key]
    lead = spec[1] if key == "pos" and batch[key].dim() == 3 else spec[0]
    axes = (lead,) if isinstance(lead, str) else tuple(lead or ())
    ms = mesh_shape(mesh)
    return tuple(ms.axis_names.index(a) for a in axes if ms.shape[a] > 1)


def batch_slices(batch: Dict[str, torch.Tensor], accum: int, mesh) -> List[Dict]:
    """This rank's slice of each of ``batch``'s ``accum`` microbatches
    (``batch`` whole: plain tensors every rank holds)."""
    mbs = split_batch(batch, accum) if accum > 1 else [batch]
    pls = {k: placements(s, mesh) for k, s in batch_specs(mbs[0], mesh).items()}
    return [{k: shard_of(v, mesh, pls[k]) for k, v in mb.items()} for mb in mbs]


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


# ------------------------------------------------- the collective counter
class Counter:
    """Collective bytes by kind (``all-gather``, ``reduce-scatter``,
    ``all-reduce``) and mesh axis, as the reference's
    ``roofline.parse_collective_bytes`` counts them: each collective's
    result bytes on one device (an all-gather's whole result, a
    reduce-scatter's shard, an all-reduce's tensor).  A collective over
    several axes (the MoE's arrival counts over the world) is keyed by
    their names joined with ``+``."""

    def __init__(self):
        self.bytes: Dict[Tuple[str, str], int] = {}
        #: the ``id`` of every parameter a ``fetch`` gathered over ``"model"``
        self.model_gathered: set = set()

    def add(self, kind: str, axis: str, n: int) -> None:
        self.bytes[kind, axis] = self.bytes.get((kind, axis), 0) + int(n)

    def by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for (kind, _), n in self.bytes.items():
            out[kind] = out.get(kind, 0) + n
        return out

    def by_axis(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for (kind, axis), n in sorted(self.bytes.items()):
            out.setdefault(kind, {})[axis] = n
        return out

    def total(self) -> int:
        return sum(self.bytes.values())


_COUNTERS: list = []  # module globals, as ``_SPLIT``: autograd's threads count too


@contextlib.contextmanager
def counting(counter: Optional[Counter] = None):
    """Count every collective of ``launch/shardings.py`` under it (on the
    card, on the CPU and on ``meta`` alike) into ``counter`` (a new one by
    default), which it yields."""
    counter = Counter() if counter is None else counter
    _COUNTERS.append(counter)
    try:
        yield counter
    finally:
        _COUNTERS.remove(counter)


def _count(kind: str, axis: str, n: int) -> None:
    for c in _COUNTERS:
        c.add(kind, axis, n)


def _axis(mesh, i: int) -> str:
    return mesh_shape(mesh).axis_names[i]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ------------------------------------------- the partitioned layer's view
class Partition:
    """How a model's parameters lie on ``mesh`` while a partitioned step
    runs: each parameter's placements (``where``, by ``id``), the mesh
    dims that split the batch (``split``: along them ranks hold different
    data, so gradients sum), where gradients land (``grads``: ``id`` ->
    this rank's f32 shard of the summed gradient, or None where no
    backward runs), and the decode KV caches' split (``kv``: ``"heads"``,
    ``("seq", s_cache)`` or None, replicated over ``"model"``)."""

    def __init__(self, mesh, where: Dict[int, Sequence], split: Sequence[int] = (),
                 grads: Optional[Dict[int, torch.Tensor]] = None, kv=None):
        self.mesh = mesh
        self.where = where
        self.split = tuple(split)
        self.grads = grads
        self.kv = kv
        names = mesh_shape(mesh).axis_names
        self.model = names.index("model") if "model" in names else None
        self.m = mesh.size(self.model) if self.model is not None else 1
        self.coord = tuple(mesh.get_coordinate())

    @property
    def rank_in_model(self) -> int:
        return self.coord[self.model] if self.model is not None else 0

    def model_dim(self, t: torch.Tensor) -> Optional[int]:
        """The tensor dim of ``t`` that ``"model"`` shards (None: it
        replicates ``t``, or the mesh has no ``"model"`` of 2 or more)."""
        if self.m == 1:
            return None
        p = self.where[id(t)][self.model]
        return p.dim if p.is_shard() else None


_PART: Optional[Partition] = None  # a module global: autograd's threads read it too


@contextlib.contextmanager
def partitioned(part: Optional[Partition]):
    """``part`` in scope for the code under it: the layers' parameters come
    through ``fetch``, the ``"model"`` regions through ``to_model`` and
    ``from_model``."""
    global _PART
    before, _PART = _PART, part
    try:
        yield
    finally:
        _PART = before


def current_partition() -> Optional[Partition]:
    return _PART


def model_split() -> Tuple[int, int]:
    """``(m, i)``: the size of the current partition's ``"model"`` axis and
    this rank's coordinate on it (``(1, 0)`` with no partition)."""
    part = _PART
    return (1, 0) if part is None else (part.m, part.rank_in_model)


#: ``fetch`` modes for the ``"model"`` dim of a parameter: ``local``
#: computes on this rank's shard; ``partial`` gathers it whole (or takes a
#: replicated one as it is) inside a ``"model"`` region, where each rank's
#: gradient is a part of the sum; ``replicated`` gathers it whole where
#: every model rank computes the same thing
MODES = ("local", "partial", "replicated")


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            yield prefix + k, v
        else:
            yield from _flat(v, prefix + k + ".")


def _nest(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in flat.items():
        *head, last = k.split(".")
        node = out
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def fetch(tree, modes: Optional[Dict[str, str]] = None):
    """The tensors a layer computes with, from ``tree`` (a dict, nested or
    not, of parameters: a ``ParameterDict``).  With no partition in scope,
    ``tree`` itself.  Under one (``partitioned``), a dict of the same keys:
    each parameter gathered whole over the mesh dims that shard it, except
    ``"model"`` where its mode (``modes[key]``, default ``replicated``;
    ``MODES``) is ``local``.  The backward sends each parameter's
    gradient into the partition's ``grads``, in f32, as this rank's shard
    of the sum over the ranks that split the batch (a reduce-scatter where
    the gather went, a slice where the gathered dim's ranks computed the
    same thing) and, for ``partial``, over ``"model"`` (a reduce-scatter,
    or an all-reduce of a replicated parameter)."""
    part = _PART
    if part is None:
        return tree
    modes = modes or {}
    keys, leaves, plans = [], [], []
    for k, t in _flat(tree):
        mode = modes.get(k, "replicated")
        if mode not in MODES:
            raise ValueError(f"fetch: mode {mode!r} of {k} not in {MODES}")
        pl = part.where[id(t)]
        gathers = []
        for i in reversed(range(len(pl))):
            if not pl[i].is_shard() or part.mesh.size(i) == 1 or (i == part.model and mode == "local"):
                continue
            if i == part.model:
                how = "sum" if mode == "partial" else "slice"
            else:
                how = "sum" if i in part.split else "slice"
            gathers.append((i, pl[i].dim, how))
        if mode == "local" and part.m > 1 and not pl[part.model].is_shard():
            raise ValueError(f"fetch: {k} is local on 'model', which does not shard it")
        model_sum = (mode == "partial" and part.m > 1 and not pl[part.model].is_shard())
        if any(i == part.model for i, _, _ in gathers):
            for c in _COUNTERS:
                c.model_gathered.add(id(t))
        keys.append(k)
        leaves.append(t)
        plans.append((id(t), tuple(gathers), model_sum))
    outs = _Fetch.apply(part, tuple(plans), *leaves)
    return _nest(dict(zip(keys, outs)))


def fetch_one(t: torch.Tensor, mode: str = "replicated") -> torch.Tensor:
    """``fetch`` of one parameter."""
    return fetch({"t": t}, {"t": mode})["t"]


def _all_gather_dim(ts: list, dims: list, mesh, i: int) -> list:
    """Each of ``ts`` whole along its ``dims`` entry over mesh dim ``i``
    (one all-gather of their bytes)."""
    likes = [t.contiguous() for t in ts]
    parts = [_unpack(p, likes) for p in _all_gather_bytes(_pack(likes), mesh, i)]
    return [torch.cat([part[j] for part in parts], dim=d) for j, d in enumerate(dims)]


def _reduce_scatter_dim(gs: list, dims: list, mesh, i: int) -> list:
    """Each of the f32 ``gs`` summed over mesh dim ``i``'s group, this rank
    keeping its chunk along its ``dims`` entry (one reduce-scatter)."""
    n = mesh.size(i)
    rows = [g.movedim(d, 0).reshape(n, -1) for g, d in zip(gs, dims)]
    widths = [r.shape[1] for r in rows]
    out = _reduce_scatter(torch.cat(rows, dim=1), mesh, i, 0)[0]
    res = []
    for g, d, piece in zip(gs, dims, out.split(widths)):
        shape = list(g.movedim(d, 0).shape)
        shape[0] //= n
        res.append(piece.reshape(shape).movedim(0, d))
    return res


def _all_reduce_many(gs: list, mesh, dims: Sequence[int]) -> list:
    """Each of the f32 ``gs`` summed over the mesh dims ``dims`` (one
    all-reduce a dim of their elements end to end)."""
    if not gs:
        return []
    flat = all_reduce(torch.cat([g.reshape(-1) for g in gs]), mesh, dims)
    return [piece.reshape(g.shape) for g, piece in zip(gs, flat.split([g.numel() for g in gs]))]


class _Fetch(torch.autograd.Function):
    """``fetch``'s gathers (forward) and gradient sends (backward)."""

    @staticmethod
    def forward(ctx, part, plans, *leaves):
        ctx.part, ctx.plans = part, plans
        ctx.shapes = [t.shape for t in leaves]
        outs = [t.detach() for t in leaves]
        for i in reversed(range(part.mesh.ndim)):
            hit = [(j, d) for j, (_, gathers, _) in enumerate(plans) for gi, d, _ in gathers if gi == i]
            if hit:
                got = _all_gather_dim([outs[j] for j, _ in hit], [d for _, d in hit], part.mesh, i)
                for (j, _), t in zip(hit, got):
                    outs[j] = t
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        part, plans = ctx.part, ctx.plans
        mesh = part.mesh
        gs = [g.float() for g in grads]
        for i in range(mesh.ndim):
            summed = [(j, d) for j, (_, gathers, _) in enumerate(plans)
                      for gi, d, how in gathers if gi == i and how == "sum"]
            for j, (_, gathers, _) in enumerate(plans):
                for gi, d, how in gathers:
                    if gi == i and how == "slice":
                        n = gs[j].shape[d] // mesh.size(i)
                        gs[j] = gs[j].narrow(d, part.coord[i] * n, n)
            if summed:
                got = _reduce_scatter_dim([gs[j] for j, _ in summed], [d for _, d in summed], mesh, i)
                for (j, _), g in zip(summed, got):
                    gs[j] = g
        summed = [j for j, (_, _, model_sum) in enumerate(plans) if model_sum]
        for j, g in zip(summed, _all_reduce_many([gs[j] for j in summed], mesh, [part.model])):
            gs[j] = g
        if part.grads is None:
            raise RuntimeError("a backward through fetch with no gradient sink (Partition.grads)")
        for (key, _, _), g, shape in zip(plans, gs, ctx.shapes):
            g = g.contiguous().reshape(shape)
            have = part.grads.get(key)
            part.grads[key] = g if have is None else have + g
        return (None, None) + (None,) * len(plans)


class _ToModel(torch.autograd.Function):
    """Megatron's f: the identity, whose backward sums over ``"model"``."""

    @staticmethod
    def forward(ctx, x, part):
        ctx.part = part
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _model_sum(g.float(), ctx.part, g.dtype), None


class _FromModel(torch.autograd.Function):
    """Megatron's g: the sum over ``"model"``, whose backward is the
    identity."""

    @staticmethod
    def forward(ctx, x, part, dtype):
        return _model_sum(x, part, dtype)

    @staticmethod
    def backward(ctx, g):
        return g.float(), None, None


class _ColProduct(torch.autograd.Function):
    """``x @ w`` on this rank's ``"model"`` columns ``w`` (``col_product``)."""

    @staticmethod
    def forward(ctx, x, w, part):
        ctx.part = part
        ctx.save_for_backward(x, w)
        return x @ w

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        part = ctx.part
        dx = _model_sum(_f32_product(dy, w.transpose(-1, -2)), part, x.dtype)
        dw = x.reshape(-1, x.shape[-1]).transpose(0, 1) @ dy.reshape(-1, dy.shape[-1])
        return dx, dw.reshape(w.shape), None


def col_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` where ``w`` is this rank's ``"model"`` shard of a
    column-parallel weight and ``x`` is the same on every model rank:
    Megatron's f folded into the product, its backward's ``dx`` summed over
    ``"model"`` before it is rounded to ``x``'s dtype (``_model_sum``), so
    a bf16 ``dx`` rounds once, as the single process' one product does.
    ``x @ w`` with no partition or one model rank."""
    part = _PART
    if part is None or part.m == 1:
        return x @ w
    return _ColProduct.apply(x, w, part)


def to_model(x: torch.Tensor) -> torch.Tensor:
    """Enter a ``"model"`` region (Megatron's f): ``x`` as it is, its
    gradient summed over the model ranks, each of which computes a part of
    what follows.  The identity with no partition or one model rank."""
    part = _PART
    if part is None or part.m == 1:
        return x
    return _ToModel.apply(x, part)


def _model_sum(x: torch.Tensor, part: Partition, dtype: torch.dtype) -> torch.Tensor:
    """The f32 parts ``x`` summed over ``part``'s model ranks and rounded
    to ``dtype``.  A result narrower than f32 is summed in f64, where a
    sum of a few f32 terms is exact (to 2^-53 of it where they lie over
    2^27 apart), so it rounds the same whatever order the collective adds
    in: the step equals, bit for bit, one process that adds the ranks'
    parts in any order and rounds once.  An f32 result is summed in f32."""
    wide = torch.float32 if dtype == torch.float32 else torch.float64
    return all_reduce(x.to(wide), part.mesh, [part.model]).to(dtype)


def from_model(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Leave a ``"model"`` region (Megatron's g): the sum over the model
    ranks of their f32 parts ``x``, rounded to ``dtype`` once
    (``_model_sum``).  ``x`` in ``dtype`` with no partition or one model
    rank."""
    part = _PART
    x = x.float()
    if part is None or part.m == 1:
        return x.to(dtype)
    return _FromModel.apply(x, part, dtype)


def _f32_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` with an f32 result and no rounding between: on the card a
    bf16 product keeps its bf16 inputs (``torch.mm``'s ``out_dtype``);
    elsewhere the inputs are widened."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        flat = torch.mm(a.reshape(-1, a.shape[-1]), w, out_dtype=torch.float32)
        return flat.reshape(a.shape[:-1] + (w.shape[-1],))
    return a.float() @ w.float()


class _RowProduct(torch.autograd.Function):
    """``row_product`` of a narrower dtype: the f32 product, whose
    gradient (the f32 image of a gradient in ``a``'s dtype, which the
    rounding after the sum passes back) runs in ``a``'s dtype, as the
    single process' product's does."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return _f32_product(a, w)

    @staticmethod
    def backward(ctx, dy):
        a, w = ctx.saved_tensors
        dy = dy.to(a.dtype)
        da = dy @ w.transpose(-1, -2)
        dw = a.reshape(-1, a.shape[-1]).transpose(0, 1) @ dy.reshape(-1, dy.shape[-1])
        return da, dw.reshape(w.shape)


def row_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in f32, with no rounding to ``a``'s dtype: a rank's part of
    a row-parallel product, whose sum over ``"model"`` (``from_model``)
    then rounds once, as the single process' one product does."""
    if a.dtype == torch.float32:
        return a @ w
    if torch.is_grad_enabled() and (a.requires_grad or w.requires_grad):
        return _RowProduct.apply(a, w)
    return _f32_product(a, w)


def vocab_split(table: torch.Tensor) -> bool:
    """Whether serving (no autograd) under the current partition takes
    ``table``'s rows on this rank's ``"model"`` shard (vocab-parallel)."""
    part = _PART
    return (part is not None and part.m > 1 and not torch.is_grad_enabled()
            and part.model_dim(table) == 0)


def vocab_embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Serving's embedding lookup on this rank's rows of a vocab-parallel
    ``table`` (``fetch``'s ``local``): each token's row from the one rank
    that holds it, zeros elsewhere, summed over ``"model"`` (exact)."""
    part = _PART
    mine = fetch_one(table, "local")
    n = mine.shape[0]
    lo = part.rank_in_model * n
    ids = tokens.long() - lo
    here = (ids >= 0) & (ids < n)
    rows = mine[ids.clamp(0, n - 1)].float() * here[..., None]
    return all_reduce(rows, part.mesh, [part.model]).to(mine.dtype)


def vocab_logits(x: torch.Tensor, table: torch.Tensor, softcap: float) -> torch.Tensor:
    """Serving's f32 logits on a vocab-parallel ``table``: this rank's
    columns ``x @ rows.T``, gathered over ``"model"`` (each column as the
    whole product computes it)."""
    logits = x.float() @ fetch_one(table, "local").float().T
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    return gather_model(logits, logits.dim() - 1)


def gather_model(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` (a rank's part along ``dim``) whole over the current
    partition's ``"model"`` ranks, in their order: an all-gather of an
    activation, outside autograd (serving)."""
    part = _PART
    return _all_gather_dim([t], [dim], part.mesh, part.model)[0]


def reduce_replicated(grads: Dict[str, torch.Tensor], pls: Dict[str, Sequence], mesh,
                      dims: Sequence[int]) -> Dict[str, torch.Tensor]:
    """``grads`` (f32, this rank's shards) summed over each mesh dim of
    ``dims`` that does not shard them (one all-reduce a dim for all of
    them); the dims that shard a gradient summed it on its way
    (``fetch``)."""
    out = dict(grads)
    for i in dims:
        keys = [k for k in out if not pls[k][i].is_shard()]
        for k, g in zip(keys, _all_reduce_many([out[k] for k in keys], mesh, [i])):
            out[k] = g
    return out
