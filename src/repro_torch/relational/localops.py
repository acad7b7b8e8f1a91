"""Per-shard (single-reducer) relational operations, over leading batch axes.

Every function takes tables ``(*B, n, ar)`` with valid ``(*B, n)`` — the
reducer axis and, on the fused path, the op group's instance axis — and
works on each segment of ``B`` independently, so one call (and one kernel
launch per hot loop) serves a whole fused op group.

Everything is exact for arbitrary arities/domains: multi-column keys are
dictionary-encoded with ``dense_ranks`` (concat + lexsort + run ids), never
hashed.  "Too many output tuples" surfaces as an overflow count (the
paper's abort), never silent truncation.

The hot loops — hash bucketing, membership probes and sorted match
ranges — go through a **local backend registry**
(``register_local_backend``):

- ``'torch'`` — the plain PyTorch versions (``kernels.ref``), on any
  device: the CPU default and the card's reference;
- ``'cuda'``  — the hand-written Hopper kernels (``kernels``), for CUDA
  tensors only; CPU tensors raise.

Both are bit-identical; the engine threads the choice down from
``GymConfig.local_backend``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..kernels import ops as K
from .hashing import dense_ranks, dests_for, seed_tensor, self_ranks

I32MAX = 2**31 - 1


# --------------------------------------------------------------------------
# local backend registry: who executes the per-shard hot loops
# --------------------------------------------------------------------------
LOCAL_BACKENDS: Dict[str, "LocalBackend"] = {}


def register_local_backend(name: str):
    """Class decorator: make a ``LocalBackend`` selectable by name."""

    def deco(cls):
        cls.name = name
        LOCAL_BACKENDS[name] = cls()
        return cls

    return deco


def get_local_backend(name: str) -> "LocalBackend":
    try:
        return LOCAL_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown local backend {name!r}; registered: {sorted(LOCAL_BACKENDS)}"
        ) from None


def default_backend(device) -> str:
    """``'cuda'`` on a CUDA device, ``'torch'`` on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def _seg(x: torch.Tensor, tail: int) -> torch.Tensor:
    """Flatten every axis but the last ``tail`` into one segment axis."""
    lead = x.shape[: x.dim() - tail]
    return x.reshape((math.prod(lead),) + tuple(x.shape[x.dim() - tail:]))


class LocalBackend:
    """The three per-shard hot loops every operator is built from, over
    leading batch axes.

    Implementations must be bit-identical: ``dests`` to
    ``hashing.dests_for``; ``member_mask`` / ``probe_ranges`` to
    sort + binary search over the ``dense_ranks`` int32 encoding (probe
    values < INT32_MAX; invalid key slots == INT32_MAX)."""

    name = "?"

    def dests(self, data, valid, cols, p: int, seed) -> torch.Tensor:
        """Reducer destination in [0,p) per valid row; p for invalid."""
        raise NotImplementedError

    def member_mask(
        self, q: torch.Tensor, keys: torch.Tensor, bound: Optional[int] = None
    ) -> torch.Tensor:
        """mask[..., i] = q[..., i] in keys[...] (keys need NOT be sorted).
        ``bound`` promises every key other than INT32_MAX lies in
        ``[0, bound)``."""
        raise NotImplementedError

    def probe_ranges(self, q: torch.Tensor, sorted_keys: torch.Tensor):
        """(lo, hi) = left/right searchsorted of q in sorted_keys."""
        raise NotImplementedError


@register_local_backend("torch")
class TorchBackend(LocalBackend):
    """Plain PyTorch versions of the kernels (``kernels.ref``), any device."""

    def dests(self, data, valid, cols, p, seed):
        return dests_for(data, valid, cols, p, seed)

    def member_mask(self, q, keys, bound=None):
        out = K.semijoin_probe(_seg(q, 1), _seg(keys, 1), bound=bound, use_cuda=False)
        return out.reshape(q.shape)

    def probe_ranges(self, q, sorted_keys):
        lo, hi = K.sorted_probe_ranges(_seg(q, 1), _seg(sorted_keys, 1), use_cuda=False)
        return lo.reshape(q.shape), hi.reshape(q.shape)


@register_local_backend("cuda")
class CudaBackend(LocalBackend):
    """Hand-written Hopper kernels (``csrc/gym_kernels.cu``); CUDA tensors
    only — a CPU tensor raises rather than falling back."""

    @staticmethod
    def _need_cuda(t: torch.Tensor) -> None:
        if not t.is_cuda:
            raise ValueError(
                "local_backend='cuda' needs CUDA tensors, got a tensor on "
                f"{t.device}; use local_backend='torch' on the CPU"
            )

    def dests(self, data, valid, cols, p, seed):
        self._need_cuda(data)
        batch = tuple(data.shape[:-2])
        n = data.shape[-2]
        keys = data[..., list(cols)] if tuple(cols) != tuple(range(data.shape[-1])) else data
        keys = _seg(keys, 2).contiguous()
        seeds = seed_tensor(seed, batch, data.device).reshape(math.prod(batch))
        out = K.hash_partition(
            keys, _seg(valid, 1).contiguous(), p, seeds, use_cuda=True
        )
        return out.reshape(batch + (n,))

    def member_mask(self, q, keys, bound=None):
        self._need_cuda(q)
        out = K.semijoin_probe(
            _seg(q, 1).contiguous(), _seg(keys, 1).contiguous(), bound=bound,
            use_cuda=True,
        )
        return out.reshape(q.shape)

    def probe_ranges(self, q, sorted_keys):
        self._need_cuda(q)
        lo, hi = K.sorted_probe_ranges(
            _seg(q, 1).contiguous(), _seg(sorted_keys, 1).contiguous(),
            use_cuda=True,
        )
        return lo.reshape(q.shape), hi.reshape(q.shape)


# --------------------------------------------------------------------------
# shard-local operators
# --------------------------------------------------------------------------
def take_cols(data: torch.Tensor, cols) -> torch.Tensor:
    """Gather columns: ``cols`` is a static tuple or a ``(*B, c)`` int
    tensor of per-segment column indices (the fused path's key columns)."""
    if not isinstance(cols, torch.Tensor):
        if not len(cols):
            return data[..., :0]
        return data[..., list(cols)]
    n = data.shape[-2]
    idx = cols.to(torch.int64).unsqueeze(-2).expand(*cols.shape[:-1], n, cols.shape[-1])
    return data.gather(-1, idx)


def compact(
    data: torch.Tensor, valid: torch.Tensor, out_cap: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Move valid rows to the front (stable) and resize to ``out_cap``.

    Returns (data, valid, dropped_count per segment)."""
    n, ar = data.shape[-2], data.shape[-1]
    lead = tuple(data.shape[:-2])
    d = _seg(data, 2)
    v = _seg(valid, 1)
    vi = v.to(torch.int64)
    cnt = vi.sum(-1)
    # the stable partition valid-first: each row's position in it
    pos = torch.where(
        v, torch.cumsum(vi, -1) - 1, cnt[:, None] + torch.cumsum(1 - vi, -1) - 1
    )
    width = max(n, out_cap)
    od = torch.zeros((d.shape[0], width, ar), dtype=data.dtype, device=data.device)
    ov = torch.zeros((d.shape[0], width), dtype=torch.bool, device=data.device)
    od.scatter_(1, pos.unsqueeze(-1).expand(-1, -1, ar), d)
    ov.scatter_(1, pos, v)
    dropped = (cnt - out_cap).clamp(min=0)
    return (
        od[:, :out_cap].reshape(lead + (out_cap, ar)),
        ov[:, :out_cap].reshape(lead + (out_cap,)),
        dropped.reshape(lead),
    )


def local_join(
    a_data, a_valid, b_data, b_valid, a_key: Sequence[int], b_key: Sequence[int],
    b_keep, out_cap: int, backend: str = "torch",
):
    """Natural join on the given key columns.

    Output rows are ``a_row ++ b_row[b_keep]``.  Returns (out_data
    (*B, out_cap, a_ar + len(b_keep)), out_valid, overflow_count)."""
    ra, rb = dense_ranks(a_data, a_valid, a_key, b_data, b_valid, b_key)
    return local_join_ranked(
        a_data, a_valid, ra, b_data, b_valid, rb, b_keep, out_cap, backend
    )


def local_join_ranked(
    a_data, a_valid, ra, b_data, b_valid, rb, b_keep, out_cap: int,
    backend: str = "torch",
):
    """Join expansion given precomputed shared key ranks (``dense_ranks``).

    ``b_keep`` may be a static tuple OR a ``(*B, nkeep)`` tensor of
    per-segment column indices."""
    be = get_local_backend(backend)
    lead = tuple(a_data.shape[:-2])
    na, a_ar = a_data.shape[-2], a_data.shape[-1]
    nb, b_ar = b_data.shape[-2], b_data.shape[-1]
    dev = a_data.device
    ad, av, rav = _seg(a_data, 2), _seg(a_valid, 1), _seg(ra, 1)
    bd, bv, rbv = _seg(b_data, 2), _seg(b_valid, 1), _seg(rb, 1)
    s = ad.shape[0]
    rb_key = torch.where(bv, rbv, torch.full_like(rbv, I32MAX))
    rb_sorted, order_b = torch.sort(rb_key, dim=-1, stable=True)
    lo, hi = be.probe_ranges(rav, rb_sorted)
    counts = torch.where(av, (hi - lo).to(torch.int64), 0)
    offsets = torch.cumsum(counts, -1)
    total = offsets[:, -1] if na else torch.zeros((s,), dtype=torch.int64, device=dev)
    # i[t] = #{j : offsets[j] <= t}: the a-row output slot t expands
    hist = torch.zeros((s, out_cap + 1), dtype=torch.int64, device=dev)
    hist.scatter_add_(1, offsets.clamp(max=out_cap), torch.ones_like(offsets))
    i = torch.cumsum(hist[:, :out_cap], -1)
    i_c = i.clamp(0, max(na - 1, 0))
    prev = torch.where(
        i_c > 0, offsets.gather(-1, (i_c - 1).clamp(min=0)), 0
    )
    t = torch.arange(out_cap, device=dev)
    within = t - prev
    j_sorted = (lo.to(torch.int64).gather(-1, i_c) + within).clamp(0, max(nb - 1, 0))
    j = order_b.gather(-1, j_sorted)
    out_valid = t < total[:, None]
    left = ad.gather(1, i_c.unsqueeze(-1).expand(-1, -1, a_ar))
    right = bd.gather(1, j.unsqueeze(-1).expand(-1, -1, b_ar))
    if isinstance(b_keep, torch.Tensor):
        right = take_cols(right, _seg(b_keep, 1))
    else:
        right = take_cols(right, tuple(b_keep))
    out = torch.cat([left, right], dim=-1)
    out = torch.where(out_valid.unsqueeze(-1), out, 0)
    overflow = (total - out_cap).clamp(min=0)
    w = out.shape[-1]
    return (
        out.reshape(lead + (out_cap, w)),
        out_valid.reshape(lead + (out_cap,)),
        overflow.reshape(lead),
    )


def local_join_count(
    a_data, a_valid, b_data, b_valid, a_key, b_key, backend: str = "torch"
) -> torch.Tensor:
    """Exact output size of the join per segment (for capacity planning)."""
    be = get_local_backend(backend)
    ra, rb = dense_ranks(a_data, a_valid, a_key, b_data, b_valid, b_key)
    rb_sorted = torch.sort(
        torch.where(b_valid, rb, torch.full_like(rb, I32MAX)), dim=-1
    ).values
    lo, hi = be.probe_ranges(ra, rb_sorted)
    return torch.where(a_valid, (hi - lo).to(torch.int64), 0).sum(-1)


def local_semijoin_mask(
    s_data, s_valid, s_key: Sequence[int], r_data, r_valid, r_key: Sequence[int],
    backend: str = "torch",
) -> torch.Tensor:
    """Mask of S rows whose key appears in R (S |>< R)."""
    be = get_local_backend(backend)
    rs, rr = dense_ranks(s_data, s_valid, s_key, r_data, r_valid, r_key)
    keys = torch.where(r_valid, rr, torch.full_like(rr, I32MAX))
    # dense ranks of the n S and m R rows lie in [0, n + m); invalid S rows
    # probe -1, invalid R rows become INT32_MAX padding
    return s_valid & be.member_mask(rs, keys, bound=rs.shape[-1] + keys.shape[-1])


def local_dedup_mask(data, valid, cols: Sequence[int]) -> torch.Tensor:
    """Keep-first mask of distinct rows (by ``cols``)."""
    n = data.shape[-2]
    if n == 0:
        return valid.clone()
    ranks = self_ranks(data, valid, cols).to(torch.int64)
    idx = torch.arange(n, device=data.device).expand(valid.shape)
    src = torch.where(valid, idx, I32MAX)
    seg = ranks.clamp(0, n - 1)
    first = torch.full(valid.shape, I32MAX, dtype=torch.int64, device=data.device)
    first = first.scatter_reduce(-1, seg, src, reduce="amin", include_self=False)
    return valid & (idx == first.gather(-1, seg))


def local_intersect_mask(
    a_data, a_valid, b_data, b_valid, a_cols: Sequence[int], b_cols: Sequence[int],
    backend: str = "torch",
) -> torch.Tensor:
    """Mask of A rows present in B (full-row by aligned columns)."""
    return local_semijoin_mask(
        a_data, a_valid, a_cols, b_data, b_valid, b_cols, backend
    )


def local_project(
    data, valid, cols: Sequence[int], dedup: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    out = take_cols(data, tuple(cols))
    v = valid
    if dedup:
        v = local_dedup_mask(out, valid, tuple(range(len(cols))))
    out = torch.where(v.unsqueeze(-1), out, 0)
    return out, v
