"""Public entry points of the Hopper kernels, with the kernel/plain switch.

``use_cuda`` picks the CUDA kernel (which needs CUDA tensors and raises on
CPU ones) or the plain PyTorch version (any device); ``None`` follows the
tensors' device.  There is no fallback: a failed build or launch raises.
``launch_counts`` / ``reset_launch_counts`` read and clear the kernels'
launch counters, which count kernel launches only;
``semijoin_probe_path_counts`` splits the probe's count by path.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..relational import wire as _wire

from . import flash_attention as _fa
from . import hash_partition as _hp
from . import ref
from . import semijoin_probe as _sp
from . import sorted_probe as _so
from . import wire_codec as _wc


def _want_cuda(t: torch.Tensor, use_cuda: Optional[bool], name: str) -> bool:
    if use_cuda is None:
        return t.is_cuda
    if use_cuda and not t.is_cuda:
        raise ValueError(
            f"{name}: use_cuda=True needs CUDA tensors, got a tensor on {t.device}"
        )
    return use_cuda


def semijoin_probe(
    q: torch.Tensor,
    keys: torch.Tensor,
    *,
    bound: Optional[int] = None,
    use_cuda: Optional[bool] = None,
) -> torch.Tensor:
    """mask of q in keys per segment.  ``bound`` promises every key other
    than INT32_MAX lies in ``[0, bound)``: the kernel then takes its
    bitmap path (``kernels/semijoin_probe.py``); the plain version
    ignores it."""
    if _want_cuda(q, use_cuda, "semijoin_probe"):
        return _sp.semijoin_probe(q, keys, bound=bound)
    return ref.semijoin_probe_ref(q, keys)


def sorted_probe_ranges(
    q: torch.Tensor, keys: torch.Tensor, *, use_cuda: Optional[bool] = None
):
    """(lo, hi) match ranges of q against SORTED keys (searchsorted pair)."""
    if _want_cuda(q, use_cuda, "sorted_probe_ranges"):
        return _so.sorted_probe_ranges(q, keys)
    return ref.sorted_probe_ranges_ref(q, keys)


def hash_partition(
    keys: torch.Tensor,
    valid: torch.Tensor,
    p: int,
    seeds: torch.Tensor,
    *,
    use_cuda: Optional[bool] = None,
) -> torch.Tensor:
    if _want_cuda(keys, use_cuda, "hash_partition"):
        return _hp.hash_partition(keys, valid, p, seeds)
    return ref.hash_partition_ref(keys, valid, p, seeds)


def wire_encode(buf, valid, fmt, *, use_cuda: Optional[bool] = None) -> torch.Tensor:
    """Packed-wire bytes ``(S, nbytes)`` of ``buf (S, c, ar)`` + ``valid
    (S, c)`` under ``fmt`` (``relational.wire.WireFormat``)."""
    if _want_cuda(valid, use_cuda, "wire_encode"):
        return _wc.wire_encode(buf, valid, fmt)
    return _wire.wire_encode(buf, valid, fmt)


def wire_decode(packed, fmt, c_out: int, *, use_cuda: Optional[bool] = None):
    """Inverse of ``wire_encode``: ``(buf (S, c_out, ar), valid (S, c_out))``."""
    if _want_cuda(packed, use_cuda, "wire_decode"):
        return _wc.wire_decode(packed, fmt, c_out)
    return _wire.wire_decode(packed, fmt, c_out)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
    use_cuda: Optional[bool] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Attention of q ``(B,H,Sq,D)`` over k/v ``(B,KVH,Skv,D)``: the flash
    kernel, or its plain version, per ``use_cuda``.  ``impl='chunked'``,
    the reference's XLA scan for long training sequences, is not ported."""
    if impl == "chunked":
        raise NotImplementedError(
            "attention impl='chunked' is not ported yet (ROADMAP queue A, "
            "item 'LM training': kernels/chunked.py)"
        )
    if impl is not None:
        raise ValueError(f"attention: unknown impl {impl!r}")
    if _want_cuda(q, use_cuda, "attention"):
        return _fa.flash_attention(
            q, k, v, causal=causal, window=window, softcap=softcap, scale=scale
        )
    return ref.flash_attention_ref(
        q, k, v, causal=causal, window=window, softcap=softcap, scale=scale
    )


def launch_counts() -> Dict[str, int]:
    return {
        "hash_partition": _hp.launches,
        "semijoin_probe": _sp.launches,
        "sorted_probe_ranges": _so.launches,
        "flash_attention": _fa.launches,
        "wire_encode": _wc.encode_launches,
        "wire_decode": _wc.decode_launches,
    }


def semijoin_probe_path_counts() -> Dict[str, int]:
    """``semijoin_probe`` launches by path (``bitmap`` / ``hash``)."""
    return dict(_sp.path_launches)


def reset_launch_counts() -> None:
    _hp.launches = 0
    _sp.launches = 0
    _sp.path_launches.update(bitmap=0, hash=0)
    _so.launches = 0
    _fa.launches = 0
    _wc.encode_launches = 0
    _wc.decode_launches = 0
