"""Flash attention — online-softmax attention, the compute hot spot of
every LM block's prefill.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (the Pallas
``_attn_kernel``).  Contract: q ``(B, H, Sq, D)``, k/v ``(B, KVH, Skv, D)``
with ``H % KVH == 0``; head ``h`` reads kv-head ``h // (H // KVH)``.  Key
``col`` is visible from query ``row`` when ``col < Skv``, (causal)
``col <= row`` — aligned top-left in absolute positions, with no shift
when ``Sq != Skv`` — and (``window > 0``) ``col > row - window``.  Scores
are ``q.k * scale`` (``scale`` defaults to ``D**-0.5``), then
``softcap * tanh(s / softcap)`` when ``softcap > 0``.  The softmax and
the output accumulate in f32; the output has q's dtype.

A masked entry contributes exactly 0 and a row with no visible key is 0,
as ``kernels/ref.py::attention_ref`` gives.  The TPU kernel differs there:
inside a kv tile where a row sees nothing its running max is still the
``-1e30`` fill, so ``exp(s - m) = exp(0) = 1`` for every masked entry and
a row that never sees a key comes out as the mean of V over the masked
keys, not 0 (a fault of the reference, recorded in ROADMAP C).  The model
path never meets such a row: prefill is causal with ``Sq == Skv``.

Hopper design (``csrc/flash_attention.cu``).  At the main path's shapes
the work is bound by operations (``4*B*H*D`` per visible pair: 348 GFLOP
for B=2, H=16, S=4608, D=256 causal; 0.35 ms at the bf16 tensor-core
peak) rather than by its 226 MB of q, k, v and o, so the bf16 path runs
both products on the tensor cores: a block of two warpgroups owns 128 q
rows (64 each), K/V tiles of 64 keys arrive by TMA into a 2-stage ring of
swizzled shared-memory tiles, ``S = Q K^T`` and ``O += P V`` are ``wgmma``
with bf16 operands and f32 accumulators, the online softmax runs on the
accumulator fragment in registers and P stays there, in bf16, as the A
operand of the second product.  A loop over kv tiles takes the place of
the TPU's sequential kv grid axis; tiles wholly above the causal diagonal
or left of the window are never loaded.  The bf16 kernel is compiled for
D = 64, 128, 256; the f32 path (CUDA-core FMAs, f32 tiles in shared
memory; TF32 would miss the f32 tolerance) for D = 16, 32, 64, 128, 256.
The wrapper pads any other D <= 256 with zero columns.  The launcher's
return code reports a refused launch.

Rounding: for f32 inputs the kernel and the plain version differ only in
summation order.  For bf16 inputs both form the scores exactly from the
bf16 inputs with f32 sums; the kernel then rounds the weights P to bf16
for the tensor-core product P V (the plain version keeps them in f32),
a relative error of at most 2**-9 a weight, and both round the f32 output
once to bf16.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

#: kernel launches since the last reset (not counting plain-version calls)
launches = 0

#: head widths the kernels are compiled for, by dtype; any other D <= 256
#: is padded with zero columns up to the next one (zeros change no score)
KERNEL_D = {torch.float32: (16, 32, 64, 128, 256), torch.bfloat16: (64, 128, 256)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention: q (B,H,Sq,D), k/v (B,KVH,Skv,D) expected, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] == 0 or h % k.shape[1]:
        raise ValueError(
            f"flash_attention: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
            "(same B and D, H a multiple of KVH)"
        )


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
    blk_k: int = 512,
) -> torch.Tensor:
    """Plain PyTorch version: ``_attn_kernel``'s blockwise online-softmax
    loop over kv blocks of ``blk_k`` keys, all queries at once, in f32,
    with masked entries contributing exactly 0.  It is differentiable
    (``kernels/ops.py``'s ``impl="dense"``): every value autograd saves
    is finite."""
    _check_shapes(q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    g = h // k.shape[1]
    scale = float(scale) if scale is not None else float(d) ** -0.5
    qf = q.float()
    dev = q.device
    rows = torch.arange(sq, device=dev)[:, None]
    m = torch.full((b, h, sq, 1), float("-inf"), device=dev)
    l = torch.zeros((b, h, sq, 1), device=dev)
    acc = torch.zeros((b, h, sq, d), device=dev)
    for k0 in range(0, sk, blk_k):
        kb = k[:, :, k0:k0 + blk_k].float().repeat_interleave(g, dim=1)
        vb = v[:, :, k0:k0 + blk_k].float().repeat_interleave(g, dim=1)
        s = (qf @ kb.transpose(-1, -2)) * scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        cols = torch.arange(k0, k0 + kb.shape[2], device=dev)[None, :]
        mask = torch.ones((sq, kb.shape[2]), dtype=torch.bool, device=dev)
        if causal:
            mask &= cols <= rows
        if window > 0:
            mask &= cols > rows - window
        s = s.masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # a row that has seen nothing yet keeps weight 0 everywhere; its
        # max is -inf, taken as 0 so that no exp meets -inf - -inf (whose
        # NaN would reach the gradient through the unselected branch)
        m_safe = torch.where(m_new == float("-inf"), 0.0, m_new)
        corr = torch.exp(m - m_safe)
        p = torch.where(mask, torch.exp(s - m_safe), 0.0)
        l = corr * l + p.sum(dim=-1, keepdim=True)
        acc = corr * acc + p @ vb
        m = m_new
    # no visible key -> 0 (divided by 1, not 0, for the same reason)
    out = torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)
    return out.to(q.dtype)


def refuse_autograd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise when autograd would record through the kernel: it has no
    backward (nor has the reference's), and its output would otherwise
    carry no gradient back to q, k and v, without an error."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention: the kernel has no backward, and autograd records "
            "through these inputs; train with impl='chunked' or impl='dense' "
            "(kernels/ops.py::attention), or call it under torch.no_grad()"
        )


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of q ``(B,H,Sq,D)`` over k/v ``(B,KVH,Skv,D)`` -> ``(B,H,Sq,D)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, softcap=softcap, scale=scale
        )
    global launches
    from . import build

    refuse_autograd(q, k, v)

    for name, t in (("q", q), ("k", k), ("v", v)):
        if (
            not t.is_cuda or t.dtype not in _DTYPES or t.dtype != q.dtype
            or not t.is_contiguous() or t.device != q.device
        ):
            raise ValueError(
                f"flash_attention: {name} must be a contiguous float32 or bfloat16 "
                f"tensor on {q.device} with q's dtype, got {tuple(t.shape)} "
                f"{t.dtype} {t.device} contiguous={t.is_contiguous()}"
            )
    _check_shapes(q, k, v)
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    widths = KERNEL_D[q.dtype]
    if d > widths[-1] or d == 0:
        raise ValueError(f"flash_attention: head width {d} not in 1..{widths[-1]}")
    if max(b, h) > 65535 or max(sq, sk) >= 2**31:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} exceeds the grid")
    scale = float(scale) if scale is not None else float(d) ** -0.5
    dk = next(x for x in widths if x >= d)
    if dk != d:
        q, k, v = (F.pad(t, (0, dk - d)) for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        # the bf16 kernel's tensor maps need 16-byte aligned bases
        q, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q, k, v))
    out = torch.empty_like(q)
    if out.numel():
        lib = build.load()
        err = lib.gym_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, h, kvh, sq, sk, dk, scale, int(bool(causal)),
            max(0, min(int(window), 2**31 - 1)), float(softcap),
            build.stream_handle(q.device),
        )
        build.check(err, "gym_flash_attention")
        launches += 1
    return out if dk == d else out[..., :d].contiguous()
