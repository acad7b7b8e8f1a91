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

The kernel is the operator ``torch.ops.repro_torch.flash_attention``
(``torch.library.define``, its CUDA kernel ``_launch`` registered with
``torch.library.impl``): its contract is a width of
``KERNEL_D`` and 16-byte aligned bases, which the wrapper meets (padding
and aligned copies happen in the wrapper, where a trace sees them).  The
operator has a fake (``meta`` and fake tensors: an empty tensor of q's
shape, no launch) and a flop formula for ``FlopCounterMode``, ``4 B H D``
a visible pair (``visible_pairs``; ``register_flop_formula``), so that
``launch/dryrun.py`` traces the ``'cuda'`` path on ``meta`` tensors.

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


def visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave visible, the work a call needs,
    in closed form (O(1) at any length).  Row ``r`` sees keys ``[lo, hi)``
    with ``hi = min(sk, r + 1)`` (causal) or ``sk``, and ``lo = max(0, r -
    window + 1)`` (``window > 0``) or 0: a count that is linear in ``r``
    between the breakpoints ``sk - 1``, ``window - 1`` and ``sk + window -
    1``, so each piece is an arithmetic series."""
    sq, sk, window = int(sq), int(sk), int(window)
    if sq <= 0 or sk <= 0:
        return 0

    def seen(r: int) -> int:
        hi = min(sk, r + 1) if causal else sk
        lo = max(0, r - window + 1) if window > 0 else 0
        return max(0, hi - lo)

    cuts = {0, sq}
    for c in ((sk - 1, window - 1, sk + window - 1) if window > 0 else (sk - 1,)):
        if 0 < c < sq:
            cuts.add(c)
    cuts = sorted(cuts)
    return sum((seen(a) + seen(b - 1)) * (b - a) // 2 for a, b in zip(cuts, cuts[1:]))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
            softcap: float, scale: float) -> torch.Tensor:
    """The operator's CUDA kernel: q ``(B,H,Sq,D)``, k/v ``(B,KVH,Skv,D)``
    contiguous CUDA tensors of one dtype with ``D`` in ``KERNEL_D[dtype]``
    and 16-byte aligned bases, ``window >= 0`` -> ``(B,H,Sq,D)``, one
    ``ctypes`` launch.  The wrapper ``flash_attention`` meets that contract
    (padding and aligned copies)."""
    global launches
    from . import build

    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel():
        lib = build.load()
        err = lib.gym_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, h, kvh, sq, sk, d, scale, int(causal), window, softcap,
            build.stream_handle(q.device),
        )
        build.check(err, "gym_flash_attention")
        launches += 1
    return out


def _flash_attention_fake(q, k, v, causal, window, softcap, scale):
    """Shape only (``meta`` and fake tensors): nothing is launched or
    counted."""
    return torch.empty_like(q)


# torch.library.define + impl rather than custom_op: custom_op wraps each
# kernel in torch._disable_dynamo, whose first call imports torch._dynamo
# (and triton with it), seconds of host time in every process
torch.library.define(
    "repro_torch::flash_attention",
    "(Tensor q, Tensor k, Tensor v, bool causal, int window, float softcap, float scale) -> Tensor",
)
torch.library.impl("repro_torch::flash_attention", "cuda", _launch)
torch.library.register_fake("repro_torch::flash_attention", _flash_attention_fake)


def _flash_attention_flop(q_shape, k_shape, v_shape, causal, window, *args, out_shape=None,
                          **kwargs) -> int:
    """``4 B H D`` a visible pair (``S = Q K^T`` and ``O = P V``), at the
    width the kernel runs (a padded ``D`` counts its zero columns)."""
    b, h, sq, d = q_shape
    return 4 * b * h * d * visible_pairs(sq, k_shape[2], causal, window)


_flop_formula_registered = False


def register_flop_formula() -> None:
    """Register the operator's flop formula with ``FlopCounterMode`` (once;
    ``launch/dryrun.py`` calls it).  Not done at import: importing
    ``torch.utils.flop_counter`` costs a fresh process seconds of host
    time, which every process that never counts flops would pay."""
    global _flop_formula_registered
    if not _flop_formula_registered:
        from torch.utils.flop_counter import register_flop_formula as register

        register(torch.ops.repro_torch.flash_attention)(_flash_attention_flop)
        _flop_formula_registered = True


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

    CPU tensors take the plain version; CUDA tensors launch the kernel
    through ``torch.ops.repro_torch.flash_attention``, and ``meta`` tensors
    reach its fake (shapes, and the flop count under ``FlopCounterMode``).
    Any other D <= 256 is padded here with zero columns to the next width
    the kernel is built for, and sliced back."""
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, softcap=softcap, scale=scale
        )
    refuse_autograd(q, k, v)

    for name, t in (("q", q), ("k", k), ("v", v)):
        if (
            not (t.is_cuda or t.is_meta) or t.dtype not in _DTYPES or t.dtype != q.dtype
            or not t.is_contiguous() or t.device != q.device
        ):
            raise ValueError(
                f"flash_attention: {name} must be a contiguous float32 or bfloat16 "
                f"tensor on {q.device} (a CUDA device, or meta) with q's dtype, got "
                f"{tuple(t.shape)} {t.dtype} {t.device} contiguous={t.is_contiguous()}"
            )
    _check_shapes(q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
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
    out = torch.ops.repro_torch.flash_attention(
        q, k, v, bool(causal), max(0, min(int(window), 2**31 - 1)), float(softcap), scale
    )
    return out if dk == d else out[..., :d].contiguous()
