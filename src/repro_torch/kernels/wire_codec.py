"""The packed wire's codec on the card — a kernel pair of the port's own.

The reference computes ``wire_encode``/``wire_decode``
(``repro/relational/wire.py``) with XLA element-wise operations, not
Pallas: under ``jit`` XLA fuses the gather of every word to one lane per
row bit, the shifts and the group transpose into one pass.  Eager
PyTorch would materialise each step as a ``(slots, row_bits)`` tensor —
about 30 GB for one real-size S_8 bucket buffer — so the port's plain
versions (``relational/wire.py``) loop over the ``row_bits`` bit planes
instead, and the card gets one pass each way here
(``csrc/wire_codec.cu``): encode reads each slot's ``1 + arity`` words
once and writes its ``row_bits`` bits (one warp per 32 slots, one
``__ballot_sync`` per row bit gives four groups' bytes); decode is the
inverse.  Both are bound by memory bytes.

Problem: ``buf (S, c, ar)`` int32 and ``valid (S, c)`` bool, contiguous,
S segments (the flattened shard, instance and destination axes) ->
``(S, ceil(c/8) * row_bits)`` uint8, and back.  A row of more than
``MAX_ROW_BITS`` bits does not fit the kernels' shared-memory staging and
raises.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from ..relational import wire as W

#: kernel launches since the last reset (not counting plain-version calls)
encode_launches = 0
decode_launches = 0

#: 8 warps a block each stage 4 groups of row_bits bytes: 48 KiB of
#: shared memory holds rows of up to 1536 bits
MAX_ROW_BITS = 48 * 1024 // 32


@functools.lru_cache(maxsize=None)
def _col_bits(col_bits: Tuple[int, ...], device: str) -> torch.Tensor:
    return torch.tensor(col_bits or (0,), dtype=torch.int32, device=device)


def _check_fmt(fmt: W.WireFormat, name: str) -> None:
    if not 1 <= fmt.row_bits <= MAX_ROW_BITS or not all(1 <= b <= 32 for b in fmt.col_bits):
        raise ValueError(
            f"{name}: column widths must lie in [1, 32] and a row hold at most "
            f"{MAX_ROW_BITS} bits, got {fmt.col_bits}"
        )


def wire_encode(buf: torch.Tensor, valid: torch.Tensor, fmt: W.WireFormat) -> torch.Tensor:
    """Pack ``buf (S, c, ar)`` + ``valid (S, c)`` into ``(S, nbytes)``
    uint8.  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if valid.device.type == "cpu":
        return W.wire_encode(buf, valid, fmt)
    global encode_launches
    from . import build

    if not valid.is_cuda:
        raise ValueError(f"wire_encode: unsupported device {valid.device}")
    _check_fmt(fmt, "wire_encode")
    if valid.dim() != 2 or valid.dtype != torch.bool or not valid.is_contiguous():
        raise ValueError(
            f"wire_encode: valid must be contiguous (S, c) bool, got "
            f"{tuple(valid.shape)} {valid.dtype} contiguous={valid.is_contiguous()}"
        )
    s, c = valid.shape
    if (
        buf.shape != (s, c, fmt.arity) or buf.dtype != torch.int32
        or buf.device != valid.device or not buf.is_contiguous()
    ):
        raise ValueError(
            f"wire_encode: buf must be contiguous ({s}, {c}, {fmt.arity}) int32 on "
            f"{valid.device}, got {tuple(buf.shape)} {buf.dtype} on {buf.device}"
        )
    out = torch.empty((s, fmt.bucket_bytes(c)), dtype=torch.uint8, device=valid.device)
    if out.numel() == 0:
        return out
    bits = _col_bits(fmt.col_bits, str(valid.device))
    lib = build.load()
    err = lib.gym_wire_encode(
        buf.data_ptr(), valid.data_ptr(), bits.data_ptr(), out.data_ptr(),
        s, c, fmt.arity, fmt.row_bits, build.stream_handle(valid.device),
    )
    build.check(err, "gym_wire_encode")
    encode_launches += 1
    return out


def wire_decode(
    packed: torch.Tensor, fmt: W.WireFormat, c_out: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unpack ``(S, nbytes)`` uint8 into ``(buf (S, c_out, ar) int32,
    valid (S, c_out) bool)``.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if packed.device.type == "cpu":
        return W.wire_decode(packed, fmt, c_out)
    global decode_launches
    from . import build

    if not packed.is_cuda:
        raise ValueError(f"wire_decode: unsupported device {packed.device}")
    _check_fmt(fmt, "wire_decode")
    if (
        packed.dim() != 2 or packed.dtype != torch.uint8 or not packed.is_contiguous()
        or packed.shape[1] != fmt.bucket_bytes(c_out) or c_out < 0
    ):
        raise ValueError(
            f"wire_decode: packed must be contiguous (S, {fmt.bucket_bytes(c_out)}) "
            f"uint8, got {tuple(packed.shape)} {packed.dtype} "
            f"contiguous={packed.is_contiguous()}"
        )
    s = packed.shape[0]
    buf = torch.empty((s, c_out, fmt.arity), dtype=torch.int32, device=packed.device)
    valid = torch.empty((s, c_out), dtype=torch.bool, device=packed.device)
    if valid.numel() == 0:
        return buf, valid
    bits = _col_bits(fmt.col_bits, str(packed.device))
    lib = build.load()
    err = lib.gym_wire_decode(
        packed.data_ptr(), bits.data_ptr(), buf.data_ptr(), valid.data_ptr(),
        s, c_out, fmt.arity, fmt.row_bits, build.stream_handle(packed.device),
    )
    build.check(err, "gym_wire_decode")
    decode_launches += 1
    return buf, valid
