"""Packed wire format for the exchange: bit-level codec + width policy.

The dense exchange ships ``(p, c_out, arity)`` int32 cells plus a
``(p, c_out)`` bool valid plane — 32 bits per cell and 8 per flag even
when every value fits in 6 bits.  This module closes that gap with an
exact codec:

- ``WireFormat`` fixes a per-column bit width; a row packs as
  ``1 valid bit + sum(col_bits)`` contiguous bits, and a whole
  destination bucket of ``c_out`` rows packs as one bit stream padded up
  to bytes.  ``wire_encode``/``wire_decode`` are exact inverses for any
  int32 whose value fits the column width (a 32-bit column round-trips
  any int32, sign bit included).
- ``WirePolicy`` derives sound widths from the *base relations'* value
  ranges, observed once on the host before sharding.  Joins, semijoins,
  intersections and dedups never create new attribute values, so a width
  that covers the base columns of an attribute covers every intermediate
  of the query (``wire_overflow`` checks hand-built formats).
- A fused op group's mixed-schema exchanges concatenate their encoded
  buffers into ONE segmented uint8 buffer (``pack_segments`` /
  ``split_segments``), so the group ships a single all_to_all.
- ``register_codec`` is the compression hook: a codec wraps the packed
  bytes right before/after the collective; the exact channel ships the
  ``raw`` identity codec.

Bit layout (the reference's, pinned by ``tests/fixtures/wire_s8_packed.npz``):
a bucket's slots go in groups of 8 consecutive slots (the bucket is
padded with invalid slots up to a multiple of 8); each group packs to
exactly ``row_bits`` bytes, where byte ``b`` holds bit ``b`` of every
slot's row stream — slot ``r`` of the group in bit ``r`` of the byte.
Within a row stream the valid bit comes first, then each column's bits
least-significant first.

``wire_encode``/``wire_decode`` here are the plain PyTorch versions, any
device: one pass per bit plane (``row_bits`` passes), each over the
bucket's slots, writing its byte column of the output in place — peak
memory stays a small multiple of the bucket, never the ``(..., c,
row_bits)`` lane tensor a one-shot gather would build.  The Hopper
kernels (``kernels/wire_codec.py``) do the same work in one pass; the
local backends choose (``localops.LocalBackend.wire_encode``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

MAX_BITS = 32  # columns are int32; 32-bit columns carry the raw bit pattern


def value_bits(lo: int, hi: int) -> int:
    """Bits needed to represent every integer in [lo, hi] exactly.

    Negative values fall back to the full 32-bit width (32 bits carry any
    int32's bit pattern)."""
    if lo < 0:
        return MAX_BITS
    return min(MAX_BITS, max(1, int(hi).bit_length()))


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """Per-column bit widths of one exchange payload (frozen, hashable)."""

    col_bits: Tuple[int, ...]
    codec: str = "raw"

    @property
    def arity(self) -> int:
        return len(self.col_bits)

    @property
    def row_bits(self) -> int:
        return 1 + sum(self.col_bits)  # leading valid bit

    def bucket_bytes(self, c_out: int) -> int:
        """Bytes one destination bucket of ``c_out`` slots packs to:
        ``row_bits`` bytes per group of 8 slots."""
        return (-(-c_out // 8)) * self.row_bits

    def bit_map(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-row-bit source map: bit ``b`` of the row stream reads
        ``(source column, shift)`` where source 0 is the valid plane and
        source ``1+j`` is payload column ``j``."""
        srcs, shifts = [0], [0]
        for j, nb in enumerate(self.col_bits):
            srcs.extend([j + 1] * nb)
            shifts.extend(range(nb))
        return np.asarray(srcs), np.asarray(shifts, dtype=np.uint32)

    @property
    def row_payload_bytes(self) -> int:
        """Dense int32 bytes of one useful row (the tuple-accounting byte
        value, independent of the wire encoding)."""
        return 4 * max(1, self.arity)

    @staticmethod
    def union(fmts: Sequence["WireFormat"]) -> "WireFormat":
        """Widest-per-column union — the group-uniform format of a fused
        op group (wider is always sound)."""
        assert fmts
        ar = fmts[0].arity
        assert all(f.arity == ar for f in fmts), [f.arity for f in fmts]
        assert all(f.codec == fmts[0].codec for f in fmts)
        return WireFormat(
            tuple(max(f.col_bits[j] for f in fmts) for j in range(ar)),
            codec=fmts[0].codec,
        )


@dataclasses.dataclass(frozen=True)
class WirePolicy:
    """Sound per-attribute bit widths for one query, derived from the
    base relations before sharding.  ``format_for`` projects the policy
    onto any intermediate schema."""

    attr_bits: Tuple[Tuple[str, int], ...]
    default_bits: int = MAX_BITS
    codec: str = "raw"

    @classmethod
    def from_columns(
        cls, items: Iterable[Tuple[Sequence[str], np.ndarray]], *, codec: str = "raw",
    ) -> "WirePolicy":
        """items: (schema, host rows (n, arity)) per base relation.  An
        attribute's width covers its values in EVERY base column that
        carries it; attributes with no rows pack to 1 bit."""
        bits: Dict[str, int] = {}
        for schema, rows in items:
            rows = np.asarray(rows)
            for j, attr in enumerate(schema):
                if rows.shape[0]:
                    col = rows[:, j]
                    b = value_bits(int(col.min()), int(col.max()))
                else:
                    b = 1
                bits[attr] = max(bits.get(attr, 1), b)
        return cls(tuple(sorted(bits.items())), codec=codec)

    def bits_for(self, attr: str) -> int:
        for a, b in self.attr_bits:
            if a == attr:
                return b
        return self.default_bits

    def format_for(self, schema: Sequence[str]) -> WireFormat:
        return WireFormat(tuple(self.bits_for(a) for a in schema), codec=self.codec)


# ------------------------------------------------------------------- codec
def _padded_groups(c: int) -> int:
    return -(-c // 8)


def wire_encode(buf: torch.Tensor, valid: torch.Tensor, fmt: WireFormat) -> torch.Tensor:
    """Pack ``buf (..., c, arity) int32`` + ``valid (..., c) bool`` into a
    ``(..., fmt.bucket_bytes(c)) uint8`` bit stream (the plain version:
    one pass per bit plane).  Values must fit their column width."""
    lead = tuple(valid.shape[:-1])
    c = valid.shape[-1]
    ng = _padded_groups(c)
    cp = 8 * ng
    dev = valid.device
    out = torch.empty(lead + (ng, fmt.row_bits), dtype=torch.uint8, device=dev)
    if ng == 0:
        return out.reshape(lead + (0,))
    # (..., cp, 1 + arity) int32 words, padded slots all-zero (invalid)
    words = torch.zeros(lead + (cp, 1 + fmt.arity), dtype=torch.int32, device=dev)
    words[..., :c, 0] = valid.to(torch.int32)
    if fmt.arity:
        words[..., :c, 1:] = buf.to(torch.int32)
    words = words.reshape(lead + (ng, 8, 1 + fmt.arity))
    # bit r of a byte is slot r of its group
    weight = torch.tensor([1 << r for r in range(8)], dtype=torch.int32, device=dev)
    srcs, shifts = fmt.bit_map()
    for b, (src, sh) in enumerate(zip(srcs.tolist(), shifts.tolist())):
        # an arithmetic shift keeps bit ``sh`` of the int32 pattern at bit
        # 0 for every sh in [0, 32), so negatives need no unsigned view
        plane = (words[..., int(src)] >> int(sh)) & 1  # (..., ng, 8)
        out[..., b] = (plane * weight).sum(-1).to(torch.uint8)
    return out.reshape(lead + (ng * fmt.row_bits,))


def wire_decode(
    packed: torch.Tensor, fmt: WireFormat, c_out: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact inverse of ``wire_encode``: ``(..., nbytes) uint8`` back to
    ``(buf (..., c_out, arity) int32, valid (..., c_out) bool)`` (the
    plain version: one pass per bit plane).  Invalid slots decode to
    all-zero rows, as the dense path's zero-filled buckets."""
    lead = tuple(packed.shape[:-1])
    ng = _padded_groups(c_out)
    cp = 8 * ng
    dev = packed.device
    bb = packed.reshape(lead + (ng, fmt.row_bits))
    shifts = torch.arange(8, dtype=torch.int32, device=dev)

    def plane(b: int) -> torch.Tensor:
        # byte column b -> bit b of each of the group's 8 slots: (..., cp)
        byte = bb[..., b].to(torch.int32).unsqueeze(-1)
        return ((byte >> shifts) & 1).reshape(lead + (cp,))

    valid = plane(0).to(torch.bool)[..., :c_out]
    buf = torch.zeros(lead + (cp, fmt.arity), dtype=torch.int32, device=dev)
    off = 1
    for j, nb in enumerate(fmt.col_bits):
        acc = torch.zeros(lead + (cp,), dtype=torch.int64, device=dev)
        for k in range(nb):
            acc |= plane(off + k).to(torch.int64) << k
        # bit 31 set: the int32 whose bit pattern this is (wraps mod 2^32)
        buf[..., j] = torch.where(acc >= 2**31, acc - 2**32, acc).to(torch.int32)
        off += nb
    return buf[..., :c_out, :], valid


def wire_overflow(buf: torch.Tensor, valid: torch.Tensor, fmt: WireFormat) -> torch.Tensor:
    """True where a VALID row holds a value its column width cannot
    represent (negative, or >= 2^bits, for widths < 32)."""
    bad = torch.zeros(valid.shape, dtype=torch.bool, device=valid.device)
    for j, nb in enumerate(fmt.col_bits):
        if nb >= MAX_BITS:
            continue
        col = buf[..., j]
        bad = bad | (col < 0) | ((col >> nb) != 0)
    return bad & valid


# -------------------------------------------------------------- segmentation
def pack_segments(wires: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenate per-exchange encoded buffers ``(..., nbytes_i)`` into
    one segmented ``(..., sum nbytes_i)`` buffer — a fused group ships a
    single all_to_all for every op and side."""
    return torch.cat(list(wires), dim=-1)


def split_segments(seg: torch.Tensor, sizes: Sequence[int]) -> List[torch.Tensor]:
    """Undo ``pack_segments`` with the per-segment byte sizes."""
    out = []
    off = 0
    for n in sizes:
        out.append(seg[..., off: off + n])
        off += n
    assert off == seg.shape[-1], (off, tuple(seg.shape))
    return out


# ------------------------------------------------------------ byte accounting
def dense_wire_bytes(p: int, c_out: int, arity: int = 1) -> int:
    """Bytes the DENSE exchange ships end-to-end: p shards x p bucket
    segments x c_out slots of (4-byte int32 cells + 1-byte valid flag).
    The byte-true sibling of ``routed.padded_slots``."""
    return p * p * c_out * (4 * max(1, arity) + 1)


def packed_wire_bytes(p: int, c_out: int, fmt: WireFormat) -> int:
    """Bytes the PACKED exchange ships end-to-end for the same grid."""
    return p * p * fmt.bucket_bytes(c_out)


def count_wire_bytes(p: int, n: int = 1) -> int:
    """Bytes of ``n`` count-only pre-pass vectors ((p,)-int32 per shard,
    no valid plane)."""
    return n * p * p * 4


def wire_gain(fmts: Sequence[Optional[WireFormat]]) -> float:
    """Advisor-side mean compression ratio of a set of exchange formats:
    dense row bits (32/col + 8 valid) over packed row bits; 1.0 for dense
    (None) entries.  ``costs.shuffle_pad_factor`` reprices packed plans
    with it."""
    ratios = []
    for f in fmts:
        if f is None:
            ratios.append(1.0)
        else:
            dense_bits = 32 * max(1, f.arity) + 8
            ratios.append(dense_bits / f.row_bits)
    return float(np.mean(ratios)) if ratios else 1.0


# ------------------------------------------------------------ compression hook
# A codec wraps the packed bytes right before/after the collective:
# encode(u8) -> (payload, aux), decode(payload, aux) -> u8.  The exact
# channel registers only lossless codecs.
_CODECS: Dict[str, Tuple[Callable, Callable]] = {}


def register_codec(name: str, encode: Callable, decode: Callable) -> None:
    _CODECS[name] = (encode, decode)


def get_codec(name: str) -> Tuple[Callable, Callable]:
    if name not in _CODECS:
        raise KeyError(f"unknown wire codec {name!r}: {sorted(_CODECS)}")
    return _CODECS[name]


def codec_roundtrip(buf: torch.Tensor, name: str = "raw") -> torch.Tensor:
    """Encode + decode through a registered codec."""
    enc, dec = get_codec(name)
    payload, aux = enc(buf)
    return dec(payload, aux)


register_codec("raw", lambda b: (b, ()), lambda b, aux: b)
