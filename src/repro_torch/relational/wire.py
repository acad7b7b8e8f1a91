"""Wire-size accounting of the dense exchange.

The dense exchange ships ``(p, c_out, arity)`` int32 cells plus a
``(p, c_out)`` bool valid plane per shard; the count pre-pass ships
``(p,)`` int32 vectors.  These helpers give the bytes each shipped, for
the ledger's ``payload_bytes``.  The packed (bit-packed) wire format is
not part of the port yet.
"""
from __future__ import annotations


def dense_wire_bytes(p: int, c_out: int, arity: int = 1) -> int:
    """Bytes the DENSE exchange ships end-to-end: p shards x p bucket
    segments x c_out slots of (4-byte int32 cells + 1-byte valid flag).
    The byte-true sibling of ``routed.padded_slots``."""
    return p * p * c_out * (4 * max(1, arity) + 1)


def count_wire_bytes(p: int, n: int = 1) -> int:
    """Bytes of ``n`` count-only pre-pass vectors ((p,)-int32 per shard,
    no valid plane)."""
    return n * p * p * 4
