"""The packed wire's codec and width policy in the port against the JAX
reference (``repro.relational.wire``).

The same inputs, made from a seed with numpy, go through both packages;
bytes, decoded buffers and widths must be equal (exact: all data is int32,
bool or uint8).  The port's ``wire_encode``/``wire_decode`` here are the
plain bit-plane versions (the CPU path of the ``'torch'`` backend and of
the codec kernels' wrappers); the kernels themselves are held against
them on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).  No
gym run here: the file is fast.
"""
from __future__ import annotations

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.queries import star_query  # noqa: E402
from repro.data.synthetic import star_data_sparse  # noqa: E402
from repro.relational import wire as RW  # noqa: E402

from repro_torch.interop import wire_policy_from_tuple  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.relational import localops as TL  # noqa: E402
from repro_torch.relational import shuffle as TS  # noqa: E402
from repro_torch.relational import wire as TW  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "wire_s8_packed.npz")


def _rand_case(rng, col_bits, lead, c, occupancy="random"):
    cols = []
    for nb in col_bits:
        if nb == 32:  # full width: any int32, sign bit included
            col = rng.integers(-(2**31), 2**31, lead + (c,), dtype=np.int64)
        else:
            col = rng.integers(0, 2**nb, lead + (c,), dtype=np.int64)
        cols.append(col.astype(np.int32))
    buf = np.stack(cols, axis=-1) if cols else np.zeros(lead + (c, 0), np.int32)
    if occupancy == "empty":
        valid = np.zeros(lead + (c,), bool)
    elif occupancy == "full":
        valid = np.ones(lead + (c,), bool)
    else:
        valid = rng.integers(0, 2, lead + (c,)).astype(bool)
    return buf, valid


def _both(buf, valid, col_bits):
    """(reference bytes, port bytes, port decode) of one bucket buffer."""
    want = np.asarray(RW.wire_encode(jnp.asarray(buf), jnp.asarray(valid), RW.WireFormat(col_bits)))
    fmt = TW.WireFormat(col_bits)
    got = TW.wire_encode(torch.from_numpy(buf), torch.from_numpy(valid), fmt)
    back = TW.wire_decode(got, fmt, valid.shape[-1])
    return want, got, back


# ------------------------------------------------------------- width policy
@pytest.mark.parametrize("lo,hi", [(0, 0), (0, 1), (0, 2), (0, 63), (0, 64),
                                   (0, 2**31 - 1), (-1, 5), (3, 2**21 - 1)])
def test_value_bits_matches_reference(lo, hi):
    assert TW.value_bits(lo, hi) == RW.value_bits(lo, hi)


def test_format_shapes_union_and_byte_accounting_match_reference():
    for bits in [(), (6, 6), (4, 9, 1), (32,), (21,) * 7]:
        r, t = RW.WireFormat(bits), TW.WireFormat(bits)
        assert (t.arity, t.row_bits, t.row_payload_bytes) == (r.arity, r.row_bits, r.row_payload_bytes)
        for c in (0, 1, 7, 8, 9, 33, 4096):
            assert t.bucket_bytes(c) == r.bucket_bytes(c)
            assert TW.packed_wire_bytes(4, c, t) == RW.packed_wire_bytes(4, c, r)
            assert TW.dense_wire_bytes(8, c, len(bits)) == RW.dense_wire_bytes(8, c, len(bits))
        rs, rh = r.bit_map()
        ts, th = t.bit_map()
        np.testing.assert_array_equal(ts, rs)
        np.testing.assert_array_equal(th, rh)
    assert TW.count_wire_bytes(4, n=3) == RW.count_wire_bytes(4, n=3)
    fmts = [(3, 9), (5, 2)]
    assert TW.WireFormat.union([TW.WireFormat(b) for b in fmts]).col_bits == \
        RW.WireFormat.union([RW.WireFormat(b) for b in fmts]).col_bits == (5, 9)
    with pytest.raises(AssertionError):
        TW.WireFormat.union([TW.WireFormat((3,)), TW.WireFormat((3, 3))])
    mixed = [None, TW.WireFormat((6, 6)), TW.WireFormat((21,) * 7)]
    assert TW.wire_gain(mixed) == RW.wire_gain(
        [None, RW.WireFormat((6, 6)), RW.WireFormat((21,) * 7)]
    )
    assert TW.wire_gain([]) == RW.wire_gain([]) == 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policy_from_columns_matches_reference(seed):
    rng = np.random.default_rng(seed)
    items = [
        (("A", "B"), rng.integers(0, 200, (9, 2)).astype(np.int32)),
        (("B", "C"), rng.integers(-3, 5, (4, 2)).astype(np.int32)),
        (("D",), np.zeros((0, 1), np.int32)),  # empty: packs to 1 bit
        (("C", "E"), rng.integers(0, 2**21, (6, 2)).astype(np.int32)),
    ]
    ref = RW.WirePolicy.from_columns(items)
    port = TW.WirePolicy.from_columns(items)
    assert port.attr_bits == ref.attr_bits
    for attr in ("A", "B", "C", "D", "E", "Z"):
        assert port.bits_for(attr) == ref.bits_for(attr)
    assert port.format_for(("E", "A")).col_bits == ref.format_for(("E", "A")).col_bits
    assert wire_policy_from_tuple(ref.attr_bits) == port


# ------------------------------------------------------------------- codec
@pytest.mark.parametrize("seed", range(8))
def test_encode_bytes_match_reference_random_schemas(seed):
    """Random schemas, widths, occupancies, leading batch dims and bucket
    sizes (c off and on multiples of 8)."""
    rng = np.random.default_rng(seed)
    for _ in range(3):
        col_bits = tuple(int(b) for b in rng.integers(1, 33, int(rng.integers(0, 5))))
        lead = tuple(int(x) for x in rng.integers(1, 4, int(rng.integers(0, 3))))
        c = int(rng.integers(1, 41))
        occ = ["empty", "full", "random"][int(rng.integers(0, 3))]
        buf, valid = _rand_case(rng, col_bits, lead, c, occ)
        want, got, (b2, v2) = _both(buf, valid, col_bits)
        assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(b2.numpy(), buf)
        np.testing.assert_array_equal(v2.numpy(), valid)


@pytest.mark.parametrize("case", ["arity0", "neg32", "c_off_8", "lead_dims", "empty", "full"])
def test_encode_edge_cases_match_reference(case):
    rng = np.random.default_rng(7)
    if case == "arity0":
        col_bits, buf, valid = (), np.zeros((12, 0), np.int32), rng.integers(0, 2, 12).astype(bool)
    elif case == "neg32":
        col_bits = (32,)
        buf = np.asarray([[-1], [-(2**31)], [2**31 - 1], [0], [-7]], np.int32)
        valid = np.asarray([True, True, True, False, True])
    elif case == "c_off_8":
        col_bits = (6, 6)
        buf, valid = _rand_case(rng, col_bits, (), 33)
    elif case == "lead_dims":
        col_bits = (4, 9, 1)
        buf, valid = _rand_case(rng, col_bits, (2, 4), 16)
    else:
        col_bits = (5, 32, 2)
        buf, valid = _rand_case(rng, col_bits, (3,), 24, case)
    want, got, (b2, v2) = _both(buf, valid, col_bits)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(b2.numpy(), buf)
    np.testing.assert_array_equal(v2.numpy(), valid)


def test_empty_bucket_and_decode_of_zero_slots():
    fmt = TW.WireFormat((6,))
    got = TW.wire_encode(torch.zeros((4, 0, 1), dtype=torch.int32),
                         torch.zeros((4, 0), dtype=torch.bool), fmt)
    assert tuple(got.shape) == (4, 0)
    b, v = TW.wire_decode(got, fmt, 0)
    assert tuple(b.shape) == (4, 0, 1) and tuple(v.shape) == (4, 0)


def test_wire_overflow_matches_reference():
    buf = np.asarray([[7, -5], [8, 0], [9, 1], [-1, 3]], np.int32)
    valid = np.asarray([True, True, False, True])
    want = np.asarray(RW.wire_overflow(jnp.asarray(buf), jnp.asarray(valid), RW.WireFormat((3, 32))))
    got = TW.wire_overflow(torch.from_numpy(buf), torch.from_numpy(valid), TW.WireFormat((3, 32)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [False, True, False, True]


def test_pack_split_segments_and_raw_codec():
    rng = np.random.default_rng(2)
    parts = [rng.integers(0, 256, (4, 2, 4, n)).astype(np.uint8) for n in (3, 1, 8)]
    seg = TW.pack_segments([torch.from_numpy(x) for x in parts])
    want = np.asarray(RW.pack_segments([jnp.asarray(x) for x in parts]))
    np.testing.assert_array_equal(seg.numpy(), want)
    back = TW.split_segments(seg, [3, 1, 8])
    for a, b in zip(parts, back):
        np.testing.assert_array_equal(b.numpy(), a)
    with pytest.raises(AssertionError):
        TW.split_segments(seg, [3, 1])
    buf = torch.arange(24, dtype=torch.uint8).reshape(2, 12)
    assert torch.equal(TW.codec_roundtrip(buf, "raw"), buf)
    enc, _ = TW.get_codec("raw")
    assert enc(buf)[0] is buf
    with pytest.raises(KeyError):
        TW.get_codec("no-such-codec")


def test_golden_fixture_bytes_and_decode():
    """The reference's golden S_8 bucket buffer (``tests/test_wire_format.py``):
    the port's encode reproduces the fixture's bytes, and decodes them back
    to the exact buckets."""
    q = star_query(8)
    data = star_data_sparse(8, domain=64, hub_rows=256, spoke_extra=64, seed=21)
    pol = TW.WirePolicy.from_columns([(a.attrs, data[a.rel]) for a in q.atoms])
    hub = next(a for a in q.atoms if len(a.attrs) > 2)
    fmt = pol.format_for(hub.attrs)
    z = np.load(FIXTURE)
    assert fmt.col_bits == tuple(z["col_bits"].tolist()) == (6,) * 7
    rows = np.unique(data[hub.rel], axis=0)[:200]
    p, c_out = 8, int(z["c_out"])
    buf = np.zeros((p, c_out, rows.shape[1]), np.int32)
    valid = np.zeros((p, c_out), bool)
    for i, r in enumerate(rows):
        buf[i % p, i // p] = r
        valid[i % p, i // p] = True
    got = TW.wire_encode(torch.from_numpy(buf), torch.from_numpy(valid), fmt)
    np.testing.assert_array_equal(got.numpy(), z["wire"])
    b2, v2 = TW.wire_decode(torch.from_numpy(z["wire"]), fmt, c_out)
    np.testing.assert_array_equal(b2.numpy(), buf)
    np.testing.assert_array_equal(v2.numpy(), valid)


# ----------------------------------------------------- backends + exchange
def test_local_backends_route_the_codec():
    rng = np.random.default_rng(3)
    buf, valid = _rand_case(rng, (6, 21), (4, 2), 19)
    fmt = TW.WireFormat((6, 21))
    tb, tv = torch.from_numpy(buf), torch.from_numpy(valid)
    be = TL.get_local_backend("torch")
    w = be.wire_encode(tb, tv, fmt)
    assert torch.equal(w, TW.wire_encode(tb, tv, fmt))
    assert torch.equal(K.wire_encode(tb.reshape(8, 19, 2), tv.reshape(8, 19), fmt),
                       w.reshape(8, -1))
    b2, v2 = be.wire_decode(w, fmt, 19)
    assert torch.equal(b2, tb) and torch.equal(v2, tv)
    cuda = TL.get_local_backend("cuda")
    with pytest.raises(ValueError, match="CUDA"):
        cuda.wire_encode(tb, tv, fmt)
    with pytest.raises(ValueError, match="CUDA"):
        cuda.wire_decode(w, fmt, 19)
    with pytest.raises(ValueError, match="use_cuda=True"):
        K.wire_encode(tb.reshape(8, 19, 2), tv.reshape(8, 19), fmt, use_cuda=True)


@pytest.mark.parametrize("multi", [False, True])
def test_packed_exchange_equals_dense(multi):
    """``exchange``/``exchange_multi`` with a format give the dense
    exchange's rows and stats, and the split-phase exchange around one
    segmented collective gives them too."""
    g = torch.Generator().manual_seed(5)
    p, k, n = 4, 3, 21
    data = torch.randint(0, 60, (p, k, n, 3), generator=g, dtype=torch.int32)
    valid = torch.rand((p, k, n), generator=g) < 0.7
    shape = (p, k, n, 2) if multi else (p, k, n)
    dest = torch.randint(0, p, shape, generator=g, dtype=torch.int32)
    fmt = TW.WireFormat((6, 6, 6))
    fn = TS.exchange_multi if multi else TS.exchange
    dense = fn(data, valid, dest, p=p, c_out=16, cap_recv=48)
    packed = fn(data, valid, dest, p=p, c_out=16, cap_recv=48, fmt=fmt, backend="torch")
    for a, b in zip(dense, packed):
        assert torch.equal(a, b)
    start = TS.exchange_multi_start if multi else TS.exchange_start
    w1, s1, d1 = start(data, valid, dest, p=p, c_out=16, fmt=fmt, backend="torch")
    keys = TW.WireFormat((6,))
    w2, _, _ = start(data[..., :1], valid, dest, p=p, c_out=16, fmt=keys, backend="torch")
    r1, _ = TS.ship_segments([w1, w2])
    rd, rv, dr = TS.exchange_finish(r1, p=p, c_out=16, cap_recv=48, fmt=fmt, backend="torch")
    assert torch.equal(rd, dense[0]) and torch.equal(rv, dense[1])
    assert torch.equal(s1, dense[2]) and torch.equal(d1, dense[3]) and torch.equal(dr, dense[4])
