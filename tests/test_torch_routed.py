"""The port's dense exchange (``routed``: ``_bucketize``, the count
pre-pass and ``routed_all_to_all``) against ``repro.relational.routed``
under its named-axis ``vmap`` and against a numpy delivery oracle."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.relational import routed as JR  # noqa: E402
from repro.relational.spmd import AXIS  # noqa: E402

from repro_torch.relational import routed as TR  # noqa: E402

P, N, AR = 4, 12, 3


def _mk(seed=0, dom=7, frac_valid=0.8, k=None):
    rng = np.random.RandomState(seed)
    shape = (P, N) if k is None else (P, k, N)
    data = rng.randint(0, dom, size=shape + (AR,)).astype(np.int32)
    valid = rng.rand(*shape) < frac_valid
    dest = rng.randint(0, P, size=shape).astype(np.int32)
    return data, valid, dest


def _sent_rows(data, valid, dest, want):
    rows = [data[s, i] for s in range(P) for i in range(N) if valid[s, i] and dest[s, i] == want]
    if not rows:
        return np.zeros((0, data.shape[-1]), np.int32)
    r = np.stack(rows)
    return r[np.lexsort(r.T[::-1])]


def _recv_rows(rdata, rvalid, shard):
    sel = rdata[shard][rvalid[shard]]
    if not len(sel):
        return np.zeros((0, rdata.shape[-1]), rdata.dtype)
    return sel[np.lexsort(sel.T[::-1])]


@pytest.mark.parametrize("c_out", [2, 3, 8])
def test_bucketize_exact(c_out):
    data, valid, dest = _mk(c_out)
    vd = np.where(valid, dest, P).astype(np.int32)
    buf, bufv, sent, dropped = TR._bucketize(
        torch.from_numpy(data), torch.from_numpy(vd), P, c_out
    )
    for s in range(P):
        wb, wv, ws, wd = JR._bucketize(jnp.asarray(data[s]), jnp.asarray(vd[s]), P, c_out)
        np.testing.assert_array_equal(buf[s].numpy(), np.asarray(wb))
        np.testing.assert_array_equal(bufv[s].numpy(), np.asarray(wv))
        assert int(sent[s]) == int(ws) and int(dropped[s]) == int(wd)


@pytest.mark.parametrize("c_out,cap_recv", [(8, 64), (2, 64), (8, 5)])
def test_routed_all_to_all_matches_reference_and_oracle(c_out, cap_recv):
    data, valid, dest = _mk(1)
    r = TR.routed_all_to_all(
        torch.from_numpy(data), torch.from_numpy(valid), torch.from_numpy(dest),
        p=P, c_out=c_out, cap_recv=cap_recv,
    )
    w = jax.vmap(
        lambda d, v, t: JR.routed_all_to_all(d, v, t, p=P, c_out=c_out, cap_recv=cap_recv),
        axis_name=AXIS,
    )(jnp.asarray(data), jnp.asarray(valid), jnp.asarray(dest))
    for got, want in zip(r[:5], w[:5]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if c_out == 8 and cap_recv == 64:  # nothing dropped: the delivery oracle
        assert int(r.sent.sum()) == int(valid.sum())
        for s in range(P):
            np.testing.assert_array_equal(
                _recv_rows(r.data.numpy(), r.valid.numpy(), s),
                _sent_rows(data, valid, dest, s),
            )


def test_fused_instances_exchange_independently():
    """A (p, k, n, ar) group exchanges each instance k as its own send."""
    k = 3
    data, valid, dest = _mk(2, k=k)
    r = TR.routed_all_to_all(
        torch.from_numpy(data), torch.from_numpy(valid), torch.from_numpy(dest),
        p=P, c_out=6, cap_recv=24,
    )
    for i in range(k):
        w = jax.vmap(
            lambda d, v, t: JR.routed_all_to_all(d, v, t, p=P, c_out=6, cap_recv=24),
            axis_name=AXIS,
        )(jnp.asarray(data[:, i]), jnp.asarray(valid[:, i]), jnp.asarray(dest[:, i]))
        np.testing.assert_array_equal(r.data[:, i].numpy(), np.asarray(w.data))
        np.testing.assert_array_equal(r.valid[:, i].numpy(), np.asarray(w.valid))
        np.testing.assert_array_equal(r.sent[:, i].numpy(), np.asarray(w.sent))


def test_replicated_send_matches_reference():
    data, valid, _ = _mk(3)
    rng = np.random.RandomState(4)
    dests = rng.randint(0, P + 1, size=(P, N, 3)).astype(np.int32)  # dups + skips
    r = TR.routed_all_to_all(
        torch.from_numpy(data), torch.from_numpy(valid), torch.from_numpy(dests),
        p=P, c_out=16, cap_recv=64,
    )
    w = jax.vmap(
        lambda d, v, t: JR.routed_all_to_all(d, v, t, p=P, c_out=16, cap_recv=64),
        axis_name=AXIS,
    )(jnp.asarray(data), jnp.asarray(valid), jnp.asarray(dests))
    for got, want in zip(r[:5], w[:5]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_route_counts_match_reference():
    data, valid, dest = _mk(5)
    vd = np.where(valid, dest, P).astype(np.int32)
    out, recv = TR.route_counts(torch.from_numpy(vd), P)
    wo, wr = jax.vmap(lambda t: JR.route_counts(t, P), axis_name=AXIS)(jnp.asarray(vd))
    np.testing.assert_array_equal(out.numpy(), np.asarray(wo))
    np.testing.assert_array_equal(recv.numpy(), np.asarray(wr))
    assert TR.pow2(5) == JR.pow2(5) == 8 and TR.padded_slots(4, 8, 3) == JR.padded_slots(4, 8, 3)
