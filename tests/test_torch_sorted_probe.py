"""The port's sorted probe on the CPU, at the cases where the Hopper
kernel's design branches: each plain PyTorch version (what a CPU tensor
takes, and the oracle the CUDA kernel is held to on the card) against the
JAX package's Pallas ``_range_kernel`` in interpret mode and against
``repro.kernels.ref``, exactly (all data is int32), on the same numpy
inputs.

The kernel answers probes below the first key (the -1 invalid probes)
and above the last valid key with no search, searches only the valid
prefix ``[0, m_eff)`` of a segment (through a splitter sample, then a
window of the keys) and gallops right from ``lo`` over a run of equal
keys; each case below pins one of those branches on the plain side.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.sorted_probe import sorted_probe_ranges as pl_ranges  # noqa: E402

from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.kernels.sorted_probe import (  # noqa: E402
    SPLITTERS,
    sorted_probe_ranges,
    sorted_probe_ranges_plain,
)

I32MAX = 2**31 - 1
I32MIN = -(2**31)


def _segment(rng, m, meff, lo, hi):
    k = np.full(m, I32MAX, np.int32)
    k[:meff] = np.sort(rng.integers(lo, hi, meff))
    return k


def _case(name, rng):
    """(q (B, n), keys (B, m)) for one named edge case."""
    if name == "equal_run":  # one run of equal keys fills the segment
        keys = np.full((2, 1500), 5, np.int32)
        keys[1, 700:] = I32MAX
        q = np.tile(np.array([5, 4, 6, -1, I32MIN + 1, I32MAX - 1], np.int32), (2, 20))
    elif name == "all_padding":
        keys = np.full((3, 257), I32MAX, np.int32)
        q = rng.integers(-5, 50, (3, 90)).astype(np.int32)
        q[:, ::4] = I32MAX - 1
    elif name == "below_and_above":
        keys = np.stack([_segment(rng, 300, 250, 100, 200) for _ in range(2)])
        q = np.concatenate([rng.integers(-3, 99, (2, 30)), rng.integers(200, 10**6, (2, 30)),
                            np.full((2, 4), -1), np.full((2, 4), I32MIN + 1)], 1)
    elif name == "meff_one":
        keys = np.full((2, 130), I32MAX, np.int32)
        keys[:, 0] = [7, -7]
        q = np.array([[7, 6, 8, -1, -7, -8] * 7] * 2, np.int32)
    elif name == "meff_below_splitters":  # every valid key fits on chip
        keys = np.stack([_segment(rng, 2100, e, 0, 400) for e in (700, SPLITTERS - 1)])
        q = rng.integers(-2, 420, (2, 333)).astype(np.int32)
    elif name == "meff_off_stride":  # m_eff not a multiple of the splitter stride
        keys = np.stack([_segment(rng, 3000, e, -100, 3000) for e in (SPLITTERS + 1, 2999)])
        q = rng.integers(-120, 3100, (2, 501)).astype(np.int32)
    elif name == "negative_keys_and_duplicates":
        keys = np.stack([_segment(rng, 600, 550, -30, 30) for _ in range(3)])
        q = rng.integers(-40, 40, (3, 257)).astype(np.int32)
        q[:, ::9] = I32MIN + 1
    else:
        raise KeyError(name)
    return np.ascontiguousarray(q, np.int32), np.ascontiguousarray(keys, np.int32)


CASES = ["equal_run", "all_padding", "below_and_above", "meff_one",
         "meff_below_splitters", "meff_off_stride", "negative_keys_and_duplicates"]


@pytest.mark.parametrize("name", CASES)
def test_plain_vs_pallas_and_reference(name):
    rng = np.random.default_rng(len(name))
    q, keys = _case(name, rng)
    assert np.all(np.diff(keys.astype(np.int64), axis=1) >= 0) and np.all(q < I32MAX)
    lo, hi = sorted_probe_ranges_plain(torch.from_numpy(q), torch.from_numpy(keys))
    assert lo.dtype == torch.int32 and hi.dtype == torch.int32
    assert lo.shape == hi.shape == q.shape
    for i in range(q.shape[0]):
        rlo, rhi = ref.sorted_probe_ranges_ref(jnp.asarray(q[i]), jnp.asarray(keys[i]))
        plo, phi = pl_ranges(jnp.asarray(q[i]), jnp.asarray(keys[i]), interpret=True)
        for got, want in ((lo, rlo), (hi, rhi), (lo, plo), (hi, phi)):
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    # the wrapper and the ops switch take the plain version for CPU tensors
    for fn in (sorted_probe_ranges, K.sorted_probe_ranges):
        wlo, whi = fn(torch.from_numpy(q), torch.from_numpy(keys))
        assert torch.equal(wlo, lo) and torch.equal(whi, hi)


def test_equal_run_multiplicity_is_the_run_length():
    """``hi - lo`` over a run of equal keys is the run's length, up to a
    whole segment (the gallop's longest walk)."""
    keys = np.full((2, 2**14), 5, np.int32)
    keys[1, 3:] = I32MAX
    q = np.array([[5, 4, 6], [5, 5, -1]], np.int32)
    lo, hi = sorted_probe_ranges_plain(torch.from_numpy(q), torch.from_numpy(keys))
    assert (hi - lo).tolist() == [[2**14, 0, 0], [3, 3, 0]]
    assert lo.tolist() == [[0, 0, 2**14], [0, 0, 0]]


@pytest.mark.parametrize("n", [0, 1, 3, 1023, 1025, 4096])
def test_plain_vs_numpy_searchsorted_over_tile_edges(n):
    """Probe counts on and off the kernel's 1024-probe tile and a multiple
    of its 4 probes a thread, against numpy's searchsorted per segment."""
    rng = np.random.default_rng(n)
    keys = np.stack([_segment(rng, 900, e, -50, 500) for e in (0, 1, 640, 900)])
    q = rng.integers(-60, 560, (4, n)).astype(np.int32)
    lo, hi = sorted_probe_ranges_plain(torch.from_numpy(q), torch.from_numpy(keys))
    for i in range(4):
        np.testing.assert_array_equal(lo[i].numpy(), np.searchsorted(keys[i], q[i], "left"))
        np.testing.assert_array_equal(hi[i].numpy(), np.searchsorted(keys[i], q[i], "right"))
