#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of GYM on one CUDA card.

    python3 chip_smoke.py [--seed N] [--reps N] [--phases gym,grid,skew,logdepth,wire,lm]

Run from the root of a checkout on a machine with a CUDA card (sm_90a,
an H100) and the CUDA toolkit.  In order it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the Hopper kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all at once) and prints the build time, ptxas's register
   and spill report, and the count of tensor-core MMA instructions in the
   flash kernels' SASS (``cuobjdump -sass``; it must not be 0);
3. holds each gym CUDA kernel exactly equal to its plain PyTorch version
   on the card at edge cases (n=0, all-INT32_MAX keys, -1 probes, p=7 and
   p=8, a top-bit seed; for the sorted probe also every early out, valid
   lengths 0, 1 and off the splitter stride, a 2^20-key run of equal keys,
   n off the tile, 70000 segments, an empty join key (every range a whole
   segment) and three distinct keys at 2^20-2^22 probes a segment; for the
   semijoin probe's bitmap path also
   a bound off 32, probes at 0 and bound - 1, the largest bound that fits
   one block's shared memory and one bit past it, which must take the hash
   path, and more segments than SMs, and, in a child process, that a key
   outside [0, bound) traps), and the flash attention kernel within stated
   tolerances of its plain version over head widths, dtypes, GQA groups,
   masks, softcaps and ragged shapes, with fully masked rows exactly 0;
4. (phase ``gym``) drives the port's join path — default ``gym()`` (hash
   engine, DYM-d, fused, calibrated, dense wire) with the ``'cuda'``
   backend — on S_8, C_8 and TC_9 at the ``benchmarks/bench_shuffle.py``
   sizes and at a real size (about 2^20 tuples per relation at p=8, 8-9 M
   input tuples per query, made with vectorized numpy from ``--seed``).
   Each run's rows, schema and ledger must equal a run with the
   ``'torch'`` backend (the plain versions) on the card, the real-size
   row sets must equal an independent numpy join, and every gym kernel
   must have launched, every ``semijoin_probe`` launch on its bitmap path
   (the launches are printed per path, ``bitmap`` / ``hash``);
5. (phase ``grid``) drives ``GymConfig(strategy="grid")`` — the paper's
   skew-proof Lemma 8/10 engine — on the same families, sizes and data,
   with the same checks, and prints its comm beside the hash engine's;
   the semijoin probe's launches are split by path and by the ``bound``
   passed, and no launch whose bound fits the bitmap may take the hash
   path;
6. (phase ``skew``) drives ``GymConfig(strategy="hybrid")`` — the
   heavy-hitter engine — beside the hash and grid engines: the five
   families of ``benchmarks/bench_skew.py`` (p = 8, seed 23,
   ``max_cap_tuples=1<<18``), the planted heavy key ``S_8_heavy`` at the
   gym phase's real S_8 scale (hub 2^20 rows, 80% of them on one A_1
   value), and the gym phase's real S_8 under ``hybrid`` as a uniform
   control.  Each run's rows, schema and ledger must equal the ``'torch'``
   backend's; the engines must give one row set, the real-size rows the
   numpy join's; ``hybrid`` must make no retry, and on ``S_8_heavy`` ship
   fewer padded slots than ``hash`` with heavy tuples; the control must
   equal the gym phase's hash run record for record; no semijoin launch
   with a bound the bitmap holds may take the hash path.  Each run prints
   rows, comm, shuffle tuples, padded slots, the heavy/light split, the
   flagged destinations, retries, dispatches, launches (per kernel and per
   semijoin path) and cold seconds (warm too at real size);
7. (phase ``logdepth``) drives the paper's log-depth path: C_16 (about 256
   tuples a relation) under ``chain_ghd(16)``, ``gym_loggta`` (Log-GTA,
   whose cross bags hold about 2^24 tuples) and ``acq_mr`` (Log-GTA'),
   TC_15 under ``gym_loggta``, and ``shares_join`` on the Table-2 query;
   each run's rows, schema and ledger must equal the ``'torch'`` backend's,
   the rows the numpy join's, and the largest materialized bag the numpy
   count; it prints rounds, comm, the largest bag, peak device memory and
   cold/warm seconds.  Every gym kernel must launch on each of the grid
   and logdepth phases;
8. (phase ``wire``) drives ``GymConfig(wire_format="packed")`` — the
   bit-packed exchange, whose codec runs the ``wire_encode`` /
   ``wire_decode`` kernels — and ``GymConfig(plan="auto")``: S_8, C_8 and
   TC_9 at bench size under ``hash``, ``grid`` and ``hybrid`` (``'cuda'``
   == ``'torch'`` in rows, schema and every record; rows, comm, retries
   and useful bytes equal to the dense run, payload bytes below it); the
   gym phase's real-size data under ``hash`` (cold and warm seconds,
   payload bytes and peak device memory against the gym phase's dense
   run — at most ``WIRE_PEAK_RATIO_MAX`` times it — rows == numpy); and
   ``plan="auto"`` with the packed wire on the bench and real families
   and the skew phase's real ``S_8_heavy``, whose chosen plan key must
   equal the advisor's on the host from the same statistics, with every
   gym and codec kernel launched (the plan keeps the ``'cuda'`` backend).
   Before any phase the codec kernels are held exactly equal to the plain
   versions at edge cases (arity 0, negative 32-bit columns, c off a
   multiple of 8 and c = 0, empty and full buckets, row_bits 2 to 257,
   the golden fixture ``tests/fixtures/wire_s8_packed.npz``).  With both
   sizes, the gym phase's dense counts must equal those from before the
   packed wire (``DENSE_BASELINE``);
9. (phase ``lm``) drives the port's LM serving path — ``generate`` over
   ``DecoderLM.prefill`` and ``decode_step`` — on gemma2-9b at full width
   and depth in bf16 with random weights from ``--seed``: a batch of two
   4608-token prompts, 16 greedy tokens, the ``'cuda'`` backend.  The
   flash kernel must launch exactly 42 times per ``generate`` (once per
   layer, in prefill), and the per-step logits must agree with a
   teacher-forced replay through the ``'torch'`` backend on the card;
10. times each kernel at the largest inputs its path gave it (CUDA events,
   L2 flushed before each launch) beside its plain version, one PyTorch
   library call where one computes the same function, and its bound,
   prints the sorted probe's census of that call (the share of probes its
   early outs answer, the share of padding keys) and the semijoin probe's
   (the share of -1 probes and of padding keys, the hit rate, the largest
   valid key + 1 against ``bound``, duplicate keys), times the semijoin
   probe's hash path at the same call, splits the bitmap path's device
   time between its two kernels (``torch.profiler``), and prints beside it
   an elementwise pass over the same probe and mask bytes and the
   wrapper's host time a call.

TF32 is off for matrix products and cuDNN (set explicitly below), so f32
products on the card run in full f32.  The second-to-last line is one
JSON object describing the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises and the exit
code is nonzero.  Without a CUDA card the script exits nonzero before
printing anything.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, the 32-bit
# non-tensor-core rate as the integer-operation ceiling, and the dense
# bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
I32MAX = 2**31 - 1

GYM_SOURCE = "src/repro_torch/csrc/gym_kernels.cu"
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
WIRE_SOURCE = "src/repro_torch/csrc/wire_codec.cu"
GYM_KERNELS = ("hash_partition", "semijoin_probe", "sorted_probe_ranges")
WIRE_KERNELS = ("wire_encode", "wire_decode")
KERNELS = {
    # kernel name -> the TPU kernel (file:line of its body) it replaces
    "hash_partition": "src/repro/kernels/hash_partition.py:49",
    "semijoin_probe": "src/repro/kernels/semijoin_probe.py:33",
    "sorted_probe_ranges": "src/repro/kernels/sorted_probe.py:40",
    "flash_attention": "src/repro/kernels/flash_attention.py:34",
    # the packed wire's codec has no TPU kernel: the reference computes it
    # with XLA element-wise operations; these are its functions
    "wire_encode": "src/repro/relational/wire.py:164",
    "wire_decode": "src/repro/relational/wire.py:188",
}
# the dense gym phase's counts before the packed wire was ported (bench and
# real size, PERF.md section 6): dispatches and padded slots of the
# real-size runs, and the gym kernels' launches over the phase's 'cuda' runs
DENSE_BASELINE = {
    "dispatches": {"S_8": 45, "C_8": 53, "TC_9": 38},
    "padded": {"S_8": 1945113472, "C_8": 374343680, "TC_9": 295700352},
    "launches": {"hash_partition": 740, "semijoin_probe": 120, "sorted_probe_ranges": 156},
}
# the wire phase: packed peak device memory at most this multiple of dense's
WIRE_PEAK_RATIO_MAX = 1.25
# the log-depth phase: C_16 on real_chain(16, ident=LOGDEPTH_IDENT,
# extra=64, domain=4096), about 256 tuples a relation, so that Log-GTA's
# cross bag pi_A4(R4) x pi_A6(R6) x pi_A8(R8) holds about 256^3 = 2^24
# tuples; Assumption 3's default per-shard ceiling (64 M, M = 4 IN / p)
# is far below that bag, so both backends get this explicit one
LOGDEPTH_IDENT = 192
LOGDEPTH_MAX_CAP = 2**25
# the least tuples Log-GTA's and Log-GTA''s largest C_16 bag must hold,
# so that the phase keeps its real device state
LOGDEPTH_MIN_BAG = 16_000_000
# the LM serving phase: gemma2-9b at full width and depth
LM_ARCH, LM_BATCH, LM_PROMPT, LM_STEPS = "gemma2-9b", 2, 4608, 16
# flash kernel vs its plain version: f32 both accumulate in f32 and differ
# in summation order only; bf16 both round an f32 result once, a value on
# a rounding boundary may land one or two bf16 ulps apart (2**-7 relative
# each), and the kernel's tensor-core product rounds the weights P to bf16
# (2**-9 relative each); the bf16 bound is two ulps at |o| in [1, 2),
# absolute at |o| <= 1, relative above
FLASH_TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}
# LM logits, 'cuda' backend vs teacher-forced 'torch' backend: the two
# prefills differ only in attention's summation order and the kernel's
# bf16 weights P, whose roundings then travel through 42 layers of bf16
# activations
LM_LOGIT_REL_TOL = 5e-2


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ------------------------------------------------------------------ data
def real_chain(n: int, *, ident: int, extra: int, domain: int, seed: int):
    """C_n matching database: identity links on [0, ident) plus ``extra``
    random links over [ident, domain) per relation (as chain_data_sparse,
    vectorized)."""
    rng = np.random.default_rng(seed)
    out = {}
    iden = np.repeat(np.arange(ident, dtype=np.int32)[:, None], 2, axis=1)
    for i in range(1, n + 1):
        rnd = rng.integers(ident, domain, (extra, 2)).astype(np.int32)
        out[f"R{i}"] = np.unique(np.concatenate([iden, rnd]), axis=0)
    return out


def real_star(n: int, *, hub_rows: int, spoke_extra: int, domain: int, seed: int):
    """S_n: a (hub_rows, n-1) hub over [0, domain/2); each spoke matches
    every hub value as (v, v % 7) plus ``spoke_extra`` non-matching rows
    (as star_data_sparse, vectorized)."""
    rng = np.random.default_rng(seed)
    hub = rng.integers(0, domain // 2, (hub_rows, n - 1)).astype(np.int32)
    out = {"S": np.unique(hub, axis=0)}
    for i in range(1, n):
        vals = np.unique(hub[:, i - 1])
        rows = np.stack([vals, vals % 7], 1)
        ext = np.stack([
            rng.integers(domain // 2, domain, spoke_extra),
            rng.integers(0, 7, spoke_extra),
        ], 1)
        out[f"R{i}"] = np.unique(np.concatenate([rows, ext]).astype(np.int32), axis=0)
    return out


def real_star_heavy(n: int, *, hub_rows: int, heavy_share: float, spoke_extra: int,
                    domain: int, seed: int):
    """S_n with a planted heavy hitter: ``heavy_share`` of the hub rows
    carry A_1 = 0, the other columns uniform over [0, domain/2); spokes as
    ``real_star`` (as star_data_heavy, vectorized)."""
    rng = np.random.default_rng(seed)
    half = domain // 2
    k = int(hub_rows * heavy_share)
    a1 = np.concatenate([np.zeros(k, np.int64), rng.integers(1, half, hub_rows - k)])
    cols = [a1] + [rng.integers(0, half, hub_rows) for _ in range(n - 2)]
    hub = np.stack(cols, 1).astype(np.int32)
    out = {"S": np.unique(hub, axis=0)}
    for i in range(1, n):
        vals = np.unique(hub[:, i - 1])
        rows = np.stack([vals, vals % 7], 1)
        ext = np.stack([
            rng.integers(half, domain, spoke_extra),
            rng.integers(0, 7, spoke_extra),
        ], 1)
        out[f"R{i}"] = np.unique(np.concatenate([rows, ext]).astype(np.int32), axis=0)
    return out


def real_tc(n_tri: int, *, ident: int, extra: int, domain: int, seed: int):
    """TC_n: identity triangles on [0, ident) plus random links."""
    return real_chain(3 * n_tri, ident=ident, extra=extra, domain=domain, seed=seed)


def np_join(a, a_schema, b, b_schema):
    """Independent vectorized natural join: dense key codes, sort and
    searchsorted, then expand the match ranges."""
    shared = [x for x in a_schema if x in b_schema]
    b_keep = [i for i, x in enumerate(b_schema) if x not in a_schema]
    out_schema = tuple(a_schema) + tuple(b_schema[i] for i in b_keep)
    ak = a[:, [a_schema.index(x) for x in shared]].astype(np.int64)
    bk = b[:, [b_schema.index(x) for x in shared]].astype(np.int64)
    _, codes = np.unique(np.concatenate([ak, bk]), axis=0, return_inverse=True)
    codes = codes.reshape(-1)
    ca, cb = codes[: len(a)], codes[len(a):]
    order = np.argsort(cb, kind="stable")
    cbs = cb[order]
    lo = np.searchsorted(cbs, ca, "left")
    hi = np.searchsorted(cbs, ca, "right")
    cnt = hi - lo
    ai = np.repeat(np.arange(len(a)), cnt)
    start = np.repeat(lo - np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt)
    bj = order[start + np.arange(len(ai))]
    out = np.concatenate([a[ai], b[bj][:, b_keep]], axis=1)
    return out, out_schema


def np_answer(q, data):
    """The query answer by folding ``np_join`` over the atoms, in the
    query's output column order, lexicographically sorted."""
    atoms = list(q.atoms)
    out = np.asarray(data[atoms[0].rel], np.int64)
    schema = tuple(atoms[0].attrs)
    for at in atoms[1:]:
        out, schema = np_join(out, schema, np.asarray(data[at.rel], np.int64), tuple(at.attrs))
    out = out[:, [schema.index(x) for x in q.output_attrs]]
    out = np.unique(out, axis=0) if len(out) else out.reshape(0, len(q.output_attrs))
    return out


# ------------------------------------------------------------ kernel phase
def kernel_edge_checks(torch, K, ref, dev):
    """Each CUDA kernel exactly equal to its plain version at edge cases."""
    rng = np.random.default_rng(7)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    n_checks = 0
    # probes: n=0, all-INT32_MAX keys, -1 probes, empty key table
    cases = []
    q = rng.integers(-1, 50, (6, 300)).astype(np.int32)
    k = rng.integers(0, 50, (6, 200)).astype(np.int32)
    k[:, 150:] = I32MAX
    k[2] = I32MAX  # an all-padding segment
    q[3] = -1  # invalid probes
    cases += [(q, k), (q[:, :0], k), (q, k[:, :0]), (np.full((2, 5), -1, np.int32), np.full((2, 7), I32MAX, np.int32))]
    for qq, kk in cases:
        tq, tk = t(qq), t(kk)
        check(torch.equal(K.semijoin_probe(tq, tk, use_cuda=True), ref.semijoin_probe_ref(tq, tk)),
              f"semijoin_probe != plain at q{qq.shape} keys{kk.shape}")
        ks = torch.sort(tk, dim=-1).values.contiguous()
        lo, hi = K.sorted_probe_ranges(tq, ks, use_cuda=True)
        rlo, rhi = ref.sorted_probe_ranges_ref(tq, ks)
        check(torch.equal(lo, rlo) and torch.equal(hi, rhi),
              f"sorted_probe_ranges != plain at q{qq.shape} keys{kk.shape}")
        n_checks += 2
    # hashing: p=7 and p=8, top-bit seeds, negative keys, n=0, zero columns
    rows = rng.integers(-(2**31), 2**31 - 1, (4, 513, 3), dtype=np.int64).astype(np.int32)
    valid = rng.random((4, 513)) < 0.8
    seeds = t(np.array([0, 2**31, 2**32 - 1, 7919], np.int64))
    for p in (7, 8):
        for nk in (0, 1, 3):
            r, v = t(rows[..., :nk]), t(valid)
            check(torch.equal(K.hash_partition(r, v, p, seeds, use_cuda=True),
                              ref.hash_partition_ref(r, v, p, seeds)),
                  f"hash_partition != plain at p={p} nk={nk}")
            n_checks += 1
        r0, v0 = t(rows[:, :0]), t(valid[:, :0])
        check(K.hash_partition(r0, v0, p, seeds, use_cuda=True).shape == (4, 0), "n=0 hash")
    torch.cuda.synchronize()
    return n_checks


def sorted_probe_edge_checks(torch, K, ref, dev):
    """The sorted-probe kernel exactly equal to its plain version where its
    design branches: probes below the first key (-1, INT32_MIN + 1) and
    above the last valid one; m_eff = 0, 1, fewer than the splitters, and
    not a multiple of the splitter stride; one run of equal keys filling a
    2^20-key segment; n off the 1024-probe tile and off 4 (the scalar
    path); more than 65535 segments (the grid's y limit)."""
    rng = np.random.default_rng(13)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731

    def sorted_keys(b, m, meff, hi):
        k = np.full((b, m), I32MAX, np.int32)
        for i, e in enumerate(meff):
            k[i, :e] = np.sort(rng.integers(-50, hi, e))
        return k

    def probes(b, n, hi):
        q = rng.integers(-60, hi + 60, (b, n)).astype(np.int32)
        q[:, ::7] = -1
        q[:, 3::11] = -(2**31) + 1
        q[:, 5::13] = I32MAX - 1
        return q

    n_checks = 0

    def one(q, k, what):
        nonlocal n_checks
        tq, tk = t(q), t(k)
        lo, hi = K.sorted_probe_ranges(tq, tk, use_cuda=True)
        rlo, rhi = ref.sorted_probe_ranges_ref(tq, tk)
        check(torch.equal(lo, rlo) and torch.equal(hi, rhi),
              f"sorted_probe_ranges != plain: {what} q{q.shape} keys{k.shape}")
        n_checks += 1
        return lo, hi

    # m_eff 0, 1, < 1024 splitters, a stride that does not divide m_eff
    k = sorted_keys(4, 4096, [0, 1, 700, 4096], 3000)
    for n in (4096, 1027, 4099, 3):
        one(probes(4, n, 3000), k, f"m_eff 0/1/700/4096 n={n}")
    k = sorted_keys(2, 2**21, [2**20 + 12345, 2**21 - 1], 2**22)
    one(probes(2, 2**16 + 2, 2**22), k, "m_eff 2^20+12345 and 2^21-1")
    one(probes(2, 2**16, 2**22), k, "m_eff 2^20+12345 and 2^21-1, n a multiple of the tile")
    # one run of equal keys filling a whole 2^20-key segment
    k = np.full((2, 2**20), 5, np.int32)
    k[1, 2**19:] = I32MAX
    q = np.tile(np.array([5, 4, 6, -1, 5, I32MAX - 1, -(2**31) + 1], np.int32), (2, 150))
    lo, hi = one(q, k, "a run of 2^20 equal keys")
    check(int((hi - lo)[0, 0]) == 2**20 and int((hi - lo)[1, 0]) == 2**19,
          "sorted_probe_ranges: the equal run's multiplicity")
    # more segments than a grid's y dimension takes
    one(probes(70000, 6, 40), sorted_keys(70000, 3, rng.integers(0, 4, 70000), 40),
        "70000 segments")
    # the cross joins of the grid and log-depth phases: an empty join key
    # ranks every valid row 0, so every probe's range is its whole segment
    # (2^22 probes a segment against 2^10 keys, as the last step of a
    # 3-way cross bag; 2^12 against 2^21 keys); and segments of a few
    # distinct keys
    for n, m in ((2**22, 2**10), (2**12, 2**21)):
        meff = np.array([m, m // 8, 1, 0, m - 1, 3, m // 2 + 1, 2])
        k = np.zeros((8, m), np.int32)
        k[np.arange(m)[None, :] >= meff[:, None]] = I32MAX
        q = np.zeros((8, n), np.int32)
        q[:, ::9] = -1
        lo, hi = one(q, k, f"an empty join key, {n} probes against {m} keys")
        check(np.array_equal((hi - lo)[:, [1, 8]].cpu().numpy(), np.repeat(meff[:, None], 2, axis=1))
              and int(lo[:, [1, 8]].abs().max()) == 0,
              "sorted_probe_ranges: an empty-key probe's range is not its whole segment")
    for n, m in ((2**20, 2**20), (2**22, 2**12)):
        k = np.sort(rng.integers(0, 3, (8, m)), axis=1).astype(np.int32)
        k[:, m - m // 5:] = I32MAX
        k[3] = 1
        one(rng.integers(-1, 4, (8, n)).astype(np.int32), k, f"3 distinct keys, n={n} m={m}")
    torch.cuda.synchronize()
    return n_checks


def bitmap_edge_checks(torch, K, ref, dev):
    """The semijoin probe's bitmap path exactly equal to its plain version:
    a bound off 32 and off the 128-bit row, probes at 0, bound - 1 and -1,
    an all-padding segment, n = 0 and m = 0, n off 4, more segments than
    SMs, the largest bound one block's shared memory takes and one bit past
    it, which must take the hash path.  Each call's path is checked by the
    launch counts."""
    from repro_torch.kernels.semijoin_probe import MAX_BITMAP_BITS

    rng = np.random.default_rng(17)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_checks = 0
    for b, n, m, bound in ((3, 1003, 517, 1520), (5, 4096, 4096, 8192), (4, 0, 300, 300),
                           (4, 300, 0, 300), (2, 2**16 + 3, 2**13, 2**16 + 3 + 2**13),
                           (2 * sms + 7, 517, 129, 646), (3, 2**15 + 1, 2**14, MAX_BITMAP_BITS),
                           (3, 2**15 + 1, 2**14, MAX_BITMAP_BITS + 1)):
        keys = rng.integers(0, bound, (b, m)).astype(np.int32)
        keys[:, m // 2:] = I32MAX
        keys[1] = I32MAX  # an all-padding segment
        if m > 2:
            keys[0, :2] = (0, bound - 1)
            keys[-1, :2] = (bound - 32, bound - 33)
        q = rng.integers(-1, bound, (b, n)).astype(np.int32)
        if n > 4:
            q[:, :4] = (0, bound - 1, -1, bound - 32)
        q[:, 5::7] = -1
        tq, tk = t(q), t(keys)
        K.reset_launch_counts()
        got = K.semijoin_probe(tq, tk, bound=bound, use_cuda=True)
        torch.cuda.synchronize()
        path = "bitmap" if bound <= MAX_BITMAP_BITS else "hash"
        check(torch.equal(got, ref.semijoin_probe_ref(tq, tk)),
              f"semijoin_probe {path} path != plain at q{q.shape} keys{keys.shape} bound={bound}")
        check(K.semijoin_probe_path_counts()[path] == int(b * n > 0),
              f"semijoin_probe bound={bound}: {K.semijoin_probe_path_counts()}, not the {path} path")
        n_checks += 1
    return n_checks


TRAP_CHILD = """
import sys, torch
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import ops as K
q = torch.arange(-1, 100, dtype=torch.int32, device="cuda").reshape(1, 101)
keys = torch.tensor([[3, 100, 2**31 - 1]], dtype=torch.int32, device="cuda")
mask = K.semijoin_probe(q, keys, bound=100)
torch.cuda.synchronize()
print("mask", int(mask.sum()))
"""


def bitmap_trap_check() -> str:
    """A key outside [0, bound) must stop the bitmap build with a trap, not
    return a mask: run in a child process, whose CUDA context it loses."""
    proc = subprocess.run([sys.executable, "-c", TRAP_CHILD, os.path.join(HERE, "src")],
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode != 0 and "mask" not in proc.stdout,
          f"semijoin_probe: a key >= bound did not trap: {proc.stdout[-500:]}")
    check("CUDA error" in proc.stderr,
          f"semijoin_probe trap child failed otherwise: {proc.stderr[-2000:]}")
    return proc.stderr.strip().splitlines()[-1][:120]


def semijoin_census(torch, q, keys, bound, mask):
    """What the recorded call's data asks of the semijoin probe: the share
    of -1 probes, of probes outside [-1, bound) (the promise allows none),
    of padding keys, the hit rate, the largest valid key + 1 against
    ``bound``, and the keys that repeat one of their segment."""
    valid = keys != I32MAX
    ks = torch.sort(keys, dim=1).values
    dup = int(((ks[:, 1:] == ks[:, :-1]) & (ks[:, 1:] != I32MAX)).sum()) if keys.shape[1] > 1 else 0
    return dict(
        probes=q.numel(), minus_one_probes=float((q == -1).float().mean()),
        probes_outside=float(((q < -1) | (q >= bound)).float().mean()),
        valid_keys=int(valid.sum()), padding_keys=1.0 - float(valid.float().mean()),
        hit_rate=float(mask.float().mean()),
        valid_key_min=int(torch.where(valid, keys, I32MAX).min()) if keys.numel() else None,
        valid_key_max_plus_1=int(torch.where(valid, keys, -1).max()) + 1 if keys.numel() else 0,
        bound=bound, duplicate_keys=dup,
    )


def bitmap_kernel_split(torch, fn, flush, reps: int = 5):
    """Device ms a call of the bitmap path spends in each of its kernels
    (``torch.profiler`` over ``reps`` calls, L2 flushed before each)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    split = {"bitmap_build_kernel": 0.0, "bitmap_probe_kernel": 0.0}
    for e in prof.events():
        for name in split:
            if e.device_type == DeviceType.CUDA and name in e.name:
                split[name] += e.time_range.elapsed_us() / 1e3 / reps
    return split


def wrapper_host_us(torch, SP, calls: int = 2000) -> float:
    """Host microseconds a bitmap-path call of the semijoin wrapper takes
    (at a tiny shape, so that the card keeps up with the launches)."""
    q = torch.zeros((4, 64), dtype=torch.int32, device="cuda")
    for _ in range(50):
        SP.semijoin_probe(q, q, bound=128)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        SP.semijoin_probe(q, q, bound=128)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def sorted_probe_census(torch, q, keys):
    """What the recorded call's data asks of the sorted probe: the share of
    probes answered by an early out (below the first key or in an empty
    segment; above the last valid key) and the share of padding keys."""
    meff = (keys != I32MAX).sum(dim=1)
    first = keys[:, 0:1]
    last = keys.gather(1, (meff - 1).clamp(min=0)[:, None].long())
    below = (q < first) | (meff[:, None] == 0)
    above = ~below & (q > last)
    return dict(
        probes=q.numel(), below_first=float(below.float().mean()),
        above_last=float(above.float().mean()),
        searched=float((~below & ~above).float().mean()),
        valid_keys=int(meff.sum()),
        padding_keys=1.0 - float(meff.sum()) / max(1, keys.numel()),
    )


def sass_mma_count(lib_path) -> int:
    """Tensor-core MMA instructions (HGMMA, HMMA) in the flash kernels'
    SASS, by ``cuobjdump -sass`` of the built library; -1 without it."""
    exe = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(exe):
        return -1
    out = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    n, in_flash = 0, False
    for line in out.stdout.splitlines():
        if "Function :" in line:
            in_flash = "flash_attention" in line
        elif in_flash and ("HGMMA" in line or "HMMA" in line):
            n += 1
    return n


class Recorder:
    """Wraps a kernel wrapper to keep (clones of) the largest inputs the
    main path gave it, keyword arguments too (the semijoin probe's
    ``bound``); the wrapped call still launches the kernel."""

    def __init__(self, torch, mod, attr):
        self.torch, self.mod, self.attr = torch, mod, attr
        self.orig = getattr(mod, attr)
        self.best = None
        self.kw = {}
        self.size = -1
        setattr(mod, attr, self)

    def __call__(self, *args, **kw):
        size = sum(a.numel() for a in args if isinstance(a, self.torch.Tensor))
        if size > self.size:
            self.size = size
            self.best = tuple(a.clone() if isinstance(a, self.torch.Tensor) else a for a in args)
            self.kw = dict(kw)
        return self.orig(*args, **kw)

    def restore(self):
        setattr(self.mod, self.attr, self.orig)


def time_cold(torch, fn, reps: int, flush) -> float:
    """Mean ms per call, CUDA events around each call, L2 flushed first."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / reps


def kernel_timing(torch, K, ref, recorded, launches, reps):
    """Time each kernel at its recorded main-path inputs (``recorded``:
    name -> (arguments, keyword arguments)); compare with its plain version
    there.  Returns the kernel records of the JSON line."""
    from repro_torch.kernels import hash_partition as HP
    from repro_torch.kernels import semijoin_probe as SP
    from repro_torch.kernels import sorted_probe as SO

    dev = torch.device("cuda")
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.int32, device=dev)  # > 50 MB L2
    out = []
    # -- hash_partition
    keys, valid, p, seeds = recorded["hash_partition"][0]
    b, n, nk = keys.shape
    got = HP.hash_partition(keys, valid, p, seeds)
    want = ref.hash_partition_ref(keys, valid, p, seeds)
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    nbytes = keys.numel() * 4 + valid.numel() + seeds.numel() * 4 + b * n * 4
    ops = b * n * (10 * (nk + 1) + 2 * nk + 2)
    out.append(dict(
        name="hash_partition", shape=f"keys {tuple(keys.shape)} p={p}",
        ms=time_cold(torch, lambda: HP.hash_partition(keys, valid, p, seeds), reps, flush),
        plain_ms=time_cold(torch, lambda: ref.hash_partition_ref(keys, valid, p, seeds), reps, flush),
        library_ms=None, max_abs_err=err, nbytes=nbytes, ops=ops,
    ))
    # -- semijoin_probe (library yardstick: torch.isin on segment-offset keys)
    (q, keys), kw = recorded["semijoin_probe"]
    bound = kw.get("bound")
    check(SP.uses_bitmap(bound), f"semijoin_probe's recorded call has bound {bound}: not the bitmap path")
    got = SP.semijoin_probe(q, keys, bound=bound)
    want = ref.semijoin_probe_ref(q, keys)
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    hgot = SP.semijoin_probe(q, keys)
    check(torch.equal(hgot, want), "semijoin_probe's hash path != plain at the recorded call")
    census = semijoin_census(torch, q, keys, bound, want)
    print(f"semijoin_probe census of the recorded call: {census}", flush=True)
    check(census["probes_outside"] == 0.0 and census["valid_key_max_plus_1"] <= bound
          and (census["valid_key_min"] is None or census["valid_key_min"] >= 0),
          "semijoin_probe's recorded call breaks the bound promise")
    seg = torch.arange(q.shape[0], device=dev, dtype=torch.int64)[:, None] << 32
    # padding keys move below every probe so they never match
    q64 = q.long() + seg
    k64 = torch.where(keys == I32MAX, -(2**62), keys.long() + seg)
    check(torch.equal(torch.isin(q64, k64), want), "torch.isin yardstick disagrees")
    nbytes = q.numel() * 4 + keys.numel() * 4 + q.numel()
    ops = 30 * (q.numel() + keys.numel())
    bitmap = lambda: SP.semijoin_probe(q, keys, bound=bound)  # noqa: E731
    ms = time_cold(torch, bitmap, reps, flush)
    hash_ms = time_cold(torch, lambda: SP.semijoin_probe(q, keys), reps, flush)
    split = bitmap_kernel_split(torch, bitmap, flush)
    # what the bytes alone cost: an elementwise pass that reads each probe
    # and writes one byte for it, as the probe kernel does
    mask_out = torch.empty_like(want)
    stream_ms = time_cold(torch, lambda: torch.eq(q, -1, out=mask_out), reps, flush)
    print(f"semijoin_probe at the recorded call: bitmap path {ms:.5f} ms "
          f"(device ms by kernel, torch.profiler: {split}), hash path {hash_ms:.5f} ms "
          f"(launched without bound); torch.eq(q, -1) over the same probe and mask "
          f"bytes {stream_ms:.5f} ms; the wrapper's host work "
          f"{wrapper_host_us(torch, SP):.3f} us a call", flush=True)
    out.append(dict(
        name="semijoin_probe",
        shape=f"q {tuple(q.shape)} keys {tuple(keys.shape)} bound={bound}",
        ms=ms,
        plain_ms=time_cold(torch, lambda: ref.semijoin_probe_ref(q, keys), reps, flush),
        library_ms=time_cold(torch, lambda: torch.isin(q64, k64), reps, flush),
        max_abs_err=err, nbytes=nbytes, ops=ops,
    ))
    # -- sorted_probe_ranges (library yardstick: batched torch.searchsorted)
    q, keys = recorded["sorted_probe_ranges"][0]
    lo, hi = SO.sorted_probe_ranges(q, keys)
    rlo, rhi = ref.sorted_probe_ranges_ref(q, keys)
    err = max(
        int((lo.long() - rlo.long()).abs().max()) if lo.numel() else 0,
        int((hi.long() - rhi.long()).abs().max()) if hi.numel() else 0,
    )
    check(torch.equal(torch.searchsorted(keys, q, side="left").int(), rlo), "searchsorted yardstick")

    def lib():
        torch.searchsorted(keys, q, side="left")
        torch.searchsorted(keys, q, side="right")

    census = sorted_probe_census(torch, q, keys)
    print(f"sorted_probe_ranges census of the recorded call: {census}", flush=True)
    m = keys.shape[1]
    # probes read once, lo and hi written once, the valid keys read once:
    # the function never needs a padding key
    nbytes = q.numel() * 12 + census["valid_keys"] * 4
    # the searches these probes need: a lower bound and a gallop for each
    # probe no early out answers, a few compares for every probe
    searched = round(census["searched"] * q.numel())
    ops = 4 * q.numel() + searched * 2 * 4 * max(1, m.bit_length())
    out.append(dict(
        name="sorted_probe_ranges", shape=f"q {tuple(q.shape)} keys {tuple(keys.shape)}",
        ms=time_cold(torch, lambda: SO.sorted_probe_ranges(q, keys), reps, flush),
        plain_ms=time_cold(torch, lambda: ref.sorted_probe_ranges_ref(q, keys), reps, flush),
        library_ms=time_cold(torch, lib, reps, flush),
        max_abs_err=err, nbytes=nbytes, ops=ops,
    ))
    recs = []
    for r in out:
        t_bytes = r["nbytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / INT32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        print(
            f"kernel {r['name']}: {r['shape']} kernel_ms={r['ms']:.5f} "
            f"plain_ms={r['plain_ms']:.5f} library_ms={r['library_ms']} "
            f"bound_ms={bound:.6f} ({'bytes' if t_bytes >= t_ops else 'operations'}: "
            f"{r['nbytes']} B, {r['ops']} int ops) share_of_bound={bound / r['ms']:.4f} "
            f"max_abs_err={r['max_abs_err']} launches={launches[r['name']]}",
            flush=True,
        )
        check(r["max_abs_err"] == 0, f"{r['name']} disagrees with its plain version")
        recs.append({
            "name": r["name"], "route": "cuda", "source": GYM_SOURCE,
            "replaces": KERNELS[r["name"]], "launches": launches[r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": r["library_ms"],
        })
    return recs


# --------------------------------------------------------------- main path
@functools.lru_cache(maxsize=None)
def families(seed: int, real: bool):
    """S_8, C_8 and TC_9 with their GHDs and data, built once per process
    (the gym and grid phases drive the same data)."""
    from repro_torch.core import queries as Q
    from repro_torch.data import synthetic as D

    if not real:  # benchmarks/bench_shuffle.py sizes
        return {
            "S_8": (Q.star_query(8), Q.star_ghd(8),
                    D.star_data_sparse(8, domain=64, hub_rows=256, spoke_extra=64, seed=21)),
            "C_8": (Q.chain_query(8), Q.chain_ghd(8),
                    D.chain_data_sparse(8, domain=256, ident=64, extra=192, seed=24)),
            "TC_9": (Q.triangle_chain_query(3), Q.triangle_chain_ghd(3),
                     D.tc_data_sparse(3, domain=128, ident=32, extra=96, seed=22)),
        }
    return {
        "S_8": (Q.star_query(8), Q.star_ghd(8),
                real_star(8, hub_rows=2**20, spoke_extra=2**18, domain=2**22, seed=seed)),
        "C_8": (Q.chain_query(8), Q.chain_ghd(8),
                real_chain(8, ident=2**19, extra=2**19, domain=2**22, seed=seed + 1)),
        "TC_9": (Q.triangle_chain_query(3), Q.triangle_chain_ghd(3),
                 real_tc(3, ident=2**19, extra=2**19, domain=2**22, seed=seed + 2)),
    }


@functools.lru_cache(maxsize=None)
def real_answer(seed: int, fam: str):
    """The numpy join of a real-size family, computed once per process
    (the gym and grid phases check the same data)."""
    q, _, data = families(seed, True)[fam]
    return np_answer(q, data)


def peak_reset(torch) -> int:
    """Start a peak-memory window: returns the bytes already allocated
    (the recorders' kept inputs, say), which the run's peak is taken
    above, so a run's figure is the device memory it allocated itself."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def run_gym(torch, gym_mod, q, g, data, backend, strategy="hash"):
    cfg = gym_mod.GymConfig(strategy=strategy, seed=23, local_backend=backend)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows, schema, led = gym_mod.gym(q, data, ghd=g, p=8, config=cfg, device="cuda")
    torch.cuda.synchronize()
    return rows, schema, led, time.perf_counter() - t0


def main_path(torch, seed: int, sizes=("bench", "real"), strategy="hash", audit=None,
              hash_summary=None):
    """Drive default ``gym()`` (``strategy="hash"``, the gym phase) or
    ``GymConfig(strategy="grid")`` (the grid phase) over S_8/C_8/TC_9.  The
    gym phase requires every semijoin probe launch on its bitmap path; the
    grid phase's semijoins may pass a larger ``bound`` and then take the
    hash path, so ``audit`` (a ``SemijoinAudit``) checks there that no
    launch within the bitmap's bound took it.  ``hash_summary``: the gym
    phase's summary, whose comm the grid phase prints beside its own."""
    from repro_torch.core import gym as gym_mod
    from repro_torch.kernels import ops as K

    phase = "gym" if strategy == "hash" else strategy
    summary = {}
    totals = {k: 0 for k in GYM_KERNELS}
    totals.update({"semijoin_probe/bitmap": 0, "semijoin_probe/hash": 0})
    for size in sizes:
        t0 = time.perf_counter()
        fams = families(seed, real=(size == "real"))
        n_in = {f: sum(len(v) for v in d.values()) for f, (_, _, d) in fams.items()}
        print(f"data {size}: built in {time.perf_counter() - t0:.2f} s; input tuples {n_in}", flush=True)
        for fam, (q, g, data) in fams.items():
            K.reset_launch_counts()
            if audit is not None:
                audit.reset()
            rows, schema, led, cold = run_gym(torch, gym_mod, q, g, data, "cuda", strategy)
            per_run = {k: K.launch_counts()[k] for k in GYM_KERNELS}
            per_run.update({f"semijoin_probe/{k}": v
                            for k, v in K.semijoin_probe_path_counts().items()})
            check(K.launch_counts()["flash_attention"] == 0, "gym launched flash_attention")
            check(all(K.launch_counts()[k] == 0 for k in WIRE_KERNELS), "dense gym launched the codec")
            base = peak_reset(torch)
            rows2, schema2, led2, warm = run_gym(torch, gym_mod, q, g, data, "cuda", strategy)
            peak = torch.cuda.max_memory_allocated() - base
            for k in GYM_KERNELS:
                totals[k] += K.launch_counts()[k]
            for k, v in K.semijoin_probe_path_counts().items():
                totals[f"semijoin_probe/{k}"] += v
            K.reset_launch_counts()
            audited = audit.counts() if audit is not None else None
            trows, tschema, tled, tsec = run_gym(torch, gym_mod, q, g, data, "torch", strategy)
            check(sum(K.launch_counts().values()) == 0, "'torch' backend launched a kernel")
            recs = [dataclasses.asdict(r) for r in led.records]
            check(tuple(schema) == tuple(tschema) == tuple(q.output_attrs), f"{fam} {size}: schema")
            check(np.array_equal(rows, trows), f"{fam} {size}: cuda rows != torch rows")
            check(recs == [dataclasses.asdict(r) for r in tled.records], f"{fam} {size}: ledger records")
            check(led.retries == tled.retries and led.output_tuples == tled.output_tuples,
                  f"{fam} {size}: retries/output")
            check(np.array_equal(rows, rows2) and recs == [dataclasses.asdict(r) for r in led2.records],
                  f"{fam} {size}: warm run differs")
            check(rows.shape == (led.output_tuples, len(q.output_attrs)), f"{fam} {size}: shape")
            check(all(per_run[k] > 0 for k in GYM_KERNELS),
                  f"{fam} {size}: a kernel never launched {per_run}")
            if audit is None:
                check(per_run["semijoin_probe/hash"] == 0,
                      f"{fam} {size}: a semijoin_probe launch took the hash path {per_run}")
            else:
                audit.check(f"{phase} {fam} {size}")
            if size == "real":
                want = real_answer(seed, fam)
                check(np.array_equal(rows.astype(np.int64), want), f"{fam} real: rows != numpy join")
                check(led.output_tuples > 0, f"{fam} real: empty answer")
            hash_comm = ""
            if strategy != "hash":
                hs = (hash_summary or {}).get(f"{fam}/{size}")
                hash_comm = f" hash_engine_comm={hs['comm'] if hs else 'not run'}"
                hash_comm += f" semijoin_audit={audited}"
            print(
                f"{phase} {fam} {size}: inputs={n_in[fam]} out={led.output_tuples} "
                f"cold_s={cold:.4f} warm_s={warm:.4f} torch_backend_s={tsec:.4f} "
                f"rounds={led.rounds} dispatches={led.measured_dispatches} "
                f"measure_dispatches={led.measure_dispatches} retries={led.retries} "
                f"comm={led.comm_tuples}{hash_comm} padded_slots={led.padded_slots} "
                f"payload_bytes={led.payload_bytes} warm_peak_bytes={peak} "
                f"launches_per_run={per_run} cuda==torch rows+ledger: yes"
                + (" rows==numpy join: yes" if size == "real" else ""),
                flush=True,
            )
            summary[f"{fam}/{size}"] = dict(cold_s=cold, warm_s=warm, out=led.output_tuples,
                                            dispatches=led.measured_dispatches,
                                            comm=led.comm_tuples, padded=led.padded_slots,
                                            payload_bytes=led.payload_bytes, peak=peak,
                                            records=recs, launches=per_run)
    return summary, totals


def profile_queries(torch, seed: int, fams, out_dir: str) -> None:
    """One profiled real-size query per family: host-side set-up
    (dedup, scatter, upload) timed apart from the run and from reading the
    rows back, ``torch.profiler`` over the run, the device's busy share,
    and the top kernels by device time (the operator table goes to
    ``out_dir``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.gym import GymConfig, GymDriver
    from repro_torch.relational.spmd import SPMD

    os.makedirs(out_dir, exist_ok=True)
    all_fams = families(seed, real=True)
    for fam in fams:
        q, g, data = all_fams[fam]
        cfg = GymConfig(strategy="hash", seed=23, local_backend="cuda")
        for _ in range(2):  # the second, warm, run is the profiled one
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            drv = GymDriver(q, g, data, SPMD(8, device="cuda"), cfg)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = drv.run()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                out.to_numpy()
            t3 = time.perf_counter()
        # device time = the kernels and copies the card ran (one stream, so
        # they do not overlap); launch-queue stalls are reported apart
        dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        stall_us = sum(e.time_range.elapsed_us() for e in dev_events
                       if e.name == "Command Buffer Full")
        busy_us = sum(e.time_range.elapsed_us() for e in dev_events
                      if e.name != "Command Buffer Full")
        ka = prof.key_averages()
        with open(os.path.join(out_dir, f"profile_{fam}.txt"), "w") as f:
            f.write(ka.table(sort_by="self_device_time_total", row_limit=40))
        kern = {}
        for e in dev_events:
            if e.name != "Command Buffer Full":
                kern[e.name] = kern.get(e.name, 0.0) + e.time_range.elapsed_us()
        print(
            f"profile {fam} real (warm, profiled): setup_s={t1 - t0:.4f} "
            f"run_s={t2 - t1:.4f} rows_to_host_s={t3 - t2:.4f} "
            f"device_busy_s={busy_us / 1e6:.4f} device_busy_share_of_run={busy_us / 1e6 / (t2 - t1):.4f} "
            f"launch_queue_full_s={stall_us / 1e6:.4f}", flush=True,
        )
        for name, us in sorted(kern.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {name[:70]:70s} device_ms={us / 1e3:.3f}", flush=True)


# ------------------------------------------------- grid and log-depth paths
class SemijoinAudit:
    """Wraps the semijoin probe's wrapper to split its launches by path and
    by the ``bound`` the caller passed: a launch whose bound fits the bitmap
    (``MAX_BITMAP_BITS``) must never take the hash path."""

    def __init__(self, SP, K):
        self.SP, self.K = SP, K
        self.orig = SP.semijoin_probe
        SP.semijoin_probe = self
        self.reset()

    def reset(self):
        self.tally = {"bitmap": 0, "hash": 0, "hash_bound_fits": 0, "hash_no_bound": 0}
        self.max_bound = 0

    def __call__(self, q, keys, bound=None):
        before = self.K.semijoin_probe_path_counts()
        out = self.orig(q, keys, bound=bound)
        after = self.K.semijoin_probe_path_counts()
        for path in ("bitmap", "hash"):
            self.tally[path] += after[path] - before[path]
        hashed = after["hash"] - before["hash"]
        if bound is None:
            self.tally["hash_no_bound"] += hashed
        else:
            self.max_bound = max(self.max_bound, bound)
            if bound <= self.SP.MAX_BITMAP_BITS:
                self.tally["hash_bound_fits"] += hashed
        return out

    def counts(self):
        return dict(self.tally, max_bound=self.max_bound)

    def check(self, what: str) -> None:
        check(self.tally["hash_bound_fits"] == 0 and self.tally["hash_no_bound"] == 0,
              f"{what}: a semijoin_probe launch took the hash path with a bound the "
              f"bitmap holds, or with none: {self.counts()}")

    def restore(self):
        self.SP.semijoin_probe = self.orig


class BagRecorder:
    """Wraps ``PhysicalExecutor.materialize`` to keep the largest bag
    (valid tuples, per-shard capacity) each materialization produced."""

    def __init__(self, physical):
        self.cls = physical.PhysicalExecutor
        self.orig = self.cls.materialize
        self.largest = (0, 0)
        rec = self

        def materialize(exe, ghd, base, node_schema, ledger):
            out = rec.orig(exe, ghd, base, node_schema, ledger)
            for t in out[0].values():
                rec.largest = max(rec.largest, (int(t.valid.sum().item()), t.cap))
            return out

        self.cls.materialize = materialize

    def restore(self):
        self.cls.materialize = self.orig


def np_bag_sizes(q, plan, data):
    """Tuples of each bag of ``plan`` — the join of the projections of
    lam(v) onto chi(v) — counted with numpy: a product of the projections'
    sizes where they share no attribute, else a fold of ``np_join``."""
    sizes = {}
    atoms = {a.alias: a for a in q.atoms}
    for v in plan.nodes():
        parts = []
        for alias in sorted(plan.lam[v]):
            at = atoms[alias]
            keep = [x for x in at.attrs if x in plan.chi[v]]
            rows = np.asarray(data[at.rel], np.int64)[:, [at.attrs.index(x) for x in keep]]
            parts.append((np.unique(rows, axis=0), tuple(keep)))
        attrs = [x for _, sch in parts for x in sch]
        if len(attrs) == len(set(attrs)):
            sizes[v] = int(np.prod([len(r) for r, _ in parts]))
            continue
        out, schema = parts[0]
        for rows, sch in parts[1:]:
            out, schema = np_join(out, schema, rows, sch)
        sizes[v] = len(np.unique(out, axis=0)) if len(out) else 0
    return sizes


def logdepth_workloads(seed: int):
    """The log-depth phase's plans: (name, query, data, entry point,
    keyword arguments, the plan the entry point runs, the least tuples its
    largest bag must hold)."""
    from repro_torch.core import acq_mr as A
    from repro_torch.core import gym as G
    from repro_torch.core import queries as Q
    from repro_torch.core.loggta import log_gta
    from repro_torch.core.loggta_prime import log_gta_prime
    from repro_torch.data import synthetic as D

    q16, g16 = Q.chain_query(16), Q.chain_ghd(16)
    d16 = real_chain(16, ident=LOGDEPTH_IDENT, extra=64, domain=4096, seed=seed + 3)
    tc, gtc = Q.triangle_chain_query(5), Q.triangle_chain_ghd(5)
    dtc = D.tc_data_sparse(5, domain=128, ident=32, extra=96, seed=22)
    g16c, gtcc = g16.make_complete(q16), gtc.make_complete(tc)
    return [
        ("C_16 chain_ghd(16)", q16, d16, G.gym, dict(ghd=g16), g16c, 0),
        ("C_16 Log-GTA (gym_loggta)", q16, d16, A.gym_loggta, dict(ghd=g16),
         log_gta(g16c, q16), LOGDEPTH_MIN_BAG),
        ("C_16 Log-GTA' (acq_mr)", q16, d16, A.acq_mr, dict(ghd=g16),
         log_gta_prime(g16c, q16), LOGDEPTH_MIN_BAG),
        ("TC_15 Log-GTA (gym_loggta)", tc, dtc, A.gym_loggta, dict(ghd=gtc), log_gta(gtcc, tc), 0),
    ]


def logdepth_phase(torch, seed: int, audit):
    """The paper's log-depth path on the card: C_16 under chain_ghd(16),
    GYM(Log-GTA) and ACQ-MR (GYM on Log-GTA'), TC_15 under GYM(Log-GTA),
    and the one-round Shares baseline on the Table-2 query.  Each: 'cuda'
    == 'torch' in rows, schema and records, rows == the numpy join.
    Returns (summary, launches over the phase's 'cuda' runs)."""
    from repro_torch.core import gym as G
    from repro_torch.core import physical
    from repro_torch.core import queries as Q
    from repro_torch.core import shares as S
    from repro_torch.data import synthetic as D
    from repro_torch.kernels import ops as K

    totals = {k: 0 for k in GYM_KERNELS}
    summary = {}

    def tally():
        for k in GYM_KERNELS:
            totals[k] += K.launch_counts()[k]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    bags = BagRecorder(physical)
    try:
        for name, q, data, entry, kw, plan, min_bag in logdepth_workloads(seed):
            want = np_answer(q, data)
            want_bag = max(np_bag_sizes(q, plan, data).values())

            def run(backend):
                cfg = G.GymConfig(seed=23, local_backend=backend, max_cap_tuples=LOGDEPTH_MAX_CAP)
                return entry(q, data, p=8, config=cfg, device="cuda", **kw)

            K.reset_launch_counts()
            audit.reset()
            bags.largest = (0, 0)
            torch.cuda.reset_peak_memory_stats()
            (rows, schema, led), cold = timed(lambda: run("cuda"))
            peak = torch.cuda.max_memory_allocated()
            bag = bags.largest
            per_run = {k: K.launch_counts()[k] for k in GYM_KERNELS}
            audited = audit.counts()
            audit.check(f"logdepth {name}")
            (rows2, _, led2), warm = timed(lambda: run("cuda"))
            tally()
            K.reset_launch_counts()
            (trows, tschema, tled), tsec = timed(lambda: run("torch"))
            check(sum(K.launch_counts().values()) == 0, "'torch' backend launched a kernel")
            recs = [dataclasses.asdict(r) for r in led.records]
            check(tuple(schema) == tuple(tschema) == tuple(q.output_attrs), f"{name}: schema")
            check(np.array_equal(rows, trows), f"{name}: cuda rows != torch rows")
            check(recs == [dataclasses.asdict(r) for r in tled.records], f"{name}: ledger records")
            check((led.retries, led.output_tuples) == (tled.retries, tled.output_tuples),
                  f"{name}: retries/output")
            check(np.array_equal(rows, rows2) and recs == [dataclasses.asdict(r) for r in led2.records],
                  f"{name}: warm run differs")
            check(np.array_equal(rows.astype(np.int64), want) and len(want) > 0,
                  f"{name}: rows != numpy join")
            check(bag[0] == want_bag, f"{name}: largest bag {bag[0]} != numpy's {want_bag}")
            check(bag[0] >= min_bag, f"{name}: largest bag {bag[0]} < {min_bag} tuples")
            print(
                f"logdepth {name}: inputs={sum(len(v) for v in data.values())} "
                f"out={led.output_tuples} depth={plan.depth} "
                f"largest_bag_tuples={bag[0]} (per-shard cap {bag[1]}; numpy: {want_bag}) "
                f"peak_device_bytes={peak} cold_s={cold:.4f} warm_s={warm:.4f} "
                f"torch_backend_s={tsec:.4f} rounds={led.rounds} comm={led.comm_tuples} "
                f"dispatches={led.measured_dispatches} measure_dispatches={led.measure_dispatches} "
                f"retries={led.retries} padded_slots={led.padded_slots} "
                f"launches_per_run={per_run} semijoin_audit={audited} "
                "cuda==torch rows+ledger: yes rows==numpy join: yes", flush=True,
            )
            summary[name] = dict(rounds=led.rounds, comm=led.comm_tuples, bag=bag[0], peak=peak,
                                 cold_s=cold, warm_s=warm, launches=per_run)
    finally:
        bags.restore()
    # the Table-2 query under the one-round Shares baseline
    q, data = Q.star_query(5), D.star_data_sparse(5, seed=1)
    K.reset_launch_counts()
    (rows, schema, led), cold = timed(lambda: S.shares_join(q, data, p=8, seed=2, device="cuda"))
    per_run = {k: K.launch_counts()[k] for k in GYM_KERNELS}
    (rows2, _, _), warm = timed(lambda: S.shares_join(q, data, p=8, seed=2, device="cuda"))
    tally()
    K.reset_launch_counts()
    trows, tschema, tled = S.shares_join(q, data, p=8, seed=2, local_backend="torch", device="cuda")
    check(sum(K.launch_counts().values()) == 0, "'torch' backend launched a kernel")
    check(np.array_equal(rows, trows) and np.array_equal(rows, rows2) and tuple(schema) == tuple(tschema),
          "shares: cuda rows != torch rows")
    check([dataclasses.asdict(r) for r in led.records] == [dataclasses.asdict(r) for r in tled.records],
          "shares: ledger records")
    check(np.array_equal(rows.astype(np.int64), np_answer(q, data)), "shares: rows != numpy join")
    print(f"logdepth S_5 Shares (shares_join): out={led.output_tuples} rounds={led.rounds} "
          f"comm={led.comm_tuples} retries={led.retries} cold_s={cold:.4f} warm_s={warm:.4f} "
          f"launches_per_run={per_run} cuda==torch rows+ledger: yes rows==numpy join: yes",
          flush=True)
    summary["S_5 Shares"] = dict(rounds=led.rounds, comm=led.comm_tuples, launches=per_run)
    return summary, totals


# ------------------------------------------------------------ skew phase
SKEW_ENGINES = ("hash", "grid", "hybrid")
# benchmarks/bench_skew.py's capacity ceiling for its bench-size families
SKEW_BENCH_MAX_CAP = 1 << 18


@functools.lru_cache(maxsize=None)
def skew_families(seed: int, real: bool):
    """The skew phase's instances: at bench size the five families of
    ``benchmarks/bench_skew.py`` (their own seeds), at real size the
    planted heavy key at the gym phase's S_8 scale (from ``seed``)."""
    from repro_torch.core import queries as Q
    from repro_torch.data import synthetic as D

    star = (Q.star_query(8), Q.star_ghd(8))
    chain = (Q.chain_query(8), Q.chain_ghd(8))
    if not real:
        return {
            "S_8_z0": star + (D.star_data_zipf(8, domain=64, hub_rows=256, spoke_extra=32, s=0.0, seed=31),),
            "S_8_z11": star + (D.star_data_zipf(8, domain=64, hub_rows=256, spoke_extra=32, s=1.1, seed=31),),
            "C_8_z0": chain + (D.chain_data_zipf(8, domain=96, rows=192, s=0.0, seed=34),),
            "C_8_z11": chain + (D.chain_data_zipf(8, domain=96, rows=192, s=1.1, seed=34),),
            "S_8_heavy": star + (D.star_data_heavy(8, domain=64, hub_rows=256, heavy_share=0.8,
                                                   spoke_extra=16, seed=5),),
        }
    return {"S_8_heavy": star + (real_star_heavy(8, hub_rows=2**20, heavy_share=0.8,
                                                 spoke_extra=2**18, domain=2**22, seed=seed),)}


class HeavyRecorder:
    """Wraps ``PhysicalExecutor._measure_stage`` to sum the heavy
    destinations its measures flagged and count the hybrid-routed groups."""

    def __init__(self, physical):
        self.cls = physical.PhysicalExecutor
        self.orig = self.cls._measure_stage
        self.reset()
        rec = self

        def measure_stage(exe, groups, resolve, pending=None):
            out = rec.orig(exe, groups, resolve, pending)
            for m in out[0]:
                if m is not None:
                    rec.n_heavy += m.n_heavy
                    rec.routed += int(m.hybrid_routed)
            return out

        self.cls._measure_stage = measure_stage

    def reset(self):
        self.n_heavy = 0
        self.routed = 0

    def restore(self):
        self.cls._measure_stage = self.orig


def skew_phase(torch, seed: int, audit, gym_summary=None, sizes=("bench", "real")):
    """The hybrid engine beside hash and grid on the skew families (see
    the module doc).  Returns (summary, launches over the phase's 'cuda'
    runs)."""
    from repro_torch.core import gym as G
    from repro_torch.core import physical
    from repro_torch.kernels import ops as K

    totals = {k: 0 for k in GYM_KERNELS}
    totals.update({"semijoin_probe/bitmap": 0, "semijoin_probe/hash": 0})
    summary = {}

    def run(q, g, data, backend, strategy, max_cap):
        cfg = G.GymConfig(strategy=strategy, seed=23, local_backend=backend, max_cap_tuples=max_cap)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = G.gym(q, data, ghd=g, p=8, config=cfg, device="cuda")
        torch.cuda.synchronize()
        return out + (time.perf_counter() - t0,)

    def drive(name, q, g, data, strategy, max_cap, want=None):
        """A cold 'cuda' run, a warm one at real size (``want`` given), and
        a 'torch' run, checked against each other (and ``want``); None when
        both backends hit the ceiling.  Bench-size seconds measure launch
        and host overhead, so the bench families skip the warm repeat."""
        K.reset_launch_counts()
        audit.reset()
        heavy.reset()
        try:
            rows, schema, led, cold = run(q, g, data, "cuda", strategy, max_cap)
        except physical.CapacityCeiling as e:
            check(strategy == "hash", f"{name} {strategy}: {e}")
            try:
                run(q, g, data, "torch", strategy, max_cap)
            except physical.CapacityCeiling:
                print(f"skew {name} {strategy}: CapacityCeiling on both backends ({e})", flush=True)
                return None
            raise SmokeFailure(f"{name} {strategy}: only the 'cuda' backend hit the ceiling")
        per_run = {k: K.launch_counts()[k] for k in GYM_KERNELS}
        per_run.update({f"semijoin_probe/{k}": v for k, v in K.semijoin_probe_path_counts().items()})
        flagged, routed = heavy.n_heavy, heavy.routed
        audited = audit.counts()
        audit.check(f"skew {name} {strategy}")
        recs = [dataclasses.asdict(r) for r in led.records]
        warm = None
        if want is not None:
            rows2, _, led2, warm = run(q, g, data, "cuda", strategy, max_cap)
            check(np.array_equal(rows, rows2) and recs == [dataclasses.asdict(r) for r in led2.records],
                  f"{name} {strategy}: warm run differs")
        for k in GYM_KERNELS:
            totals[k] += K.launch_counts()[k]
        for k, v in K.semijoin_probe_path_counts().items():
            totals[f"semijoin_probe/{k}"] += v
        K.reset_launch_counts()
        trows, tschema, tled, tsec = run(q, g, data, "torch", strategy, max_cap)
        check(sum(K.launch_counts().values()) == 0, "'torch' backend launched a kernel")
        check(tuple(schema) == tuple(tschema) == tuple(q.output_attrs), f"{name} {strategy}: schema")
        check(np.array_equal(rows, trows), f"{name} {strategy}: cuda rows != torch rows")
        check(recs == [dataclasses.asdict(r) for r in tled.records], f"{name} {strategy}: ledger records")
        check((led.retries, led.output_tuples) == (tled.retries, tled.output_tuples),
              f"{name} {strategy}: retries/output")
        check(all(per_run[k] > 0 for k in GYM_KERNELS), f"{name} {strategy}: a kernel never launched")
        if want is not None:
            check(np.array_equal(rows.astype(np.int64), want) and len(want) > 0,
                  f"{name} {strategy}: rows != numpy join")
        print(
            f"skew {name} {strategy}: out={led.output_tuples} comm={led.comm_tuples} "
            f"shuffle_tuples={led.shuffle_tuples} padded_slots={led.padded_slots} "
            f"heavy_tuples={led.heavy_tuples} light_tuples={led.light_tuples} "
            f"n_heavy={flagged} hybrid_routed_groups={routed} retries={led.retries} "
            f"rounds={led.rounds} dispatches={led.measured_dispatches} "
            f"measure_dispatches={led.measure_dispatches} cold_s={cold:.4f} "
            f"warm_s={'not run' if warm is None else f'{warm:.4f}'} "
            f"torch_backend_s={tsec:.4f} launches_per_run={per_run} semijoin_audit={audited} "
            "cuda==torch rows+ledger: yes" + (" rows==numpy join: yes" if want is not None else ""),
            flush=True,
        )
        summary[f"{name}/{strategy}"] = dict(
            out=led.output_tuples, comm=led.comm_tuples, padded=led.padded_slots,
            heavy=led.heavy_tuples, retries=led.retries, dispatches=led.measured_dispatches,
            n_heavy=flagged, cold_s=cold, warm_s=warm, launches=per_run,
        )
        return rows, led

    heavy = HeavyRecorder(physical)
    try:
        for size in sizes:
            real = size == "real"
            for fam, (q, g, data) in skew_families(seed, real).items():
                name = f"{fam} {size}"
                want = np_answer(q, data) if real else None
                res = {e: drive(name, q, g, data, e, None if real else SKEW_BENCH_MAX_CAP, want)
                       for e in SKEW_ENGINES}
                sets = [np.unique(r[0].astype(np.int64), axis=0) for r in res.values() if r]
                check(all(np.array_equal(x, sets[0]) for x in sets), f"{name}: engines disagree on rows")
                hyb = res["hybrid"][1]
                check(hyb.retries == 0, f"{name}: hybrid made {hyb.retries} retries")
                if fam == "S_8_heavy":
                    check(hyb.heavy_tuples > 0, f"{name}: no heavy tuples under hybrid")
                    if res["hash"] is not None:
                        check(hyb.padded_slots < res["hash"][1].padded_slots,
                              f"{name}: hybrid padded {hyb.padded_slots} >= hash "
                              f"{res['hash'][1].padded_slots}")
        if "real" in sizes:
            # the uniform control: the gym phase's real S_8 under hybrid must
            # be the hash engine's run, record for record
            q, g, data = families(seed, True)["S_8"]
            rows, led = drive("S_8 real (uniform control)", q, g, data, "hybrid", None,
                              real_answer(seed, "S_8"))
            hs = (gym_summary or {}).get("S_8/real")
            if hs is None:  # the gym phase did not run: run its hash query here
                hrows, _, hled, _ = run(q, g, data, "cuda", "hash", None)
                hs = dict(records=[dataclasses.asdict(r) for r in hled.records])
            check([dataclasses.asdict(r) for r in led.records] == hs["records"],
                  "uniform control: hybrid records != the hash run's")
            check(led.heavy_tuples == 0, "uniform control: heavy tuples on uniform data")
            print(f"skew S_8 real (uniform control): hybrid == hash record for record "
                  f"(comm={led.comm_tuples} padded_slots={led.padded_slots} "
                  f"dispatches={led.measured_dispatches} heavy_tuples=0)", flush=True)
    finally:
        heavy.restore()
    return summary, totals


# ------------------------------------------------------------ packed wire
def wire_edge_checks(torch, dev):
    """The codec kernels' bytes exactly equal to the plain bit-plane
    version's, and decode the exact inverse, at edge cases: arity 0,
    negative 32-bit columns, c off a multiple of 8 and c = 0, empty and
    full buckets, row_bits from 2 to 1 + 8 * 32, many segments, and the
    golden fixture's bytes."""
    from repro_torch.kernels import wire_codec as WC
    from repro_torch.relational import wire as W

    rng = np.random.default_rng(11)
    n_checks = 0
    cases = [((), 5, 37, "random"), ((32, 32), 3, 64, "random"), ((6,) * 7, 8, 33, "random"),
             ((6,) * 7, 8, 0, "random"), ((5, 1, 17), 4, 40, "empty"), ((5, 1, 17), 4, 40, "full"),
             ((21,) * 7, 64, 4099, "random")]
    cases += [((b,) * k, 3, 24, "random") for b, k in ((1, 1), (3, 1), (31, 1), (32, 1), (7, 5),
                                                        (32, 4), (32, 8))]
    for col_bits, segs, c, occ in cases:
        cols = []
        for nb in col_bits:
            lo = -(2**31) if nb == 32 else 0
            cols.append(rng.integers(lo, 2**nb if nb < 32 else 2**31, (segs, c)).astype(np.int32))
        buf = np.stack(cols, -1) if cols else np.zeros((segs, c, 0), np.int32)
        valid = {"empty": np.zeros((segs, c), bool), "full": np.ones((segs, c), bool)}.get(
            occ, rng.random((segs, c)) < 0.6)
        fmt = W.WireFormat(col_bits)
        tb, tv = torch.from_numpy(buf).to(dev), torch.from_numpy(valid).to(dev)
        got = WC.wire_encode(tb, tv, fmt)
        check(torch.equal(got, W.wire_encode(tb, tv, fmt)),
              f"wire_encode != plain at bits {col_bits} segments {segs} c {c} {occ}")
        b2, v2 = WC.wire_decode(got, fmt, c)
        check(torch.equal(b2, tb) and torch.equal(v2, tv),
              f"wire_decode does not invert encode at bits {col_bits} c {c} {occ}")
        n_checks += 2
    z = np.load(os.path.join(HERE, "tests", "fixtures", "wire_s8_packed.npz"))
    fmt = W.WireFormat(tuple(int(b) for b in z["col_bits"]))
    packed = torch.from_numpy(z["wire"]).to(dev)
    b2, v2 = WC.wire_decode(packed, fmt, int(z["c_out"]))
    pb, pv = W.wire_decode(packed, fmt, int(z["c_out"]))
    check(torch.equal(b2, pb) and torch.equal(v2, pv), "wire_decode != plain on the golden fixture")
    check(torch.equal(WC.wire_encode(b2, v2, fmt), packed), "wire_encode != the golden fixture bytes")
    torch.cuda.synchronize()
    return n_checks + 2


def advisor_key(q, g, data, wire_format, p=8, deduped=False):
    """The plan ``GymConfig(plan="auto")`` should choose, computed on the
    host from the same statistics ``GymDriver`` uses (``deduped``: every
    relation is already a set, as ``real_chain``/``real_star`` make them,
    so the distinct counts are the row counts)."""
    from repro_torch.core import optimizer as O
    from repro_torch.core.costs import DEFAULT_DISPATCH_OVERHEAD_SLOTS
    from repro_torch.relational.wire import WirePolicy, wire_gain

    rows = {a.alias: (np.asarray(data[a.rel], np.int32) if deduped
                      else np.unique(np.asarray(data[a.rel], np.int32), axis=0)) for a in q.atoms}
    stats = {a.rel: int(rows[a.alias].shape[0]) for a in q.atoms}
    skew = {a.rel: O.skew_share(rows[a.alias]) for a in q.atoms}
    pol = WirePolicy.from_columns([(a.attrs, rows[a.alias]) for a in q.atoms])
    wg = wire_gain([pol.format_for(a.attrs) for a in q.atoms]) if wire_format == "packed" else 1.0
    return O.choose_plan(
        q, stats, profile=O.MachineProfile(p=p, dispatch_overhead=DEFAULT_DISPATCH_OVERHEAD_SLOTS),
        hand_ghd=g, local_backend=None, calibrate_shuffle=True, skew=skew,
        calibrate_options=(True, False), wire_gain=wg,
    ).key


def wire_phase(torch, seed: int, audit, gym_summary=None, sizes=("bench", "real")):
    """The packed wire and the plan advisor (see the module doc).  Returns
    (summary, launches over the phase's 'cuda' runs, recorded codec calls)."""
    from repro_torch.core import gym as G
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import wire_codec as WC
    from repro_torch.relational.spmd import SPMD

    kernels = GYM_KERNELS + WIRE_KERNELS
    totals = {k: 0 for k in kernels}
    summary = {}

    def run(q, g, data, backend, **cfg):
        """One query: (rows, schema, ledger, seconds, the chosen plan's key,
        engine and backend, the executor's backend).  Nothing of the
        driver is kept, so its device tables are freed before the next."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drv = G.GymDriver(q, g, data, SPMD(8, device="cuda"),
                          G.GymConfig(seed=23, local_backend=backend, **cfg))
        out = drv.run()
        rows = out.to_numpy()
        torch.cuda.synchronize()
        plan = None if drv.plan is None else (
            drv.plan.key, drv.plan.engine, drv.plan.local_backend, drv.executor.local_backend)
        return rows, out.schema, drv.ledger, time.perf_counter() - t0, plan

    def counted(fn):
        K.reset_launch_counts()
        audit.reset()
        res = fn()
        per = {k: K.launch_counts()[k] for k in kernels}
        for k in kernels:
            totals[k] += per[k]
        return res, per

    def same(a, b, what):
        check(tuple(a[1]) == tuple(b[1]), f"{what}: schema")
        check(np.array_equal(a[0], b[0]), f"{what}: rows")
        check([dataclasses.asdict(r) for r in a[2].records] == [dataclasses.asdict(r) for r in b[2].records],
              f"{what}: ledger records")
        check((a[2].retries, a[2].output_tuples) == (b[2].retries, b[2].output_tuples),
              f"{what}: retries/output")

    recorders = {"wire_encode": Recorder(torch, WC, "wire_encode"),
                 "wire_decode": Recorder(torch, WC, "wire_decode")}
    try:
        if "bench" in sizes:
            for fam, (q, g, data) in families(seed, False).items():
                want = np_answer(q, data)
                for engine in ("hash", "grid", "hybrid"):
                    name = f"wire {fam} bench {engine}"
                    packed, per = counted(lambda: run(q, g, data, "cuda", strategy=engine,
                                                      wire_format="packed"))
                    audit.check(name)
                    check(all(per[k] > 0 for k in kernels), f"{name}: a kernel never launched {per}")
                    K.reset_launch_counts()
                    tpacked = run(q, g, data, "torch", strategy=engine, wire_format="packed")
                    check(sum(K.launch_counts().values()) == 0, "'torch' backend launched a kernel")
                    same(packed, tpacked, f"{name} cuda vs torch")
                    dense, _ = counted(lambda: run(q, g, data, "cuda", strategy=engine))
                    lp, ld = packed[2], dense[2]
                    check(np.array_equal(np.unique(packed[0].astype(np.int64), axis=0), want),
                          f"{name}: rows != numpy join")
                    check(np.array_equal(packed[0], dense[0]) and lp.comm_tuples == ld.comm_tuples
                          and lp.retries == ld.retries and lp.useful_bytes == ld.useful_bytes,
                          f"{name}: packed and dense disagree in rows, comm, retries or useful bytes")
                    check(lp.payload_bytes < ld.payload_bytes, f"{name}: packed bytes >= dense")
                    print(f"{name}: out={lp.output_tuples} comm={lp.comm_tuples} retries={lp.retries} "
                          f"payload_bytes packed={lp.payload_bytes} dense={ld.payload_bytes} "
                          f"(ratio {lp.payload_bytes / ld.payload_bytes:.4f}) padded_slots "
                          f"packed={lp.padded_slots} dense={ld.padded_slots} dispatches "
                          f"packed={lp.measured_dispatches} dense={ld.measured_dispatches} "
                          f"cold_s={packed[3]:.4f} launches={per} cuda==torch rows+ledger: yes "
                          "rows==numpy join: yes", flush=True)
                    summary[f"{fam}/bench/{engine}"] = dict(
                        payload=lp.payload_bytes, dense_payload=ld.payload_bytes, launches=per)
        if "real" in sizes:
            for fam, (q, g, data) in families(seed, True).items():
                name = f"wire {fam} real hash"
                want = real_answer(seed, fam)
                cold, per = counted(lambda: run(q, g, data, "cuda", wire_format="packed"))
                audit.check(name)
                base = peak_reset(torch)
                warm, _ = counted(lambda: run(q, g, data, "cuda", wire_format="packed"))
                peak = torch.cuda.max_memory_allocated() - base
                check(all(per[k] > 0 for k in kernels), f"{name}: a kernel never launched {per}")
                same(cold, warm, f"{name} warm run")
                check(np.array_equal(cold[0].astype(np.int64), want) and len(want) > 0,
                      f"{name}: rows != numpy join")
                gs = (gym_summary or {}).get(f"{fam}/real")
                if gs is None:  # the gym phase did not run: run its dense query here
                    base = peak_reset(torch)
                    d = run(q, g, data, "cuda")
                    gs = dict(payload_bytes=d[2].payload_bytes,
                              peak=torch.cuda.max_memory_allocated() - base,
                              comm=d[2].comm_tuples, warm_s=d[3])
                led = cold[2]
                check(led.comm_tuples == gs["comm"] and led.retries == 0,
                      f"{name}: comm or retries differ from the dense run")
                check(led.payload_bytes < gs["payload_bytes"], f"{name}: packed bytes >= dense")
                check(peak <= WIRE_PEAK_RATIO_MAX * gs["peak"],
                      f"{name}: packed peak {peak} > {WIRE_PEAK_RATIO_MAX} x dense {gs['peak']}")
                print(f"{name}: out={led.output_tuples} comm={led.comm_tuples} retries={led.retries} "
                      f"payload_bytes packed={led.payload_bytes} dense={gs['payload_bytes']} "
                      f"(ratio {led.payload_bytes / gs['payload_bytes']:.4f}) padded_slots="
                      f"{led.padded_slots} dispatches={led.measured_dispatches} peak_bytes "
                      f"packed={peak} dense={gs['peak']} (ratio {peak / gs['peak']:.4f}) "
                      f"cold_s={cold[3]:.4f} warm_s={warm[3]:.4f} dense_warm_s={gs['warm_s']:.4f} "
                      f"launches={per} rows==numpy join: yes", flush=True)
                summary[f"{fam}/real"] = dict(payload=led.payload_bytes, dense_payload=gs["payload_bytes"],
                                              peak=peak, dense_peak=gs["peak"], cold_s=cold[3],
                                              warm_s=warm[3], launches=per)
        # the advisor: plan="auto" with the packed wire (so the codec runs
        # too), its key against the host-side choice from the same statistics
        auto = [(f"{fam} bench", q, g, data, False) for fam, (q, g, data) in
                (families(seed, False).items() if "bench" in sizes else [])]
        if "real" in sizes:
            auto += [(f"{fam} real", q, g, data, True) for fam, (q, g, data) in
                     families(seed, True).items()]
            q, g, data = skew_families(seed, True)["S_8_heavy"]
            auto.append(("S_8_heavy real", q, g, data, True))
        for name, q, g, data, real in auto:
            key = advisor_key(q, g, data, "packed", deduped=real)
            # local_backend None: the device's default, which the plan must keep
            res, per = counted(lambda: run(q, g, data, None, plan="auto", wire_format="packed"))
            audit.check(f"wire auto {name}")
            rows, _, led, sec, (pkey, pengine, pbackend, ebackend) = res
            check(pkey == key, f"auto {name}: chose {pkey}, the host advisor {key}")
            check(pbackend is None and ebackend == "cuda",
                  f"auto {name}: the plan turned the kernels off")
            check(all(per[k] > 0 for k in kernels), f"auto {name}: a kernel never launched {per}")
            want = np_answer(q, data) if name.startswith("S_8_heavy") or not real else real_answer(
                seed, name.split()[0])
            check(np.array_equal(np.unique(rows.astype(np.int64), axis=0), want) and len(want) > 0,
                  f"auto {name}: rows != numpy join")
            if not real:
                K.reset_launch_counts()
                tres = run(q, g, data, "torch", plan="auto", wire_format="packed")
                check(sum(K.launch_counts().values()) == 0, "'torch' backend launched a kernel")
                same(res, tres, f"auto {name} cuda vs torch")
                check(tres[4][0] == pkey, f"auto {name}: the 'torch' run chose {tres[4][0]}")
            print(f"wire auto {name}: plan={pkey} (host advisor: same) engine="
                  f"{pengine} out={led.output_tuples} comm={led.comm_tuples} "
                  f"rounds={led.rounds} retries={led.retries} dispatches={led.measured_dispatches} "
                  f"payload_bytes={led.payload_bytes} cold_s={sec:.4f} launches={per} "
                  "rows==numpy join: yes", flush=True)
            summary[f"auto/{name}"] = dict(key=pkey, launches=per, cold_s=sec)
    finally:
        for r in recorders.values():
            r.restore()
    return summary, totals, {k: (r.best, r.kw) for k, r in recorders.items()}


def wire_timing(torch, recorded, launches, reps):
    """Time the codec kernels at the largest calls the wire phase gave
    them, beside the plain bit-plane versions (no library call computes
    the codec).  Returns the kernel records of the JSON line."""
    from repro_torch.kernels import wire_codec as WC
    from repro_torch.relational import wire as W

    dev = torch.device("cuda")
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.int32, device=dev)
    (buf, valid, fmt), _ = recorded["wire_encode"]
    (packed, dfmt, c_out), _ = recorded["wire_decode"]
    got = WC.wire_encode(buf, valid, fmt)
    enc_err = 0 if torch.equal(got, W.wire_encode(buf, valid, fmt)) else 1
    db, dv = WC.wire_decode(packed, dfmt, c_out)
    pb, pv = W.wire_decode(packed, dfmt, c_out)
    dec_err = max(int((db.long() - pb.long()).abs().max()) if db.numel() else 0,
                  int((dv != pv).sum()))
    plain_reps = max(1, min(reps, 5))
    rows = [
        dict(name="wire_encode", shape=f"buf {tuple(buf.shape)} bits {fmt.col_bits}",
             ms=time_cold(torch, lambda: WC.wire_encode(buf, valid, fmt), reps, flush),
             plain_ms=time_cold(torch, lambda: W.wire_encode(buf, valid, fmt), plain_reps, flush),
             err=enc_err, nbytes=buf.numel() * 4 + valid.numel() + got.numel(),
             ops=valid.numel() * fmt.row_bits * 3),
        dict(name="wire_decode", shape=f"packed {tuple(packed.shape)} c_out {c_out} bits {dfmt.col_bits}",
             ms=time_cold(torch, lambda: WC.wire_decode(packed, dfmt, c_out), reps, flush),
             plain_ms=time_cold(torch, lambda: W.wire_decode(packed, dfmt, c_out), plain_reps, flush),
             err=dec_err, nbytes=packed.numel() + db.numel() * 4 + dv.numel(),
             ops=dv.numel() * dfmt.row_bits * 3),
    ]
    recs = []
    for r in rows:
        t_bytes = r["nbytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / INT32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        print(f"kernel {r['name']}: {r['shape']} kernel_ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} "
              f"library_ms=None bound_ms={bound:.6f} ({'bytes' if t_bytes >= t_ops else 'operations'}: "
              f"{r['nbytes']} B, {r['ops']} int ops) share_of_bound={bound / r['ms']:.4f} "
              f"max_abs_err={r['err']} launches={launches[r['name']]}", flush=True)
        check(r["err"] == 0, f"{r['name']} disagrees with its plain version")
        recs.append({
            "name": r["name"], "route": "cuda", "source": WIRE_SOURCE,
            "replaces": KERNELS[r["name"]], "launches": launches[r["name"]],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
    return recs


# ------------------------------------------------------- flash attention
def _visible(torch, sq, sk, causal, window, dev):
    rows = torch.arange(sq, device=dev)[:, None]
    cols = torch.arange(sk, device=dev)[None, :]
    vis = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if causal:
        vis &= cols <= rows
    if window > 0:
        vis &= cols > rows - window
    return vis


def _flash_err(got, want) -> float:
    """max |got - want| / max(1, |want|): absolute at |o| <= 1, relative above."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / w.abs().clamp(min=1.0)).max()) if w.numel() else 0.0


def flash_edge_checks(torch, dev):
    """The flash kernel against its plain version on the card, within
    ``FLASH_TOL``: head widths 16/64/128/256 (and 80, padded), f32 and
    bf16, GQA groups 1/2/8, causal or not, window 0, shorter than a tile
    or longer, softcap 0 or 50, Sq != Skv both ways, Sq and Skv off the
    bf16 kernel's 128-row block and 64-key tile, Skv = 1, the main path's
    shape, and fully masked rows, which must be exactly 0."""
    import itertools

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref

    rng = np.random.default_rng(11)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0

    def run(dtype, b, h, kvh, sq, sk, d, causal, window, softcap):
        nonlocal n
        dt = getattr(torch, dtype)
        # q scaled by 4 so that the scores reach the softcap's bend
        q = torch.from_numpy(4 * rng.standard_normal((b, h, sq, d))).to(dev, dt)
        k = torch.from_numpy(rng.standard_normal((b, kvh, sk, d))).to(dev, dt)
        v = torch.from_numpy(rng.standard_normal((b, kvh, sk, d))).to(dev, dt)
        kw = dict(causal=causal, window=window, softcap=softcap)
        got = FA.flash_attention(q, k, v, **kw)
        want = FA.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        what = f"flash_attention {dtype} b{b} h{h}/{kvh} sq{sq} sk{sk} d{d} {kw}"
        check(got.dtype == dt and got.shape == q.shape, f"{what}: dtype/shape")
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
        err = _flash_err(got, want)
        check(err <= FLASH_TOL[dtype], f"{what}: err {err} > {FLASH_TOL[dtype]}")
        dead = ~_visible(torch, sq, sk, causal, window, dev).any(dim=1)
        check(bool((got[:, :, dead] == 0).all()), f"{what}: a fully masked row is not 0")
        worst[dtype] = max(worst[dtype], err)
        n += 1
        return got

    for d, dtype, g, causal, window, softcap in itertools.product(
        (16, 64, 128, 256), ("float32", "bfloat16"), (1, 2, 8), (True, False),
        (0, 37), (0.0, 50.0),
    ):
        run(dtype, 2, 8, 8 // g, 130, 130, d, causal, window, softcap)
    for d, dtype in itertools.product((16, 64, 128, 256, 80), ("float32", "bfloat16")):
        run(dtype, 1, 4, 2, 70, 200, d, True, 0, 50.0)     # Sq < Skv, top-left causal
        run(dtype, 1, 4, 2, 200, 70, d, False, 33, 0.0)    # Sq > Skv, window
        run(dtype, 2, 4, 1, 129, 1, d, False, 0, 0.0)      # Skv = 1
        for causal in (True, False):                       # rows 23.. see no key
            got = run(dtype, 1, 2, 1, 128, 16, d, causal, 8, 0.0)
            check(bool((got[:, :, 23:] == 0).all()), "masked rows 23.. are not 0")
    for d in (64, 128, 256):  # bf16 tensor-core path: a window shorter than
        # a tile, Sq off the 128-row block and Skv off the 64-key tile
        run("bfloat16", 1, 8, 1, 200, 200, d, True, 5, 50.0)
        run("bfloat16", 1, 8, 2, 77, 333, d, False, 0, 0.0)
        run("bfloat16", 1, 4, 4, 333, 77, d, True, 0, 50.0)
    # the main path's call: gemma2-9b's global layer at 2 x 4608 tokens
    run("bfloat16", 2, 16, 8, 4608, 4608, 256, True, 0, 50.0)
    # and once against the dense oracle
    q = torch.from_numpy(rng.standard_normal((2, 8, 150, 64))).to(dev, torch.float32)
    k = torch.from_numpy(rng.standard_normal((2, 2, 150, 64))).to(dev, torch.float32)
    err = _flash_err(FA.flash_attention(q, k, k, causal=True, window=40, softcap=50.0),
                     ref.attention_ref(q, k, k, causal=True, window=40, softcap=50.0))
    check(err <= FLASH_TOL["float32"], f"flash_attention vs attention_ref: {err}")
    torch.cuda.synchronize()
    return n + 1, worst


class FlashRecorder:
    """Wraps the flash wrapper to keep clones of the first call of a
    global (window 0) layer; the wrapped call still launches the kernel."""

    def __init__(self, mod):
        self.mod = mod
        self.orig = mod.flash_attention
        self.best = None
        mod.flash_attention = self

    def __call__(self, q, k, v, **kw):
        if self.best is None and not kw.get("window"):
            self.best = (q.clone(), k.clone(), v.clone(), dict(kw))
        return self.orig(q, k, v, **kw)

    def restore(self):
        self.mod.flash_attention = self.orig


def lm_phase(torch, seed: int, profile_dir: str = ""):
    """gemma2-9b serving through ``generate`` with the 'cuda' backend, held
    to a teacher-forced replay through the 'torch' backend on the card.
    With ``profile_dir``, one more warm prefill and decode are profiled."""
    from repro_torch.configs import get_config, get_model
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops as K
    from repro_torch.serve import generate

    torch.cuda.empty_cache()
    cfg = get_config(LM_ARCH)
    n_layers = len(cfg.blocks())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    model = get_model(cfg, "cuda", generator=gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(model.use_cuda, "LM model is not on the 'cuda' backend")
    prompt_np = np.random.default_rng(seed).integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT))
    prompt = torch.from_numpy(prompt_np).to("cuda")
    s_cache = LM_PROMPT + LM_STEPS + 1
    print(f"lm {cfg.name}: {n_layers} layers, d_model {cfg.d_model}, {n_params} params "
          f"({cfg.dtype}), init_s={init_s:.3f}; batch {LM_BATCH} x prompt {LM_PROMPT}, "
          f"s_cache {s_cache}, {LM_STEPS} greedy steps", flush=True)

    runs = []
    rec = FlashRecorder(FA)
    try:
        for name in ("cold", "warm"):
            torch.cuda.reset_peak_memory_stats()
            stats = {}
            K.reset_launch_counts()
            toks, logits = generate(model, prompt, steps=LM_STEPS, s_cache=s_cache,
                                    return_logits=True, stats=stats)
            counts = K.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            check(counts["flash_attention"] == n_layers,
                  f"lm {name}: flash_attention launched {counts['flash_attention']} times, "
                  f"not {n_layers}")
            check(all(counts[k] == 0 for k in GYM_KERNELS), f"lm {name}: gym kernel launched")
            runs.append(dict(name=name, toks=toks, logits=logits, stats=stats, peak=peak,
                             launches=counts["flash_attention"]))
    finally:
        rec.restore()
    cold, warm = runs
    toks, logits = cold["toks"], cold["logits"]
    check(toks.shape == (LM_BATCH, LM_STEPS) and logits.shape == (LM_BATCH, LM_STEPS, cfg.vocab),
          "lm: output shapes")
    check(bool(torch.isfinite(logits).all()), "lm: non-finite logits")
    check(torch.equal(toks, logits.argmax(-1)), "lm: greedy tokens are not the argmax")

    # teacher-forced replay through the plain attention on the card
    model.backend = "torch"
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, caches = model.prefill({"tokens": prompt}, s_cache=s_cache)
    ref_logits = [lg]
    for i in range(LM_STEPS - 1):
        lg, caches = model.decode_step(caches, toks[:, i])
        ref_logits.append(lg)
    ref_logits = torch.stack(ref_logits, dim=1)
    torch.cuda.synchronize()
    torch_s = time.perf_counter() - t0
    model.backend = None
    check(sum(K.launch_counts().values()) == 0, "lm: the 'torch' backend launched a kernel")
    del caches
    delta = float((logits - ref_logits).abs().max())
    scale = float(ref_logits.abs().max())
    check(delta <= LM_LOGIT_REL_TOL * scale,
          f"lm: max |dlogit| {delta} > {LM_LOGIT_REL_TOL} * max |logit| {scale}")
    top2 = ref_logits.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * delta
    same = ref_logits.argmax(-1) == toks
    check(bool(same[decided].all()), "lm: argmax differs where the margin exceeds 2 max |dlogit|")
    steps_per_gen = LM_STEPS - 1
    out = {}
    for r in runs:
        st = r["stats"]
        total = st["prefill_s"] + st["decode_s"]
        m = out[r["name"]] = dict(
            prefill_s=st["prefill_s"], decode_ms_per_step=1e3 * st["decode_s"] / steps_per_gen,
            decode_ms_per_token=1e3 * st["decode_s"] / (steps_per_gen * LM_BATCH),
            tokens_per_s=LM_BATCH * LM_STEPS / total,
            prefill_tokens_per_s=LM_BATCH * LM_PROMPT / st["prefill_s"],
            peak_bytes=r["peak"], flash_launches=r["launches"],
        )
        print(
            f"lm generate {r['name']}: prefill_s={st['prefill_s']:.4f} "
            f"decode_s={st['decode_s']:.4f} decode_ms_per_step={m['decode_ms_per_step']:.3f} "
            f"decode_ms_per_token={m['decode_ms_per_token']:.3f} "
            f"tokens_per_s={m['tokens_per_s']:.2f} "
            f"prefill_tokens_per_s={m['prefill_tokens_per_s']:.1f} "
            f"max_memory_allocated={r['peak']} flash_launches={r['launches']}",
            flush=True,
        )
    print(
        f"lm cuda vs torch backend (teacher-forced; the torch backend took {torch_s:.3f} s): "
        f"max|dlogit|={delta:.6g} max|logit|={scale:.6g} ratio={delta / scale:.3g} "
        f"(bound {LM_LOGIT_REL_TOL}); argmax equal on {int(same.sum())}/{same.numel()} "
        f"steps, margin > 2 max|dlogit| on {int(decided.sum())}; warm tokens == cold: "
        f"{bool(torch.equal(warm['toks'], toks))}; tokens[0][:8]={toks[0, :8].tolist()}",
        flush=True,
    )
    check(rec.best is not None, "lm: no global-layer flash call was recorded")
    if profile_dir:
        profile_lm(torch, model, prompt, s_cache, profile_dir)
    del model, logits, ref_logits, runs, cold, warm
    torch.cuda.empty_cache()
    return out, rec.best, n_layers


def profile_lm(torch, model, prompt, s_cache: int, out_dir: str) -> None:
    """``torch.profiler`` over one warm prefill and, apart, over the decode
    steps of one ``generate``: host seconds, the device's busy share, and
    the top device work by name (operator tables go to ``out_dir``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    logits, caches = model.prefill({"tokens": prompt}, s_cache=s_cache)
    tok = logits.argmax(-1)
    windows = {}
    for name in ("prefill", "decode"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if name == "prefill":
                model.prefill({"tokens": prompt}, s_cache=s_cache)
            else:
                for _ in range(LM_STEPS - 1):
                    logits, caches = model.decode_step(caches, tok)
                    tok = logits.argmax(-1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        windows[name] = (prof, wall)
    for name, (prof, wall) in windows.items():
        dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        kern = {}
        for e in dev_events:
            kern[e.name] = kern.get(e.name, 0.0) + e.time_range.elapsed_us()
        busy_s = sum(kern.values()) / 1e6
        with open(os.path.join(out_dir, f"profile_lm_{name}.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
        print(f"profile lm {name} (warm, profiled): wall_s={wall:.4f} device_busy_s={busy_s:.4f} "
              f"device_busy_share={busy_s / wall:.4f} device_ops={len(dev_events)}", flush=True)
        for kname, us in sorted(kern.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {kname[:90]:90s} device_ms={us / 1e3:.3f}", flush=True)


def visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave visible: the work this call needs."""
    rows = np.arange(sq, dtype=np.int64)
    hi = np.minimum(sk, rows + 1) if causal else np.full(sq, sk, np.int64)
    lo = np.maximum(0, rows - window + 1) if window > 0 else np.zeros(sq, np.int64)
    return int(np.maximum(0, hi - lo).sum())


def flash_timing(torch, recorded, launches, reps):
    """Time the flash kernel at its recorded main-path call beside its plain
    version and SDPA (a yardstick only: it computes no softcap)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA

    q, k, v, kw = recorded
    dev = q.device
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.int32, device=dev)  # > 50 MB L2
    got = FA.flash_attention(q, k, v, **kw)
    want = FA.flash_attention_plain(q, k, v, **kw)
    err = float((got.float() - want.float()).abs().max())
    rel = _flash_err(got, want)
    check(rel <= FLASH_TOL[str(q.dtype).split(".")[-1]], f"flash at main-path shapes: {rel}")
    del got, want
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    ms = time_cold(torch, lambda: FA.flash_attention(q, k, v, **kw), reps, flush)
    plain_ms = time_cold(torch, lambda: FA.flash_attention_plain(q, k, v, **kw),
                         max(3, reps // 10), flush)
    causal = bool(kw.get("causal"))
    try:
        def lib():
            F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)
        lib()
        lib_note = "SDPA enable_gqa=True, no softcap"
    except TypeError:  # a torch without enable_gqa: repeat the kv heads outside the timing
        kr, vr = (t.repeat_interleave(h // kvh, dim=1) for t in (k, v))

        def lib():
            F.scaled_dot_product_attention(q, kr, vr, is_causal=causal)
        lib_note = "SDPA on repeated kv heads, no softcap"
    library_ms = time_cold(torch, lib, reps, flush)
    pairs = visible_pairs(sq, sk, causal, int(kw.get("window") or 0))
    flops = 4 * b * h * d * pairs
    nbytes = (q.numel() * 2 + k.numel() + v.numel()) * q.element_size()
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    print(
        f"kernel flash_attention: q {tuple(q.shape)} k/v {tuple(k.shape)} {q.dtype} {kw} "
        f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} ({lib_note}) "
        f"bound_ms={bound:.6f} ({'operations' if t_ops >= t_bytes else 'bytes'}: {flops} flop "
        f"over {pairs} visible pairs, {nbytes} B) share_of_bound={bound / ms:.4f} "
        f"achieved_tflops={flops / ms / 1e9:.2f} max_abs_err={err:.6g} launches={launches}",
        flush=True,
    )
    return {
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": KERNELS["flash_attention"], "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--phases", default="gym,grid,skew,logdepth,wire,lm",
                    help="comma-separated main paths to drive: gym (the join path), "
                         "grid (the grid engine), skew (the hybrid engine beside hash "
                         "and grid on skewed data), logdepth (Log-GTA, Log-GTA', Shares), "
                         "wire (the packed wire and plan='auto'), lm (gemma2-9b serving)")
    ap.add_argument("--sizes", default="bench,real",
                    help="comma-separated gym, grid, skew and wire sizes to drive: bench, real")
    ap.add_argument("--profile", default="",
                    help="comma-separated families (S_8,C_8,TC_9) to profile at real size, "
                         "and lm to profile the LM serving path")
    ap.add_argument("--profile-out", default=os.path.join(HERE, "chiprun_out", "profile"))
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import hash_partition as HP
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref
    from repro_torch.kernels import semijoin_probe as SP
    from repro_torch.kernels import sorted_probe as SO

    # full-f32 products on the card: no TF32 in matrix products or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib_path = build.compile_library()
    build.load()
    print(f"build: {lib_path.name} from {len(build.sources())} sources, "
          f"nvcc_s={build.build_seconds:.2f} total_s={time.perf_counter() - t0:.2f}", flush=True)
    for line in build.build_log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()[:160]}")

    dev = torch.device("cuda")
    mma = sass_mma_count(lib_path)
    print(f"flash_attention SASS: {mma} tensor-core MMA instructions (HGMMA/HMMA; -1: no "
          f"cuobjdump)", flush=True)
    check(mma != 0, "the flash kernels' SASS holds no tensor-core MMA instruction")

    t0 = time.perf_counter()
    n = kernel_edge_checks(torch, K, ref, dev)
    n += sorted_probe_edge_checks(torch, K, ref, dev)
    n_bitmap = bitmap_edge_checks(torch, K, ref, dev)
    print(f"kernel edge cases: {n + n_bitmap} checks ({n_bitmap} of the semijoin probe's "
          f"bitmap path), every gym CUDA kernel == its plain version", flush=True)
    print(f"semijoin_probe bitmap path, a key >= bound in a child process: trapped "
          f"({bitmap_trap_check()})", flush=True)
    n_wire = wire_edge_checks(torch, dev)
    print(f"wire codec edge cases: {n_wire} checks, wire_encode/wire_decode == their plain "
          f"versions and decode inverts encode (the golden fixture included)", flush=True)
    n, worst = flash_edge_checks(torch, dev)
    print(f"flash_attention edge cases: {n} checks within {FLASH_TOL} of the plain version "
          f"(worst |d|/max(1,|o|): {worst}), fully masked rows exactly 0; "
          f"edge phase {time.perf_counter() - t0:.1f} s", flush=True)

    kernels = []
    by_path = {}
    summary = None
    if "gym" in phases:
        recorders = {
            "hash_partition": Recorder(torch, HP, "hash_partition"),
            "semijoin_probe": Recorder(torch, SP, "semijoin_probe"),
            "sorted_probe_ranges": Recorder(torch, SO, "sorted_probe_ranges"),
        }
        K.reset_launch_counts()
        try:
            summary, launches = main_path(torch, args.seed, tuple(args.sizes.split(",")))
        finally:
            for r in recorders.values():
                r.restore()
        print(f"main path launches (cuda gym runs): {launches}", flush=True)
        check(all(launches[k] > 0 for k in GYM_KERNELS), f"a kernel never launched: {launches}")
        sizes = set(args.sizes.split(","))
        if {"bench", "real"} <= sizes:
            # the dense path is unchanged: the counts from before the packed wire
            got = {
                "dispatches": {f: summary[f"{f}/real"]["dispatches"] for f in ("S_8", "C_8", "TC_9")},
                "padded": {f: summary[f"{f}/real"]["padded"] for f in ("S_8", "C_8", "TC_9")},
                "launches": {k: launches[k] for k in GYM_KERNELS},
            }
            check(got == DENSE_BASELINE, f"dense gym counts {got} != the baseline {DENSE_BASELINE}")
            print(f"dense baseline: dispatches, padded slots and launches equal those from "
                  f"before the packed wire {DENSE_BASELINE}", flush=True)
        check(launches["semijoin_probe/hash"] == 0
              and launches["semijoin_probe/bitmap"] == launches["semijoin_probe"],
              f"a main-path semijoin_probe launch took the hash path: {launches}")
        recorded = {k: (r.best, r.kw) for k, r in recorders.items()}
        kernels += kernel_timing(torch, K, ref, recorded, launches, args.reps)
        by_path["gym"] = launches
        fams = [f for f in args.profile.split(",") if f and f != "lm"]
        if fams:
            profile_queries(torch, args.seed, fams, args.profile_out)
    wire_recorded = None
    for path in ("grid", "skew", "logdepth", "wire"):
        if path not in phases:
            continue
        t0 = time.perf_counter()
        audit = SemijoinAudit(SP, K)
        K.reset_launch_counts()
        try:
            if path == "grid":
                _, launches = main_path(torch, args.seed, tuple(args.sizes.split(",")),
                                        strategy="grid", audit=audit, hash_summary=summary)
            elif path == "skew":
                _, launches = skew_phase(torch, args.seed, audit, summary,
                                         tuple(args.sizes.split(",")))
            elif path == "wire":
                _, launches, wire_recorded = wire_phase(torch, args.seed, audit, summary,
                                                        tuple(args.sizes.split(",")))
            else:
                _, launches = logdepth_phase(torch, args.seed, audit)
        finally:
            audit.restore()
        print(f"{path} path launches (cuda runs): {launches}; phase {time.perf_counter() - t0:.1f} s",
              flush=True)
        want = GYM_KERNELS + (WIRE_KERNELS if path == "wire" else ())
        check(all(launches[k] > 0 for k in want), f"{path}: a kernel never launched: {launches}")
        by_path[path] = launches
    if wire_recorded is not None:
        kernels += wire_timing(torch, wire_recorded, by_path["wire"], args.reps)
    for rec in kernels:
        rec["launches_by_path"] = {p: n.get(rec["name"], 0) for p, n in by_path.items()}
    if "lm" in phases:
        lm, flash_call, per_generate = lm_phase(
            torch, args.seed, args.profile_out if "lm" in args.profile.split(",") else "")
        kernels.append(flash_timing(torch, flash_call, per_generate, args.reps))
    torch.cuda.synchronize()
    print(f"chip_smoke phases {sorted(phases)}: total_s={time.perf_counter() - t_start:.1f}",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
