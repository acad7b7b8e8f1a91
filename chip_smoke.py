#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of GYM on one CUDA card.

    python3 chip_smoke.py [--seed N] [--reps N]

Run from the root of a checkout on a machine with a CUDA card (sm_90a,
an H100) and the CUDA toolkit.  In order it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the Hopper kernels from ``src/repro_torch/csrc`` and prints the
   build time;
3. holds each CUDA kernel exactly equal to its plain PyTorch version on
   the card at edge cases (n=0, all-INT32_MAX keys, -1 probes, p=7 and
   p=8, a top-bit seed);
4. drives the port's main path — default ``gym()`` (hash engine, DYM-d,
   fused, calibrated, dense wire) with the ``'cuda'`` backend — on S_8,
   C_8 and TC_9 at the ``benchmarks/bench_shuffle.py`` sizes and at a
   real size (about 2^20 tuples per relation at p=8, 8-9 M input tuples
   per query, made with vectorized numpy from ``--seed``).  Each run's
   rows, schema and ledger must equal a run with the ``'torch'`` backend
   (the plain versions) on the card, the real-size row sets must equal an
   independent numpy join, and every kernel must have launched;
5. times each kernel at the largest inputs the main path gave it (CUDA
   events, L2 flushed before each launch) beside its plain version, one
   PyTorch library call where one computes the same function, and its
   memory bound.

The second-to-last line is one JSON object describing the kernels; the
last line is ``{"ok": true, "device": {...}}``.  Any failed check raises
and the exit code is nonzero.  Without a CUDA card the script exits
nonzero before printing anything.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the 32-bit
# non-tensor-core rate as the integer-operation ceiling
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
I32MAX = 2**31 - 1

SOURCE = "src/repro_torch/csrc/gym_kernels.cu"
KERNELS = {
    # kernel name -> the TPU kernel (file:line of its body) it replaces
    "hash_partition": "src/repro/kernels/hash_partition.py:49",
    "semijoin_probe": "src/repro/kernels/semijoin_probe.py:33",
    "sorted_probe_ranges": "src/repro/kernels/sorted_probe.py:40",
}


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


class Recorder:
    """Wraps a kernel wrapper to keep (clones of) the largest inputs the
    main path gave it; the wrapped call still launches the kernel."""

    def __init__(self, torch, mod, attr):
        self.torch, self.mod, self.attr = torch, mod, attr
        self.orig = getattr(mod, attr)
        self.best = None
        self.size = -1
        setattr(mod, attr, self)

    def __call__(self, *args):
        size = sum(a.numel() for a in args if isinstance(a, self.torch.Tensor))
        if size > self.size:
            self.size = size
            self.best = tuple(a.clone() if isinstance(a, self.torch.Tensor) else a for a in args)
        return self.orig(*args)

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
    """Time each kernel at its recorded main-path inputs; compare with its
    plain version there.  Returns the kernel records of the JSON line."""
    from repro_torch.kernels import hash_partition as HP
    from repro_torch.kernels import semijoin_probe as SP
    from repro_torch.kernels import sorted_probe as SO

    dev = torch.device("cuda")
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.int32, device=dev)  # > 50 MB L2
    out = []
    # -- hash_partition
    keys, valid, p, seeds = recorded["hash_partition"]
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
    q, keys = recorded["semijoin_probe"]
    got = SP.semijoin_probe(q, keys)
    want = ref.semijoin_probe_ref(q, keys)
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    seg = torch.arange(q.shape[0], device=dev, dtype=torch.int64)[:, None] << 32
    # padding keys move below every probe so they never match
    q64 = q.long() + seg
    k64 = torch.where(keys == I32MAX, -(2**62), keys.long() + seg)
    check(torch.equal(torch.isin(q64, k64), want), "torch.isin yardstick disagrees")
    nbytes = q.numel() * 4 + keys.numel() * 4 + q.numel()
    ops = 30 * (q.numel() + keys.numel())
    out.append(dict(
        name="semijoin_probe", shape=f"q {tuple(q.shape)} keys {tuple(keys.shape)}",
        ms=time_cold(torch, lambda: SP.semijoin_probe(q, keys), reps, flush),
        plain_ms=time_cold(torch, lambda: ref.semijoin_probe_ref(q, keys), reps, flush),
        library_ms=time_cold(torch, lambda: torch.isin(q64, k64), reps, flush),
        max_abs_err=err, nbytes=nbytes, ops=ops,
    ))
    # -- sorted_probe_ranges (library yardstick: batched torch.searchsorted)
    q, keys = recorded["sorted_probe_ranges"]
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

    m = keys.shape[1]
    nbytes = q.numel() * 4 + keys.numel() * 4 + q.numel() * 8
    ops = q.numel() * 2 * 4 * max(1, m.bit_length())
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
            "name": r["name"], "route": "cuda", "source": SOURCE,
            "replaces": KERNELS[r["name"]], "launches": launches[r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": r["library_ms"],
        })
    return recs


# --------------------------------------------------------------- main path
def families(seed: int, real: bool):
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


def run_gym(torch, gym_mod, q, g, data, backend):
    cfg = gym_mod.GymConfig(strategy="hash", seed=23, local_backend=backend)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows, schema, led = gym_mod.gym(q, data, ghd=g, p=8, config=cfg, device="cuda")
    torch.cuda.synchronize()
    return rows, schema, led, time.perf_counter() - t0


def main_path(torch, seed: int, sizes=("bench", "real")):
    from repro_torch.core import gym as gym_mod
    from repro_torch.kernels import ops as K

    summary = {}
    totals = {k: 0 for k in KERNELS}
    for size in sizes:
        t0 = time.perf_counter()
        fams = families(seed, real=(size == "real"))
        n_in = {f: sum(len(v) for v in d.values()) for f, (_, _, d) in fams.items()}
        print(f"data {size}: built in {time.perf_counter() - t0:.2f} s; input tuples {n_in}", flush=True)
        for fam, (q, g, data) in fams.items():
            K.reset_launch_counts()
            rows, schema, led, cold = run_gym(torch, gym_mod, q, g, data, "cuda")
            per_run = K.launch_counts()
            rows2, schema2, led2, warm = run_gym(torch, gym_mod, q, g, data, "cuda")
            for k, v in K.launch_counts().items():
                totals[k] += v
            K.reset_launch_counts()
            trows, tschema, tled, tsec = run_gym(torch, gym_mod, q, g, data, "torch")
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
            check(all(v > 0 for v in per_run.values()), f"{fam} {size}: a kernel never launched {per_run}")
            if size == "real":
                want = np_answer(q, data)
                check(np.array_equal(rows.astype(np.int64), want), f"{fam} real: rows != numpy join")
                check(led.output_tuples > 0, f"{fam} real: empty answer")
            print(
                f"gym {fam} {size}: inputs={n_in[fam]} out={led.output_tuples} "
                f"cold_s={cold:.4f} warm_s={warm:.4f} torch_backend_s={tsec:.4f} "
                f"rounds={led.rounds} dispatches={led.measured_dispatches} "
                f"measure_dispatches={led.measure_dispatches} retries={led.retries} "
                f"comm={led.comm_tuples} padded_slots={led.padded_slots} "
                f"launches_per_run={per_run} cuda==torch rows+ledger: yes"
                + (" rows==numpy join: yes" if size == "real" else ""),
                flush=True,
            )
            summary[f"{fam}/{size}"] = dict(cold_s=cold, warm_s=warm, out=led.output_tuples,
                                            dispatches=led.measured_dispatches,
                                            launches=per_run)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--sizes", default="bench,real",
                    help="comma-separated main-path sizes to drive: bench, real")
    ap.add_argument("--profile", default="",
                    help="comma-separated families (S_8,C_8,TC_9) to profile at real size")
    ap.add_argument("--profile-out", default=os.path.join(HERE, "chiprun_out", "profile"))
    args = ap.parse_args(argv)

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
    print(f"build: {lib_path.name} nvcc_s={build.build_seconds:.2f} "
          f"total_s={time.perf_counter() - t0:.2f}", flush=True)

    dev = torch.device("cuda")
    n = kernel_edge_checks(torch, K, ref, dev)
    print(f"kernel edge cases: {n} checks, every CUDA kernel == its plain version", flush=True)

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
    check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
    recorded = {k: r.best for k, r in recorders.items()}
    kernels = kernel_timing(torch, K, ref, recorded, launches, args.reps)
    if args.profile:
        profile_queries(torch, args.seed, args.profile.split(","), args.profile_out)
    torch.cuda.synchronize()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
