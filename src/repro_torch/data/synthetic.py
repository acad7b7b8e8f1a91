"""Synthetic relation generators for benchmarks/examples.

``*_sparse`` generators produce matching-database-style inputs (paper
Appendix A): each relation is mostly a partial permutation, so every
pairwise join stays O(|R|) and end-to-end chain outputs are small — the
regime where round counts and communication constants are measurable
without output-size blowup."""
from __future__ import annotations

from typing import Dict

import numpy as np


def chain_data_sparse(
    n: int, *, domain: int = 32, ident: int = 8, extra: int = 12, seed: int = 0
) -> Dict[str, np.ndarray]:
    """C_n relations R_i(A_{i-1}, A_i): identity links on [0, ident) (so
    exactly ``ident`` complete chains survive) + random sparse links."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(1, n + 1):
        rows = [(v, v) for v in range(ident)]
        rows += [
            (int(rng.integers(ident, domain)), int(rng.integers(ident, domain)))
            for _ in range(extra)
        ]
        out[f"R{i}"] = np.unique(np.array(rows, np.int32), axis=0)
    return out


def star_data_sparse(
    n: int, *, domain: int = 16, hub_rows: int = 12, spoke_extra: int = 8,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """S_n: hub S(A_1..A_{n-1}) + spokes R_i(A_i, B_i); every hub value is
    matched in each spoke so the output is non-trivial but bounded."""
    rng = np.random.default_rng(seed)
    hub = rng.integers(0, domain // 2, (hub_rows, n - 1)).astype(np.int32)
    out = {"S": np.unique(hub, axis=0)}
    for i in range(1, n):
        vals = np.unique(hub[:, i - 1])
        rows = [(int(v), int(v) % 7) for v in vals]
        rows += [
            (int(rng.integers(domain // 2, domain)), int(rng.integers(0, 7)))
            for _ in range(spoke_extra)
        ]
        out[f"R{i}"] = np.unique(np.array(rows, np.int32), axis=0)
    return out


# ---------------------------------------------------------- skewed families
def zipf_values(
    rng: np.random.Generator, size: int, domain: int, s: float
) -> np.ndarray:
    """``size`` draws from a bounded zipf(s) over [0, domain): value v has
    probability ~ 1/(v+1)^s.  ``s=0`` is uniform; ``s ~ 1.1`` plants a
    rank-1 value carrying a ~1/H_{domain,s} share — the heavy-hitter
    regime the hybrid exchange routes around.  Bounded + deterministic
    (unlike ``Generator.zipf``), so benchmark inputs are reproducible."""
    if s <= 0:
        return rng.integers(0, domain, size).astype(np.int32)
    ranks = np.arange(1, domain + 1, dtype=np.float64)
    probs = ranks ** (-float(s))
    probs /= probs.sum()
    return rng.choice(domain, size=size, p=probs).astype(np.int32)


def star_data_zipf(
    n: int, *, domain: int = 16, hub_rows: int = 12, spoke_extra: int = 8,
    s: float = 1.1, seed: int = 0,
) -> Dict[str, np.ndarray]:
    """S_n with the hub's A_1 column zipf(s)-distributed (other columns
    uniform): at s >~ 1 one A_1 value carries a constant share of the hub,
    so every exchange hashing the hub on A_1 funnels that share onto one
    reducer.  Spokes match the realized hub values as in
    ``star_data_sparse`` (so the skew survives the semijoin phase).

    The zipf draw uses a quarter of the domain: H(m, 1.1) grows with the
    support m, so a narrow head keeps the rank-1 share (~1/H) above the
    heavy-hitter detection threshold at s=1.1 and p=8 — the regime the
    skew benchmark exercises — while s=0 stays a uniform control."""
    rng = np.random.default_rng(seed)
    half = max(2, domain // 2)
    cols = [zipf_values(rng, hub_rows, max(2, domain // 4), s)]
    cols += [
        rng.integers(0, half, hub_rows).astype(np.int32) for _ in range(n - 2)
    ]
    hub = np.stack(cols, 1).astype(np.int32)
    out = {"S": np.unique(hub, axis=0)}
    for i in range(1, n):
        vals = np.unique(hub[:, i - 1])
        rows = [(int(v), int(v) % 7) for v in vals]
        rows += [
            (int(rng.integers(half, domain)), int(rng.integers(0, 7)))
            for _ in range(spoke_extra)
        ]
        out[f"R{i}"] = np.unique(np.array(rows, np.int32), axis=0)
    return out


def star_data_heavy(
    n: int, *, domain: int = 32, hub_rows: int = 64, heavy_share: float = 0.8,
    spoke_extra: int = 8, seed: int = 0,
) -> Dict[str, np.ndarray]:
    """S_n with a PLANTED heavy hitter: ``heavy_share`` of the hub rows
    carry A_1 = 0 (distinct rows — the other columns are uniform draws,
    so dedup-on-load keeps them).  The adversarial single-key instance of
    the skew tests: hash exchanges on A_1 pile that share onto ONE
    reducer, while the hybrid exchange spreads it."""
    rng = np.random.default_rng(seed)
    half = max(2, domain // 2)
    k = int(hub_rows * heavy_share)
    a1 = np.concatenate(
        [np.zeros(k, np.int32), rng.integers(1, half, hub_rows - k)]
    )
    cols = [a1] + [
        rng.integers(0, half, hub_rows).astype(np.int32) for _ in range(n - 2)
    ]
    hub = np.stack(cols, 1).astype(np.int32)
    out = {"S": np.unique(hub, axis=0)}
    for i in range(1, n):
        vals = np.unique(hub[:, i - 1])
        rows = [(int(v), int(v) % 7) for v in vals]
        rows += [
            (int(rng.integers(half, domain)), int(rng.integers(0, 7)))
            for _ in range(spoke_extra)
        ]
        out[f"R{i}"] = np.unique(np.array(rows, np.int32), axis=0)
    return out


def chain_data_zipf(
    n: int, *, domain: int = 32, rows: int = 24, s: float = 1.1, seed: int = 0
) -> Dict[str, np.ndarray]:
    """C_n with each R_i's RIGHT attribute A_i zipf(s)-distributed and the
    left attribute uniform: the join/semijoin exchanges keyed on A_i see a
    heavy value (rank-1 of the zipf) on the R_i side while the R_{i+1}
    side stays uniform — skewing the exchange load without exploding the
    join output (the heavy key matches ~rows/domain partners)."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(1, n + 1):
        left = rng.integers(0, domain, rows).astype(np.int32)
        right = zipf_values(rng, rows, domain, s)
        out[f"R{i}"] = np.unique(np.stack([left, right], 1).astype(np.int32), axis=0)
    return out


def tc_data_sparse(
    n_tri: int, *, domain: int = 24, ident: int = 6, extra: int = 10, seed: int = 0
) -> Dict[str, np.ndarray]:
    """TC_n triangles: identity triangles on [0, ident) + sparse noise."""
    rng = np.random.default_rng(seed)
    out = {}
    k = 1
    for _ in range(n_tri):
        for _ in range(3):
            rows = [(v, v) for v in range(ident)]
            rows += [
                (int(rng.integers(ident, domain)), int(rng.integers(ident, domain)))
                for _ in range(extra)
            ]
            out[f"R{k}"] = np.unique(np.array(rows, np.int32), axis=0)
            k += 1
    return out


# --------------------------------------------------------------- MoE tokens
def zipf_hot_batch(
    e: int, d: int, b: int, s: int, *, zs: float = 1.5, seed: int = 0
) -> np.ndarray:
    """``(b, s, d)`` float32 tokens whose router traffic is zipf-skewed
    (``benchmarks/bench_moe.py::zipf_hot_batch``): each token is a noisy
    copy of one of ``e`` prototype directions, prototypes drawn
    ~ 1/rank^zs, so one expert's arrivals dominate."""
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((e, d)).astype(np.float32) * 2.0
    w = np.array([1.0 / (r + 1) ** zs for r in range(e)])
    pick = rng.choice(e, size=b * s, p=w / w.sum())
    x = protos[pick] + 0.05 * rng.standard_normal((b * s, d)).astype(np.float32)
    return x.reshape(b, s, d).astype(np.float32)
