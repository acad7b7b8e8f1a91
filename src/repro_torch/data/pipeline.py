"""Relational data pipeline: training batches are assembled by GYM itself
(counterpart of ``repro/data/pipeline.py``).

Corpus metadata is relational:
    docs(doc_id, shard_id, len_bucket)
    shards(shard_id, quality)
    dedup(doc_id, keep)
    mix(len_bucket, weight)
The eligible-document set is the acyclic join
    docs |><| shards |><| dedup |><| mix
filtered to quality >= q_min, keep = 1, weight > 0, evaluated by the
port's ``gym()`` on the caller's device (with none, the CUDA card and its
``'cuda'`` backend, so the join runs the three gym kernels).  Token
batches are then made per eligible doc id from a deterministic LCG
stream, equal to the reference's token for token.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from ..core.gym import GymConfig, gym
from ..core.hypergraph import Atom, Query


@dataclasses.dataclass
class CorpusConfig:
    n_docs: int = 512
    n_shards: int = 16
    n_buckets: int = 4
    q_min: int = 2
    seed: int = 0


def corpus_query() -> Query:
    return Query(
        [
            Atom("docs", "docs", ("doc_id", "shard_id", "len_bucket")),
            Atom("shards", "shards", ("shard_id", "quality")),
            Atom("dedup", "dedup", ("doc_id", "keep")),
            Atom("mix", "mix", ("len_bucket", "weight")),
        ],
        name="CorpusJoin",
    )


def synth_corpus(cfg: CorpusConfig) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(cfg.seed)
    docs = np.stack(
        [
            np.arange(cfg.n_docs),
            rng.integers(0, cfg.n_shards, cfg.n_docs),
            rng.integers(0, cfg.n_buckets, cfg.n_docs),
        ],
        axis=1,
    ).astype(np.int32)
    shards = np.stack(
        [np.arange(cfg.n_shards), rng.integers(0, 5, cfg.n_shards)], axis=1
    ).astype(np.int32)
    dedup = np.stack(
        [np.arange(cfg.n_docs), (rng.random(cfg.n_docs) < 0.9).astype(int)],
        axis=1,
    ).astype(np.int32)
    mix = np.stack(
        [np.arange(cfg.n_buckets), rng.integers(0, 3, cfg.n_buckets)], axis=1
    ).astype(np.int32)
    return {"docs": docs, "shards": shards, "dedup": dedup, "mix": mix}


def eligible_docs(
    cfg: CorpusConfig, data: Optional[Dict[str, np.ndarray]] = None, p: int = 4,
    device=None, config: Optional[GymConfig] = None,
) -> Tuple[np.ndarray, Dict]:
    """GYM-evaluated corpus join + selection predicates -> (doc ids,
    ledger summary).  ``config`` replaces ``GymConfig(strategy="hash")``
    (to pin a backend, say)."""
    data = data or synth_corpus(cfg)
    # pre-filter the small dimension tables (selection pushdown), join with GYM
    data = dict(data)
    data["shards"] = data["shards"][data["shards"][:, 1] >= cfg.q_min]
    data["dedup"] = data["dedup"][data["dedup"][:, 1] == 1]
    data["mix"] = data["mix"][data["mix"][:, 1] > 0]
    rows, schema, ledger = gym(
        corpus_query(), data, p=p, config=config or GymConfig(strategy="hash"), device=device
    )
    doc_col = list(schema).index("doc_id")
    ids = np.unique(rows[:, doc_col])
    return ids.astype(np.int64), ledger.summary()


_LCG_A = np.uint64(6364136223846793005)
_LCG_C = np.uint64(1442695040888963407)


def _lcg_tokens(doc_id, n: int, vocab: int, seed: int) -> np.ndarray:
    """Deterministic per-doc token stream (synthetic corpus): ``(n,)`` for
    one doc id, ``(len(doc_id), n)`` for an array of them (the streams
    advance together, one step a column)."""
    ids = np.asarray(doc_id)
    start = [(int(d) * 2654435761 + seed * 97 + 1) % (1 << 64) for d in ids.reshape(-1)]
    x = np.array(start, dtype=np.uint64)
    out = np.empty((x.size, n), np.int64)
    with np.errstate(over="ignore"):  # uint64 wraparound is the algorithm
        for i in range(n):
            x = _LCG_A * x + _LCG_C
            out[:, i] = (x >> np.uint64(33)) % np.uint64(vocab)
    return out.reshape(ids.shape + (n,))


def batches(
    cfg: CorpusConfig,
    *,
    batch: int,
    seq: int,
    vocab: int,
    p: int = 4,
    data: Optional[Dict[str, np.ndarray]] = None,
    device=None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite batch iterator over GYM-eligible docs (tokens, targets as
    int32 numpy arrays); the join runs on ``device`` once, up front."""
    ids, _ = eligible_docs(cfg, data, p=p, device=device)
    if len(ids) == 0:
        raise ValueError("corpus join produced no eligible documents")
    rng = np.random.default_rng(cfg.seed + 1)
    while True:
        pick = rng.choice(ids, size=batch)
        toks = _lcg_tokens(pick, seq + 1, vocab, cfg.seed)
        yield {
            "tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
        }
