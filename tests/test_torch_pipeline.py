"""The port's GYM-assembled data pipeline (``data/pipeline.py``) and
smoke batch on the CPU against the JAX package.

The corpus tables, the corpus join's eligible doc ids and ledger summary
(``CorpusConfig(n_docs=64, n_shards=8, seed=3)``), and the token batches
must equal the reference's exactly; the eligible set must also equal a
numpy evaluation of the selection predicates (the reference test's
oracle, ``tests/test_train_substrate.py``), there and on the default and a
4000-doc corpus.  The reference's join compiles once, in a module-scoped
fixture.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import pipeline as jpipe  # noqa: E402

from repro_torch.configs import get_config, make_smoke_batch, reduced_config  # noqa: E402
from repro_torch.data import CorpusConfig, batches, corpus_query, eligible_docs, synth_corpus  # noqa: E402
from repro_torch.data.pipeline import _lcg_tokens  # noqa: E402


def numpy_eligible(cfg: CorpusConfig) -> np.ndarray:
    d = synth_corpus(cfg)
    ok_shards = d["shards"][d["shards"][:, 1] >= cfg.q_min][:, 0]
    keep = d["dedup"][d["dedup"][:, 1] == 1][:, 0]
    ok_buckets = d["mix"][d["mix"][:, 1] > 0][:, 0]
    docs = d["docs"]
    ok = (np.isin(docs[:, 1], ok_shards) & np.isin(docs[:, 0], keep)
          & np.isin(docs[:, 2], ok_buckets))
    return np.unique(docs[ok, 0]).astype(np.int64)


SMALL = dict(n_docs=64, n_shards=8, seed=3)


@pytest.fixture(scope="module")
def ref_small():
    """The reference's eligible docs on the small corpus (one JAX compile,
    shared)."""
    return jpipe.eligible_docs(jpipe.CorpusConfig(**SMALL))


def test_eligible_docs_match_reference(ref_small):
    cfg, jcfg = CorpusConfig(**SMALL), jpipe.CorpusConfig(**SMALL)
    for name, t in synth_corpus(cfg).items():
        assert np.array_equal(t, jpipe.synth_corpus(jcfg)[name]), name
    assert [(a.alias, a.rel, a.attrs) for a in corpus_query().atoms] == [
        (a.alias, a.rel, tuple(a.attrs)) for a in jpipe.corpus_query().atoms]
    ids, summary = eligible_docs(cfg, device="cpu")
    want_ids, want_summary = ref_small
    assert ids.dtype == np.int64 and np.array_equal(ids, want_ids)
    assert np.array_equal(ids, numpy_eligible(cfg)) and len(ids) > 0
    assert summary == want_summary and summary["rounds"] >= 1


@pytest.mark.parametrize("cfg", [CorpusConfig(), CorpusConfig(n_docs=4000, n_shards=64, seed=17)],
                         ids=["default", "4000_docs"])
def test_eligible_docs_match_numpy(cfg):
    ids, summary = eligible_docs(cfg, device="cpu")
    assert np.array_equal(ids, numpy_eligible(cfg)) and len(ids) > 0
    assert summary["output_tuples"] >= len(ids) and summary["retries"] == 0


def test_batches_match_reference(ref_small, monkeypatch):
    # the reference's batches, its join's ids shared from the fixture
    monkeypatch.setattr(jpipe, "eligible_docs", lambda *a, **kw: ref_small)
    got = batches(CorpusConfig(**SMALL), batch=3, seq=24, vocab=101, device="cpu")
    want = jpipe.batches(jpipe.CorpusConfig(**SMALL), batch=3, seq=24, vocab=101)
    for _ in range(3):
        a, b = next(got), next(want)
        assert set(a) == set(b) == {"tokens", "targets"}
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32 and np.array_equal(a[k], b[k]), k
        assert np.array_equal(a["tokens"][:, 1:], a["targets"][:, :-1])
    # the LCG vectorized over docs keeps the uint64 wraparound: large ids
    # and seeds, and the full vocab of smollm
    ids = np.array([0, 1, 2**31 - 1, 2**40 + 7, 12345], np.int64)
    for seed, vocab in ((0, 49152), (17, 101), (2**20, 7)):
        block = _lcg_tokens(ids, 40, vocab, seed)
        for row, d in zip(block, ids):
            assert np.array_equal(row, jpipe._lcg_tokens(int(d), 40, vocab, seed))
        assert np.array_equal(_lcg_tokens(int(ids[3]), 40, vocab, seed), block[3])


def test_smoke_batch():
    for arch in ("smollm-360m", "qwen2-vl-2b"):
        cfg = reduced_config(get_config(arch))
        g = torch.Generator().manual_seed(1)
        b = make_smoke_batch(cfg, g, b=3, s=10)
        assert b["tokens"].shape == b["targets"].shape == (3, 10)
        assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < cfg.vocab
        if cfg.rope == "mrope":
            assert b["pos"].shape == (3, 3, 10) and torch.equal(b["pos"][2, 1], torch.arange(10))
        else:
            assert "pos" not in b
        again = make_smoke_batch(cfg, torch.Generator().manual_seed(1), b=3, s=10)
        assert all(torch.equal(b[k], again[k]) for k in b)
