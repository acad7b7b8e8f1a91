"""Synthetic relations and the GYM-assembled training data pipeline."""
from .pipeline import CorpusConfig, batches, corpus_query, eligible_docs, synth_corpus

__all__ = ["CorpusConfig", "batches", "corpus_query", "eligible_docs", "synth_corpus"]
