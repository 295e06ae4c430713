"""BM25 lexical index — the sparse half of hybrid retrieval.

The reference's agentic notebook builds an EnsembleRetriever over BM25 +
dense FAISS (ref: RAG/notebooks/langchain/agentic_rag_with_nemo_retriever_
nim.ipynb, "BM25Retriever + FAISS" hybrid, lines 227-235). This module
provides the BM25 side in-tree (Okapi BM25, k1/b defaults per the classic
formulation) plus reciprocal-rank fusion for the ensemble.

A copy of ``generativeaiexamples_tpu/retrieval/bm25.py`` (pure Python),
kept in the port because the port imports nothing of that package.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Dict, List, Sequence, Tuple

_TOKEN = re.compile(r"[a-z0-9]+")


def _tokenize(text: str) -> List[str]:
    return _TOKEN.findall(text.lower())


class BM25Index:
    def __init__(self, k1: float = 1.5, b: float = 0.75) -> None:
        self.k1 = k1
        self.b = b
        self._docs: List[str] = []
        self._tf: List[Counter] = []
        self._df: Counter = Counter()
        self._lengths: List[int] = []

    def add(self, texts: Sequence[str]) -> None:
        for text in texts:
            toks = _tokenize(text)
            tf = Counter(toks)
            self._docs.append(text)
            self._tf.append(tf)
            self._lengths.append(len(toks))
            for term in tf:
                self._df[term] += 1

    def search(self, query: str, top_k: int = 4) -> List[Tuple[int, float]]:
        """Top-k (doc_index, score)."""
        if not self._docs:
            return []
        n = len(self._docs)
        avg_len = sum(self._lengths) / n
        scores = [0.0] * n
        for term in _tokenize(query):
            df = self._df.get(term)
            if not df:
                continue
            idf = math.log(1 + (n - df + 0.5) / (df + 0.5))
            for i, tf in enumerate(self._tf):
                f = tf.get(term)
                if not f:
                    continue
                denom = f + self.k1 * (1 - self.b + self.b * self._lengths[i] / avg_len)
                scores[i] += idf * f * (self.k1 + 1) / denom
        order = sorted(range(n), key=lambda i: -scores[i])[:top_k]
        return [(i, scores[i]) for i in order if scores[i] > 0]


def reciprocal_rank_fusion(rankings: Sequence[Sequence[int]], k: int = 60,
                           top_k: int = 4) -> List[int]:
    """Fuse multiple ranked id lists (the EnsembleRetriever combiner)."""
    scores: Dict[int, float] = {}
    for ranking in rankings:
        for rank, doc_id in enumerate(ranking):
            scores[doc_id] = scores.get(doc_id, 0.0) + 1.0 / (k + rank + 1)
    return sorted(scores, key=lambda d: -scores[d])[:top_k]
