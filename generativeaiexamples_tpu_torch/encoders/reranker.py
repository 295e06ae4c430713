"""Cross-encoder reranker: replaces the reranking NIM.

Port of ``generativeaiexamples_tpu/encoders/reranker.py``: (query,
passage) pairs scored by a BERT cross-encoder with a rank head, the top
``top_n`` kept best first (the 40 -> 4 funnel of the reference's
multi-turn chain). A pair packs as the query (cut at ``max_len // 2``
tokens), a 0 separator and the passage, token type 1 on the passage, in
power-of-two (batch, length) buckets from 8; pairs are the micro-batch
unit, so one batch may mix queries.

Dispatch-ahead as the embedder: every batch of ``max_batch`` pairs is
launched before any score is fetched. ``pairs_reranked`` counts after the
fetch (the reference counts before it, ``reranker.py:107``). ``device``,
``dtype`` and the default e5-base encoder as ``Embedder``'s; default
weights from a ``torch.Generator`` seeded 13, with the rank head.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from generativeaiexamples_tpu_torch.core.metrics import REGISTRY
from generativeaiexamples_tpu_torch.encoders.embedder import (bucket,
                                                              encoder_setup,
                                                              upload)
from generativeaiexamples_tpu_torch.encoders.microbatch import MicroBatcher
from generativeaiexamples_tpu_torch.engine.tokenizer import (Tokenizer,
                                                            get_tokenizer)
from generativeaiexamples_tpu_torch.models import bert


class Reranker:
    def __init__(self, cfg: Optional[bert.BertConfig] = None,
                 params: Optional[bert.Params] = None,
                 tokenizer: Optional[Tokenizer] = None,
                 max_len: int = 512, max_batch: int = 64,
                 micro_window_s: float = 0.0, device=None,
                 dtype=None) -> None:
        self.device, self.cfg, self.params = encoder_setup(
            cfg, params, device, dtype, seed=13, with_rank_head=True)
        self.tokenizer = tokenizer or get_tokenizer("")
        self.max_len = min(max_len, self.cfg.max_positions)
        self.max_batch = max_batch
        # the coalescing unit must hold several funnels (a 40 -> 4 funnel
        # is one ~40-pair submission, and submissions never split);
        # _score_pairs chunks by max_batch internally with dispatch-ahead
        self._batcher: Optional[MicroBatcher] = (
            MicroBatcher(self._score_pairs, max_items=4 * max_batch,
                         window_s=micro_window_s, name="rerank")
            if micro_window_s > 0 else None)

    def close(self) -> None:
        """Stop the micro-batch worker thread (no-op without one): see
        ``Embedder.close``."""
        if self._batcher is not None:
            self._batcher.close()
            self._batcher = None

    def _pack_pairs(self, pairs: Sequence[Tuple[str, str]]):
        """Bucketed (tokens, mask, types) for a batch of (query, passage)
        pairs."""
        q_cache: dict = {}
        rows = []
        for query, passage in pairs:
            q_ids = q_cache.get(query)
            if q_ids is None:
                q_ids = self.tokenizer.encode(query)[: self.max_len // 2]
                q_cache[query] = q_ids
            p_ids = self.tokenizer.encode(passage)[
                : self.max_len - len(q_ids) - 1]
            rows.append((q_ids, p_ids))
        S = bucket(max(len(q) + len(p) + 1 for q, p in rows), self.max_len)
        B = bucket(len(rows), self.max_batch)
        tokens = np.zeros((B, S), np.int32)
        mask = np.zeros((B, S), bool)
        types = np.zeros((B, S), np.int32)
        for r, (q, p) in enumerate(rows):
            seq = list(q) + [0] + list(p)
            tokens[r, :len(seq)] = seq
            mask[r, :len(seq)] = True
            types[r, len(q) + 1:len(seq)] = 1  # passage segment
        for r in range(len(rows), B):
            mask[r, 0] = True
        return tokens, mask, types

    @torch.inference_mode()
    def _score_pairs(self, pairs: Sequence[Tuple[str, str]]) -> np.ndarray:
        """Scores for (query, passage) pairs: one batch per <= max_batch,
        every batch launched before any is fetched."""
        pending = []
        for i in range(0, len(pairs), self.max_batch):
            chunk = pairs[i:i + self.max_batch]
            tokens, mask, types = upload(self._pack_pairs(chunk),
                                         self.device)
            scores = bert.rank_score(self.params, self.cfg, tokens, mask,
                                     types)
            pending.append((scores, len(chunk)))
        out = [s[:n].cpu().numpy() for s, n in pending]
        REGISTRY.counter("pairs_reranked").inc(len(pairs))
        return (np.concatenate(out, axis=0) if out
                else np.zeros((0,), np.float32))

    def score(self, query: str, passages: Sequence[str]) -> np.ndarray:
        """Relevance scores (len(passages),) for one query."""
        if not passages:
            return np.zeros((0,), np.float32)
        pairs = [(query, p) for p in passages]
        if self._batcher is not None:
            return np.asarray(self._batcher.submit(pairs))
        return self._score_pairs(pairs)

    def rerank(self, query: str, passages: Sequence[str],
               top_n: int = 4) -> List[Tuple[int, float]]:
        """Top-n (index, score) pairs, best first: the 40 -> 4 funnel."""
        scores = self.score(query, passages)
        order = np.argsort(-scores)[:top_n]
        return [(int(i), float(scores[i])) for i in order]
