"""Shared runtime context for chains: LLM, encoders, stores, splitter, prompts.

Port of ``generativeaiexamples_tpu/chains/context.py``: one
``ChainContext`` owns the engine and the encoders and hands chains their
dependencies, so every example runs in one process with no HTTP hops
between pipeline stages. ``store()`` builds each named collection with
``retrieval/adapters.make_store`` on the embedder's device.
``get_context(scheduler, device)`` builds the process-wide context on
first use: the LLM from ``chains/llm_client.get_llm`` and both encoders
with the configured micro-batch windows, on ``device`` (``cuda`` unless
the caller asks for another). ``set_context`` is the server-wiring hook.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional

from generativeaiexamples_tpu_torch.core.config import AppConfig, get_config
from generativeaiexamples_tpu_torch.core.prompts import get_prompts
from generativeaiexamples_tpu_torch.encoders.embedder import Embedder
from generativeaiexamples_tpu_torch.encoders.reranker import Reranker
from generativeaiexamples_tpu_torch.retrieval.text_splitter import (
    TokenTextSplitter)


@dataclass
class ChainContext:
    config: AppConfig
    llm: object
    embedder: Embedder
    reranker: Optional[Reranker] = None
    stores: Dict[str, object] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    @property
    def prompts(self) -> Dict[str, str]:
        return get_prompts()

    def store(self, collection: str = "default"):
        """Named collections (one per example), config-dispatched: the
        in-process store by default, Milvus/pgvector/Elasticsearch
        adapters for deployments running those services."""
        from generativeaiexamples_tpu_torch.retrieval.adapters import (
            make_store)

        with self._lock:
            if collection not in self.stores:
                self.stores[collection] = make_store(
                    dim=self.embedder.dim, config=self.config.vector_store,
                    name=collection, device=self.embedder.device)
            return self.stores[collection]

    def splitter(self) -> TokenTextSplitter:
        ts = self.config.text_splitter
        return TokenTextSplitter(chunk_size=ts.chunk_size,
                                 chunk_overlap=ts.chunk_overlap)


_context: Optional[ChainContext] = None
_context_lock = threading.Lock()


def get_context(scheduler=None, device=None) -> ChainContext:
    """Process-wide context; builds the engine and encoders on first use."""
    global _context
    with _context_lock:
        if _context is None:
            from generativeaiexamples_tpu_torch.chains.llm_client import (
                get_llm)

            config = get_config()
            # process-wide encoders micro-batch across requests: every
            # chain's embed/rerank call rides shared dispatches
            _context = ChainContext(
                config=config,
                llm=get_llm(scheduler, device=device),
                embedder=Embedder(
                    micro_window_s=config.embeddings.microbatch_window_ms
                    / 1e3, device=device),
                reranker=Reranker(
                    micro_window_s=config.ranking.microbatch_window_ms / 1e3,
                    device=device),
            )
        return _context


def set_context(context: Optional[ChainContext]) -> None:
    """Test hook / server wiring."""
    global _context
    with _context_lock:
        _context = context
