"""basic_rag — ingest→split→embed→store; retrieve→prompt→stream.

Behavioral parity with the reference's flagship example
(ref: RAG/examples/basic_rag/langchain/chains.py): `ingest_docs` loads and
chunks the file then indexes it (chains.py:54-88); `rag_chain` retrieves
top-k above the score threshold, trims context to the token budget, builds
the RAG prompt, and streams (chains.py:121-192 + retriever wiring 156-167;
budget DEFAULT_MAX_CONTEXT utils.py:103). `llm_chain` answers without
retrieval (chains.py:91-118).

The pipeline differences are architectural, not behavioral: embedding and
generation are in-process device calls instead of HTTP hops to NIM containers.

Port of ``generativeaiexamples_tpu/chains/basic_rag.py``, the same in
behaviour, over the port's context, store and engine.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterator, List, Sequence

from generativeaiexamples_tpu_torch.chains.context import ChainContext, get_context
from generativeaiexamples_tpu_torch.chains.loaders import load_document
from generativeaiexamples_tpu_torch.core.tracing import chain_instrumentation
from generativeaiexamples_tpu_torch.observability.otel import stage_span
from generativeaiexamples_tpu_torch.retrieval.store import Document
from generativeaiexamples_tpu_torch.server import guardrails
from generativeaiexamples_tpu_torch.server.base import BaseExample
from generativeaiexamples_tpu_torch.server.registry import register_example

logger = logging.getLogger(__name__)

COLLECTION = "basic_rag"


def _sampling(llm_settings: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "max_tokens": int(llm_settings.get("max_tokens", 256)),
        "temperature": float(llm_settings.get("temperature", 0.2)),
        "top_p": float(llm_settings.get("top_p", 0.7)),
        "stop": list(llm_settings.get("stop") or []),
    }


def trim_context(chunks: Sequence[str], tokenizer, budget: int) -> str:
    """Concatenate retrieved chunks up to the token budget
    (ref: LimitRetrievedNodesLength._postprocess_nodes, utils.py:106-134)."""
    used = 0
    kept: List[str] = []
    for chunk in chunks:
        n = len(tokenizer.encode(chunk))
        if used + n > budget:
            break
        kept.append(chunk)
        used += n
    return "\n\n".join(kept)


@register_example("basic_rag")
class BasicRAG(BaseExample):
    # subclasses point the same chain at their own collection
    # (e.g. chains/asr_stream_rag.py's live-transcript store)
    collection = COLLECTION

    def __init__(self, context: ChainContext = None) -> None:
        self.ctx = context or get_context()

    # ------------------------------------------------------------ ingestion

    @chain_instrumentation
    def ingest_docs(self, filepath: str, filename: str) -> None:
        text = load_document(filepath)
        if not text.strip():
            raise ValueError(f"no text extracted from {filename}")
        chunks = self.ctx.splitter().split(text)
        docs = [Document(content=c, metadata={"source": filename})
                for c in chunks]
        embeddings = self.ctx.embedder.embed_documents([d.content for d in docs])
        self.ctx.store(self.collection).add(docs, embeddings)
        logger.info("ingested %s: %d chunks", filename, len(docs))

    # ----------------------------------------------------------- generation

    @chain_instrumentation
    def llm_chain(self, query: str, chat_history: Sequence[Dict[str, str]],
                  **llm_settings: Any) -> Iterator[str]:
        messages = ([{"role": "system", "content": self.ctx.prompts["chat_template"]}]
                    + list(chat_history) + [{"role": "user", "content": query}])
        yield from self.ctx.llm.chat(messages, **_sampling(llm_settings))

    @chain_instrumentation
    def rag_chain(self, query: str, chat_history: Sequence[Dict[str, str]],
                  **llm_settings: Any) -> Iterator[str]:
        rcfg = self.ctx.config.retriever
        # stage spans + stage_<name>_s histograms (observability/otel.py):
        # the per-request view of the pipelined dataplane — embed rides the
        # cross-request micro-batcher, so concurrent requests share dispatches
        with stage_span("embed"):
            qvec = self.ctx.embedder.embed_queries([query])[0]
        with stage_span("retrieve"):
            hits = self.ctx.store(self.collection).search(
                qvec, top_k=rcfg.top_k, score_threshold=rcfg.score_threshold)
        context_text = trim_context([d.content for d, _ in hits],
                                    self.ctx.embedder.tokenizer,
                                    rcfg.max_context_tokens)
        guardrails.record_context(context_text)
        system = self.ctx.prompts["rag_template"].format(context=context_text)
        messages = ([{"role": "system", "content": system}]
                    + list(chat_history) + [{"role": "user", "content": query}])
        with stage_span("generate"):
            yield from self.ctx.llm.chat(messages, **_sampling(llm_settings))

    # ------------------------------------------------------------ documents

    def document_search(self, query: str, num_docs: int = 4) -> List[Dict[str, Any]]:
        qvec = self.ctx.embedder.embed_queries([query])[0]
        hits = self.ctx.store(self.collection).search(
            qvec, top_k=num_docs,
            score_threshold=self.ctx.config.retriever.score_threshold)
        return [{"source": str(d.metadata.get("source", "")),
                 "content": d.content, "score": score}
                for d, score in hits]

    def get_documents(self) -> List[str]:
        return self.ctx.store(self.collection).list_sources()

    def delete_documents(self, filenames: Sequence[str]) -> bool:
        return self.ctx.store(self.collection).delete_by_source(filenames) > 0
