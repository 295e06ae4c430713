"""multi_turn_rag — two-store retrieval with the 40→4 rerank funnel.

Behavioral parity with the reference example
(ref: RAG/examples/advanced_rag/multi_turn_rag/chains.py): keeps a document
store and a conversation-memory store; each turn retrieves from BOTH with a
wide net (top_k=40 when a ranker is configured, chains.py:146-147), narrows
each pool to `retriever.top_k` with the cross-encoder
(ranker.compress_documents, chains.py:173-190), renders the multi-turn
template with {history} and {context}, streams, then writes the exchange
back into the conversation store (save_memory_and_get_output,
chains.py:63-68).

Device design: both rerank passes are single bucketed cross-encoder batches
(one forward each — see encoders/reranker.py), so the funnel costs
~2 forwards instead of 80 HTTP calls — and they ISSUE CONCURRENTLY, so the
pair-granular micro-batcher (encoders/microbatch.py) can merge them into
one. When the request carries chat history, the follow-up is first
condensed into a standalone query (prompts.query_rewriter_prompt) with the
raw-query retrieval speculatively overlapped behind that LLM call
(chains/lookahead.py, TeleRAG) — docs/rag_pipeline.md has the full
dataplane picture.

Port of ``generativeaiexamples_tpu/chains/multi_turn_rag.py``, the same in
behaviour, over the port's context, encoders and engine.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterator, List, Sequence

from generativeaiexamples_tpu_torch.chains import NO_CONTEXT_MSG
from generativeaiexamples_tpu_torch.chains.basic_rag import _sampling, trim_context
from generativeaiexamples_tpu_torch.chains.context import ChainContext, get_context
from generativeaiexamples_tpu_torch.chains.loaders import load_document
from generativeaiexamples_tpu_torch.chains.lookahead import (
    LookaheadRetrieval, submit_concurrently)
from generativeaiexamples_tpu_torch.core.tracing import chain_instrumentation
from generativeaiexamples_tpu_torch.observability.otel import stage_span
from generativeaiexamples_tpu_torch.retrieval.store import Document
from generativeaiexamples_tpu_torch.server import guardrails
from generativeaiexamples_tpu_torch.server.base import BaseExample
from generativeaiexamples_tpu_torch.server.registry import register_example

logger = logging.getLogger(__name__)

DOCS = "multi_turn_docs"
CONV = "multi_turn_conv"
WIDE_TOP_K = 40  # ref chains.py:146 — "Get 40 results ... compress them to 4"


@register_example("multi_turn_rag")
class MultiTurnRAG(BaseExample):
    def __init__(self, context: ChainContext = None) -> None:
        self.ctx = context or get_context()

    # ------------------------------------------------------------ ingestion

    @chain_instrumentation
    def ingest_docs(self, filepath: str, filename: str) -> None:
        if not filename.lower().endswith((".txt", ".pdf", ".md")):
            raise ValueError(
                f"{filename} is not a valid Text, PDF or Markdown file")
        text = load_document(filepath)
        if not text.strip():
            raise ValueError(f"no text extracted from {filename}")
        chunks = self.ctx.splitter().split(text)
        docs = [Document(content=c, metadata={"source": filename})
                for c in chunks]
        embeddings = self.ctx.embedder.embed_documents([d.content for d in docs])
        self.ctx.store(DOCS).add(docs, embeddings)
        logger.info("ingested %s: %d chunks", filename, len(docs))

    # -------------------------------------------------------------- memory

    def _save_memory(self, query: str, output: str) -> None:
        """Write the turn into the conversation store
        (ref save_memory_and_get_output, chains.py:63-68)."""
        texts = [f"User previously responded with {query}",
                 f"Agent previously responded with {output}"]
        docs = [Document(content=t, metadata={"source": "conversation"})
                for t in texts]
        embeddings = self.ctx.embedder.embed_documents(texts)
        self.ctx.store(CONV).add(docs, embeddings)

    def _retrieve_pool(self, collection: str, qvec, wide: bool) -> List[str]:
        rcfg = self.ctx.config.retriever
        top_k = WIDE_TOP_K if (wide and self.ctx.reranker) else rcfg.top_k
        hits = self.ctx.store(collection).search(
            qvec, top_k=top_k, score_threshold=rcfg.score_threshold)
        return [d.content for d, _ in hits]

    def _funnel(self, query: str, pool: List[str]) -> List[str]:
        """40→top_k cross-encoder narrowing (ref chains.py:173-190)."""
        if not pool or not self.ctx.reranker:
            return pool
        top_n = self.ctx.config.retriever.top_k
        ranked = self.ctx.reranker.rerank(query, pool, top_n=top_n)
        return [pool[i] for i, _ in ranked]

    # ----------------------------------------------------------- generation

    @chain_instrumentation
    def llm_chain(self, query: str, chat_history: Sequence[Dict[str, str]],
                  **llm_settings: Any) -> Iterator[str]:
        # ref chains.py:96-98: chat history handled via the conversation
        # store, not the raw message list
        messages = [{"role": "system",
                     "content": self.ctx.prompts["chat_template"]},
                    {"role": "user", "content": query}]
        yield from self.ctx.llm.chat(messages, **_sampling(llm_settings))

    def _condense(self, query: str, chat_history: Sequence[Dict[str, str]],
                  **settings: Any) -> str:
        """Rewrite a follow-up question into a standalone retrieval query
        using the turn history (the condense step of the reference's
        conversational examples; prompts.query_rewriter_prompt)."""
        s = _sampling(settings)
        s.update(max_tokens=96, temperature=0.0)
        history_txt = "\n".join(
            f"{m.get('role', 'user')}: {m.get('content', '')}"
            for m in chat_history)
        out = "".join(self.ctx.llm.chat(
            [{"role": "system",
              "content": self.ctx.prompts["query_rewriter_prompt"]},
             {"role": "user",
              "content": f"History:\n{history_txt}\n\n"
                         f"Follow-up question: {query}"}], **s)).strip()
        return out or query

    @chain_instrumentation
    def rag_chain(self, query: str, chat_history: Sequence[Dict[str, str]],
                  **llm_settings: Any) -> Iterator[str]:
        rcfg = self.ctx.config.retriever

        def retrieve_pools(q: str, qvec=None):
            if qvec is None:
                qvec = self.ctx.embedder.embed_queries([q])[0]
            return qvec, (self._retrieve_pool(DOCS, qvec, wide=True),
                          self._retrieve_pool(CONV, qvec, wide=True))

        search_query = query
        if chat_history:
            # Lookahead retrieval (TeleRAG, chains/lookahead.py): the
            # condense LLM call and the raw-query retrieval run CONCURRENTLY;
            # reconcile reuses the speculative pools when the rewrite stays
            # close in embedding space and re-retrieves otherwise
            look = LookaheadRetrieval(retrieve_pools).start(query)
            with stage_span("condense"):
                search_query = self._condense(query, chat_history,
                                              **llm_settings)
            with stage_span("retrieve"):
                _, (context_pool, history_pool) = look.reconcile(
                    search_query,
                    embed=lambda q: self.ctx.embedder.embed_queries([q])[0])
        else:
            with stage_span("retrieve"):
                _, (context_pool, history_pool) = retrieve_pools(query)

        # both funnels issue together: the reranker micro-batcher coalesces
        # their (query, passage) pairs into a shared cross-encoder dispatch
        with stage_span("rerank"):
            context, history = submit_concurrently(
                lambda: self._funnel(search_query, context_pool),
                lambda: self._funnel(search_query, history_pool))

        if not context and not history:
            yield NO_CONTEXT_MSG  # ref chains.py:198-203
            return

        tok = self.ctx.embedder.tokenizer
        budget = rcfg.max_context_tokens
        # history gets at most half the budget; context gets what's left, so
        # the combined prompt never exceeds max_context_tokens
        history_text = trim_context(history, tok, budget // 2)
        context_budget = budget - len(tok.encode(history_text))
        context_text = trim_context(context, tok, context_budget)
        guardrails.record_context(context_text)
        system = self.ctx.prompts["multi_turn_rag_template"].format(
            history=history_text or "(none)",
            context=context_text or "(none)")
        messages = [{"role": "system", "content": system},
                    {"role": "user", "content": query}]

        response = ""
        with stage_span("generate"):
            for chunk in self.ctx.llm.chat(messages, **_sampling(llm_settings)):
                response += chunk
                yield chunk
        self._save_memory(query, response)

    # ------------------------------------------------------------ documents

    def document_search(self, query: str, num_docs: int = 4) -> List[Dict[str, Any]]:
        qvec = self.ctx.embedder.embed_queries([query])[0]
        hits = self.ctx.store(DOCS).search(
            qvec, top_k=num_docs,
            score_threshold=self.ctx.config.retriever.score_threshold)
        return [{"source": str(d.metadata.get("source", "")),
                 "content": d.content, "score": score}
                for d, score in hits]

    def get_documents(self) -> List[str]:
        return self.ctx.store(DOCS).list_sources()

    def delete_documents(self, filenames: Sequence[str]) -> bool:
        return self.ctx.store(DOCS).delete_by_source(filenames) > 0
