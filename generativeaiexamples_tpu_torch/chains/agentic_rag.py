"""agentic_rag — self-corrective RAG with hybrid retrieval.

Behavioral parity with the reference's agentic notebook (ref: RAG/notebooks/
langchain/agentic_rag_with_nemo_retriever_nim.ipynb): hybrid BM25 + dense
ensemble retrieval (cells ~227-235, EnsembleRetriever), a retrieval grader
that filters irrelevant documents, question rewriting when retrieval fails,
generation, a hallucination grader checking groundedness, and an answer
grader checking usefulness — wired as a state machine (LangGraph build,
cells 13-37) with bounded retries.

In-tree the graph is an explicit loop: retrieve → grade docs →
(rewrite + retry | generate) → grade generation → (accept | regenerate |
rewrite + retry), capped at `max_retries` passes.

Port of ``generativeaiexamples_tpu/chains/agentic_rag.py``, the same in
behaviour, over the port's context, encoders, store, BM25 and engine. The
BM25 index is the instance's, as the reference's is: a delete rebuilds it
from the documents that stay.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterator, List, Sequence

from generativeaiexamples_tpu_torch.chains import NO_CONTEXT_MSG
from generativeaiexamples_tpu_torch.chains.basic_rag import _sampling, trim_context
from generativeaiexamples_tpu_torch.chains.context import ChainContext, get_context
from generativeaiexamples_tpu_torch.chains.loaders import load_document
from generativeaiexamples_tpu_torch.chains.lookahead import (
    DEFAULT_SIM_THRESHOLD, LookaheadRetrieval)
from generativeaiexamples_tpu_torch.chains.query_decomposition import extract_json
from generativeaiexamples_tpu_torch.core.tracing import chain_instrumentation
from generativeaiexamples_tpu_torch.observability.otel import stage_span
from generativeaiexamples_tpu_torch.retrieval.bm25 import (
    BM25Index, reciprocal_rank_fusion)
from generativeaiexamples_tpu_torch.retrieval.store import Document
from generativeaiexamples_tpu_torch.server import guardrails
from generativeaiexamples_tpu_torch.server.base import BaseExample
from generativeaiexamples_tpu_torch.server.registry import register_example

logger = logging.getLogger(__name__)

COLLECTION = "agentic_rag"
MAX_RETRIES = 2


@register_example("agentic_rag")
class AgenticRAG(BaseExample):
    def __init__(self, context: ChainContext = None) -> None:
        self.ctx = context or get_context()
        self.bm25 = BM25Index()
        self._bm25_docs: List[Document] = []

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
        self.ctx.store(COLLECTION).add(docs, embeddings)
        self.bm25.add([d.content for d in docs])
        self._bm25_docs.extend(docs)

    # ------------------------------------------------------------ retrieval

    def _hybrid_retrieve(self, query: str, top_k: int) -> List[Document]:
        return self._hybrid_with_vec(query, top_k)[1]

    def _hybrid_with_vec(self, query: str, top_k: int, qvec=None):
        """BM25 + dense, fused by reciprocal rank (the EnsembleRetriever
        equivalent). Returns (qvec, docs) — the vector feeds the lookahead
        reconcile (chains/lookahead.py), which passes it back on a requery
        so the query is never embedded twice."""
        if qvec is None:
            qvec = self.ctx.embedder.embed_queries([query])[0]
        dense_hits = self.ctx.store(COLLECTION).search(
            qvec, top_k=top_k * 2, score_threshold=0.0)
        sparse_hits = self.bm25.search(query, top_k=top_k * 2)

        # fuse over content identity
        pool: List[Document] = []
        key_to_idx: Dict[str, int] = {}

        def pool_idx(doc: Document) -> int:
            key = doc.content
            if key not in key_to_idx:
                key_to_idx[key] = len(pool)
                pool.append(doc)
            return key_to_idx[key]

        dense_rank = [pool_idx(d) for d, _ in dense_hits]
        sparse_rank = [pool_idx(self._bm25_docs[i]) for i, _ in sparse_hits]
        fused = reciprocal_rank_fusion([dense_rank, sparse_rank], top_k=top_k)
        return qvec, [pool[i] for i in fused]

    def _rewrite_with_lookahead(self, question: str, top_k: int,
                                held, reuse_similar: bool, **settings: Any):
        """Run the question-rewrite LLM call with the CURRENT question's
        in-hand retrieval seeded as the speculation (TeleRAG reconcile,
        chains/lookahead.py). ``held`` is this iteration's already-computed
        ``(qvec, ungraded_docs)`` — seeding it costs ZERO new encoder/store
        work; retrieval runs again only when the rewrite diverges. Returns
        (rewritten_question, (qvec, docs) valid for it).

        ``reuse_similar=False`` forces the re-retrieve whenever the rewrite
        changed the text at all — used on the docs-rejected path, where the
        held docs were just graded irrelevant and a merely-similar rewrite
        must hit BM25/dense afresh. An identical rewrite still reuses them
        (same query → same docs, by construction)."""
        look = LookaheadRetrieval(
            lambda q, v=None: self._hybrid_with_vec(q, top_k, v),
            sim_threshold=(DEFAULT_SIM_THRESHOLD if reuse_similar else 2.0))
        look.seed(question, held)
        with stage_span("rewrite"):
            rewritten = self._rewrite_question(question, **settings)
        with stage_span("retrieve"):
            qvec, docs = look.reconcile(
                rewritten,
                embed=(lambda q: self.ctx.embedder.embed_queries([q])[0])
                if reuse_similar else None)
        return rewritten, (qvec, docs)

    # -------------------------------------------------------------- graders

    def _grade(self, prompt: str, **settings: Any) -> bool:
        s = _sampling(settings)
        s.update(max_tokens=32, temperature=0.0)
        raw = "".join(self.ctx.llm.chat(
            [{"role": "user", "content": prompt}], **s))
        parsed = extract_json(raw)
        if parsed and "score" in parsed:
            return str(parsed["score"]).strip().lower().startswith("y")
        return "yes" in raw.lower()

    def _grade_documents(self, question: str, docs: List[Document],
                         **settings: Any) -> List[Document]:
        kept = []
        for doc in docs:
            prompt = self.ctx.prompts["retrieval_grader_prompt"].format(
                document=doc.content, question=question)
            if self._grade(prompt, **settings):
                kept.append(doc)
        logger.info("retrieval grader kept %d/%d docs", len(kept), len(docs))
        return kept

    def _rewrite_question(self, question: str, **settings: Any) -> str:
        s = _sampling(settings)
        s.update(max_tokens=96, temperature=0.0)
        out = "".join(self.ctx.llm.chat(
            [{"role": "user",
              "content": self.ctx.prompts["question_rewriter_prompt"].format(
                  question=question)}], **s)).strip()
        return out or question

    def _generate(self, question: str, context_text: str,
                  **settings: Any) -> str:
        system = self.ctx.prompts["rag_template"].format(context=context_text)
        return "".join(self.ctx.llm.chat(
            [{"role": "system", "content": system},
             {"role": "user", "content": question}], **_sampling(settings)))

    # ----------------------------------------------------------- generation

    @chain_instrumentation
    def llm_chain(self, query: str, chat_history: Sequence[Dict[str, str]],
                  **llm_settings: Any) -> Iterator[str]:
        messages = ([{"role": "system",
                      "content": self.ctx.prompts["chat_template"]}]
                    + list(chat_history) + [{"role": "user", "content": query}])
        yield from self.ctx.llm.chat(messages, **_sampling(llm_settings))

    @chain_instrumentation
    def rag_chain(self, query: str, chat_history: Sequence[Dict[str, str]],
                  **llm_settings: Any) -> Iterator[str]:
        rcfg = self.ctx.config.retriever
        question = query
        generation = ""
        held = None    # (qvec, ungraded docs) for the CURRENT question
        for attempt in range(MAX_RETRIES + 1):
            if held is None:
                with stage_span("retrieve"):
                    held = self._hybrid_with_vec(question, rcfg.top_k)
            raw_docs = held[1]
            docs = self._grade_documents(question, raw_docs, **llm_settings)
            if not docs:
                if attempt >= MAX_RETRIES:
                    yield NO_CONTEXT_MSG
                    return
                # docs were graded irrelevant: only an IDENTICAL rewrite may
                # reuse this iteration's retrieval (reuse_similar=False)
                question, held = self._rewrite_with_lookahead(
                    question, rcfg.top_k, held, reuse_similar=False,
                    **llm_settings)
                logger.info("no relevant docs; rewrote question to %r",
                            question)
                continue
            context_text = trim_context(
                [d.content for d in docs], self.ctx.embedder.tokenizer,
                rcfg.max_context_tokens)
            guardrails.record_context(context_text)
            generation = self._generate(question, context_text,
                                        **llm_settings)
            grounded = self._grade(
                self.ctx.prompts["hallucination_grader_prompt"].format(
                    documents=context_text, generation=generation),
                **llm_settings)
            useful = grounded and self._grade(
                self.ctx.prompts["answer_grader_prompt"].format(
                    generation=generation, question=question),
                **llm_settings)
            if useful or attempt >= MAX_RETRIES:
                break
            if grounded:  # answered but not useful → rewrite the question;
                # these docs PASSED grading, so a similar rewrite may reuse
                # the held retrieval (reuse_similar=True)
                question, held = self._rewrite_with_lookahead(
                    question, rcfg.top_k, held, reuse_similar=True,
                    **llm_settings)
            # not grounded: regenerate the SAME question — `held` already
            # carries its retrieval, so the next iteration re-grades without
            # recomputing it (the store is deterministic)
            logger.info("generation rejected (grounded=%s); retrying",
                        grounded)
        yield generation or NO_CONTEXT_MSG

    # ------------------------------------------------------------ documents

    def document_search(self, query: str, num_docs: int = 4) -> List[Dict[str, Any]]:
        docs = self._hybrid_retrieve(query, num_docs)
        return [{"source": str(d.metadata.get("source", "")),
                 "content": d.content, "score": 0.0} for d in docs]

    def get_documents(self) -> List[str]:
        return self.ctx.store(COLLECTION).list_sources()

    def delete_documents(self, filenames: Sequence[str]) -> bool:
        removed = self.ctx.store(COLLECTION).delete_by_source(filenames) > 0
        names = set(filenames)
        keep = [d for d in self._bm25_docs
                if d.metadata.get("source") not in names]
        if len(keep) != len(self._bm25_docs):
            self.bm25 = BM25Index()
            self.bm25.add([d.content for d in keep])
            self._bm25_docs = keep
        return removed
