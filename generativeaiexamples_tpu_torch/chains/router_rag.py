"""router_rag — query routing across local KB, web seam, and direct LLM.

Behavioral parity with the reference's routing workflow
(ref: community/routing-multisource-rag/workflow.py — QueryFlow: a routing
step picks sources (`RoutingChoice`, line 59), `rewrite_query` (160)
reformulates for retrieval, then Milvus retrieval and a Perplexity web call
run as parallel branches (`milvus_retrieve`:202, PerplexityQueryEvent),
nodes are collected and synthesized with source attributions). The
LlamaIndex event workflow is replaced by a plain staged pipeline; Milvus by
the in-proc store; Perplexity by a pluggable `WebSearchClient` seam
(zero-egress default returns nothing gracefully, matching the app's
behavior with no PERPLEXITY_API_KEY).

Routing decisions are LLM-emitted JSON parsed defensively; unparseable
output degrades to the KB route (never a dead end).

Port of ``generativeaiexamples_tpu/chains/router_rag.py``, the same in
behaviour but for ``delete_documents``, which answers whether anything was
removed where the reference's returns None (ROADMAP C9).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterator, List, Optional, Sequence

from generativeaiexamples_tpu_torch.chains.basic_rag import _sampling, trim_context
from generativeaiexamples_tpu_torch.chains.context import ChainContext, get_context
from generativeaiexamples_tpu_torch.chains.loaders import load_document
from generativeaiexamples_tpu_torch.chains.query_decomposition import extract_json
from generativeaiexamples_tpu_torch.core.tracing import chain_instrumentation
from generativeaiexamples_tpu_torch.retrieval.store import Document
from generativeaiexamples_tpu_torch.server import guardrails
from generativeaiexamples_tpu_torch.server.base import BaseExample
from generativeaiexamples_tpu_torch.server.registry import register_example

logger = logging.getLogger(__name__)

COLLECTION = "router_rag"

ROUTE_PROMPT = """\
You route user questions to data sources. Sources:
  "kb"     - the local document knowledge base (ingested files)
  "web"    - live web search (recent events, external facts)
  "direct" - no retrieval needed (small talk, general knowledge, math)
Reply with ONLY a JSON object:
{{"sources": ["kb"|"web"|"direct", ...], "rewritten": "<standalone search query>"}}

Question: {query}
"""

SYNTH_PROMPT = """\
Answer the user's question from the sources below. Attribute facts to their
source tag ([kb] or [web]) when they matter. If the sources do not contain
the answer, say so.

{context}
"""


class WebSearchClient:
    """Seam for the reference's Perplexity branch (workflow.py web route).
    The default implementation returns no results — the zero-egress
    analogue of running the app without PERPLEXITY_API_KEY. Deployments
    point `search` at any HTTP search/answer API."""

    def search(self, query: str, max_results: int = 3) -> List[Dict[str, str]]:
        logger.info("web search seam inactive; skipping web route")
        return []


def parse_route(text: str) -> Dict[str, Any]:
    """Defensive parse of the routing JSON; degrade to the KB route."""
    obj = extract_json(text)
    if isinstance(obj, dict):
        try:
            sources = [s for s in obj.get("sources", [])
                       if s in ("kb", "web", "direct")]
        except TypeError:
            sources = []
        if sources:
            return {"sources": sources,
                    "rewritten": str(obj.get("rewritten", "")).strip()}
    return {"sources": ["kb"], "rewritten": ""}


@register_example("router_rag")
class RouterRAG(BaseExample):
    def __init__(self, context: ChainContext = None,
                 web_client: Optional[WebSearchClient] = None) -> None:
        self.ctx = context or get_context()
        self.web = web_client or WebSearchClient()

    # ------------------------------------------------------------ ingestion

    @chain_instrumentation
    def ingest_docs(self, filepath: str, filename: str) -> None:
        text = load_document(filepath)
        if not text.strip():
            raise ValueError(f"no text extracted from {filename}")
        chunks = self.ctx.splitter().split(text)
        docs = [Document(content=c, metadata={"source": filename})
                for c in chunks]
        self.ctx.store(COLLECTION).add(
            docs, self.ctx.embedder.embed_documents([d.content for d in docs]))

    # -------------------------------------------------------------- routing

    def route(self, query: str) -> Dict[str, Any]:
        reply = "".join(self.ctx.llm.chat(
            [{"role": "user", "content": ROUTE_PROMPT.format(query=query)}],
            max_tokens=128, temperature=0.0))
        decision = parse_route(reply)
        logger.info("routed %r -> %s", query[:60], decision["sources"])
        return decision

    def _gather(self, query: str, decision: Dict[str, Any]) -> List[str]:
        """Run the chosen branches; each contributes source-tagged snippets
        (the workflow's NodeCollectEvent join)."""
        search_q = decision["rewritten"] or query
        parts: List[str] = []
        if "kb" in decision["sources"]:
            hits = self.ctx.store(COLLECTION).search(
                self.ctx.embedder.embed_queries([search_q])[0],
                top_k=self.ctx.config.retriever.top_k,
                score_threshold=self.ctx.config.retriever.score_threshold)
            parts += [f"[kb] {d.content}" for d, _ in hits]
        if "web" in decision["sources"]:
            for r in self.web.search(search_q):
                snippet = r.get("snippet") or r.get("content", "")
                url = r.get("url", "")
                parts.append(f"[web] {snippet} ({url})".strip())
        return parts

    # ----------------------------------------------------------- generation

    @chain_instrumentation
    def llm_chain(self, query: str, chat_history: Sequence[Dict[str, str]],
                  **llm_settings: Any) -> Iterator[str]:
        yield from self.ctx.llm.chat(
            list(chat_history) + [{"role": "user", "content": query}],
            **_sampling(llm_settings))

    @chain_instrumentation
    def rag_chain(self, query: str, chat_history: Sequence[Dict[str, str]],
                  **llm_settings: Any) -> Iterator[str]:
        decision = self.route(query)
        if decision["sources"] == ["direct"]:
            yield from self.llm_chain(query, chat_history, **llm_settings)
            return
        parts = self._gather(query, decision)
        context = trim_context(parts, self.ctx.embedder.tokenizer, 1500)
        guardrails.record_context(context)
        messages = ([{"role": "system",
                      "content": SYNTH_PROMPT.format(
                          context=context or "(no sources returned results)")}]
                    + list(chat_history)
                    + [{"role": "user", "content": query}])
        yield from self.ctx.llm.chat(messages, **_sampling(llm_settings))

    # ------------------------------------------------------------ documents

    def document_search(self, query: str, top_k: int = 4) -> List[Dict[str, Any]]:
        hits = self.ctx.store(COLLECTION).search(
            self.ctx.embedder.embed_queries([query])[0], top_k=top_k)
        return [{"content": d.content, "score": float(score),
                 "source": str(d.metadata.get("source", ""))}
                for d, score in hits]

    def get_documents(self) -> List[str]:
        return self.ctx.store(COLLECTION).list_sources()

    def delete_documents(self, filenames: Sequence[str]) -> bool:
        return self.ctx.store(COLLECTION).delete_by_source(filenames) > 0

