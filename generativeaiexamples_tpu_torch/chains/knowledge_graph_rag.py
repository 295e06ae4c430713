"""knowledge_graph_rag — triple extraction → NetworkX graph → graph-augmented RAG.

Behavioral parity with the reference's knowledge-graph community app
(ref: community/knowledge_graph_rag/backend/utils/preprocessor.py:52-80 —
LLM triple extraction with a fixed relation-verb set and list-of-tuples
output; utils/lc_graph.py process_documents — split → extract per chunk →
graph; routers/chat.py — GraphQAChain over a NetworkxEntityGraph loaded
from graphml, answering only from graph context). cuGraph acceleration is
replaced by plain NetworkX per SURVEY §2.5 (graph ops are not the
accelerator's job); embedding/generation run on the in-proc engines.

Design differences (documented, deliberate):
  * entity linking for queries is lexical-first (graph nodes found in the
    query string) with an LLM fallback, instead of always burning an LLM
    call (ref chat.py extracts entities with a second chain);
  * ingest also indexes chunks in the dense store, so `rag_chain` can fuse
    graph triples with vector context (the app keeps these separate pages);
  * the graph persists as graphml next to the store, matching the
    reference's KG_GRAPHML_PATH contract.

Port of ``generativeaiexamples_tpu/chains/knowledge_graph_rag.py``, the same
in behaviour but for ``delete_documents``, which answers whether anything
was removed (passages from the store or edges from the graph) where the
reference's returns None, so its chain server answers a real delete with
``{"deleted": false}`` (ROADMAP C11). networkx is imported when the chain
is built, as in the reference, so the module imports without it.
"""

from __future__ import annotations

import ast
import logging
import os
import re
from typing import Any, Dict, Iterator, List, Sequence, Tuple

from generativeaiexamples_tpu_torch.chains.basic_rag import _sampling, trim_context
from generativeaiexamples_tpu_torch.chains.context import ChainContext, get_context
from generativeaiexamples_tpu_torch.chains.loaders import load_document
from generativeaiexamples_tpu_torch.core.tracing import chain_instrumentation
from generativeaiexamples_tpu_torch.retrieval.store import Document
from generativeaiexamples_tpu_torch.server import guardrails
from generativeaiexamples_tpu_torch.server.base import BaseExample
from generativeaiexamples_tpu_torch.server.registry import register_example

logger = logging.getLogger(__name__)

COLLECTION = "knowledge_graph_rag"

# ref preprocessor.py:68 — the fixed relation-verb vocabulary the extractor
# is constrained to (keeps the graph queryable)
RELATIONS = ("Has", "Announce", "Operate_In", "Introduce", "Produce",
             "Control", "Participates_In", "Impact", "Positive_Impact_On",
             "Negative_Impact_On", "Relate_To", "Is_Member_Of", "Invests_In",
             "Raise", "Decrease")

EXTRACT_PROMPT = """\
You are a knowledge-graph builder. Extract entity triples from the text.
The relationship 'r' between entities must be one of: {relations}.
Output ONLY a python list of tuples, each ['h', 'type', 'r', 'o', 'type']
where every element is a string and 'r' is from the set above. Example:
[('Nvidia', 'Company', 'Introduce', 'H100', 'Product')]

Text:
{text}
"""

ANSWER_PROMPT = """\
You are a helpful AI assistant. Reply to questions only based on the context
you are provided. If something is out of context, politely decline to answer.

Knowledge-graph facts:
{triples}

Supporting passages:
{context}
"""


def parse_triples(text: str) -> List[Tuple[str, str, str, str, str]]:
    """Parse the extractor's list-of-tuples output defensively: the LLM may
    wrap it in prose or emit partially malformed entries — salvage every
    well-formed 5-tuple whose relation is in the vocabulary, drop the rest
    (ref preprocessor.py:30-49 does the same filtering loop)."""
    match = re.search(r"\[.*\]", text, re.DOTALL)
    if not match:
        return []
    try:
        items = ast.literal_eval(match.group())
    except (ValueError, SyntaxError):
        return []
    out = []
    if not isinstance(items, (list, tuple)):
        return []
    for item in items:
        if (isinstance(item, (list, tuple)) and len(item) == 5
                and all(isinstance(e, str) for e in item)
                and item[2] in RELATIONS):
            out.append(tuple(e.strip() for e in item))
    return out


@register_example("knowledge_graph_rag")
class KnowledgeGraphRAG(BaseExample):
    """Graph-augmented RAG over an LLM-extracted entity graph."""

    def __init__(self, context: ChainContext = None,
                 graph_path: str = "") -> None:
        import networkx as nx

        self.ctx = context or get_context()
        self._nx = nx
        self.graph_path = graph_path or os.environ.get(
            "KG_GRAPHML_PATH", "")
        # MultiDiGraph: the same (h, o) pair can carry several relations
        # from several documents — a plain DiGraph would overwrite the
        # first fact (and its source attribution) with the second
        if self.graph_path and os.path.exists(self.graph_path):
            self.graph = nx.read_graphml(self.graph_path,
                                         force_multigraph=True)
            logger.info("loaded knowledge graph: %d nodes / %d edges",
                        self.graph.number_of_nodes(),
                        self.graph.number_of_edges())
        else:
            self.graph = nx.MultiDiGraph()

    # ------------------------------------------------------------ ingestion

    @chain_instrumentation
    def ingest_docs(self, filepath: str, filename: str) -> None:
        """Split → extract triples per chunk (LLM) → merge into the graph;
        chunks also land in the dense store for hybrid answers."""
        text = load_document(filepath)
        if not text.strip():
            raise ValueError(f"no text extracted from {filename}")
        chunks = self.ctx.splitter().split(text)
        n_triples = 0
        for chunk in chunks:
            prompt = EXTRACT_PROMPT.format(
                relations=", ".join(RELATIONS), text=chunk)
            reply = "".join(self.ctx.llm.chat(
                [{"role": "user", "content": prompt}],
                max_tokens=512, temperature=0.0))
            for h, h_type, rel, o, o_type in parse_triples(reply):
                self.graph.add_node(h, type=h_type)
                self.graph.add_node(o, type=o_type)
                self.graph.add_edge(h, o, relation=rel, source=filename)
                n_triples += 1
        docs = [Document(content=c, metadata={"source": filename})
                for c in chunks]
        embeddings = self.ctx.embedder.embed_documents([d.content for d in docs])
        self.ctx.store(COLLECTION).add(docs, embeddings)
        if self.graph_path:
            self._nx.write_graphml(self.graph, self.graph_path)
        logger.info("ingested %s: %d chunks, %d triples (graph now %d/%d)",
                    filename, len(chunks), n_triples,
                    self.graph.number_of_nodes(), self.graph.number_of_edges())

    # ------------------------------------------------------------ retrieval

    def _query_entities(self, query: str) -> List[str]:
        """Lexical-first entity linking: graph nodes appearing in the query
        (case-insensitive); LLM fallback when nothing matches."""
        q = query.lower()
        found = [n for n in self.graph.nodes if str(n).lower() in q]
        if found:
            return found
        if self.graph.number_of_nodes() == 0:
            return []
        reply = "".join(self.ctx.llm.chat(
            [{"role": "user", "content":
              "List the named entities in this question as a comma-"
              f"separated line, nothing else: {query}"}],
            max_tokens=64, temperature=0.0))
        cands = [c.strip() for c in reply.split(",") if c.strip()]
        lower = {str(n).lower(): n for n in self.graph.nodes}
        return [lower[c.lower()] for c in cands if c.lower() in lower]

    def graph_context(self, query: str, hops: int = 1,
                      limit: int = 40) -> List[str]:
        """Triples within ``hops`` of the query's entities, rendered as
        'h -[r]-> o' lines (the GraphQAChain neighborhood semantics)."""
        entities = self._query_entities(query)
        if not entities:
            return []
        sub = set(entities)
        frontier = set(entities)
        for _ in range(hops):
            nxt = set()
            for n in frontier:
                nxt |= set(self.graph.successors(n))
                nxt |= set(self.graph.predecessors(n))
            sub |= nxt
            frontier = nxt
        lines = []
        for h, o, data in self.graph.edges(sub, data=True):
            if h in sub and o in sub:
                lines.append(f"{h} -[{data.get('relation', 'Relate_To')}]-> {o}")
                if len(lines) >= limit:
                    break
        return lines

    # ----------------------------------------------------------- generation

    @chain_instrumentation
    def llm_chain(self, query: str, chat_history: Sequence[Dict[str, str]],
                  **llm_settings: Any) -> Iterator[str]:
        messages = (list(chat_history)
                    + [{"role": "user", "content": query}])
        yield from self.ctx.llm.chat(messages, **_sampling(llm_settings))

    @chain_instrumentation
    def rag_chain(self, query: str, chat_history: Sequence[Dict[str, str]],
                  **llm_settings: Any) -> Iterator[str]:
        triples = self.graph_context(query)
        top_k = self.ctx.config.retriever.top_k
        hits = self.ctx.store(COLLECTION).search(
            self.ctx.embedder.embed_queries([query])[0], top_k=top_k,
            score_threshold=self.ctx.config.retriever.score_threshold)
        context = trim_context([d.content for d, _ in hits],
                               self.ctx.embedder.tokenizer, 1500)
        guardrails.record_context(context)
        system = ANSWER_PROMPT.format(
            triples="\n".join(triples) if triples else "(none found)",
            context=context or "(no passages retrieved)")
        messages = ([{"role": "system", "content": system}]
                    + list(chat_history) + [{"role": "user", "content": query}])
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
        removed = self.ctx.store(COLLECTION).delete_by_source(filenames)
        # drop edges extracted from those files; prune now-isolated nodes
        doomed = [(h, o, k) for h, o, k, d in
                  self.graph.edges(keys=True, data=True)
                  if d.get("source") in set(filenames)]
        self.graph.remove_edges_from(doomed)
        self.graph.remove_nodes_from(
            [n for n in list(self.graph.nodes) if self.graph.degree(n) == 0])
        if self.graph_path:
            self._nx.write_graphml(self.graph, self.graph_path)
        return removed > 0 or bool(doomed)

