"""query_decomposition_rag — recursive task-decomposition agent.

Behavioral parity with the reference agent (ref: RAG/examples/advanced_rag/
query_decomposition_rag/chains.py): a tool-selector LLM call emits JSON
{"Tool_Request", "Generated Sub Questions"}; Search retrieves + extracts a
concise answer per sub-question into a ledger (chains.py:307-318), Math
extracts two variables + an operation as JSON and computes the result
(chains.py:320-345); the loop stops on Tool_Request "Nil", empty/repeated
sub-questions, or trace depth > 3 (CustomOutputParser.parse,
chains.py:120-146); the accumulated ledger becomes the final-answer prompt
(run_agent, chains.py:257-274).

Differences by design: the math step evaluates with an explicit operator
table instead of `eval` (the reference eval's LLM output — chains.py:333),
and the agent is a plain loop rather than a LangChain AgentExecutor.

Port of ``generativeaiexamples_tpu/chains/query_decomposition.py``, the
same in behaviour, over the port's context, store and engine; its
``extract_json`` delegates to the port's ``engine/tools.extract_json_value``
and stays bug-compatible with the reference's.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence

from generativeaiexamples_tpu_torch.chains import NO_CONTEXT_MSG
from generativeaiexamples_tpu_torch.chains.basic_rag import _sampling
from generativeaiexamples_tpu_torch.chains.context import ChainContext, get_context
from generativeaiexamples_tpu_torch.chains.loaders import load_document
from generativeaiexamples_tpu_torch.core.tracing import chain_instrumentation
from generativeaiexamples_tpu_torch.engine.tools import extract_json_value
from generativeaiexamples_tpu_torch.retrieval.store import Document
from generativeaiexamples_tpu_torch.server import guardrails
from generativeaiexamples_tpu_torch.server.base import BaseExample
from generativeaiexamples_tpu_torch.server.registry import register_example

logger = logging.getLogger(__name__)

COLLECTION = "query_decomposition"
MAX_TRACE = 3  # ref chains.py:133 — "self.ledger.trace > 3"

_OPS = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "*": lambda a, b: a * b, "/": lambda a, b: a / b,
    "=": lambda a, b: a == b, ">": lambda a, b: a > b,
    "<": lambda a, b: a < b, ">=": lambda a, b: a >= b,
    "<=": lambda a, b: a <= b,
}


def extract_json(text: str) -> Optional[Dict[str, Any]]:
    """First balanced JSON OBJECT in `text` (models wrap JSON in prose).

    Delegates to the serving layer's string-aware scanner
    (engine/tools.py:extract_json_value — one scanner to keep
    bug-compatible, there and here), skipping over non-object values:
    chains expect a dict."""
    def first_dict(value):
        if isinstance(value, dict):
            return value
        if isinstance(value, list):   # models wrap the object in an array
            for v in value:
                d = first_dict(v)
                if d is not None:
                    return d
        return None

    pos = 0
    while pos < len(text):
        found = extract_json_value(text[pos:])
        if found is None:
            return None
        value, (_, end) = found
        d = first_dict(value)
        if d is not None:
            return d
        pos += end
    return None


def _scalar(value: Any) -> float:
    """LLMs return variables as numbers, strings, or 1-element lists."""
    if isinstance(value, (list, tuple)):
        value = value[0]
    if isinstance(value, str):
        m = re.search(r"-?\d+(?:\.\d+)?", value.replace(",", ""))
        if not m:
            raise ValueError(f"no number in {value!r}")
        value = m.group(0)
    return float(value)


@dataclass
class Ledger:
    """State of the recursive decomposition (ref chains.py:72-77)."""
    question_trace: List[str] = field(default_factory=list)
    answer_trace: List[str] = field(default_factory=list)
    trace: int = 0
    done: bool = False

    def context(self) -> str:
        """ref fetch_context, chains.py:81-89."""
        lines = []
        for q, a in zip(self.question_trace, self.answer_trace):
            lines.append(f"Sub-Question: {q}\nSub-Answer: {a}")
        return "\n".join(lines)


@register_example("query_decomposition_rag")
class QueryDecompositionRAG(BaseExample):
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
        self.ctx.store(COLLECTION).add(docs, embeddings)

    # ----------------------------------------------------------- LLM helpers

    def _complete(self, prompt: str, **settings: Any) -> str:
        """Non-streaming completion used by agent-internal calls."""
        s = _sampling(settings)
        s["max_tokens"] = min(s["max_tokens"], 256)
        return "".join(self.ctx.llm.chat(
            [{"role": "user", "content": prompt}], **s))

    # ------------------------------------------------------------ the tools

    def _retrieve(self, query: str) -> List[str]:
        """ref retriever(), chains.py:276-291 — no threshold for this agent."""
        qvec = self.ctx.embedder.embed_queries([query])[0]
        hits = self.ctx.store(COLLECTION).search(
            qvec, top_k=self.ctx.config.retriever.top_k, score_threshold=0.0)
        return [d.content for d, _ in hits]

    def _extract_answer(self, chunks: List[str], question: str,
                        **settings: Any) -> str:
        """ref extract_answer, chains.py:293-305."""
        parts = [self.ctx.prompts["answer_extraction_prompt"],
                 f"\nQuestion: {question}\n"]
        for idx, chunk in enumerate(chunks):
            parts.append(f"Passage {idx + 1}:\n{chunk}\n")
        return self._complete("\n".join(parts), **settings).strip()

    def _search(self, ledger: Ledger, sub_questions: List[str],
                **settings: Any) -> None:
        """ref search(), chains.py:307-318."""
        for sub_q in sub_questions:
            chunks = self._retrieve(sub_q)
            ledger.question_trace.append(sub_q)
            ledger.answer_trace.append(
                self._extract_answer(chunks, sub_q, **settings))

    def _math(self, ledger: Ledger, sub_questions: List[str],
              **settings: Any) -> None:
        """ref math(), chains.py:320-345 — JSON variable extraction with an
        LLM fallback; computation via operator table, never eval."""
        question = sub_questions[0]
        answer: str
        try:
            prompt = (self.ctx.prompts["math_tool_prompt"].format(
                context=ledger.context(), question=question))
            parsed = extract_json(self._complete(prompt, **settings))
            a = _scalar(parsed["variable1"])
            b = _scalar(parsed["variable2"])
            op = parsed["operation"]
            if isinstance(op, (list, tuple)):
                op = op[0]
            answer = f"{a}{op}{b}={_OPS[op](a, b)}"
        except Exception as exc:  # fall back to a concise LLM answer
            logger.info("math JSON path failed (%s); falling back", exc)
            prompt = (f"Solve this mathematical question:\n"
                      f"Question: {question}\n"
                      f"Context:\n{ledger.context()}\n"
                      f"Be concise and only return the answer.")
            answer = self._complete(prompt, **settings).strip()
        ledger.question_trace.append(question)
        ledger.answer_trace.append(answer)
        ledger.done = True

    # ---------------------------------------------------------- agent loop

    def _run_agent(self, question: str, **settings: Any) -> str:
        """Recursive decomposition; returns the final-answer prompt built
        from the ledger (ref run_agent, chains.py:257-274)."""
        ledger = Ledger()
        while not ledger.done:
            prompt = self.ctx.prompts["tool_selector_prompt"].format(
                context=ledger.context(), question=question)
            raw = self._complete(prompt, **settings)
            logger.info("tool selector: %s", raw.strip()[:400])
            state = extract_json(raw)
            if state is None:
                logger.warning("tool selector returned no JSON; finishing")
                break
            raw_subs = state.get("Generated Sub Questions", [])
            if isinstance(raw_subs, str):  # schema deviation: bare string
                raw_subs = [raw_subs]
            elif not isinstance(raw_subs, (list, tuple)):
                raw_subs = [str(raw_subs)]
            sub_qs = [str(q) for q in raw_subs if str(q).strip()]
            tool = str(state.get("Tool_Request", "Nil")).strip()
            # stop conditions (ref CustomOutputParser.parse, chains.py:127-137)
            if (not sub_qs or sub_qs[0] == "Nil" or tool == "Nil"
                    or ledger.trace > MAX_TRACE
                    or sub_qs[0] in ledger.question_trace):
                break
            if tool == "Search":
                ledger.trace += 1
                self._search(ledger, sub_qs, **settings)
            elif tool == "Math":
                self._math(ledger, sub_qs, **settings)
            else:
                logger.warning("invalid tool %r; finishing", tool)
                break

        parts = [f"Question: {question}\n", "Sub Questions and Answers"]
        qa_lines = []
        for q, a in zip(ledger.question_trace, ledger.answer_trace):
            qa_lines.append(f"Sub Question: {q}")
            qa_lines.append(f"Sub Answer: {a}")
        parts.extend(qa_lines)
        parts.append("\nFinal Answer: ")
        # the final answer is generated from this sub-Q/A evidence — the
        # fact-check rail must judge against it, not a fresh retrieval
        guardrails.record_context("\n".join(qa_lines))
        return "\n".join(parts)

    # ----------------------------------------------------------- generation

    @chain_instrumentation
    def llm_chain(self, query: str, chat_history: Sequence[Dict[str, str]],
                  **llm_settings: Any) -> Iterator[str]:
        messages = [{"role": "system",
                     "content": self.ctx.prompts["chat_template"]},
                    {"role": "user", "content": f"\n\nQuestion: {query}\n"}]
        yield from self.ctx.llm.chat(messages, **_sampling(llm_settings))

    @chain_instrumentation
    def rag_chain(self, query: str, chat_history: Sequence[Dict[str, str]],
                  **llm_settings: Any) -> Iterator[str]:
        try:
            final_prompt = self._run_agent(query, **llm_settings)
        except ValueError as exc:
            logger.warning("agent failed: %s", exc)
            yield "I can't find an answer for that."
            return
        if "Sub Question:" not in final_prompt:
            yield NO_CONTEXT_MSG
            return
        yield from self.ctx.llm.chat(
            [{"role": "user", "content": final_prompt}],
            **_sampling(llm_settings))

    # ------------------------------------------------------------ documents

    def document_search(self, query: str, num_docs: int = 4) -> List[Dict[str, Any]]:
        qvec = self.ctx.embedder.embed_queries([query])[0]
        hits = self.ctx.store(COLLECTION).search(
            qvec, top_k=num_docs, score_threshold=0.0)
        return [{"source": str(d.metadata.get("source", "")),
                 "content": d.content, "score": score}
                for d, score in hits]

    def get_documents(self) -> List[str]:
        return self.ctx.store(COLLECTION).list_sources()

    def delete_documents(self, filenames: Sequence[str]) -> bool:
        return self.ctx.store(COLLECTION).delete_by_source(filenames) > 0
