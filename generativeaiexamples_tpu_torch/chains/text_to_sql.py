"""text_to_sql — Vanna-style retrieval-augmented SQL generation over sqlite.

Behavioral parity with the reference's text-to-SQL retrievers
(ref: industries/asset_lifecycle_management_agent/src/asset_lifecycle_management_agent/
retrievers/vanna_util.py — NIMVanna = ChromaDB vector store + LLM: `train`
ingests DDL statements, documentation chunks (chunk_documentation:322), and
question→SQL example pairs into separate collections; `ask` retrieves the
relevant schema/docs/examples and prompts the LLM for SQL; also
community/Vanna_with_NVIDIA_AI_Endpoints). ChromaDB is replaced by the
in-proc vector store; the embedder/LLM are the in-proc engines.

Safety: generated SQL executes through a **read-only sqlite authorizer** —
only SELECT/read opcodes are approved, so a hallucinated `DROP TABLE`
(or a prompt-injected one riding in a user question) is rejected by the
database layer itself, not by regex (the reference runs whatever comes
back — `vn.ask` → `run_sql` — and relies on DB permissions).

Port of ``generativeaiexamples_tpu/chains/text_to_sql.py``, the same in
behaviour but for ``delete_documents``, which answers whether anything was
removed where the reference's returns None (ROADMAP C9). Training items
carry their collection's name as their source, as the reference's do, so
``get_documents`` lists ``sql_docs`` and that is the name a delete takes.
"""

from __future__ import annotations

import logging
import re
import sqlite3
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from generativeaiexamples_tpu_torch.chains.basic_rag import _sampling
from generativeaiexamples_tpu_torch.chains.context import ChainContext, get_context
from generativeaiexamples_tpu_torch.chains.loaders import load_document
from generativeaiexamples_tpu_torch.core.tracing import chain_instrumentation
from generativeaiexamples_tpu_torch.retrieval.store import Document
from generativeaiexamples_tpu_torch.server.base import BaseExample
from generativeaiexamples_tpu_torch.server.registry import register_example

logger = logging.getLogger(__name__)

DDL_COLLECTION = "sql_ddl"
DOC_COLLECTION = "sql_docs"
PAIR_COLLECTION = "sql_pairs"

SQL_PROMPT = """\
You are an expert SQL analyst for a SQLite database. Write ONE SQL SELECT
statement answering the user's question. Use only tables and columns from
the schema. Output only the SQL, no commentary, no markdown fences.

Schema:
{ddl}

Documentation:
{docs}

Similar questions and their SQL:
{examples}
"""

SUMMARY_PROMPT = """\
Answer the user's question in one or two sentences from these SQL results.

Question: {question}
SQL: {sql}
Columns: {columns}
Rows (first {n}): {rows}
"""

# sqlite authorizer opcodes that a pure read needs
_READ_OK = {sqlite3.SQLITE_SELECT, sqlite3.SQLITE_READ,
            sqlite3.SQLITE_FUNCTION, sqlite3.SQLITE_RECURSIVE}


def _readonly_authorizer(action, *args):
    return (sqlite3.SQLITE_OK if action in _READ_OK else sqlite3.SQLITE_DENY)


def _split_first_statement(sql: str) -> str:
    """Cut at the first ';' OUTSIDE quoted literals (a semicolon inside
    'a;b' must not truncate the statement)."""
    quote = ""
    for i, ch in enumerate(sql):
        if quote:
            if ch == quote:
                quote = ""
        elif ch in ("'", '"'):
            quote = ch
        elif ch == ";":
            return sql[:i]
    return sql


def extract_sql(text: str) -> str:
    """Pull the SQL out of the LLM reply: strip fences/prose, keep the first
    statement (defensive parse — mirrors Vanna's extract_sql semantics)."""
    fence = re.search(r"```(?:sql)?\s*(.+?)```", text, re.DOTALL | re.IGNORECASE)
    if fence:
        text = fence.group(1)
    match = re.search(r"(?is)\b(select|with)\b.*", text)
    if not match:
        return ""
    return _split_first_statement(match.group().strip()).strip()


@register_example("text_to_sql")
class TextToSQL(BaseExample):
    """Retrieval-augmented SQL generation + read-only execution."""

    def __init__(self, context: ChainContext = None,
                 db_path: str = ":memory:") -> None:
        self.ctx = context or get_context()
        self.db_path = db_path
        self._conn: Optional[sqlite3.Connection] = None

    # ------------------------------------------------------------- database

    def connect(self, db_path: str) -> None:
        if self._conn is not None:
            self._conn.close()
        self.db_path = db_path
        self._conn = None

    @property
    def conn(self) -> sqlite3.Connection:
        if self._conn is None:
            self._conn = sqlite3.connect(self.db_path,
                                         check_same_thread=False)
        return self._conn

    def auto_train_schema(self) -> int:
        """Vanna's initVanna bootstrap: read the live schema's DDL out of
        sqlite_master and train on it (ref vanna_util.py:379 trains DDL
        from the training yaml / INFORMATION_SCHEMA)."""
        rows = self.conn.execute(
            "SELECT sql FROM sqlite_master WHERE sql IS NOT NULL").fetchall()
        for (ddl,) in rows:
            self.train(ddl=ddl)
        return len(rows)

    # ------------------------------------------------------------- training

    def train(self, ddl: str = "", documentation: str = "",
              question: str = "", sql: str = "") -> None:
        """Add training items to their collections (ref NIMVanna.train:
        add_ddl / add_documentation / add_question_sql)."""
        if ddl:
            self._add(DDL_COLLECTION, ddl, {"kind": "ddl"})
        if documentation:
            for chunk in self.ctx.splitter().split(documentation):
                self._add(DOC_COLLECTION, chunk, {"kind": "doc"})
        if question and sql:
            self._add(PAIR_COLLECTION, f"Q: {question}\nSQL: {sql}",
                      {"kind": "pair", "question": question})

    def _add(self, collection: str, content: str, meta: Dict[str, str]) -> None:
        doc = Document(content=content, metadata={"source": collection, **meta})
        emb = self.ctx.embedder.embed_documents([content])
        self.ctx.store(collection).add([doc], emb)

    # ------------------------------------------------------------ the chain

    def generate_sql(self, question: str) -> str:
        q_emb = self.ctx.embedder.embed_queries([question])[0]
        ddl = "\n".join(d.content for d, _ in
                        self.ctx.store(DDL_COLLECTION).search(q_emb, top_k=6))
        docs = "\n".join(d.content for d, _ in
                         self.ctx.store(DOC_COLLECTION).search(q_emb, top_k=4))
        examples = "\n\n".join(
            d.content for d, _ in
            self.ctx.store(PAIR_COLLECTION).search(q_emb, top_k=4))
        prompt = SQL_PROMPT.format(ddl=ddl or "(none)", docs=docs or "(none)",
                                   examples=examples or "(none)")
        reply = "".join(self.ctx.llm.chat(
            [{"role": "system", "content": prompt},
             {"role": "user", "content": question}],
            max_tokens=256, temperature=0.0))
        return extract_sql(reply)

    def run_sql(self, sql: str, limit: int = 50
                ) -> Tuple[List[str], List[tuple]]:
        """Execute read-only; returns (columns, rows).

        Each call gets a PRIVATE connection with the authorizer installed
        for its whole life — a shared connection's install/clear dance is
        racy when the chain server streams requests on separate threads
        (one request's teardown would strip another's write protection).
        File databases additionally open with sqlite's mode=ro."""
        if not sql:
            raise ValueError("no SQL statement to run")
        if self.db_path == ":memory:":
            # in-memory DBs are per-connection; reuse the trainer's conn but
            # keep the authorizer installed permanently (reads still pass)
            conn = self.conn
            conn.set_authorizer(_readonly_authorizer)
        else:
            conn = sqlite3.connect(f"file:{self.db_path}?mode=ro", uri=True)
            conn.set_authorizer(_readonly_authorizer)
        try:
            cur = conn.execute(sql)
            rows = cur.fetchmany(limit)
            columns = [d[0] for d in cur.description or []]
        finally:
            if conn is not self._conn:
                conn.close()
        return columns, rows

    def ask(self, question: str) -> Dict[str, Any]:
        """generate → execute → package (ref vn.ask returns sql/df/fig)."""
        sql = self.generate_sql(question)
        columns, rows = self.run_sql(sql)
        return {"sql": sql, "columns": columns, "rows": rows}

    # --------------------------------------------------- BaseExample surface

    @chain_instrumentation
    def llm_chain(self, query: str, chat_history: Sequence[Dict[str, str]],
                  **llm_settings: Any) -> Iterator[str]:
        yield from self.ctx.llm.chat(
            list(chat_history) + [{"role": "user", "content": query}],
            **_sampling(llm_settings))

    @chain_instrumentation
    def rag_chain(self, query: str, chat_history: Sequence[Dict[str, str]],
                  **llm_settings: Any) -> Iterator[str]:
        """Full flow with NL summarization of the result set; SQL or
        execution errors surface as a polite message, not a stack trace."""
        try:
            result = self.ask(query)
        except (ValueError, sqlite3.Error) as exc:
            yield f"I could not answer that with SQL: {exc}"
            return
        summary = SUMMARY_PROMPT.format(
            question=query, sql=result["sql"], columns=result["columns"],
            rows=result["rows"][:10], n=min(10, len(result["rows"])))
        settings = _sampling(llm_settings)
        settings["temperature"] = 0.0     # factual summarization stays greedy
        yield from self.ctx.llm.chat(
            [{"role": "user", "content": summary}], **settings)

    def ingest_docs(self, filepath: str, filename: str) -> None:
        """Uploaded files become documentation training data."""
        self.train(documentation=load_document(filepath))

    def get_documents(self) -> List[str]:
        return self.ctx.store(DOC_COLLECTION).list_sources()

    def delete_documents(self, filenames: Sequence[str]) -> bool:
        return sum(self.ctx.store(coll).delete_by_source(filenames)
                   for coll in (DDL_COLLECTION, DOC_COLLECTION,
                                PAIR_COLLECTION)) > 0
