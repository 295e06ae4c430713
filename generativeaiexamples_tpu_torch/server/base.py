"""BaseExample — the plugin contract every RAG pipeline implements.

Parity with the reference ABC (ref: RAG/src/chain_server/base.py:22-68):
required `llm_chain` / `rag_chain` / `ingest_docs`; optional
`document_search` / `get_documents` / `delete_documents` degrade gracefully
when unimplemented (the server returns the same fallbacks the reference's
duck-typing produced).

A copy of ``generativeaiexamples_tpu/server/base.py``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, Iterator, List, Sequence


class BaseExample(ABC):
    """A pluggable chain. Generation methods yield text deltas (the server
    wraps them into SSE chunks, ref server.py:350-376)."""

    @abstractmethod
    def llm_chain(self, query: str, chat_history: Sequence[Dict[str, str]],
                  **llm_settings: Any) -> Iterator[str]:
        """Answer from the model alone (use_knowledge_base=false path,
        ref basic_rag/langchain/chains.py:91-118)."""

    @abstractmethod
    def rag_chain(self, query: str, chat_history: Sequence[Dict[str, str]],
                  **llm_settings: Any) -> Iterator[str]:
        """Retrieve → augment → generate (ref chains.py:121-192)."""

    @abstractmethod
    def ingest_docs(self, filepath: str, filename: str) -> None:
        """Parse + chunk + embed + index an uploaded file (ref chains.py:54-88)."""

    # -------------------------------------------------- optional operations

    def document_search(self, query: str, num_docs: int = 4) -> List[Dict[str, Any]]:
        """Top-k chunks with scores (ref utils/document_search via
        server.py:418-438). Default: not supported."""
        raise NotImplementedError

    def get_documents(self) -> List[str]:
        """Uploaded source filenames (ref server.py:441-464)."""
        raise NotImplementedError

    def delete_documents(self, filenames: Sequence[str]) -> bool:
        """Remove all chunks of the named files (ref server.py:467-491)."""
        raise NotImplementedError
