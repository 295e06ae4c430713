"""Token-aware text splitter.

Parity with the reference's splitter contract: chunks of `chunk_size` tokens
with `chunk_overlap` overlap, counted by a real tokenizer
(ref: SentenceTransformersTokenTextSplitter factory utils.py:474-489;
defaults 510/200, configuration.py:86-91). Splitting prefers paragraph, then
sentence, then whitespace boundaries before falling back to hard token cuts.

A copy of ``generativeaiexamples_tpu/retrieval/text_splitter.py`` over the
port's tokenizers (``engine/tokenizer.get_tokenizer``).
"""

from __future__ import annotations

import re
from typing import List, Optional

from generativeaiexamples_tpu_torch.engine.tokenizer import Tokenizer, get_tokenizer

_PARAGRAPH = re.compile(r"\n\s*\n")
_SENTENCE = re.compile(r"(?<=[.!?])\s+")


class TokenTextSplitter:
    def __init__(self, chunk_size: int = 510, chunk_overlap: int = 200,
                 tokenizer: Optional[Tokenizer] = None) -> None:
        if chunk_overlap >= chunk_size:
            raise ValueError("chunk_overlap must be < chunk_size")
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self.tokenizer = tokenizer or get_tokenizer("")

    def _count(self, text: str) -> int:
        return len(self.tokenizer.encode(text))

    def split(self, text: str) -> List[str]:
        if not text.strip():
            return []
        if self._count(text) <= self.chunk_size:
            return [text.strip()]

        pieces = self._atomize(text)
        chunks: List[str] = []
        current: List[str] = []
        current_tokens = 0
        for piece, n in pieces:
            if current and current_tokens + n > self.chunk_size:
                chunks.append(" ".join(current).strip())
                # carry back overlap worth of trailing pieces
                keep: List[str] = []
                kept = 0
                for prev in reversed(current):
                    pn = self._count(prev)
                    if kept + pn > self.chunk_overlap:
                        break
                    keep.insert(0, prev)
                    kept += pn
                current = keep
                current_tokens = kept
            current.append(piece)
            current_tokens += n
        if current:
            chunks.append(" ".join(current).strip())
        return [c for c in chunks if c]

    def _atomize(self, text: str):
        """Break into (piece, token_count) units each ≤ chunk_size."""
        out = []
        for para in _PARAGRAPH.split(text):
            if not para.strip():
                continue
            if self._count(para) <= self.chunk_size:
                out.append((para.strip(), self._count(para)))
                continue
            for sent in _SENTENCE.split(para):
                n = self._count(sent)
                if n <= self.chunk_size:
                    if sent.strip():
                        out.append((sent.strip(), n))
                    continue
                # hard cut by tokens
                ids = self.tokenizer.encode(sent)
                for i in range(0, len(ids), self.chunk_size):
                    part = self.tokenizer.decode(ids[i:i + self.chunk_size])
                    if part.strip():
                        out.append((part.strip(), self._count(part)))
        return out
