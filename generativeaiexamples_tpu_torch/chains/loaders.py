"""Document loaders for ingestion.

The reference leans on UnstructuredFileLoader (ref: basic_rag/langchain/
chains.py:70); in-tree we parse the common formats directly: txt/md, html
(bs4), csv, json, and PDF via a minimal native parser (uncompressed and
Flate-compressed text streams — covers text-first PDFs; scanned/image PDFs
go through the multimodal chain instead).

A copy of ``generativeaiexamples_tpu/chains/loaders.py``. Its PDF path is
the standard library's; ``load_html`` imports ``bs4`` when called, so
HTML ingestion fails where ``bs4`` is missing (the card's machine), as it
does there.
"""

from __future__ import annotations

import json
import logging
import os
import re
import zlib
from typing import List

logger = logging.getLogger(__name__)


def load_text(path: str) -> str:
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        return fh.read()


def load_html(path: str) -> str:
    from bs4 import BeautifulSoup

    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        soup = BeautifulSoup(fh.read(), "lxml")
    for tag in soup(["script", "style"]):
        tag.decompose()
    return re.sub(r"\n{3,}", "\n\n", soup.get_text("\n")).strip()


def load_csv(path: str) -> str:
    return load_text(path)


def load_json(path: str) -> str:
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        data = json.load(fh)
    return json.dumps(data, indent=1)


# --------------------------------------------------------------------- PDF

_PDF_STREAM = re.compile(rb"stream\r?\n(.*?)\r?\nendstream", re.S)
_PDF_TEXT_OPS = re.compile(
    rb"\((?:[^()\\]|\\.)*\)\s*Tj"      # (text) Tj
    rb"|\[(?:[^\[\]\\]|\\.)*\]\s*TJ"   # [(a)(b)] TJ
    rb"|T\*|Td|TD",
    re.S)
_PDF_STRING = re.compile(rb"\((?:[^()\\]|\\.)*\)")


def _decode_pdf_string(raw: bytes) -> str:
    body = raw[1:-1]
    body = re.sub(rb"\\([nrtbf()\\])",
                  lambda m: {b"n": b"\n", b"r": b"\r", b"t": b"\t", b"b": b"\b",
                             b"f": b"\f", b"(": b"(", b")": b")",
                             b"\\": b"\\"}[m.group(1)], body)
    body = re.sub(rb"\\(\d{1,3})", lambda m: bytes([int(m.group(1), 8) & 0xFF]), body)
    return body.decode("latin-1", errors="replace")


def load_pdf(path: str) -> str:
    """Best-effort text extraction from Tj/TJ operators in content streams."""
    with open(path, "rb") as fh:
        data = fh.read()
    pieces: List[str] = []
    for m in _PDF_STREAM.finditer(data):
        stream = m.group(1)
        if stream[:2] == b"\x78\x9c" or b"FlateDecode" in data[max(0, m.start() - 400):m.start()]:
            try:
                stream = zlib.decompress(stream)
            except zlib.error:
                continue
        if b"Tj" not in stream and b"TJ" not in stream:
            continue
        line: List[str] = []
        for op in _PDF_TEXT_OPS.finditer(stream):
            tok = op.group(0)
            if tok in (b"T*",) or tok.endswith(b"Td") or tok.endswith(b"TD"):
                if line:
                    pieces.append("".join(line))
                    line = []
                continue
            for s in _PDF_STRING.finditer(tok):
                line.append(_decode_pdf_string(s.group(0)))
        if line:
            pieces.append("".join(line))
    text = "\n".join(p for p in pieces if p.strip())
    if not text.strip():
        logger.warning("PDF %s produced no extractable text "
                       "(image-only or unsupported encoding)", path)
    return text


_LOADERS = {
    ".txt": load_text, ".md": load_text, ".rst": load_text, ".py": load_text,
    ".log": load_text, ".html": load_html, ".htm": load_html,
    ".csv": load_csv, ".json": load_json, ".pdf": load_pdf,
}


def load_document(path: str) -> str:
    """Dispatch by extension; unknown types fall back to text."""
    ext = os.path.splitext(path)[1].lower()
    loader = _LOADERS.get(ext, load_text)
    return loader(path)
