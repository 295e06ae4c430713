"""Prompt templates with the user-override merge.

Port of ``generativeaiexamples_tpu/core/prompts.py``: ``DEFAULT_PROMPTS``
verbatim, and ``get_prompts``, which merges the file named by
``APP_PROMPTS_FILE`` (or ``override_path``) over them (``_combine``:
nested mappings merge, everything else replaces).

The reference reads that file with ``yaml.safe_load``; the card's machine
has no ``yaml``, so ``read_prompt_file`` reads the shapes a prompt file
holds: a mapping (nested mappings too) whose keys are plain words and
whose values are strings written plain, single-quoted, double-quoted (on
one line, with the usual escapes), or as ``|`` / ``>`` block scalars
(clip, ``-`` strip or ``+`` keep chomping), with ``#`` comments and a
leading ``---``. Anything else (lists, flow collections, anchors, tags,
multi-line plain or quoted scalars, plain scalars that YAML would read
as a number, a boolean or null, duplicate keys, tabs, a more-indented
line inside a folded scalar) raises ``PromptFileError`` naming the
limit, so a file is never read differently from the reference.
"""

from __future__ import annotations

import os
import re
from functools import lru_cache
from typing import Any, Dict, List, Optional, Tuple

DEFAULT_PROMPTS: Dict[str, str] = {
    # ref basic_rag prompt.yaml semantics: a chat template and a rag template
    "chat_template": (
        "You are a helpful, respectful and honest assistant. Always answer as "
        "helpfully as possible. If you don't know the answer to a question, "
        "say so rather than guessing."),
    "rag_template": (
        "You are a helpful AI assistant. Use the following pieces of retrieved "
        "context to answer the question. If the context does not contain the "
        "answer, say you don't know. Keep the answer concise.\n\n"
        "Context:\n{context}\n"),
    "multi_turn_rag_template": (
        "You are a document chatbot. Answer the user's question using only the "
        "retrieved context and the conversation so far. If unsure, say so. "
        "Make your response conversational.\n\n"
        "Conversation history retrieved:\n{history}\n\n"
        "Document context retrieved:\n{context}\n"),
    "query_rewriter_prompt": (
        "Given the conversation history and a follow-up question, rewrite the "
        "follow-up into a standalone question. Return only the question."),
    # query-decomposition agent (ref: query_decomposition_rag/prompt.yaml
    # tool_selector_prompt / math_tool_prompt — JSON tool-request protocol)
    "tool_selector_prompt": (
        "Your task is to answer questions. If you cannot answer the question "
        "directly, request a tool and break the question into specific "
        "sub-questions. Fill with Nil where no action is required. Return ONLY "
        "a JSON object with the tool and the generated sub-questions — no "
        "other text. You are given two tools:\n"
        "- Search: finds and retrieves relevant answers from the ingested "
        "documents.\n"
        "- Math: performs arithmetic (addition, subtraction, multiplication, "
        "division, comparisons).\n"
        "Do not pass sub-questions to a tool if the contextual information "
        "already answers them. If you have all the information needed, set "
        "Tool_Request to Nil.\n\n"
        "Contextual Information:\n{context}\n\n"
        "Question:\n{question}\n\n"
        '{{"Tool_Request": "<Fill>", "Generated Sub Questions": [<Fill>]}}'),
    "math_tool_prompt": (
        "Identify two numeric variables and one operation from the question. "
        "Return ONLY a JSON object with keys IsPossible (\"Possible\" or "
        "\"Not Possible\"), variable1, variable2, and operation (one of "
        "+ - * / = > < >= <=) — no other text.\n\n"
        "Contextual Information:\n{context}\n\n"
        "Question:\n{question}\n\n"
        '{{"IsPossible": "<Fill>", "variable1": <Fill>, "variable2": <Fill>, '
        '"operation": "<Fill>"}}'),
    "answer_extraction_prompt": (
        "Below is a question and a set of passages that may or may not be "
        "relevant. Extract the answer to the question using only the "
        "information in the passages. Be as concise as possible and only "
        "include the answer if present. Do not infer beyond the passages."),
    # structured-data CSV chain (ref: structured_data_rag/prompt.yaml
    # csv_data_retrieval_template / csv_response_template)
    "csv_data_retrieval_template": (
        "You are an expert data analyst who writes pandas code.\n"
        "Write python code that computes the answer to the user's query from "
        "the DataFrame `df` (already loaded; do NOT read any files). Assign "
        "the final answer to a variable named `result`. Use only `df`, `pd`, "
        "and builtins. Return ONLY the code, no explanations or markdown.\n\n"
        "The data contains: {description}\n"
        "Instructions:\n{instructions}\n\n"
        "DataFrame columns and sample rows:\n{data_frame}\n"),
    "csv_response_template": (
        "Provide a response to the user's query based on the given data "
        "point. Do not add anything beyond the information provided in the "
        "data.\n\nUser's query:\n{query}\n\n"
        "Data point computed from the table:\n{data}\n\nResponse:"),
    "multimodal_rag_template": (
        "Answer using the retrieved text passages, table contents, and image "
        "descriptions.\n\nContext:\n{context}\n"),
    # agentic self-corrective RAG (ref: RAG/notebooks/langchain/
    # agentic_rag_with_nemo_retriever_nim.ipynb — grader/rewriter prompts)
    "retrieval_grader_prompt": (
        "You are a grader assessing the relevance of a retrieved document to "
        "a user question. If the document contains keywords or semantic "
        "meaning related to the question, grade it relevant. Return ONLY a "
        "JSON object {{\"score\": \"yes\"}} or {{\"score\": \"no\"}}.\n\n"
        "Document:\n{document}\n\nQuestion: {question}"),
    "hallucination_grader_prompt": (
        "You are a grader assessing whether an answer is grounded in the "
        "provided facts. Return ONLY a JSON object {{\"score\": \"yes\"}} if "
        "the answer is supported by the facts, else {{\"score\": \"no\"}}.\n\n"
        "Facts:\n{documents}\n\nAnswer: {generation}"),
    "answer_grader_prompt": (
        "You are a grader assessing whether an answer resolves the question. "
        "Return ONLY a JSON object {{\"score\": \"yes\"}} or "
        "{{\"score\": \"no\"}}.\n\nAnswer:\n{generation}\n\n"
        "Question: {question}"),
    "question_rewriter_prompt": (
        "You are a question re-writer that converts an input question into a "
        "better version optimized for vector-store retrieval. Reason about "
        "the underlying semantic intent. Return only the rewritten "
        "question.\n\nQuestion: {question}"),
}


class PromptFileError(ValueError):
    """A prompt file outside the subset ``read_prompt_file`` reads."""


_KEY = re.compile(r"([A-Za-z0-9_][A-Za-z0-9_.\-]*):(?:[ ]+(.*))?$")
# plain scalars YAML 1.1 (PyYAML's safe loader) resolves to another type
_TYPED = re.compile(
    r"""^(?:~|null|Null|NULL|yes|Yes|YES|no|No|NO|true|True|TRUE|false|False
    |FALSE|on|On|ON|off|Off|OFF|y|Y|n|N
    |[-+]?(?:0b[0-1_]+|0[0-7_]+|(?:0|[1-9][0-9_]*)|0x[0-9a-fA-F_]+
    |[1-9][0-9_]*(?::[0-5]?[0-9])+)
    |[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)
    |[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|=|<<)$""", re.X)
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX = {"x": 2, "u": 4, "U": 8}


def _only_comment_after(text: str, where: str) -> None:
    rest = text.strip()
    if rest and not rest.startswith("#"):
        raise PromptFileError(f"{where}: text after a quoted scalar")


def _double_quoted(text: str, where: str) -> str:
    out = []
    i = 1
    while i < len(text):
        c = text[i]
        if c == '"':
            _only_comment_after(text[i + 1:], where)
            return "".join(out)
        if c == "\\":
            e = text[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            if e in _HEX:
                digits = text[i + 2:i + 2 + _HEX[e]]
                if len(digits) != _HEX[e] or not re.fullmatch(
                        "[0-9a-fA-F]+", digits):
                    raise PromptFileError(f"{where}: a bad \\{e} escape")
                out.append(chr(int(digits, 16)))
                i += 2 + _HEX[e]
                continue
            raise PromptFileError(f"{where}: escape \\{e} (or a quoted "
                                  f"scalar over several lines)")
        out.append(c)
        i += 1
    raise PromptFileError(f"{where}: a double-quoted scalar over several "
                          f"lines")


def _single_quoted(text: str, where: str) -> str:
    out = []
    i = 1
    while i < len(text):
        if text[i] == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            _only_comment_after(text[i + 1:], where)
            return "".join(out)
        out.append(text[i])
        i += 1
    raise PromptFileError(f"{where}: a single-quoted scalar over several "
                          f"lines")


def _plain(text: str, where: str) -> str:
    value = re.split(r"\s#", text, 1)[0].rstrip()
    if value[0] in _INDICATORS and not (
            value[0] in "-?:" and len(value) > 1 and value[1] not in " \t"):
        raise PromptFileError(f"{where}: a value starting with "
                              f"{value[0]!r} (flow collection, anchor, tag, "
                              f"alias or sequence)")
    if ": " in value or value.endswith(":"):
        raise PromptFileError(f"{where}: ': ' inside a plain scalar")
    if _TYPED.match(value):
        raise PromptFileError(f"{where}: {value!r} is not read as a string "
                              f"by YAML; quote it")
    return value


def _block(lines: List[Tuple[int, str]], i: int, parent: int, header: str,
           where: str) -> Tuple[str, int]:
    """A ``|`` or ``>`` scalar whose header is ``header``; ``lines[i:]``
    follow it. Returns (value, index of the next line)."""
    m = re.fullmatch(r"([|>])([-+]?)\s*(#.*)?", header)
    if not m:
        raise PromptFileError(f"{where}: block header {header!r} (an "
                              f"indentation indicator)")
    style, chomp = m.group(1), m.group(2)
    body: List[str] = []
    indent = None
    j = i
    while j < len(lines):
        n, raw = lines[j]
        if raw.strip() == "":
            if indent is not None and len(raw) > indent:
                raise PromptFileError(f"line {n}: a line of spaces inside "
                                      f"a block scalar")
            body.append("")
            j += 1
            continue
        lead = len(raw) - len(raw.lstrip(" "))
        if indent is None:
            if lead <= parent:
                break
            indent = lead
        elif lead < indent:
            break
        body.append(raw[indent:])
        j += 1
    content_end = len(body)
    while content_end and body[content_end - 1] == "":
        content_end -= 1
    trailing = len(body) - content_end
    text_lines = body[:content_end]
    if style == "|":
        text = "\n".join(text_lines)
    else:
        parts: List[str] = []
        pending = 0          # empty lines since the last content line
        for line in text_lines:
            if line.startswith(" ") or line != line.rstrip(" "):
                raise PromptFileError(f"{where}: a more-indented line or "
                                      f"trailing spaces inside a folded "
                                      f"scalar")
            if line == "":
                pending += 1
                continue
            if parts:
                parts.append("\n" * pending if pending else " ")
            elif pending:
                parts.append("\n" * pending)
            pending = 0
            parts.append(line)
        text = "".join(parts)
    if not text_lines:
        text = "\n" * trailing if chomp == "+" else ""
        return text, j
    if chomp == "-":
        return text, j
    if chomp == "+":
        return text + "\n" * (1 + trailing), j
    return text + "\n", j


def _mapping(lines: List[Tuple[int, str]], i: int,
             indent: int) -> Tuple[Dict[str, Any], int]:
    out: Dict[str, Any] = {}
    while i < len(lines):
        n, raw = lines[i]
        lead = len(raw) - len(raw.lstrip(" "))
        if lead < indent:
            break
        where = f"line {n}"
        if lead > indent:
            raise PromptFileError(f"{where}: unexpected indentation")
        m = _KEY.match(raw[lead:].rstrip())
        if not m:
            raise PromptFileError(f"{where}: not a 'key: value' line of a "
                                  f"mapping (lists, quoted keys and flow "
                                  f"collections are not read)")
        key, value = m.group(1), (m.group(2) or "").strip()
        if key in out:
            raise PromptFileError(f"{where}: duplicate key {key!r}")
        i += 1
        if not value or value.startswith("#"):
            # a nested mapping follows, more indented
            if i < len(lines):
                child = len(lines[i][1]) - len(lines[i][1].lstrip(" "))
                if child > indent:
                    out[key], i = _mapping(lines, i, child)
                    continue
            raise PromptFileError(f"{where}: {key!r} has no value (YAML "
                                  f"reads null)")
        if value[0] in "|>":
            out[key], i = _block(lines, i, indent, value, where)
        elif value[0] == '"':
            out[key] = _double_quoted(value, where)
        elif value[0] == "'":
            out[key] = _single_quoted(value, where)
        else:
            out[key] = _plain(value, where)
        # a plain scalar continued on the next, more-indented line
        if i < len(lines) and value[0] not in "|>":
            nxt = lines[i][1]
            if len(nxt) - len(nxt.lstrip(" ")) > indent:
                raise PromptFileError(f"line {lines[i][0]}: a scalar over "
                                      f"several lines")
    return out, i


def read_prompt_file(text: str) -> Dict[str, Any]:
    """The mapping ``yaml.safe_load`` reads from a prompt file's ``text``
    (``{}`` for an empty one), or ``PromptFileError``."""
    if "\t" in text:
        raise PromptFileError("tabs are not read")
    lines = list(enumerate(text.splitlines(), 1))
    if lines and lines[0][1].strip() == "---":
        lines = lines[1:]
    return _top(lines)


def _top(lines: List[Tuple[int, str]]) -> Dict[str, Any]:
    """Drop blank and comment lines outside block scalars, then read the
    top-level mapping."""
    filtered: List[Tuple[int, str]] = []
    in_block = None
    for n, raw in lines:
        stripped = raw.strip()
        lead = len(raw) - len(raw.lstrip(" "))
        if in_block is not None:
            if stripped == "" or lead > in_block:
                filtered.append((n, raw))
                continue
            in_block = None
        if stripped == "" or stripped.startswith("#"):
            continue
        if stripped in ("---", "...") and lead == 0:
            raise PromptFileError(f"line {n}: more than one document")
        m = _KEY.match(stripped)
        if m and (m.group(2) or "").strip()[:1] in ("|", ">"):
            in_block = lead
        filtered.append((n, raw))
    if not filtered:
        return {}
    first = filtered[0][1]
    out, i = _mapping(filtered, 0, len(first) - len(first.lstrip(" ")))
    if i != len(filtered):
        raise PromptFileError(f"line {filtered[i][0]}: text after the "
                              f"mapping")
    return out


def _combine(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for key, value in override.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = _combine(out[key], value)
        else:
            out[key] = value
    return out


@lru_cache(maxsize=1)
def get_prompts(override_path: Optional[str] = None) -> Dict[str, Any]:
    prompts: Dict[str, Any] = dict(DEFAULT_PROMPTS)
    path = override_path or os.environ.get("APP_PROMPTS_FILE", "")
    if path and os.path.isfile(path):
        with open(path, "r", encoding="utf-8") as fh:
            user = read_prompt_file(fh.read())
        prompts = _combine(prompts, user)
    return prompts
