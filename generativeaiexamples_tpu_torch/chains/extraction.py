"""Structured text extraction — schema-validated JSON from free text.

Behavioral parity with the reference's structured-text-extraction vision
workflow (ref: vision_workflows/README.md:25-37 — "Structured Text
Extraction": run a VLM/LLM over documents and pull typed fields into a
fixed schema). The extraction loop is model-agnostic here: text arrives
from the document parsers (the reference's chains/multimodal_parsers.py
for images/PDFs; ROADMAP A.16 in the port) or straight from the caller,
the in-proc LLM fills the schema, and a validation-and-retry loop feeds
type errors back to the model instead of returning malformed records (the
workflow's schema box, minus the hosted NIM).

A copy of ``generativeaiexamples_tpu/chains/extraction.py`` over the
port's ``extract_json``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional, Sequence

from generativeaiexamples_tpu_torch.chains.query_decomposition import extract_json

logger = logging.getLogger(__name__)

_TYPES = {
    "string": str,
    "number": (int, float),
    "boolean": bool,
    "list": list,
}


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    type: str = "string"            # string | number | boolean | list
    description: str = ""
    required: bool = True

    def __post_init__(self):
        if self.type not in _TYPES:
            raise ValueError(f"unknown field type {self.type!r}; "
                             f"valid: {sorted(_TYPES)}")


PROMPT = """\
Extract the following fields from the text. Reply with ONLY a JSON object.
Use null for a missing optional field. Fields:
{fields}

Text:
{text}
"""


def _render_fields(fields: Sequence[Field]) -> str:
    lines = []
    for f in fields:
        req = "required" if f.required else "optional"
        desc = f" — {f.description}" if f.description else ""
        lines.append(f'  "{f.name}": {f.type} ({req}){desc}')
    return "\n".join(lines)


def _validate(obj: Dict[str, Any], fields: Sequence[Field]) -> List[str]:
    """Type/presence errors, phrased for the retry prompt."""
    errors = []
    for f in fields:
        value = obj.get(f.name)
        if value is None:
            if f.required:
                errors.append(f'missing required field "{f.name}"')
            continue
        expected = _TYPES[f.type]
        if f.type == "number" and isinstance(value, bool):
            errors.append(f'"{f.name}" must be a number, got boolean')
        elif not isinstance(value, expected):
            errors.append(f'"{f.name}" must be {f.type}, '
                          f"got {type(value).__name__}")
    return errors


class StructuredExtractor:
    """LLM extraction with schema validation + error-feedback retries."""

    def __init__(self, llm, max_retries: int = 2) -> None:
        self.llm = llm
        self.max_retries = max_retries

    def extract(self, text: str, fields: Sequence[Field]
                ) -> Dict[str, Any]:
        """Typed record for ``fields``; raises ValueError after the retry
        budget (never returns a record that fails its own schema)."""
        messages = [{"role": "user", "content": PROMPT.format(
            fields=_render_fields(fields), text=text)}]
        errors: List[str] = []
        for attempt in range(self.max_retries + 1):
            reply = "".join(self.llm.chat(messages, max_tokens=512,
                                          temperature=0.0))
            obj = extract_json(reply)
            if obj is None:
                # reset per attempt — stale type errors from an earlier
                # reply must not masquerade as this one's problem
                errors = ["no JSON object in reply"]
            else:
                errors = _validate(obj, fields)
                if not errors:
                    return {f.name: obj.get(f.name) for f in fields}
            if attempt < self.max_retries:
                logger.info("extraction attempt %d invalid: %s",
                            attempt + 1, errors)
                messages = messages + [
                    {"role": "assistant", "content": reply},
                    {"role": "user",
                     "content": "That reply was invalid: "
                                + "; ".join(errors)
                                + ". Reply again with ONLY a corrected "
                                  "JSON object."}]
        raise ValueError(f"extraction failed after {self.max_retries + 1} "
                         f"attempts: {'; '.join(errors)}")

    def extract_many(self, texts: Sequence[str], fields: Sequence[Field]
                     ) -> List[Optional[Dict[str, Any]]]:
        """Batch helper: None for records that exhausted their retries
        (a failed page must not abort a document batch)."""
        out: List[Optional[Dict[str, Any]]] = []
        for text in texts:
            try:
                out.append(self.extract(text, fields))
            except ValueError as exc:
                logger.warning("extraction skipped a record: %s", exc)
                out.append(None)
        return out
