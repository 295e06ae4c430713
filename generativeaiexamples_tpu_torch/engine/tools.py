"""OpenAI tool calling + JSON mode for the serving layer.

The port's own copy of ``generativeaiexamples_tpu/engine/tools.py``
(standard library only): the same prompt contract, parser and
streamer, so both servers read a generation alike. The text below is
the reference's.

Capability parity with the NIM tool-calling surface the reference's agent
notebooks consume (`tools` / `tool_choice` / `tool_calls` /
`response_format`; ref: RAG/notebooks/langchain/
Agent_use_tools_leveraging_NVIDIA_AI_endpoints.ipynb and
NIM_tool_call_HumanInTheLoop_MultiAgents.ipynb bind tools through the
OpenAI schema and read `message.tool_calls` back).

Mechanism: tools are rendered into the system prompt as JSON schemas with
a strict output contract (the llama-3 style of tool use — the template
teaches the model to answer with a single JSON object when it wants a
tool), and the generated text is parsed back into structured
`tool_calls`. Parsing is deliberately forgiving about the shapes tuned
models actually emit ({"name","arguments"} | {"name","parameters"} |
{"tool_calls":[...]} | a bare list), but strict about unknown tool names
— a hallucinated tool comes back as plain content, never as a bogus call.

JSON mode (`response_format={"type":"json_object"}`) rides the same
prompt+extract path. Since round 4 the prompt contract is additionally
ENFORCED at the token level when the output shape is unambiguous
(json_schema / forced tools): engine/grammar.py compiles the schema to a
byte-level DFA whose logit mask runs INSIDE the fused decode step — no
per-token host round trip, so the multi-step dispatch fusion
(scheduler.py's throughput design point) survives. The prompt+parse
machinery here remains the portable fallback (unsupported schemas,
tool_choice "auto" where prose is legal) and the wire-shape parser either
way.
"""

from __future__ import annotations

import json
import re
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

TOOL_PROMPT = """\
You have access to the following tools. To call a tool, respond with ONLY \
a JSON object of the form {{"tool_calls": [{{"name": "<tool name>", \
"arguments": {{...}}}}]}} and nothing else. Call a tool only when it helps \
answer the request; otherwise reply normally in plain text.

Tools:
{tools}"""

TOOL_REQUIRED = ("\nYou MUST call one of the tools — a plain-text reply is "
                 "not acceptable for this request.")
TOOL_NAMED = ("\nYou MUST call the tool named {name!r} — no other tool and "
              "no plain-text reply.")

JSON_PROMPT = ("Respond with ONLY a single valid JSON object — no prose, "
               "no code fences.")
JSON_SCHEMA_PROMPT = ("Respond with ONLY a single valid JSON object matching "
                      "this JSON schema — no prose, no code fences:\n{schema}")
JSON_WITH_TOOLS_PREFIX = ("When you are NOT calling a tool, your reply must "
                          "follow this rule: ")


def _tool_lines(tools: Sequence[Dict[str, Any]]) -> str:
    lines = []
    for t in tools:
        fn = t.get("function", t)
        lines.append(json.dumps({
            "name": fn.get("name", ""),
            "description": fn.get("description", ""),
            "parameters": fn.get("parameters", {}),
        }))
    return "\n".join(lines)


def tool_names(tools: Sequence[Dict[str, Any]]) -> List[str]:
    return [t.get("function", t).get("name", "") for t in tools]


def forced_name(tool_choice) -> Optional[str]:
    """The tool name a {"type":"function","function":{"name":...}} choice
    pins, else None."""
    if isinstance(tool_choice, dict):
        return tool_choice.get("function", {}).get("name")
    return None


def inject_tool_prompt(messages: Sequence[Dict[str, Any]],
                       tools: Sequence[Dict[str, Any]],
                       tool_choice) -> List[Dict[str, Any]]:
    """Prepend/extend the system message with the tool contract."""
    text = TOOL_PROMPT.format(tools=_tool_lines(tools))
    if tool_choice == "required":
        text += TOOL_REQUIRED
    name = forced_name(tool_choice)
    if name:
        text += TOOL_NAMED.format(name=name)
    return _with_system_suffix(messages, text)


def inject_json_prompt(messages: Sequence[Dict[str, Any]],
                       response_format: Dict[str, Any],
                       with_tools: bool = False) -> List[Dict[str, Any]]:
    """``with_tools`` scopes the constraint to non-tool-call replies so the
    two output contracts (tool_calls JSON vs. content JSON) don't clash."""
    if response_format.get("type") == "json_schema":
        schema = response_format.get("json_schema", {}).get("schema", {})
        text = JSON_SCHEMA_PROMPT.format(schema=json.dumps(schema))
    else:
        text = JSON_PROMPT
    if with_tools:
        text = JSON_WITH_TOOLS_PREFIX + text
    return _with_system_suffix(messages, text)


def _with_system_suffix(messages: Sequence[Dict[str, Any]],
                        suffix: str) -> List[Dict[str, Any]]:
    out = [dict(m) for m in messages]
    for m in out:
        if m.get("role") == "system":
            m["content"] = f"{m.get('content', '')}\n\n{suffix}"
            return out
    return [{"role": "system", "content": suffix}] + out


def normalize_messages(messages: Sequence[Dict[str, Any]]
                       ) -> List[Dict[str, Any]]:
    """Render OpenAI tool-protocol messages into template-friendly text:
    an assistant turn carrying `tool_calls` becomes its JSON contract form
    (so the model sees its own past calls the way it was taught to emit
    them), and `role:"tool"` results keep their role with the tool name
    prefixed."""
    out: List[Dict[str, Any]] = []
    for m in messages:
        role = m.get("role", "user")
        if role == "assistant" and m.get("tool_calls"):
            calls = [{"name": c.get("function", {}).get("name", ""),
                      "arguments": _parse_args(
                          c.get("function", {}).get("arguments"))}
                     for c in m["tool_calls"]]
            out.append({"role": "assistant",
                        "content": json.dumps({"tool_calls": calls})})
        elif role == "tool":
            name = m.get("name", "")
            prefix = f"[{name}] " if name else ""
            out.append({"role": "tool",
                        "content": f"{prefix}{m.get('content', '')}"})
        else:
            out.append({"role": role, "content": m.get("content", "") or ""})
    return out


def _parse_args(arguments) -> Dict[str, Any]:
    if isinstance(arguments, dict):
        return arguments
    if isinstance(arguments, str):
        try:
            parsed = json.loads(arguments)
            return parsed if isinstance(parsed, dict) else {"value": parsed}
        except ValueError:
            return {"raw": arguments}
    return {}


# ---------------------------------------------------------------- parsing

def extract_json_value(text: str) -> Optional[Tuple[Any, Tuple[int, int]]]:
    """First balanced JSON object/array in ``text`` → (value, (start, end)).

    A bracket scanner (string/escape aware) finds candidate spans; only
    spans that json-parse count, so ``{"a": 1} trailing prose`` and fenced
    ```json blocks both work without regex fragility."""
    for start, opener in ((i, c) for i, c in enumerate(text) if c in "{["):
        closer = "}" if opener == "{" else "]"
        depth = 0
        in_str = False
        escape = False
        for j in range(start, len(text)):
            c = text[j]
            if escape:
                escape = False
            elif c == "\\":
                escape = in_str
            elif c == '"':
                in_str = not in_str
            elif not in_str:
                if c in "{[":
                    depth += 1
                elif c in "]}":
                    depth -= 1
                    if depth == 0:
                        if c != closer:
                            break  # mismatched nesting; try the next start
                        try:
                            return (json.loads(text[start:j + 1]),
                                    (start, j + 1))
                        except ValueError:
                            break
        # unbalanced from this start; try the next opener
    return None


def _value_end(text: str, i: int) -> int:
    """Index one past the JSON value starting at ``i`` (after any leading
    whitespace), or -1 while it is still incomplete. String/escape aware."""
    while i < len(text) and text[i].isspace():
        i += 1
    if i >= len(text):
        return -1
    c = text[i]
    if c in "{[":
        depth = 0
        in_str = escape = False
        for j in range(i, len(text)):
            ch = text[j]
            if escape:
                escape = False
            elif ch == "\\":
                escape = in_str
            elif ch == '"':
                in_str = not in_str
            elif not in_str:
                if ch in "{[":
                    depth += 1
                elif ch in "]}":
                    depth -= 1
                    if depth == 0:
                        return j + 1
        return -1
    if c == '"':
        escape = False
        for j in range(i + 1, len(text)):
            if escape:
                escape = False
            elif text[j] == "\\":
                escape = True
            elif text[j] == '"':
                return j + 1
        return -1
    m = re.match(r"[^\s,\]}]+", text[i:])
    if m is None:
        return i        # no value at all (e.g. "arguments":}) — empty span
    end = i + m.end()
    return end if end < len(text) else -1   # a primitive may still grow


_WRAP_RE = re.compile(r'\{\s*"tool_calls"\s*:\s*\[\s*')
_ELEM_RE = re.compile(
    r'\{\s*"name"\s*:\s*"([^"\\]+)"\s*,\s*"(?:arguments|parameters)"\s*:')
_LIST_RE = re.compile(r"\[\s*")


class ToolCallStreamer:
    """Incremental tool-call detection for SSE streaming.

    The buffered path (server._run) holds the WHOLE generation before
    answering a `stream=true` tools request; OpenAI semantics instead
    stream `tool_calls` deltas — name first, then the argument text in
    fragments — so long argument generations are visible as they decode
    (round-3 weakness: seconds of silence). This feeds on text deltas and
    COMMITS to a call as soon as the envelope prefix is unambiguous
    ({"tool_calls": [{"name": <known tool>, "arguments": …); from there
    the raw argument value streams out in fragments (clients concatenate
    and json-parse, the OpenAI wire contract). Unknown tool names or
    non-envelope JSON are released as plain content once balanced —
    matching parse_tool_calls' strictness.

    Events from feed()/finish():
      ("content", text) | ("tool_start", index, name) |
      ("tool_args", index, fragment)
    """

    def __init__(self, tools: Sequence[Dict[str, Any]]) -> None:
        self._known = set(tool_names(tools))
        self._buf = ""
        self._pos = 0            # next unconsumed char
        self._state = "scan"     # scan | held | args | between | done
        self._mode = ""          # wrap | list | bare (valid once committed)
        self._open = 0           # index of the held candidate's opener
        self._args_start = 0
        self._emit_to = 0        # args chars already emitted
        self.calls = 0           # committed tool calls (index = calls - 1)

    @property
    def committed(self) -> bool:
        return self.calls > 0

    def feed(self, delta: str) -> List[tuple]:
        self._buf += delta
        events: List[tuple] = []
        progressed = True
        while progressed:
            progressed = False
            before = (self._state, self._pos, self._emit_to, self.calls)
            handler = getattr(self, "_st_" + self._state)
            handler(events)
            progressed = before != (self._state, self._pos, self._emit_to,
                                    self.calls)
        return events

    def finish(self) -> List[tuple]:
        events: List[tuple] = []
        if self._state in ("scan", "held"):
            tail = self._buf[self._pos:]
            if tail:
                events.append(("content", tail))
        elif self._state == "args" and len(self._buf) > self._emit_to:
            # truncated generation mid-arguments: flush best-effort
            events.append(("tool_args", self.calls - 1,
                           self._buf[self._emit_to:]))
        self._pos = len(self._buf)
        return events

    # -- states ------------------------------------------------------------

    def _st_scan(self, events: List[tuple]) -> None:
        nxt = min((i for i in (self._buf.find("{", self._pos),
                               self._buf.find("[", self._pos)) if i >= 0),
                  default=-1)
        if nxt < 0:
            # hold back a trailing partial char? deltas are whole chars;
            # emit everything before any opener
            if self._pos < len(self._buf):
                events.append(("content", self._buf[self._pos:]))
                self._pos = len(self._buf)
            return
        if nxt > self._pos:
            events.append(("content", self._buf[self._pos:nxt]))
        self._pos = self._open = nxt
        self._state = "held"

    def _try_commit(self) -> Optional[str]:
        """Match an envelope prefix at the held opener. Returns the matched
        mode, "dead" when the candidate can never be an envelope, or None
        while undecided (needs more text)."""
        rest = self._buf[self._open:]
        for mode, pre in (("wrap", _WRAP_RE), ("list", _LIST_RE),
                          ("bare", None)):
            off = 0
            if pre is not None:
                m = pre.match(rest)
                if not m:
                    continue
                off = m.end()
                if mode == "list" and not rest[off:off + 1] == "{":
                    if rest[off:off + 1]:
                        continue            # a list, but not of objects
                    return None             # may still grow into one
            em = _ELEM_RE.match(rest[off:])
            if em:
                if em.group(1) not in self._known:
                    return "dead"           # hallucinated tool → content
                self._mode = mode
                self._elem_name = em.group(1)
                self._args_start = self._open + off + em.end()
                return mode
        return None

    # whitespace-stripped envelope heads a held candidate must stay
    # prefix-compatible with; divergence means it can NEVER commit
    _HEADS = ('{"tool_calls":[{"name":"', '{"name":"', '[{"name":"')

    def _could_still_commit(self) -> bool:
        text = re.sub(r"\s+", "", self._buf[self._open:])
        for head in self._HEADS:
            n = min(len(head), len(text))
            if text[:n] == head[:n]:
                return True
        return False

    def _st_held(self, events: List[tuple]) -> None:
        got = self._try_commit()
        if got is not None and got != "dead":
            self.calls += 1
            events.append(("tool_start", self.calls - 1, self._elem_name))
            self._emit_to = self._args_start
            self._state = "args"
            return
        if got == "dead" or not self._could_still_commit():
            # never an envelope (hallucinated name, or prose like 'if (x) {'
            # whose '{' balances late or never): release the opener and
            # rescan from the next char — ordinary streamed content must
            # not go silent waiting for a balance that may never come
            events.append(("content", self._buf[self._pos:self._open + 1]))
            self._pos = self._open + 1
            self._state = "scan"
            return
        # still prefix-compatible with an envelope (a bounded region — the
        # commit regex needs only the head + tool name): hold; a candidate
        # that BALANCES while still compatible (e.g. {"name":"x"} with no
        # arguments) is plain JSON content
        end = _value_end(self._buf, self._open)
        if end < 0:
            return
        events.append(("content", self._buf[self._pos:end]))
        self._pos = end
        self._state = "scan"

    def _st_args(self, events: List[tuple]) -> None:
        # skip whitespace before the value so fragment streaming can key on
        # the value's first character (dropped from fragments — the
        # concatenation stays valid JSON)
        while (self._args_start < len(self._buf)
               and self._buf[self._args_start].isspace()):
            self._args_start += 1
        if self._emit_to < self._args_start:
            self._emit_to = self._args_start
        end = _value_end(self._buf, self._args_start)
        if end < 0:
            # structured values are prefix-safe to stream; primitives wait
            head = self._buf[self._args_start:self._args_start + 1]
            if head in '{["' and len(self._buf) > self._emit_to:
                events.append(("tool_args", self.calls - 1,
                               self._buf[self._emit_to:]))
                self._emit_to = len(self._buf)
            return
        if end > self._emit_to:
            events.append(("tool_args", self.calls - 1,
                           self._buf[self._emit_to:end]))
        self._pos = self._emit_to = end
        self._state = "between"

    def _st_between(self, events: List[tuple]) -> None:
        """After an argument value: either another element follows (wrap/
        list modes) or the envelope closes; trailing text is swallowed
        (the buffered path likewise reports content=None for calls)."""
        rest = self._buf[self._pos:]
        if self._mode in ("wrap", "list"):
            m = re.match(r"\s*\}\s*,\s*", rest)
            if m:
                em = _ELEM_RE.match(rest[m.end():])
                if em:
                    if em.group(1) not in self._known:
                        self._state = "done"    # partial envelope: stop
                        return
                    self.calls += 1
                    events.append(("tool_start", self.calls - 1, em.group(1)))
                    self._args_start = self._pos + m.end() + em.end()
                    self._emit_to = self._args_start
                    self._state = "args"
                return
        if re.match(r"\s*\}\s*\]\s*\}" if self._mode == "wrap" else
                    r"\s*\}\s*\]" if self._mode == "list" else r"\s*\}",
                    rest):
            self._state = "done"

    def _st_done(self, events: List[tuple]) -> None:
        self._pos = len(self._buf)


def parse_tool_calls(text: str, tools: Sequence[Dict[str, Any]]
                     ) -> Optional[List[Dict[str, Any]]]:
    """Structured tool calls in ``text``, or None when it is plain content.

    Returns the OpenAI wire shape: [{"id", "type": "function",
    "function": {"name", "arguments": <json string>}}]."""
    found = extract_json_value(text)
    if found is None:
        return None
    value, _ = found
    if isinstance(value, dict) and isinstance(value.get("tool_calls"), list):
        raw_calls = value["tool_calls"]
    elif isinstance(value, dict) and "name" in value and (
            "arguments" in value or "parameters" in value):
        raw_calls = [value]
    elif isinstance(value, list) and value and all(
            isinstance(v, dict) and "name" in v for v in value):
        raw_calls = value
    else:
        return None
    known = set(tool_names(tools))
    calls = []
    for rc in raw_calls:
        if not isinstance(rc, dict):
            return None
        name = rc.get("name")
        if name not in known:
            return None   # hallucinated tool: treat the text as content
        args = rc.get("arguments", rc.get("parameters", {}))
        calls.append({
            "id": f"call_{uuid.uuid4().hex[:12]}",
            "type": "function",
            "function": {"name": name,
                         "arguments": json.dumps(_parse_args(args))},
        })
    return calls or None
