"""Constrained decoding: JSON-schema → byte-level DFA → on-device logit masks.

The port's own copy of ``generativeaiexamples_tpu/engine/grammar.py``
(numpy only, no import of the JAX package): the same automata, byte
table and cache keys, so both packages compile a schema to the same
DFA. On the port the per-token walk is ``ops/sampling.py``
``grammar_mask_plain`` on the CPU and the ``grammar_mask`` kernel
(``csrc/grammar_mask.cu``) on the card; the advance rides the
sampling kernel. The text below is the reference's.

The reference's NIM surface guarantees grammatical output for
``response_format.json_schema`` and tool calls at the token level (the
surface RAG/notebooks/langchain/NIM_tool_call_HumanInTheLoop_MultiAgents.ipynb
consumes); round 3 shipped prompt+parse instead, because a per-token host
round trip would break the engine's fused multi-step decode
(engine/tools.py:19-25). This module closes that gap WITHOUT unfusing:

  * A supported JSON schema compiles to a regular language over BYTES
    (objects with fixed properties, arrays with bounds, strings, numbers,
    enums, bounded-depth free JSON) — regex AST → Thompson NFA → subset-
    construction DFA. State 0 is the reject sink; accept states may emit
    EOS.
  * The DFA table is (S, 256) int32 — a few KB. The TOKEN-level transition
    is evaluated inside the decode program by walking each vocab token's
    byte string through the table (L chained gathers over (B, V), ops/
    sampling.py:grammar_mask) — no (S, V) dense table (hundreds of MB at a
    128k vocab), no host sync, and the 8/16-step dispatch fusion survives
    because the per-slot DFA state rides DecodeState like any other
    sampling parameter.
  * Token byte strings come from the tokenizer once per process
    (token_byte_table); specials and oversized tokens are permanently
    masked while a grammar is active.

Unsupported schema features (unbounded recursion via $ref, patternProperties,
anyOf of unbounded shapes) raise ``UnsupportedSchema`` — the serving layer
falls back to prompt+parse exactly as before, so the guarantee is strictly
additive.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

REJECT = 0          # DFA reject sink (row 0 of every table)


class UnsupportedSchema(ValueError):
    """Schema outside the regular subset — caller falls back to prompt+parse."""


# ---------------------------------------------------------------------------
# Regex AST (over byte classes) + combinators
# ---------------------------------------------------------------------------

def lit(data: bytes) -> tuple:
    return ("seq", [("cls", frozenset([b])) for b in data])


def cls(byte_values) -> tuple:
    return ("cls", frozenset(byte_values))


def seq(*parts) -> tuple:
    return ("seq", list(parts))


def alt(*parts) -> tuple:
    if not parts:
        raise UnsupportedSchema("empty alternation (e.g. empty enum)")
    return ("alt", list(parts))


def star(x) -> tuple:
    return ("star", x)


def opt(x) -> tuple:
    return ("opt", x)


def rep(x, lo: int, hi: Optional[int]) -> tuple:
    """x{lo,hi}; hi=None → unbounded."""
    parts = [x] * lo
    if hi is None:
        parts.append(star(x))
    else:
        parts += [opt(x)] * (hi - lo)
    return ("seq", parts)


# -- JSON building blocks ---------------------------------------------------

_WS = opt(cls([0x20]))          # one optional space (compact-ish JSON)

_STRING_CHAR = alt(
    cls(set(range(0x20, 0x7F)) - {0x22, 0x5C}),     # printable minus " \
    cls(range(0x80, 0x100)),                        # utf-8 continuation/lead
    seq(cls([0x5C]), cls(b'"\\/bfnrt')),            # escapes
    seq(cls([0x5C]), cls(b"u"), *([cls(b"0123456789abcdefABCDEF")] * 4)),
)

_DIGIT = cls(b"0123456789")
_INT = seq(opt(cls(b"-")), alt(cls(b"0"), seq(cls(b"123456789"),
                                              star(_DIGIT))))
_NUMBER = seq(_INT, opt(seq(cls(b"."), _DIGIT, star(_DIGIT))),
              opt(seq(cls(b"eE"), opt(cls(b"+-")), _DIGIT, star(_DIGIT))))


def _string_ast(s: Dict[str, Any]) -> tuple:
    if "enum" in s:
        return alt(*[lit(json.dumps(v).encode()) for v in s["enum"]])
    body = rep(_STRING_CHAR, int(s.get("minLength", 0)),
               int(s["maxLength"]) if "maxLength" in s else None)
    return seq(lit(b'"'), body, lit(b'"'))


def _free_json_object(depth: int) -> tuple:
    """Any JSON object (free-form keys and values), nesting bounded at
    ``depth`` — the language of ``{"type": "object"}`` with no declared
    properties."""
    inner = _free_json(depth - 1)
    key = seq(lit(b'"'), star(_STRING_CHAR), lit(b'"'))
    member = seq(key, _WS, lit(b":"), _WS, inner)
    return seq(lit(b"{"), _WS,
               opt(seq(member, star(seq(lit(b","), _WS, member)))),
               _WS, lit(b"}"))


def _free_json(depth: int) -> tuple:
    """Any JSON value, nesting bounded at ``depth`` (a DFA cannot count)."""
    scalar = alt(seq(lit(b'"'), star(_STRING_CHAR), lit(b'"')),
                 _NUMBER, lit(b"true"), lit(b"false"), lit(b"null"))
    if depth <= 0:
        return scalar
    inner = _free_json(depth - 1)
    arr = seq(lit(b"["), _WS,
              opt(seq(inner, star(seq(lit(b","), _WS, inner)))),
              _WS, lit(b"]"))
    return alt(scalar, arr, _free_json_object(depth))


_FREE_DEPTH = 3


def schema_ast(schema: Dict[str, Any], depth: int = 12) -> tuple:
    """Regex AST for a JSON-schema subset. Raises UnsupportedSchema beyond
    the regular fragment."""
    if depth <= 0:
        raise UnsupportedSchema("schema nests deeper than the DFA bound")
    if not isinstance(schema, dict):
        raise UnsupportedSchema(f"schema must be an object, got {schema!r}")
    if "$ref" in schema:
        raise UnsupportedSchema("$ref (potentially recursive)")
    if "const" in schema:
        return lit(json.dumps(schema["const"]).encode())
    if "enum" in schema:
        return alt(*[lit(json.dumps(v).encode()) for v in schema["enum"]])
    if "anyOf" in schema or "oneOf" in schema:
        options = schema.get("anyOf") or schema.get("oneOf")
        return alt(*[schema_ast(o, depth - 1) for o in options])
    t = schema.get("type")
    if isinstance(t, list):
        return alt(*[schema_ast({**schema, "type": one}, depth - 1)
                     for one in t])
    if t == "string":
        return _string_ast(schema)
    if t == "integer":
        return _INT
    if t == "number":
        return _NUMBER
    if t == "boolean":
        return alt(lit(b"true"), lit(b"false"))
    if t == "null":
        return lit(b"null")
    if t == "array":
        items = schema.get("items")
        inner = (schema_ast(items, depth - 1) if isinstance(items, dict)
                 else _free_json(_FREE_DEPTH))
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        body = (opt(_items_seq(inner, 1, None)) if lo == 0 and hi is None
                else _items_seq(inner, max(lo, 1), hi) if lo > 0
                else opt(_items_seq(inner, 1, hi)))
        return seq(lit(b"["), _WS, body, _WS, lit(b"]"))
    if t == "object" or (t is None and "properties" in schema):
        props = schema.get("properties")
        if not props:
            # a bare {"type": "object"} admits ANY object (JSON Schema
            # semantics) — only an explicit additionalProperties:false
            # pins it to the empty object. A SCHEMA-valued
            # additionalProperties would make the free-object language a
            # superset of the schema's — refuse so the serving layer falls
            # back to prompt+parse instead of guaranteeing invalid output.
            ap = schema.get("additionalProperties")
            if isinstance(ap, dict):
                raise UnsupportedSchema(
                    "additionalProperties with a value schema")
            if ap is False:
                return seq(lit(b"{"), _WS, lit(b"}"))
            return (_free_json(_FREE_DEPTH) if t is None
                    else _free_json_object(_FREE_DEPTH))
        # JSON Schema semantics: absent "required" means NO property is
        # required (the prompt contract still asks the model for all of
        # them; the mask only guarantees validity)
        required = set(schema.get("required", ()))
        members = []
        for name, sub in props.items():
            m = seq(lit(json.dumps(name).encode()), _WS, lit(b":"), _WS,
                    schema_ast(sub, depth - 1))
            members.append((m, name in required))
        # fixed property order (the order models are prompted with); the
        # first emitted member needs no leading comma — build alternatives
        # over which required/optional members appear
        return seq(lit(b"{"), _WS, _members_seq(members), _WS, lit(b"}"))
    if t is None:
        return _free_json(_FREE_DEPTH)
    raise UnsupportedSchema(f"unsupported type {t!r}")


def _items_seq(inner: tuple, lo: int, hi: Optional[int]) -> tuple:
    first = inner
    more = seq(lit(b","), _WS, inner)
    return seq(first, rep(more, lo - 1, None if hi is None else hi - 1))


def _members_seq(members: List[Tuple[tuple, bool]]) -> tuple:
    """Members in fixed order; optional ones may be absent; commas separate
    exactly the PRESENT members. suffix_from(i) is the language of members
    i.. given that some member was already emitted (each present one is
    comma-prefixed); the head alternation picks which member appears first
    (no comma) — any optional member before the first required one may be
    it."""
    def suffix_from(i: int) -> tuple:
        a: tuple = ("seq", [])
        for m, req in reversed(members[i:]):
            e = seq(lit(b","), _WS, m, a)
            a = e if req else alt(e, a)
        return a

    options: List[tuple] = []
    for i, (m, req) in enumerate(members):
        options.append(seq(m, suffix_from(i + 1)))
        if req:
            break
    else:
        options.append(("seq", []))     # all optional: object may be empty
    return alt(*options)


# ---------------------------------------------------------------------------
# NFA construction + subset-construction DFA
# ---------------------------------------------------------------------------

class _NFA:
    def __init__(self) -> None:
        self.eps: List[List[int]] = []
        self.edges: List[Dict[int, List[int]]] = []   # state -> byte -> [to]

    def new(self) -> int:
        self.eps.append([])
        self.edges.append({})
        return len(self.eps) - 1


def _build(nfa: _NFA, ast: tuple, start: int, end: int) -> None:
    kind = ast[0]
    if kind == "cls":
        for b in ast[1]:
            nfa.edges[start].setdefault(b, []).append(end)
    elif kind == "seq":
        cur = start
        parts = ast[1]
        for i, p in enumerate(parts):
            nxt = end if i == len(parts) - 1 else nfa.new()
            _build(nfa, p, cur, nxt)
            cur = nxt
        if not parts:
            nfa.eps[start].append(end)
    elif kind == "alt":
        for p in ast[1]:
            s, e = nfa.new(), nfa.new()
            nfa.eps[start].append(s)
            nfa.eps[e].append(end)
            _build(nfa, p, s, e)
    elif kind == "star":
        s, e = nfa.new(), nfa.new()
        nfa.eps[start] += [s, end]
        nfa.eps[e] += [s, end]
        _build(nfa, ast[1], s, e)
    elif kind == "opt":
        nfa.eps[start].append(end)
        _build(nfa, ast[1], start, end)
    else:  # pragma: no cover
        raise AssertionError(kind)


def _closure(nfa: _NFA, states: frozenset) -> frozenset:
    stack, seen = list(states), set(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


DIST_INF = 1 << 30


@dataclass(frozen=True)
class ByteDFA:
    """table: (S, 256) int32, row 0 = reject sink; accept: (S,) bool;
    start: int; dist: (S,) int32 — fewest BYTES from the state to an accept
    state (DIST_INF for the sink). Because every byte has a single-byte
    token in serving vocabularies, dist also upper-bounds the TOKENS needed
    to finish — the runtime masks away tokens that would leave the
    automaton unfinishable within the request's remaining budget, so
    constrained generations complete instead of truncating mid-JSON."""

    table: np.ndarray
    accept: np.ndarray
    start: int
    dist: np.ndarray

    @property
    def n_states(self) -> int:
        return self.table.shape[0]

    def matches(self, data: bytes) -> bool:
        s = self.start
        for b in data:
            s = int(self.table[s, b])
            if s == REJECT:
                return False
        return bool(self.accept[s])


MAX_DFA_STATES = 20000


def compile_dfa(ast: tuple) -> ByteDFA:
    nfa = _NFA()
    s0, s1 = nfa.new(), nfa.new()
    _build(nfa, ast, s0, s1)

    start_set = _closure(nfa, frozenset([s0]))
    index: Dict[frozenset, int] = {start_set: 1}     # 0 reserved for reject
    order = [start_set]
    rows: List[np.ndarray] = []
    i = 0
    while i < len(order):
        cur = order[i]
        i += 1
        row = np.zeros((256,), np.int32)
        moves: Dict[int, set] = {}
        for s in cur:
            for b, tos in nfa.edges[s].items():
                moves.setdefault(b, set()).update(tos)
        for b, tos in moves.items():
            nxt = _closure(nfa, frozenset(tos))
            if nxt not in index:
                if len(index) + 1 > MAX_DFA_STATES:
                    raise UnsupportedSchema(
                        f"DFA exceeds {MAX_DFA_STATES} states")
                index[nxt] = len(index) + 1
                order.append(nxt)
            row[b] = index[nxt]
        rows.append(row)
    table = np.zeros((len(order) + 1, 256), np.int32)
    for j, row in enumerate(rows):
        table[j + 1] = row
    accept = np.zeros((len(order) + 1,), bool)
    for st, j in index.items():
        accept[j] = s1 in st
    # reverse BFS: fewest bytes from each state to an accept state
    S = len(order) + 1
    preds: List[List[int]] = [[] for _ in range(S)]
    for s in range(1, S):
        for t in set(table[s].tolist()):
            if t != REJECT:
                preds[t].append(s)
    dist = np.full((S,), DIST_INF, np.int64)
    frontier = [s for s in range(1, S) if accept[s]]
    dist[frontier] = 0
    d = 0
    while frontier:
        d += 1
        nxt = []
        for t in frontier:
            for s in preds[t]:
                if dist[s] > d:
                    dist[s] = d
                    nxt.append(s)
        frontier = nxt
    return ByteDFA(table=table, accept=accept, start=1,
                   dist=np.minimum(dist, DIST_INF).astype(np.int32))


# ---------------------------------------------------------------------------
# Tokenizer byte table + compiled grammar handle
# ---------------------------------------------------------------------------

MAX_TOKEN_BYTES = 16


def token_byte_table(tokenizer, max_bytes: int = MAX_TOKEN_BYTES
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(V, max_bytes) byte ids + (V,) lengths; length -1 = token never
    allowed under a grammar (specials, empties, oversized)."""
    V = tokenizer.vocab_size
    out = np.zeros((V, max_bytes), np.int32)
    lens = np.full((V,), -1, np.int32)
    specials = {getattr(tokenizer, a, -1)
                for a in ("bos_id", "eos_id", "pad_id")}
    # ids 0..255 are raw bytes only where the tokenizer says so (the byte
    # tokenizer's ``byte_ids``). The reference reads every tokenizer whose
    # EOS id is >= 256 so, and a byte-level BPE vocabulary (Llama-3's:
    # ids 0..255 are GPT-2's byte alphabet in another order) is one: its
    # ids 0..255 would walk the wrong bytes. Every other id is decoded.
    byte_ids = bool(getattr(tokenizer, "byte_ids", False))
    for t in range(V):
        if t in specials:
            continue
        if byte_ids and t < 256:
            data = bytes([t])     # raw byte token (may be a utf-8 fragment)
        else:
            data = tokenizer.decode([t]).encode("utf-8")
            if "�" in data.decode("utf-8", errors="replace"):
                continue          # partial-utf8 piece we cannot byte-map
        if not data or len(data) > max_bytes:
            continue
        out[t, :len(data)] = list(data)
        lens[t] = len(data)
    return out, lens


@dataclass(frozen=True)
class Grammar:
    """A compiled grammar ready for the engine: the byte DFA + a cache key."""

    dfa: ByteDFA
    key: str

    @staticmethod
    def from_schema(schema: Dict[str, Any]) -> "Grammar":
        # NOT sort_keys: property order is part of the enforced language
        # (fixed-order members), so schemas differing only in property
        # order are different grammars and must not collide in engine caches
        return Grammar(dfa=compile_dfa(seq(schema_ast(schema), _WS)),
                       key="schema:" + json.dumps(schema, sort_keys=False))

    @staticmethod
    def json_value() -> "Grammar":
        """Generic json_object mode: any JSON value, nesting ≤ _FREE_DEPTH."""
        return Grammar(dfa=compile_dfa(seq(_free_json(_FREE_DEPTH), _WS)),
                       key="json_value")

    @staticmethod
    def for_tools_cached(tools: Sequence[Dict[str, Any]],
                         forced: Optional[str] = None) -> "Grammar":
        """Compile-once variant: tool sets repeat across agent-loop turns,
        DFA determinization doesn't need to (the /v1 server caches for the
        same reason)."""
        return _cached_tools_grammar(
            json.dumps({"tools": list(tools), "forced": forced},
                       sort_keys=False))

    @staticmethod
    def for_tools(tools: Sequence[Dict[str, Any]],
                  forced: Optional[str] = None) -> "Grammar":
        """The tool-call envelope: {"tool_calls": [{"name": <tool>,
        "arguments": <its parameter schema>}...]} — names constrained to the
        declared tools, arguments to each tool's own schema."""
        calls = []
        for t in tools:
            fn = t.get("function", t)
            name = fn.get("name", "")
            if forced and name != forced:
                continue
            params = fn.get("parameters") or {"type": "object"}
            calls.append(seq(lit(b'{"name":'), _WS,
                             lit(json.dumps(name).encode()), lit(b","), _WS,
                             lit(b'"arguments":'), _WS,
                             schema_ast(params), lit(b"}")))
        one = alt(*calls)
        env = seq(lit(b'{"tool_calls":'), _WS, lit(b"["), _WS,
                  one, star(seq(lit(b","), _WS, one)), _WS, lit(b"]"),
                  lit(b"}"), _WS)
        # the key must cover PARAMETER SCHEMAS, not just names — engines
        # dedup grammars by key, and two tool sets with identical names but
        # different parameters are different languages (NOT sort_keys:
        # property order is part of the enforced language)
        spec = json.dumps(
            [[t.get("function", t).get("name"),
              t.get("function", t).get("parameters")] for t in tools],
            sort_keys=False)
        digest = hashlib.sha256(spec.encode()).hexdigest()[:16]
        key = f"tools:{digest}:{forced}"
        return Grammar(dfa=compile_dfa(env), key=key)


import functools as _functools


@_functools.lru_cache(maxsize=64)
def _cached_tools_grammar(spec_json: str) -> "Grammar":
    spec = json.loads(spec_json)
    return Grammar.for_tools(spec["tools"], forced=spec["forced"])
