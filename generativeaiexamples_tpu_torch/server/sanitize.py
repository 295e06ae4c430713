"""``bleach.clean(text, strip=True)`` with bleach's defaults, on the
standard library.

The chain server cleans every user string as the reference's does
(``server/api.py`` there: ``bleach.clean(text[:131072], strip=True)``),
and the chains see the cleaned strings, so a sanitizer that differs would
change the prompt. The card's machine has no bleach, so this module
reproduces bleach 6's output by running its four stages:

1. tokenize: html5lib's tokenizer states for the data, tag, attribute,
   comment, bogus-comment and DOCTYPE paths, over html5lib's input stream
   (10,240-character chunks, CR/LF folded, one "invalid-codepoint" error
   per control or noncharacter code point, reported as each chunk is
   read), with bleach's changes: character references are not consumed;
   a tag outside the allowed set becomes an empty text token (a newline
   for a block-level start tag after the first tag); after
   "expected-closing-tag-but-got-char" a bogus comment that does not name
   an allowed tag turns back into its source text; a tag cut off by the
   end of the input becomes its source text;
2. build the tree: html5lib's "in body" insertion mode in a ``div``
   fragment, for the tags that reach it (the twelve allowed ones):
   formatting elements with the adoption agency, reconstruction and the
   three-element clause, list items, blocks, and "any other" tags;
3. walk and filter: comments dropped; attributes kept only where allowed,
   an ``href`` only with an allowed scheme (bleach's URI normalisation
   and its vendored ``urlsplit``); control characters other than tab,
   CR and LF become "?" inside text runs; character references that
   bleach recognises are kept as they are;
4. serialize: text escaped (``&``, ``<``, ``>``), attribute values quoted
   as html5lib quotes them, and bleach's pass over the serializer's
   tokens that re-escapes bare ampersands after an ``=``.

``clean`` is the one entry point. ``tests/test_torch_chain_server.py``
holds it equal to bleach on a fixed corpus and under a hypothesis search.
"""

from __future__ import annotations

import html.entities
import re
import string
from typing import Dict, Iterator, List, Optional

ALLOWED_TAGS = frozenset(("a", "abbr", "acronym", "b", "blockquote", "code",
                          "em", "i", "li", "ol", "strong", "ul"))
ALLOWED_ATTRIBUTES = {"a": ("href", "title"), "abbr": ("title",),
                      "acronym": ("title",)}
ALLOWED_PROTOCOLS = frozenset(("http", "https", "mailto"))
# bleach's HTML_TAGS_BLOCK_LEVEL: a stripped block-level start tag leaves
# a newline, as a browser would render it
BLOCK_LEVEL = frozenset((
    "address", "article", "aside", "blockquote", "dd", "details", "dialog",
    "div", "dl", "dt", "fieldset", "figcaption", "figure", "footer", "form",
    "h1", "h2", "h3", "h4", "h5", "h6", "header", "hgroup", "hr", "li", "main",
    "nav", "ol", "p", "pre", "section", "table", "ul"))
# the html5lib "special" category and the formatting elements, as far as
# the allowed tags go
SPECIAL = frozenset(("html", "blockquote", "li", "ol", "ul"))
FORMATTING = frozenset(("b", "code", "em", "i", "strong"))
BLOCKS = frozenset(("blockquote", "ol", "ul"))
# attributes whose value is a URL (html5lib's attr_val_is_uri)
URI_ATTRS = frozenset([(None, n) for n in (
    "action", "background", "cite", "datasrc", "dynsrc", "formaction",
    "href", "longdesc", "lowsrc", "ping", "poster", "src")] + [
    ("http://www.w3.org/1999/xlink", "href"),
    ("http://www.w3.org/XML/1998/namespace", "base")])

SPACE = "\t\n\x0c \r"
LETTERS = frozenset(string.ascii_letters)
_ASCII_LOWER = str.maketrans(string.ascii_uppercase, string.ascii_lowercase)
_INVISIBLE = re.compile("[\x00-\x08\x0b\x0c\x0e-\x1f]")
_INVALID = re.compile(
    "[\x01-\x08\x0b\x0e-\x1f\x7f-\x9f﷐-﷯￾￿"
    + "".join(chr(p << 16 | 0xFFFE) + chr(p << 16 | 0xFFFF)
              for p in range(1, 17))
    + "\ud800-\udfff]")
_NS_ATTR = re.compile("{([^}]*)}(.*)")
_CHUNK = 10240
_ENTITIES = html.entities.html5
_PREFIXES: Optional[frozenset] = None


def _entity_prefixes() -> frozenset:
    global _PREFIXES
    if _PREFIXES is None:
        _PREFIXES = frozenset(k[:i] for k in _ENTITIES
                              for i in range(1, len(k) + 1))
    return _PREFIXES


# ---------------------------------------------------------------- entities

def match_entity(part: str) -> Optional[str]:
    """bleach's ``match_entity``: the reference's name (without ``&`` and
    ``;``) that ``part`` (which starts with ``&``) begins with, or None."""
    rest = part[1:]
    ends = "<&=;" + string.whitespace
    i = 0
    if rest[:1] == "#":
        entity = "#"
        i = 1
        if rest[1:2] in ("x", "X"):
            allowed = "0123456789abcdefABCDEF"
            entity += rest[1]
            i = 2
        else:
            allowed = "0123456789"
        while i < len(rest) and rest[i] not in ends:
            c = rest[i]
            i += 1
            if c not in allowed:
                break
            entity += c
        # bleach looks at the character after the one it stopped on
        return entity if i < len(rest) and rest[i] == ";" else None
    entity = ""
    prefixes = _entity_prefixes()
    while i < len(rest) and rest[i] not in ends:
        entity += rest[i]
        i += 1
        if entity not in prefixes:
            return None
    return entity if entity and i < len(rest) and rest[i] == ";" else None


def convert_entity(value: str) -> Optional[str]:
    if value[0] == "#":
        if len(value) < 2:
            return None
        digits, base = ((value[2:], 16) if value[1] in ("x", "X")
                        else (value[1:], 10))
        if digits == "":
            return None
        point = int(digits, base)
        return chr(point) if 0 < point < 0x110000 else None
    return _ENTITIES.get(value)


def _amp_parts(text: str) -> Iterator[str]:
    """bleach's ``next_possible_entity``: the text split before each
    ``&``."""
    for i, part in enumerate(re.split("(&)", text)):
        if i == 0:
            yield part
        elif i % 2 == 0:
            yield "&" + part


def convert_entities(text: str) -> str:
    if "&" not in text:
        return text
    out = []
    for part in _amp_parts(text):
        if not part:
            continue
        if part.startswith("&"):
            entity = match_entity(part)
            if entity is not None:
                converted = convert_entity(entity)
                if converted is not None:
                    out.append(converted)
                    out.append(part[len(entity) + 2:])
                    continue
        out.append(part)
    return "".join(out)


# ------------------------------------------------------------------ stream

class _Stream:
    """html5lib's input stream over positions in the folded text: chunks
    load as the tokenizer first reads into them, and each load reports its
    invalid code points."""

    def __init__(self, raw: str) -> None:
        self.chunks = []
        held = ""
        i = 0
        while True:
            data = raw[i:i + _CHUNK]
            i += _CHUNK
            if held:
                data, held = held + data, ""
            elif not data:
                break
            if len(data) > 1 and (data[-1] == "\r"
                                  or "\ud800" <= data[-1] <= "\udbff"):
                held, data = data[-1], data[:-1]
            errors = len(_INVALID.findall(data))
            self.chunks.append((data.replace("\r\n", "\n").replace(
                "\r", "\n"), errors))
        self.text = "".join(c for c, _ in self.chunks)
        self.pos = 0
        self.end = 0
        self.loaded = 0
        self.errors: List[str] = []
        self.tag_start = 0

    def _load(self) -> bool:
        if self.loaded == len(self.chunks):
            return False
        data, errors = self.chunks[self.loaded]
        self.loaded += 1
        self.end += len(data)
        self.errors.extend(["invalid-codepoint"] * errors)
        return True

    def char(self) -> Optional[str]:
        if self.pos >= self.end and not self._load():
            return None
        c = self.text[self.pos]
        self.pos += 1
        return c

    def chars_until(self, chars, opposite: bool = False) -> str:
        start = self.pos
        while True:
            if self.pos >= self.end and not self._load():
                break
            j = self.pos
            text, end = self.text, self.end
            while j < end and (text[j] in chars) == opposite:
                j += 1
            self.pos = j
            if j < end:
                break
        return self.text[start:self.pos]

    def unget(self, c: Optional[str]) -> None:
        if c is not None:
            self.pos -= 1

    def get_tag(self) -> str:
        """The source since the ``<`` that opened the current tag."""
        return self.text[self.tag_start:self.pos]


# --------------------------------------------------------------- tokenizer

def _error(name: str) -> Dict:
    return {"type": "ParseError", "data": name}


class _Tokenizer:
    """html5lib's tokenizer for the states a fragment reaches in a ``div``
    (the tree builder never switches it to RCDATA, RAWTEXT or script data:
    the tags that would are stripped first), with bleach's changes."""

    def __init__(self, text: str) -> None:
        self.stream = _Stream(text)
        self.state = self.data_state
        self.queue: List[Dict] = []
        self.current: Optional[Dict] = None
        self.emitted_last = None

    def __iter__(self) -> Iterator[Dict]:
        while self.state():
            while self.stream.errors:
                yield _error(self.stream.errors.pop(0))
            while self.queue:
                yield self.queue.pop(0)

    def emit_current(self) -> None:
        token = self.current
        if token["name"].lower() not in ALLOWED_TAGS:
            # bleach strips the tag: an empty text token, or a newline for
            # a block-level start tag once a tag has been emitted
            data = ("\n" if self.emitted_last is not None
                    and token["type"] == "StartTag"
                    and token["name"].lower() in BLOCK_LEVEL else "")
            new = {"type": "Characters", "data": data}
            self.current = self.emitted_last = new
            self.queue.append(new)
            self.state = self.data_state
            return
        self.emitted_last = token
        token["name"] = token["name"].translate(_ASCII_LOWER)
        if token["type"] == "StartTag":
            raw = token["data"]
            data = dict(raw)
            if len(raw) > len(data):
                data.update(raw[::-1])      # the first of duplicates wins
            token["data"] = data
        else:
            if token["data"]:
                self.queue.append(_error("attributes-in-end-tag"))
            if token["selfClosing"]:
                self.queue.append(_error("self-closing-flag-on-end-tag"))
        self.queue.append(token)
        self.state = self.data_state

    # -- data and tags

    def data_state(self) -> bool:
        s = self.stream
        c = s.char()
        if c == "&":
            # bleach does not consume character references
            self.queue.append({"type": "Characters", "data": "&"})
        elif c == "<":
            self.state = self.tag_open_state
        elif c == "\x00":
            self.queue.append(_error("invalid-codepoint"))
            self.queue.append({"type": "Characters", "data": "\x00"})
        elif c is None:
            return False
        elif c in SPACE:
            self.queue.append({"type": "SpaceCharacters",
                               "data": c + s.chars_until(SPACE, True)})
        else:
            self.queue.append({"type": "Characters",
                               "data": c + s.chars_until("&<\x00")})
        return True

    def tag_open_state(self) -> bool:
        s = self.stream
        s.tag_start = s.pos - 1
        c = s.char()
        if c == "!":
            self.state = self.markup_declaration_open_state
        elif c == "/":
            self.state = self.close_tag_open_state
        elif c is not None and c in LETTERS:
            self.current = {"type": "StartTag", "name": c, "data": [],
                            "selfClosing": False}
            self.state = self.tag_name_state
        elif c == ">":
            self.queue.append(_error("expected-tag-name-but-got-right-"
                                     "bracket"))
            self.queue.append({"type": "Characters", "data": "<>"})
            self.state = self.data_state
        elif c == "?":
            self.queue.append(_error("expected-tag-name-but-got-question-"
                                     "mark"))
            s.unget(c)
            self.state = self.bogus_comment_state
        else:
            self.queue.append(_error("expected-tag-name"))
            self.queue.append({"type": "Characters", "data": "<"})
            s.unget(c)
            self.state = self.data_state
        return True

    def close_tag_open_state(self) -> bool:
        s = self.stream
        c = s.char()
        if c is not None and c in LETTERS:
            self.current = {"type": "EndTag", "name": c, "data": [],
                            "selfClosing": False}
            self.state = self.tag_name_state
        elif c == ">":
            self.queue.append(_error("expected-closing-tag-but-got-right-"
                                     "bracket"))
            self.state = self.data_state
        elif c is None:
            self.queue.append(_error("expected-closing-tag-but-got-eof"))
            self.queue.append({"type": "Characters", "data": "</"})
            self.state = self.data_state
        else:
            self.queue.append(_error("expected-closing-tag-but-got-char"))
            s.unget(c)
            self.state = self.bogus_comment_state
        return True

    def tag_name_state(self) -> bool:
        c = self.stream.char()
        if c is None:
            self.queue.append(_error("eof-in-tag-name"))
            self.state = self.data_state
        elif c in SPACE:
            self.state = self.before_attribute_name_state
        elif c == ">":
            self.emit_current()
        elif c == "/":
            self.state = self.self_closing_start_tag_state
        elif c == "\x00":
            self.queue.append(_error("invalid-codepoint"))
            self.current["name"] += "�"
        else:
            self.current["name"] += c
        return True

    # -- attributes

    def _new_attribute(self, name: str) -> None:
        self.current["data"].append([name, ""])
        self.state = self.attribute_name_state

    def before_attribute_name_state(self) -> bool:
        s = self.stream
        c = s.char()
        if c is None:
            self.queue.append(_error("expected-attribute-name-but-got-eof"))
            self.state = self.data_state
        elif c in SPACE:
            s.chars_until(SPACE, True)
        elif c in LETTERS:
            self._new_attribute(c)
        elif c == ">":
            self.emit_current()
        elif c == "/":
            self.state = self.self_closing_start_tag_state
        elif c in ("'", '"', "=", "<"):
            self.queue.append(_error("invalid-character-in-attribute-name"))
            self._new_attribute(c)
        elif c == "\x00":
            self.queue.append(_error("invalid-codepoint"))
            self._new_attribute("�")
        else:
            self._new_attribute(c)
        return True

    def attribute_name_state(self) -> bool:
        s = self.stream
        c = s.char()
        leaving = True
        emit = False
        attr = self.current["data"][-1]
        if c == "=":
            self.state = self.before_attribute_value_state
        elif c is not None and c in LETTERS:
            attr[0] += c + s.chars_until(LETTERS, True)
            leaving = False
        elif c == ">":
            emit = True
        elif c is None:
            self.queue.append(_error("eof-in-attribute-name"))
            self.state = self.data_state
        elif c in SPACE:
            self.state = self.after_attribute_name_state
        elif c == "/":
            self.state = self.self_closing_start_tag_state
        elif c == "\x00":
            self.queue.append(_error("invalid-codepoint"))
            attr[0] += "�"
            leaving = False
        elif c in ("'", '"', "<"):
            self.queue.append(_error("invalid-character-in-attribute-name"))
            attr[0] += c
            leaving = False
        else:
            attr[0] += c
            leaving = False
        if leaving:
            attr[0] = attr[0].translate(_ASCII_LOWER)
            if any(name == attr[0] for name, _ in self.current["data"][:-1]):
                self.queue.append(_error("duplicate-attribute"))
            if emit:
                self.emit_current()
        return True

    def after_attribute_name_state(self) -> bool:
        s = self.stream
        c = s.char()
        if c is None:
            self.queue.append(_error("expected-end-of-tag-but-got-eof"))
            self.state = self.data_state
        elif c in SPACE:
            s.chars_until(SPACE, True)
        elif c == "=":
            self.state = self.before_attribute_value_state
        elif c == ">":
            self.emit_current()
        elif c in LETTERS:
            self._new_attribute(c)
        elif c == "/":
            self.state = self.self_closing_start_tag_state
        elif c == "\x00":
            self.queue.append(_error("invalid-codepoint"))
            self._new_attribute("�")
        elif c in ("'", '"', "<"):
            self.queue.append(_error("invalid-character-after-attribute-"
                                     "name"))
            self._new_attribute(c)
        else:
            self._new_attribute(c)
        return True

    def before_attribute_value_state(self) -> bool:
        s = self.stream
        c = s.char()
        attr = self.current["data"][-1]
        if c is None:
            self.queue.append(_error("expected-attribute-value-but-got-eof"))
            self.state = self.data_state
        elif c in SPACE:
            s.chars_until(SPACE, True)
        elif c == '"':
            self.state = self.attribute_value_double_quoted_state
        elif c == "&":
            self.state = self.attribute_value_unquoted_state
            s.unget(c)
        elif c == "'":
            self.state = self.attribute_value_single_quoted_state
        elif c == ">":
            self.queue.append(_error("expected-attribute-value-but-got-"
                                     "right-bracket"))
            self.emit_current()
        elif c == "\x00":
            self.queue.append(_error("invalid-codepoint"))
            attr[1] += "�"
            self.state = self.attribute_value_unquoted_state
        elif c in ("=", "<", "`"):
            self.queue.append(_error("equals-in-unquoted-attribute-value"))
            attr[1] += c
            self.state = self.attribute_value_unquoted_state
        else:
            attr[1] += c
            self.state = self.attribute_value_unquoted_state
        return True

    def _quoted_value(self, quote: str) -> bool:
        s = self.stream
        c = s.char()
        attr = self.current["data"][-1]
        if c == quote:
            self.state = self.after_attribute_value_state
        elif c == "&":
            attr[1] += "&"
        elif c == "\x00":
            self.queue.append(_error("invalid-codepoint"))
            attr[1] += "�"
        elif c is None:
            self.queue.append(_error(
                "eof-in-attribute-value-"
                + ("double" if quote == '"' else "single") + "-quote"))
            self.state = self.data_state
        else:
            attr[1] += c + s.chars_until((quote, "&", "\x00"))
        return True

    def attribute_value_double_quoted_state(self) -> bool:
        return self._quoted_value('"')

    def attribute_value_single_quoted_state(self) -> bool:
        return self._quoted_value("'")

    def attribute_value_unquoted_state(self) -> bool:
        s = self.stream
        c = s.char()
        attr = self.current["data"][-1]
        if c is None:
            self.queue.append(_error("eof-in-attribute-value-no-quotes"))
            self.state = self.data_state
        elif c in SPACE:
            self.state = self.before_attribute_name_state
        elif c == "&":
            attr[1] += "&"
        elif c == ">":
            self.emit_current()
        elif c in ('"', "'", "=", "<", "`"):
            self.queue.append(_error("unexpected-character-in-unquoted-"
                                     "attribute-value"))
            attr[1] += c
        elif c == "\x00":
            self.queue.append(_error("invalid-codepoint"))
            attr[1] += "�"
        else:
            attr[1] += c + s.chars_until(
                frozenset("&>\"'=<`\x00") | frozenset(SPACE))
        return True

    def after_attribute_value_state(self) -> bool:
        s = self.stream
        c = s.char()
        if c is None:
            self.queue.append(_error("unexpected-EOF-after-attribute-value"))
            self.state = self.data_state
        elif c in SPACE:
            self.state = self.before_attribute_name_state
        elif c == ">":
            self.emit_current()
        elif c == "/":
            self.state = self.self_closing_start_tag_state
        else:
            self.queue.append(_error("unexpected-character-after-attribute-"
                                     "value"))
            s.unget(c)
            self.state = self.before_attribute_name_state
        return True

    def self_closing_start_tag_state(self) -> bool:
        s = self.stream
        c = s.char()
        if c == ">":
            self.current["selfClosing"] = True
            self.emit_current()
        elif c is None:
            self.queue.append(_error("unexpected-EOF-after-solidus-in-tag"))
            self.state = self.data_state
        else:
            self.queue.append(_error("unexpected-character-after-solidus-in-"
                                     "tag"))
            s.unget(c)
            self.state = self.before_attribute_name_state
        return True

    # -- comments and declarations (their text is dropped: only where
    #    they end and the errors they raise matter)

    def bogus_comment_state(self) -> bool:
        s = self.stream
        data = s.chars_until(">").replace("\x00", "�")
        self.queue.append({"type": "Comment", "data": data})
        s.char()
        self.state = self.data_state
        return True

    def markup_declaration_open_state(self) -> bool:
        s = self.stream
        stack = [s.char()]
        if stack[-1] == "-":
            stack.append(s.char())
            if stack[-1] == "-":
                self.current = {"type": "Comment", "data": ""}
                self.state = self.comment_start_state
                return True
        elif stack[-1] in ("d", "D"):
            for expected in "octype":
                stack.append(s.char())
                if stack[-1] not in (expected, expected.upper()):
                    break
            else:
                self.state = self.doctype_state
                return True
        self.queue.append(_error("expected-dashes-or-doctype"))
        while stack:
            s.unget(stack.pop())
        self.state = self.bogus_comment_state
        return True

    def _end_comment(self, error: Optional[str] = None) -> None:
        if error:
            self.queue.append(_error(error))
        self.queue.append(self.current)
        self.state = self.data_state

    def comment_start_state(self) -> bool:
        c = self.stream.char()
        if c == "-":
            self.state = self.comment_start_dash_state
        elif c == "\x00":
            self.queue.append(_error("invalid-codepoint"))
        elif c == ">":
            self._end_comment("incorrect-comment")
        elif c is None:
            self._end_comment("eof-in-comment")
        else:
            self.state = self.comment_state
        return True

    def comment_start_dash_state(self) -> bool:
        c = self.stream.char()
        if c == "-":
            self.state = self.comment_end_state
        elif c == "\x00":
            self.queue.append(_error("invalid-codepoint"))
        elif c == ">":
            self._end_comment("incorrect-comment")
        elif c is None:
            self._end_comment("eof-in-comment")
        else:
            self.state = self.comment_state
        return True

    def comment_state(self) -> bool:
        c = self.stream.char()
        if c == "-":
            self.state = self.comment_end_dash_state
        elif c == "\x00":
            self.queue.append(_error("invalid-codepoint"))
        elif c is None:
            self._end_comment("eof-in-comment")
        else:
            self.stream.chars_until(("-", "\x00"))
        return True

    def comment_end_dash_state(self) -> bool:
        c = self.stream.char()
        if c == "-":
            self.state = self.comment_end_state
        elif c == "\x00":
            self.queue.append(_error("invalid-codepoint"))
            self.state = self.comment_state
        elif c is None:
            self._end_comment("eof-in-comment-end-dash")
        else:
            self.state = self.comment_state
        return True

    def comment_end_state(self) -> bool:
        c = self.stream.char()
        if c == ">":
            self._end_comment()
        elif c == "\x00":
            self.queue.append(_error("invalid-codepoint"))
            self.state = self.comment_state
        elif c == "!":
            self.queue.append(_error("unexpected-bang-after-double-dash-in-"
                                     "comment"))
            self.state = self.comment_end_bang_state
        elif c == "-":
            self.queue.append(_error("unexpected-dash-after-double-dash-in-"
                                     "comment"))
        elif c is None:
            self._end_comment("eof-in-comment-double-dash")
        else:
            self.queue.append(_error("unexpected-char-in-comment"))
            self.state = self.comment_state
        return True

    def comment_end_bang_state(self) -> bool:
        c = self.stream.char()
        if c == ">":
            self._end_comment()
        elif c == "-":
            self.state = self.comment_end_dash_state
        elif c == "\x00":
            self.queue.append(_error("invalid-codepoint"))
            self.state = self.comment_state
        elif c is None:
            self._end_comment("eof-in-comment-end-bang-state")
        else:
            self.state = self.comment_state
        return True

    def doctype_state(self) -> bool:
        """A DOCTYPE in a fragment is ignored; every DOCTYPE state ends it
        at the first ``>`` (or the end of the input), so only that end
        matters. Its parse errors come before its token and displace no
        held error that decides anything, so they are not kept."""
        s = self.stream
        s.chars_until(">")
        s.char()
        self.queue.append({"type": "Doctype"})
        self.state = self.data_state
        return True


def _bleach_tokens(tokenizer: _Tokenizer) -> Iterator[Dict]:
    """``BleachHTMLTokenizer.__iter__``: a parse error is held until the
    next token, which it may rewrite; an input that ends inside a tag
    yields the tag's source as text. (Its case for a text token holding a
    space after a bad attribute name is left out: with ``strip=True`` a
    stripped tag is empty or a newline, so that case cannot arise.)"""
    held = None
    stream = tokenizer.stream
    for token in tokenizer:
        if held is not None:
            if (held["data"] == "invalid-character-in-attribute-name"
                    and token["type"] in ("StartTag", "EndTag")
                    and token.get("data")):
                if token["type"] == "StartTag":
                    token["data"] = {
                        k: v for k, v in token["data"].items()
                        if '"' not in k and "'" not in k and "<" not in k}
                held = None
                yield token
            elif (held["data"] == "expected-closing-tag-but-got-char"
                  and token["data"].lower().strip() not in ALLOWED_TAGS):
                held = None
                yield {"type": "Characters", "data": stream.get_tag()}
            elif token["type"] == "ParseError":
                yield held
                held = token
            else:
                yield held
                yield token
                held = None
            continue
        if token["type"] == "ParseError":
            held = token
            continue
        yield token
    if held is not None:
        if held["data"] in ("eof-in-tag-name", "duplicate-attribute",
                            "eof-in-attribute-name",
                            "eof-in-attribute-value-no-quotes",
                            "expected-end-of-tag-but-got-eof"):
            yield {"type": "Characters", "data": stream.get_tag()}
        else:
            yield held


# ------------------------------------------------------------ tree builder

class _Element:
    __slots__ = ("name", "attrs", "children", "parent")

    def __init__(self, name: str, attrs: Dict[str, str]) -> None:
        self.name = name
        self.attrs = attrs
        self.children: List = []
        self.parent: Optional[_Element] = None

    def append(self, node) -> None:
        self.children.append(node)
        if isinstance(node, _Element):
            node.parent = self

    def remove(self, node) -> None:
        self.children.remove(node)
        node.parent = None

    def clone(self) -> "_Element":
        return _Element(self.name, dict(self.attrs))


class _Text:
    __slots__ = ("data",)

    def __init__(self, data: str) -> None:
        self.data = data


class _Comment:
    __slots__ = ()


def _index(items: List, node) -> int:
    for i, item in enumerate(items):
        if item is node:
            return i
    raise ValueError("node not in list")


def _contains(items: List, node) -> bool:
    return any(item is node for item in items)


def _remove(items: List, node) -> None:
    del items[_index(items, node)]


class _TreeBuilder:
    """html5lib's "in body" insertion mode for a fragment in a ``div``,
    for the tags that reach it. No scope marker is ever pushed: the tags
    that push one are all stripped before the tree sees them."""

    def __init__(self) -> None:
        self.root = _Element("html", {})
        self.open: List[_Element] = [self.root]
        self.formatting: List[_Element] = []

    # -- helpers

    def insert_element(self, name: str, attrs: Dict[str, str]) -> _Element:
        element = _Element(name, attrs)
        self.open[-1].append(element)
        self.open.append(element)
        return element

    def insert_text(self, data: str) -> None:
        parent = self.open[-1]
        if parent.children and isinstance(parent.children[-1], _Text):
            parent.children[-1].data += data
        else:
            parent.children.append(_Text(data))

    def in_scope(self, name: str, variant: str = "") -> bool:
        stops = {"": ("html",), "list": ("html", "ol", "ul")}[variant]
        for node in reversed(self.open):
            if node.name == name:
                return True
            if node.name in stops:
                return False
        return False

    def reconstruct(self) -> None:
        afe = self.formatting
        if not afe or _contains(self.open, afe[-1]):
            return
        i = len(afe) - 1
        while not _contains(self.open, afe[i]):
            if i == 0:
                i = -1
                break
            i -= 1
        while True:
            i += 1
            clone = afe[i].clone()
            element = self.insert_element(clone.name, clone.attrs)
            afe[i] = element
            if element is afe[-1]:
                break

    def in_formatting(self, name: str) -> Optional[_Element]:
        for node in reversed(self.formatting):
            if node.name == name:
                return node
        return None

    def implied_end_tags(self, exclude: Optional[str] = None) -> None:
        while self.open[-1].name == "li" and exclude != "li":
            self.open.pop()

    def add_formatting(self, name: str, attrs: Dict[str, str]) -> None:
        element = self.insert_element(name, attrs)
        matching = [node for node in reversed(self.formatting)
                    if node.name == name and node.attrs == element.attrs]
        if len(matching) == 3:
            _remove(self.formatting, matching[-1])
        self.formatting.append(element)

    # -- tokens

    def characters(self, data: str) -> None:
        if data == "\x00":
            return
        self.reconstruct()
        self.insert_text(data)

    def start_tag(self, name: str, attrs: Dict[str, str]) -> None:
        if name == "a":
            afe_a = self.in_formatting("a")
            if afe_a is not None:
                self.end_formatting("a")
                if _contains(self.open, afe_a):
                    _remove(self.open, afe_a)
                if _contains(self.formatting, afe_a):
                    _remove(self.formatting, afe_a)
            self.reconstruct()
            self.add_formatting(name, attrs)
        elif name in FORMATTING:
            self.reconstruct()
            self.add_formatting(name, attrs)
        elif name in BLOCKS:
            # "close a p element" never applies: p is stripped
            self.insert_element(name, attrs)
        elif name == "li":
            for node in reversed(self.open):
                if node.name == "li":
                    self.end_tag("li")
                    break
                if node.name in SPECIAL:
                    break
            self.insert_element(name, attrs)
        else:
            self.reconstruct()
            self.insert_element(name, attrs)

    def end_tag(self, name: str) -> None:
        if name in FORMATTING or name == "a":
            self.end_formatting(name)
        elif name in BLOCKS:
            if self.in_scope(name):
                self.implied_end_tags()
                node = self.open.pop()
                while node.name != name:
                    node = self.open.pop()
        elif name == "li":
            if self.in_scope("li", "list"):
                self.implied_end_tags(exclude="li")
                node = self.open.pop()
                while node.name != "li":
                    node = self.open.pop()
        else:
            self.end_other(name)

    def end_other(self, name: str) -> None:
        for node in reversed(self.open):
            if node.name == name:
                self.implied_end_tags(exclude=name)
                while self.open.pop() is not node:
                    pass
                break
            if node.name in SPECIAL:
                break

    def end_formatting(self, name: str) -> None:
        """The adoption agency algorithm, as html5lib runs it."""
        for _ in range(8):
            fe = self.in_formatting(name)
            if fe is None or (_contains(self.open, fe)
                              and not self.in_scope(fe.name)):
                self.end_other(name)
                return
            if not _contains(self.open, fe):
                _remove(self.formatting, fe)
                return
            if not self.in_scope(fe.name):
                return
            fe_index = _index(self.open, fe)
            furthest = next((node for node in self.open[fe_index:]
                             if node.name in SPECIAL), None)
            if furthest is None:
                node = self.open.pop()
                while node is not fe:
                    node = self.open.pop()
                _remove(self.formatting, node)
                return
            common = self.open[fe_index - 1]
            bookmark = _index(self.formatting, fe)
            last = node = furthest
            index = _index(self.open, node)
            for _inner in range(3):
                index -= 1
                node = self.open[index]
                if not _contains(self.formatting, node):
                    _remove(self.open, node)
                    continue
                if node is fe:
                    break
                if last is furthest:
                    bookmark = _index(self.formatting, node) + 1
                clone = node.clone()
                self.formatting[_index(self.formatting, node)] = clone
                self.open[_index(self.open, node)] = clone
                node = clone
                if last.parent is not None:
                    last.parent.remove(last)
                node.append(last)
                last = node
            if last.parent is not None:
                last.parent.remove(last)
            common.append(last)
            clone = fe.clone()
            clone.children = furthest.children
            for child in clone.children:
                if isinstance(child, _Element):
                    child.parent = clone
            furthest.children = []
            furthest.append(clone)
            _remove(self.formatting, fe)
            self.formatting.insert(bookmark, clone)
            _remove(self.open, fe)
            self.open.insert(_index(self.open, furthest) + 1, clone)

    def feed(self, tokens) -> _Element:
        for token in tokens:
            kind = token["type"]
            if kind in ("Characters", "SpaceCharacters"):
                self.characters(token["data"])
            elif kind == "StartTag":
                self.start_tag(token["name"], token["data"])
            elif kind == "EndTag":
                self.end_tag(token["name"])
            elif kind == "Comment":
                self.open[-1].children.append(_Comment())
        return self.root


# ------------------------------------------------- walk, filter, serialize

def _text_tokens(data: str) -> Iterator[tuple]:
    """html5lib's tree walker splits a text node into its leading spaces,
    its middle and its trailing spaces."""
    middle = data.lstrip(SPACE)
    left = data[:len(data) - len(middle)]
    if left:
        yield ("SpaceCharacters", left)
    core = middle.rstrip(SPACE)
    right = middle[len(core):]
    if core:
        yield ("Characters", core)
    if right:
        yield ("SpaceCharacters", right)


def _walk(root: _Element) -> Iterator[tuple]:
    stack = [iter(root.children)]
    names: List[str] = []
    while stack:
        node = next(stack[-1], None)
        if node is None:
            stack.pop()
            if names:
                yield ("EndTag", names.pop())
            continue
        if isinstance(node, _Text):
            if node.data:
                yield from _text_tokens(node.data)
        elif isinstance(node, _Comment):
            yield ("Comment",)
        else:
            attrs = {}
            for name, value in node.attrs.items():
                m = _NS_ATTR.match(name)
                attrs[(m.group(1), m.group(2)) if m else (None, name)] = value
            yield ("StartTag", node.name, attrs)
            stack.append(iter(node.children))
            names.append(node.name)


def _allowed_uri(value: str) -> bool:
    """bleach's ``sanitize_uri_value`` with its vendored ``urlsplit``'s
    scheme rule: True when the attribute stays."""
    uri = convert_entities(value)
    uri = re.sub(r"[`\000-\040\177-\240\s]+", "", uri)
    uri = re.sub(r"[^\x00-\x7f]", "", uri)
    uri = uri.lower()
    scheme = ""
    rest = uri
    i = uri.find(":")
    if i > 0:
        if uri[:i] == "http":
            scheme, rest = "http", uri[i + 1:]
        elif all(c in "abcdefghijklmnopqrstuvwxyz0123456789+-."
                 for c in uri[:i]):
            tail = uri[i + 1:]
            if not tail or any(c not in "0123456789" for c in tail):
                scheme, rest = uri[:i], tail
    if rest[:2] == "//":
        netloc = rest[2:]
        for delim in "/?#":
            j = netloc.find(delim)
            if j >= 0:
                netloc = netloc[:j]
        if ("[" in netloc) != ("]" in netloc):
            return False                # urlsplit raises: not allowed
    if scheme:
        return scheme in ALLOWED_PROTOCOLS
    if uri.startswith("#"):
        return True
    if ":" in uri and uri.split(":")[0] in ALLOWED_PROTOCOLS:
        return True
    return True        # no scheme: http(s) assumed, and both are allowed


def _merged(tokens) -> Iterator[tuple]:
    """``merge_characters``: runs of text tokens joined, and one text token
    (empty or not) at the end."""
    run: List[str] = []
    for token in tokens:
        if token[0] == "Characters":
            run.append(token[1])
            continue
        if run:
            yield ("Characters", "".join(run))
            run = []
        yield token
    yield ("Characters", "".join(run))


def _filtered(tokens) -> Iterator[tuple]:
    """``BleachSanitizerFilter``: tags and attributes outside the allow
    lists dropped, comments dropped, text runs cleaned."""
    for token in tokens:
        kind = token[0]
        if kind in ("StartTag", "EndTag"):
            name = token[1]
            if name not in ALLOWED_TAGS:
                continue
            if kind == "EndTag":
                yield token
                continue
            attrs = {}
            allowed = ALLOWED_ATTRIBUTES.get(name, ())
            for key, value in token[2].items():
                if key[1] not in allowed:
                    continue
                if key in URI_ATTRS and not _allowed_uri(value):
                    continue
                attrs[key] = value
            yield ("StartTag", name, attrs)
        elif kind == "Characters":
            data = _INVISIBLE.sub("?", token[1])
            if "&" not in data:
                yield ("Characters", data)
                continue
            for part in _amp_parts(data):
                if not part:
                    continue
                if part.startswith("&"):
                    entity = match_entity(part)
                    if entity is not None:
                        yield (("Characters", "&") if entity == "amp"
                               else ("Entity", entity))
                        if part[len(entity) + 2:]:
                            yield ("Characters", part[len(entity) + 2:])
                        continue
                yield ("Characters", part)
        elif kind == "SpaceCharacters":
            yield token


def _escape(text: str) -> str:
    return text.replace("&", "&amp;").replace("<", "&lt;").replace(
        ">", "&gt;")


def _serializer_tokens(tokens) -> Iterator[str]:
    """html5lib's serializer with bleach's options, token for token."""
    for token in tokens:
        kind = token[0]
        if kind == "SpaceCharacters":
            yield token[1]
        elif kind == "Characters":
            yield _escape(token[1])
        elif kind == "Entity":
            yield f"&{token[1]};"
        elif kind == "StartTag":
            yield f"<{token[1]}"
            for (_, name), value in token[2].items():
                yield " "
                yield name
                yield "="
                value = value.replace("&", "&amp;").replace("<", "&lt;")
                quote = '"'
                if "'" in value and '"' not in value:
                    quote = '"'
                elif '"' in value and "'" not in value:
                    quote = "'"
                value = (value.replace("'", "&#39;") if quote == "'"
                         else value.replace('"', "&quot;"))
                yield quote
                yield value
                yield quote
            yield ">"
        else:
            yield f"</{token[1]}>"


def _escape_base_amp(stoken: str) -> Iterator[str]:
    stoken = stoken.replace("&amp;", "&")
    for part in _amp_parts(stoken):
        if not part:
            continue
        if part.startswith("&"):
            entity = match_entity(part)
            if entity is not None and convert_entity(entity) is not None:
                yield f"&{entity};"
                if part[len(entity) + 2:]:
                    yield part[len(entity) + 2:]
                continue
        yield part.replace("&", "&amp;")


def _bleach_serialize(stokens) -> Iterator[str]:
    """``BleachHTMLSerializer.serialize``: after an ``=`` inside what it
    takes for a tag, a token other than ``"`` has its bare ampersands
    re-escaped and its recognised references kept."""
    in_tag = False
    after_equals = False
    for stoken in stokens:
        if in_tag:
            if stoken == ">":
                in_tag = False
            elif after_equals:
                if stoken != '"':
                    yield from _escape_base_amp(stoken)
                    after_equals = False
                    continue
            elif stoken == "=":
                after_equals = True
            yield stoken
        else:
            if stoken.startswith("<"):
                in_tag = True
            yield stoken


def clean(text: str) -> str:
    """``bleach.clean(text, strip=True)`` with bleach's default tags,
    attributes and protocols."""
    if not isinstance(text, str):
        raise TypeError(f"argument cannot be of {type(text).__name__!r} "
                        f"type, must be of text type")
    if not text:
        return ""
    root = _TreeBuilder().feed(_bleach_tokens(_Tokenizer(text)))
    return "".join(_bleach_serialize(_serializer_tokens(
        _merged(_filtered(_walk(root))))))
