"""Tokenizers for the port's serving engine.

Port of ``generativeaiexamples_tpu/engine/tokenizer.py``: the byte
tokenizer, :class:`HFTokenizer` (a wrapper over the ``tokenizers``
package, imported only when one is made), the streaming detokenizer and
:func:`get_tokenizer`, which reads a checkpoint directory's
``tokenizer.json`` through the port's native BPE core
(``engine/native_tokenizer.py``). The machine the port serves on has no
``tokenizers`` package, so the native core is what serves there.
"""

from __future__ import annotations

import logging
import os
from typing import List, Protocol, Sequence

from generativeaiexamples_tpu_torch.engine.native_tokenizer import (
    NativeBPETokenizer, UnsupportedTokenizer)

logger = logging.getLogger(__name__)


class Tokenizer(Protocol):
    vocab_size: int
    bos_id: int
    eos_id: int
    pad_id: int

    def encode(self, text: str, add_bos: bool = False) -> List[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...
    def apply_chat_template(self, messages: Sequence[dict]) -> List[int]: ...


class ByteTokenizer:
    """UTF-8 byte tokenizer: ids 0..255 are bytes; specials appended after.
    Ids past 258 (a larger model vocabulary) decode to nothing."""

    # ids 0..255 are the bytes themselves (grammar.token_byte_table)
    byte_ids = True

    def __init__(self) -> None:
        self.bos_id = 256
        self.eos_id = 257
        self.pad_id = 258
        self.vocab_size = 259

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")

    def apply_chat_template(self, messages: Sequence[dict]) -> List[int]:
        parts = []
        for m in messages:
            parts.append(f"<|{m.get('role', 'user')}|>\n{m.get('content', '')}\n")
        parts.append("<|assistant|>\n")
        return self.encode("".join(parts), add_bos=True)


class HFTokenizer:
    """Wrapper over a local HuggingFace ``tokenizers`` JSON file."""

    def __init__(self, path: str) -> None:
        from tokenizers import Tokenizer as _Tok

        self._tok = _Tok.from_file(path)
        self.vocab_size = self._tok.get_vocab_size()
        self.bos_id = self._special("<|begin_of_text|>", "<s>", "<bos>")
        self.eos_id = self._special("<|eot_id|>", "</s>", "<eos>",
                                    "<|end_of_text|>")
        self.pad_id = self.eos_id

    def _special(self, *names: str) -> int:
        vocab = self._tok.get_vocab()
        for n in names:
            if n in vocab:
                return vocab[n]
        return 0

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False).ids
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    def apply_chat_template(self, messages: Sequence[dict]) -> List[int]:
        # Llama-3 instruct convention: header tokens around each role block
        ids: List[int] = [self.bos_id]
        for m in messages:
            ids += self.encode(f"<|start_header_id|>{m.get('role', 'user')}"
                               f"<|end_header_id|>\n\n{m.get('content', '')}"
                               f"<|eot_id|>")
        ids += self.encode("<|start_header_id|>assistant<|end_header_id|>\n\n")
        return ids


class IncrementalDetokenizer:
    """Streaming detokenizer: feed ids, get printable text deltas. Trailing
    bytes of an incomplete UTF-8 sequence are held back, so a delta never
    ends mid-codepoint."""

    def __init__(self, tokenizer: Tokenizer) -> None:
        self._tok = tokenizer
        self._pending: List[int] = []
        self._pending_emitted = 0  # chars of decode(_pending) already streamed

    def push(self, token_id: int) -> str:
        self._pending.append(token_id)
        text = self._tok.decode(self._pending)
        safe = len(text)
        while safe > 0 and text[safe - 1] == "�":   # partial UTF-8 tail
            safe -= 1
        delta = text[self._pending_emitted:safe]
        if safe == len(text):
            self._pending = []
            self._pending_emitted = 0
        else:
            self._pending_emitted = safe
        return delta

    def flush(self) -> str:
        text = self._tok.decode(self._pending)
        delta = text[self._pending_emitted:]
        self._pending = []
        self._pending_emitted = 0
        return delta


def get_tokenizer(checkpoint_dir: str = "") -> Tokenizer:
    """The tokenizer of ``checkpoint_dir``, or the byte tokenizer without
    one.

    The directory's ``tokenizer.json`` is served by the native BPE core
    first, as in the reference. Only a shape that the core refuses (a
    normalizer that changes text, an unknown split pattern, a model other
    than BPE) goes to :class:`HFTokenizer`, with the refusal logged, and
    only where ``tokenizers`` is importable; otherwise it raises, naming
    the shape. A core that fails to build raises and gives way to
    nothing. A directory without ``tokenizer.json`` raises: the reference
    falls back to the byte tokenizer with a warning, which garbles a real
    vocabulary, and the port refuses instead.
    """
    if not checkpoint_dir:
        return ByteTokenizer()
    path = os.path.join(checkpoint_dir, "tokenizer.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"checkpoint {checkpoint_dir!r} has no tokenizer.json; the byte "
            f"tokenizer would garble its vocabulary, so it is refused")
    try:
        return NativeBPETokenizer(path)
    except UnsupportedTokenizer as exc:
        refused = exc
    try:
        tok = HFTokenizer(path)
    except ImportError as exc:
        raise UnsupportedTokenizer(
            f"{path}: the native BPE core does not implement this tokenizer "
            f"({refused}) and the tokenizers package is not installed"
        ) from exc
    logger.info("native tokenizer refuses %s (%s); using HFTokenizer", path,
                refused)
    return tok
