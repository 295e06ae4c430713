"""ctypes bindings for the port's byte-level BPE core (``native/bpe_tokenizer.cpp``).

Port of ``generativeaiexamples_tpu/engine/native_tokenizer.py``. The
serving machine has no ``tokenizers`` package, so this is how the port
reads a checkpoint's ``tokenizer.json``.

Split of labor: Python does everything cold — parse ``tokenizer.json``,
invert the GPT-2 byte<->unicode alphabet so the C++ side sees raw bytes,
resolve merge rules to id triples, build \\p{L} / \\p{N} bitsets from
unicodedata, handle added special tokens — and C++ does everything hot
(UTF-8 scan, pre-tokenization, the BPE merge loop).

The core is built from the package's own source with the host C++
compiler at first use, into ``build/torch_kernels/`` (beside the CUDA
kernels), named by a hash of the source and the flags. A failed build
raises with the compiler's output: it never gives way to another
tokenizer. A ``tokenizer.json`` whose shape the core does not implement (a
model other than BPE, a normalizer that changes text, an unknown split
pattern) raises :class:`UnsupportedTokenizer`, and ``get_tokenizer``
decides what serves it.

Unlike the reference, the core honours ``model.ignore_merges`` (Llama-3
sets it): a pre-token that is itself a vocabulary entry encodes to that
entry, as HF ``tokenizers`` does (ROADMAP §C, C6).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Sequence

from generativeaiexamples_tpu_torch.core.runtime import BUILD_DIR

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_PATH = os.path.join(_PKG_DIR, "native", "bpe_tokenizer.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_MAX_CP = 0x110000
_BITS_LEN = _MAX_CP // 8


class UnsupportedTokenizer(ValueError):
    """A ``tokenizer.json`` shape the native core does not implement."""


def lib_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SRC_PATH, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libbpe_tokenizer_{h.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("native tokenizer: no host C++ compiler (g++) to "
                           f"build {SRC_PATH}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    # a per-process temporary renamed into place: concurrent first builds
    # never load a half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, SRC_PATH, "-o", tmp],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"native tokenizer build failed (rc "
                           f"{proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)


def load_native_lib() -> ctypes.CDLL:
    """The native core, built on first use; raises if it cannot build."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        out = lib_path()
        if not os.path.exists(out):
            _build(out)
        lib = ctypes.CDLL(out)
        lib.bpe_create.restype = ctypes.c_void_p
        lib.bpe_create.argtypes = [
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32]
        lib.bpe_free.restype = None
        lib.bpe_free.argtypes = [ctypes.c_void_p]
        lib.bpe_encode.restype = ctypes.c_int32
        lib.bpe_encode.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.bpe_decode.restype = ctypes.c_int32
        lib.bpe_decode.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32]
        _lib = lib
        return _lib


def bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 byte → printable-codepoint alphabet (every byte-level BPE
    vocab is written in it)."""
    bs = (list(range(ord("!"), ord("~") + 1)) +
          list(range(ord("¡"), ord("¬") + 1)) +
          list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


_B2U = bytes_to_unicode()
_U2B = {u: b for b, u in _B2U.items()}


def _token_to_bytes(token: str) -> Optional[bytes]:
    """Vocab entry (byte-alphabet domain) → raw bytes; None if it contains
    characters outside the alphabet (e.g. an added special in the vocab)."""
    out = bytearray()
    for ch in token:
        b = _U2B.get(ch)
        if b is None:
            return None
        out.append(b)
    return bytes(out)


# The two pre-tokenization patterns the native scanner implements. Anything
# else raises: silently applying the wrong split would encode ids the model
# was never trained on.
_GPT2_MODE, _LLAMA3_MODE = 0, 1
_LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                   r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                   r"|\s+(?!\S)|\s+")
_GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                 r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


def _normalizer_is_noop(norm: dict) -> bool:
    """True only for normalizer configs that provably change nothing: an
    empty Sequence, or a Sequence of empty Sequences. Real normalizers
    (NFC/NFD/Replace/...) make the caller raise."""
    if norm.get("type") == "Sequence":
        return all(_normalizer_is_noop(n)
                   for n in norm.get("normalizers", []) or [])
    return False


def _detect_pre_tokenizer(pre: dict) -> tuple:
    """Map a tokenizer.json pre_tokenizer config onto a native scanner mode.

    Supported shapes:
      * ByteLevel with its built-in regex (use_regex != false) → GPT-2 mode;
      * Sequence([Split(known pattern), ByteLevel(use_regex=false)]) →
        the pattern decides (Llama-3 checkpoints ship exactly this shape).
    Returns (mode, add_prefix_space); raises UnsupportedTokenizer otherwise.
    """
    pres = (pre.get("pretokenizers", []) if pre.get("type") == "Sequence"
            else [pre])
    byte_levels = [p for p in pres if p.get("type") == "ByteLevel"]
    if not byte_levels:
        raise UnsupportedTokenizer(
            "only ByteLevel pre-tokenization is supported")
    aps = bool(byte_levels[0].get("add_prefix_space", False))
    splits = [p for p in pres if p.get("type") == "Split"]
    others = [p for p in pres if p.get("type") not in ("ByteLevel", "Split")]
    if others:
        raise UnsupportedTokenizer(
            f"unsupported pre-tokenizers: {[p.get('type') for p in others]}")
    if splits:
        if len(splits) > 1 or byte_levels[0].get("use_regex", True):
            raise UnsupportedTokenizer(
                "unsupported Split/ByteLevel combination")
        pattern = splits[0].get("pattern", {})
        pattern = pattern.get("Regex") if isinstance(pattern, dict) else None
        if pattern == _LLAMA3_PATTERN:
            return _LLAMA3_MODE, aps
        if pattern == _GPT2_PATTERN:
            return _GPT2_MODE, aps
        raise UnsupportedTokenizer(f"unrecognized split pattern {pattern!r}")
    if byte_levels[0].get("use_regex", True) is False:
        raise UnsupportedTokenizer(
            "ByteLevel without a split regex is unsupported")
    return _GPT2_MODE, aps


_bitsets_lock = threading.Lock()
_bitsets_cache: Optional[tuple] = None


def _unicode_bitsets() -> tuple:
    """(letter_bits, number_bits): 1 bit per codepoint, \\p{L} and \\p{N}
    per unicodedata. Built once per process, and cached on disk under
    ``build/torch_kernels/`` for later processes."""
    global _bitsets_cache
    with _bitsets_lock:
        if _bitsets_cache is not None:
            return _bitsets_cache
        import unicodedata
        cache = os.path.join(
            BUILD_DIR, f"unicode_bits_{unicodedata.unidata_version}.bin")
        if os.path.exists(cache):
            with open(cache, "rb") as fh:
                blob = fh.read()
            if len(blob) == 2 * _BITS_LEN:
                _bitsets_cache = (blob[:_BITS_LEN], blob[_BITS_LEN:])
                return _bitsets_cache
        letters = bytearray(_BITS_LEN)
        numbers = bytearray(_BITS_LEN)
        for cp in range(_MAX_CP):
            cat = unicodedata.category(chr(cp))
            if cat[0] == "L":
                letters[cp >> 3] |= 1 << (cp & 7)
            elif cat[0] == "N":
                numbers[cp >> 3] |= 1 << (cp & 7)
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{cache}.{os.getpid()}.tmp"
        with open(tmp, "wb") as fh:
            fh.write(bytes(letters) + bytes(numbers))
        os.replace(tmp, cache)
        _bitsets_cache = (bytes(letters), bytes(numbers))
        return _bitsets_cache


class NativeBPETokenizer:
    """Byte-level BPE over the native core; the ``Tokenizer`` protocol."""

    def __init__(self, path: str) -> None:
        with open(path, "r", encoding="utf-8") as fh:
            spec = json.load(fh)
        model = spec.get("model", {})
        if model.get("type") != "BPE":
            raise UnsupportedTokenizer(
                f"unsupported tokenizer model {model.get('type')!r}")
        norm = spec.get("normalizer")
        if norm is not None and not _normalizer_is_noop(norm):
            # Qwen-style configs pair ByteLevel BPE with an NFC normalizer;
            # encoding without it would silently diverge from HF ids
            raise UnsupportedTokenizer(
                f"unsupported normalizer {norm.get('type')!r}")
        self._mode, self._add_prefix_space = _detect_pre_tokenizer(
            spec.get("pre_tokenizer") or {})
        self.ignore_merges = bool(model.get("ignore_merges", False))
        vocab: Dict[str, int] = model["vocab"]
        byte_init = []
        for b in range(256):
            tid = vocab.get(_B2U[b])
            if tid is None:
                raise UnsupportedTokenizer(
                    f"vocab lacks single-byte token for {b:#x}")
            byte_init.append(tid)
        self.vocab_size = max(vocab.values()) + 1

        # added/special tokens: handled Python-side (split before encode,
        # skipped in decode)
        self._special_ids: Dict[str, int] = {}
        for tok in spec.get("added_tokens", []):
            self._special_ids[tok["content"]] = tok["id"]
            self.vocab_size = max(self.vocab_size, tok["id"] + 1)
        self._id_is_special = set(self._special_ids.values())
        self._special_re = (re.compile("|".join(
            re.escape(s) for s in sorted(self._special_ids, key=len,
                                         reverse=True)))
            if self._special_ids else None)

        self.bos_id = self._pick("<|begin_of_text|>", "<s>", "<bos>",
                                 "<|endoftext|>")
        self.eos_id = self._pick("<|eot_id|>", "</s>", "<eos>",
                                 "<|end_of_text|>", "<|endoftext|>")
        self.pad_id = self.eos_id

        self._lib = load_native_lib()
        # --- vocab as raw-byte strings for the native core ---------------
        tok_bytes = [b""] * self.vocab_size
        for tok, tid in vocab.items():
            raw = _token_to_bytes(tok)
            if raw is not None:
                tok_bytes[tid] = raw
        lens = (ctypes.c_int32 * self.vocab_size)(
            *(len(b) for b in tok_bytes))
        blob = b"".join(tok_bytes)
        blob_arr = (ctypes.c_uint8 * max(len(blob), 1)).from_buffer_copy(
            blob or b"\0")

        # --- merges resolved to id triples --------------------------------
        keys, merged = [], []
        for rule in model.get("merges", []):
            a, b = rule.split(" ", 1) if isinstance(rule, str) else rule
            ia, ib, iab = vocab.get(a), vocab.get(b), vocab.get(a + b)
            if ia is None or ib is None or iab is None:
                continue
            keys.append((ia & 0xFFFFFFFF) << 32 | (ib & 0xFFFFFFFF))
            merged.append(iab)
        n_merges = len(keys)
        keys_arr = (ctypes.c_uint64 * max(n_merges, 1))(*(keys or [0]))
        merged_arr = (ctypes.c_int32 * max(n_merges, 1))(*(merged or [0]))
        init_arr = (ctypes.c_int32 * 256)(*byte_init)

        letters, numbers = _unicode_bitsets()
        lbits = (ctypes.c_uint8 * _BITS_LEN).from_buffer_copy(letters)
        nbits = (ctypes.c_uint8 * _BITS_LEN).from_buffer_copy(numbers)

        self._handle = self._lib.bpe_create(
            self.vocab_size, lens, blob_arr, n_merges, keys_arr, merged_arr,
            init_arr, lbits, nbits, _BITS_LEN, self._mode,
            int(self.ignore_merges))
        if not self._handle:
            raise RuntimeError("bpe_create failed")

    def _pick(self, *names: str) -> int:
        for n in names:
            if n in self._special_ids:
                return self._special_ids[n]
        return 0

    def __del__(self) -> None:
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.bpe_free(handle)
            self._handle = None

    # ------------------------------------------------------------- protocol

    def _encode_plain(self, text: str) -> List[int]:
        if not text:
            return []
        if self._add_prefix_space and not text.startswith(" "):
            text = " " + text
        data = text.encode("utf-8")
        cap = len(data) + 8      # ids never outnumber bytes
        out = (ctypes.c_int32 * cap)()
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        n = self._lib.bpe_encode(self._handle, buf, len(data), out, cap)
        return list(out[:n])

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids: List[int] = [self.bos_id] if add_bos else []
        if self._special_re is None:
            return ids + self._encode_plain(text)
        pos = 0
        for m in self._special_re.finditer(text):
            ids += self._encode_plain(text[pos:m.start()])
            ids.append(self._special_ids[m.group()])
            pos = m.end()
        ids += self._encode_plain(text[pos:])
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        plain = [i for i in ids if i not in self._id_is_special]
        if not plain:
            return ""
        arr = (ctypes.c_int32 * len(plain))(*plain)
        cap = 8 * len(plain)
        out = (ctypes.c_uint8 * cap)()
        n = self._lib.bpe_decode(self._handle, arr, len(plain), out, cap)
        if n > cap:
            out = (ctypes.c_uint8 * n)()
            n = self._lib.bpe_decode(self._handle, arr, len(plain), out, n)
        return bytes(out[:n]).decode("utf-8", errors="replace")

    def apply_chat_template(self, messages: Sequence[dict]) -> List[int]:
        """The Llama-3 instruct form: a header around each role's message,
        each message ended by ``<|eot_id|>``, then the assistant's header."""
        ids: List[int] = [self.bos_id]
        for m in messages:
            ids += self.encode(f"<|start_header_id|>{m.get('role', 'user')}"
                               f"<|end_header_id|>\n\n{m.get('content', '')}"
                               f"<|eot_id|>")
        ids += self.encode("<|start_header_id|>assistant<|end_header_id|>\n\n")
        return ids
