"""The port's native BPE core against HF ``tokenizers`` and the reference's.

On byte-level BPE vocabularies trained by ``tokenizers`` in GPT-2 mode and
in Llama-3 mode (``Split`` + ``ByteLevel(use_regex=False)``), built as the
reference's ``tests/test_native_tokenizer.py`` builds them, the port's
``NativeBPETokenizer`` encodes as HF ``tokenizers`` and as the
reference's core, round-trips, splits out and skips specials, and gives
the reference's chat template ids. It refuses the shapes it does not
implement, and ``get_tokenizer`` takes the native core first, falls back
to ``HFTokenizer`` only for a refused shape where ``tokenizers`` imports,
and raises otherwise.

C6: with ``model.ignore_merges`` (set by Llama-3's ``tokenizer.json``) a
pre-token that is a vocabulary entry encodes to that entry. The port
follows HF ``tokenizers``, the oracle the reference's tests name; the
reference's core ignores the flag, and a test shows that it still does.

The smoke's synthetic Llama-3 ``tokenizer.json`` (``chip_smoke
.llama3_tokenizer_json``) loads in HF ``tokenizers`` and encodes a unicode
corpus as the port does.
"""

import builtins
import json
import logging
import os
import sys

import pytest

from generativeaiexamples_tpu.engine import native_tokenizer as ref_native
from generativeaiexamples_tpu.engine.tokenizer import (
    HFTokenizer as RefHFTokenizer)

from generativeaiexamples_tpu_torch.engine import native_tokenizer as nt
from generativeaiexamples_tpu_torch.engine.native_tokenizer import (
    NativeBPETokenizer, UnsupportedTokenizer)
from generativeaiexamples_tpu_torch.engine.tokenizer import (
    ByteTokenizer, HFTokenizer, get_tokenizer)

tokenizers = pytest.importorskip("tokenizers")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CORPUS = [
    "The quick brown fox jumps over the lazy dog.",
    "I'll say it's done — they've gone; we'd better not.",
    "Pi is 3.14159 and 2^10 = 1024, about 1,000.",
    "naïve café über Zürich — ⚡ emoji ☃ snow",
    "  leading spaces   and\ttabs\nand\r\nnewlines   ",
    "def f(x):\n    return x * 2  # comment",
    "MixedCASE WORDS and lowercase and UPPER",
    "日本語のテキストと中文文本 mixed with English",
]
EXTRA = ["", " ", "a", "  ", "…—…", "'", "''s", "x'll y'd",
         "1234567 digits split by threes 99 1000000",
         "I'LL SHOUT'S case-insensitive 'RE contractions",
         "punct!!!\n\nwith newlines\r\n  \n mixed   runs",
         "tab\tbefore word and nbsp", "\n", "  \n  ", "a\nb", "... \n",
         "emoji 🚀🔥👍🏽 and 𝔘𝔫𝔦𝔠𝔬𝔡𝔢"]
SPECIALS = ["<|begin_of_text|>", "<|eot_id|>", "<|start_header_id|>",
            "<|end_header_id|>"]
MESSAGES = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "what's 2+2? ça va 日本"}]


def _train(path, llama3):
    from tokenizers import (Regex, Tokenizer, decoders, models,
                            pre_tokenizers, trainers)
    tok = Tokenizer(models.BPE())
    if llama3:
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(nt._LLAMA3_PATTERN),
                                 behavior="isolated"),
            pre_tokenizers.ByteLevel(add_prefix_space=False,
                                     use_regex=False)])
    else:
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=600, special_tokens=SPECIALS,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(CORPUS * 30, trainer)
    tok.save(path)
    return tok


@pytest.fixture(scope="module", params=["gpt2", "llama3"])
def trained(request, tmp_path_factory):
    """(path, HF tokenizer) trained in GPT-2 or Llama-3 mode."""
    d = tmp_path_factory.mktemp(request.param)
    path = str(d / "tokenizer.json")
    return path, _train(path, request.param == "llama3")


def _with_ignore_merges(path, dst, flag=True):
    spec = json.load(open(path))
    spec["model"]["ignore_merges"] = flag
    dst.write_text(json.dumps(spec))
    return str(dst)


def test_encode_equals_hf_and_reference(trained):
    path, hf = trained
    port, ref = NativeBPETokenizer(path), ref_native.NativeBPETokenizer(path)
    assert port._mode == ref._mode == (1 if "llama3" in path else 0)
    for text in CORPUS + EXTRA:
        want = hf.encode(text, add_special_tokens=False).ids
        assert port.encode(text) == want, text
        assert ref.encode(text) == want, text


def test_decode_round_trip(trained):
    path, hf = trained
    port = NativeBPETokenizer(path)
    for text in CORPUS + EXTRA:
        ids = port.encode(text)
        assert port.decode(ids) == text
        assert port.decode(ids) == hf.decode(ids, skip_special_tokens=True)


def test_specials_split_and_skipped(trained):
    path, hf = trained
    port = NativeBPETokenizer(path)
    text = "<|start_header_id|>user<|end_header_id|>\n\nhi<|eot_id|>"
    ids = port.encode(text)
    assert ids == hf.encode(text, add_special_tokens=False).ids
    assert port._special_ids["<|start_header_id|>"] in ids
    assert port.decode(ids) == "user\n\nhi"
    assert (port.bos_id, port.eos_id) == (
        hf.token_to_id("<|begin_of_text|>"), hf.token_to_id("<|eot_id|>"))


def test_chat_template_ids_equal_reference(trained):
    path, _ = trained
    want = ref_native.NativeBPETokenizer(path).apply_chat_template(MESSAGES)
    assert NativeBPETokenizer(path).apply_chat_template(MESSAGES) == want
    assert RefHFTokenizer(path).apply_chat_template(MESSAGES) == want
    assert HFTokenizer(path).apply_chat_template(MESSAGES) == want


def test_long_document(trained):
    path, hf = trained
    doc = "\n\n".join(CORPUS) * 50 + "=" * 20_000
    assert NativeBPETokenizer(path).encode(doc) == hf.encode(
        doc, add_special_tokens=False).ids


def test_port_honours_ignore_merges(trained, tmp_path):
    """A trained vocabulary with ``ignore_merges`` set: the port encodes
    as HF ``tokenizers``."""
    path, _ = trained
    p = _with_ignore_merges(path, tmp_path / "tokenizer.json")
    hf = tokenizers.Tokenizer.from_file(p)
    port = NativeBPETokenizer(p)
    assert port.ignore_merges
    for text in CORPUS + EXTRA:
        assert port.encode(text) == hf.encode(
            text, add_special_tokens=False).ids, text


def _c6_tokenizer(tmp_path, ignore_merges):
    """The 256 byte symbols plus ``bc``, ``ab`` and ``abc``, merged
    ``b c``, ``a b``, ``ab c`` in that order."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    b2u = nt.bytes_to_unicode()
    vocab = {b2u[b]: i for i, b in enumerate(range(256))}
    for t in ("bc", "ab", "abc"):
        vocab[t] = len(vocab)
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[("b", "c"), ("a", "b"),
                                                    ("ab", "c")],
                               ignore_merges=ignore_merges))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    path = str(tmp_path / f"c6_{ignore_merges}.json")
    tok.save(path)
    return path, tok, vocab


@pytest.mark.parametrize("ignore_merges", [True, False])
def test_c6_port_equals_hf(tmp_path, ignore_merges):
    path, hf, vocab = _c6_tokenizer(tmp_path, ignore_merges)
    port = NativeBPETokenizer(path)
    want = [vocab["abc"]] if ignore_merges else [vocab["a"], vocab["bc"]]
    assert hf.encode("abc").ids == want
    assert port.encode("abc") == want
    assert port.encode("abc abc xabc") == hf.encode("abc abc xabc").ids


def test_reference_ignores_ignore_merges(tmp_path):
    """C6, the reference's divergence: with ``ignore_merges`` HF gives
    ``[abc]`` and the reference's core ``[a, bc]``, as without the flag.
    The reference is not edited; this passes while it stays so."""
    path, hf, vocab = _c6_tokenizer(tmp_path, True)
    assert hf.encode("abc").ids == [vocab["abc"]]
    assert ref_native.NativeBPETokenizer(path).encode("abc") == [
        vocab["a"], vocab["bc"]]


# ------------------------------------------------------------- refusals

def test_unknown_model_type_raises(tmp_path):
    p = tmp_path / "tokenizer.json"
    p.write_text(json.dumps({"model": {"type": "WordPiece", "vocab": {}}}))
    with pytest.raises(UnsupportedTokenizer, match="unsupported"):
        NativeBPETokenizer(str(p))


def test_normalizer_raises_and_noop_is_accepted(trained, tmp_path):
    path, _ = trained
    spec = json.load(open(path))
    spec["normalizer"] = {"type": "NFC"}
    p = tmp_path / "tokenizer.json"
    p.write_text(json.dumps(spec))
    with pytest.raises(UnsupportedTokenizer, match="normalizer"):
        NativeBPETokenizer(str(p))
    spec["normalizer"] = {"type": "Sequence", "normalizers": []}
    p.write_text(json.dumps(spec))
    NativeBPETokenizer(str(p))


def _llama3_with_pattern(trained_path, tmp_path, pattern):
    spec = json.load(open(trained_path))
    spec["pre_tokenizer"]["pretokenizers"][0]["pattern"]["Regex"] = pattern
    d = tmp_path / "ckpt"
    d.mkdir()
    (d / "tokenizer.json").write_text(json.dumps(spec))
    return str(d)


@pytest.fixture
def llama3_path(tmp_path):
    path = str(tmp_path / "tokenizer.json")
    _train(path, llama3=True)
    return path


def test_unrecognized_split_pattern_raises(llama3_path, tmp_path):
    d = _llama3_with_pattern(llama3_path, tmp_path, r"\w+")
    with pytest.raises(UnsupportedTokenizer,
                       match="unrecognized split pattern"):
        NativeBPETokenizer(os.path.join(d, "tokenizer.json"))


# -------------------------------------------------------- get_tokenizer

def test_get_tokenizer_prefers_native(trained):
    path, _ = trained
    assert isinstance(get_tokenizer(os.path.dirname(path)),
                      NativeBPETokenizer)
    assert isinstance(get_tokenizer(""), ByteTokenizer)


def test_get_tokenizer_falls_back_to_hf_for_a_refused_shape(
        llama3_path, tmp_path, caplog):
    d = _llama3_with_pattern(llama3_path, tmp_path, r"\w+")
    with caplog.at_level(logging.INFO):
        tok = get_tokenizer(d)
    assert isinstance(tok, HFTokenizer)
    assert "unrecognized split pattern" in caplog.text


def test_get_tokenizer_raises_without_tokenizers(llama3_path, tmp_path,
                                                 monkeypatch):
    d = _llama3_with_pattern(llama3_path, tmp_path, r"\w+")
    real_import = builtins.__import__

    def no_tokenizers(name, *args, **kw):
        if name.split(".")[0] == "tokenizers":
            raise ImportError("no tokenizers here")
        return real_import(name, *args, **kw)

    monkeypatch.delitem(sys.modules, "tokenizers", raising=False)
    monkeypatch.setattr(builtins, "__import__", no_tokenizers)
    with pytest.raises(UnsupportedTokenizer,
                       match="unrecognized split pattern.*not installed"):
        get_tokenizer(d)


def test_get_tokenizer_raises_without_tokenizer_json(tmp_path):
    with pytest.raises(FileNotFoundError, match="no tokenizer.json"):
        get_tokenizer(str(tmp_path))


def test_failed_build_raises_and_falls_back_to_nothing(trained, tmp_path,
                                                       monkeypatch):
    path, _ = trained
    broken = tmp_path / "bpe_tokenizer.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(nt, "SRC_PATH", str(broken))
    monkeypatch.setattr(nt, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(nt, "_lib", None)
    with pytest.raises(RuntimeError, match="native tokenizer build failed"):
        get_tokenizer(os.path.dirname(path))


# ------------------------------------------- the smoke's Llama-3 tokenizer

UNICODE_CORPUS = CORPUS + EXTRA + [
    "Résumé en français : le cache de préfixes — naïve café, señor.",
    "日本語と中文：分页缓存如何在请求之间共享页面？",
    "Emoji check 🚀🔥👍🏽 with symbols ⚡☃ — then say done.",
    "The paged KV cache keeps every request's keys and values in pages.",
]


def test_smoke_llama3_tokenizer_loads_in_hf_and_encodes_as_port(tmp_path):
    sys.path.insert(0, ROOT)
    import chip_smoke
    n_merges = 3000
    spec = chip_smoke.llama3_tokenizer_json(
        chip_smoke.markdown_corpus() + "\n".join(UNICODE_CORPUS),
        n_merges=n_merges, seed=0, learned=400)
    model = spec["model"]
    assert model["ignore_merges"] and len(model["merges"]) == n_merges
    assert len(model["vocab"]) == 256 + n_merges
    assert len(set(model["vocab"].values())) == 256 + n_merges
    names = {t["content"]: t["id"] for t in spec["added_tokens"]}
    assert len(names) == 256 and names["<|begin_of_text|>"] == 256 + n_merges
    assert names["<|eot_id|>"] == 256 + n_merges + 9
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(spec, ensure_ascii=False))
    hf = tokenizers.Tokenizer.from_file(str(path))
    port = get_tokenizer(str(tmp_path))
    assert isinstance(port, NativeBPETokenizer) and port._mode == 1
    assert port.vocab_size == hf.get_vocab_size() == 512 + n_merges
    for text in UNICODE_CORPUS:
        ids = port.encode(text)
        assert ids == hf.encode(text, add_special_tokens=False).ids, text
        assert port.decode(ids) == text
    chat = port.apply_chat_template(MESSAGES)
    assert chat[0] == names["<|begin_of_text|>"]
    assert hf.decode(chat, skip_special_tokens=True) == port.decode(chat)
    # every regular id decodes, as HF decodes it
    every = list(range(256 + n_merges))
    assert port.decode(every) == hf.decode(every)


def test_smoke_traffic_texts_are_serve_traffic_in_bpe_tokens(tmp_path):
    """``serve_ckpt_traffic`` sends ``serve``'s traffic in the checkpoint's
    tokens: each prompt encodes to at most as many tokens as ``serve``'s
    prompt has bytes and at most 4 fewer, and the prompts share prefixes
    as ``PROMPT_TEXT * n`` do (the prefix cache sees the same hits)."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    spec = chip_smoke.llama3_tokenizer_json(
        chip_smoke.markdown_corpus() + "\n".join(UNICODE_CORPUS),
        n_merges=3000, seed=0, learned=400)
    (tmp_path / "tokenizer.json").write_text(
        json.dumps(spec, ensure_ascii=False))
    port = get_tokenizer(str(tmp_path))
    decoders, late = chip_smoke._traffic_texts(port)
    per = len(chip_smoke.PROMPT_TEXT)
    want = [per * n for n in chip_smoke.DECODERS] + [
        per * chip_smoke.LATE_PROMPT]
    got = [len(port.encode(t)) for t in decoders + [late]]
    assert all(w - 4 <= g <= w for g, w in zip(got, want)), (got, want)
    texts = sorted(decoders + [late], key=len)
    for short, long in zip(texts, texts[1:]):
        assert long.startswith(short[:-16])
