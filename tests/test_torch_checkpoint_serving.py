"""Serve an HF-format checkpoint through the port, as a user would.

A tiny Llama directory (``transformers.LlamaForCausalLM.save_pretrained``,
f32, 3 layers, dim 128, GQA 4/2) with a real Llama-3-mode BPE
``tokenizer.json`` trained by ``tokenizers`` on a unicode corpus is served
by the port's ``build_scheduler`` (``APP_ENGINE_CHECKPOINT_DIR``,
``device="cpu"``, ``APP_ENGINE_DTYPE=float32``) and its HTTP server. The
greedy stream (ids and text) equals the JAX ``Scheduler`` over the
reference's ``load_hf_dir`` of the same directory and ``transformers``'
greedy ``generate`` (as the reference's ``tests/test_hf_serving_e2e.py``);
``usage.prompt_tokens`` is the chat template's length, the streamed text
is ``decode`` of the generated ids, and a stop string that straddles two
BPE tokens ends the text where the JAX engine ends it. ``int8`` streams
the quantization and serves; an orbax directory is refused.
"""

import dataclasses
import json
import urllib.request

import jax
import pytest
import torch

from generativeaiexamples_tpu.core.config import EngineConfig as JaxEngineConfig
from generativeaiexamples_tpu.engine.engine import EngineCore as JaxCore
from generativeaiexamples_tpu.engine.scheduler import Request as JaxRequest
from generativeaiexamples_tpu.engine.scheduler import Scheduler as JaxScheduler
from generativeaiexamples_tpu.engine.tokenizer import (
    get_tokenizer as ref_get_tokenizer)
from generativeaiexamples_tpu.models.hf_loader import (
    load_hf_dir as ref_load_hf_dir)

from generativeaiexamples_tpu_torch.engine.__main__ import build_scheduler
from generativeaiexamples_tpu_torch.engine.native_tokenizer import (
    NativeBPETokenizer, _LLAMA3_PATTERN)
from generativeaiexamples_tpu_torch.engine.scheduler import Request
from generativeaiexamples_tpu_torch.engine.server import serve_in_thread

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

CORPUS = ["the auxiliary pump assembly requires inspection",
          "the reranker orders candidate passages by relevance",
          "speculative decoding verifies drafted tokens in one step",
          "paged attention gathers the slot's pages",
          "le café naïve à Zürich — déjà vu",
          "日本語のテキストと中文文本 🚀🔥"]
GEOMETRY = {"APP_ENGINE_MAX_BATCH_SIZE": "2", "APP_ENGINE_MAX_SEQ_LEN": "128",
            "APP_ENGINE_PAGE_SIZE": "8", "APP_ENGINE_PREFILL_CHUNK": "16",
            "APP_ENGINE_DTYPE": "float32"}
MAX_TOKENS = 12
MESSAGES = [{"role": "user", "content": "the pump — café 日本"}]


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    from tokenizers import (Regex, Tokenizer, decoders, models,
                            pre_tokenizers, trainers)
    d = str(tmp_path_factory.mktemp("hf_llama3"))
    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(_LLAMA3_PATTERN), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=600, special_tokens=[
            "<|begin_of_text|>", "<|eot_id|>", "<|start_header_id|>",
            "<|end_header_id|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(CORPUS * 50, trainer)
    tok.save(f"{d}/tokenizer.json")
    cfg = transformers.LlamaConfig(
        vocab_size=tok.get_vocab_size(), hidden_size=128,
        intermediate_size=256, num_hidden_layers=3, num_attention_heads=4,
        num_key_value_heads=2, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False,
        bos_token_id=tok.token_to_id("<|begin_of_text|>"),
        eos_token_id=tok.token_to_id("<|eot_id|>"))
    torch.manual_seed(7)
    model = transformers.LlamaForCausalLM(cfg)
    model.save_pretrained(d, safe_serialization=True)
    return d, model


@pytest.fixture
def port_env(hf_dir, monkeypatch):
    d, _ = hf_dir
    monkeypatch.setenv("APP_ENGINE_CHECKPOINT_DIR", d)
    for key, value in GEOMETRY.items():
        monkeypatch.setenv(key, value)
    return d


def _jax_stream(d, ids, **kw):
    """The JAX engine's (text, generated ids) for ``ids`` over the
    reference's load of ``d`` (cast to f32, as the reference's own e2e
    test does); the ids come from its logprob records."""
    cfg, params = ref_load_hf_dir(d)
    cfg = dataclasses.replace(cfg, dtype="float32")
    params = jax.tree.map(lambda x: x.astype("float32"), params)
    tok = ref_get_tokenizer(d)
    sched = JaxScheduler(JaxCore(cfg, JaxEngineConfig(
        max_batch_size=2, max_seq_len=128, page_size=8, prefill_chunk=16),
        params, eos_id=tok.eos_id), tok)
    req = JaxRequest(prompt_ids=list(ids), max_tokens=MAX_TOKENS,
                     temperature=0.0, logprobs=True, **kw)
    sched.start()
    try:
        sched.submit(req)
        text = "".join(sched.iter_text(req))
    finally:
        sched.stop()
    assert req.error is None
    return text, [rec[0] for rec in req.logprob_data]


def _port_request(sched, ids, **kw):
    req = Request(prompt_ids=list(ids), max_tokens=MAX_TOKENS,
                  temperature=0.0, **kw)
    sched.start()
    try:
        sched.submit(req)
        text = "".join(sched.iter_text(req))
    finally:
        sched.stop()
    assert req.error is None
    return req, text


def test_build_scheduler_serves_the_checkpoint(port_env, hf_dir):
    d, model = hf_dir
    sched, _ = build_scheduler(device="cpu")
    tok = sched.tokenizer
    assert isinstance(tok, NativeBPETokenizer)
    assert sched.core.model_cfg.n_layers == 3            # from config.json
    assert sched.core.model_cfg.dtype == "float32"       # APP_ENGINE_DTYPE
    assert sched.core.eos_id == tok.eos_id == model.config.eos_token_id
    ids = tok.encode("the auxiliary pump assembly", add_bos=True)
    req, text = _port_request(sched, ids)

    with torch.no_grad():
        hf_out = model.generate(torch.tensor([ids]),
                                max_new_tokens=MAX_TOKENS, do_sample=False,
                                eos_token_id=model.config.eos_token_id)
    hf_gen = hf_out[0][len(ids):].tolist()
    assert req.output_ids == hf_gen[:len(req.output_ids)]
    if tok.eos_id in hf_gen:
        hf_gen = hf_gen[:hf_gen.index(tok.eos_id)]
    assert text == tok.decode(hf_gen) and text
    assert _jax_stream(d, ids) == (text, req.output_ids)


def test_http_chat_usage_and_stream(port_env, hf_dir):
    d, _ = hf_dir
    sched, name = build_scheduler(device="cpu")
    tok = sched.tokenizer
    ids = tok.apply_chat_template(MESSAGES)
    assert ids == ref_get_tokenizer(d).apply_chat_template(MESSAGES)
    submitted = []
    submit = sched.submit
    sched.submit = lambda req: (submitted.append(req), submit(req))[1]
    httpd, thread = serve_in_thread(sched, name)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        bodies = []
        for stream in (True, False):
            body = {"messages": MESSAGES, "max_tokens": MAX_TOKENS,
                    "temperature": 0.0, "stream": stream}
            req = urllib.request.Request(
                base + "/v1/chat/completions", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                assert resp.status == 200
                bodies.append(resp.read().decode())
    finally:
        httpd.shutdown()
        httpd.server_close()
        sched.stop()
        thread.join(timeout=10)
    events = [json.loads(line[len("data: "):]) for line in
              bodies[0].splitlines()
              if line.startswith("data: ") and line != "data: [DONE]"]
    streamed = "".join(e["choices"][0]["delta"].get("content", "")
                       for e in events)
    final = json.loads(bodies[1])
    for usage, r in ((events[-1]["usage"], submitted[0]),
                     (final["usage"], submitted[1])):
        assert usage["prompt_tokens"] == len(ids)
        assert usage["completion_tokens"] == len(r.output_ids)
    assert streamed == tok.decode(submitted[0].output_ids)
    assert final["choices"][0]["message"]["content"] == streamed
    assert submitted[0].output_ids == submitted[1].output_ids
    assert _jax_stream(d, ids) == (streamed, submitted[0].output_ids)


def test_stop_string_straddling_two_bpe_tokens(port_env, hf_dir):
    d, _ = hf_dir
    sched, _ = build_scheduler(device="cpu")
    tok = sched.tokenizer
    ids = tok.encode("the reranker orders", add_bos=True)
    req, text = _port_request(sched, ids)
    pieces = [tok.decode([t]) for t in req.output_ids]
    # the first boundary after a piece of two or more characters whose
    # stop (its last character and the next piece's first, both whole
    # characters) first appears there
    stop, at = None, 0
    for k in range(len(pieces) - 1):
        at += len(pieces[k])
        cand = pieces[k][-1:] + pieces[k + 1][:1]
        if (len(cand) == 2 and "\ufffd" not in cand and len(pieces[k]) > 1
                and text.find(cand) == at - 1):
            stop = cand
            break
    assert stop is not None, pieces
    sched, _ = build_scheduler(device="cpu")
    req, stopped = _port_request(sched, ids, stop=[stop])
    assert stopped == text[:at - 1] and req.finish_reason == "stop"
    assert _jax_stream(d, ids, stop=[stop])[0] == stopped


def test_int8_checkpoint_serves(port_env, monkeypatch):
    monkeypatch.setenv("APP_ENGINE_QUANT", "int8")
    sched, _ = build_scheduler(device="cpu")
    assert hasattr(sched.core.params["layers"][0]["wq"], "q")
    ids = sched.tokenizer.encode("paged attention", add_bos=True)
    req, text = _port_request(sched, ids)
    assert len(req.output_ids) > 0 and text == sched.tokenizer.decode(
        req.output_ids)


def test_orbax_directory_is_refused(tmp_path, monkeypatch):
    (tmp_path / "params").mkdir()
    monkeypatch.setenv("APP_ENGINE_CHECKPOINT_DIR", str(tmp_path))
    with pytest.raises(NotImplementedError, match="A.15"):
        build_scheduler(device="cpu")


def test_checkpoint_without_tokenizer_json_is_refused(hf_dir, tmp_path,
                                                      monkeypatch):
    import shutil
    d, _ = hf_dir
    for name in ("config.json", "model.safetensors"):
        shutil.copy(f"{d}/{name}", tmp_path)
    monkeypatch.setenv("APP_ENGINE_CHECKPOINT_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        build_scheduler(device="cpu")
