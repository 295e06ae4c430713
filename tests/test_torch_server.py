"""The port's stdlib HTTP server with the tiny model, on port 0.

``/health`` answers; a chat completion and a streamed one return the JAX
engine's greedy text for the same weights and prompt, the stream ends with
``[DONE]`` and reports ``usage``. Both engines run without the prefix
cache; a second server with it on answers a repeated chat with the same
text and reports the hit on ``/health``.
"""

import contextlib
import json
import urllib.request

import jax
import numpy as np
import pytest

from generativeaiexamples_tpu.core.config import EngineConfig as JaxEngineConfig
from generativeaiexamples_tpu.engine.engine import EngineCore as JaxCore
from generativeaiexamples_tpu.engine.scheduler import Scheduler as JaxScheduler
from generativeaiexamples_tpu.engine.tokenizer import ByteTokenizer
from generativeaiexamples_tpu.models import llama as jllama

from generativeaiexamples_tpu_torch.core.config import EngineConfig
from generativeaiexamples_tpu_torch.engine.engine import EngineCore
from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
from generativeaiexamples_tpu_torch.engine.server import serve_in_thread
from generativeaiexamples_tpu_torch.models import llama

GEOMETRY = dict(max_batch_size=4, max_seq_len=128, prefill_chunk=32,
                page_size=16)
MESSAGES = [{"role": "user", "content": "say something"}]
MAX_TOKENS = 16


@pytest.fixture(scope="module")
def served():
    cfg = jllama.LlamaConfig.tiny(vocab_size=300)
    jparams = jllama.init_params(jax.random.PRNGKey(5), cfg)
    tok = ByteTokenizer()
    ids = tok.apply_chat_template(MESSAGES)
    jsched = JaxScheduler(JaxCore(cfg, JaxEngineConfig(
        spec_decode="off", prefix_cache="off", **GEOMETRY), jparams,
        eos_id=tok.eos_id), tok)
    jsched.start()
    try:
        want = jsched.generate(ids, max_tokens=MAX_TOKENS, temperature=0.0)
    finally:
        jsched.stop()
    tcfg = llama.LlamaConfig.tiny(vocab_size=300)
    tparams = llama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    with _server(tparams, tcfg, tok, prefix_cache="off") as base:
        yield base, want, (tcfg, tparams)


@contextlib.contextmanager
def _server(tparams, tcfg, tok, **engine_kw):
    sched = Scheduler(EngineCore(tcfg, EngineConfig(**GEOMETRY, **engine_kw),
                                 tparams, eos_id=tok.eos_id, device="cpu"),
                      tok)
    httpd, thread = serve_in_thread(sched, "tiny-llama-test")
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        sched.stop()
        thread.join(timeout=10)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=60)


def test_health_and_models(served):
    base, _, _ = served
    with urllib.request.urlopen(base + "/health", timeout=10) as resp:
        assert resp.status == 200
        assert json.loads(resp.read())["batch"] == 4
    with urllib.request.urlopen(base + "/v1/models", timeout=10) as resp:
        assert json.loads(resp.read())["data"][0]["id"] == "tiny-llama-test"


def test_chat_completion_matches_jax_greedy(served):
    base, want, _ = served
    with _post(base + "/v1/chat/completions",
               {"messages": MESSAGES, "max_tokens": MAX_TOKENS,
                "temperature": 0}) as resp:
        body = json.loads(resp.read())
    choice = body["choices"][0]
    assert choice["message"]["content"] == want
    assert choice["finish_reason"] in ("stop", "length")
    assert body["usage"]["completion_tokens"] <= MAX_TOKENS
    assert body["object"] == "chat.completion"


def test_streamed_chat_matches_jax_greedy(served):
    base, want, _ = served
    with _post(base + "/v1/chat/completions",
               {"messages": MESSAGES, "max_tokens": MAX_TOKENS,
                "temperature": 0, "stream": True}) as resp:
        assert resp.headers["Content-Type"] == "text/event-stream"
        lines = [ln.decode().strip() for ln in resp if ln.strip()]
    assert lines[-1] == "data: [DONE]"
    chunks = [json.loads(ln[len("data: "):]) for ln in lines[:-1]]
    assert chunks[0]["choices"][0]["delta"] == {"role": "assistant"}
    text = "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks)
    assert text == want
    assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")
    assert chunks[-1]["usage"]["completion_tokens"] >= 1


def test_completion_and_bad_request(served):
    base, _, _ = served
    with _post(base + "/v1/completions",
               {"prompt": "abc", "max_tokens": 4, "temperature": 0}) as resp:
        body = json.loads(resp.read())
    assert body["object"] == "text_completion" and "text" in body["choices"][0]
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base + "/v1/chat/completions",
              {"messages": MESSAGES,
               "tools": [{"type": "function", "function": {"name": "f"}}],
               "tool_choice": {"type": "function",
                               "function": {"name": "g"}}})
    assert err.value.code == 400


def test_repeated_chat_hits_the_prefix_cache(served):
    _, want, (tcfg, tparams) = served
    tok = ByteTokenizer()
    with _server(tparams, tcfg, tok, prefix_cache="on") as base:
        for _ in range(2):
            with _post(base + "/v1/chat/completions",
                       {"messages": MESSAGES, "max_tokens": MAX_TOKENS,
                        "temperature": 0}) as resp:
                body = json.loads(resp.read())
            assert body["choices"][0]["message"]["content"] == want
        with urllib.request.urlopen(base + "/health", timeout=10) as resp:
            health = json.loads(resp.read())
    ids = tok.apply_chat_template(MESSAGES)
    assert health["prefix_cache"] is True
    assert health["prefix_hit_tokens"] == (len(ids) - 1) // 16 * 16 > 0
    assert health["prefix_prompt_tokens"] == 2 * len(ids)
