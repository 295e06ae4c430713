"""LoRA model ids on the port's HTTP server, on the CPU with the tiny model.

Two adapters registered (the reference's trained trees, carried across by
``adapters_from_jax``): ``/v1/models`` lists them with the base model as
``parent``; the ``model`` field routes a request, and the adapter's reply
is the JAX ``Scheduler``'s greedy text for that adapter on the same
weights; an unknown id gets a 404 (no silent base weights); every
response shape echoes the requested id (buffered and streamed chat, text
completions, ``n = 2``); without adapters any id serves the base model.
"""

import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from generativeaiexamples_tpu.core.config import EngineConfig as JaxEngineConfig
from generativeaiexamples_tpu.engine.engine import EngineCore as JaxCore
from generativeaiexamples_tpu.engine.scheduler import Scheduler as JaxScheduler
from generativeaiexamples_tpu.engine.tokenizer import ByteTokenizer
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.train import lora as jlora

from generativeaiexamples_tpu_torch.core.config import EngineConfig
from generativeaiexamples_tpu_torch.engine.engine import EngineCore
from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
from generativeaiexamples_tpu_torch.engine.server import serve_in_thread
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.train import lora

GEOMETRY = dict(max_batch_size=4, max_seq_len=128, prefill_chunk=32,
                page_size=16, spec_decode="off", prefix_cache="off")
MESSAGES = [{"role": "user", "content": "route me"}]
BASE = "tiny-llama-test"
TOKENS = 8


def _trained(cfg, seed):
    ad = jlora.init_adapters(jax.random.PRNGKey(seed), cfg,
                             jlora.LoraConfig(rank=4, alpha=8.0))
    return jax.tree.map(lambda x: x + 0.8 * jax.random.normal(
        jax.random.PRNGKey(seed + 100), x.shape, x.dtype), ad)


@pytest.fixture(scope="module")
def served():
    cfg = jllama.LlamaConfig.tiny(vocab_size=300)
    jparams = jllama.init_params(jax.random.PRNGKey(5), cfg)
    jtrees = {"tuned": _trained(cfg, 1), "other": _trained(cfg, 2)}
    tok = ByteTokenizer()
    ids = tok.apply_chat_template(MESSAGES)
    want = {}
    for name in ("", "tuned"):
        core = JaxCore(cfg, JaxEngineConfig(**GEOMETRY), jparams,
                       eos_id=tok.eos_id)
        for n, t in jtrees.items():
            core.register_adapter(n, t)
        sched = JaxScheduler(core, tok)
        sched.start()
        try:
            want[name] = sched.generate(ids, max_tokens=TOKENS,
                                        temperature=0.0, adapter=name)
        finally:
            sched.stop()
    tcfg = llama.LlamaConfig.tiny(vocab_size=300)
    tparams = llama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    core = EngineCore(tcfg, EngineConfig(mixed_phase_dispatch="off",
                                         **GEOMETRY), tparams,
                      eos_id=tok.eos_id, device="cpu")
    for n, t in jtrees.items():
        core.register_adapter(n, lora.adapters_from_jax(
            jax.tree.map(np.asarray, t), tcfg))
    sched = Scheduler(core, tok)
    httpd, thread = serve_in_thread(sched, BASE)
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}", want, tparams
    finally:
        httpd.shutdown()
        httpd.server_close()
        sched.stop()
        thread.join(timeout=10)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=60)


def _chat(base, model, **kw):
    with _post(base + "/v1/chat/completions",
               {"model": model, "max_tokens": TOKENS, "temperature": 0,
                "messages": MESSAGES, **kw}) as resp:
        assert resp.status == 200
        return json.loads(resp.read())


def test_models_lists_adapters_with_their_parent(served):
    base, _, _ = served
    with urllib.request.urlopen(base + "/v1/models", timeout=10) as resp:
        cards = json.loads(resp.read())["data"]
    assert [c["id"] for c in cards] == [BASE, "tuned", "other"]
    assert "parent" not in cards[0]
    assert all(c["parent"] == BASE for c in cards[1:])


def test_model_field_routes_and_replies_equal_jax(served):
    base, want, _ = served
    out = {m: _chat(base, m) for m in (BASE, "tuned")}
    assert out[BASE]["model"] == BASE and out["tuned"]["model"] == "tuned"
    texts = {m: o["choices"][0]["message"]["content"] for m, o in out.items()}
    assert texts[BASE] == want[""]
    assert texts["tuned"] == want["tuned"]
    assert texts[BASE] != texts["tuned"]
    # no model field serves the base model under its id
    with _post(base + "/v1/chat/completions",
               {"max_tokens": TOKENS, "temperature": 0,
                "messages": MESSAGES}) as resp:
        body = json.loads(resp.read())
    assert body["model"] == BASE
    assert body["choices"][0]["message"]["content"] == want[""]


def test_unknown_model_gets_404(served):
    base, _, _ = served
    with pytest.raises(urllib.error.HTTPError) as err:
        _chat(base, "tuned-typo")
    assert err.value.code == 404
    msg = json.loads(err.value.read())["error"]
    assert "tuned-typo" in msg and "tuned" in msg and BASE in msg


def test_stream_and_completions_echo_the_adapter(served):
    base, want, _ = served
    with _post(base + "/v1/chat/completions",
               {"model": "tuned", "max_tokens": TOKENS, "temperature": 0,
                "stream": True, "messages": MESSAGES}) as resp:
        lines = [ln.decode().strip() for ln in resp
                 if ln.decode().startswith("data: ")]
    assert lines[-1] == "data: [DONE]"
    chunks = [json.loads(ln[len("data: "):]) for ln in lines[:-1]]
    assert {c["model"] for c in chunks} == {"tuned"}
    text = "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks)
    assert text == want["tuned"]
    with _post(base + "/v1/completions",
               {"model": "other", "max_tokens": TOKENS, "temperature": 0,
                "prompt": "route me"}) as resp:
        body = json.loads(resp.read())
    assert body["model"] == "other" and body["object"] == "text_completion"


def test_n2_under_an_adapter(served):
    base, _, _ = served
    body = _chat(base, "tuned", n=2, temperature=0.9, seed=3)
    assert body["model"] == "tuned"
    assert [c["index"] for c in body["choices"]] == [0, 1]
    again = _chat(base, "tuned", n=2, temperature=0.9, seed=3)
    base_n = _chat(base, BASE, n=2, temperature=0.9, seed=3)
    texts = [c["message"]["content"] for c in body["choices"]]
    assert texts == [c["message"]["content"] for c in again["choices"]]
    assert texts != [c["message"]["content"] for c in base_n["choices"]]
    assert body["usage"]["completion_tokens"] == 2 * TOKENS


def test_without_adapters_any_model_id_serves_the_base(served):
    _, want, tparams = served
    tok = ByteTokenizer()
    sched = Scheduler(EngineCore(llama.LlamaConfig.tiny(vocab_size=300),
                                 EngineConfig(mixed_phase_dispatch="off",
                                              **GEOMETRY), tparams,
                                 eos_id=tok.eos_id, device="cpu"), tok)
    httpd, thread = serve_in_thread(sched, BASE)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        body = _chat(url, "any-model-id")
        with urllib.request.urlopen(url + "/v1/models", timeout=10) as resp:
            cards = json.loads(resp.read())["data"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        sched.stop()
        thread.join(timeout=10)
    assert [c["id"] for c in cards] == [BASE]
    assert body["model"] == BASE
    assert body["choices"][0]["message"]["content"] == want[""]
