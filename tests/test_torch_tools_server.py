"""The port server's OpenAI surface for the reference's chains, on the CPU.

* Shape parity with the reference's server: the same scripted generation
  (a fake scheduler, the same canned text and logprob triples) gives the
  same non-streamed body and the same stream (ids and timestamps aside)
  for tool calls (buffered and streamed), a plain answer beside tools,
  ``tool_choice`` none, JSON mode (alone, with tools, streamed with the
  grammar attached and falling back when it did not), ``logprobs`` with
  ``top_logprobs`` and ``n`` = 2; the same requests are refused.
* The ``logprobs`` object equals the reference's ``_format_logprobs`` on
  the same triples; the fused first token lists only itself.
* Live, the tiny model behind the HTTP server: a ``json_schema`` reply
  (streamed and not) and a forced tool call parse and validate under the
  grammar; a ``logprobs`` reply has one entry a completion token; ``n`` =
  2 gives the streams of seeds ``seed`` and ``seed + 1``; a grammar that
  does not attach streams the buffered reply.
"""

import asyncio
import json
import urllib.request

import jax
import numpy as np
import pytest

from generativeaiexamples_tpu.engine.server import ModelServer as RefServer
from generativeaiexamples_tpu.engine.tokenizer import ByteTokenizer
from generativeaiexamples_tpu.models import llama as jllama

from generativeaiexamples_tpu_torch.core.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import grammar as tgrammar
from generativeaiexamples_tpu_torch.engine import server as tserver
from generativeaiexamples_tpu_torch.engine.engine import EngineCore
from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
from generativeaiexamples_tpu_torch.engine.tokenizer import (
    ByteTokenizer as TorchByteTokenizer)
from generativeaiexamples_tpu_torch.models import llama

from test_constrained import validates
from test_tool_calling import CALC_TOOL, WEATHER_TOOL

MESSAGES = [{"role": "user", "content": "Weather in Oslo?"}]
SCHEMA = {"type": "object",
          "properties": {"answer": {"enum": ["yes", "no"]},
                         "score": {"type": "integer"}},
          "required": ["answer", "score"]}
CALL = ('{"tool_calls": [{"name": "get_weather", '
        '"arguments": {"city": "Oslo"}}]}')
# logprob triples of a scripted 4-token reply "Oslo": the first token
# (fused into the prefill) has no top rows, the rest three
TRIPLES = [(79, -0.25, None),
           (115, -0.5, [(115, -0.5), (116, -1.5), (32, -2.25)]),
           (108, -0.125, [(108, -0.125), (111, -3.0), (97, -4.0)]),
           (111, -1.0, [(111, -1.0), (97, -1.25), (101, -2.5)])]


class FakeScheduler:
    """Scripted scheduler: each submit pops a canned (text, triples,
    finish reason, grammar attached); ``chunk`` > 0 streams the text in
    chunks of that many characters."""

    def __init__(self, outputs, chunk=0, tokenizer=None):
        self.tokenizer = tokenizer or ByteTokenizer()
        self.outputs = list(outputs)
        self.prompts = []
        self.chunk = chunk

    def submit(self, req):
        self.prompts.append(self.tokenizer.decode(req.prompt_ids))
        out = self.outputs.pop(0)
        text, triples, finish, attached = (tuple(out) + (None,) * 4)[:4]
        req._out = text
        if getattr(req, "logprobs", False):
            req.logprob_data = list(triples or [])
        req.finish_reason = finish or "eos"
        req.completion_tokens = len(triples or [])
        if getattr(req, "grammar", None) is not None:
            req.grammar_attached = bool(attached)
        return req

    def iter_text(self, req):
        if not self.chunk:
            yield req._out
            return
        for i in range(0, len(req._out), self.chunk):
            yield req._out[i:i + self.chunk]


def _ref_post(outputs, body, chunk=0):
    from aiohttp.test_utils import TestClient, TestServer
    sched = FakeScheduler(outputs, chunk)
    server = RefServer(sched, "m")

    async def drive():
        client = TestClient(TestServer(server.app))
        await client.start_server()
        try:
            resp = await client.post("/v1/chat/completions", json=body)
            if resp.content_type == "application/json":
                return resp.status, await resp.json()
            return resp.status, await resp.text()
        finally:
            await client.close()
    status, data = asyncio.run(drive())
    return status, data, sched


def _port_post(outputs, body, chunk=0):
    sched = FakeScheduler(outputs, chunk, TorchByteTokenizer())
    server = tserver.ModelServer(sched, "m")
    try:
        call = server.submit("/v1/chat/completions", body)
    except tserver.BadRequest:
        return 400, None, sched
    if not call.stream:
        return 200, server.complete(call), sched
    return 200, "".join(f"data: {p}\n\n" for p in server.stream(call)), sched


def _scrub(obj):
    """A reply without what differs call to call: ids, timestamps, the
    port's stream ``usage``."""
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items()
                if k not in ("id", "created", "usage")}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


def _chunks(body):
    return [json.loads(line[len("data: "):]) for line in body.splitlines()
            if line.startswith("data: ") and "[DONE]" not in line]


BUFFERED = {
    "tool_call": ([(CALL,)], {"messages": MESSAGES, "tools": [WEATHER_TOOL]}),
    "plain_beside_tools": ([("It is sunny.",)],
                           {"messages": MESSAGES, "tools": [WEATHER_TOOL]}),
    "tool_choice_none": ([("plain",)], {"messages": MESSAGES,
                                         "tools": [WEATHER_TOOL],
                                         "tool_choice": "none"}),
    "forced_tool": ([(CALL, None, "eos", True)], {
        "messages": MESSAGES, "tools": [WEATHER_TOOL, CALC_TOOL],
        "tool_choice": {"type": "function",
                        "function": {"name": "get_weather"}}}),
    "required_tool": ([(CALL, None, "eos", True)], {
        "messages": MESSAGES, "tools": [WEATHER_TOOL],
        "tool_choice": "required"}),
    "json_object": ([('Here: {"answer": 42} ok',)], {
        "messages": MESSAGES, "response_format": {"type": "json_object"}}),
    "json_with_tools": ([('Sure: {"temp_c": 12} as asked',)], {
        "messages": MESSAGES, "tools": [WEATHER_TOOL],
        "response_format": {"type": "json_object"}}),
    "json_schema": ([('{"answer": "yes", "score": 3}', None, "eos", True)], {
        "messages": MESSAGES, "response_format": {
            "type": "json_schema",
            "json_schema": {"name": "v", "schema": SCHEMA}}}),
    "logprobs": ([("Oslo", TRIPLES, "length")], {
        "messages": MESSAGES, "logprobs": True, "top_logprobs": 2}),
    "top_logprobs_capped": ([("Oslo", TRIPLES)], {
        "messages": MESSAGES, "top_logprobs": 9}),
    "n2": ([("Oslo", TRIPLES), ("Bergen", TRIPLES[:2], "length")], {
        "messages": MESSAGES, "n": 2, "seed": 4, "logprobs": True}),
    "thinking": ([("ok",)], {"messages": MESSAGES, "thinking": True}),
}


@pytest.mark.parametrize("case", sorted(BUFFERED))
def test_buffered_reply_equals_reference(case):
    outputs, body = BUFFERED[case]
    status, want, ref = _ref_post(outputs, body)
    got_status, got, port = _port_post(outputs, body)
    assert status == got_status == 200
    assert _scrub(got) == _scrub(want)
    assert port.prompts == ref.prompts          # the same prompt contract
    for w, g in zip(want["choices"], got["choices"]):
        for call_w, call_g in zip(w["message"].get("tool_calls") or [],
                                  g["message"].get("tool_calls") or []):
            assert call_w["id"].startswith("call_")
            assert call_g["id"].startswith("call_")


STREAMED = {
    "tool_call": ([(CALL,)], {"messages": MESSAGES, "tools": [WEATHER_TOOL]},
                  7),
    "tool_plain": ([("It is sunny in Oslo today.",)],
                   {"messages": MESSAGES, "tools": [WEATHER_TOOL]}, 5),
    "text": ([("Oslo is in Norway.",)], {"messages": MESSAGES}, 4),
    "text_logprobs": ([("Oslo", TRIPLES)], {
        "messages": MESSAGES, "logprobs": True, "top_logprobs": 3}, 2),
    "json_attached": ([('{"answer": "no", "score": 1}', None, "eos", True)],
                      {"messages": MESSAGES, "response_format": {
                          "type": "json_schema",
                          "json_schema": {"schema": SCHEMA}}}, 6),
    "json_fallback": ([('x {"answer": "no", "score": 1} y', None, "eos",
                        False)],
                      {"messages": MESSAGES, "response_format": {
                          "type": "json_schema",
                          "json_schema": {"schema": SCHEMA}}}, 6),
    "json_without_grammar": ([('so {"a": 1} ok',)], {
        "messages": MESSAGES, "tools": [WEATHER_TOOL],
        "response_format": {"type": "json_object"}}, 3),
}


@pytest.mark.parametrize("case", sorted(STREAMED))
def test_stream_equals_reference(case):
    outputs, body, chunk = STREAMED[case]
    body = dict(body, stream=True)
    _, want, _ = _ref_post(outputs, body, chunk)
    _, got, _ = _port_post(outputs, body, chunk)
    assert got.rstrip().endswith("data: [DONE]")
    assert _scrub(_chunks(got)) == _scrub(_chunks(want))


def test_n2_stream_interleaves_choices_as_the_reference():
    outputs = [("Oslo is", TRIPLES), ("Bergen!", TRIPLES[:2], "length")]
    body = {"messages": MESSAGES, "n": 2, "seed": 3, "stream": True,
            "logprobs": True}
    _, want, _ = _ref_post(outputs, body, 2)
    _, got, _ = _port_post(outputs, body, 2)

    def by_choice(chunks):
        out = {}
        for c in chunks:
            ch = c["choices"][0]
            rec = out.setdefault(ch["index"], {"text": "", "finals": []})
            rec["text"] += ch["delta"].get("content", "")
            if ch["finish_reason"] is not None:
                rec["finals"].append(_scrub(ch))
        return out
    assert by_choice(_chunks(got)) == by_choice(_chunks(want))


@pytest.mark.parametrize("body", [
    {"tools": [WEATHER_TOOL],
     "tool_choice": {"type": "function", "function": {"name": "nope"}}},
    {"tools": [WEATHER_TOOL], "n": 2},
    {"response_format": {"type": "json_object"}, "n": 3},
    {"messages": []}], ids=["unknown_tool", "n_with_tools", "n_with_json",
                            "no_messages"])
def test_refusals_equal_reference(body):
    body = {"messages": MESSAGES, **body}
    status, _, _ = _ref_post([("x",)] * 4, body)
    got_status, _, _ = _port_post([("x",)] * 4, body)
    assert status == got_status == 400


def test_format_logprobs_equals_reference():
    class Req:
        logprob_data = TRIPLES
        top_logprobs = 3

    class Fake:
        class scheduler:
            tokenizer = ByteTokenizer()
    port = tserver.ModelServer(FakeScheduler([], 0, TorchByteTokenizer()),
                               "m")
    got = port._format_logprobs(Req)
    assert got == RefServer._format_logprobs(Fake, Req)
    assert got["content"][0]["top_logprobs"] == [
        {"token": "O", "logprob": -0.25, "bytes": [79]}]
    assert [len(c["top_logprobs"]) for c in got["content"]] == [1, 3, 3, 3]


def test_grammar_for_prep_equals_reference():
    for body in BUFFERED.values():
        body = body[1]
        prep = tserver.ModelServer._prepare_chat(body)
        ref = RefServer._prepare_chat(None, body)
        assert prep == ref
        grammar, spec = tserver.ModelServer._grammar_for_prep(prep)
        rgrammar, rspec = RefServer._grammar_for_prep(ref)
        assert spec == rspec
        assert (grammar is None) == (rgrammar is None)
        if grammar is not None:
            assert grammar.key == rgrammar.key
            np.testing.assert_array_equal(grammar.dfa.table,
                                          rgrammar.dfa.table)
    assert tserver._grammar_for("schema", json.dumps({"$ref": "#"})) is None


# ----------------------------------------------------- live, the tiny model

GEOMETRY = dict(max_batch_size=4, max_seq_len=1024, prefill_chunk=64,
                page_size=16)


@pytest.fixture(scope="module")
def live():
    cfg = llama.LlamaConfig.tiny(vocab_size=300)
    jcfg = jllama.LlamaConfig.tiny(vocab_size=300)
    params = llama.params_from_jax(jax.tree.map(
        np.asarray, jllama.init_params(jax.random.PRNGKey(99), jcfg)), cfg)
    core = EngineCore(cfg, EngineConfig(**GEOMETRY), params,
                      eos_id=ByteTokenizer().eos_id, device="cpu")
    sched = Scheduler(core, TorchByteTokenizer())
    httpd, thread = tserver.serve_in_thread(sched, "tiny")
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}", sched
    finally:
        httpd.shutdown()
        httpd.server_close()
        sched.stop()
        thread.join(timeout=10)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        raw = resp.read().decode()
    return json.loads(raw) if not body.get("stream") else _chunks(raw)


def test_live_json_schema_replies_validate(live):
    base, sched = live
    body = {"messages": [{"role": "user", "content": "verdict?"}],
            "max_tokens": 48, "temperature": 0.0,
            "response_format": {"type": "json_schema",
                                "json_schema": {"schema": SCHEMA}}}
    got = _post(base + "/v1/chat/completions", body)
    text = got["choices"][0]["message"]["content"]
    assert validates(json.loads(text), SCHEMA), text
    chunks = _post(base + "/v1/chat/completions", dict(body, stream=True))
    streamed = "".join(c["choices"][0]["delta"].get("content") or ""
                       for c in chunks)
    assert validates(json.loads(streamed), SCHEMA), streamed
    # streamed token by token: the grammar attached
    assert sum(1 for c in chunks
               if c["choices"][0]["delta"].get("content")) > 1


def test_live_forced_tool_call_validates(live):
    base, _ = live
    body = {"messages": MESSAGES, "max_tokens": 64, "temperature": 0.8,
            "seed": 5, "tools": [WEATHER_TOOL, CALC_TOOL],
            "tool_choice": {"type": "function",
                            "function": {"name": "get_weather"}}}
    got = _post(base + "/v1/chat/completions", body)
    choice = got["choices"][0]
    assert choice["finish_reason"] == "tool_calls"
    call = choice["message"]["tool_calls"][0]["function"]
    assert call["name"] == "get_weather"
    assert validates(json.loads(call["arguments"]),
                     WEATHER_TOOL["function"]["parameters"])
    chunks = _post(base + "/v1/chat/completions", dict(body, stream=True))
    starts = [c["choices"][0]["delta"]["tool_calls"][0] for c in chunks
              if "tool_calls" in c["choices"][0]["delta"]
              and "name" in c["choices"][0]["delta"]["tool_calls"][0].get(
                  "function", {})]
    assert starts and starts[0]["function"]["name"] == "get_weather"
    assert chunks[-1]["choices"][0]["finish_reason"] == "tool_calls"


def test_live_logprobs_one_entry_a_token(live):
    base, _ = live
    got = _post(base + "/v1/chat/completions",
                {"messages": MESSAGES, "max_tokens": 12, "temperature": 0.0,
                 "logprobs": True, "top_logprobs": 5})
    content = got["choices"][0]["logprobs"]["content"]
    assert len(content) == got["usage"]["completion_tokens"] > 1
    assert len(content[0]["top_logprobs"]) == 1
    assert all(len(c["top_logprobs"]) == 5 for c in content[1:])
    assert all(c["top_logprobs"][0]["logprob"] == c["logprob"]
               for c in content[1:])


def test_live_n2_streams_are_the_seeds(live):
    base, _ = live
    body = {"messages": MESSAGES, "max_tokens": 10, "temperature": 0.9,
            "seed": 40, "n": 2}
    got = _post(base + "/v1/chat/completions", body)
    texts = [c["message"]["content"] for c in got["choices"]]
    alone = [_post(base + "/v1/chat/completions",
                   dict(body, n=1, seed=40 + i))["choices"][0]["message"]
             ["content"] for i in range(2)]
    assert texts == alone
    chunks = _post(base + "/v1/chat/completions", dict(body, stream=True))
    streamed = ["".join(c["choices"][0]["delta"].get("content", "")
                        for c in chunks if c["choices"][0]["index"] == i)
                for i in range(2)]
    assert streamed == texts


def test_live_stream_falls_back_when_grammar_does_not_attach(live,
                                                             monkeypatch):
    base, sched = live

    def refuse(*args, **kwargs):
        raise tgrammar.UnsupportedSchema("every slot pinned (test)")
    monkeypatch.setattr(sched.core, "register_grammar", refuse)
    monkeypatch.setattr(sched.core, "walk_grammar", refuse)
    schema = {"type": "object", "properties": {"flag": {"type": "boolean"}},
              "required": ["flag"]}
    chunks = _post(base + "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "flag?"}],
        "max_tokens": 24, "temperature": 1.0, "stream": True,
        "response_format": {"type": "json_schema",
                            "json_schema": {"schema": schema}}})
    deltas = [c for c in chunks
              if c["choices"][0]["delta"].get("content") is not None]
    assert len(deltas) == 1
    assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")
