"""LLM client seam: the in-process engine or a remote OpenAI-compatible server.

Port of ``generativeaiexamples_tpu/chains/llm_client.py``. ``get_llm`` gives
the chains ``LocalLLM`` (the port's ``Scheduler``, no HTTP) or, when
``APP_LLM_SERVER_URL`` is set, ``RemoteLLM`` (any ``/v1`` server); both
stream text deltas from ``chat`` and answer one tool-capable turn from
``chat_tools``. ``RemoteLLM`` speaks ``urllib`` where the reference speaks
``httpx`` (the card's machine has no ``httpx``), with the same SSE parsing
and the same error surfacing: an error chunk raises, a non-2xx stream
ends without text as ``httpx.stream`` ends it, and ``chat_tools`` raises
on a non-2xx answer as ``raise_for_status`` does. Its requests carry the
W3C ``traceparent``; the SLO class and deadline headers the reference adds
wait for the SLO plane (ROADMAP A.10). A comma-separated ``server_url``
(the reference's failover pool) is refused: ``server/failover.py`` is
ROADMAP A.17.
"""

from __future__ import annotations

import json
import logging
import urllib.error
import urllib.request
from functools import lru_cache
from typing import Dict, Iterator, Optional, Sequence

from generativeaiexamples_tpu_torch.core.config import get_config
from generativeaiexamples_tpu_torch.observability import otel

logger = logging.getLogger(__name__)

REMOTE_TIMEOUT_S = 120.0


class LocalLLM:
    """Directly drives the in-proc continuous-batching scheduler."""

    def __init__(self, scheduler) -> None:
        self.scheduler = scheduler

    def chat(self, messages: Sequence[Dict[str, str]], max_tokens: int = 256,
             temperature: float = 0.7, top_p: float = 1.0,
             top_k: int = 0, grammar=None,
             stop: Optional[Sequence[str]] = None) -> Iterator[str]:
        from generativeaiexamples_tpu_torch.engine.scheduler import Request

        prompt_ids = self.scheduler.tokenizer.apply_chat_template(
            list(messages))
        req = Request(prompt_ids=prompt_ids, max_tokens=max_tokens,
                      temperature=temperature, top_p=top_p, top_k=top_k,
                      grammar=grammar, stop=list(stop or []))
        # submitted on the first pull (a generator body), so an un-iterated
        # chat() never leaves a generating request on the device
        self.scheduler.submit(req)
        yield from self.scheduler.iter_text(req)
        # the scheduler rejects e.g. over-capacity prompts per request (no
        # silent truncation): surface that instead of yielding ''
        if req.error:
            raise RuntimeError(f"LLM request failed: {req.error}")

    def chat_tools(self, messages: Sequence[Dict], tools: Sequence[Dict],
                   tool_choice="auto", **sampling) -> Dict:
        """One tool-capable turn -> an OpenAI-shaped assistant message:
        {"role": "assistant", "content": str|None, "tool_calls": [...]?}.
        The /v1 server's prompt-render/parse mechanics (engine/tools.py),
        minus the HTTP; a forced or required tool_choice also applies the
        tool-envelope grammar (engine/grammar.py)."""
        from generativeaiexamples_tpu_torch.engine import tools as tools_mod

        msgs = tools_mod.normalize_messages(messages)
        grammar = None
        if tools and tool_choice != "none":
            name = tools_mod.forced_name(tool_choice)
            if name and name not in tools_mod.tool_names(tools):
                # the /v1 server's 400: a typo'd forced name fails loudly
                raise ValueError(f"tool_choice names unknown tool {name!r}")
            msgs = tools_mod.inject_tool_prompt(msgs, tools, tool_choice)
            if tool_choice == "required" or name:
                from generativeaiexamples_tpu_torch.engine import (
                    grammar as grammar_mod)
                try:
                    grammar = grammar_mod.Grammar.for_tools_cached(
                        tools, forced=name)
                except grammar_mod.UnsupportedSchema:
                    grammar = None              # prompt+parse fallback
        text = "".join(self.chat(msgs, grammar=grammar, **sampling))
        calls = (tools_mod.parse_tool_calls(text, tools)
                 if tools and tool_choice != "none" else None)
        if calls:
            return {"role": "assistant", "content": None, "tool_calls": calls}
        return {"role": "assistant", "content": text}


def _post(url: str, payload: Dict) -> urllib.request.Request:
    headers = {"Content-Type": "application/json"}
    otel.inject_traceparent(headers)
    return urllib.request.Request(url, data=json.dumps(payload).encode(),
                                  headers=headers, method="POST")


def _lines(resp) -> Iterator[str]:
    for raw in resp:
        yield raw.decode("utf-8").rstrip("\r\n")


class RemoteLLM:
    """OpenAI-compatible /v1 client (the reference's server_url path)."""

    def __init__(self, base_url: str, model: str) -> None:
        self.base_url = base_url.rstrip("/")
        self.model = model

    def chat(self, messages: Sequence[Dict[str, str]], max_tokens: int = 256,
             temperature: float = 0.7, top_p: float = 1.0,
             top_k: int = 0,
             stop: Optional[Sequence[str]] = None) -> Iterator[str]:
        payload = {"model": self.model, "messages": list(messages),
                   "max_tokens": max_tokens, "temperature": temperature,
                   "top_p": top_p, "stream": True}
        if stop:
            payload["stop"] = list(stop)
        req = _post(f"{self.base_url}/v1/chat/completions", payload)
        try:
            resp = urllib.request.urlopen(req, timeout=REMOTE_TIMEOUT_S)
        except urllib.error.HTTPError as exc:
            # httpx.stream does not raise on a status: the body's lines are
            # read the same way (an error body holds no data: lines)
            resp = exc
        with resp:
            for line in _lines(resp):
                if not line.startswith("data: "):
                    continue
                data = line[len("data: "):]
                if data.strip() == "[DONE]":
                    return
                chunk = json.loads(data)
                choices = chunk.get("choices") or [{}]
                # engine/server.py reports failures as a final chunk with
                # finish_reason="error" and a top-level "error": surface it
                # instead of ending the stream as an apparent success
                if (chunk.get("error")
                        or choices[0].get("finish_reason") == "error"):
                    raise RuntimeError(
                        f"LLM stream error: {chunk.get('error', 'unknown')}")
                content = choices[0].get("delta", {}).get("content")
                if content:
                    yield content

    def chat_tools(self, messages: Sequence[Dict], tools: Sequence[Dict],
                   tool_choice="auto", **sampling) -> Dict:
        """One tool-capable turn against the remote /v1 server; returns the
        assistant message (with `tool_calls` when the model called one)."""
        payload = {"model": self.model, "messages": list(messages),
                   "stream": False, **sampling}
        if tools:
            payload["tools"] = list(tools)
            payload["tool_choice"] = tool_choice
        req = _post(f"{self.base_url}/v1/chat/completions", payload)
        with urllib.request.urlopen(req, timeout=REMOTE_TIMEOUT_S) as resp:
            data = json.loads(resp.read())
        return data["choices"][0]["message"]


@lru_cache(maxsize=1)
def _default_scheduler(device=None):
    """Build the in-proc engine once per process (the tiny model unless a
    checkpoint is configured, as the reference's), on ``device``."""
    from generativeaiexamples_tpu_torch.engine.__main__ import build_scheduler

    cfg = get_config()
    tiny = not cfg.engine.checkpoint_dir
    scheduler, _ = build_scheduler(tiny=tiny, device=device)
    scheduler.start()
    return scheduler


def get_llm(scheduler=None, device=None):
    """The factory chains call: remote when APP_LLM_SERVER_URL is set, the
    local engine (``scheduler``, or one built on ``device``) otherwise."""
    cfg = get_config()
    if cfg.llm.server_url:
        urls = [u.strip() for u in cfg.llm.server_url.split(",") if u.strip()]
        if len(urls) > 1:
            raise NotImplementedError(
                f"APP_LLM_SERVER_URL names {len(urls)} servers: the "
                f"health-tracked failover pool (server/failover.py) is not "
                f"ported yet (ROADMAP A.17); name one server")
        return RemoteLLM(urls[0], cfg.llm.model_name)
    return LocalLLM(scheduler if scheduler is not None
                    else _default_scheduler(device))
