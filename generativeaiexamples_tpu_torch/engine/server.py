"""OpenAI-compatible model server on the standard library.

Port of the serving surface of ``generativeaiexamples_tpu/engine/server.py``
(``/health``, ``/v1/models``, ``/v1/completions``, ``/v1/chat/completions``,
with and without SSE ``stream``), with the same JSON shapes as its
``_chunk``/``_finish_reason``, a final ``data: [DONE]`` and ``usage``. It
is written on ``http.server.ThreadingHTTPServer``: one thread per
connection blocks on its request's token queue, and the engine's driver
thread does the device work.

The request surface the reference's chains send: ``logprobs`` and
``top_logprobs`` (at most ``TOP_LP``; the fused first token lists only
itself, as there), ``n`` of 1 to 4 (choice i seeded ``seed + i``; refused
with ``tools`` or ``response_format``), ``tools`` / ``tool_choice`` and
``response_format`` (``json_object``, ``json_schema``) through the tool
and JSON prompt contracts (``engine/tools.py``) and, where the output
contract is unambiguous (a forced or required tool call, JSON mode
without tools), an on-device grammar (``engine/grammar.py``) compiled
once per spec. Tool calls stream as ``tool_calls`` deltas; grammared JSON
mode streams as content once the grammar attached and falls back to the
buffered extract path when it did not.

LoRA model ids, as there: ``/v1/models`` lists each registered adapter
(with the base model as its ``parent``), a request's ``model`` naming an
adapter routes every choice to it, an unknown id gets a 404 once adapters
exist, and every response shape (buffered, streamed, ``n`` > 1, tools)
echoes the requested id.

KV movement, as there: ``POST /v1/kv/prefill`` prefills a request
(``prefill_only``; the chat preparation of ``/v1/chat/completions``, plus
``continue_text``) and answers its exported pages and sampling state as a
binary frame (``core/kv_wire.py``) to an ``Accept`` that names
``application/x-kv-frames``, else as JSON-base64; ``POST /v1/kv/handoff``
imports such a body and streams the completion as SSE framed like chat
completions (``X-Resume-Chars`` for a snapshot resume); ``GET
/v1/kv/evacuation/<rid>`` serves a request's mid-decode snapshot once
(from the outbox, or taken from the live slot on demand) and answers 404
when there is none. An undecodable body answers 400, a geometry or dtype
mismatch 409, and a ``role=prefill`` worker 409 on the generation routes;
``/health`` carries ``engine_role`` and the wires it reads (``kv_wire``).
A request naming a LoRA adapter is refused on both handoff routes (400):
the reference hands it off on the base weights (ROADMAP C8). Every
completion (chat or not, streamed or not) carries ``X-KV-Prefix``: the
prompt's opening-page chain hash under the prefix-addressed host tier
(``Scheduler.prefix_key_hex``), ``""`` when the tier is off or the prompt
does not fill a page; ``/health`` carries the tier's hot-set advert.

The host planes, as there: ``GET /metrics`` (``server/common.py``'s
content negotiation), the debug routes of ``server/common.DEBUG_ROUTES``
(``/debug/flight``, ``/debug/requests[/<rid>]``, ``/debug/slo``,
``/debug/devtime``, ``/debug/compiles``, ``/debug/chaos``,
``/debug/deadletter``, ``/debug/usage``, ``/debug/fleet``,
``/debug/trace``, ``/debug/locks``, ``/debug/qos``,
``/debug/forensics[/<rid>]``, ``/debug/alerts``, ``/debug/doctor``), and
``/health`` with ``slo_pressure``, ``usage_by_tenant``, ``perf``,
``alerts_active`` while ``APP_FORENSICS=on`` and, with an engine
watchdog attached (``engine/watchdog.py``, ``APP_WATCHDOG``), its status:
503 while the worker drains or the watchdog has tripped.
``POST /debug/drain`` drains (``?off=1`` lifts it; ``?evacuate=1`` also
snapshots every live decode slot through the driver, each stream ending
"evacuated" with its snapshot at ``/v1/kv/evacuation/<rid>``); with no
watchdog attached it answers 409. Every route that submits reads the SLO
headers (``X-Request-Class`` / ``X-Slo-Class`` and the remaining-deadline
pair; an unknown class is a 400), the tenant (``X-Tenant-Id`` or an API
key's digest; the handoff takes the payload's tenant below the header)
and a caller's ``X-Request-Id``. The chaos plane's server faults gate
``/v1/chat/completions``, ``/v1/completions`` and ``/v1/kv/*`` (a delay
is slept on the handler's thread, an error answers 503).
``install_sigterm_drain`` turns SIGTERM into a drain and an evacuation,
then an exit after ``APP_DRAIN_GRACE_S``. The scheduler's QoS admission
plane (``APP_QOS=fair``) reads the tenant, the class and the deadline
these headers carry. Not ported: ``/debug/profile`` (ROADMAP A.17).
"""

from __future__ import annotations

import functools
import json
import logging
import os
import queue
import re
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Mapping, Optional

from generativeaiexamples_tpu_torch.core import kv_wire
from generativeaiexamples_tpu_torch.engine import grammar as grammar_mod
from generativeaiexamples_tpu_torch.engine import tools as tools_mod
from generativeaiexamples_tpu_torch.engine.engine import TOP_LP
from generativeaiexamples_tpu_torch.engine.scheduler import Request, Scheduler
from generativeaiexamples_tpu_torch.engine.watchdog import (
    EngineWatchdog, watchdog_enabled)
from generativeaiexamples_tpu_torch.observability import chaos as chaos_mod
from generativeaiexamples_tpu_torch.observability import otel
from generativeaiexamples_tpu_torch.observability import slo as slo_mod
from generativeaiexamples_tpu_torch.observability import usage as usage_mod
from generativeaiexamples_tpu_torch.observability.alerts import ALERTS
from generativeaiexamples_tpu_torch.observability.forensics import FORENSICS
from generativeaiexamples_tpu_torch.server import common
from generativeaiexamples_tpu_torch.server.common import (MAX_TOKENS_CAP,
                                                           parse_stop)

MAX_CHOICES = 4
_RID_SAFE = re.compile(r"[^A-Za-z0-9_.:\-]")
logger = logging.getLogger(__name__)


def inbound_request_id(headers: Mapping[str, str]) -> str:
    """A caller's ``X-Request-Id`` (a router stamps one id on every
    dispatch of a logical request), sanitized and capped: the id is a
    log and URL key, never trusted further."""
    raw = (headers.get("X-Request-Id") or "").strip()
    return _RID_SAFE.sub("", raw)[:64]


def request_fields(headers: Optional[Mapping[str, str]]) -> Dict[str, Any]:
    """The SLO, tenant and trace fields of a submitting route's Request,
    from its headers; an unknown SLO class or a malformed deadline is a
    BadRequest (400)."""
    headers = headers or {}
    try:
        cls, deadline_s = slo_mod.parse_inbound(headers)
    except ValueError as exc:
        raise BadRequest(str(exc))
    parent = otel.extract_traceparent(dict(headers))
    # no tenant header bills "anon": the reference passes the default
    # "anon" on, which its ledger escapes to "t_anon" (ROADMAP C12)
    return {"slo_class": cls or "", "deadline_s": deadline_s,
            "trace_id": parent.trace_id if parent else "",
            "tenant": usage_mod.tenant_from_headers(headers, default="")}


def _finish_reason(req, default: str = "stop") -> str:
    """OpenAI finish_reason from the scheduler's finish cause; ``default``
    carries "tool_calls" (a parsed call is complete whatever ended it)."""
    if getattr(req, "error", None):
        return "error"
    if default == "tool_calls":
        return default
    if getattr(req, "finish_reason", None) in ("length", "evacuated"):
        # "evacuated" passes through: a router resumes the stream on it
        return req.finish_reason
    return default


def _chunk(model: str, rid: str, delta: Dict[str, Any],
           finish_reason: Optional[str] = None, index: int = 0,
           logprobs: Optional[Dict[str, Any]] = None) -> str:
    choice: Dict[str, Any] = {"index": index, "delta": delta,
                              "finish_reason": finish_reason}
    if logprobs is not None:
        choice["logprobs"] = logprobs
    return json.dumps({
        "id": rid, "object": "chat.completion.chunk",
        "created": int(time.time()), "model": model,
        "choices": [choice],
    })


@functools.lru_cache(maxsize=64)
def _grammar_for(kind: str, payload: str) -> Optional[object]:
    """Compile-once cache of grammars: schemas and tool sets repeat across
    requests. None for a schema outside the DFA-regular subset (the request
    then runs prompt+parse only)."""
    try:
        if kind == "schema":
            return grammar_mod.Grammar.from_schema(json.loads(payload))
        if kind == "json":
            return grammar_mod.Grammar.json_value()
        if kind == "tools":
            spec = json.loads(payload)
            return grammar_mod.Grammar.for_tools(spec["tools"],
                                                 forced=spec["forced"])
    except grammar_mod.UnsupportedSchema as exc:
        logger.info("schema outside the DFA-regular subset (%s); serving "
                    "with prompt+parse only", exc)
    return None


class BadRequest(ValueError):
    pass


class Unavailable(RuntimeError):
    """A chaos-injected 5xx: the handler answers 503."""


class NotFound(LookupError):
    """An unknown model id or request: the handler answers 404."""


class Conflict(RuntimeError):
    """A request this worker cannot serve (its role, or a handoff its pool
    cannot host): the handler answers 409."""


class KVBody:
    """A KV route's answer: the encoded payload and its content type."""

    def __init__(self, body: bytes, content_type: str, rid: str) -> None:
        self.body, self.content_type, self.rid = body, content_type, rid


class Call:
    """One HTTP request's scheduler requests (``n`` choices) and what its
    reply needs: the prompt, chat or completion, the tools it may call,
    JSON mode and the grammar."""

    def __init__(self, reqs: List[Request], ids, chat: bool,
                 tools: List[Dict[str, Any]], json_mode: bool,
                 grammar: Optional[object], stream: bool, model: str,
                 kv_prefix: str = "") -> None:
        self.reqs, self.ids, self.chat = reqs, ids, chat
        self.tools, self.json_mode, self.grammar = tools, json_mode, grammar
        self.stream = stream
        self.model = model   # the id every response echoes
        # the prompt's opening-page chain hash under the host tier ("" when
        # the tier is off): the X-KV-Prefix header a router learns from
        self.kv_prefix = kv_prefix

    @property
    def req(self) -> Request:
        return self.reqs[0]


class ModelServer:
    """Routes and request handling, independent of the HTTP transport."""

    def __init__(self, scheduler: Scheduler, model_name: str,
                 watchdog: Optional[EngineWatchdog] = None) -> None:
        self.scheduler = scheduler
        self.model_name = model_name
        # the health arbiter (engine/watchdog.py): while it reports not
        # serving (tripped or draining) /health answers 503; None: health
        # is liveness only and POST /debug/drain answers 409
        self.watchdog = watchdog

    @property
    def role(self) -> str:
        """This worker's serving role (``EngineConfig.role``)."""
        return str(getattr(getattr(self.scheduler, "core", None), "role",
                           "unified") or "unified")

    def health(self) -> tuple:
        """(status, body) of ``GET /health``: liveness, ``slo_pressure``,
        the load surface, the tenant rollup, the utilization card and,
        with ``APP_FORENSICS=on``, the active burn-rate alerts
        (``alerts_active``); 503 while the watchdog reports not
        serving."""
        core = self.scheduler.core
        # kv_wire: the handoff bodies this worker reads, so a router never
        # sends a frame to a worker that would refuse it
        body = {"message": "Service is up.",
                "slo_pressure": slo_mod.SLO.pressure(),
                "kv_wire": ["binary", "json"],
                **self.scheduler.load_stats(),
                "quant": core.quant, "weight_bytes": core.param_bytes,
                "usage_by_tenant": usage_mod.USAGE.rollup(),
                "perf": usage_mod.worker_perf_card()}
        # the burn-rate alert summary rides the probe a router already
        # makes; off mode costs one attribute read
        if FORENSICS.enabled:
            body["alerts_active"] = ALERTS.active()
        if self.watchdog is not None:
            body["watchdog"] = self.watchdog.status()
            if not self.watchdog.serving_ok():
                body["message"] = ("Service is draining."
                                   if self.watchdog.draining
                                   else "Service is unhealthy "
                                        "(watchdog tripped).")
                return 503, body
        return 200, body

    def debug_drain(self, query: Mapping[str, str]) -> tuple:
        """(status, body) of ``POST /debug/drain``: start a graceful drain
        (health 503 while in-flight streams finish), ``?off=1`` lifts it,
        ``?evacuate=1`` also snapshots every live decode slot on the
        driver (this handler's thread waits for its summary). 409 without
        a watchdog."""
        if self.watchdog is None:
            return 409, {"error": "no watchdog attached (APP_WATCHDOG=off);"
                                  " drain needs the health arbiter"}
        if query.get("off", "").strip() in ("1", "true", "on"):
            self.watchdog.undrain()
            return 200, self.watchdog.status()
        self.watchdog.drain()
        body: Dict[str, Any] = dict(self.watchdog.status())
        if query.get("evacuate", "").strip() in ("1", "true", "on"):
            body["evacuation"] = self.scheduler.request_evacuation(
                reason="drain")
        return 200, body

    @staticmethod
    def chaos_gate(site: str) -> None:
        """The chaos plane's server fault at an HTTP seam: a delay is
        slept here, an error raises Unavailable (503). APP_CHAOS=off is
        one attribute read."""
        if not chaos_mod.CHAOS.enabled:
            return
        action = chaos_mod.CHAOS.server_fault(site)
        if action is None:
            return
        kind, param = action
        if kind == "delay":
            chaos_mod.CHAOS.sleep(param)
        elif kind == "error":
            raise Unavailable(f"chaos: injected 5xx at {site}")

    def require_decode_capable(self) -> None:
        if self.role == "prefill":
            raise Conflict("this worker serves APP_ENGINE_ROLE=prefill: it "
                           "only runs chunked prefill (/v1/kv/prefill) and "
                           "never decodes; route generation to a decode or "
                           "unified worker")

    def models(self) -> Dict[str, Any]:
        """The base model and, as first-class model ids, every registered
        adapter with the base model as its parent."""
        cards = [{"id": self.model_name, "object": "model",
                  "owned_by": "generativeaiexamples_tpu_torch"}]
        for name in self._adapter_names():
            cards.append({"id": name, "object": "model",
                          "owned_by": "generativeaiexamples_tpu_torch",
                          "parent": self.model_name})
        return {"object": "list", "data": cards}

    def _adapter_names(self) -> List[str]:
        """The registered adapters (none for a scheduler without a core)."""
        core = getattr(self.scheduler, "core", None)
        return list(getattr(core, "adapter_names", []) or [])

    def _adapter_for(self, body: Dict[str, Any]) -> str:
        """Route the OpenAI ``model`` field: a registered adapter's name
        selects it; the base model's id (or no field) serves base weights.
        Once adapters exist any other id raises NotFound: a mistyped
        fine-tune name must never serve base weights."""
        model_id = str(body.get("model") or "")
        names = self._adapter_names()
        if model_id in names:
            return model_id
        if names and model_id and model_id != self.model_name:
            raise NotFound(f"unknown model {model_id!r}; served: "
                           f"{[self.model_name] + names}")
        return ""

    @staticmethod
    def _sampling(body: Dict[str, Any]) -> Dict[str, Any]:
        def get(key, default, cast):
            value = body.get(key)
            return default if value is None else cast(value)

        top_lp = get("top_logprobs", 0, int)
        return {
            "max_tokens": min(get("max_tokens", 128, int), MAX_TOKENS_CAP),
            "temperature": get("temperature", 0.7, float),
            "top_p": get("top_p", 1.0, float),
            "top_k": get("top_k", 0, int),
            "stop": parse_stop(body.get("stop")),
            "seed": (int(body["seed"]) if body.get("seed") is not None
                     else None),
            "logprobs": bool(get("logprobs", False, bool) or top_lp),
            "top_logprobs": max(0, min(top_lp, TOP_LP)),
        }

    def _format_logprobs(self, req: Request) -> Dict[str, Any]:
        """The OpenAI chat ``logprobs`` object of the scheduler's (token,
        logprob, top) triples; the first (fused-prefill) token's
        ``top_logprobs`` lists only itself."""
        tok = self.scheduler.tokenizer
        content = []
        for tid, lp, top in req.logprob_data:
            s = tok.decode([tid])
            entry: Dict[str, Any] = {"token": s, "logprob": lp,
                                     "bytes": list(s.encode("utf-8"))}
            if req.top_logprobs:
                alts = top if top else ([(tid, lp)] if lp is not None else [])
                entry["top_logprobs"] = [
                    {"token": tok.decode([i]), "logprob": l,
                     "bytes": list(tok.decode([i]).encode("utf-8"))}
                    for i, l in alts[:req.top_logprobs]]
            content.append(entry)
        return {"content": content}

    @staticmethod
    def _prepare_chat(body: Dict[str, Any]) -> Dict[str, Any]:
        """The chat message pipeline: the ``thinking`` toggle, forced-tool
        validation, message normalization, and the tool and JSON prompt
        contracts."""
        messages = body.get("messages") or []
        if not messages:
            raise BadRequest("messages must be non-empty")
        thinking = body.get("thinking")
        if thinking is not None:
            messages = ([{"role": "system",
                          "content": "detailed thinking "
                                     + ("on" if thinking else "off")}]
                        + list(messages))
        tools = body.get("tools") or []
        tool_choice = body.get("tool_choice", "auto" if tools else "none")
        response_format = body.get("response_format") or {}
        json_mode = response_format.get("type") in ("json_object",
                                                    "json_schema")
        name = tools_mod.forced_name(tool_choice)
        if name and name not in tools_mod.tool_names(tools):
            raise BadRequest(f"tool_choice names unknown tool {name!r}")
        messages = tools_mod.normalize_messages(messages)
        use_tools = bool(tools) and tool_choice != "none"
        if use_tools:
            messages = tools_mod.inject_tool_prompt(messages, tools,
                                                    tool_choice)
        if json_mode:
            # with tools, the JSON constraint scopes to non-tool replies
            messages = tools_mod.inject_json_prompt(
                messages, response_format, with_tools=use_tools)
        return {"messages": messages, "tools": tools,
                "tool_choice": tool_choice,
                "response_format": response_format, "json_mode": json_mode,
                "use_tools": use_tools, "forced_name": name}

    @staticmethod
    def _grammar_for_prep(prep: Dict[str, Any]):
        """``(grammar, (kind, payload) | None)``: a grammar wherever the
        output contract is unambiguous (a forced or required tool call, or
        JSON mode without tools; ``tool_choice`` "auto" may answer in
        prose, so it stays prompt+parse)."""
        tools = prep["tools"]
        name = prep["forced_name"]
        spec = None
        if prep["use_tools"] and (prep["tool_choice"] == "required" or name):
            spec = ("tools", json.dumps({"tools": tools, "forced": name}))
        elif prep["json_mode"] and not prep["use_tools"]:
            if prep["response_format"].get("type") == "json_schema":
                # property order is part of the enforced language
                schema = prep["response_format"].get(
                    "json_schema", {}).get("schema", {})
                spec = ("schema", json.dumps(schema))
            else:
                spec = ("json", "")
        if spec is None:
            return None, None
        grammar = _grammar_for(*spec)
        return grammar, (spec if grammar is not None else None)

    def submit(self, path: str, body: Dict[str, Any],
               headers: Optional[Mapping[str, str]] = None) -> Call:
        """Parse a request and submit its ``n`` choices; ``headers`` give
        their SLO class, deadline, tenant and a caller's request id."""
        self.require_decode_capable()
        fields = request_fields(headers)
        rid_in = inbound_request_id(headers or {})
        tok = self.scheduler.tokenizer
        chat = path == "/v1/chat/completions"
        adapter = self._adapter_for(body)
        tools: List[Dict[str, Any]] = []
        json_mode, grammar, spec = False, None, None
        if chat:
            prep = self._prepare_chat(body)
            ids = tok.apply_chat_template(prep["messages"])
            json_mode = prep["json_mode"]
            tools = prep["tools"] if prep["use_tools"] else []
            grammar, spec = self._grammar_for_prep(prep)
        else:
            ids = tok.encode(str(body.get("prompt", "")), add_bos=True)
        sampling = self._sampling(body)
        n = max(1, min(int(body.get("n") or 1), MAX_CHOICES))
        if n > 1 and (tools or json_mode):
            raise BadRequest("n > 1 is not supported with tools or "
                             "response_format")
        reqs = []
        for i in range(n):
            kw = dict(sampling)
            if i and kw["seed"] is not None:
                kw["seed"] = kw["seed"] + i   # distinct, still reproducible
            if rid_in:
                # the caller's id keys this worker's timeline; secondary
                # choices get a derived suffix
                kw["request_id"] = rid_in if i == 0 else f"{rid_in}.{i}"
            reqs.append(Request(prompt_ids=list(ids), grammar=grammar,
                                grammar_spec=spec, adapter=adapter,
                                **fields, **kw))
        for r in reqs:
            self.scheduler.submit(r)
        # responses echo the requested id: adapter traffic is not reported
        # as the base model's; a scheduler without the host tier's key
        # (a stand-in) answers "", as the reference's server reads it
        key = getattr(self.scheduler, "prefix_key_hex", None)
        return Call(reqs, ids, chat, tools, json_mode, grammar,
                    bool(body.get("stream")), adapter or self.model_name,
                    kv_prefix=key(ids, adapter) if key else "")

    def _text(self, req: Request) -> str:
        return "".join(self.scheduler.iter_text(req))

    # ------------------------------------------ KV handoff (disaggregation)

    def _refuse_adapter(self, model_id: str) -> None:
        """A LoRA adapter's request cannot cross a handoff: the importer
        activates at the base model, so it would decode on base weights."""
        if model_id and model_id in self._adapter_names():
            raise BadRequest(
                f"model {model_id!r} is a LoRA adapter: adapter requests "
                f"cannot be handed off (the KV handoff carries no adapter "
                f"slot); send it to /v1/chat/completions")

    def _prompt_ids_from_body(self, body: Dict[str, Any]) -> tuple:
        """A /v1/kv/prefill body -> ``(prompt_ids, grammar, grammar_spec,
        continue_text)``: chat messages take the chat endpoint's
        preparation; a raw ``prompt`` is encoded as it is (no grammar);
        ``continue_text`` appends an emitted prefix, which the grammar
        walks before its first sample."""
        tok = self.scheduler.tokenizer
        grammar = spec = None
        if body.get("messages"):
            prep = self._prepare_chat(body)
            ids = tok.apply_chat_template(prep["messages"])
            grammar, spec = self._grammar_for_prep(prep)
        else:
            ids = tok.encode(str(body.get("prompt", "")), add_bos=True)
        cont = str(body.get("continue_text") or "")
        if cont:
            ids = ids + tok.encode(cont)
        return ids, grammar, spec, cont

    @staticmethod
    def wants_kv_frames(accept: str) -> bool:
        """Frames only to a client whose Accept names them; any other gets
        the JSON-base64 wire."""
        return kv_wire.KV_FRAMES_CONTENT_TYPE in (accept or "")

    def kv_prefill(self, body: Dict[str, Any], accept: str,
                   headers: Optional[Mapping[str, str]] = None) -> KVBody:
        """Prefill a request and answer its handoff payload (any role may
        serve it) in the negotiated wire form. The host copy of the
        device-native payload is made here, on the handler's thread, after
        the gather's event. With the chaos plane on, the payload and then
        the frame may be corrupted (the decode side must refuse both)."""
        self._refuse_adapter(str(body.get("model") or ""))
        fields = request_fields(headers)
        rid_in = inbound_request_id(headers or {})
        if rid_in:
            fields["request_id"] = rid_in
        ids, grammar, spec, cont = self._prompt_ids_from_body(body)
        sampling = self._sampling(body)
        sampling.pop("logprobs", None)
        sampling.pop("top_logprobs", None)
        req = Request(prompt_ids=list(ids), prefill_only=True,
                      grammar=grammar, grammar_spec=spec,
                      grammar_prefix=cont, **fields, **sampling)
        self.scheduler.submit(req)
        self._text(req)
        if req.error or not req.handoff:
            raise RuntimeError(req.error or "prefill produced no handoff")
        payload = req.handoff
        binary = self.wants_kv_frames(accept)
        if chaos_mod.CHAOS.enabled:
            payload = chaos_mod.CHAOS.corrupt_kv(payload, "kv.prefill")
        data, ctype = kv_wire.encode_for_wire(payload, binary)
        if chaos_mod.CHAOS.enabled and binary:
            data = chaos_mod.CHAOS.corrupt_wire(data, "kv.prefill.wire")
        return KVBody(data, ctype, req.request_id)

    def kv_handoff(self, raw: bytes, content_type: str,
                   resume_chars: Optional[str] = None,
                   headers: Optional[Mapping[str, str]] = None):
        """Import a /v1/kv/prefill payload (or an evacuation snapshot) and
        submit it: ``(request, model id)``. An undecodable body raises
        BadRequest (400); a payload this pool cannot host, Conflict
        (409). One logical request bills one tenant: the header, else the
        tenant the payload carries."""
        self.require_decode_capable()
        fields = request_fields(headers)
        if kv_wire.is_kv_frames(raw, content_type):
            try:
                payload = kv_wire.decode_kv_frames(raw)
            except kv_wire.KVWireError as exc:
                raise BadRequest(f"undecodable handoff frame: {exc}")
        else:
            try:
                body = json.loads(raw)
                if not isinstance(body, dict):
                    raise ValueError("the body is not a JSON object")
                payload = kv_wire.decode_kv_payload(body)
            except Exception as exc:
                raise BadRequest(f"undecodable handoff payload: {exc}")
        self._refuse_adapter(str(payload.get("adapter")
                                 or payload.get("model") or ""))
        if payload.get("resume") and resume_chars is not None:
            # the characters the client was delivered: the resume emits
            # only the gap after them
            try:
                payload["resume_chars"] = int(resume_chars)
            except ValueError:
                raise BadRequest("X-Resume-Chars must be an int")
        # the grammar rides as its constructor spec; it attaches only where
        # the exporting worker enforced it (a degraded first token must not
        # be passed off as constrained)
        grammar = None
        kind = str(payload.get("grammar_kind") or "")
        if kind and payload.get("grammar_attached"):
            grammar = _grammar_for(kind,
                                   str(payload.get("grammar_payload") or ""))
        fields["tenant"] = usage_mod.handoff_tenant(headers or {}, payload)
        rid_in = inbound_request_id(headers or {})
        if rid_in:
            fields["request_id"] = rid_in
        try:
            req = Request(
                prompt_ids=[int(t) for t in payload.get("prompt_ids", [])],
                max_tokens=int(payload.get("max_tokens", 128)),
                temperature=float(payload.get("temperature", 0.7)),
                top_k=int(payload.get("top_k", 0)),
                top_p=float(payload.get("top_p", 1.0)),
                stop=parse_stop(payload.get("stop")),
                seed=int(payload.get("seed", 0)), grammar=grammar,
                grammar_prefix=str(payload.get("grammar_prefix") or ""),
                **fields)
        except (TypeError, ValueError) as exc:
            raise BadRequest(f"undecodable handoff payload: {exc}")
        try:
            self.scheduler.submit_prefilled(req, payload)
        except ValueError as exc:
            raise Conflict(str(exc))
        return req, str(payload.get("model") or self.model_name)

    def handoff_stream(self, req: Request, model: str):
        """SSE payloads of a handed-off request, framed like a chat
        completion stream."""
        rid = f"chatcmpl-{uuid.uuid4().hex[:16]}"
        yield _chunk(model, rid, {"role": "assistant"})
        for delta in self.scheduler.iter_text(req):
            yield _chunk(model, rid, {"content": delta})
        final = json.loads(_chunk(model, rid, {}, _finish_reason(req)))
        if req.error:
            final["error"] = req.error
        yield json.dumps(final)
        yield "[DONE]"

    def kv_evacuation(self, rid: str, accept: str) -> KVBody:
        """One request's mid-decode snapshot, served once: the parked one,
        or the live slot's taken now (a one-request evacuation through the
        driver). NotFound when there is none (finished, never
        snapshottable, or pulled already): resume by re-prefill."""
        rid = _RID_SAFE.sub("", rid)[:64]
        if not rid:
            raise BadRequest("missing request id")
        payload = self.scheduler.take_evacuated(rid)
        if payload is None:
            self.scheduler.request_evacuation(rids={rid}, wait_s=15.0,
                                              reason="pull")
            payload = self.scheduler.take_evacuated(rid)
        if payload is None:
            raise NotFound(f"no evacuable state for request {rid!r} "
                           f"(finished, never snapshottable, or already "
                           f"pulled): resume by re-prefill")
        data, ctype = kv_wire.encode_for_wire(payload,
                                              self.wants_kv_frames(accept))
        return KVBody(data, ctype, rid)

    def _usage(self, call: Call) -> Dict[str, int]:
        n = sum(r.completion_tokens for r in call.reqs)
        return {"prompt_tokens": len(call.ids), "completion_tokens": n,
                "total_tokens": len(call.ids) + n}

    def _message(self, call: Call, text: str):
        """(message, finish_reason) of a buffered reply: tool calls parsed,
        a JSON-mode value extracted and rewritten canonically."""
        req = call.req
        tool_calls = (tools_mod.parse_tool_calls(text, call.tools)
                      if call.tools else None)
        if call.json_mode and not tool_calls:
            found = tools_mod.extract_json_value(text)
            if found is not None:
                text = json.dumps(found[0])
        finish = "tool_calls" if tool_calls else _finish_reason(req)
        message: Dict[str, Any] = {"role": "assistant",
                                   "content": None if tool_calls else text}
        if tool_calls:
            message["tool_calls"] = tool_calls
        return message, finish

    def complete(self, call: Call) -> Dict[str, Any]:
        """Non-streamed response body once every choice has finished."""
        texts = [self._text(r) for r in call.reqs]
        message, finish = self._message(call, texts[0])
        choices = []
        for i, (r, t) in enumerate(zip(call.reqs, texts)):
            fin = _finish_reason(r, finish if i == 0 else "stop")
            choice: Dict[str, Any] = {"index": i, "finish_reason": fin}
            if call.chat:
                choice["message"] = (message if i == 0 else
                                     {"role": "assistant", "content": t})
            else:
                choice["text"] = t
            if r.logprobs:
                choice["logprobs"] = self._format_logprobs(r)
            choices.append(choice)
        payload = {
            "id": f"chatcmpl-{uuid.uuid4().hex[:16]}",
            "object": "chat.completion" if call.chat else "text_completion",
            "created": int(time.time()), "model": call.model,
            "choices": choices, "usage": self._usage(call),
        }
        errs = [r.error for r in call.reqs if r.error]
        if errs:
            payload["error"] = "; ".join(errs)
        return payload

    def stream(self, call: Call):
        """SSE payloads (without the ``data: `` framing) of a stream."""
        rid = f"chatcmpl-{uuid.uuid4().hex[:16]}"
        if call.tools and not call.json_mode:
            yield from self._stream_tools(call, rid)
        elif call.json_mode and call.grammar is not None and not call.tools:
            yield from self._stream_json(call, rid)
        elif call.tools or call.json_mode:
            yield from self._stream_buffered(call, rid)
        else:
            yield from self._stream_text(call, rid)
        yield "[DONE]"

    def _final(self, call: Call, rid: str, req: Request, finish: str,
               index: int = 0, error: Optional[str] = None,
               usage: bool = True, logprobs: bool = False) -> str:
        """A choice's final chunk: its finish reason, with ``logprobs`` its
        logprobs object (the text streams), the call's usage on the last
        one, and any error."""
        lps = (self._format_logprobs(req) if logprobs and req.logprobs
               else None)
        final = json.loads(_chunk(call.model, rid, {}, finish, index, lps))
        if usage:
            final["usage"] = self._usage(call)
        error = req.error or error
        if error:
            final["error"] = error
        return json.dumps(final)

    def _stream_text(self, call: Call, rid: str):
        """Content deltas; with ``n`` > 1 each choice's deltas under its
        index as they come, then a final chunk per choice."""
        model, n = call.model, len(call.reqs)
        if call.chat:
            for i in range(n):
                yield _chunk(model, rid, {"role": "assistant"}, index=i)
        if n == 1:
            for delta in self.scheduler.iter_text(call.req):
                yield _chunk(model, rid, {"content": delta})
        else:
            q: "queue.Queue" = queue.Queue()

            def pump(i: int, r: Request) -> None:
                for delta in self.scheduler.iter_text(r):
                    q.put((i, delta))
                q.put((i, None))

            for i, r in enumerate(call.reqs):
                threading.Thread(target=pump, args=(i, r), daemon=True,
                                 name=f"choice-{i}").start()
            live = n
            while live:
                i, delta = q.get()
                if delta is None:
                    live -= 1
                    continue
                yield _chunk(model, rid, {"content": delta}, index=i)
        for i, r in enumerate(call.reqs):
            yield self._final(call, rid, r, _finish_reason(r), i,
                              usage=i == n - 1, logprobs=True)

    def _stream_json(self, call: Call, rid: str):
        """A grammared JSON-mode stream: content deltas once the first
        delta shows the grammar attached (validity is then token-level);
        else the buffered extract-and-rewrite path."""
        model, req = call.model, call.req
        yield _chunk(model, rid, {"role": "assistant"})
        it = self.scheduler.iter_text(req)
        first = next(it, None)
        error = None
        if req.grammar_attached and first is not None and not req.error:
            yield _chunk(model, rid, {"content": first})
            for delta in it:
                if req.grammar_attached is False:
                    # a preemption resume lost the grammar: what follows is
                    # unconstrained, so it is not passed off as valid
                    error = ("constrained decoding lost on preemption "
                             "resume; retry the request")
                    continue
                yield _chunk(model, rid, {"content": delta})
        else:
            text = "".join(([] if first is None else [first]) + list(it))
            if not req.error:
                if not req.grammar_prefix:
                    found = tools_mod.extract_json_value(text)
                    if found is not None:
                        text = json.dumps(found[0])
                yield _chunk(model, rid, {"content": text})
        finish = "error" if (req.error or error) else _finish_reason(req)
        yield self._final(call, rid, req, finish, error=error)

    def _stream_tools(self, call: Call, rid: str):
        """Tool calls as OpenAI ``tool_calls`` deltas: a call is committed
        once its envelope parses, its arguments stream in fragments."""
        model, req = call.model, call.req
        yield _chunk(model, rid, {"role": "assistant"})
        streamer = tools_mod.ToolCallStreamer(call.tools)

        def deltas(events):
            for ev in events:
                if ev[0] == "content":
                    delta: Dict[str, Any] = {"content": ev[1]}
                elif ev[0] == "tool_start":
                    delta = {"tool_calls": [{
                        "index": ev[1], "id": f"call_{uuid.uuid4().hex[:12]}",
                        "type": "function",
                        "function": {"name": ev[2], "arguments": ""}}]}
                else:   # tool_args
                    delta = {"tool_calls": [{
                        "index": ev[1], "function": {"arguments": ev[2]}}]}
                yield _chunk(model, rid, delta)

        for text in self.scheduler.iter_text(req):
            yield from deltas(streamer.feed(text))
        yield from deltas(streamer.finish())
        finish = ("error" if req.error
                  else "tool_calls" if streamer.committed
                  else _finish_reason(req))
        yield self._final(call, rid, req, finish)

    def _stream_buffered(self, call: Call, rid: str):
        """A buffered tool or JSON reply as a stream: the role chunk, one
        delta with the whole content or tool calls, the final chunk."""
        model, req = call.model, call.req
        yield _chunk(model, rid, {"role": "assistant"})
        text = self._text(req)
        if req.error:
            yield self._final(call, rid, req, "error")
            return
        message, finish = self._message(call, text)
        delta: Dict[str, Any] = {}
        if message.get("tool_calls"):
            delta["tool_calls"] = [{"index": i, **c} for i, c in
                                   enumerate(message["tool_calls"])]
        else:
            delta["content"] = message.get("content") or ""
        yield _chunk(model, rid, delta)
        yield self._final(call, rid, req, finish)


def _handler_class(server: ModelServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.0"   # one response per connection

        def log_message(self, fmt, *args):   # route access logs to logging
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _json(self, status: int, body: Dict[str, Any]) -> None:
            self._bytes(status, json.dumps(body).encode(), "application/json")

        def _bytes(self, status: int, data: bytes, ctype: str,
                   rid: Optional[str] = None,
                   kv_prefix: Optional[str] = None) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            if rid:
                self.send_header("X-Request-Id", rid)
            if kv_prefix is not None:
                self.send_header("X-KV-Prefix", kv_prefix)
            self.end_headers()
            self.wfile.write(data)

        def _sse(self, rid: str, payloads,
                 kv_prefix: Optional[str] = None) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("X-Request-Id", rid)
            if kv_prefix is not None:
                self.send_header("X-KV-Prefix", kv_prefix)
            self.end_headers()
            for payload in payloads:
                self.wfile.write(f"data: {payload}\n\n".encode())
                self.wfile.flush()

        def _guarded(self, fn):
            """Run a route; its refusals answer 400, 404, 409 or 503."""
            try:
                return fn()
            except NotFound as exc:
                self._json(404, {"error": str(exc)})
            except Conflict as exc:
                self._json(409, {"error": str(exc)})
            except Unavailable as exc:
                self._json(503, {"error": str(exc)})
            except (BadRequest, ValueError, NotImplementedError) as exc:
                self._json(400, {"error": str(exc)})
            return None

        def do_GET(self):
            path, query = common.split_path(self.path)
            if path == "/health":
                self._json(*server.health())
            elif path == "/metrics":
                body, ctype = common.metrics_body(
                    query.get("format", ""), self.headers.get("Accept", ""))
                self._bytes(200, body, ctype)
            elif path == "/v1/models":
                self._json(200, server.models())
            elif path.startswith("/v1/kv/evacuation/"):
                def evac():
                    server.chaos_gate("engine.kv_evacuation")
                    return server.kv_evacuation(
                        path[len("/v1/kv/evacuation/"):],
                        self.headers.get("Accept", ""))
                out = self._guarded(evac)
                if out is not None:
                    self._bytes(200, out.body, out.content_type, out.rid)
            else:
                got = common.debug_get(path, query)
                if got is None:
                    self._json(404, {"error": f"no route {self.path}"})
                else:
                    self._json(*got)

        def _read(self) -> bytes:
            length = int(self.headers.get("Content-Length") or 0)
            return self.rfile.read(length) if length else b""

        def _json_body(self, raw: bytes) -> Dict[str, Any]:
            body = json.loads(raw or b"{}")
            if not isinstance(body, dict):
                raise BadRequest("the request body must be a JSON object")
            return body

        def do_POST(self):
            path, query = common.split_path(self.path)
            if path == "/debug/drain":
                self._read()
                self._json(*server.debug_drain(query))
                return
            routes = {"/v1/chat/completions": "engine.chat",
                      "/v1/completions": "engine.completions",
                      "/v1/kv/prefill": "engine.kv_prefill",
                      "/v1/kv/handoff": "engine.kv_handoff"}
            if path not in routes:
                self._json(404, {"error": f"no route {self.path}"})
                return
            raw = self._read()
            if self._guarded(lambda: server.chaos_gate(routes[path])
                             or True) is None:
                return
            if path == "/v1/kv/prefill":
                try:
                    out = self._guarded(lambda: server.kv_prefill(
                        self._json_body(raw),
                        self.headers.get("Accept", ""), self.headers))
                except RuntimeError as exc:   # the prefill itself failed
                    self._json(503, {"error": str(exc)})
                    return
                if out is not None:
                    self._bytes(200, out.body, out.content_type, out.rid)
                return
            if path == "/v1/kv/handoff":
                got = self._guarded(lambda: server.kv_handoff(
                    raw, self.headers.get("Content-Type", ""),
                    self.headers.get("X-Resume-Chars"), self.headers))
                if got is not None:
                    req, model = got
                    self._sse(req.request_id,
                              server.handoff_stream(req, model))
                return
            call = self._guarded(lambda: server.submit(
                path, self._json_body(raw), self.headers))
            if call is None:
                return
            # every completion carries the prompt's tier prefix hash
            if not call.stream:
                payload = server.complete(call)
                self._bytes(503 if call.req.error else 200,
                            json.dumps(payload).encode(), "application/json",
                            call.req.request_id, kv_prefix=call.kv_prefix)
                return
            self._sse(call.req.request_id, server.stream(call),
                      kv_prefix=call.kv_prefix)

    return Handler


def make_server(scheduler: Scheduler, model_name: str, host: str = "0.0.0.0",
                port: int = 8000,
                watchdog: Optional[EngineWatchdog] = None
                ) -> ThreadingHTTPServer:
    """A bound, not yet serving, HTTP server (port 0 picks a free port).
    ``httpd.model_server`` is its ModelServer."""
    model_server = ModelServer(scheduler, model_name, watchdog=watchdog)
    httpd = ThreadingHTTPServer((host, port), _handler_class(model_server))
    httpd.daemon_threads = True
    httpd.model_server = model_server
    return httpd


def install_sigterm_drain(scheduler: Scheduler,
                          watchdog: Optional[EngineWatchdog],
                          grace_s: Optional[float] = None, exit_fn=None):
    """SIGTERM -> graceful drain and evacuation: the handler flags the
    drain (health 503), queues a non-blocking full evacuation (every live
    slot's snapshot parks at ``/v1/kv/evacuation/<rid>`` while HTTP keeps
    serving), then exits after ``APP_DRAIN_GRACE_S`` (default 10 s),
    flushing the event trace first. Installs only from the main thread;
    returns the handler either way (tests call it, ``exit_fn`` injects
    the exit)."""
    import signal

    if grace_s is None:
        try:
            grace_s = float(os.environ.get("APP_DRAIN_GRACE_S", "") or 10.0)
        except ValueError:
            grace_s = 10.0
    exit_fn = exit_fn if exit_fn is not None else (lambda: os._exit(0))
    fired = {"done": False}

    def _handler(signum, frame):
        if fired["done"]:
            return   # a second TERM inside the grace window is a no-op
        fired["done"] = True
        logger.warning("SIGTERM: draining (+evacuating live streams); "
                       "exiting in %.1fs", grace_s)
        if watchdog is not None:
            watchdog.drain()
        # non-blocking: HTTP must keep serving the snapshot pulls
        scheduler.request_evacuation(wait_s=0.0, reason="sigterm")

        def _exit_after_grace():
            time.sleep(grace_s)
            logger.warning("drain grace elapsed; exiting")
            # os._exit skips atexit: push the trace tail to its sink first
            from generativeaiexamples_tpu_torch.observability.trace import (
                TRACE)
            TRACE.flush()
            exit_fn()

        threading.Thread(target=_exit_after_grace, name="drain-exit",
                         daemon=True).start()

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _handler)
    else:
        logger.debug("not on the main thread; SIGTERM handler not "
                     "installed")
    return _handler


def serve_in_thread(scheduler: Scheduler, model_name: str,
                    host: str = "127.0.0.1", port: int = 0,
                    watchdog: Optional[EngineWatchdog] = None):
    """Start the scheduler and an HTTP server on a background thread.
    Returns (httpd, thread); stop with ``httpd.shutdown()`` and
    ``scheduler.stop()`` (and the watchdog's ``stop()``)."""
    httpd = make_server(scheduler, model_name, host, port, watchdog)
    scheduler.start()
    thread = threading.Thread(target=httpd.serve_forever, name="http",
                              daemon=True)
    thread.start()
    return httpd, thread


def run_server(scheduler: Scheduler, model_name: str, host: str = "0.0.0.0",
               port: int = 8000) -> None:
    """Serve until interrupted: the observability planes, a watchdog
    unless ``APP_WATCHDOG=off``, and SIGTERM as a drain."""
    from generativeaiexamples_tpu_torch.observability.bootstrap import (
        init_observability)
    init_observability("engine")
    watchdog = None
    if watchdog_enabled():
        watchdog = EngineWatchdog(scheduler)
        watchdog.start()
    httpd = make_server(scheduler, model_name, host, port, watchdog)
    scheduler.start()
    install_sigterm_drain(scheduler, watchdog)
    logger.info("serving %s on http://%s:%d", model_name, host,
                httpd.server_address[1])
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        if watchdog is not None:
            watchdog.stop()
        scheduler.stop()
