"""Live KV migration and host-spill preemption in the PyTorch port, against
the JAX package on the CPU (the tiny model, ``PRNGKey(5)`` weights through
``params_from_jax``).

Every engine, scheduler and server case of ``tests/test_live_migration.py``
has its counterpart here (the drain route, SIGTERM, the watchdog trip, the
router and the timeline wait for their modules: ROADMAP A.10, A.17):

* streams evacuated mid-decode (seeded and greedy), their snapshots
  through the binary frame, resume on a peer and each joined stream equals
  the unevacuated one and the JAX ``Scheduler``'s, over both pools
  (speculation on over the model-dtype pool), a grammared stream too (and
  it validates); a snapshot is served once; ``resume_chars`` re-emits the
  undelivered gap;
* a request that cannot be snapshotted (still pending) ends "evacuated"
  without a snapshot and without text;
* with a spill budget, a page-exhaust preemption demotes the victim's
  pages and promotes them back with no prefill (no prefill or mixed
  dispatch, no call of the paged prefill passes after the promotion), the
  streams (seeded and greedy) equal the roomy pool's and the JAX
  ``Scheduler``'s over both pools, and the budget drains to 0; a pool too small for a snapshot recomputes with the
  same streams and counts ``kv_spill_over_budget``;
* a guarded evacuation whose guard reads False is cancelled; an unpulled
  snapshot expires after ``APP_EVAC_TTL_S``;
* over HTTP: ``GET /v1/kv/evacuation/<rid>`` takes a live stream's
  snapshot on demand (its stream ends "evacuated"), serves it once (then
  404), and a peer's ``/v1/kv/handoff`` resumes it, ``X-Resume-Chars``
  counting what the client was delivered.

Streams are compared token for token (text and ids).
"""

import json
import time
import urllib.error
import urllib.request

import pytest

from generativeaiexamples_tpu.engine.scheduler import Request as JaxRequest
from generativeaiexamples_tpu_torch.core import kv_wire
from generativeaiexamples_tpu_torch.engine import grammar as grammar_mod
from generativeaiexamples_tpu_torch.engine import kv_cache
from generativeaiexamples_tpu_torch.engine.scheduler import Request
from generativeaiexamples_tpu_torch.engine.server import serve_in_thread
from tests.test_constrained import validates
from tests.test_torch_kv_handoff import (JTOK, TOK, _drive, _jax_sched,
                                         _mk_sched, _text, one_thread,
                                         tiny)  # noqa: F401

pytestmark = pytest.mark.filterwarnings("ignore")


def _drive_until(sched, req, min_tokens: int, ticks: int = 4000) -> None:
    """Tick until the request has streamed at least ``min_tokens``."""
    for _ in range(ticks):
        sched._tick()
        if req.completion_tokens >= min_tokens:
            return
        if req.finished_at is not None:
            raise AssertionError(f"finished at {req.completion_tokens} "
                                 f"tokens before reaching {min_tokens}")
    raise AssertionError("never reached the token threshold")


def _evacuate(sched, ticks: int = 50) -> None:
    """Queue a full evacuation and tick until it ran."""
    res = sched.request_evacuation(wait_s=0.0)
    assert res.get("queued")
    for _ in range(ticks):
        sched._tick()
        if not sched._evac_reqs:
            return
    raise AssertionError("evacuation never ran")


def _jax_stream(tiny, prompt, kw, kv_quant="none", spec="off"):
    r = JaxRequest(prompt_ids=JTOK.encode(prompt), logprobs=True, **kw)
    _drive(_jax_sched(tiny, "decode", kv_quant, spec), [r])
    assert r.error is None
    return [t for t, _lp, _top in r.logprob_data]


# ------------------------------------------------ mid-stream snapshot resume

@pytest.mark.parametrize("kv_quant,spec", [("none", "on"), ("int8", "off")])
def test_evacuated_stream_resumes_token_identical(tiny, kv_quant, spec):
    """Evacuate two slots mid-decode (one seeded, one greedy), pass their
    snapshots through the binary frame, resume them on a peer: each joined
    stream equals the unevacuated one and the JAX stream; a resume starts
    at its snapshot's position (``snapshot_resumes``), never at token 0."""
    prompts = ["the quick brown fox jumps over the lazy dog",
               "pack my box with five dozen liquor jugs"]
    kws = [dict(max_tokens=14, temperature=0.7, seed=123),
           dict(max_tokens=14, temperature=0.0, seed=1)]
    peer = _mk_sched(tiny, "decode", kv_quant, spec)
    refs = _drive(peer, [Request(prompt_ids=TOK.encode(p), **kw)
                         for p, kw in zip(prompts, kws)])
    oracles = [_text(r) for r in refs]
    assert all(oracles)
    for ref, p, kw in zip(refs, prompts, kws):
        assert ref.output_ids == _jax_stream(tiny, p, kw, kv_quant, spec)

    src = _mk_sched(tiny, "decode", kv_quant, spec)
    rs = [Request(prompt_ids=TOK.encode(p), **kw)
          for p, kw in zip(prompts, kws)]
    for r in rs:
        src.submit(r)
    for r in rs:
        _drive_until(src, r, min_tokens=4)
    _evacuate(src)
    assert src.stats["evacuations_snapshot"] == 2
    prefills = peer.stats["prefill_dispatches"]
    for r, ref, oracle, kw in zip(rs, refs, oracles, kws):
        assert r.finished_at is not None
        assert r.finish_reason == "evacuated" and r.error is None
        pre = _text(r)
        assert oracle.startswith(pre) and pre != oracle
        payload = src.take_evacuated(r.request_id)
        assert payload is not None
        assert src.take_evacuated(r.request_id) is None   # served once
        payload = dict(kv_wire.decode_kv_frames(kv_wire.encode_kv_frames(
            payload)))
        assert payload["resume"] is True and payload["generated"] >= 4
        rd = Request(prompt_ids=[int(t) for t in payload["prompt_ids"]],
                     **kw)
        peer.submit_prefilled(rd, payload)
        _drive(peer, [rd], submit=False)
        assert rd.error is None, rd.error
        assert pre + _text(rd) == oracle
        assert rd.output_ids == ref.output_ids
        assert rd.snapshot_resumes == 1
    assert peer.stats["prefill_dispatches"] == prefills


def test_evacuated_grammar_stream_resumes_token_identical(tiny):
    """A grammared stream: the DFA state rides as the spec and is rebuilt
    by walking the emitted tokens; the joined stream equals the unevacuated
    one, validates, and enforcement stays attached."""
    schema = {"type": "array", "items": {"type": "integer"}, "minItems": 1}
    prompt = TOK.encode("reply with a JSON array of integers")
    kw = dict(max_tokens=24, temperature=1.0, seed=77)
    peer = _mk_sched(tiny, "decode")
    (ref,) = _drive(peer, [Request(
        prompt_ids=list(prompt),
        grammar=grammar_mod.Grammar.from_schema(schema), **kw)])
    assert ref.grammar_attached is True
    oracle = _text(ref)
    assert validates(json.loads(oracle), schema), oracle

    src = _mk_sched(tiny, "decode")
    r = Request(prompt_ids=list(prompt),
                grammar=grammar_mod.Grammar.from_schema(schema),
                grammar_spec=("schema", json.dumps(schema)), **kw)
    src.submit(r)
    _drive_until(src, r, min_tokens=3)
    _evacuate(src)
    assert r.finish_reason == "evacuated"
    pre = _text(r)
    payload = src.take_evacuated(r.request_id)
    assert payload["grammar_kind"] == "schema"
    assert payload["grammar_attached"] is True
    payload = dict(kv_wire.decode_kv_frames(kv_wire.encode_kv_frames(
        payload)))
    rd = Request(prompt_ids=[int(t) for t in payload["prompt_ids"]],
                 grammar=grammar_mod.Grammar.from_schema(
                     json.loads(payload["grammar_payload"])), **kw)
    peer.submit_prefilled(rd, payload)
    _drive(peer, [rd], submit=False)
    assert rd.error is None, rd.error
    assert rd.grammar_attached is True
    combined = pre + _text(rd)
    assert combined == oracle
    assert validates(json.loads(combined), schema), combined


def test_resume_chars_reemits_undelivered_gap(tiny):
    """The client was delivered fewer characters than the evacuated worker
    streamed: ``resume_chars`` makes the resume emit exactly the gap."""
    prompt = TOK.encode("pack my box with five dozen jugs")
    kw = dict(max_tokens=12, temperature=0.7, seed=9)
    peer = _mk_sched(tiny, "decode")
    (ref,) = _drive(peer, [Request(prompt_ids=list(prompt), **kw)])
    oracle = _text(ref)
    src = _mk_sched(tiny, "decode")
    r = Request(prompt_ids=list(prompt), **kw)
    src.submit(r)
    _drive_until(src, r, min_tokens=5)
    _evacuate(src)
    pre = _text(r)
    payload = dict(src.take_evacuated(r.request_id))
    delivered = min(2, len(pre))
    payload["resume_chars"] = delivered
    rd = Request(prompt_ids=[int(t) for t in payload["prompt_ids"]], **kw)
    peer.submit_prefilled(rd, payload)
    _drive(peer, [rd], submit=False)
    assert rd.error is None, rd.error
    assert pre[:delivered] + _text(rd) == oracle


def test_unsnapshotable_slots_end_loud_for_reprefill(tiny):
    """A request evacuated while still pending carries no snapshot: its
    stream ends "evacuated" (the caller re-prefills), never silently."""
    src = _mk_sched(tiny, "decode")
    r = Request(prompt_ids=TOK.encode("hello"), max_tokens=8,
                temperature=0.0)
    src.submit(r)
    _evacuate(src)
    assert r.finish_reason == "evacuated" and r.error is None
    assert src.take_evacuated(r.request_id) is None
    assert _text(r) == ""
    assert src.stats["evacuations_reprefill"] == 1


# --------------------------------------------------- host-spill preemption

PA = "the quick brown fox jumps over the lazy"
PB = "pack my box with five dozen liquor ju"
KWA = dict(max_tokens=60, temperature=0.7, seed=11)
KWB = dict(max_tokens=60, temperature=0.0, seed=22)


def _mk_tight(tiny, num_pages, monkeypatch, spill_mb, kv_quant="none"):
    if spill_mb is None:
        monkeypatch.delenv("APP_KV_SPILL_MB", raising=False)
    else:
        monkeypatch.setenv("APP_KV_SPILL_MB", str(spill_mb))
    return _mk_sched(tiny, kv_quant=kv_quant, max_batch_size=2,
                     num_pages=num_pages, prefix_cache="off")


@pytest.fixture
def prefill_calls(monkeypatch):
    """Calls of the paged prefill passes (grouped and mixed)."""
    calls = []
    for name in ("prefill_chunks", "mixed_step"):
        fn = getattr(kv_cache, name)
        monkeypatch.setattr(kv_cache, name,
                            lambda *a, _f=fn, **k: calls.append(1)
                            or _f(*a, **k))
    return calls


def _roomy(tiny, monkeypatch, kv_quant="none"):
    big = _mk_tight(tiny, 0, monkeypatch, spill_mb=None, kv_quant=kv_quant)
    return _drive(big, [Request(prompt_ids=TOK.encode(PA), **KWA),
                        Request(prompt_ids=TOK.encode(PB), **KWB)])


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_spill_preemption_zero_prefill_token_identical(tiny, monkeypatch,
                                                       prefill_calls,
                                                       kv_quant):
    """With a spill budget, page exhaustion demotes the victim's pages to
    host RAM and promotes them back: after the promotion no prefill runs,
    and both streams (seeded and greedy) equal the roomy pool's and the JAX
    ``Scheduler``'s, over both pools."""
    o1, o2 = _roomy(tiny, monkeypatch, kv_quant)
    assert o1.output_ids == _jax_stream(tiny, PA, KWA, kv_quant)
    assert o2.output_ids == _jax_stream(tiny, PB, KWB, kv_quant)
    # 2 slots x 3 prompt pages + 2 spares: decode growth exhausts the pool
    sched = _mk_tight(tiny, 8, monkeypatch, spill_mb=64, kv_quant=kv_quant)
    assert sched._spill is not None
    r1 = Request(prompt_ids=TOK.encode(PA), **KWA)
    r2 = Request(prompt_ids=TOK.encode(PB), **KWB)
    sched.submit(r1)
    sched.submit(r2)
    for _ in range(6000):
        sched._tick()
        if r1.spill_resumes + r2.spill_resumes >= 1:
            break
    else:
        raise AssertionError("no spill resume under page pressure")
    at_resume = (len(prefill_calls), sched.stats["prefill_dispatches"],
                 sched.stats["mixed_dispatches"])
    _drive(sched, [r1, r2], submit=False, ticks=6000)
    assert r1.error is None and r2.error is None
    assert (len(prefill_calls), sched.stats["prefill_dispatches"],
            sched.stats["mixed_dispatches"]) == at_resume, \
        "the spill promotion ran a prefill"
    assert r1.preemptions + r2.preemptions >= 1
    assert r1.spill_resumes + r2.spill_resumes >= 1
    assert sched.stats["spill_resumes"] >= 1
    assert sched.stats["kv_spill_spilled"] == sched.stats["kv_spill_promoted"]
    assert r1.output_ids == o1.output_ids and r2.output_ids == o2.output_ids
    assert _text(r1) == _text(o1) and _text(r2) == _text(o2)
    assert sched._spill.used_bytes == 0
    assert sched.load_stats()["kv_spill_budget_bytes"] == 64 << 20


def test_spill_over_budget_falls_back_to_recompute(tiny, monkeypatch):
    """A pool too small for any snapshot takes the recompute path: the same
    streams, no spill resume, ``kv_spill_over_budget`` counted."""
    o1, o2 = _roomy(tiny, monkeypatch)
    sched = _mk_tight(tiny, 8, monkeypatch, spill_mb=64)
    sched._spill.budget_bytes = 1
    r1 = Request(prompt_ids=TOK.encode(PA), **KWA)
    r2 = Request(prompt_ids=TOK.encode(PB), **KWB)
    _drive(sched, [r1, r2], ticks=6000)
    assert r1.error is None and r2.error is None
    assert r1.spill_resumes + r2.spill_resumes == 0
    assert r1.preemptions + r2.preemptions >= 1
    assert sched.stats["kv_spill_over_budget"] >= 1
    assert _text(r1) == _text(o1) and _text(r2) == _text(o2)
    assert sched._spill.used_bytes == 0


# ------------------------------------------------------ evacuation control

def test_guarded_evacuation_cancels_when_condition_cleared(tiny):
    """A queued evacuation whose guard reads False when the driver acts is
    cancelled: the stream keeps serving to its natural end."""
    sched = _mk_sched(tiny, "decode")
    r = Request(prompt_ids=TOK.encode("the quick brown fox jumps over"),
                max_tokens=12, temperature=0.0, seed=3)
    sched.submit(r)
    _drive_until(sched, r, min_tokens=2)
    res = sched.request_evacuation(wait_s=0.0, guard=lambda: False)
    assert res.get("queued")
    _drive(sched, [r], submit=False)
    assert r.error is None
    assert r.finish_reason in ("eos", "stop", "length")
    assert _text(r)


def test_evacuation_outbox_ttl_expires_unpulled_snapshots(tiny):
    """Past ``APP_EVAC_TTL_S`` an unpulled snapshot expires (counted) and
    its pull finds nothing."""
    sched = _mk_sched(tiny, "decode")
    r = Request(prompt_ids=TOK.encode("the quick brown fox jumps over"),
                max_tokens=12, temperature=0.7, seed=5)
    sched.submit(r)
    _drive_until(sched, r, min_tokens=3)
    sched._evac_ttl_s = 0.05
    _evacuate(sched)
    assert r.finish_reason == "evacuated"
    assert sched.evacuated_ids() == [r.request_id]
    time.sleep(0.1)
    assert sched.take_evacuated(r.request_id) is None
    assert sched.stats["evacuation_snapshots_expired"] == 1


# ------------------------------------------------------- HTTP surface (e2e)

def test_evacuation_pull_resumes_over_http(tiny):
    """A live streamed chat is pulled through ``GET /v1/kv/evacuation/<rid>``
    (the slot snapshotted on demand; its stream ends "evacuated"), a second
    pull is 404, and the peer's ``/v1/kv/handoff`` with ``X-Resume-Chars``
    streams the rest: the joined text equals the peer's own answer."""
    body = {"messages": [{"role": "user", "content": "write about pumps"}],
            "max_tokens": 40, "temperature": 0.7, "seed": 4, "stream": True}
    servers = []
    for _ in range(2):
        sched = _mk_sched(tiny, "decode")
        httpd, _ = serve_in_thread(sched, "tiny")
        servers.append((f"http://127.0.0.1:{httpd.server_address[1]}", sched,
                        httpd))
    (src_url, src, _), (peer_url, peer, _) = servers
    dispatch = src._dispatch_decode

    def slow_dispatch(*a, **k):
        time.sleep(0.05)    # the client reads a token while decode runs
        return dispatch(*a, **k)

    src._dispatch_decode = slow_dispatch
    try:
        oracle_body = dict(body, stream=False)
        req = urllib.request.Request(
            peer_url + "/v1/chat/completions",
            data=json.dumps(oracle_body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            oracle = json.loads(resp.read())["choices"][0]["message"][
                "content"]
        req = urllib.request.Request(
            src_url + "/v1/chat/completions", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        delivered, finish, frame = [], None, None
        with urllib.request.urlopen(req, timeout=120) as resp:
            rid = resp.headers["X-Request-Id"]
            for line in resp:
                line = line.decode().strip()
                if not line.startswith("data: ") or line == "data: [DONE]":
                    continue
                choice = json.loads(line[6:])["choices"][0]
                content = choice["delta"].get("content")
                if content:
                    delivered.append(content)
                finish = choice.get("finish_reason") or finish
                if frame is None and content:
                    pull = urllib.request.Request(
                        src_url + f"/v1/kv/evacuation/{rid}",
                        headers={"Accept": kv_wire.KV_FRAMES_CONTENT_TYPE})
                    with urllib.request.urlopen(pull, timeout=60) as got:
                        assert got.headers.get("Content-Type") == \
                            kv_wire.KV_FRAMES_CONTENT_TYPE
                        frame = got.read()
        assert finish == "evacuated"
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(src_url + f"/v1/kv/evacuation/{rid}",
                                   timeout=60)
        assert err.value.code == 404
        pre = "".join(delivered)
        assert oracle.startswith(pre) and pre != oracle
        resume = urllib.request.Request(
            peer_url + "/v1/kv/handoff", data=frame,
            headers={"Content-Type": kv_wire.KV_FRAMES_CONTENT_TYPE,
                     "X-Resume-Chars": str(len(pre))})
        with urllib.request.urlopen(resume, timeout=120) as resp:
            raw = resp.read().decode()
        rest = "".join(
            json.loads(line[6:])["choices"][0]["delta"].get("content", "")
            for line in raw.splitlines()
            if line.startswith("data: ") and line != "data: [DONE]")
        assert pre + rest == oracle
        assert peer.stats["snapshot_resumes"] == 1
    finally:
        for _, sched, httpd in servers:
            httpd.shutdown()
            httpd.server_close()
            sched.stop()
