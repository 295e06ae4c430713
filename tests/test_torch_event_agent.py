"""The event agent and the resilience policy in the PyTorch port, against
the JAX package on the CPU.

``chains/event_agent.py`` and ``server/resilience.py`` run beside the
reference's with the same inputs:

  * **the resilience policy** (``tests/test_resilience.py``'s cases): the
    backoff's bounds, growth and jitter (with a seeded ``random.Random``
    both packages draw the same delays), the retry budget's token bucket
    and its bound on amplification, the attempt cap, the budget and an
    explicit deadline as denials counted under the reference's names, and
    the hedged call. The reference's ambient SLO read waits for ROADMAP
    A.10, so the port's policy reads no deadline when given none;
  * **the event agent** (``tests/test_event_agent.py``'s cases): the
    concurrency cap, retries then the dead letter and the result sink, the
    backoff it sleeps, the process-wide dead-letter ring and its counter,
    the JSONL source; each run's results and dead letters equal the
    reference's on the same handler;
  * **the CVE triage handler**: over the same scripted LLM and retrieval
    both packages send the same prompt and return the same verdict, and
    refuse a reply without one alike; over the same tiny weights (the tiny
    llama of ``jax.random.PRNGKey(99)`` through ``llama.params_from_jax``,
    greedy) with the handler's LLM under a verdict schema's grammar, six
    events and a poisoned one through ``EventDrivenAgent`` give equal
    verdicts (each valid under the schema) and equal dead letters.
"""

import json
import random
import threading
import time

import jax
import numpy as np
import pytest

from generativeaiexamples_tpu.chains import event_agent as jevent
from generativeaiexamples_tpu.chains.llm_client import LocalLLM as JLocalLLM
from generativeaiexamples_tpu.core import config as jconfig
from generativeaiexamples_tpu.engine import grammar as jgrammar
from generativeaiexamples_tpu.engine.engine import EngineCore as JCore
from generativeaiexamples_tpu.engine.scheduler import Scheduler as JScheduler
from generativeaiexamples_tpu.engine.tokenizer import ByteTokenizer as JByte
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.retrieval.store import Document as JDocument
from generativeaiexamples_tpu.server import resilience as jres
from generativeaiexamples_tpu_torch.chains import event_agent as tevent
from generativeaiexamples_tpu_torch.chains.llm_client import LocalLLM
from generativeaiexamples_tpu_torch.core import config as tconfig
from generativeaiexamples_tpu_torch.core.metrics import REGISTRY
from generativeaiexamples_tpu_torch.engine import grammar as tgrammar
from generativeaiexamples_tpu_torch.engine.engine import EngineCore
from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.retrieval.store import Document
from generativeaiexamples_tpu_torch.server import resilience as tres
from test_torch_chains import GEOMETRY

PACKAGES = {"jax": (jevent, jres, JDocument),
            "torch": (tevent, tres, Document)}


# --------------------------------------------------------------- backoff

def test_full_jitter_backoff_bounds_and_growth():
    rng = random.Random(0)
    for attempt in range(1, 12):
        ceiling = min(60.0, 0.5 * 2 ** (attempt - 1))
        for _ in range(50):
            d = tres.full_jitter_backoff(attempt, base_s=0.5, cap_s=60.0,
                                         rng=rng)
            assert 0.0 <= d <= ceiling


def test_full_jitter_backoff_draws_equal_the_reference():
    for seed in (0, 3, 7):
        got = [tres.full_jitter_backoff(i, base_s=0.3, cap_s=5.0,
                                        rng=random.Random(seed))
               for i in range(1, 9)]
        want = [jres.full_jitter_backoff(i, base_s=0.3, cap_s=5.0,
                                         rng=random.Random(seed))
                for i in range(1, 9)]
        assert got == want
    rng = random.Random(3)
    draws = {tres.full_jitter_backoff(4, base_s=1.0, cap_s=60.0, rng=rng)
             for _ in range(20)}
    assert len(draws) > 10          # jittered, not a deterministic 2**n


# ---------------------------------------------------------------- budget

def test_retry_budget_token_bucket_semantics():
    exhausted = REGISTRY.counter("retry_budget_exhausted_total",
                                 labels={"pool": "t"})
    before = exhausted.value
    b = tres.RetryBudget("t", ratio=0.5, burst=2.0)
    assert b.tokens == 2.0                     # starts full
    assert b.try_spend() and b.try_spend()
    assert not b.try_spend()                   # empty: refuse
    b.note_request()                           # +0.5
    assert not b.try_spend()                   # 0.5 < 1
    b.note_request()
    assert b.try_spend()                       # 1.0 spends
    for _ in range(100):
        b.note_request()
    assert b.tokens == 2.0                     # deposits cap at burst
    assert exhausted.value == before + 2


def test_retry_budget_bounds_amplification_under_sustained_outage():
    """With every attempt failing, total retries stay within ratio x
    requests + burst, in both packages alike."""
    counts = {}
    for name, (_, res, _) in PACKAGES.items():
        budget = res.RetryBudget("outage", ratio=0.2, burst=3.0)
        policy = res.ResiliencePolicy("outage", max_attempts=5, base_s=0.0,
                                      cap_s=0.0, budget=budget,
                                      sleep=lambda s: None)
        n_requests, retries = 40, 0
        for _ in range(n_requests):
            policy.note_request()
            for attempt in range(1, policy.max_attempts):
                if not policy.before_retry(attempt, deadline_s=60.0):
                    break
                retries += 1
        assert 3 <= retries <= 0.2 * n_requests + 3.0
        counts[name] = retries
    assert counts["torch"] == counts["jax"]


# ---------------------------------------------------------------- policy

def test_policy_sleeps_jittered_backoff_between_retries():
    slept = {}
    for name, (_, res, _) in PACKAGES.items():
        slept[name] = []
        policy = res.ResiliencePolicy("p", max_attempts=4, base_s=0.1,
                                      cap_s=1.0, rng=random.Random(1),
                                      sleep=slept[name].append)
        assert policy.before_retry(1, deadline_s=60.0)
        assert policy.before_retry(2, deadline_s=60.0)
    assert len(slept["torch"]) == 2 and slept["torch"] == slept["jax"]
    assert 0.0 <= slept["torch"][0] <= 0.1
    assert 0.0 <= slept["torch"][1] <= 0.2


def _denied(pool, reason):
    return REGISTRY.counter("retries_denied_total",
                            labels={"pool": pool, "reason": reason}).value


def test_policy_denies_past_attempt_cap():
    before = _denied("cap", "attempts")
    policy = tres.ResiliencePolicy("cap", max_attempts=2,
                                   sleep=lambda s: None)
    assert policy.before_retry(1)
    assert not policy.before_retry(2)
    assert _denied("cap", "attempts") == before + 1


def test_policy_denies_when_the_budget_is_spent():
    before = _denied("spent", "budget")
    budget = tres.RetryBudget("spent", ratio=0.0, burst=1.0)
    policy = tres.ResiliencePolicy("spent", max_attempts=4, base_s=0.0,
                                   cap_s=0.0, budget=budget,
                                   sleep=lambda s: None)
    assert policy.before_retry(1)
    assert not policy.before_retry(2)
    assert _denied("spent", "budget") == before + 1


def test_policy_deadline_cutoff_sheds_instead_of_retrying():
    before = _denied("ddl", "deadline")
    policy = tres.ResiliencePolicy("ddl", max_attempts=4, base_s=0.2,
                                   cap_s=0.2, rng=random.Random(2),
                                   sleep=lambda s: None)
    assert not policy.before_retry(1, deadline_s=0.0)
    assert policy.before_retry(1, deadline_s=10.0)
    assert _denied("ddl", "deadline") == before + 1


def test_policy_reads_no_ambient_deadline_until_the_slo_plane():
    """Given no deadline, both packages' policies read their SLO plane's
    admission context (the port's since ROADMAP A.10's first part; the
    test keeps its name). Outside such a context both approve alike;
    inside one past its deadline both shed; inside one with budget to
    spare both approve."""
    from generativeaiexamples_tpu.observability import slo as jslo
    from generativeaiexamples_tpu_torch.observability import slo as tslo

    policies = {name: res.ResiliencePolicy("amb", max_attempts=4,
                                           base_s=0.05, cap_s=0.05,
                                           sleep=lambda s: None)
                for name, (_, res, _) in PACKAGES.items()}
    assert all(p.before_retry(1) for p in policies.values())
    before = _denied("amb", "deadline")
    with jslo.admission("interactive", deadline_ms=0.0), \
            tslo.admission("interactive", deadline_ms=0.0):
        assert [p.before_retry(1) for p in policies.values()] == [False,
                                                                  False]
    assert _denied("amb", "deadline") == before + 1
    with jslo.admission("batch", deadline_ms=60000.0), \
            tslo.admission("batch", deadline_ms=60000.0):
        assert all(p.before_retry(1) for p in policies.values())
    # an explicit deadline sheds in both
    assert not any(p.before_retry(1, deadline_s=0.0)
                   for p in policies.values())


# ----------------------------------------------------------------- hedge

def test_hedged_call_fast_primary_never_hedges():
    hedges = REGISTRY.counter("hedges_total", labels={"pool": "h1"})
    before = hedges.value
    result, ix = tres.hedged_call([lambda: "primary", lambda: "secondary"],
                                  hedge_after_s=0.2, name="h1")
    assert (result, ix) == ("primary", 0)
    assert hedges.value == before


def test_hedged_call_slow_primary_loses_to_hedge():
    cancelled = []
    release = threading.Event()

    def slow():
        release.wait(timeout=5.0)
        return "slow"

    wins = REGISTRY.counter("hedge_wins_total", labels={"pool": "h2"})
    before = wins.value
    result, ix = tres.hedged_call([slow, lambda: "fast"], hedge_after_s=0.02,
                                  cancel=cancelled.append, name="h2")
    assert (result, ix) == ("fast", 1)
    assert wins.value == before + 1
    release.set()
    deadline = time.monotonic() + 2.0
    while not cancelled and time.monotonic() < deadline:
        time.sleep(0.005)
    assert cancelled == ["slow"]       # the straggler was reaped


def test_hedged_call_fast_failure_fails_over_immediately():
    t0 = time.monotonic()
    errors = []

    def boom():
        raise ConnectionError("down")

    result, ix = tres.hedged_call([boom, lambda: "ok"], hedge_after_s=5.0,
                                  on_error=lambda i, e: errors.append(i),
                                  name="h3")
    assert (result, ix) == ("ok", 1)
    assert errors == [0]
    assert time.monotonic() - t0 < 2.0   # did not wait out the window


def test_hedged_call_all_failures_raise_last_error():
    def boom_a():
        raise ConnectionError("a")

    def boom_b():
        raise ValueError("b")

    with pytest.raises((ConnectionError, ValueError)):
        tres.hedged_call([boom_a, boom_b], hedge_after_s=0.01, name="h4")
    with pytest.raises(ValueError, match="at least one"):
        tres.hedged_call([], hedge_after_s=0.01)


def test_hedge_delay_equals_the_reference():
    for args in ((0.0, 3, 8, None), (0.1, 0, 8, None), (0.1, 16, 8, None),
                 (0.1, 200, 4, None), (0.1, 2, 8, 0.5), (0.1, 2, 8, 5.0)):
        assert tres.hedge_delay(*args) == jres.hedge_delay(*args)


# ----------------------------------------------------------- event agent

def _results(agent):
    return sorted((r.key, r.output, r.ok, r.error, r.attempts)
                  for r in agent.results)


def test_events_processed_with_bounded_concurrency():
    peak = {"now": 0, "max": 0}
    lock = threading.Lock()
    gate = threading.Event()

    def handler(event):
        with lock:
            peak["now"] += 1
            peak["max"] = max(peak["max"], peak["now"])
        gate.wait(timeout=0.2)   # overlap the workers
        with lock:
            peak["now"] -= 1
        return f"done {event.key}"

    agent = tevent.EventDrivenAgent(handler, max_concurrency=2)
    events = [tevent.Event(key=f"e{i}") for i in range(6)]
    threading.Timer(0.05, gate.set).start()
    stats = agent.run_sync(tevent.list_source(events))
    assert stats == {"processed": 6, "succeeded": 6, "failed": 0,
                     "dead_letter": 0}
    assert 1 <= peak["max"] <= 2
    assert sorted(r.key for r in agent.results) == sorted(e.key
                                                          for e in events)


def test_retry_then_dead_letter_and_sink_equal_the_reference():
    runs = {}
    for name, (mod, _, _) in PACKAGES.items():
        seen = []

        def flaky(event):
            if event.key == "bad":
                raise RuntimeError("boom")
            return "ok"

        agent = mod.EventDrivenAgent(flaky, result_sink=seen.append,
                                     max_retries=2, retry_delay_s=0.01)
        stats = agent.run_sync(mod.list_source([mod.Event(key="good"),
                                                mod.Event(key="bad")]))
        assert stats == {"processed": 2, "succeeded": 1, "failed": 1,
                         "dead_letter": 1}
        assert agent.dead_letter[0].key == "bad"
        assert agent.dead_letter[0].attempt == 3      # initial + 2 retries
        bad = next(r for r in seen if r.key == "bad")
        assert not bad.ok and "boom" in bad.error and bad.attempts == 3
        good = next(r for r in seen if r.key == "good")
        assert good.ok and good.output == "ok"
        runs[name] = (stats, _results(agent),
                      [(e.key, e.attempt) for e in agent.dead_letter])
    assert runs["torch"] == runs["jax"]


def test_retry_backoff_is_jittered_exponential(monkeypatch):
    """Retries sleep the shared full-jitter backoff with the agent's
    retry_delay_s as its base."""
    calls = []

    def fake_backoff(attempt, base_s=0.5, cap_s=60.0, rng=None):
        calls.append((attempt, base_s, cap_s))
        return 0.0

    monkeypatch.setattr(tevent, "full_jitter_backoff", fake_backoff)

    def always_fails(event):
        raise RuntimeError("down")

    agent = tevent.EventDrivenAgent(always_fails, max_retries=3,
                                    retry_delay_s=0.25, retry_cap_s=7.0)
    agent.run_sync(tevent.list_source([tevent.Event(key="x")]))
    assert calls == [(1, 0.25, 7.0), (2, 0.25, 7.0), (3, 0.25, 7.0)]


def test_dead_letters_counted_and_exposed_on_the_ring():
    total0 = REGISTRY.counter("event_agent_dead_letter_total").value

    def always_fails(event):
        raise RuntimeError("poisoned payload")

    agent = tevent.EventDrivenAgent(always_fails, max_retries=0,
                                    retry_delay_s=0.0)
    agent.run_sync(tevent.list_source([tevent.Event(key="dead-1"),
                                       tevent.Event(key="dead-2")]))
    assert REGISTRY.counter("event_agent_dead_letter_total").value \
        == total0 + 2
    payload = tevent.dead_letter_payload()
    assert payload["total"] == total0 + 2
    assert payload["ring_capacity"] == 256
    recent_keys = [d["key"] for d in payload["dead_letters"][:2]]
    assert set(recent_keys) == {"dead-1", "dead-2"}
    top = payload["dead_letters"][0]
    assert "poisoned payload" in top["error"] and top["attempts"] == 1


def test_jsonl_event_source(tmp_path):
    p = tmp_path / "events.jsonl"
    p.write_text('{"id": "CVE-2026-1", "summary": "rce in pump fw"}\n'
                 '{"id": "CVE-2026-2", "summary": "dos in valve ui"}\n')
    outs = {}
    for name, (mod, _, _) in PACKAGES.items():
        agent = mod.EventDrivenAgent(lambda e: e.payload["summary"])
        stats = agent.run_sync(mod.jsonl_event_source(str(p)))
        assert stats["processed"] == 2
        outs[name] = {r.key: r.output for r in agent.results}
    assert outs["torch"] == outs["jax"]
    assert outs["torch"]["CVE-2026-1"] == "rce in pump fw"


# ----------------------------------------------------- the triage handler

class _FakeLLM:
    def __init__(self, replies):
        self.replies = list(replies)
        self.prompts = []

    def chat(self, messages, **kw):
        self.prompts.append(messages[-1]["content"])
        yield self.replies.pop(0)


class _FakeEmbedder:
    def embed_queries(self, texts):
        return np.ones((len(texts), 4), np.float32)


class _Ctx:
    def __init__(self, llm, docs, embedder=None):
        self.llm = llm
        self.embedder = embedder or _FakeEmbedder()
        self._docs = docs

    def store(self, collection):
        docs = self._docs

        class S:
            def search(self, qvec, top_k=4):
                return [(d, 0.9) for d in docs[:top_k]]
        return S()


def test_cve_triage_handler_structured_verdict_equals_the_reference():
    reply = ('Assessment: {"cve": "CVE-2026-1", "affected": true, '
             '"severity": "high", "justification": "pump fw 2.1 '
             'deployed fleet-wide"}')
    got = {}
    for name, (mod, _, doc_cls) in PACKAGES.items():
        llm = _FakeLLM([reply])
        ctx = _Ctx(llm, [doc_cls(content="We run pump firmware 2.1 on all "
                                 "sites.")])
        out = mod.make_cve_triage_handler(ctx)(mod.Event(
            key="CVE-2026-1", payload={"summary": "rce in pump firmware "
                                                  "2.x"}))
        verdict = json.loads(out)
        assert verdict["affected"] is True and verdict["severity"] == "high"
        assert "pump firmware 2.1" in llm.prompts[0]
        got[name] = (out, llm.prompts)
    assert got["torch"] == got["jax"]
    assert tevent.CVE_TRIAGE_PROMPT == jevent.CVE_TRIAGE_PROMPT


@pytest.mark.parametrize("reply,match", [
    ("I think it's probably fine.", "JSON verdict"),
    ('{"cve": "CVE-2026-9", "severity": "low"}', "malformed verdict"),
    ('["affected"]', "malformed verdict")])
def test_cve_triage_handler_rejects_unstructured(reply, match):
    for mod, _, _ in PACKAGES.values():
        handler = mod.make_cve_triage_handler(_Ctx(_FakeLLM([reply]), []))
        with pytest.raises(ValueError, match=match):
            handler(mod.Event(key="CVE-2026-9", payload={}))


def test_cve_triage_handler_fills_a_missing_cve_from_the_key():
    reply = '{"affected": false, "severity": "low", "justification": "n/a"}'
    outs = [json.loads(mod.make_cve_triage_handler(_Ctx(
        _FakeLLM([reply]), []))(mod.Event(key="CVE-2026-7", payload={})))
        for mod, _, _ in PACKAGES.values()]
    assert outs[0] == outs[1] and outs[1]["cve"] == "CVE-2026-7"


# the verdict's grammar: random weights answer in it (chip_smoke.py's
# serve_events uses the same schema)
VERDICT_SCHEMA = {"type": "object", "properties": {
    "cve": {"type": "string", "maxLength": 16},
    "affected": {"type": "boolean"},
    "severity": {"enum": ["low", "medium", "high", "critical"]},
    "justification": {"type": "string", "maxLength": 24}},
    "required": ["cve", "affected", "severity", "justification"]}
EVENTS = [("CVE-2026-%04d" % i, {"summary": s}) for i, s in enumerate((
    "rce in pump firmware", "dos in valve ui", "auth bypass in gateway",
    "xss in dashboard", "overflow in parser", "leak in logger"))]


class _Verdict:
    """An LLM whose ``chat`` decodes under the verdict schema's grammar."""

    def __init__(self, llm, grammar_mod):
        self.llm = llm
        self.grammar = grammar_mod.Grammar.from_schema(VERDICT_SCHEMA)

    def chat(self, messages, **sampling):
        return self.llm.chat(messages, grammar=self.grammar, **sampling)


@pytest.fixture(scope="module")
def llms():
    """(the JAX package's LocalLLM, the port's) over the same tiny llama,
    schedulers started."""
    cfg = jllama.LlamaConfig.tiny(vocab_size=300)
    jparams = jllama.init_params(jax.random.PRNGKey(99), cfg)
    jsched = JScheduler(JCore(cfg, jconfig.EngineConfig(**GEOMETRY), jparams,
                              eos_id=JByte().eos_id), JByte())
    tcfg = llama.LlamaConfig.tiny(vocab_size=300)
    tsched = Scheduler(EngineCore(
        tcfg, tconfig.EngineConfig(**GEOMETRY),
        llama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg),
        eos_id=ByteTokenizer().eos_id, device="cpu"), ByteTokenizer())
    jsched.start()
    tsched.start()
    try:
        yield {"jax": JLocalLLM(jsched), "torch": LocalLLM(tsched)}
    finally:
        jsched.stop()
        tsched.stop()


def test_triage_under_the_verdict_grammar_matches_jax(llms):
    """Six CVE events and a poisoned one through ``EventDrivenAgent`` on
    the tiny weights, the handler's LLM under the verdict grammar: equal
    verdicts, each valid under the schema, and equal dead letters."""
    runs = {}
    for name, (mod, _, doc_cls) in PACKAGES.items():
        gram = jgrammar if name == "jax" else tgrammar
        ctx = _Ctx(_Verdict(llms[name], gram),
                   [doc_cls(content="Pump firmware 2.1 runs on every site; "
                            "the valve ui is internal only.")])
        triage = mod.make_cve_triage_handler(ctx, max_tokens=96,
                                             temperature=0.0)

        def handler(event, triage=triage):
            if event.key == "poison":
                raise ValueError("no JSON verdict in analysis for poison")
            return triage(event)

        agent = mod.EventDrivenAgent(handler, max_concurrency=4,
                                     max_retries=2, retry_delay_s=0.01)
        events = [mod.Event(key=k, payload=p) for k, p in EVENTS]
        stats = agent.run_sync(mod.list_source(
            events + [mod.Event(key="poison")]))
        assert stats == {"processed": 7, "succeeded": 6, "failed": 1,
                         "dead_letter": 1}
        runs[name] = (_results(agent),
                      [(e.key, e.attempt) for e in agent.dead_letter])
    assert runs["torch"] == runs["jax"]
    for key, output, ok, _, attempts in runs["torch"][0]:
        if key == "poison":
            assert not ok and attempts == 3
            continue
        verdict = json.loads(output)
        assert ok and attempts == 1
        assert set(verdict) == set(VERDICT_SCHEMA["properties"])
        assert isinstance(verdict["affected"], bool)
        assert verdict["severity"] in VERDICT_SCHEMA["properties"][
            "severity"]["enum"]
        assert len(verdict["justification"]) <= 24
