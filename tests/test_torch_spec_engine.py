"""Speculative decoding and the mixed-phase dispatch of the port's engine,
on the CPU with the tiny model.

* The width ladder, the ceiling width and the mixed program's q_block
  equal the JAX ``EngineCore``'s for the same config fields.
* Through the ``Scheduler``, with prompts arriving while a slot decodes,
  greedy streams with speculation on (and the mixed dispatch forced on)
  equal the JAX ``Scheduler``'s with the same settings on the same weights
  (``params_from_jax``), over the model-dtype pool and the int8 pool, with
  the prefix cache off on both sides and again on on both sides.
* Within the port: seeded sampled streams with speculation equal those
  without; a draft cap changes no token; preemption under page pressure
  and slots at the context limit keep the spec-off streams; a repetitive
  prompt gets drafts accepted.
* ``mixed_phase_dispatch="auto"`` resolves off on the CPU, the bare
  ``APP_MIXED_PHASE_DISPATCH`` overrides the field, and ``"on"`` with a
  config the mixed program cannot serve raises.
"""

import jax
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.core.config import EngineConfig as JaxEngineConfig
from generativeaiexamples_tpu.engine.engine import EngineCore as JaxCore
from generativeaiexamples_tpu.engine.scheduler import Request as JaxRequest
from generativeaiexamples_tpu.engine.scheduler import Scheduler as JaxScheduler
from generativeaiexamples_tpu.engine.tokenizer import ByteTokenizer
from generativeaiexamples_tpu.models import llama as jllama

from generativeaiexamples_tpu_torch.core.config import (EngineConfig,
                                                        load_config)
from generativeaiexamples_tpu_torch.engine.engine import (
    EngineCore, PrefillItem, unpack_decode_out)
from generativeaiexamples_tpu_torch.engine.scheduler import Request, Scheduler
from generativeaiexamples_tpu_torch.models import llama

GEOMETRY = dict(max_batch_size=4, max_seq_len=256, page_size=8,
                prefill_chunk=16)
# repetitive RAG-flavoured text: generation tends to quote it, so the
# n-gram lookup finds real continuations to draft
QUOTE = ("the retrieved context says: alpha beta gamma delta. "
         "the retrieved context says: alpha beta gamma delta. "
         "question: repeat the context. answer: the retrieved")
# (prompt, max_tokens): the first decodes alone, the others arrive while
# it does (one of 7 chunks, one of 6)
STAGGERED = [("hello", 40), (QUOTE[:110], 32), (QUOTE[:90], 20)]


@pytest.fixture(scope="module")
def tiny():
    cfg = jllama.LlamaConfig.tiny(vocab_size=300)
    jparams = jllama.init_params(jax.random.PRNGKey(5), cfg)
    tcfg = llama.LlamaConfig.tiny(vocab_size=300)
    tparams = llama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return cfg, jparams, tcfg, tparams


def _core(tiny, **kw):
    _, _, tcfg, tparams = tiny
    return EngineCore(tcfg, EngineConfig(**{**GEOMETRY, **kw}), tparams,
                      eos_id=ByteTokenizer().eos_id, device="cpu")


def _drive(sched, make, first_ticks=2, **req_kw):
    """Submit the first request, tick until it decodes, submit the rest,
    tick to idle; returns the requests."""
    tok = ByteTokenizer()
    reqs = [make(prompt_ids=tok.encode(p, add_bos=True), max_tokens=n,
                 **req_kw) for p, n in STAGGERED]
    sched.submit(reqs[0])
    for _ in range(first_ticks):
        sched._tick()
    for r in reqs[1:]:
        sched.submit(r)
    for _ in range(500):
        if not sched._tick():
            break
    for r in reqs:
        assert r.error is None, r.error
    return reqs


def _jax_streams(tiny, **engine_kw):
    cfg, jparams, _, _ = tiny
    tok = ByteTokenizer()
    engine_kw = {"prefix_cache": "off", **engine_kw}
    core = JaxCore(cfg, JaxEngineConfig(prefill_hold_chunks=0, **GEOMETRY,
                                        **engine_kw), jparams,
                   eos_id=tok.eos_id)
    sched = JaxScheduler(core, tok)
    reqs = _drive(sched, JaxRequest, temperature=0.0, logprobs=True)
    return [[t for t, _lp, _top in r.logprob_data] for r in reqs], sched


def _torch_streams(tiny, **engine_kw):
    # no prefill hold, as the JAX side runs
    engine_kw = {"prefix_cache": "off", "prefill_hold_chunks": 0,
                 **engine_kw}
    sched = Scheduler(_core(tiny, **engine_kw), ByteTokenizer())
    reqs = _drive(sched, Request, temperature=0.0)
    return [r.output_ids for r in reqs], sched.stats


@pytest.mark.parametrize("fields", [
    {}, dict(spec_draft=3), dict(spec_draft=2, spec_draft_max=16),
    dict(spec_adaptive="off"), dict(spec_adaptive="off", spec_draft=8),
    dict(spec_decode="off"), dict(spec_draft=0)])
def test_spec_ladder_equals_jax(tiny, fields):
    cfg, jparams, _, _ = tiny
    want = JaxCore(cfg, JaxEngineConfig(prefix_cache="off", **GEOMETRY,
                                        **fields), jparams, eos_id=257)
    got = _core(tiny, **fields)
    assert got.spec_widths == want.spec_widths
    assert got.spec_width == want.spec_width
    assert got._mixed_q_block == want._mixed_q_block


def test_default_config_resolves_like_the_reference(tiny):
    core = _core(tiny, prefill_chunk=16)
    assert core.spec_widths == (2, 3, 5, 9) and core.spec_width == 9
    assert core._mixed_q_block == 16
    assert not core.mixed_supported          # "auto" is off on the CPU
    assert core.mixed_row_queries == 9       # the plain path's raw width


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("mixed", ["off", "on"])
def test_spec_streams_match_jax_scheduler(tiny, kv_quant, mixed):
    want, jsched = _jax_streams(tiny, kv_quant=kv_quant,
                                mixed_phase_dispatch=mixed)
    got, stats = _torch_streams(tiny, kv_quant=kv_quant,
                                mixed_phase_dispatch=mixed)
    assert got == want
    assert [len(g) for g in got] == [n for _, n in STAGGERED]
    assert stats["spec_steps"] > 0 and stats["spec_bonus_tokens"] > 0
    if mixed == "on":
        assert stats["mixed_dispatches"] > 0
        assert jsched._mixed_dispatches > 0


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("mixed", ["off", "on"])
def test_spec_streams_match_jax_scheduler_with_the_prefix_cache_on(
        tiny, kv_quant, mixed):
    want, _ = _jax_streams(tiny, kv_quant=kv_quant,
                           mixed_phase_dispatch=mixed, prefix_cache="on")
    got, stats = _torch_streams(tiny, kv_quant=kv_quant,
                                mixed_phase_dispatch=mixed,
                                prefix_cache="on")
    assert got == want
    assert stats["spec_steps"] > 0
    assert (stats["mixed_dispatches"] > 0) == (mixed == "on")


def test_spec_and_mixed_equal_narrow_two_dispatch(tiny):
    base, stats = _torch_streams(tiny, spec_decode="off",
                                 mixed_phase_dispatch="off")
    assert stats["spec_steps"] == stats["mixed_dispatches"] == 0
    got, stats = _torch_streams(tiny, mixed_phase_dispatch="on")
    assert got == base and stats["mixed_dispatches"] > 0


def _sampled(tiny, **kw):
    """A greedy request decodes; two seeded sampled ones arrive while it
    does (so, with the mixed dispatch on and no prefill hold, their chunks
    ride it)."""
    sched = Scheduler(_core(tiny, **{"prefill_hold_chunks": 0, **kw}),
                      ByteTokenizer())
    tok = ByteTokenizer()
    reqs = [Request(prompt_ids=tok.encode(QUOTE[:60], add_bos=True),
                    max_tokens=40, temperature=0.0),
            Request(prompt_ids=tok.encode(QUOTE[:110], add_bos=True),
                    max_tokens=24, temperature=1.0, seed=11),
            Request(prompt_ids=tok.encode(QUOTE[:100], add_bos=True),
                    max_tokens=24, temperature=0.8, top_p=0.9, top_k=20,
                    seed=12)]
    sched.submit(reqs[0])
    sched._tick()
    for r in reqs[1:]:
        sched.submit(r)
    while sched._tick():
        pass
    assert all(r.error is None for r in reqs)
    return [r.output_ids for r in reqs], sched.stats


@pytest.mark.parametrize("mixed", ["off", "on"])
def test_seeded_sampling_spec_on_equals_spec_off(tiny, mixed):
    base, _ = _sampled(tiny, spec_decode="off", mixed_phase_dispatch="off")
    got, stats = _sampled(tiny, mixed_phase_dispatch=mixed)
    assert got == base and [len(g) for g in got] == [40, 24, 24]
    assert stats["spec_steps"] > 0
    assert (stats["mixed_dispatches"] > 0) == (mixed == "on")


def test_repetitive_prompt_accepts_drafts(tiny):
    got, stats = _torch_streams(tiny)
    assert stats["spec_bonus_tokens"] > 0
    assert stats["spec_base_steps"] > 0


def test_draft_cap_does_not_change_the_stream(tiny):
    """Two slots prefilled alike, decoded at the top rung with per-slot
    caps (0, 3, 8, 1) and uncapped: every emitted token is the same."""
    core = _core(tiny)
    tok = ByteTokenizer()
    ids = tok.encode(QUOTE[:100], add_bos=True)
    streams = []
    for cap in (None, np.array([0, 3, 8, 1], np.int32)):
        state = core.init_state()
        table = np.zeros((core.batch, core.max_pages_per_slot), np.int32)
        items = []
        for s in range(2):
            pages = list(range(1 + s * 20, 1 + s * 20 + core.pages_for(
                len(ids) + 64)))
            table[s, :len(pages)] = pages
            for start in range(0, len(ids), core.chunk):
                chunk = ids[start:start + core.chunk]
                items.append(PrefillItem(
                    chunk_ids=chunk, page_row=table[s], slot=s,
                    start_pos=start, is_last=start + len(chunk) >= len(ids),
                    generated=1, max_gen=40, temperature=0.0))
        for g in range(0, len(items), core.prefill_group_max):
            state, _ = core.prefill_group(state,
                                          items[g:g + core.prefill_group_max])
        out_tokens = [[], []]
        for _ in range(3):
            state, out = core.decode(state, core.put_table(table), 4,
                                     spec_width=9, draft_cap=cap)
            host = unpack_decode_out(out["packed"].numpy())
            for s in range(2):
                out_tokens[s] += [int(t) for t, e in zip(
                    host["sampled"][:, s], host["emitted"][:, s]) if e]
        streams.append(out_tokens)
    for full, capped in zip(*streams):
        # a capped slot emits fewer tokens a step, never other tokens
        assert len(capped) >= 12 and capped == full[:len(capped)]
    assert len(streams[0][0]) > 12             # drafts were accepted


def test_preemption_under_page_pressure_keeps_streams(tiny):
    tok = ByteTokenizer()

    def run(**kw):
        sched = Scheduler(_core(tiny, **kw), tok)
        reqs = [Request(prompt_ids=tok.encode(
            "first request with a fairly long prompt here ok", add_bos=True),
            max_tokens=24, temperature=0.0),
            Request(prompt_ids=tok.encode("second one", add_bos=True),
                    max_tokens=24, temperature=0.0)]
        for r in reqs:
            sched.submit(r)
        while sched._tick():
            pass
        assert all(r.error is None for r in reqs)
        return [r.output_ids for r in reqs], sched.stats

    roomy, _ = run(spec_decode="off")
    tight, stats = run(num_pages=12)
    assert stats["preemptions"] > 0 and stats["spec_steps"] > 0
    assert tight == roomy


def test_context_limit_matches_spec_off(tiny):
    """Slots within a verify width of max_seq: the widened step's causal
    limits must not shift, and capacity ends the stream as spec-off does."""
    tok = ByteTokenizer()

    def run(**kw):
        sched = Scheduler(_core(tiny, **kw), tok)
        req = sched.submit(Request(prompt_ids=tok.encode("x" * 246,
                                                         add_bos=True),
                                   max_tokens=32, temperature=0.0))
        while sched._tick():
            pass
        assert req.error is None
        return req.output_ids, req.finish_reason

    base = run(spec_decode="off")
    assert run() == base
    assert len(base[0]) > 0


def test_mixed_gate(tiny, monkeypatch):
    monkeypatch.delenv("APP_MIXED_PHASE_DISPATCH", raising=False)
    assert not _core(tiny).mixed_supported
    assert _core(tiny, mixed_phase_dispatch="on").mixed_supported
    with pytest.raises(ValueError, match="q_block"):
        # verify width 9 needs rows of 16 queries; chunks of 8 cannot fill them
        _core(tiny, mixed_phase_dispatch="on", prefill_chunk=8)
    assert not _core(tiny, mixed_phase_dispatch="auto",
                     prefill_chunk=8).mixed_supported
    monkeypatch.setenv("APP_MIXED_PHASE_DISPATCH", "on")
    assert _core(tiny, mixed_phase_dispatch="off").mixed_supported
    monkeypatch.setenv("APP_MIXED_PHASE_DISPATCH", "sometimes")
    with pytest.raises(ValueError, match="APP_MIXED_PHASE_DISPATCH"):
        _core(tiny)


def test_spec_knobs_load_from_the_environment(monkeypatch):
    monkeypatch.setenv("APP_ENGINE_SPEC_DECODE", "off")
    monkeypatch.setenv("APP_ENGINE_SPEC_DRAFT", "3")
    monkeypatch.setenv("APP_ENGINE_MIXED_PHASE_DISPATCH", "on")
    eng = load_config().engine
    assert (eng.spec_decode, eng.spec_draft, eng.mixed_phase_dispatch) == (
        "off", 3, "on")
    # multi-step decode, the KV handoff's role and the QoS plane are
    # ported; sequence-parallel prefill is not
    monkeypatch.setenv("APP_ENGINE_DECODE_MULTISTEP", "2")
    assert load_config().engine.decode_multistep == 2
    monkeypatch.setenv("APP_ENGINE_ROLE", "prefill")
    assert load_config().engine.role == "prefill"
    monkeypatch.setenv("APP_ENGINE_QOS", "fair")
    assert load_config().engine.qos == "fair"
    monkeypatch.setenv("APP_ENGINE_LONG_PREFILL", "on")
    with pytest.raises(NotImplementedError, match="A11"):
        load_config()
    with pytest.raises(ValueError, match="spec_decode"):
        _core_cfg = EngineConfig(spec_decode="maybe")
        EngineCore(llama.LlamaConfig.tiny(), _core_cfg,
                   llama.init_params(torch.Generator().manual_seed(0),
                                     llama.LlamaConfig.tiny()),
                   eos_id=257, device="cpu")
