"""The PyTorch port's engine against the JAX engine, end to end on the CPU.

Same tiny model (vocab 300, ``PRNGKey(5)`` weights as the JAX CLI's
``--tiny``), same engine geometry, three greedy prompts (one longer than a
prefill chunk): the port's ``Scheduler`` streams must be token-identical
to the JAX ``Scheduler``'s. Both run the narrow two-dispatch path
(speculation off, the mixed dispatch off on the port) with the prefix
cache off, all token-identical options there, and again with the prefix
cache on on both sides; the speculative and mixed paths are held to JAX in
``tests/test_torch_spec_engine.py``, the prefix cache's sharing traffic in
``tests/test_torch_prefix_cache.py``. The same holds with the int8 KV pool
(``kv_quant="int8"``) on both sides.
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

from generativeaiexamples_tpu_torch.core.config import EngineConfig
from generativeaiexamples_tpu_torch.engine.engine import EngineCore
from generativeaiexamples_tpu_torch.engine.scheduler import Request, Scheduler
from generativeaiexamples_tpu_torch.models import llama

GEOMETRY = dict(max_batch_size=4, max_seq_len=128, prefill_chunk=32,
                page_size=16)
PROMPTS = ["hello", "the quick brown fox jumps over the lazy dog, twice: "
           "the quick brown fox", "abc"]
MAX_TOKENS = 24


@pytest.fixture(scope="module")
def tiny():
    cfg = jllama.LlamaConfig.tiny(vocab_size=300)
    jparams = jllama.init_params(jax.random.PRNGKey(5), cfg)
    tree = jax.tree.map(np.asarray, jparams)
    tcfg = llama.LlamaConfig.tiny(vocab_size=300)
    return cfg, jparams, tcfg, llama.params_from_jax(tree, tcfg)


def _jax_streams(tiny, prompts, max_tokens, **engine_kw):
    cfg, jparams, _, _ = tiny
    tok = ByteTokenizer()
    engine_kw = {"prefix_cache": "off", **engine_kw}
    core = JaxCore(cfg, JaxEngineConfig(spec_decode="off", **GEOMETRY,
                                        **engine_kw), jparams,
                   eos_id=tok.eos_id)
    sched = JaxScheduler(core, tok)
    sched.start()
    try:
        reqs = [sched.submit(JaxRequest(prompt_ids=tok.encode(p, add_bos=True),
                                        max_tokens=max_tokens,
                                        temperature=0.0, logprobs=True))
                for p in prompts]
        texts = ["".join(sched.iter_text(r)) for r in reqs]
    finally:
        sched.stop()
    return [[t for t, _lp, _top in r.logprob_data] for r in reqs], texts


def _torch_streams(tiny, prompts, max_tokens, **engine_kw):
    _, _, tcfg, tparams = tiny
    tok = ByteTokenizer()
    # the narrow two-dispatch path without the prefix cache, as the JAX side
    # runs it, unless a test asks otherwise
    engine_kw = {"spec_decode": "off", "mixed_phase_dispatch": "off",
                 "prefix_cache": "off", **engine_kw}
    core = EngineCore(tcfg, EngineConfig(**GEOMETRY, **engine_kw), tparams,
                      eos_id=tok.eos_id, device="cpu")
    sched = Scheduler(core, tok)
    sched.start()
    try:
        reqs = [sched.submit(Request(prompt_ids=tok.encode(p, add_bos=True),
                                     max_tokens=max_tokens, temperature=0.0))
                for p in prompts]
        texts = ["".join(sched.iter_text(r)) for r in reqs]
    finally:
        sched.stop()
    assert all(r.error is None for r in reqs)
    return [r.output_ids for r in reqs], texts, sched.stats


def test_scheduler_greedy_streams_match_jax(tiny):
    want_ids, want_text = _jax_streams(tiny, PROMPTS, MAX_TOKENS)
    got_ids, got_text, stats = _torch_streams(tiny, PROMPTS, MAX_TOKENS)
    assert got_ids == want_ids
    assert got_text == want_text
    assert all(len(ids) == MAX_TOKENS for ids in got_ids)
    assert stats["prefill_chunks"] >= 4       # the long prompt took 2 chunks


def test_scheduler_int8_kv_streams_match_jax(tiny):
    """The int8 KV pool: both engines quantize the same way and attend to
    the dequantized view on the CPU, so the greedy streams are equal."""
    want_ids, want_text = _jax_streams(tiny, PROMPTS, MAX_TOKENS,
                                       kv_quant="int8")
    got_ids, got_text, stats = _torch_streams(tiny, PROMPTS, MAX_TOKENS,
                                              kv_quant="int8")
    assert got_ids == want_ids
    assert got_text == want_text
    assert stats["prefill_chunks"] >= 4


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_scheduler_streams_match_jax_with_the_prefix_cache_on(tiny, kv_quant):
    """The same prompts twice: the repeats hit the prefix cache on both
    sides, and every stream equals the JAX engine's."""
    prompts = PROMPTS + PROMPTS
    want_ids, want_text = _jax_streams(tiny, prompts, MAX_TOKENS,
                                       kv_quant=kv_quant, prefix_cache="on")
    got_ids, got_text, stats = _torch_streams(
        tiny, prompts, MAX_TOKENS, kv_quant=kv_quant, prefix_cache="on")
    assert got_ids == want_ids
    assert got_text == want_text
    assert got_ids[:3] == got_ids[3:]


@pytest.mark.parametrize("engine_kw", [
    dict(prefill_group=1, decode_steps_per_dispatch=1),
    dict(num_pages=9, decode_steps_per_dispatch=4),   # forces preemption
])
def test_greedy_streams_independent_of_dispatch_shape(tiny, engine_kw):
    """Grouping, dispatch depth and recompute preemption change how the
    work is cut, never the greedy tokens."""
    want, _, _ = _torch_streams(tiny, PROMPTS, MAX_TOKENS)
    got, _, stats = _torch_streams(tiny, PROMPTS, MAX_TOKENS, **engine_kw)
    assert got == want
    if "num_pages" in engine_kw:
        assert stats["preemptions"] > 0


def test_seeded_sampling_is_reproducible(tiny):
    _, _, tcfg, tparams = tiny
    tok = ByteTokenizer()

    def run(seed):
        core = EngineCore(tcfg, EngineConfig(**GEOMETRY), tparams,
                          eos_id=tok.eos_id, device="cpu")
        sched = Scheduler(core, tok)
        sched.start()
        try:
            req = sched.submit(Request(prompt_ids=tok.encode("seeded"),
                                       max_tokens=16, temperature=0.9,
                                       top_p=0.9, top_k=40, seed=seed))
            list(sched.iter_text(req))
        finally:
            sched.stop()
        return req.output_ids

    assert run(7) == run(7)
    assert len(run(7)) == 16


def test_stop_string_ends_stream(tiny):
    ids, texts, _ = _torch_streams(tiny, PROMPTS[:1], MAX_TOKENS)
    text = texts[0]
    stop = text[3:5]
    assert stop, text
    _, _, tcfg, tparams = tiny
    tok = ByteTokenizer()
    core = EngineCore(tcfg, EngineConfig(**GEOMETRY), tparams,
                      eos_id=tok.eos_id, device="cpu")
    sched = Scheduler(core, tok)
    sched.start()
    try:
        req = sched.submit(Request(prompt_ids=tok.encode(PROMPTS[0],
                                                         add_bos=True),
                                   max_tokens=MAX_TOKENS, temperature=0.0,
                                   stop=[stop]))
        got = "".join(sched.iter_text(req))
    finally:
        sched.stop()
    assert got == text[:text.find(stop)]
    assert req.finish_reason == "stop"


def test_unported_request_fields_raise(monkeypatch):
    # every Request field is served now: logprobs and grammars since A.5
    # and A.6, adapters since A.7, prefill_only (the KV handoff) since A.9
    assert Request(prompt_ids=[1], prefill_only=True).prefill_only
    assert Request(prompt_ids=[1], adapter="lora-a").adapter == "lora-a"
    assert Request(prompt_ids=[1], logprobs=True, top_logprobs=5).logprobs
    # role and kv_spill_mb left NOT_PORTED with it, the prefix tier's knobs
    # with A.9's second part; the knobs still unported stay refused,
    # naming their item
    from generativeaiexamples_tpu_torch.core.config import (NOT_PORTED,
                                                            load_config)
    # devtime with A.10's first part (the device-time ledger), qos with
    # its second part (the QoS admission plane)
    for knob in ("role", "kv_spill_mb", "kv_tier", "kv_tier_disk_mb",
                 "devtime", "qos"):
        assert knob not in NOT_PORTED
    for knob, value in (("KV_TIER", "prefix"), ("KV_TIER_DISK_MB", "64"),
                        ("DEVTIME", "sample"), ("QOS", "fair")):
        monkeypatch.setenv(f"APP_ENGINE_{knob}", value)
    eng = load_config().engine
    assert (eng.kv_tier, eng.kv_tier_disk_mb, eng.devtime, eng.qos) == (
        "prefix", 64, "sample", "fair")
    monkeypatch.setenv("APP_ENGINE_LONG_PREFILL", "on")
    with pytest.raises(NotImplementedError, match="sequence-parallel"):
        load_config()


def test_engine_refuses_kernel_attention_on_cpu(tiny):
    _, _, tcfg, tparams = tiny
    with pytest.raises(ValueError, match="CUDA"):
        EngineCore(tcfg, EngineConfig(attention="kernel", **GEOMETRY),
                   tparams, eos_id=257, device="cpu")
    core = EngineCore(tcfg, EngineConfig(**GEOMETRY), tparams, eos_id=257,
                      device="cpu")
    assert core.model_cfg.attn_impl == "plain"
    assert isinstance(core.init_state().cache.k, torch.Tensor)
    with pytest.raises(ValueError, match="kv_quant"):
        EngineCore(tcfg, EngineConfig(kv_quant="fp8", **GEOMETRY), tparams,
                   eos_id=257, device="cpu")
    core = EngineCore(tcfg, EngineConfig(kv_quant="int8", **GEOMETRY),
                      tparams, eos_id=257, device="cpu")
    assert core.kv_dtype == "int8" and core.init_state().cache.quantized
