"""The Gemma family in the port against the reference, on the CPU.

Small and seeded (numpy and ``jax.random`` draws handed to both sides
through ``params_from_jax``):

* ``tiny-gemma`` logits (GeGLU, the sqrt(dim) embedding scale, tied
  embeddings, MQA 4/1) within 1e-5 of ``models/llama.forward`` there, in
  f32, and a tiny config at head_dim 256 (2 layers, 2 heads, 1 KV head),
  the width of every Gemma head;
* the embedding scale rounded to bf16 before it multiplies (bf16
  sqrt(3072) is 55.5), bit-equal to the reference's ``embed_tokens``;
  the GeGLU in bf16 bit-equal to ``jax.nn.gelu(gate, approximate=True) *
  up``, and in f32 within 1e-5;
* ``gemma.params_from_hf``'s ``(1 + w)`` fold, in the norm's dtype, equal
  to the reference's, leaf for leaf;
* greedy and seeded streams of ``tiny-gemma`` through the paged engine,
  speculation on, equal to the JAX ``Scheduler``'s, over the model-dtype
  pool and the int8 pool; the HD 256 config's greedy streams too;
* ``APP_ENGINE_MODEL_FAMILY`` resolving the four new names to the
  reference's configs and serving ``tiny-gemma`` through
  ``build_scheduler``, and the HF loader still refusing a
  ``GemmaForCausalLM`` ``config.json``, as the reference's does.
"""

import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.core.config import EngineConfig as JaxEngineConfig
from generativeaiexamples_tpu.engine.engine import EngineCore as JaxCore
from generativeaiexamples_tpu.engine.scheduler import Request as JaxRequest
from generativeaiexamples_tpu.engine.scheduler import Scheduler as JaxScheduler
from generativeaiexamples_tpu.engine.tokenizer import ByteTokenizer
from generativeaiexamples_tpu.models import gemma as jgemma
from generativeaiexamples_tpu.models import hf_loader as ref_loader
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.models import model_configs as ref_configs
from generativeaiexamples_tpu.ops import layers as jlayers

from generativeaiexamples_tpu_torch.core.config import (EngineConfig,
                                                        load_config)
from generativeaiexamples_tpu_torch.engine.engine import EngineCore
from generativeaiexamples_tpu_torch.engine.scheduler import Request, Scheduler
from generativeaiexamples_tpu_torch.models import (gemma, hf_loader, llama,
                                                   model_config)
from generativeaiexamples_tpu_torch.ops import layers

TOL = 1e-5
NEW_NAMES = ("gemma-2b", "gemma-7b", "codegemma-7b", "tiny-gemma")
GEOMETRY = dict(max_batch_size=4, max_seq_len=256, page_size=8,
                prefill_chunk=16)
QUOTE = ("the retrieved context says: alpha beta gamma delta. "
         "the retrieved context says: alpha beta gamma delta. "
         "question: repeat the context. answer: the retrieved")
# (prompt, max_tokens): the first decodes alone, the others arrive while
# it does
STAGGERED = [("hello gemma", 32), (QUOTE[:110], 24), (QUOTE[:90], 16)]


def _hd256(jax_side: bool):
    """A tiny config at Gemma's head width: 2 layers, 2 heads and 1 KV
    head of 256, f32."""
    kw = dict(vocab_size=300, dim=64, n_layers=2, n_heads=2, n_kv_heads=1,
              hidden_dim=128, head_dim=256, rope_theta=10000.0,
              norm_eps=1e-6, tie_embeddings=True, hidden_act="gelu_tanh",
              embed_scale=math.sqrt(64.0), dtype="float32")
    return (jllama.LlamaConfig if jax_side else llama.LlamaConfig)(**kw)


CONFIGS = {"tiny-gemma": (lambda: jgemma.tiny(vocab_size=300),
                          lambda: gemma.tiny(vocab_size=300)),
           "hd256": (lambda: _hd256(True), lambda: _hd256(False))}


def _models(name, seed=9):
    """(jax cfg, jax params, port cfg, port params): the reference's draw
    with every norm weight moved off one (seeded), carried across."""
    jcfg, tcfg = (make() for make in CONFIGS[name])
    jparams = jllama.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    for key in ("attn_norm", "mlp_norm"):
        w = jparams["layers"][key]
        jparams["layers"][key] = w + jnp.asarray(
            0.2 * rng.standard_normal(w.shape), w.dtype)
    jparams["final_norm"] = jparams["final_norm"] + jnp.asarray(
        0.2 * rng.standard_normal(jparams["final_norm"].shape),
        jparams["final_norm"].dtype)
    tparams = llama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, jparams, tcfg, tparams


@functools.lru_cache(maxsize=None)
def _cached(name):
    return _models(name)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    return request.param, _cached(request.param)


# ---------------------------------------------------------------- the model

def test_logits_match_reference(models):
    name, (jcfg, jparams, tcfg, tparams) = models
    assert tcfg.head_dim == (256 if name == "hd256" else 16)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 300, size=(2, 11)).astype(np.int32)
    want = np.asarray(jllama.forward(jparams, jcfg, jnp.asarray(tokens)))
    with torch.no_grad():
        got = llama.forward(tparams, tcfg, torch.from_numpy(tokens)).numpy()
    assert got.shape == want.shape == (2, 11, 300)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_dense_api_matches_forward_at_head_dim_256():
    """The dense-cache API (prefill, then decode steps) at head_dim 256
    gives the full forward's last-position logits."""
    _, _, tcfg, tparams = _models("hd256")
    rng = np.random.default_rng(2)
    seq = torch.from_numpy(rng.integers(0, 300, size=(2, 14)).astype(
        np.int64))
    cache = llama.KVCache.create(tcfg, 2, 32, device="cpu")
    lens = torch.tensor([10, 10], dtype=torch.int32)
    with torch.no_grad():
        full = llama.forward(tparams, tcfg, seq)
        logits, cache = llama.prefill(tparams, tcfg, seq[:, :10], cache,
                                      torch.zeros_like(lens), lens,
                                      last_only=True)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, 9].numpy(),
                                   atol=TOL, rtol=TOL)
        for t in range(10, 14):
            step, cache = llama.decode_step(tparams, tcfg, seq[:, t], cache)
            np.testing.assert_allclose(step.numpy(), full[:, t].numpy(),
                                       atol=TOL, rtol=TOL)


def test_embed_scale_rounds_to_bf16_like_the_reference():
    """gemma-7b's scale in bf16 is 55.5 (sqrt(3072) = 55.4256...): the
    hidden states equal the reference's bit for bit, and differ from a
    product by the f32 scale rounded afterwards."""
    jcfg = dataclasses.replace(jgemma.gemma_7b(), vocab_size=64, n_layers=1)
    tcfg = dataclasses.replace(gemma.gemma_7b(), vocab_size=64, n_layers=1)
    rng = np.random.default_rng(3)
    embed = rng.standard_normal((64, 3072)).astype(np.float32) * 0.05
    tokens = np.arange(64, dtype=np.int32)[None]
    want = np.asarray(jllama.embed_tokens(
        {"embed": jnp.asarray(embed, jnp.bfloat16)}, jcfg,
        jnp.asarray(tokens)).astype(jnp.float32))
    table = torch.from_numpy(embed).bfloat16()
    got = llama.embed_tokens({"embed": table}, tcfg,
                             torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert torch.tensor(tcfg.embed_scale, dtype=torch.bfloat16).item() == 55.5
    f32_scaled = (table.float() * tcfg.embed_scale).bfloat16()[None]
    assert not torch.equal(got, f32_scaled)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_geglu_matches_reference(dtype):
    """``glu(gate, up, "gelu_tanh")`` against ``jax.nn.gelu(gate,
    approximate=True) * up``: bit-equal in bf16, where the reference rounds
    every op and its constants; within 1e-5 in f32."""
    rng = np.random.default_rng(4)
    gate = (rng.standard_normal((16, 3072)) * 3).astype(np.float32)
    up = rng.standard_normal((16, 3072)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(jlayers.glu(jnp.asarray(gate, jdt), jnp.asarray(up, jdt),
                                  "gelu_tanh").astype(jnp.float32))
    got = layers.glu(torch.from_numpy(gate).to(tdt),
                     torch.from_numpy(up).to(tdt), "gelu_tanh")
    assert got.dtype == tdt
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def _hf_state(cfg, rng):
    """An HF ``GemmaForCausalLM``-named state dict of ``cfg``'s shapes,
    f32 torch tensors, norms drawn around zero (HF stores w of (1 + w))."""
    D, H, KV, HD, F = (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                       cfg.hidden_dim)
    r = lambda *shape: torch.from_numpy(
        (rng.standard_normal(shape) * 0.1).astype(np.float32))
    state = {"model.embed_tokens.weight": r(cfg.vocab_size, D),
             "model.norm.weight": r(D)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        state.update({
            p + "input_layernorm.weight": r(D),
            p + "post_attention_layernorm.weight": r(D),
            p + "self_attn.q_proj.weight": r(H * HD, D),
            p + "self_attn.k_proj.weight": r(KV * HD, D),
            p + "self_attn.v_proj.weight": r(KV * HD, D),
            p + "self_attn.o_proj.weight": r(D, H * HD),
            p + "mlp.gate_proj.weight": r(F, D),
            p + "mlp.up_proj.weight": r(F, D),
            p + "mlp.down_proj.weight": r(D, F)})
    return state


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_from_hf_folds_like_the_reference(dtype):
    """Every leaf equal to the reference's import (the matrices transposed
    there), the norms ``w + 1`` added in the norm dtype; in f32 the two
    imports give the same logits."""
    jcfg = dataclasses.replace(jgemma.tiny(vocab_size=160), dtype=dtype)
    tcfg = dataclasses.replace(gemma.tiny(vocab_size=160), dtype=dtype)
    state = _hf_state(tcfg, np.random.default_rng(5))
    ref = jgemma.params_from_hf(state, jcfg)
    got = gemma.params_from_hf(state, tcfg)
    as_np = lambda t: t.float().numpy()
    j_np = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    np.testing.assert_array_equal(as_np(got["final_norm"]),
                                  j_np(ref["final_norm"]))
    np.testing.assert_array_equal(as_np(got["embed"]), j_np(ref["embed"]))
    for i, layer in enumerate(got["layers"]):
        for key in ("attn_norm", "mlp_norm"):
            assert layer[key].dtype == tcfg.torch_dtype
            np.testing.assert_array_equal(as_np(layer[key]),
                                          j_np(ref["layers"][key][i]))
        for key in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(as_np(layer[key]),
                                          j_np(ref["layers"][key][i]).T)
    # the fold moved the stored weights by one
    w = state["model.norm.weight"].to(tcfg.torch_dtype)
    assert torch.equal(got["final_norm"],
                       w + torch.tensor(1.0, dtype=tcfg.torch_dtype))
    if dtype == "float32":
        tokens = np.array([[3, 17, 42, 9, 101, 77, 5, 150]], np.int32)
        want = np.asarray(jllama.forward(ref, jcfg, jnp.asarray(tokens)))
        with torch.no_grad():
            out = llama.forward(got, tcfg, torch.from_numpy(tokens)).numpy()
        np.testing.assert_allclose(out, want, atol=TOL, rtol=TOL)


# ---------------------------------------------------------------- serving

def _drive(sched, make, **req_kw):
    """Submit the first request, tick until it decodes, submit the rest,
    tick to idle; returns the requests."""
    tok = ByteTokenizer()
    reqs = [make(prompt_ids=tok.encode(p, add_bos=True), max_tokens=n,
                 seed=20 + i, **req_kw)
            for i, (p, n) in enumerate(STAGGERED)]
    sched.submit(reqs[0])
    for _ in range(2):
        sched._tick()
    for r in reqs[1:]:
        sched.submit(r)
    for _ in range(500):
        if not sched._tick():
            break
    for r in reqs:
        assert r.error is None, r.error
    return reqs


SAMPLING = {"greedy": dict(temperature=0.0),
            "seeded": dict(temperature=0.8, top_p=0.9, top_k=40)}


def _streams(name, kv_quant, sampling):
    """(port streams, JAX streams, port stats) of ``STAGGERED`` with
    speculation on, the prefix cache off and no prefill hold on both
    sides."""
    jcfg, jparams, tcfg, tparams = _cached(name)
    kw = dict(kv_quant=kv_quant, prefix_cache="off", prefill_hold_chunks=0,
              **GEOMETRY)
    tok = ByteTokenizer()
    jsched = JaxScheduler(JaxCore(jcfg, JaxEngineConfig(**kw), jparams,
                                  eos_id=tok.eos_id), tok)
    want = [[t for t, _lp, _top in r.logprob_data]
            for r in _drive(jsched, JaxRequest, logprobs=True,
                            **SAMPLING[sampling])]
    sched = Scheduler(EngineCore(tcfg, EngineConfig(**kw), tparams,
                                 eos_id=tok.eos_id, device="cpu"), tok)
    got = [r.output_ids for r in _drive(sched, Request,
                                        **SAMPLING[sampling])]
    return got, want, sched.stats


# tiny-gemma greedy and seeded over both pools; the HD 256 config greedy
STREAM_CASES = [("tiny-gemma", kv, s) for kv in ("none", "int8")
                for s in sorted(SAMPLING)] + [("hd256", kv, "greedy")
                                              for kv in ("none", "int8")]


@pytest.mark.parametrize("name,kv_quant,sampling", STREAM_CASES)
def test_streams_match_jax_scheduler(name, kv_quant, sampling):
    got, want, stats = _streams(name, kv_quant, sampling)
    assert got == want
    assert [len(g) for g in got] == [n for _, n in STAGGERED]
    assert stats["spec_steps"] > 0


# ---------------------------------------------------------------- names

@pytest.mark.parametrize("name", NEW_NAMES)
def test_model_family_resolves_to_the_reference_config(name):
    cfg = load_config(env={"APP_ENGINE_MODEL_FAMILY": name})
    assert cfg.engine.model_family == name
    got, want = model_config(name), ref_configs()[name]()
    fields = {f.name for f in dataclasses.fields(got)} - {"attn_impl"}
    for field in sorted(fields):
        assert getattr(got, field) == getattr(want, field), field
    assert got.head_dim == (16 if name == "tiny-gemma" else 256)


def test_build_scheduler_serves_tiny_gemma(monkeypatch):
    """The server's entry point with ``APP_ENGINE_MODEL_FAMILY=tiny-gemma``
    on the CPU: a Gemma engine that answers a request."""
    from generativeaiexamples_tpu_torch.engine.__main__ import build_scheduler
    monkeypatch.setenv("APP_ENGINE_MODEL_FAMILY", "tiny-gemma")
    monkeypatch.setenv("APP_ENGINE_MAX_BATCH_SIZE", "2")
    monkeypatch.setenv("APP_ENGINE_MAX_SEQ_LEN", "128")
    monkeypatch.setenv("APP_ENGINE_PAGE_SIZE", "16")
    monkeypatch.setenv("APP_ENGINE_PREFILL_CHUNK", "32")
    sched, _ = build_scheduler(device="cpu")
    cfg = sched.core.model_cfg
    assert (cfg.hidden_act, cfg.embed_scale, cfg.tie_embeddings) == (
        "gelu_tanh", 8.0, True)
    # the reference's tiny-gemma has 256 entries: the byte tokenizer's
    # bytes, without its BOS (256)
    req = Request(prompt_ids=ByteTokenizer().encode("gemma", add_bos=False),
                  max_tokens=5, temperature=0.0)
    sched.submit(req)
    while sched._tick():
        pass
    assert req.error is None and len(req.output_ids) == 5


def test_hf_loader_refuses_a_gemma_config_like_the_reference(tmp_path):
    hc = {"architectures": ["GemmaForCausalLM"], "vocab_size": 256000,
          "hidden_size": 3072, "num_hidden_layers": 28,
          "num_attention_heads": 16, "num_key_value_heads": 16,
          "head_dim": 256, "intermediate_size": 24576,
          "hidden_act": "gelu_pytorch_tanh"}
    (tmp_path / "config.json").write_text(json.dumps(hc))
    with pytest.raises(ValueError) as ref_exc:
        ref_loader.config_from_hf(str(tmp_path))
    with pytest.raises(ValueError) as exc:
        hf_loader.config_from_hf(str(tmp_path))
    assert str(exc.value) == str(ref_exc.value)
    assert "GemmaForCausalLM" in str(exc.value)
