"""The rest of the reference's decoder block in the port, on the CPU:
LayerNorm, biased projections, the plain MLP and the top-k MoE, with the
Mixtral and StarCoder2 configs.

Seeded (numpy and ``jax.random`` draws carried across by
``params_from_jax``); biases and norm biases are drawn non-zero, since the
reference's init leaves them at zero and would leave them unchecked.

* ``layer_norm`` within ``TOL`` in f32 and bit-equal in bf16.
* ``forward(return_aux=True)`` of ``tiny-moe`` and ``forward`` of
  ``tiny-starcoder2`` (a 40-token prompt past its 16-token window) within
  ``TOL`` of the reference's; the dense API over the window too.
* The bias lands between the base product and the LoRA update; a plain
  MLP's LoRA group ``(w_up,)`` is found by ``_projs`` and matches the
  reference's update.
* Both HF mappers (Mixtral's ``block_sparse_moe`` names, StarCoder2's
  biases) equal the reference's, leaf for leaf.
* int8: the expert stacks and the router stay in the model dtype (drawn
  or quantized afterwards), biases are never quantized, ``n_params``
  counts the experts and ``param_bytes`` counts them at the dtype's size.
* The refusals: MoE with biases; MLP LoRA targets on an MoE model and
  ``w_gate`` on a plain MLP, through ``EngineCore.register_adapter`` (a
  windowed config's refusal on CUDA is in
  ``tests/test_torch_cuda_kernels.py``, which needs the card).
* Greedy and seeded streams of ``tiny-moe`` and ``tiny-starcoder2``
  through both ``Scheduler``s, token for token: a grouped prefill, spec
  verify, and for ``tiny-moe`` the mixed dispatch (windows turn it off);
  and the port's multi-step blocks against the JAX per-step streams.
* C14, padding against capacity: under drops the reference's output for
  a prompt changes with its dispatch's padding; the port's does not (a
  padded token takes no expert slot), and a prompt of exactly one
  ``prefill_chunk``, prefilled alone, gives the same first token and
  logprob in both engines and in the reference's ``forward``.
"""

import dataclasses

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
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.models import model_configs as ref_configs
from generativeaiexamples_tpu.models import starcoder2 as jsc2
from generativeaiexamples_tpu.ops import layers as jlayers
from generativeaiexamples_tpu.ops import quant as jquant

from generativeaiexamples_tpu_torch.core.config import EngineConfig
from generativeaiexamples_tpu_torch.engine.engine import EngineCore
from generativeaiexamples_tpu_torch.engine.scheduler import Request, Scheduler
from generativeaiexamples_tpu_torch.models import llama, model_config
from generativeaiexamples_tpu_torch.models import model_configs, starcoder2
from generativeaiexamples_tpu_torch.ops import layers, lora as lora_ops
from generativeaiexamples_tpu_torch.ops import quant
from generativeaiexamples_tpu_torch.train import lora as tlora

TOL = 1e-5
V = 300
GEOMETRY = dict(max_batch_size=4, max_seq_len=256, page_size=8,
                prefill_chunk=16)
QUOTE = ("the retrieved context says: alpha beta gamma delta. "
         "the retrieved context says: alpha beta gamma delta. "
         "question: repeat the context. answer: the retrieved")
# (prompt, max_tokens): the first decodes alone, the others arrive while
# it does (and reach past tiny-starcoder2's 16-token window)
STAGGERED = [("hello experts", 32), (QUOTE[:110], 24), (QUOTE[:90], 16)]

CONFIGS = {
    "tiny-moe": (lambda: jllama.LlamaConfig.tiny_moe(V),
                 lambda: llama.LlamaConfig.tiny_moe(V)),
    "tiny-starcoder2": (lambda: jsc2.tiny(V), lambda: starcoder2.tiny(V)),
}


def _models(name, seed=11, **over):
    """(jax cfg, jax params, port cfg, port params): the reference's draw
    with every norm weight moved off one and every bias and norm bias
    drawn non-zero (seeded), carried across."""
    jcfg, tcfg = (dataclasses.replace(make(), **over)
                  for make in CONFIGS[name])
    jp = jllama.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)

    def move(a, scale, base=0.0):
        return jnp.asarray(base + scale * rng.standard_normal(a.shape),
                           a.dtype)

    for key, w in list(jp["layers"].items()):
        if key.endswith("_norm"):
            jp["layers"][key] = move(w, 0.2, 1.0)
        elif key.endswith("_b"):
            jp["layers"][key] = move(w, 0.1)
    jp["final_norm"] = move(jp["final_norm"], 0.2, 1.0)
    if "final_norm_b" in jp:
        jp["final_norm_b"] = move(jp["final_norm_b"], 0.1)
    tp = llama.params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, jp, tcfg, tp


_CACHE = {}


def _cached(name):
    if name not in _CACHE:
        _CACHE[name] = _models(name)
    return _CACHE[name]


def _copy(params):
    """A copy of the dict tree the engine may quantize in place."""
    return dict(params, layers=[dict(l) for l in params["layers"]])


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 7, 96)) * 3 + 1).astype(np.float32)
    w = (1 + 0.3 * rng.standard_normal(96)).astype(np.float32)
    b = (0.2 * rng.standard_normal(96)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(jlayers.layer_norm(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt),
        1e-5).astype(jnp.float32))
    got = layers.layer_norm(torch.from_numpy(x).to(tdt),
                            torch.from_numpy(w).to(tdt),
                            torch.from_numpy(b).to(tdt), 1e-5)
    assert got.dtype == tdt
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


# ---------------------------------------------------------------- forward

def test_tiny_moe_forward_and_aux_match_reference():
    jcfg, jp, tcfg, tp = _cached("tiny-moe")
    tokens = np.random.default_rng(1).integers(0, V, (2, 24)).astype(
        np.int32)
    want, want_aux = jllama.forward(jp, jcfg, jnp.asarray(tokens),
                                    return_aux=True)
    with torch.no_grad():
        got, aux = llama.forward(tp, tcfg, torch.from_numpy(tokens),
                                 return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=TOL,
                               rtol=TOL)
    assert float(aux) > 0
    # a dense model reports zero through the same seam
    dense = llama.LlamaConfig.tiny(V)
    dp = llama.init_params(torch.Generator().manual_seed(0), dense)
    _, daux = llama.forward(dp, dense, torch.from_numpy(tokens),
                            return_aux=True)
    assert float(daux) == 0.0


def test_tiny_starcoder2_forward_matches_reference_past_the_window():
    jcfg, jp, tcfg, tp = _cached("tiny-starcoder2")
    assert tcfg.sliding_window == 16
    tokens = np.random.default_rng(2).integers(0, V, (2, 40)).astype(
        np.int32)
    want = np.asarray(jllama.forward(jp, jcfg, jnp.asarray(tokens)))
    with torch.no_grad():
        got = llama.forward(tp, tcfg, torch.from_numpy(tokens))
        full = llama.forward(tp, dataclasses.replace(tcfg, sliding_window=0),
                             torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    # the window and the biases matter at this prompt length
    assert not np.allclose(full[:, 20:].numpy(), want[:, 20:], atol=1e-3)


def test_dense_api_windowed_on_the_cpu_matches_forward():
    """``prefill`` then ``decode_step`` of ``tiny-starcoder2`` on the CPU
    (the plain windowed path, as the reference's XLA path) give the full
    forward's logits past the window."""
    _, _, tcfg, tp = _cached("tiny-starcoder2")
    seq = torch.from_numpy(np.random.default_rng(3).integers(
        0, V, (2, 30)).astype(np.int64))
    cache = llama.KVCache.create(tcfg, 2, 48, device="cpu")
    lens = torch.tensor([24, 24], dtype=torch.int32)
    with torch.no_grad():
        full = llama.forward(tp, tcfg, seq)
        logits, cache = llama.prefill(tp, tcfg, seq[:, :24], cache,
                                      torch.zeros_like(lens), lens,
                                      last_only=True)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, 23].numpy(),
                                   atol=TOL, rtol=TOL)
        for t in range(24, 30):
            step, cache = llama.decode_step(tp, tcfg, seq[:, t], cache)
            np.testing.assert_allclose(step.numpy(), full[:, t].numpy(),
                                       atol=TOL, rtol=TOL)


def _adapter_tree(jcfg, targets, seed, rank=4):
    """A reference adapter tree ``{t: {"a": (L, in, r), "b": (L, r,
    out)}}`` of numpy draws, ``b`` non-zero."""
    rng = np.random.default_rng(seed)
    dims = {"wq": (jcfg.dim, jcfg.n_heads * jcfg.head_dim),
            "w_up": (jcfg.dim, jcfg.hidden_dim),
            "w_down": (jcfg.hidden_dim, jcfg.dim)}
    L = jcfg.n_layers
    return {t: {"a": (0.2 * rng.standard_normal(
                    (L, dims[t][0], rank))).astype(np.float32),
                "b": (0.2 * rng.standard_normal(
                    (L, rank, dims[t][1]))).astype(np.float32)}
            for t in targets}


def test_plain_mlp_lora_group_is_found_and_matches_reference():
    """A plain MLP's LoRA group is ``(w_up,)``: ``ops.lora.prepare`` keys
    it so that ``_projs`` finds it, and the adapted forward equals the
    reference's (biases included)."""
    jcfg, jp, tcfg, tp = _cached("tiny-starcoder2")
    tree = _adapter_tree(jcfg, ("wq", "w_up", "w_down"), 4)
    adapters = tlora.adapters_from_jax(tree, tcfg)
    prepared = lora_ops.prepare(adapters, tcfg.n_layers)
    assert sorted(prepared[0]) == ["w_down", "w_up", "wq"]
    assert [g.targets for g in prepared[0]["w_up"]] == [("w_up",)]
    tokens = np.random.default_rng(5).integers(0, V, (1, 20)).astype(
        np.int32)
    want = np.asarray(jllama.forward(
        jp, jcfg, jnp.asarray(tokens),
        adapters=jax.tree.map(jnp.asarray, tree)))
    with torch.no_grad():
        got = llama.forward(tp, tcfg, torch.from_numpy(tokens),
                            adapters=adapters)
        only_up = llama.forward(tp, tcfg, torch.from_numpy(tokens),
                                adapters={"w_up": adapters["w_up"]})
        base = llama.forward(tp, tcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert not torch.allclose(only_up, base, atol=1e-3)


def test_bias_lands_between_the_base_product_and_the_lora_update():
    """In bf16 ``_projs`` rounds ``(x @ W + b)`` before the update, as the
    reference's ``_proj`` does, for every target of a group."""
    rng = np.random.default_rng(6)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).bfloat16()
    x = r(3, 5, 64)
    layer = {"wq": r(64, 64) * 0.2, "wq_b": r(64) * 3,
             "wk": r(32, 64) * 0.2, "wk_b": r(32) * 3,
             "wv": r(32, 64) * 0.2}
    adapters = {t: {"a": r(1, 4, 64) * 0.3, "b": r(1, n, 4) * 0.3}
                for t, n in (("wq", 64), ("wk", 32), ("wv", 32))}
    group = lora_ops.prepare(adapters, 1)[0]
    got = llama._projs(x, layer, ("wq", "wk", "wv"), group)
    for name, y in zip(("wq", "wk", "wv"), got):
        base = torch.nn.functional.linear(x, layer[name])
        if name + "_b" in layer:
            base = base + layer[name + "_b"]
        a, b = adapters[name]["a"][0], adapters[name]["b"][0]
        want = lora_ops.lora_apply_plain(base, x, a, b)
        assert torch.equal(y, want), name
    late = lora_ops.lora_apply_plain(
        torch.nn.functional.linear(x, layer["wq"]), x,
        adapters["wq"]["a"][0], adapters["wq"]["b"][0]) + layer["wq_b"]
    assert not torch.equal(got[0], late)


# ---------------------------------------------------------------- mappers

def _hf_state(cfg, rng, moe=False, starcoder=False):
    """An HF-named state dict (Mixtral's or StarCoder2's names) of
    ``cfg``'s shapes, numpy draws as f32 torch tensors."""
    D, H, KV, HD, F = (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                       cfg.hidden_dim)
    r = lambda *shape: torch.from_numpy(
        (rng.standard_normal(shape) * 0.1).astype(np.float32))
    state = {"model.embed_tokens.weight": r(cfg.vocab_size, D),
             "model.norm.weight": r(D)}
    if starcoder:
        state["model.norm.bias"] = r(D)
    if not cfg.tie_embeddings:
        state["lm_head.weight"] = r(cfg.vocab_size, D)
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        proj = {"q_proj": H * HD, "k_proj": KV * HD, "v_proj": KV * HD,
                "o_proj": D}
        for name, out in proj.items():
            state[f"{p}self_attn.{name}.weight"] = r(
                out, D if name != "o_proj" else H * HD)
            if starcoder:
                state[f"{p}self_attn.{name}.bias"] = r(out)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            state[f"{p}{norm}.weight"] = r(D)
            if starcoder:
                state[f"{p}{norm}.bias"] = r(D)
        if moe:
            b = p + "block_sparse_moe."
            state[b + "gate.weight"] = r(cfg.n_experts, D)
            for e in range(cfg.n_experts):
                state[f"{b}experts.{e}.w1.weight"] = r(F, D)
                state[f"{b}experts.{e}.w3.weight"] = r(F, D)
                state[f"{b}experts.{e}.w2.weight"] = r(D, F)
        else:
            state.update({p + "mlp.c_fc.weight": r(F, D),
                          p + "mlp.c_fc.bias": r(F),
                          p + "mlp.c_proj.weight": r(D, F),
                          p + "mlp.c_proj.bias": r(D)})
    return state


def _port_layout(key, a):
    """A reference leaf (one layer) in the port's layout."""
    if key == "w_router" or (a.ndim == 2 and not key.endswith("_b")
                             and "norm" not in key):
        return a.T
    if a.ndim == 3:
        return a.transpose(0, 2, 1)
    return a


@pytest.mark.parametrize("family", ["mixtral", "starcoder2"])
def test_params_from_hf_matches_reference(family):
    if family == "mixtral":
        jcfg = dataclasses.replace(jllama.LlamaConfig.tiny_moe(160),
                                   tie_embeddings=False)
        tcfg = dataclasses.replace(llama.LlamaConfig.tiny_moe(160),
                                   tie_embeddings=False)
        state = _hf_state(tcfg, np.random.default_rng(7), moe=True)
        ref = jllama.params_from_hf(state, jcfg)
        got = llama.params_from_hf(state, tcfg)
    else:
        jcfg, tcfg = jsc2.tiny(160), starcoder2.tiny(160)
        state = _hf_state(tcfg, np.random.default_rng(8), starcoder=True)
        ref = jsc2.params_from_hf(state, jcfg)
        got = starcoder2.params_from_hf(state, tcfg)
    j_np = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    for key in ("embed", "final_norm", "final_norm_b"):
        if key in ref:
            np.testing.assert_array_equal(got[key].numpy(), j_np(ref[key]))
    if "lm_head" in ref:
        np.testing.assert_array_equal(got["lm_head"].numpy(),
                                      j_np(ref["lm_head"]).T)
    assert set(got["layers"][0]) == set(ref["layers"])
    for i, layer in enumerate(got["layers"]):
        for key, leaf in layer.items():
            np.testing.assert_array_equal(
                leaf.numpy(), _port_layout(key, j_np(ref["layers"][key][i])),
                err_msg=key)
    tokens = np.array([[3, 17, 42, 9, 101, 77, 5, 150, 8, 2]], np.int32)
    want = np.asarray(jllama.forward(ref, jcfg, jnp.asarray(tokens)))
    with torch.no_grad():
        out = llama.forward(got, tcfg, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(out, want, atol=TOL, rtol=TOL)


# ---------------------------------------------------------------- int8

def test_int8_leaves_experts_router_and_biases_unquantized():
    for name in ("tiny-moe", "tiny-starcoder2"):
        cfg = model_config(name)
        drawn = llama.init_params(torch.Generator().manual_seed(1), cfg,
                                  quant="int8")
        plain = llama.init_params(torch.Generator().manual_seed(1), cfg)
        after = quant.quantize_params(plain)
        for params in (drawn, after):
            layer = params["layers"][0]
            assert isinstance(layer["wq"], quant.QTensor)
            for key in ("w_router", "w_gate", "w_up", "w_down", "wq_b",
                        "w_up_b", "attn_norm_b"):
                if key in plain["layers"][0] and (
                        name == "tiny-moe" or key.endswith("_b")):
                    assert isinstance(layer[key], torch.Tensor), key
                    assert layer[key].dtype == cfg.torch_dtype
        for a, b in zip(quant.weights(drawn), quant.weights(after)):
            if isinstance(a, quant.QTensor):
                assert torch.equal(a.q, b.q) and torch.equal(a.s, b.s)
            else:
                assert torch.equal(a, b)
    # the reference's quantize_params leaves its (L, E, in, out) stacks
    jcfg = jllama.LlamaConfig.tiny_moe(V)
    jq = jquant.quantize_params(jllama.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    for key in ("w_gate", "w_up", "w_down", "w_router"):
        assert not isinstance(jq["layers"][key], jquant.QTensor)


def test_n_params_counts_experts_and_int8_bytes_keep_them():
    jcfg, jp, tcfg, tp = _cached("tiny-moe")
    n = quant.n_params(tp)
    assert n == sum(int(np.size(x)) for x in jax.tree.leaves(jp))
    kept = sum(l[k].numel() for l in tp["layers"]
               for k in ("w_router", "w_gate", "w_up", "w_down"))
    assert quant.n_kept(tp) == kept > 0
    for mode, nbytes in (("none", 4 * n), ("int8", n - kept + 4 * kept)):
        core = EngineCore(tcfg, EngineConfig(**GEOMETRY, quant=mode),
                          _copy(tp), eos_id=0, device="cpu")
        assert (core.n_params, core.param_bytes) == (n, nbytes)
        layer = core.params["layers"][0]
        assert isinstance(layer["wq"], quant.QTensor) == (mode == "int8")
        assert isinstance(layer["w_gate"], torch.Tensor)
    assert quant.n_kept(_cached("tiny-starcoder2")[3]) == 0


# ---------------------------------------------------------------- refusals

def test_moe_with_bias_is_refused_like_the_reference():
    bad = dataclasses.replace(llama.LlamaConfig.tiny_moe(V), use_bias=True)
    with pytest.raises(ValueError, match="use_bias"):
        jllama.init_params(jax.random.PRNGKey(0), dataclasses.replace(
            jllama.LlamaConfig.tiny_moe(V), use_bias=True))
    with pytest.raises(ValueError, match="use_bias"):
        llama.init_params(torch.Generator().manual_seed(0), bad)
    _, _, tcfg, tp = _cached("tiny-moe")
    with pytest.raises(ValueError, match="use_bias"):
        EngineCore(bad, EngineConfig(**GEOMETRY), _copy(tp), eos_id=0,
                   device="cpu")


@pytest.mark.parametrize("name,targets,match", [
    ("tiny-moe", ("wq", "w_up"), "not supported on mlp='moe'"),
    ("tiny-starcoder2", ("wq", "w_gate"), "w_gate"),
])
def test_register_adapter_refuses_mlp_targets_the_block_lacks(
        name, targets, match):
    _, _, tcfg, tp = _cached(name)
    core = EngineCore(tcfg, EngineConfig(**GEOMETRY), _copy(tp), eos_id=0,
                      device="cpu")
    cfg = tlora.LoraConfig(rank=4, targets=targets)
    ok = tlora.init_adapters(torch.Generator().manual_seed(0), tcfg,
                             tlora.LoraConfig(rank=4, targets=("wq",)))
    bad = dict(ok)
    for t in targets[1:]:
        d_in, d_out = tlora.target_dims(tcfg, t)
        bad[t] = {"a": torch.zeros((tcfg.n_layers, 4, d_in)),
                  "b": torch.zeros((tcfg.n_layers, d_out, 4))}
    with pytest.raises(ValueError, match=match):
        tlora.init_adapters(torch.Generator().manual_seed(0), tcfg, cfg)
    with pytest.raises(ValueError, match=match):
        core.register_adapter("bad", bad)
    core.register_adapter("ok", ok)       # attention targets are served


# ---------------------------------------------------------------- names

@pytest.mark.parametrize("name", sorted(ref_configs()))
def test_every_reference_name_resolves_to_its_config(name):
    got, want = model_config(name), ref_configs()[name]()
    fields = {f.name for f in dataclasses.fields(got)} - {"attn_impl"}
    for field in sorted(fields):
        assert getattr(got, field) == getattr(want, field), field
    assert set(model_configs()) == set(ref_configs())


@pytest.mark.parametrize("name", ["tiny-moe", "tiny-starcoder2"])
def test_build_scheduler_serves_the_new_tiny_names(monkeypatch, name):
    """The server's entry point with ``APP_ENGINE_MODEL_FAMILY`` on the
    CPU: an engine of the family's block that answers a request; int8
    weights keep the MoE leaves in the model dtype."""
    from generativeaiexamples_tpu_torch.engine.__main__ import build_scheduler
    for key, val in (("MODEL_FAMILY", name), ("MAX_BATCH_SIZE", "2"),
                     ("MAX_SEQ_LEN", "128"), ("PAGE_SIZE", "16"),
                     ("PREFILL_CHUNK", "32"), ("QUANT", "int8")):
        monkeypatch.setenv("APP_ENGINE_" + key, val)
    sched, _ = build_scheduler(device="cpu")
    core = sched.core
    assert core.model_cfg.mlp == ("moe" if name == "tiny-moe" else "plain")
    kept, size = quant.n_kept(core.params), core.model_cfg.torch_dtype.itemsize
    assert core.param_bytes == core.n_params - kept + size * kept
    assert (kept > 0) == (name == "tiny-moe")
    req = Request(prompt_ids=ByteTokenizer().encode("def f(x):",
                                                    add_bos=False),
                  max_tokens=5, temperature=0.0)
    sched.submit(req)
    while sched._tick():
        pass
    assert req.error is None and len(req.output_ids) == 5


# ---------------------------------------------------------------- serving

def _drive(sched, make, **req_kw):
    """Submit the first request, tick until it decodes, submit the rest,
    tick to idle; returns the requests."""
    tok = ByteTokenizer()
    reqs = [make(prompt_ids=tok.encode(p, add_bos=True), max_tokens=n,
                 seed=30 + i, **req_kw)
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


def _streams(name, sampling, mixed):
    jcfg, jp, tcfg, tp = _cached(name)
    kw = dict(prefix_cache="off", prefill_hold_chunks=0,
              mixed_phase_dispatch=mixed, **GEOMETRY)
    tok = ByteTokenizer()
    jsched = JaxScheduler(JaxCore(jcfg, JaxEngineConfig(**kw), jp,
                                  eos_id=tok.eos_id), tok)
    want = [[t for t, _lp, _top in r.logprob_data]
            for r in _drive(jsched, JaxRequest, logprobs=True,
                            **SAMPLING[sampling])]
    sched = Scheduler(EngineCore(tcfg, EngineConfig(**kw), _copy(tp),
                                 eos_id=tok.eos_id, device="cpu"), tok)
    got = [r.output_ids for r in _drive(sched, Request,
                                        **SAMPLING[sampling])]
    return got, want, sched.stats


STREAM_CASES = ([("tiny-moe", s, m) for s in sorted(SAMPLING)
                 for m in ("off", "on")]
                + [("tiny-starcoder2", s, "off") for s in sorted(SAMPLING)])


@pytest.mark.parametrize("name,sampling,mixed", STREAM_CASES)
def test_streams_match_jax_scheduler(name, sampling, mixed):
    got, want, stats = _streams(name, sampling, mixed)
    assert got == want
    assert [len(g) for g in got] == [n for _, n in STAGGERED]
    assert stats["spec_steps"] > 0
    if mixed == "on":
        assert stats["mixed_dispatches"] > 0
    else:
        assert stats["mixed_dispatches"] == 0
        # two prompts' chunks shared a dispatch
        assert stats["prefill_chunks"] > stats["prefill_dispatches"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_multistep_streams_match_jax_per_step_streams(name):
    """The multi-step blocks (``decode_multistep=8``, K 2, speculation
    off) of ``tiny-moe`` and ``tiny-starcoder2`` give the JAX engine's
    per-step greedy and seeded streams."""
    jcfg, jp, tcfg, tp = _cached(name)
    kw = dict(prefix_cache="off", prefill_hold_chunks=0, spec_decode="off",
              decode_steps_per_dispatch=2, **GEOMETRY)
    tok = ByteTokenizer()
    for sampling in sorted(SAMPLING):
        jsched = JaxScheduler(JaxCore(jcfg, JaxEngineConfig(**kw), jp,
                                      eos_id=tok.eos_id), tok)
        want = [[t for t, _lp, _top in r.logprob_data]
                for r in _drive(jsched, JaxRequest, logprobs=True,
                                **SAMPLING[sampling])]
        sched = Scheduler(EngineCore(tcfg, EngineConfig(
            decode_multistep=8, **kw), _copy(tp), eos_id=tok.eos_id,
            device="cpu"), tok)
        got = [r.output_ids for r in _drive(sched, Request,
                                            **SAMPLING[sampling])]
        assert got == want, sampling
        assert sched.stats["multi_dispatches"] > 0


def test_windowed_config_keeps_the_mixed_dispatch_off():
    _, _, tcfg, tp = _cached("tiny-starcoder2")
    with pytest.raises(ValueError, match="sliding-window"):
        EngineCore(tcfg, EngineConfig(**GEOMETRY, mixed_phase_dispatch="on"),
                   _copy(tp), eos_id=0, device="cpu")


# ---------------------------------------------------------------- C14

DROPS = dict(capacity_factor=0.5)
PROMPT = "hello mixtral"       # 14 byte tokens with the BOS


def _first(sched, make, ids):
    r = make(prompt_ids=list(ids), max_tokens=2, temperature=0.0,
             logprobs=True)
    sched.submit(r)
    for _ in range(100):
        if not sched._tick():
            break
    assert r.error is None, r.error
    return r.logprob_data[0][:2]


def _engines(chunk, seed=4):
    """(reference scheduler, port scheduler) of ``tiny-moe`` under drops
    (capacity factor 0.5), speculation off, at ``prefill_chunk=chunk``."""
    jcfg, jp, tcfg, tp = _models("tiny-moe", seed, **DROPS)
    kw = dict(max_batch_size=4, max_seq_len=256, page_size=8,
              prefill_chunk=chunk, prefix_cache="off",
              prefill_hold_chunks=0, spec_decode="off")
    tok = ByteTokenizer()
    return (JaxScheduler(JaxCore(jcfg, JaxEngineConfig(**kw), jp,
                                 eos_id=tok.eos_id), tok),
            Scheduler(EngineCore(tcfg, EngineConfig(**kw), _copy(tp),
                                 eos_id=tok.eos_id, device="cpu"), tok))


def test_reference_output_changes_with_padding_under_drops():
    """C14: the same 14-token prompt prefilled alone at ``prefill_chunk``
    16 and 32. The reference pads the chunk to the whole bucket, and its
    pads are routed like tokens, taking expert slots ahead of real second
    choices, so its first token moves; the port's pads take no slot and
    its first token and logprob stay put."""
    ids = ByteTokenizer().encode(PROMPT, add_bos=True)
    assert len(ids) == 14
    ref, port = {}, {}
    for chunk in (16, 32):
        jsched, tsched = _engines(chunk)
        ref[chunk] = _first(jsched, JaxRequest, ids)
        port[chunk] = _first(tsched, Request, ids)
    assert ref[16] != ref[32]
    assert port[16] == port[32]


def test_one_full_chunk_alone_agrees_with_reference_and_forward():
    """A prompt of exactly one ``prefill_chunk`` prefilled alone under
    drops: no pads on either side and the same N, so both engines and the
    reference's ``forward`` give the same first token and logprob."""
    ids = ByteTokenizer().encode("hello mixtral!!", add_bos=True)
    assert len(ids) == 16
    jsched, tsched = _engines(16)
    want_tok, want_lp = _first(jsched, JaxRequest, ids)
    got_tok, got_lp = _first(tsched, Request, ids)
    jcfg, jp, _, _ = _models("tiny-moe", 4, **DROPS)
    logits = np.asarray(jllama.forward(jp, jcfg, jnp.asarray([ids])))[0, -1]
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))
    assert got_tok == want_tok == int(np.argmax(logits))
    np.testing.assert_allclose([got_lp, want_lp], [logp[want_tok]] * 2,
                               atol=TOL, rtol=TOL)
