"""The port's int8 weights (``ops/quant.py``) against the JAX package's, on
the CPU, and GQA groups of 8 under the default ladder.

* ``quantize`` is bit-equal to JAX's (q and s) on f32 and bf16 matrices
  with a zero row (the 1e-8 floor) and values at half steps (round half to
  even), over the contraction axis of the port's (out, in) layout.
* ``matmul``, ``take`` and the tied unembedding equal JAX's ``quant.matmul``
  / ``take`` / ``QTensor.T`` within 1e-5 plus 2e-6 of the value, a few f32
  ulps (f32 on both sides, another summation order; the test matrices hold
  a row of scale 1, so some outputs pass 20).
* ``quantize_params`` quantizes the leaves JAX's does, over the same axes,
  to the same bits, and leaves the norms; ``params_from_jax`` carries a
  JAX-quantized tree across to the same QTensors;
  ``init_params(quant="int8")`` equals quantizing the unquantized draw.
* The tiny model's ``Scheduler`` with ``quant="int8"`` streams greedy and
  seeded (temperature 0.7, top-k, top-p 0.9) tokens equal to the JAX
  ``Scheduler``'s with ``quant="int8"``, both packages at their defaults
  (the mixed dispatch on), over both KV pools.
* A GQA group of 8 (16 query heads over 2 KV heads), the shape of
  llama3-70b's group: served under the default ladder (verify width 9, 72
  query vectors a row; mixed q_block 16, 128) with streams equal to the
  JAX engine's, both pools, and nothing refuses it.
* ``quant`` other than none/int8 raises naming ``quant``; the knob is no
  longer refused by the config loader.

The W8A16 kernel against its plain version is a card test
(``tests/test_torch_cuda_kernels.py``).
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
from generativeaiexamples_tpu.ops import quant as jquant

from generativeaiexamples_tpu_torch.core.config import EngineConfig, load_config
from generativeaiexamples_tpu_torch.engine.engine import EngineCore
from generativeaiexamples_tpu_torch.engine.scheduler import Request, Scheduler
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.ops import quant
from generativeaiexamples_tpu_torch.ops.cuda import attention as tk

ATOL, RTOL = 1e-5, 2e-6
GEOMETRY = dict(max_batch_size=4, max_seq_len=256, page_size=8,
                prefill_chunk=16)
QUOTE = ("the retrieved context says: alpha beta gamma delta. "
         "the retrieved context says: alpha beta gamma delta. "
         "question: repeat the context. answer: the retrieved")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny-model passes run faster on one thread than on threads that
    contend with the other test workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _matrix(rng, out_f, in_f):
    """A (out, in) f32 matrix with a zero row and a row whose scale is
    exactly 1 (amax 127) holding values at half steps."""
    w = rng.standard_normal((out_f, in_f)).astype(np.float32)
    w[1] = 0.0
    w[2] = np.resize(np.array([2.5, -3.5, 0.5, -0.5, 126.5, -1.5],
                              np.float32), in_f)
    w[2, -1] = 127.0
    return w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_is_bit_equal_to_jax(dtype):
    w = _matrix(np.random.default_rng(0), 24, 40)
    jw = jnp.asarray(w).astype(dtype)
    # the reference's layer layout is (in, out), quantized over axis 0
    jq = jquant.quantize(jw.T, axis=0)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = quant.quantize(tw)
    assert got.q.dtype == torch.int8 and got.s.dtype == torch.float32
    assert got.q.shape == (24, 40) and got.s.shape == (24,)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(jq.q).T)
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(jq.s)[0])
    # the zero row's scale is the floor: 1e-8 times the f32 reciprocal of
    # 127, as XLA folds the division by a constant
    assert got.s[1].item() == np.float32(1e-8) * (np.float32(1)
                                                  / np.float32(127))
    assert (got.q[1] == 0).all()
    # half steps round to even: 2.5 -> 2, -3.5 -> -4, 0.5 -> 0, 126.5 -> 126
    assert got.q[2, :6].tolist() == [2, -4, 0, 0, 126, -2]
    back = quant.dequantize(got)
    assert ((back - tw.float()).abs() <= got.s[:, None] / 2 + 1e-6).all()


def test_matmul_take_and_tied_unembed_match_jax():
    rng = np.random.default_rng(1)
    w = _matrix(rng, 24, 40)                       # (out, in)
    x = rng.standard_normal((5, 40)).astype(np.float32)
    jq = jquant.quantize(jnp.asarray(w.T), axis=0)
    tq = quant.quantize(torch.from_numpy(w))
    want = np.asarray(jquant.matmul(jnp.asarray(x), jq))
    got = quant.matmul(torch.from_numpy(x), tq).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # a plain weight goes through F.linear unchanged
    np.testing.assert_allclose(
        quant.matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        x @ w.T, atol=ATOL, rtol=RTOL)
    # the embedding: per-row scales, rows gathered with their scales
    emb = _matrix(rng, 30, 16)                     # (V, D)
    jemb = jquant.quantize(jnp.asarray(emb), axis=1)
    temb = quant.quantize(torch.from_numpy(emb))
    ids = np.array([[0, 1, 2, 29], [7, 7, 3, 1]], np.int32)
    np.testing.assert_array_equal(
        quant.take(temb, torch.from_numpy(ids), torch.float32).numpy(),
        np.asarray(jquant.take(jemb, jnp.asarray(ids), jnp.float32)))
    # the tied unembedding: the embedding's QTensor as the head
    h = rng.standard_normal((3, 16)).astype(np.float32)
    np.testing.assert_allclose(
        quant.matmul(torch.from_numpy(h), temb).numpy(),
        np.asarray(jquant.matmul(jnp.asarray(h), jemb.T)), atol=ATOL,
        rtol=RTOL)


def _untied_tiny():
    return (dataclasses.replace(jllama.LlamaConfig.tiny(vocab_size=300),
                                tie_embeddings=False),
            dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=300),
                                tie_embeddings=False))


def _assert_same_qtensor(got, jq, transpose):
    assert isinstance(got, quant.QTensor)
    want_q = np.asarray(jq.q)
    np.testing.assert_array_equal(got.q.numpy(),
                                  want_q.T if transpose else want_q)
    np.testing.assert_array_equal(got.s.numpy(),
                                  np.asarray(jq.s).reshape(-1))


def test_quantize_params_and_params_from_jax_match_jax():
    jcfg, tcfg = _untied_tiny()
    jparams = jllama.init_params(jax.random.PRNGKey(3), jcfg)
    jq = jquant.quantize_params(jparams)
    tparams = llama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    tq = quant.quantize_params(tparams)
    # not donated: the source keeps its model-dtype matrices
    assert isinstance(tparams["layers"][0]["wq"], torch.Tensor)
    carried = llama.params_from_jax(jax.tree.map(np.asarray, jq), tcfg)
    for tree in (tq, carried):
        for i in range(tcfg.n_layers):
            for name in quant.LAYER_MATRICES:
                jl = jquant.QTensor(q=jq["layers"][name].q[i],
                                    s=jq["layers"][name].s[i])
                _assert_same_qtensor(tree["layers"][i][name], jl, True)
            for norm in ("attn_norm", "mlp_norm"):
                leaf = tree["layers"][i][norm]
                assert isinstance(leaf, torch.Tensor)
                assert leaf.dtype == torch.float32
        _assert_same_qtensor(tree["embed"], jq["embed"], False)
        _assert_same_qtensor(tree["lm_head"], jq["lm_head"], True)
        assert isinstance(tree["final_norm"], torch.Tensor)
    # the tied head: the reference's (V, 1) row scales are the port's
    assert jq["embed"].s.shape == (300, 1)
    assert tq["lm_head"].s.shape == (300,)


def test_init_params_int8_equals_quantizing_the_draw():
    cfg = llama.LlamaConfig.tiny(vocab_size=300)
    drawn = llama.init_params(torch.Generator().manual_seed(4), cfg)
    want = quant.quantize_params(drawn)
    got = llama.init_params(torch.Generator().manual_seed(4), cfg,
                            quant="int8")
    pairs = list(zip(quant.weights(got), quant.weights(want)))
    assert len(pairs) == 7 * cfg.n_layers + 1
    for a, b in pairs:
        assert torch.equal(a.q, b.q) and torch.equal(a.s, b.s)
    assert quant.n_params(got) == quant.n_params(drawn)


def test_quant_knob_validation():
    cfg = llama.LlamaConfig.tiny(vocab_size=300)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="quant"):
        EngineCore(cfg, EngineConfig(**GEOMETRY, quant="fp4"), params,
                   eos_id=0, device="cpu")
    with pytest.raises(ValueError, match="quant"):
        llama.init_params(torch.Generator().manual_seed(0), cfg,
                          quant="fp4")
    assert load_config(env={"APP_ENGINE_QUANT": "int8"}).engine.quant == "int8"
    # the engine takes none, "" and int8; int8 weight bytes are one a
    # parameter, counted before quantization
    n = quant.n_params(params)
    for mode, nbytes in (("", 4 * n), ("none", 4 * n), ("int8", n)):
        core = EngineCore(cfg, EngineConfig(**GEOMETRY, quant=mode),
                          dict(params, layers=[dict(l) for l in
                                               params["layers"]]),
                          eos_id=0, device="cpu")
        assert (core.n_params, core.param_bytes) == (n, nbytes)
        assert isinstance(core.params["layers"][0]["wq"], quant.QTensor) \
            == (mode == "int8")


# -------------------------------------------- end to end against JAX

def _ids(text):
    return ByteTokenizer().encode(text, add_bos=True)


def _waves(make):
    """A greedy and a seeded decoder (the second's prompt several
    chunks), then, while both decode, a top-k / top-p sampled prompt and a
    greedy one sharing its pages (mixed dispatches)."""
    return [
        [make(prompt_ids=_ids("hello there"), max_tokens=40,
              temperature=0.0),
         make(prompt_ids=_ids((QUOTE * 2)[:120]), max_tokens=32,
              temperature=0.7, seed=11)],
        [make(prompt_ids=_ids(QUOTE[:90]), max_tokens=20, temperature=0.7,
              top_k=20, top_p=0.9, seed=12),
         make(prompt_ids=_ids(QUOTE[:80]), max_tokens=20, temperature=0.0)]]


def _run(sched, waves, cap=3000):
    reqs = []
    for i, wave in enumerate(waves):
        if i:
            for _ in range(cap):
                if all(r.first_token_at or r.finished_at for r in reqs):
                    break
                sched._tick()
        reqs += [sched.submit(r) for r in wave]
    for _ in range(cap):
        if all(r.finished_at for r in reqs):
            break
        sched._tick()
    assert all(r.finished_at and r.error is None for r in reqs), \
        [r.error for r in reqs]
    return reqs


def _streams_pair(jcfg, tcfg, seed, **kw):
    """(JAX tokens, port tokens, port stats) of the same traffic, both at
    their defaults with ``kw``; fresh weights for each engine (int8
    quantization consumes the tree it is given)."""
    kw = dict(mixed_phase_dispatch="on", **GEOMETRY, **kw)
    tok = ByteTokenizer()
    jparams = jllama.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = llama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    jsched = JaxScheduler(JaxCore(jcfg, JaxEngineConfig(**kw), jparams,
                                  eos_id=tok.eos_id), tok)
    want = [[t for t, _lp, _top in r.logprob_data] for r in _run(
        jsched, _waves(lambda **k: JaxRequest(logprobs=True, **k)))]
    sched = Scheduler(EngineCore(tcfg, EngineConfig(**kw), tparams,
                                 eos_id=tok.eos_id, device="cpu"), tok)
    got = [r.output_ids for r in _run(sched, _waves(Request))]
    return want, got, sched


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_int8_weight_streams_match_jax_scheduler(kv_quant):
    jcfg = jllama.LlamaConfig.tiny(vocab_size=300)
    tcfg = llama.LlamaConfig.tiny(vocab_size=300)
    want, got, sched = _streams_pair(jcfg, tcfg, 5, quant="int8",
                                     kv_quant=kv_quant)
    assert got == want
    assert [len(g) for g in got] == [40, 32, 20, 20]
    assert isinstance(sched.core.params["embed"], quant.QTensor)
    assert sched.stats["mixed_dispatches"] > 0
    assert sched.stats["spec_steps"] > 0


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_gqa_group_of_8_serves_under_the_default_ladder(kv_quant):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(vocab_size=300),
                               n_heads=16, n_kv_heads=2)
    tcfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=300),
                               n_heads=16, n_kv_heads=2)
    want, got, sched = _streams_pair(jcfg, tcfg, 7, kv_quant=kv_quant)
    assert got == want
    assert [len(g) for g in got] == [40, 32, 20, 20]
    core = sched.core
    G = tcfg.n_heads // tcfg.n_kv_heads
    # the default ladder's top rung and the mixed q_block pass the
    # ragged kernel's one-block limit: both run as query tiles
    assert core.spec_width == 9 and core._mixed_q_block == 16
    assert G * core.spec_width > tk.QG_MAX and G * 16 > tk.QG_MAX
    assert core.mixed_supported and sched.stats["mixed_dispatches"] > 0
    assert sched.stats["spec_steps"] > 0


@pytest.mark.parametrize("q_block,group,tile,tiles", [
    (1, 4, 1, 1), (9, 4, 9, 1), (16, 4, 16, 1), (9, 8, 8, 2),
    (16, 8, 8, 2), (5, 8, 5, 1), (1, 64, 1, 1), (2, 64, 1, 2)])
def test_query_tiles_of_the_ragged_kernel(q_block, group, tile, tiles):
    tq = tk.query_tile(q_block, group)
    assert (tq, -(-q_block // tq)) == (tile, tiles)
    assert tq * group <= tk.QG_MAX


def test_query_tile_refuses_a_group_past_one_block():
    with pytest.raises(ValueError, match="GQA group"):
        tk.query_tile(1, tk.QG_MAX + 1)
