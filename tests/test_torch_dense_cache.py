"""The port's dense-cache model API and ``ragged_decode`` against the JAX
package, on the CPU.

* ``ragged_decode`` on CPU tensors (its plain version, ``mha_decode``)
  against the Pallas ``ragged_decode`` in interpret mode, on the cases of tests/test_pallas.py
  (ragged lengths, a full slot, one KV head with ``block_t=64``), f32
  within 2e-5 (another summation order; the matmul precision is set to
  full f32 so the interpret-mode dots do not round).
* ``llama.prefill`` (fresh, a later chunk with ``start_pos > 0``,
  ``last_only``) and a greedy ``decode_step`` loop against JAX's, from the
  same random cache contents: f32 logits within 1e-4 (matmul summation
  order), caches within 1e-4, equal lengths, identical greedy tokens, and
  the clamped write of ``dynamic_update_slice`` at the end of the cache.
* The stock config (``attn_impl="auto"``) sends the dense API through the
  kernel wrappers, which launch the kernels for CUDA tensors;
  ``attn_impl="plain"`` alone takes the plain attention.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.ops.pallas import attention as jpallas
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.ops.cuda import attention as tk

ATOL_KERNEL = 2e-5
ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


DECODE_CASES = {
    # B, T, H, KV, HD, lengths, block_t
    "ragged": (4, 256, 8, 4, 32, [3, 200, 256, 64], 512),
    "one_kv_head": (2, 128, 4, 1, 16, [128, 1], 64),
    "past_the_cache": (2, 64, 4, 2, 16, [65, 7], 512),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_ragged_decode_plain_matches_interpret_kernel(case):
    B, T, H, KV, HD, lengths, block_t = DECODE_CASES[case]
    rng = np.random.default_rng(B + T + H)
    q = rng.standard_normal((B, 1, H, HD)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, HD)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, HD)).astype(np.float32)
    lens = np.array(lengths, np.int32)
    with jax.default_matmul_precision("highest"):
        want = jpallas.ragged_decode(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lens),
                                     block_t=block_t, interpret=True)
    tk.reset_launch_counts()
    got = tk.ragged_decode(_t(q), _t(k), _t(v), _t(lens))
    assert tk.launch_counts()["ragged_decode"] == 0      # CPU: plain version
    assert got.shape == (B, 1, H, HD) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL_KERNEL, rtol=ATOL_KERNEL)


def test_kv_cache_create():
    cfg = tl.LlamaConfig.tiny()
    c = tl.KVCache.create(cfg, 3, 40)
    assert c.k.shape == c.v.shape == (cfg.n_layers, 3, 40, cfg.n_kv_heads,
                                      cfg.head_dim)
    assert c.k.dtype == cfg.torch_dtype and (c.k == 0).all()
    assert c.lengths.shape == (3,) and c.lengths.dtype == torch.int32


B, T = 2, 32


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(vocab_size=300)
    tcfg = tl.LlamaConfig.tiny(vocab_size=300)
    jparams = jl.init_params(jax.random.PRNGKey(4), jcfg)
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, jparams, tcfg, tparams


def _caches(jcfg, seed):
    rng = np.random.default_rng(seed)
    shape = (jcfg.n_layers, B, T, jcfg.n_kv_heads, jcfg.head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    jc = jl.KVCache(k=jnp.asarray(k0), v=jnp.asarray(v0),
                    lengths=jnp.zeros((B,), jnp.int32))
    tc = tl.KVCache(k=_t(k0), v=_t(v0), lengths=torch.zeros((B,),
                                                            dtype=torch.int32))
    return jc, tc, rng


def _same_cache(tc, jc):
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=ATOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=ATOL)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


def test_dense_prefill_and_decode_match_jax(models):
    jcfg, jparams, tcfg, tparams = models
    jc, tc, rng = _caches(jcfg, 0)

    # fresh prefill, right-padded rows of 12 and 9 tokens
    tokens = rng.integers(0, 259, size=(B, 12)).astype(np.int32)
    start = np.zeros(B, np.int32)
    seq = np.array([12, 9], np.int32)
    jlog, jc = jl.prefill(jparams, jcfg, jnp.asarray(tokens), jc,
                          jnp.asarray(start), jnp.asarray(seq))
    tlog, tc = tl.prefill(tparams, tcfg, _t(tokens), tc, _t(start), _t(seq))
    assert tlog.shape == (B, 12, 300) and tlog.dtype == torch.float32
    for b in range(B):
        np.testing.assert_allclose(tlog[b, :seq[b]].numpy(),
                                   np.asarray(jlog[b, :seq[b]]), atol=ATOL)
    _same_cache(tc, jc)

    # a later chunk at start_pos > 0, logits at the last valid token only
    tokens = rng.integers(0, 259, size=(B, 6)).astype(np.int32)
    start, seq = seq, np.array([6, 4], np.int32)
    jlog, jc = jl.prefill(jparams, jcfg, jnp.asarray(tokens), jc,
                          jnp.asarray(start), jnp.asarray(seq),
                          last_only=True)
    tlog, tc = tl.prefill(tparams, tcfg, _t(tokens), tc, _t(start), _t(seq),
                          last_only=True)
    assert tlog.shape == (B, 1, 300)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
    _same_cache(tc, jc)

    # greedy decode: each side feeds back its own argmax
    jtok = np.asarray(jlog[:, 0]).argmax(-1).astype(np.int32)
    ttok = tlog[:, 0].argmax(-1).to(torch.int32)
    for _ in range(6):
        np.testing.assert_array_equal(ttok.numpy(), jtok)
        jlog, jc = jl.decode_step(jparams, jcfg, jnp.asarray(jtok), jc)
        tlog, tc = tl.decode_step(tparams, tcfg, ttok, tc)
        assert tlog.shape == (B, 300)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
        jtok = np.asarray(jlog).argmax(-1).astype(np.int32)
        ttok = tlog.argmax(-1).to(torch.int32)
    _same_cache(tc, jc)


def test_dense_writes_clamp_at_the_end_of_the_cache(models):
    """A chunk that would run past T lands at T - S, and a decode step at
    lengths == T overwrites row T - 1 and attends the whole cache (lengths
    T + 1), as ``dynamic_update_slice`` and ``mha_decode`` do there."""
    jcfg, jparams, tcfg, tparams = models
    jc, tc, rng = _caches(jcfg, 1)
    tokens = rng.integers(0, 259, size=(B, 8)).astype(np.int32)
    start = np.array([T - 3, 0], np.int32)   # row 0 would end at T + 5
    seq = np.array([8, 8], np.int32)
    jlog, jc = jl.prefill(jparams, jcfg, jnp.asarray(tokens), jc,
                          jnp.asarray(start), jnp.asarray(seq))
    tlog, tc = tl.prefill(tparams, tcfg, _t(tokens), tc, _t(start), _t(seq))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
    _same_cache(tc, jc)
    assert tc.lengths.tolist() == [T + 5, 8]

    # decode with one slot exactly full
    jc = jl.KVCache(k=jc.k, v=jc.v, lengths=jnp.asarray([T, 20], jnp.int32))
    tc.lengths = torch.tensor([T, 20], dtype=torch.int32)
    toks = np.array([17, 200], np.int32)
    jlog, jc = jl.decode_step(jparams, jcfg, jnp.asarray(toks), jc)
    tlog, tc = tl.decode_step(tparams, tcfg, _t(toks), tc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
    _same_cache(tc, jc)
    assert tc.lengths.tolist() == [T + 1, 21]


@pytest.mark.parametrize("attn_impl", ["auto", "kernel", "plain"])
def test_dense_api_calls_the_kernel_wrappers_unless_plain(models, attn_impl,
                                                          monkeypatch):
    """The stock config reaches ``flash_prefill``/``ragged_decode`` through
    ``llama.prefill``/``llama.decode_step``; only "plain" bypasses them."""
    import dataclasses
    _, _, tcfg, tparams = models
    assert tl.LlamaConfig().attn_impl == tl.LlamaConfig.tiny().attn_impl \
        == "auto"
    cfg = dataclasses.replace(tcfg, attn_impl=attn_impl)
    calls = []
    for name in ("flash_prefill", "ragged_decode"):
        real = getattr(tk, name)
        monkeypatch.setattr(tk, name, lambda *a, _n=name, _f=real, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    cache = tl.KVCache.create(cfg, B, T)
    tokens = torch.tensor([[5, 6, 7], [8, 9, 0]], dtype=torch.int32)
    seq = torch.tensor([3, 2], dtype=torch.int32)
    logits, cache = tl.prefill(tparams, cfg, tokens, cache,
                               torch.zeros_like(seq), seq, last_only=True)
    tl.decode_step(tparams, cfg, logits[:, 0].argmax(-1), cache)
    L = cfg.n_layers
    want = [] if attn_impl == "plain" else (["flash_prefill"] * L
                                            + ["ragged_decode"] * L)
    assert calls == want
    with pytest.raises(ValueError, match="attn_impl"):
        tl.decode_step(tparams, dataclasses.replace(cfg, attn_impl="xla"),
                       logits[:, 0].argmax(-1), cache)
