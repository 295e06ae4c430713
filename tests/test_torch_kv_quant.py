"""The port's int8 KV pool against the JAX package's, on the CPU.

* ``_kv_quantize``: the same f32 input gives identical int8 values and
  scales (same division, same round-half-to-even), and the round trip is
  within half a scale step.
* The int8 variant of ``ragged_paged_attention_plain`` against the Pallas
  kernel's int8 variant run in interpret mode, on decode rows (Qb = 1) and
  mixed rows (Qb = 4, ``q_num`` including 0), f32, within 2e-5: the bar
  ``tests/test_kv_quant.py`` holds the Pallas kernel to (f32 on both sides,
  another summation order; the matmul precision is set to full f32 so the
  interpret-mode dots do not round). Only valid query slots are compared.
* The paged passes over an int8 pool against the JAX XLA path: logits
  within 1e-4 and the pools equal, after a grouped prefill, three decode
  steps and a ``decode_step_wide`` with Q = 3.

The int8 engine end to end against the JAX engine is in
``tests/test_torch_engine.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.engine import kv_cache as jkv
from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.ops.pallas import attention as jpallas
from generativeaiexamples_tpu_torch.engine import kv_cache as tkv
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.ops.cuda import attention as tk

ATOL_KERNEL = 2e-5
ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def test_kv_quantize_matches_jax_exactly():
    rng = np.random.default_rng(0)
    KV, HD = 4, 64
    x = (rng.standard_normal((3, 16, KV * HD)) * 2.0).astype(np.float32)
    x[0, 0, :HD] = 0.0                       # an all-zero head: scale 0
    jq, js = jkv._kv_quantize(jnp.asarray(x), KV, HD)
    q, s = tkv._kv_quantize(_t(x), KV, HD)
    assert q.dtype == torch.int8 and q.shape == x.shape
    assert s.dtype == torch.float32 and s.shape == (3, 16, KV)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = tkv._kv_dequant_dense(q, s, KV, HD, torch.float32)
    err = (back - _t(x).reshape(3, 16, KV, HD)).abs()
    assert (err <= s[..., None] / 2 + 1e-6).all()
    assert (back[0, 0, 0] == 0).all()


def _int8_pool(rng, N, ps, KV, HD):
    """int8 pages and positive (N, KV, ps) scales, as the pool holds them."""
    pages = rng.integers(-127, 128, size=(N, ps, KV * HD)).astype(np.int8)
    scales = (rng.random((N, KV, ps)) * 0.05 + 0.001).astype(np.float32)
    return pages, scales


RAGGED_CASES = {
    # R, Qb, kv_lens, q_pos0, q_num
    "decode": (4, 1, [40, 64, 21, 1], [39, 63, 20, 0], [1, 1, 1, 1]),
    "mixed": (4, 4, [40, 60, 21, 17], [39, 56, 18, 16], [1, 4, 3, 0]),
}


@pytest.mark.parametrize("case", sorted(RAGGED_CASES))
def test_int8_ragged_paged_plain_matches_interpret_kernel(case):
    R, Qb, kv_lens, q_pos0, q_num = RAGGED_CASES[case]
    rng = np.random.default_rng(len(case))
    L, P, ps, maxp, H, KV, HD = 2, 16, 16, 4, 8, 2, 32
    kp, ks = _int8_pool(rng, L * P, ps, KV, HD)
    vp, vs = _int8_pool(rng, L * P, ps, KV, HD)
    q = rng.standard_normal((R, Qb, H, HD)).astype(np.float32)
    tables = np.array([[1, 2, 3, 0], [6, 7, 8, 9], [10, 11, 0, 0],
                       [4, 5, 0, 0]], np.int32)[:R]
    lens, pos0, qnum = (np.array(a, np.int32) for a in (kv_lens, q_pos0,
                                                         q_num))
    with jax.default_matmul_precision("highest"):
        want = jpallas.ragged_paged_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(pos0),
            jnp.asarray(qnum), layer=jnp.int32(1), pages_per_layer=P,
            k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
            interpret=True)
    tk.reset_launch_counts()
    got = tk.ragged_paged_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                    _t(lens), _t(pos0), _t(qnum), layer=1,
                                    pages_per_layer=P, k_scales=_t(ks),
                                    v_scales=_t(vs))
    assert tk.launch_counts()["ragged_paged_attention_int8"] == 0   # CPU
    assert got.shape == q.shape and torch.isfinite(got).all()
    for r in range(R):
        n = int(qnum[r])
        np.testing.assert_allclose(got[r, :n].numpy(),
                                   np.asarray(want[r, :n]),
                                   atol=ATOL_KERNEL, rtol=ATOL_KERNEL)
        if n == 0:
            assert (got[r] == 0).all()
    # paged_decode forwards the scales: the decode case is its uniform row
    if case == "decode":
        got_pd = tk.paged_decode(_t(q), _t(kp), _t(vp), _t(tables),
                                 _t(lens), layer=1, pages_per_layer=P,
                                 k_scales=_t(ks), v_scales=_t(vs))
        torch.testing.assert_close(got_pd, got, atol=0, rtol=0)
    with pytest.raises(ValueError, match="both"):
        tk.ragged_paged_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                  _t(lens), _t(pos0), _t(qnum),
                                  k_scales=_t(ks))


def test_create_int8_pool_and_refuse_unknown_kv_quant():
    cfg = tl.LlamaConfig.tiny()
    c = tkv.PagedKVCache.create(cfg, 3, 5, 16, kv_quant="int8")
    width = cfg.n_kv_heads * cfg.head_dim
    assert c.quantized
    assert c.k.shape == c.v.shape == (cfg.n_layers * 5, 16, width)
    assert c.k.dtype == c.v.dtype == torch.int8
    assert c.k_s.shape == c.v_s.shape == (cfg.n_layers * 5, cfg.n_kv_heads,
                                          16)
    assert c.k_s.dtype == c.v_s.dtype == torch.float32
    assert c.lengths.shape == (3,) and c.lengths.dtype == torch.int32
    plain = tkv.PagedKVCache.create(cfg, 3, 5, 16)
    assert not plain.quantized and plain.k.dtype == cfg.torch_dtype
    with pytest.raises(ValueError, match="kv_quant"):
        tkv.PagedKVCache.create(cfg, 3, 5, 16, kv_quant="fp8")


def test_decode_scale_write_places_index_dims_first():
    """``scales[flat, :, offs] = xs`` with (B, Q) index tensors and xs of
    shape (B, Q, KV): each token's KV scales land at its (row, :, offset)."""
    N, KV, ps = 6, 3, 4
    scales = torch.zeros((N, KV, ps))
    flat = torch.tensor([[1, 1], [4, 5]])
    offs = torch.tensor([[0, 1], [3, 0]])
    xs = torch.arange(12, dtype=torch.float32).reshape(2, 2, KV)
    assert scales[flat, :, offs].shape == (2, 2, KV)
    scales[flat, :, offs] = xs
    for b in range(2):
        for j in range(2):
            assert torch.equal(scales[flat[b, j], :, offs[b, j]], xs[b, j])


B, PS, C, MAXP, P = 4, 16, 32, 8, 24


def _close(got_t, want_j):
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_j), atol=ATOL)


def _pools_equal(tc, jc, rows):
    for got, want in ((tc.k, jc.k), (tc.v, jc.v), (tc.k_s, jc.k_s),
                      (tc.v_s, jc.v_s)):
        want = np.asarray(want)[rows]
        if got.dtype == torch.int8:
            # a value a rounding step away from .5 may round the other way
            diff = np.abs(got.numpy()[rows].astype(np.int32) - want)
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        else:
            np.testing.assert_allclose(got.numpy()[rows], want, rtol=1e-5,
                                       atol=1e-7)


def test_int8_paged_passes_match_jax():
    jcfg = jl.LlamaConfig.tiny(vocab_size=300)
    tcfg = tl.LlamaConfig.tiny(vocab_size=300)
    jparams = jl.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    rng = np.random.default_rng(7)
    KV, HD = jcfg.n_kv_heads, jcfg.head_dim
    # random quantized contents, so stale rows would show
    k0, ks0 = tkv._kv_quantize(_t(rng.standard_normal(
        (jcfg.n_layers * P, PS, KV * HD)).astype(np.float32)), KV, HD)
    v0, vs0 = tkv._kv_quantize(_t(rng.standard_normal(
        (jcfg.n_layers * P, PS, KV * HD)).astype(np.float32)), KV, HD)
    ks0, vs0 = ks0.transpose(1, 2).contiguous(), vs0.transpose(1, 2).contiguous()
    lengths0 = np.array([0, 20, 0, 0], np.int32)
    jc = jkv.PagedKVCache(k=jnp.asarray(k0.numpy()), v=jnp.asarray(v0.numpy()),
                          lengths=jnp.asarray(lengths0),
                          k_s=jnp.asarray(ks0.numpy()),
                          v_s=jnp.asarray(vs0.numpy()))
    tc = tkv.PagedKVCache(k=k0.clone(), v=v0.clone(), lengths=_t(lengths0),
                          k_s=ks0.clone(), v_s=vs0.clone())
    table = np.zeros((B, MAXP), np.int32)
    table[0, :5] = [3, 9, 4, 12, 7]
    table[1, :3] = [1, 2, 5]
    live = np.ones(jcfg.n_layers * P, bool)
    live[::P] = False                        # the null page may differ

    prompt = rng.integers(0, 259, size=60).astype(np.int32)
    tokens = np.zeros((3, C), np.int32)
    tokens[0] = prompt[:32]
    tokens[1, :28] = prompt[32:]
    page_rows = np.stack([table[0], table[0], np.zeros(MAXP, np.int32)])
    slots = np.array([B, 0, B], np.int32)
    start = np.array([0, 32, 0], np.int32)
    clen = np.array([32, 28, 0], np.int32)
    jlog, jc = jkv.prefill_chunks(
        jparams, jcfg, jnp.asarray(tokens), jc, jnp.asarray(page_rows),
        jnp.asarray(slots), jnp.asarray(start), jnp.asarray(clen), P)
    tlog = tkv.prefill_chunks(tparams, tcfg, _t(tokens), tc, _t(page_rows),
                              _t(slots), _t(start), _t(clen), P)
    _close(tlog[:2], jlog[:2])
    _pools_equal(tc, jc, live)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))

    write = np.array([True, True, False, False])
    toks = np.array([5, 77, 0, 0], np.int32)
    for _ in range(3):
        jlog, jc = jkv.decode_step(jparams, jcfg, jnp.asarray(toks), jc,
                                   jnp.asarray(table), jnp.asarray(write), P)
        tlog = tkv.decode_step(tparams, tcfg, _t(toks), tc, _t(table),
                               _t(write), P)
        _close(tlog[:2], jlog[:2])
        toks = np.asarray(jlog).argmax(-1).astype(np.int32)
    _pools_equal(tc, jc, live)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))

    wide = rng.integers(0, 259, size=(B, 3)).astype(np.int32)
    jlog, jc = jkv.decode_step_wide(jparams, jcfg, jnp.asarray(wide), jc,
                                    jnp.asarray(table), jnp.asarray(write), P)
    tlog = tkv.decode_step_wide(tparams, tcfg, _t(wide), tc, _t(table),
                                _t(write), P)
    _close(tlog[:2], jlog[:2])
    _pools_equal(tc, jc, live)

