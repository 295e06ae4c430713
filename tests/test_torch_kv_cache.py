"""Port's paged passes against the JAX package's XLA path on the CPU.

Both start from identical pool contents (random, so stale rows would show);
logits and every pool row agree within 1e-4 (f32 on both sides, different
matmul summation order) after: a grouped prefill in which two consecutive
chunks of one prompt share the group beside a padding row, three
``decode_step`` calls, and a ``decode_step_wide`` with Q = 3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.engine import kv_cache as jkv
from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu_torch.engine import kv_cache as tkv
from generativeaiexamples_tpu_torch.models import llama as tl

ATOL = 1e-4
B, PS, C, MAXP, P = 4, 16, 32, 8, 24


def _close(got_t, want_j):
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_j), atol=ATOL)


@pytest.fixture(scope="module")
def setup():
    jcfg = jl.LlamaConfig.tiny(vocab_size=300)
    tcfg = tl.LlamaConfig.tiny(vocab_size=300)
    jparams = jl.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, jparams, tcfg, tparams


def test_paged_passes_match_jax(setup):
    jcfg, jparams, tcfg, tparams = setup
    rng = np.random.default_rng(0)
    shape = (jcfg.n_layers * P, PS, jcfg.n_kv_heads * jcfg.head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    lengths0 = np.array([0, 20, 0, 0], np.int32)   # slot 1 holds 20 rows
    jc = jkv.PagedKVCache(k=jnp.asarray(k0), v=jnp.asarray(v0),
                          lengths=jnp.asarray(lengths0))
    tc = tkv.PagedKVCache(k=torch.from_numpy(k0.copy()),
                          v=torch.from_numpy(v0.copy()),
                          lengths=torch.from_numpy(lengths0.copy()))
    table = np.zeros((B, MAXP), np.int32)
    table[0, :5] = [3, 9, 4, 12, 7]
    table[1, :3] = [1, 2, 5]

    # grouped prefill: slot 0's 60-token prompt as two chunks + a padding row
    prompt = rng.integers(0, 259, size=60).astype(np.int32)
    tokens = np.zeros((3, C), np.int32)
    tokens[0] = prompt[:32]
    tokens[1, :28] = prompt[32:]
    page_rows = np.stack([table[0], table[0], np.zeros(MAXP, np.int32)])
    slots = np.array([B, 0, B], np.int32)           # dedup: newest row only
    start = np.array([0, 32, 0], np.int32)
    clen = np.array([32, 28, 0], np.int32)
    jlog, jc = jkv.prefill_chunks(
        jparams, jcfg, jnp.asarray(tokens), jc, jnp.asarray(page_rows),
        jnp.asarray(slots), jnp.asarray(start), jnp.asarray(clen), P)
    tlog = tkv.prefill_chunks(
        tparams, tcfg, torch.from_numpy(tokens), tc,
        torch.from_numpy(page_rows), torch.from_numpy(slots),
        torch.from_numpy(start), torch.from_numpy(clen), P)
    _close(tlog[:2], jlog[:2])
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))

    # three decode steps; slots 2 and 3 are masked and write the null page
    write = np.array([True, True, False, False])
    toks = np.array([5, 77, 0, 0], np.int32)
    for _ in range(3):
        jlog, jc = jkv.decode_step(jparams, jcfg, jnp.asarray(toks), jc,
                                   jnp.asarray(table), jnp.asarray(write), P)
        tlog = tkv.decode_step(tparams, tcfg, torch.from_numpy(toks), tc,
                               torch.from_numpy(table),
                               torch.from_numpy(write), P)
        _close(tlog[:2], jlog[:2])
        toks = np.asarray(jlog).argmax(-1).astype(np.int32)
    # page 0 is the null page: JAX and the port may write it differently
    # (duplicate-index writes), so compare every other physical row
    live = np.ones(shape[0], bool)
    live[::P] = False
    _close(tc.k[live], np.asarray(jc.k)[live])
    _close(tc.v[live], np.asarray(jc.v)[live])
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))

    # one wide (speculative-verify shape) step, Q = 3
    wide = rng.integers(0, 259, size=(B, 3)).astype(np.int32)
    jlog, jc = jkv.decode_step_wide(jparams, jcfg, jnp.asarray(wide), jc,
                                    jnp.asarray(table), jnp.asarray(write), P)
    tlog = tkv.decode_step_wide(tparams, tcfg, torch.from_numpy(wide), tc,
                                torch.from_numpy(table),
                                torch.from_numpy(write), P)
    assert tlog.shape == (B, 3, 300)
    _close(tlog[:2], jlog[:2])
    _close(tc.k[live], np.asarray(jc.k)[live])
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


def test_page_allocator():
    alloc = tkv.PageAllocator(5)
    assert alloc.available == 4
    got = alloc.alloc(3)
    assert got == [1, 2, 3] and alloc.alloc(2) is None
    alloc.free(got)
    assert alloc.available == 4
    with pytest.raises(ValueError):
        alloc.free([0])
    with pytest.raises(ValueError, match="kv_quant"):
        tkv.PagedKVCache.create(tl.LlamaConfig.tiny(), 2, 4, 16,
                                kv_quant="int4")


def test_prefill_chunk_matches_jax(setup):
    """The single-slot pass (a group of one): a 20-token final chunk at
    position 32 of slot 2."""
    jcfg, jparams, tcfg, tparams = setup
    rng = np.random.default_rng(1)
    shape = (jcfg.n_layers * P, PS, jcfg.n_kv_heads * jcfg.head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    jc = jkv.PagedKVCache(k=jnp.asarray(k0), v=jnp.asarray(v0),
                          lengths=jnp.zeros((B,), jnp.int32))
    tc = tkv.PagedKVCache(k=torch.from_numpy(k0.copy()),
                          v=torch.from_numpy(v0.copy()),
                          lengths=torch.zeros((B,), dtype=torch.int32))
    row = np.zeros(MAXP, np.int32)
    row[:4] = [6, 2, 11, 8]
    tokens = np.zeros((1, C), np.int32)
    tokens[0, :20] = rng.integers(0, 259, size=20)
    jlog, jc = jkv.prefill_chunk(jparams, jcfg, jnp.asarray(tokens), jc,
                                 jnp.asarray(row), jnp.int32(2),
                                 jnp.int32(32), jnp.int32(20), P)
    tlog = tkv.prefill_chunk(tparams, tcfg, torch.from_numpy(tokens), tc,
                             torch.from_numpy(row), 2, 32, 20, P)
    _close(tlog, jlog)
    _close(tc.k, jc.k)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
