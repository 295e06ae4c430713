"""The port's mixed-phase forward (``kv_cache.mixed_step``) on the CPU.

* Against the JAX package's ``mixed_step`` under ``attn_impl="xla"``, for
  the model-dtype pool and the int8 pool, with Q = 1 and Q = 3 decode
  rows: decode logits, chunk logits and every pool row but the null page
  agree within ``ATOL = 1e-4`` (f32 on both sides, another summation
  order). Over the int8 pool a last-bit f32 difference before
  quantization can round a value lying on a half step the other way:
  such an element differs by exactly one int8 step, at most
  ``FLIP_SHARE`` of the valid elements may, and a run with a flip holds
  its logits to ``ATOL_FLIP = 1e-2`` (one step of 1/127 of a head's
  largest value moves this model's logits by up to ~8e-3); a run without
  one is held to ``ATOL``. The port runs both of its branches: ``"plain"`` (dense gathers)
  and ``"auto"``, whose ragged-attention wrapper takes its plain version
  on CPU tensors (one call per layer for every row).
* Against the port's own two-dispatch passes: ``mixed_step`` equals
  ``decode_step_wide`` plus ``prefill_chunks`` on the same pool.
* ``ragged_paged_attention_plain`` against the Pallas kernel in interpret
  mode at the mixed program's row shapes, Qb = 9 uniform verify rows and
  Qb = 16 mixed rows with ``q_num`` 0 tail rows, within ``TOL = 2e-2``
  (the tolerance of ``tests/test_torch_attention.py``).
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

ATOL = 1e-4
ATOL_FLIP = 1e-2
FLIP_SHARE = 1e-3
TOL = 2e-2
B, PS, C, MAXP, P = 4, 16, 32, 8, 40
Q_BLOCK = 8


@pytest.fixture(scope="module")
def setup():
    jcfg = jl.LlamaConfig.tiny(vocab_size=300)
    tcfg = tl.LlamaConfig.tiny(vocab_size=300)
    jparams = jl.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, jparams, tcfg, tparams


def _inputs(cfg, Q, quant, seed):
    """Random pool; slots 0 and 2 decode (Q tokens each), slot 1 prefills
    its first chunk (32 tokens), slot 3 its second (13 tokens at 32), and
    a padding chunk row; slots 1 and 3 are masked out of the writes."""
    rng = np.random.default_rng(seed)
    KV, HD = cfg.n_kv_heads, cfg.head_dim
    shape = (cfg.n_layers * P, PS, KV * HD)
    pools = {"k": rng.standard_normal(shape).astype(np.float32),
             "v": rng.standard_normal(shape).astype(np.float32)}
    if quant:
        for name in ("k", "v"):
            pools[name] = rng.integers(-127, 128, shape).astype(np.int8)
            pools[name + "_s"] = (rng.random((shape[0], KV, PS)) * 0.02
                                  + 0.01).astype(np.float32)
    table = np.zeros((B, MAXP), np.int32)
    table[0, :4] = [3, 9, 4, 12]
    table[1, :2] = [1, 2]
    table[2, :5] = [5, 6, 7, 8, 10]
    table[3, :4] = [11, 13, 14, 15]
    lengths = np.array([20, 0, 70, 32], np.int32)
    write = np.array([True, False, True, False])
    tokens = rng.integers(0, 259, size=(B, Q)).astype(np.int32)
    chunks = np.zeros((3, C), np.int32)
    chunks[0] = rng.integers(0, 259, size=C)
    chunks[1, :13] = rng.integers(0, 259, size=13)
    rows = np.stack([table[1], table[3], np.zeros(MAXP, np.int32)])
    start = np.array([0, 32, 0], np.int32)
    clen = np.array([32, 13, 0], np.int32)
    return pools, lengths, table, write, tokens, chunks, rows, start, clen


def _jax_cache(pools, lengths):
    return jkv.PagedKVCache(
        k=jnp.asarray(pools["k"]), v=jnp.asarray(pools["v"]),
        lengths=jnp.asarray(lengths),
        k_s=jnp.asarray(pools["k_s"]) if "k_s" in pools else None,
        v_s=jnp.asarray(pools["v_s"]) if "v_s" in pools else None)


def _torch_cache(pools, lengths):
    t = lambda name: (torch.from_numpy(pools[name].copy())
                      if name in pools else None)
    return tkv.PagedKVCache(k=t("k"), v=t("v"),
                            lengths=torch.from_numpy(lengths.copy()),
                            k_s=t("k_s"), v_s=t("v_s"))


def _valid(n_rows, rows, start, clen):
    """(pool row, in-page offset) pairs whose contents are defined: not a
    null page, and not a chunk's padding past its valid length (what a
    padding query writes there in later layers is the attention path's
    own, and no query ever reads it)."""
    ok = np.ones((n_rows, PS), bool)
    ok[::P] = False            # every layer's null page
    for row, s, n in zip(rows, start, clen):
        if n:
            for pos in range(s + n, s + C):
                ok[np.arange(0, n_rows, P) + row[pos // PS], pos % PS] = False
    return ok


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_pool", "int8"])
@pytest.mark.parametrize("Q", [1, 3])
def test_mixed_step_matches_jax(setup, quant, Q):
    jcfg, jparams, tcfg, tparams = setup
    pools, lengths, table, write, tokens, chunks, rows, start, clen = \
        _inputs(jcfg, Q, quant, seed=10 + Q)
    jc = _jax_cache(pools, lengths)
    jdec, jch, jc = jkv.mixed_step(
        jparams, jcfg, jnp.asarray(tokens), jc, jnp.asarray(table),
        jnp.asarray(write), P, jnp.asarray(chunks), jnp.asarray(rows),
        jnp.asarray(start), jnp.asarray(clen), q_block=Q_BLOCK)
    live = _valid(pools["k"].shape[0], rows, start, clen)
    for attn in ("plain", "auto"):
        cfg = tl.LlamaConfig.tiny(vocab_size=300)
        cfg = type(cfg)(**{**cfg.__dict__, "attn_impl": attn})
        tc = _torch_cache(pools, lengths)
        t = torch.from_numpy
        dec, ch = tkv.mixed_step(
            tparams, cfg, t(tokens), tc, t(table), t(write), P, t(chunks),
            t(rows), t(start), t(clen), q_block=Q_BLOCK)
        assert dec.shape == (B, Q, 300) and ch.shape == (3, 300)
        flips = 0
        for name in ("k", "v") + (("k_s", "v_s") if quant else ()):
            got = getattr(tc, name).float().numpy()
            want = np.asarray(getattr(jc, name)).astype(np.float32)
            if name.endswith("_s"):          # scales are (rows, KV, page)
                got, want = got.transpose(0, 2, 1), want.transpose(0, 2, 1)
            got, want = got[live], want[live]
            if quant and name in ("k", "v"):
                diff = np.abs(got - want)
                assert diff.max() <= 1, name
                flips += int((diff > 0).sum())
                assert flips <= FLIP_SHARE * got.size, (name, flips)
            else:
                np.testing.assert_allclose(got, want, atol=ATOL, err_msg=name)
        tol = ATOL_FLIP if flips else ATOL
        np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), atol=tol)
        np.testing.assert_allclose(ch[:2].numpy(), np.asarray(jch)[:2],
                                   atol=tol)
        np.testing.assert_array_equal(tc.lengths.numpy(), lengths)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_pool", "int8"])
def test_mixed_step_equals_two_dispatch_passes(setup, quant):
    _, _, tcfg, tparams = setup
    Q = 3
    pools, lengths, table, write, tokens, chunks, rows, start, clen = \
        _inputs(tcfg, Q, quant, seed=30)
    t = torch.from_numpy
    mixed = _torch_cache(pools, lengths)
    dec, ch = tkv.mixed_step(tparams, tcfg, t(tokens), mixed, t(table),
                             t(write), P, t(chunks), t(rows), t(start),
                             t(clen), q_block=Q_BLOCK)
    split = _torch_cache(pools, lengths)
    no_len = torch.full((3,), B, dtype=torch.int32)   # lengths untouched
    ch2 = tkv.prefill_chunks(tparams, tcfg, t(chunks), split, t(rows),
                             no_len, t(start), t(clen), P)
    dec2 = tkv.decode_step_wide(tparams, tcfg, t(tokens), split, t(table),
                                t(write), P)
    torch.testing.assert_close(dec, dec2, atol=ATOL, rtol=0)
    torch.testing.assert_close(ch[:2], ch2[:2], atol=ATOL, rtol=0)
    live = torch.from_numpy(_valid(pools["k"].shape[0], rows, start, clen))
    for name in ("k", "v") + (("k_s", "v_s") if quant else ()):
        got, want = getattr(mixed, name), getattr(split, name)
        if name.endswith("_s"):              # scales are (rows, KV, page)
            got, want = got.transpose(1, 2), want.transpose(1, 2)
        torch.testing.assert_close(got[live].float(), want[live].float(),
                                   atol=ATOL, rtol=0)


def test_mixed_step_refuses_rows_wider_than_q_block(setup):
    _, _, tcfg, tparams = setup
    pools, lengths, table, write, tokens, chunks, rows, start, clen = \
        _inputs(tcfg, 9, False, seed=31)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="q_block"):
        tkv.mixed_step(tparams, tcfg, t(tokens), _torch_cache(pools, lengths),
                       t(table), t(write), P, t(chunks), t(rows), t(start),
                       t(clen), q_block=Q_BLOCK)


# (R, Qb, kv_lens, q_pos0, q_num): the verify shape of a W = 9 step (the
# width ladder's top rung) and the mixed program's rows at q_block 16
# (two decode rows of 9 queries, a chunk's full rows, a partial row and
# idle tail rows with kv_len 0)
RAGGED_CASES = {
    "verify_qb9": (4, 9, [9, 40, 64, 23], [0, 31, 55, 14], [9, 9, 9, 9]),
    "mixed_qb16": (6, 16, [30, 57, 16, 32, 45, 0], [21, 48, 0, 16, 32, 48],
                   [9, 9, 16, 16, 13, 0]),
}


@pytest.mark.parametrize("case", sorted(RAGGED_CASES))
def test_ragged_plain_matches_interpret_kernel_at_mixed_shapes(case):
    R, Qb, lens, pos0, qnum = RAGGED_CASES[case]
    rng = np.random.default_rng(40 + Qb)
    L, Pp, ps, maxp, H, KV, HD = 2, 32, 16, 4, 4, 2, 16
    kp = rng.standard_normal((L * Pp, ps, KV * HD)).astype(np.float32)
    vp = rng.standard_normal((L * Pp, ps, KV * HD)).astype(np.float32)
    q = rng.standard_normal((R, Qb, H, HD)).astype(np.float32)
    tables = rng.permutation(np.arange(1, Pp))[:R * maxp].reshape(R, maxp)
    tables = tables.astype(np.int32)
    args = [np.array(a, np.int32) for a in (lens, pos0, qnum)]
    want = jpallas.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        *map(jnp.asarray, args), layer=jnp.int32(1), pages_per_layer=Pp,
        interpret=True)
    t = lambda a: torch.from_numpy(np.array(a))
    got = tk.ragged_paged_attention(t(q), t(kp), t(vp), t(tables),
                                    *map(t, args), layer=1,
                                    pages_per_layer=Pp)
    assert torch.isfinite(got).all()
    for r in range(R):
        n = qnum[r]
        np.testing.assert_allclose(got[r, :n].numpy(),
                                   np.asarray(want[r, :n]), atol=TOL)
        if n == 0:
            assert (got[r] == 0).all()
