"""The split-KV walk of the port's decode-side kernels, on the CPU.

``ragged_paged_attention`` and ``ragged_decode`` split each row's KV walk
across blocks: block s of a (row, KV head) walks its range of 64-token
tiles into an unnormalised partial (m, l, acc), and the last block to
finish combines the partials. The kernels run only on the card; here:

* ``split_plan`` depends on shapes only, and its ranges are tile-aligned
  and cover ``[0, capacity)`` exactly once.
* The partials' algebra, written out below in numpy as the kernel computes
  it (per split: the max over live scores, the sum of unscaled
  probabilities, and P.V with int8 probabilities row-scaled by ``v_s``; a
  split with no live key for a query contributes nothing; a query no split
  saw comes out 0), over 1, 2 and S splits, equals
  ``ragged_paged_attention_plain`` and the JAX ``ragged_paged_attention``
  in interpret mode, and ``mha_decode`` and the JAX ``ragged_decode``, in
  f32 within 2e-5 (another summation order; the bar of
  tests/test_torch_kv_quant.py, with the matmul precision set to full f32
  so the interpret-mode dots do not round). Only valid query slots are
  compared; the rest must be finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.ops.pallas import attention as jpallas
from generativeaiexamples_tpu_torch.ops.attention import NEG_INF, mha_decode
from generativeaiexamples_tpu_torch.ops.cuda import attention as tk

ATOL = 2e-5
BT = tk.SPLIT_TILE


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# The split plan
# ---------------------------------------------------------------------------

def _ranges(plan, capacity):
    """Token range of each split over ``[0, capacity)``, as the kernel
    walks it: split s takes tiles [s*tiles, (s+1)*tiles) (a row's length
    clamps it further)."""
    step = plan.tiles * BT
    return [(s * step, min((s + 1) * step, capacity))
            for s in range(plan.splits)]


PLAN_CASES = {
    # rows, kv_heads, capacity, n_sm
    "decode_batch8": (8, 8, 2048, 132),
    "mixed_rows": (4, 8, 2048, 132),
    "batch1": (1, 8, 2047, 132),
    "batch1_one_kv_head_long": (1, 1, 100_000, 132),
    "one_tile": (8, 8, BT, 132),
    "one_token": (3, 2, 1, 132),
    "cells_at_132": (33, 4, 2048, 132),
    "cells_at_264": (33, 8, 2048, 132),
    "ragged_capacity": (2, 8, 1000, 132),
    "past_split_max": (1, 1, 65 * BT, 132),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_split_plan_covers_the_capacity_once(case):
    rows, kv, cap, n_sm = PLAN_CASES[case]
    plan = tk.split_plan(rows, kv, cap, n_sm)
    n_tiles = -(-cap // BT)
    ranges = _ranges(plan, cap)
    assert 1 <= plan.splits <= tk.SPLIT_MAX and len(ranges) == plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == cap
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c                                   # no gap, no overlap
    for a, b in ranges:
        assert a % BT == 0 and a < b                    # aligned, non-empty
    if n_tiles == 1:
        assert plan.splits == 1
    # at least two blocks per SM where the tiles and SPLIT_MAX allow it
    want = min(n_tiles, -(-2 * n_sm // (rows * kv)), tk.SPLIT_MAX)
    assert (plan.splits >= want
            or plan.tiles == -(-n_tiles // tk.SPLIT_MAX))


def test_split_plan_edges():
    # R*KV at or above 2 x 132 blocks: no split; at 132: two
    assert tk.split_plan(33, 8, 2048, 132).splits == 1
    assert tk.split_plan(33, 4, 2048, 132).splits == 2
    # batch 1 of llama3-8b at the smoke capacity: one tile per split
    assert tk.split_plan(1, 8, 2048, 132) == tk.SplitPlan(32, 1)
    # the smoke shapes named in the kernels' notes
    assert tk.split_plan(8, 8, 2048, 132) == tk.SplitPlan(6, 6)
    assert tk.split_plan(4, 8, 2048, 132) == tk.SplitPlan(11, 3)
    assert tk.split_plan(8, 8, 64, 132) == tk.SplitPlan(1, 1)
    plan = tk.SplitPlan(6, 6)
    assert plan.scratch_bytes(64, 4, 128) == 4 * 64 * 6 * 4 * 130
    assert tk.SplitPlan(1, 32).scratch_bytes(64, 4, 128) == 0


# ---------------------------------------------------------------------------
# The partials' algebra, as the kernel computes it
# ---------------------------------------------------------------------------

def _partial(q, k, v, lo, hi, lim, scale, ks=None, vs=None):
    """One split's partial for one query vector: keys pos in [lo, hi) with
    pos <= lim (lim < 0: none). q (HD,), k/v (T, HD), ks/vs (T,)."""
    pos = np.arange(lo, hi)
    live = pos[pos <= lim]
    if live.size == 0:
        return NEG_INF, 0.0, np.zeros(q.shape[0], np.float64)
    s = (k[live] @ q) * scale
    if ks is not None:
        s = s * ks[live]
    m = s.max()
    p = np.exp(s - m)
    l = p.sum()
    if vs is not None:
        p = p * vs[live]
    return m, l, p @ v[live]


def _combine(parts):
    """The last block's combine: only partials that saw a live key."""
    live = [(m, l, a) for m, l, a in parts if m > 0.5 * NEG_INF]
    if not live:
        return np.zeros_like(parts[0][2])
    M = max(m for m, _, _ in live)
    L = sum(np.exp(m - M) * l for m, l, _ in live)
    A = sum(np.exp(m - M) * a for m, _, a in live)
    return A / max(L, 1e-30)


def _split_walk(q, k, v, kv_lens, q_pos0, q_num, capacity, plan,
                ks=None, vs=None):
    """q (R, Qb, H, HD); k, v (R, T, KV, HD) each row's keys dense; ks, vs
    (R, T, KV). Returns (R, Qb, H, HD) in f64."""
    R, Qb, H, HD = q.shape
    KV = k.shape[2]
    G = H // KV
    out = np.zeros(q.shape, np.float64)
    for r in range(R):
        if q_num[r] == 0:
            continue                                    # zeros written
        length = min(int(kv_lens[r]), capacity)
        for h in range(KV):
            for qi in range(Qb):
                lim = (min(int(q_pos0[r]) + qi, length - 1)
                       if qi < q_num[r] else -1)
                for g in range(G):
                    qv = q[r, qi, h * G + g].astype(np.float64)
                    parts = [_partial(
                        qv, k[r, :, h].astype(np.float64),
                        v[r, :, h].astype(np.float64), lo, min(hi, length),
                        lim, 1.0 / HD ** 0.5,
                        None if ks is None else ks[r, :, h],
                        None if vs is None else vs[r, :, h])
                        for lo, hi in _ranges(plan, capacity)]
                    out[r, qi, h * G + g] = _combine(parts)
    return out


def _plans(rows, kv, capacity):
    n_tiles = -(-capacity // BT)
    return {"1": tk.SplitPlan(1, n_tiles),
            "2": tk.SplitPlan(2, -(-n_tiles // 2)),
            "S": tk.split_plan(rows, kv, capacity, n_sm=16)}


def _int8_pool(rng, N, ps, KV, HD):
    pages = rng.integers(-127, 128, size=(N, ps, KV * HD)).astype(np.int8)
    scales = (rng.random((N, KV, ps)) * 0.05 + 0.001).astype(np.float32)
    return pages, scales


PAGED_CASES = {
    # Qb, kv_lens, q_pos0, q_num. Capacity 4 tiles (maxp 16 x page 16).
    # decode: a single token, a length at a split boundary, at capacity,
    # and past capacity unclamped (as decode_step_wide passes it)
    "decode": (1, [1, 64, 256, 300], [0, 63, 255, 299], [1, 1, 1, 1]),
    # mixed rows: row 0's queries sit at 60..67, so query 0 sees nothing
    # of split [64, 128) while query 5 does; row 1 has 5 fully masked
    # slots; row 2 is empty; row 3 one token
    "mixed": (8, [68, 256, 40, 1], [60, 250, 30, 0], [8, 3, 0, 1]),
}


@pytest.mark.parametrize("quant", [False, True], ids=["f32_pool", "int8"])
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_split_partials_match_plain_and_interpret_kernel(case, quant):
    Qb, kv_lens, q_pos0, q_num = PAGED_CASES[case]
    rng = np.random.default_rng(31 + Qb + quant)
    R, L, P, ps, maxp, H, KV, HD = 4, 2, 72, 16, 16, 8, 2, 16
    cap = maxp * ps
    if quant:
        kp, ks = _int8_pool(rng, L * P, ps, KV, HD)
        vp, vs = _int8_pool(rng, L * P, ps, KV, HD)
    else:
        kp, vp = (rng.standard_normal((L * P, ps, KV * HD))
                  .astype(np.float32) for _ in range(2))
        ks = vs = None
    q = rng.standard_normal((R, Qb, H, HD)).astype(np.float32)
    tables = (rng.permutation(np.arange(1, P))[:R * maxp]
              .reshape(R, maxp).astype(np.int32))
    lens, pos0, qnum = (np.array(a, np.int32) for a in (kv_lens, q_pos0,
                                                         q_num))
    # each row's keys dense, as the kernel's address resolution reads them
    rows = 1 * P + tables                                  # layer 1
    kd = kp[rows].reshape(R, cap, KV, HD).astype(np.float32)
    vd = vp[rows].reshape(R, cap, KV, HD).astype(np.float32)
    ksd = None if ks is None else ks[rows].transpose(0, 1, 3, 2).reshape(
        R, cap, KV)
    vsd = None if vs is None else vs[rows].transpose(0, 1, 3, 2).reshape(
        R, cap, KV)

    plain = tk.ragged_paged_attention_plain(
        _t(q), _t(kp), _t(vp), _t(tables), _t(lens), _t(pos0), _t(qnum), 1,
        P, None if ks is None else _t(ks), None if vs is None else _t(vs))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jpallas.ragged_paged_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(pos0),
            jnp.asarray(qnum), layer=jnp.int32(1), pages_per_layer=P,
            k_scales=None if ks is None else jnp.asarray(ks),
            v_scales=None if vs is None else jnp.asarray(vs),
            interpret=True))
    plans = _plans(R, KV, cap)
    assert plans["S"].splits == 4 and plans["S"].tiles == 1
    for label, plan in plans.items():
        got = _split_walk(q, kd, vd, lens, pos0, qnum, cap, plan, ksd, vsd)
        assert np.isfinite(got).all(), label
        for r in range(R):
            n = int(qnum[r])
            np.testing.assert_allclose(got[r, :n], plain[r, :n].numpy(),
                                       atol=ATOL, rtol=ATOL, err_msg=label)
            np.testing.assert_allclose(got[r, :n], want[r, :n], atol=ATOL,
                                       rtol=ATOL, err_msg=label)
            if n == 0:
                assert (got[r] == 0).all()
            else:
                assert (got[r, n:] == 0).all()   # no split saw these slots


def test_split_past_one_querys_causal_limit_contributes_nothing():
    """Row 0 of the mixed case: query 0 (at position 60) has no live key in
    split [64, 128); its partial there is empty and the combine skips it,
    while query 5 (at 65) has a live partial there."""
    rng = np.random.default_rng(5)
    HD, T = 16, 128
    q = rng.standard_normal(HD)
    k, v = rng.standard_normal((2, T, HD))
    m, l, a = _partial(q, k, v, 64, 68, 60, 0.25)
    assert (m, l) == (NEG_INF, 0.0) and (a == 0).all()
    m5, l5, _ = _partial(q, k, v, 64, 68, 65, 0.25)
    assert m5 > 0.5 * NEG_INF and l5 >= 1.0
    solo = _combine([_partial(q, k, v, 0, 64, 60, 0.25)])
    both = _combine([_partial(q, k, v, 0, 64, 60, 0.25), (m, l, a)])
    np.testing.assert_array_equal(solo, both)
    assert (_combine([(NEG_INF, 0.0, a)]) == 0).all()   # fully masked slot


DECODE_CASES = {
    # B, T, H, KV, HD, lengths, block_t: a single token, a length at a
    # split boundary, past the cache (decode_step once a slot is full)
    "ragged": (3, 256, 8, 2, 16, [1, 128, 300], 64),
    "one_kv_head": (2, 192, 4, 1, 32, [192, 65], 64),
    # gemma-2b's heads: G = 8 of 256 on one KV head
    "head_dim_256": (2, 160, 8, 1, 256, [160, 70], 64),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_split_partials_match_mha_decode_and_interpret_kernel(case):
    B, T, H, KV, HD, lengths, block_t = DECODE_CASES[case]
    rng = np.random.default_rng(B + T)
    q = rng.standard_normal((B, 1, H, HD)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, HD)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, HD)).astype(np.float32)
    lens = np.array(lengths, np.int32)
    plain = mha_decode(_t(q), _t(k), _t(v), _t(lens)).numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jpallas.ragged_decode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
            block_t=block_t, interpret=True))
    # ragged_decode's walk: a row of one query at position len - 1
    clamped = np.minimum(lens, T)
    for label, plan in _plans(B, KV, T).items():
        got = _split_walk(q, k, v, clamped, clamped - 1, np.ones(B, np.int32),
                          T, plan)
        np.testing.assert_allclose(got, plain, atol=ATOL, rtol=ATOL,
                                   err_msg=label)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL,
                                   err_msg=label)


# ---------------------------------------------------------------------------
# Head dim 256 (the Gemma family): 32 query vectors a block, query tiles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group,q_block,tile", [
    (1, 1, 1), (1, 5, 5), (1, 9, 9), (1, 16, 16),      # gemma-7b
    (8, 1, 1), (8, 5, 4), (8, 9, 4), (8, 16, 4),       # gemma-2b
])
def test_query_tile_at_head_dim_256(group, q_block, tile):
    assert tk.qg_max(256) == 32 and tk.qg_max(128) == tk.QG_MAX == 64
    assert tk.query_tile(q_block, group, 256) == tile
    assert tile * group <= tk.qg_max(256)
    # llama3-70b's G = 8 at head_dim 128 keeps its 8-query tiles
    assert tk.query_tile(q_block, group, 128) == (
        q_block if q_block * group <= 64 else 64 // group)


def test_query_tile_refuses_a_group_past_the_head_dims_block():
    assert tk.query_tile(1, 32, 256) == 1
    with pytest.raises(ValueError, match="head_dim 256"):
        tk.query_tile(1, 33, 256)
    assert tk.query_tile(1, 64, 128) == 1


@pytest.mark.parametrize("rows,kv,qg", [(8, 16, 1), (16, 1, 4), (8, 1, 8)],
                         ids=["gemma7b_decode", "gemma2b_verify_tiles",
                              "gemma2b_decode"])
def test_split_scratch_at_head_dim_256(rows, kv, qg):
    """The partials' scratch at head_dim 256 for gemma-7b's decode rows
    (G = 1, 16 KV heads) and gemma-2b's (G = 8, one KV head; a verify row
    of 5 is two tiles of 4 queries): (m, l, acc) f32 a query vector and
    split, 258 values, against 130 at head_dim 128."""
    plan = tk.split_plan(rows, kv, 2048, 132)
    cells = rows * kv
    got = plan.scratch_bytes(cells, qg, 256)
    assert got == 4 * cells * plan.splits * qg * (256 + 2)
    if plan.splits > 1:
        assert got * 130 == plan.scratch_bytes(cells, qg, 128) * 258
    assert plan.splits * plan.tiles * BT >= 2048


def _tiled_walk(q, k, v, lens, pos0, qnum, cap, plan, tq):
    """The wrapper's query tiles of ``tq`` queries, each walked as a row
    of its own (its queries, its first position, its live count), stitched
    back."""
    R, Qb = q.shape[:2]
    out = np.zeros(q.shape, np.float64)
    for q0 in range(0, Qb, tq):
        qb = min(tq, Qb - q0)
        n = np.clip(qnum - q0, 0, qb).astype(np.int32)
        part = _split_walk(q[:, q0:q0 + qb], k, v, lens, pos0 + q0, n, cap,
                           plan)
        out[:, q0:q0 + qb] = part
    return out


@pytest.mark.parametrize("heads", [(2, 2), (8, 1)], ids=["G1", "G8"])
@pytest.mark.parametrize("Qb", [5, 16])
def test_query_tiles_at_head_dim_256_match_plain_and_interpret_kernel(
        heads, Qb):
    """Rows of Qb = 5 (a verify step) and 16 (a mixed row) at head_dim
    256, cut into the wrapper's query tiles, each walked in splits: the
    plain version and the JAX kernel in interpret mode within 2e-5."""
    H, KV = heads
    HD, R, L, P, ps, maxp = 256, 3, 2, 20, 16, 4
    rng = np.random.default_rng(80 + Qb + H)
    cap = maxp * ps
    kp, vp = (rng.standard_normal((L * P, ps, KV * HD)).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((R, Qb, H, HD)).astype(np.float32)
    tables = (rng.permutation(np.arange(1, P))[:R * maxp]
              .reshape(R, maxp).astype(np.int32))
    lens = np.array([Qb + 3, cap, 40], np.int32)
    qnum = np.array([Qb, Qb - 2, 0], np.int32)
    pos0 = lens - qnum
    tq = tk.query_tile(Qb, H // KV, HD)
    assert tq * (H // KV) <= 32 and (tq < Qb) == (Qb * H // KV > 32)
    plain = tk.ragged_paged_attention_plain(
        _t(q), _t(kp), _t(vp), _t(tables), _t(lens), _t(pos0), _t(qnum), 1,
        P).numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jpallas.ragged_paged_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(pos0),
            jnp.asarray(qnum), layer=jnp.int32(1), pages_per_layer=P,
            interpret=True))
    rows = 1 * P + tables
    kd = kp[rows].reshape(R, cap, KV, HD)
    vd = vp[rows].reshape(R, cap, KV, HD)
    for label, plan in _plans(R, KV, cap).items():
        got = _tiled_walk(q, kd, vd, lens, pos0, qnum, cap, plan, tq)
        for r in range(R):
            n = int(qnum[r])
            np.testing.assert_allclose(got[r, :n], plain[r, :n], atol=ATOL,
                                       rtol=ATOL, err_msg=label)
            np.testing.assert_allclose(got[r, :n], want[r, :n], atol=ATOL,
                                       rtol=ATOL, err_msg=label)
