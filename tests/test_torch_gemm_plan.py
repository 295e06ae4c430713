"""The W8A16 GEMM's tile plan (``ops/cuda/quant.py`` ``gemm_plan``), on the
CPU, at every weight shape of llama3-8b and llama3-70b.

* At M in {1, 8, 9, 40, 72, 73, 80, 81, 136, 512, 4096} on the H100's 132
  SMs and its cluster slots: the persistent walk (cluster c takes tiles c,
  c + clusters, ...) covers every (weight-row tile, activation-row tile)
  exactly once, the tiles cover every row of y and every column, and the
  ranks' stage ranges partition the contraction in rank order, each rank
  at least one stage; clusters of at most 8 CTAs, a grid of at most 132
  CTAs and never more clusters than the card runs at once; a decode
  shape (M <= 128) puts a CTA on every SM when it has a tile for each,
  else gives every tile a cluster of its own (one round).
* Decomposing the product as the plan says (each rank's and warpgroup's
  stages summed in f32, the partials added in rank order, then the
  reference's double rounding) gives JAX's ``quant.matmul`` on the same
  int8 weights within one bf16 ulp of each rounding plus 2**-16 of
  |x| . |q| for the summation order (``chip_smoke.GEMM_TOLERANCE``).
* The weight tensor-map cache's key changes with the shape, the strides,
  the dtype or the box at one pointer.
* Decode rows are counted by the instance's rows, prefill rows exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.ops import quant as jax_quant
from generativeaiexamples_tpu_torch.ops.cuda import quant as cq

N_SM = 132
SLOTS = cq.H100_CLUSTER_SLOTS
# (name, N, K) of every weight shape: llama3-8b, then llama3-70b
SHAPES = (("8b_wq_wo", 4096, 4096), ("8b_wk_wv", 1024, 4096),
          ("8b_gate_up", 14336, 4096), ("8b_down", 4096, 14336),
          ("8b_lm_head", 128256, 4096), ("70b_wq_wo", 8192, 8192),
          ("70b_wk_wv", 1024, 8192), ("70b_gate_up", 28672, 8192),
          ("70b_down", 8192, 28672), ("70b_lm_head", 128256, 8192))
ROWS = (1, 8, 9, 40, 72, 73, 80, 81, 136, 512, 4096)


def tile_of(t, m_tiles, n_tiles):
    """csrc/w8a16_gemm.cu tile_of: unit t -> (activation tile, weight
    tile), groups of 8 activation tiles, the activation tile fastest."""
    per_group = 8 * n_tiles
    g = t // per_group
    gm = min(m_tiles - 8 * g, 8)
    r = t - g * per_group
    return 8 * g + r % gm, r // gm


def rank_ranges(plan, K):
    """Each rank's stages [lo, hi) of the contraction, in rank order."""
    ks = -(-K // plan.depth)
    return [(r * plan.ks_per_rank, min((r + 1) * plan.ks_per_rank, ks))
            for r in range(plan.cluster)], ks


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("name,N,K", SHAPES)
def test_plan_covers_every_tile_once(name, N, K, M):
    plan = cq.gemm_plan(M, N, K, N_SM, SLOTS)
    assert plan.split == (M <= 128)
    assert plan.rows == (64 if plan.split else 128)
    assert plan.bn >= (M if plan.split else 1) and plan.bn % 8 == 0
    assert plan.bn in (cq.SPLIT_ROWS if plan.split else cq.WIDE_ROWS)
    # the tiles cover y: every column and every row, none past the last
    assert plan.n_tiles * plan.rows >= N > (plan.n_tiles - 1) * plan.rows
    assert plan.m_tiles * plan.bn >= M > (plan.m_tiles - 1) * plan.bn
    tiles = plan.m_tiles * plan.n_tiles
    walked = [t for c in range(plan.clusters)
              for t in range(c, tiles, plan.clusters)]
    assert sorted(walked) == list(range(tiles))
    # every (activation tile, weight tile) exactly once
    cells = sorted(tile_of(t, plan.m_tiles, plan.n_tiles) for t in walked)
    assert cells == [(m, n) for m in range(plan.m_tiles)
                     for n in range(plan.n_tiles)]
    if plan.split:
        # the ranks' stage ranges partition the contraction in rank order
        ranges, ks = rank_ranges(plan, K)
        assert ranges[0][0] == 0 and ranges[-1][1] == ks
        assert all(lo < hi for lo, hi in ranges)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    else:
        assert plan.cluster == 1
        assert plan.ks_per_rank == -(-K // plan.depth)
    # the grid: clusters of at most 8, at most one CTA an SM, no cluster
    # waiting for a slot
    assert plan.cluster in cq.CLUSTER_SIZES and plan.cluster <= 8
    assert plan.ctas <= N_SM and plan.clusters <= SLOTS[plan.cluster]
    assert 1 <= plan.clusters <= tiles
    if plan.split:
        if tiles >= N_SM:
            assert plan.ctas == N_SM
        else:
            assert plan.clusters == tiles


# the decode plans on the H100: (cluster, CTAs) by shape; wk/wv split the
# contraction over 4 ranks (16 tiles: clusters of 8 would need 16 of the
# card's 15 slots), 8b wq/wo and down over 2
DECODE_PLANS = {"8b_wq_wo": (2, 128), "8b_wk_wv": (4, 64),
                "8b_gate_up": (1, 132), "8b_down": (2, 128),
                "8b_lm_head": (1, 132), "70b_wq_wo": (1, 128),
                "70b_wk_wv": (4, 64), "70b_gate_up": (2, 132),
                "70b_down": (1, 128), "70b_lm_head": (1, 132)}


@pytest.mark.parametrize("name,N,K", SHAPES)
def test_decode_plans_split_narrow_matrices_across_a_cluster(name, N, K):
    """Each decode shape's cluster is the one whose slowest CTA does the
    least (rounds x (stages a rank + TILE_COST)); the same at every decode
    M."""
    plan = cq.gemm_plan(8, N, K, N_SM, SLOTS)
    assert (plan.cluster, plan.ctas) == DECODE_PLANS[name]
    ks = -(-K // cq.SPLIT_DEPTH)

    def cost(c):
        kpr = -(-ks // c)
        return -(-plan.n_tiles // min(plan.n_tiles, SLOTS[c])) * (
            kpr + cq.TILE_COST)

    assert cost(plan.cluster) == min(cost(c) for c in cq.CLUSTER_SIZES)
    for M in (1, 40, 72, 128):
        assert cq.gemm_plan(M, N, K, N_SM, SLOTS)._replace(bn=8) == plan


def _emulate(x, q, s, plan):
    """The kernel's arithmetic as ``plan`` orders it, in numpy: each
    (rank, warpgroup) sums its stages' products in f32, the partials are
    added in rank order then warpgroup order (prefill tiles: one rank, the
    whole depth), then bf16(bf16(acc) * bf16(s))."""
    M, K = x.shape
    xf, qf = x.astype(np.float32), q.astype(np.float32)
    ranges, _ = rank_ranges(plan, K) if plan.split else ([(0, plan.ks_per_rank)],
                                                        None)
    acc = np.zeros((M, q.shape[0]), np.float32)
    for lo, hi in ranges:
        for wg in (range(2) if plan.split else range(1)):
            part = np.zeros_like(acc)
            stages = range(lo + wg, hi, 2) if plan.split else range(lo, hi)
            for st in stages:
                k0, k1 = st * plan.depth, min((st + 1) * plan.depth, K)
                part += xf[:, k0:k1] @ qf[:, k0:k1].T
            acc = acc + part
    y = torch.from_numpy(acc).bfloat16().float()
    sb = torch.from_numpy(s).bfloat16().float()
    return (y * sb).bfloat16().float().numpy()


@pytest.mark.parametrize("M", [1, 8, 72, 136])
@pytest.mark.parametrize("N,K,n_sm", [(256, 1024, 8), (512, 2048, 16),
                                      (192, 640, 16)])
def test_plan_decomposition_matches_jax_matmul(N, K, n_sm, M):
    """Few SMs force clusters at these small shapes; the decomposition
    still gives JAX's quantized matmul (bf16 activations)."""
    rng = np.random.default_rng(N + K + M)
    w = rng.standard_normal((K, N)).astype(np.float32) * K ** -0.5
    qt = jax_quant.quantize(jnp.asarray(w, jnp.float32), axis=0)
    q = np.asarray(qt.q).T.copy()                 # the port's (out, in)
    s = np.asarray(qt.s, np.float32).reshape(-1)
    x = rng.standard_normal((M, K)).astype(np.float32)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    plan = cq.gemm_plan(M, N, K, n_sm)
    assert plan.cluster > 1 or not plan.split
    got = _emulate(xb, q, s, plan)
    want = np.asarray(jax_quant.matmul(jnp.asarray(x, jnp.bfloat16), qt),
                      np.float32)
    unscaled = np.asarray((jnp.asarray(x, jnp.bfloat16)
                           @ jnp.asarray(q.T, jnp.bfloat16)), np.float32)
    sb = np.asarray(jnp.asarray(s, jnp.bfloat16), np.float32)
    absdot = np.abs(xb) @ np.abs(q.astype(np.float32)).T * sb
    limit = 2.0 ** -7 * (np.abs(unscaled) * sb + np.abs(want)) \
        + 2.0 ** -16 * absdot
    assert np.all(np.abs(got - want) <= limit)


def test_weight_map_key_is_more_than_the_pointer():
    q = torch.zeros((64, 256), dtype=torch.int8)
    key = cq.weight_map_key(q, 64)
    assert key == cq.weight_map_key(q.view(64, 256), 64)
    same_ptr = [q.view(128, 128), q[:, :128], q.view(torch.uint8),
                q.view(32, 512), q.t(), q.as_strided((32, 128), (512, 1))]
    for other in same_ptr:
        assert other.data_ptr() == q.data_ptr()
        assert cq.weight_map_key(other, 64) != key
    assert cq.weight_map_key(q, 128) != key


def test_rows_bucket_names_decode_instances_and_prefill_rows():
    assert cq.rows_bucket(cq.gemm_plan(8, 4096, 4096, N_SM), 8) == "m<=8"
    assert cq.rows_bucket(cq.gemm_plan(9, 4096, 4096, N_SM), 9) == "m<=16"
    assert cq.rows_bucket(cq.gemm_plan(73, 4096, 4096, N_SM), 73) == "m<=80"
    assert cq.rows_bucket(cq.gemm_plan(136, 4096, 4096, N_SM), 136) \
        == "m=136"


def test_plan_is_from_shapes_only():
    """Equal shapes give equal plans; cluster slots default to
    n_sm // size, and the H100's measured slots change only the clusters
    of 4 and 8."""
    assert cq.gemm_plan(8, 4096, 4096, N_SM) == cq.gemm_plan(8, 4096, 4096,
                                                             N_SM)
    assert cq.gemm_plan(4096, 4096, 4096, N_SM) == cq.gemm_plan(
        4096, 4096, 4096, N_SM, SLOTS)
    for name, N, K in SHAPES:
        plan = cq.gemm_plan(8, N, K, N_SM, SLOTS)
        assert plan.clusters <= SLOTS[plan.cluster]
