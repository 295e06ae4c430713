"""Port's attention (plain paths and the kernels' plain versions) against
the JAX package on the CPU.

The kernels' plain versions are held against the Pallas kernels run in
interpret mode, on the ragged cases and GQA shapes of tests/test_pallas.py,
with ``TOL = 2e-2``: the tolerance that file uses, because this machine's
default matmul precision rounds f32 dots inside the interpret-mode kernel.
``mha_prefill``/``mha_decode`` are held against the JAX XLA paths at 1e-4
(same einsums, f32 on both sides). Only valid query slots are compared.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` and
``tests/test_torch_cuda_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.ops import attention as jattn
from generativeaiexamples_tpu.ops.pallas import attention as jpallas
from generativeaiexamples_tpu_torch.ops import attention as tattn
from generativeaiexamples_tpu_torch.ops.cuda import attention as tk

TOL = 2e-2
ATOL_PLAIN = 1e-4


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_mha_prefill_and_decode_match_jax():
    rng = np.random.default_rng(0)
    B, S, T, H, KV, HD = 2, 8, 24, 4, 2, 16
    q, k, v = (_rand(rng, (B, S, H, HD)), _rand(rng, (B, T, KV, HD)),
               _rand(rng, (B, T, KV, HD)))
    qpos = np.array([[5 + i for i in range(S)], [14 + i for i in range(S)]],
                    np.int32)
    kpos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    mask = kpos < np.array([[11], [20]])
    for window in (0, 6):
        want = jattn.mha_prefill(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(qpos),
                                 jnp.asarray(kpos), jnp.asarray(mask),
                                 window=window)
        got = tattn.mha_prefill(_t(q), _t(k), _t(v), _t(qpos), _t(kpos),
                                _t(mask), window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL_PLAIN)
    lens = np.array([7, 24], np.int32)
    want = jattn.mha_decode(jnp.asarray(q[:, :1]), jnp.asarray(k),
                            jnp.asarray(v), jnp.asarray(lens))
    got = tattn.mha_decode(_t(q[:, :1]), _t(k), _t(v), _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_PLAIN)


FLASH_CASES = [
    # (B, S, T, H, KV, HD, start_pos, valid_through)
    (2, 128, 128, 8, 4, 32, None, None),                    # full causal
    (2, 128, 128, 4, 2, 32, None, [100, 37]),               # ragged lengths
    (2, 32, 128, 4, 2, 32, [64, 16], [94, 48]),             # chunked suffix
    (1, 64, 64, 2, 1, 16, None, None),                      # single kv head
    # the masking the card's tensor-core walk branches on (64-token tiles)
    (2, 96, 320, 4, 2, 32, [192, 0], [262, 96]),      # chunk at 3x64, ragged
    (2, 72, 192, 4, 2, 16, [37, 0], [101, 72]),       # S not a multiple of 64
    (2, 48, 128, 4, 2, 32, [5, 0], [40, 17]),         # keys in the diagonal tile
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_prefill_plain_matches_interpret_kernel(case):
    B, S, T, H, KV, HD, starts, through = case
    rng = np.random.default_rng(S + T + H)
    q, k, v = (_rand(rng, (B, S, H, HD)), _rand(rng, (B, T, KV, HD)),
               _rand(rng, (B, T, KV, HD)))
    sp = None if starts is None else np.array(starts, np.int32)
    vt = None if through is None else np.array(through, np.int32)
    want = jpallas.flash_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        start_pos=None if sp is None else jnp.asarray(sp),
        kv_valid_through=None if vt is None else jnp.asarray(vt),
        interpret=True)
    got = tk.flash_prefill(_t(q), _t(k), _t(v),
                           None if sp is None else _t(sp),
                           None if vt is None else _t(vt))
    assert got.shape == (B, S, H, HD) and got.dtype == torch.float32
    for b in range(B):
        start = 0 if sp is None else sp[b]
        n = S if vt is None else min(S, vt[b] - start)
        np.testing.assert_allclose(got[b, :n].numpy(),
                                   np.asarray(want[b, :n]), atol=TOL)


def _pool(rng, L, P, ps, KV, HD):
    return (_rand(rng, (L * P, ps, KV * HD)), _rand(rng, (L * P, ps, KV * HD)))


def test_ragged_paged_plain_matches_interpret_kernel():
    """2-layer pool read at layer 1; rows with q_num 1 (decode), Qb (full),
    partial and 0; a partial last page."""
    rng = np.random.default_rng(12)
    L, P, ps, maxp, H, KV, HD, Qb = 2, 16, 16, 4, 4, 2, 32, 8
    kp, vp = _pool(rng, L, P, ps, KV, HD)
    q = _rand(rng, (4, Qb, H, HD))
    tables = np.array([[1, 2, 3, 0], [6, 7, 8, 9], [10, 11, 0, 0],
                       [4, 5, 0, 0]], np.int32)
    kv_lens = np.array([40, 60, 21, 17], np.int32)
    q_num = np.array([1, 8, 5, 0], np.int32)
    q_pos0 = np.array([39, 52, 16, 16], np.int32)
    want = jpallas.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(kv_lens), jnp.asarray(q_pos0), jnp.asarray(q_num),
        layer=jnp.int32(1), pages_per_layer=P, interpret=True)
    got = tk.ragged_paged_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                    _t(kv_lens), _t(q_pos0), _t(q_num),
                                    layer=1, pages_per_layer=P)
    assert torch.isfinite(got).all()
    for r in range(4):
        n = int(q_num[r])
        np.testing.assert_allclose(got[r, :n].numpy(),
                                   np.asarray(want[r, :n]), atol=TOL)
    assert (got[3] == 0).all()       # an empty row writes zeros


def test_paged_decode_plain_matches_interpret_kernel():
    rng = np.random.default_rng(13)
    L, P, ps, maxp, H, KV, HD = 2, 12, 16, 3, 8, 2, 16
    kp, vp = _pool(rng, L, P, ps, KV, HD)
    tables = rng.permutation(np.arange(1, P))[:3 * maxp].reshape(3, maxp)
    tables = tables.astype(np.int32)
    lens = np.array([5, 33, 48], np.int32)
    for Q in (1, 3):
        q = _rand(rng, (3, Q, H, HD))
        want = jpallas.paged_decode(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(lens), layer=jnp.int32(1),
            pages_per_layer=P, interpret=True)
        got = tk.paged_decode(_t(q), _t(kp), _t(vp), _t(tables), _t(lens),
                              layer=1, pages_per_layer=P)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_support_predicates_and_launch_counts():
    assert tk.prefill_supported(512, 2048, 128)
    assert not tk.prefill_supported(512, 2048, 96)
    for ps in (8, 16, 128):
        for hd in (16, 32, 64, 128):
            assert (tk.paged_decode_supported(ps, hd)
                    == tk.ragged_paged_supported(ps, hd, 8))
    assert not tk.ragged_paged_supported(16, 32, 3)
    assert tk.decode_supported(2048, 128) and tk.decode_supported(1, 16)
    assert not tk.decode_supported(2048, 96)
    assert not tk.decode_supported(0, 128)
    # CPU tensors take the plain version: no launch is counted
    tk.reset_launch_counts()
    x = torch.zeros((1, 8, 2, 16))
    tk.flash_prefill(x, x[:, :, :1], x[:, :, :1])
    tk.ragged_decode(x[:, :1], x[:, :, :1], x[:, :, :1],
                     torch.tensor([3], dtype=torch.int32))
    from generativeaiexamples_tpu_torch.ops.cuda import quant as cq
    cq.w8a16_gemm(torch.ones((2, 16)), torch.ones((4, 16), dtype=torch.int8),
                  torch.ones(4))
    assert tk.launch_counts() == {"flash_prefill": 0,
                                  "ragged_paged_attention": 0,
                                  "ragged_paged_attention_int8": 0,
                                  "ragged_decode": 0, "sample_slots": 0,
                                  "w8a16_gemm": 0, "grammar_mask": 0,
                                  "lora": 0}

