"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Skips without one (the kernels have no CPU build). Imports nothing of JAX,
so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest

f32 within 1e-4 (same f32 arithmetic, another summation order); bf16
within 3e-2 (one bf16 rounding of outputs below 4 in magnitude). The int8
pool's kernel and plain version do the same f32 math on the same int8
values and scales, so the same tolerances hold. The split-walk tests hold
bf16 outputs per (row, query, head) to one bf16 ulp of the largest plain
output, the bar ``chip_smoke.py`` uses, since int8-pool outputs reach 6.
The W8A16 GEMM is held to its plain version by ``chip_smoke.py``'s
``check_gemm`` (one bf16 ulp of the unscaled product times the scale plus
one of the result, and 2**-16 of |x| @ |q|^T for the summation order).
The sampling kernel is held to its plain version by ``chip_smoke.py``'s
``check_sampler``: the top-k cutoff bit-equal, the top-p cutoff and the
token equal except at counted near-ties (a mass within rounding of the
target, the top two ``logit + gumbel`` within 1e-5), logprobs within
1e-5. The LoRA update is held by ``chip_smoke.py``'s ``check_lora``
(``LORA_TOLERANCE``; rows of slot 0 bit-equal to the input).
"""

import os
import sys

import numpy as np
import pytest
import torch

from generativeaiexamples_tpu_torch.ops.attention import mha_decode
from generativeaiexamples_tpu_torch.ops.cuda import attention as tk


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU build")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# The kernels' limits, on the CPU: the predicates and each instance's
# shared memory
# ---------------------------------------------------------------------------

SMEM_OPTIN = 232_448   # shared memory a block may opt into on the H100


def _round16(n):
    return -(-n // 16) * 16


def walk_smem_bytes(act, pool, head_dim, qgb):
    """Dynamic shared memory of one instance of the decode-side walk, the
    arithmetic of csrc/common.cuh ``Walk<T, KT, HD, QGB>::SMEM``:
    activations ``act`` (bf16 or f32), pool ``pool`` (the activations'
    dtype or int8), query bucket ``qgb`` (16, 32 or 64 rows)."""
    mma = act != torch.float32
    kt = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}[pool]
    ns = 2 if kt == 4 else 3
    st = tk.SPLIT_TILE // 2 if kt == 4 and head_dim > 128 else tk.SPLIT_TILE
    ldk = head_dim + 16 // kt
    ldq = head_dim + 8 if mma else head_dim + 1
    q_bytes = (_round16(2 * qgb * ldq) if mma
               else _round16(4 * (qgb * ldq + qgb * st + 3 * qgb)))
    ring = (_round16(kt * ns * 2 * st * ldk)
            + (4 * ns * 2 * st if kt == 1 else 0))
    merge = 4 * (4 if mma else 1) * qgb * (head_dim + 6)
    combine = 4 * 3 * tk.SPLIT_MAX * qgb
    return q_bytes + 8 * 4 * st + max(ring, merge, combine)


def walk_buckets(head_dim):
    """The query buckets the decode-side kernels instantiate."""
    return tuple(b for b in (16, 32, 64) if b <= tk.qg_max(head_dim))


def flash_smem_bytes(dtype, head_dim):
    """Dynamic shared memory of a ``flash_prefill`` instance, the
    arithmetic of csrc/flash_prefill.cu (``MmaTile<HD>::SMEM`` for bf16,
    ``f32_smem_bytes<HD>`` for f32): 64-query and 64-token tiles."""
    if dtype == torch.float32:
        return 4 * (64 * (head_dim + 1) * 2 + 64 * head_dim + 64 * 65)
    qreg = head_dim <= 128
    ld = head_dim + 8
    return 2 * ((3 if qreg else 2) * 2 * 64 * ld + (0 if qreg else 64 * ld))

@pytest.mark.parametrize("HD", [16, 32, 64, 128, 256])
def test_predicates_take_every_instance(HD):
    assert tk.prefill_supported(512, 2048, HD)
    assert tk.decode_supported(2048, HD)
    assert tk.paged_decode_supported(128, HD)
    assert tk.ragged_paged_supported(128, HD, 16)
    assert tk.paged_decode_supported(128, HD) == tk.ragged_paged_supported(
        128, HD, 8)


@pytest.mark.parametrize("HD", [8, 48, 96, 512])
def test_predicates_refuse_other_head_dims(HD):
    assert not tk.prefill_supported(512, 2048, HD)
    assert not tk.decode_supported(2048, HD)
    assert not tk.paged_decode_supported(128, HD)
    assert not tk.ragged_paged_supported(128, HD, 8)


# the shared memory of the HD 256 instances, as the sources' notes state
HD256_SMEM = {
    ("walk", torch.bfloat16, torch.bfloat16, 16): 213_248,
    ("walk", torch.bfloat16, torch.bfloat16, 32): 221_696,
    ("walk", torch.bfloat16, torch.int8, 32): 153_088,
    ("walk", torch.float32, torch.float32, 32): 171_520,
    ("flash", torch.bfloat16): 168_960,
    ("flash", torch.float32): 213_760,
}


def test_shared_memory_of_every_instance_fits_the_card():
    """Every instance the sources build, at every head dim and bucket, fits
    the H100's 232,448 bytes a block (with 16 of static memory); the HD
    256 instances are the numbers in the sources' notes, and the 64-row
    bucket the HD 256 cap leaves out would not fit."""
    pairs = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8),
             (torch.float32, torch.float32), (torch.float32, torch.int8)]
    for HD in tk.HEAD_DIMS:
        assert walk_buckets(HD)[-1] == tk.qg_max(HD)
        for act, pool in pairs:
            for qgb in walk_buckets(HD):
                assert walk_smem_bytes(act, pool, HD, qgb) + 16 \
                    <= SMEM_OPTIN, (act, pool, HD, qgb)
        for dt in (torch.bfloat16, torch.float32):
            assert flash_smem_bytes(dt, HD) <= SMEM_OPTIN
    for key, want in HD256_SMEM.items():
        got = (walk_smem_bytes(*key[1:3], 256, key[3])
               if key[0] == "walk" else flash_smem_bytes(key[1], 256))
        assert got == want, key
    assert walk_buckets(256) == (16, 32)
    assert walk_smem_bytes(torch.bfloat16, torch.bfloat16, 256, 64) \
        > SMEM_OPTIN
    # the llama3 instances are the ones the notes name at HD 128
    assert walk_smem_bytes(torch.bfloat16, torch.bfloat16, 128, 16) \
        == 110_848
    assert walk_smem_bytes(torch.float32, torch.float32, 128, 64) \
        == 187_392
    assert flash_smem_bytes(torch.bfloat16, 128) == 104_448


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card(cuda_device):
    rng = np.random.default_rng(21)
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        B, S, T, H, KV, HD = 2, 96, 160, 8, 2, 64
        q, k, v = (_t(_rand(rng, s)).to(cuda_device, dt)
                   for s in ((B, S, H, HD), (B, T, KV, HD), (B, T, KV, HD)))
        sp = torch.tensor([0, 64], dtype=torch.int32, device=cuda_device)
        vt = torch.tensor([90, 150], dtype=torch.int32, device=cuda_device)
        got = tk.flash_prefill(q, k, v, sp, vt).float()
        want = tk.flash_prefill_plain(q, k, v, sp, vt).float()
        for b, n in enumerate((90, 86)):
            assert (got[b, :n] - want[b, :n]).abs().max().item() < tol
        P, ps, maxp, Qb = 10, 16, 4, 8
        kp, vp = (_t(_rand(rng, (2 * P, ps, KV * HD))).to(cuda_device, dt)
                  for _ in range(2))
        qr = _t(_rand(rng, (3, Qb, H, HD))).to(cuda_device, dt)
        tables = torch.tensor([[1, 2, 3, 4], [5, 6, 0, 0], [7, 8, 9, 0]],
                              dtype=torch.int32, device=cuda_device)
        lens = torch.tensor([64, 20, 70], dtype=torch.int32,
                            device=cuda_device)
        pos0 = torch.tensor([63, 12, 40], dtype=torch.int32,
                            device=cuda_device)
        qnum = torch.tensor([1, 8, 0], dtype=torch.int32, device=cuda_device)
        got = tk.ragged_paged_attention(qr, kp, vp, tables, lens, pos0, qnum,
                                        layer=1, pages_per_layer=P).float()
        want = tk.ragged_paged_attention_plain(qr, kp, vp, tables, lens,
                                               pos0, qnum, 1, P).float()
        for r, n in enumerate((1, 8)):
            assert (got[r, :n] - want[r, :n]).abs().max().item() < tol
        assert (got[2] == 0).all()      # q_num == 0 writes zeros


@pytest.mark.cuda
def test_paged_decode_wide_matches_plain_on_the_card(cuda_device):
    rng = np.random.default_rng(22)
    P, ps, maxp, H, KV, HD = 12, 16, 3, 8, 2, 16
    kp, vp = (_t(_rand(rng, (2 * P, ps, KV * HD))).to(cuda_device)
              for _ in range(2))
    tables = torch.tensor(rng.permutation(np.arange(1, P))[:3 * maxp]
                          .reshape(3, maxp), dtype=torch.int32,
                          device=cuda_device)
    lens = torch.tensor([5, 33, 60], dtype=torch.int32, device=cuda_device)
    q = _t(_rand(rng, (3, 3, H, HD))).to(cuda_device)
    got = tk.paged_decode(q, kp, vp, tables, lens, layer=1, pages_per_layer=P)
    B, Q = q.shape[:2]
    want = tk.ragged_paged_attention_plain(
        q, kp, vp, tables, lens.clamp_max(maxp * ps), lens - Q,
        torch.full((B,), Q, dtype=torch.int32, device=cuda_device), 1, P)
    assert (got - want).abs().max().item() < 1e-4   # capacity clamp: row 2


@pytest.mark.cuda
def test_int8_ragged_paged_matches_plain_on_the_card(cuda_device):
    rng = np.random.default_rng(23)
    P, ps, H, KV, HD, Qb = 10, 16, 8, 2, 64, 8
    kp, vp = (_t(rng.integers(-127, 128, size=(2 * P, ps, KV * HD))
                 .astype(np.int8)).to(cuda_device) for _ in range(2))
    ks, vs = (_t((rng.random((2 * P, KV, ps)) * 0.05 + 1e-3)
                 .astype(np.float32)).to(cuda_device) for _ in range(2))
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 0, 0], [7, 8, 9, 0]],
                          dtype=torch.int32, device=cuda_device)
    lens = torch.tensor([64, 20, 70], dtype=torch.int32, device=cuda_device)
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        for Q, pos0, qnum in ((1, [63, 19, 40], [1, 1, 0]),
                              (Qb, [63, 12, 40], [1, 8, 0])):
            qr = _t(_rand(rng, (3, Q, H, HD))).to(cuda_device, dt)
            pos = torch.tensor(pos0, dtype=torch.int32, device=cuda_device)
            qn = torch.tensor(qnum, dtype=torch.int32, device=cuda_device)
            tk.reset_launch_counts()
            got = tk.ragged_paged_attention(
                qr, kp, vp, tables, lens, pos, qn, layer=1,
                pages_per_layer=P, k_scales=ks, v_scales=vs).float()
            assert tk.launch_counts()["ragged_paged_attention_int8"] == 1
            assert tk.launch_counts()["ragged_paged_attention"] == 0
            want = tk.ragged_paged_attention_plain(
                qr, kp, vp, tables, lens, pos, qn, 1, P, ks, vs).float()
            for r, n in enumerate(qnum[:2]):
                assert (got[r, :n] - want[r, :n]).abs().max().item() < tol
            assert (got[2] == 0).all()      # q_num == 0 writes zeros
    with pytest.raises(ValueError, match="scales"):
        tk.ragged_paged_attention(qr, kp, vp, tables, lens, pos, qn,
                                  k_scales=ks[:, :1], v_scales=vs[:, :1])


@pytest.mark.cuda
def test_ragged_decode_matches_plain_on_the_card(cuda_device):
    """One layer of a (L, B, T, KV, HD) cache, read through its strides;
    ragged lengths, a full slot and a length past the cache."""
    rng = np.random.default_rng(24)
    L, B, T, H, KV, HD = 2, 4, 200, 8, 2, 64
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        k, v = (_t(_rand(rng, (L, B, T, KV, HD))).to(cuda_device, dt)
                for _ in range(2))
        q = _t(_rand(rng, (B, 1, H, HD))).to(cuda_device, dt)
        lens = torch.tensor([1, 77, T, T + 1], dtype=torch.int32,
                            device=cuda_device)
        tk.reset_launch_counts()
        got = tk.ragged_decode(q, k[1], v[1], lens).float()
        assert tk.launch_counts()["ragged_decode"] == 1
        want = mha_decode(q, k[1], v[1], lens).float()
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() < tol


@pytest.mark.cuda
def test_dense_api_kernel_path_matches_plain_path_on_the_card(cuda_device):
    """llama.prefill plus greedy decode_step over the dense cache: the
    flash_prefill/ragged_decode path and the plain one give the same
    tokens (tiny model, f32)."""
    import dataclasses
    from generativeaiexamples_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny(vocab_size=300)
    params = llama.init_params(
        torch.Generator(device=cuda_device).manual_seed(6), cfg)
    rng = np.random.default_rng(25)
    tokens = _t(rng.integers(0, 259, size=(3, 40)).astype(np.int32)).to(
        cuda_device)
    seq = torch.tensor([40, 17, 5], dtype=torch.int32, device=cuda_device)
    streams = {}
    for attn in ("kernel", "plain"):
        c = dataclasses.replace(cfg, attn_impl=attn)
        cache = llama.KVCache.create(c, 3, 128, device=cuda_device)
        tk.reset_launch_counts()
        logits, cache = llama.prefill(params, c, tokens, cache,
                                      torch.zeros_like(seq), seq,
                                      last_only=True)
        tok = logits[:, 0].argmax(-1)
        out = [tok]
        for _ in range(16):
            logits, cache = llama.decode_step(params, c, tok, cache)
            tok = logits.argmax(-1)
            out.append(tok)
        streams[attn] = torch.stack(out).tolist()
        if attn == "kernel":
            n = tk.launch_counts()
            assert n["flash_prefill"] == cfg.n_layers
            assert n["ragged_decode"] == 16 * cfg.n_layers
    assert streams["kernel"] == streams["plain"]


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_name", ["tiny", "llama3_8b"])
def test_stock_config_dense_api_launches_the_kernels(cuda_device, cfg_name):
    """The stock configs (``attn_impl="auto"``) send ``llama.prefill`` and
    ``llama.decode_step`` on CUDA tensors through flash_prefill and
    ragged_decode (llama3-8b widths, cut to 2 layers and a small vocab)."""
    import dataclasses
    from generativeaiexamples_tpu_torch.models import llama

    cfg = getattr(llama.LlamaConfig, cfg_name)()
    assert cfg.attn_impl == "auto"
    cfg = dataclasses.replace(cfg, n_layers=2, vocab_size=300)
    params = llama.init_params(
        torch.Generator(device=cuda_device).manual_seed(7), cfg)
    tokens = torch.randint(0, 259, (2, 24), device=cuda_device,
                           dtype=torch.int32)
    seq = torch.tensor([24, 9], dtype=torch.int32, device=cuda_device)
    cache = llama.KVCache.create(cfg, 2, 64, device=cuda_device)
    tk.reset_launch_counts()
    with torch.no_grad():
        logits, cache = llama.prefill(params, cfg, tokens, cache,
                                      torch.zeros_like(seq), seq,
                                      last_only=True)
        logits, cache = llama.decode_step(params, cfg,
                                          logits[:, 0].argmax(-1), cache)
    n = tk.launch_counts()
    assert n["flash_prefill"] == n["ragged_decode"] == cfg.n_layers
    assert torch.isfinite(logits).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_engine_kernel_path_matches_plain_path_on_the_card(cuda_device,
                                                           kv_quant):
    """Greedy streams of the tiny model through the Scheduler on the
    narrow two-dispatch path: the kernel attention path and the plain one
    give the same tokens (f32), over the model-dtype pool and over the
    int8 pool."""
    from generativeaiexamples_tpu_torch.core.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.engine import EngineCore
    from generativeaiexamples_tpu_torch.engine.scheduler import (
        Request, Scheduler)
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny(vocab_size=300)
    params = llama.init_params(
        torch.Generator(device=cuda_device).manual_seed(5), cfg)
    tok = ByteTokenizer()
    prompts = [tok.encode("hello", add_bos=True),
               tok.encode("a longer prompt than one chunk of 32 tokens, "
                          "so it takes two", add_bos=True)]
    streams = {}
    for attn in ("kernel", "plain"):
        sched = Scheduler(EngineCore(
            cfg, EngineConfig(max_batch_size=4, max_seq_len=128,
                              prefill_chunk=32, page_size=16, attention=attn,
                              kv_quant=kv_quant, spec_decode="off",
                              mixed_phase_dispatch="off"),
            params, tok.eos_id, device=cuda_device), tok)
        tk.reset_launch_counts()
        sched.start()
        try:
            reqs = [sched.submit(Request(prompt_ids=p, max_tokens=24,
                                         temperature=0.0)) for p in prompts]
            for r in reqs:
                list(sched.iter_text(r))
        finally:
            sched.stop()
        assert all(r.error is None for r in reqs)
        streams[attn] = [r.output_ids for r in reqs]
        if attn == "kernel":
            key = ("ragged_paged_attention_int8" if kv_quant == "int8"
                   else "ragged_paged_attention")
            assert tk.launch_counts()[key] > 0
    assert streams["kernel"] == streams["plain"]


def _within_one_ulp(got, want):
    """Per (row, query, head): within one bf16 ulp of its largest plain
    output (the bar chip_smoke.py holds bf16 instances to), and finite."""
    g, w = got.float(), want.float()
    err = (g - w).abs().amax(dim=-1)
    limit = 2.0 ** -7 * w.abs().amax(dim=-1) + 1e-6
    return bool(torch.isfinite(g).all()) and bool((err <= limit).all())


def _flash_inputs(rng, dev, dt, B, S, T, H, KV, HD, starts, through):
    q, k, v = (_t(_rand(rng, s)).to(dev, dt)
               for s in ((B, S, H, HD), (B, T, KV, HD), (B, T, KV, HD)))
    sp = torch.tensor(starts, dtype=torch.int32, device=dev)
    vt = torch.tensor(through, dtype=torch.int32, device=dev)
    return q, k, v, sp, vt


@pytest.mark.cuda
@pytest.mark.parametrize("S", [512, 200])
def test_flash_prefill_bf16_at_llama3_heads_on_the_card(cuda_device, S):
    """The tensor-core instance at llama3-8b heads (32 q, 8 KV, HD 128):
    a first chunk, later chunks (start > 0, a start off the 64-token
    grid), valid lengths inside the chunk; S = 200 leaves the last query
    tile partly past the chunk. Each live (query, head) within one bf16
    ulp of its largest plain output; padded query slots finite."""
    rng = np.random.default_rng(50 + S)
    B, T, H, KV, HD = 4, 1536, 32, 8, 128
    starts = [0, 512, 200, 1000]
    through = [S, 512 + S - 37, 200 + S // 3, 1000 + S]
    q, k, v, sp, vt = _flash_inputs(rng, cuda_device, torch.bfloat16, B, S,
                                    T, H, KV, HD, starts, through)
    tk.reset_launch_counts()
    got = tk.flash_prefill(q, k, v, sp, vt)
    assert tk.launch_counts()["flash_prefill"] == 1
    assert got.shape == q.shape and got.dtype == q.dtype
    assert got.is_contiguous() and torch.isfinite(got).all()
    want = tk.flash_prefill_plain(q, k, v, sp, vt)
    for b in range(B):
        n = min(S, through[b] - starts[b])
        assert _within_one_ulp(got[b, :n], want[b, :n]), b


@pytest.mark.cuda
def test_flash_prefill_cache_hit_suffixes_on_the_card(cuda_device):
    """A grouped prefill of 8 cache-hit suffixes: 40 to 200 live queries
    padded to 256 (two pages), page-aligned starts 1,408 to 1,664 over a
    2,048-token view, llama3-8b heads, bf16; each live (query, head)
    within one bf16 ulp, the padded query tiles finite."""
    rng = np.random.default_rng(58)
    S, T, H, KV, HD = 256, 2048, 32, 8, 128
    starts = [1408, 1536, 1664, 1408, 1536, 1664, 1408, 1536]
    lens = [40, 64, 100, 128, 150, 180, 200, 77]
    q, k, v, sp, vt = _flash_inputs(
        rng, cuda_device, torch.bfloat16, len(starts), S, T, H, KV, HD,
        starts, [s + n for s, n in zip(starts, lens)])
    got = tk.flash_prefill(q, k, v, sp, vt)
    want = tk.flash_prefill_plain(q, k, v, sp, vt)
    assert torch.isfinite(got).all()
    for b, n in enumerate(lens):
        assert _within_one_ulp(got[b, :n], want[b, :n]), b


@pytest.mark.cuda
@pytest.mark.parametrize("HD", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_prefill_every_head_dim_on_the_card(cuda_device, dt, HD):
    """Every template instance at a small shape; k and v are one layer of
    a (L, B, T, KV, HD) cache, read through its strides."""
    rng = np.random.default_rng(60 + HD)
    B, S, T, H, KV = 2, 96, 160, 4, 2
    q = _t(_rand(rng, (B, S, H, HD))).to(cuda_device, dt)
    k, v = (_t(_rand(rng, (2, B, T, KV, HD))).to(cuda_device, dt)[1]
            for _ in range(2))
    sp = torch.tensor([0, 64], dtype=torch.int32, device=cuda_device)
    vt = torch.tensor([90, 150], dtype=torch.int32, device=cuda_device)
    got = tk.flash_prefill(q, k, v, sp, vt)
    want = tk.flash_prefill_plain(q, k, v, sp, vt)
    assert torch.isfinite(got).all()
    for b, n in enumerate((90, 86)):
        if dt == torch.float32:
            assert (got[b, :n] - want[b, :n]).abs().max().item() < 1e-4
        else:
            assert _within_one_ulp(got[b, :n], want[b, :n])


@pytest.mark.cuda
def test_flash_prefill_refuses_what_it_cannot_take(cuda_device):
    """A CUDA tensor never falls back to the plain version: rows off 16
    bytes, an unsupported head dim or mixed dtypes raise."""
    B, S, T, H, KV, HD = 1, 64, 64, 4, 2, 64
    q = torch.zeros((B, S, H, HD), dtype=torch.bfloat16, device=cuda_device)
    kv = torch.zeros((B, T, KV, HD), dtype=torch.bfloat16,
                     device=cuda_device)
    tk.reset_launch_counts()
    odd = torch.zeros((B, T, KV, HD + 1), dtype=torch.bfloat16,
                      device=cuda_device)[..., 1:]
    with pytest.raises(ValueError, match="16-byte"):
        tk.flash_prefill(q, odd, kv)
    with pytest.raises(ValueError, match="unsupported shapes"):
        tk.flash_prefill(q[..., :48], kv[..., :48], kv[..., :48])
    with pytest.raises(ValueError, match="one dtype"):
        tk.flash_prefill(q, kv.float(), kv)
    assert tk.launch_counts()["flash_prefill"] == 0


def _split_pool(rng, dev, pool, N, ps, KV, HD):
    if pool == "int8":
        pages = [_t(rng.integers(-127, 128, size=(N, ps, KV * HD))
                    .astype(np.int8)).to(dev) for _ in range(2)]
        scales = [_t((rng.random((N, KV, ps)) * 0.05 + 1e-3)
                     .astype(np.float32)).to(dev) for _ in range(2)]
        return pages, scales
    dt = torch.float32 if pool == "f32" else torch.bfloat16
    return [_t(_rand(rng, (N, ps, KV * HD))).to(dev, dt)
            for _ in range(2)], [None, None]


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [16, 128])
@pytest.mark.parametrize("pool", ["bf16", "f32", "int8"])
def test_split_walk_ragged_paged_matches_plain_on_the_card(cuda_device, pool,
                                                           ps):
    """The split walk of ragged_paged_attention at llama3-8b heads (32 q,
    8 KV, HD 128): decode rows with kv_len 1, exactly at the first split's
    end, at capacity and past it unclamped; Qb = 8 mixed rows with a
    q_num == 0 row and a query whose causal limit lies before the second
    split; one row alone (R = 1). Two calls in a row are bit-equal (the
    ticket counters are back at zero after each launch)."""
    rng = np.random.default_rng(40 + ps)
    H, KV, HD, cap = 32, 8, 128, 1024
    maxp = cap // ps
    P = 4 * maxp + 1
    (kp, vp), (ks, vs) = _split_pool(rng, cuda_device, pool, 2 * P, ps, KV,
                                     HD)
    qdt = torch.float32 if pool == "f32" else torch.bfloat16
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    edge = tk.split_plan(4, KV, cap, n_sm).tiles * tk.SPLIT_TILE
    cases = (
        (1, [1, edge, cap, cap + 37], [1, 1, 1, 1]),
        (8, [edge + 4, cap, 40, 9], [8, 3, 0, 1]),
        (1, [cap - 1], [1]),
    )
    for Qb, lens, qnum in cases:
        R = len(lens)
        plan = tk.split_plan(R, KV, cap, n_sm)
        assert plan.splits > 1
        q = _t(_rand(rng, (R, Qb, H, HD))).to(cuda_device, qdt)
        tables = torch.tensor(rng.permutation(np.arange(1, P))[:R * maxp]
                              .reshape(R, maxp), dtype=torch.int32,
                              device=cuda_device)
        kv_lens = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
        qn = torch.tensor(qnum, dtype=torch.int32, device=cuda_device)
        pos0 = kv_lens - qn.clamp_min(1)
        tk.reset_launch_counts()
        got = tk.ragged_paged_attention(q, kp, vp, tables, kv_lens, pos0, qn,
                                        layer=1, pages_per_layer=P,
                                        k_scales=ks, v_scales=vs)
        again = tk.ragged_paged_attention(q, kp, vp, tables, kv_lens, pos0,
                                          qn, layer=1, pages_per_layer=P,
                                          k_scales=ks, v_scales=vs)
        key = ("ragged_paged_attention_int8" if pool == "int8"
               else "ragged_paged_attention")
        assert tk.launch_counts()[key] == 2
        assert torch.equal(got, again)
        want = tk.ragged_paged_attention_plain(
            q, kp, vp, tables, kv_lens.clamp_max(cap), pos0, qn, 1, P, ks, vs)
        assert torch.isfinite(got).all()
        for r, n in enumerate(qnum):
            if n == 0:
                assert (got[r] == 0).all()
            elif qdt == torch.float32:
                assert (got[r, :n] - want[r, :n]).abs().max().item() < 1e-4
            else:
                assert _within_one_ulp(got[r, :n], want[r, :n])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_split_walk_ragged_decode_matches_plain_on_the_card(cuda_device, dt):
    """ragged_decode's split walk over one layer of a dense cache: lengths
    of 1, at the first split's end, at T and past T; and one slot alone.
    Two calls in a row are bit-equal."""
    rng = np.random.default_rng(44)
    L, T, H, KV, HD = 2, 1024, 32, 8, 128
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for lengths in ([1, tk.split_plan(4, KV, T, n_sm).tiles * tk.SPLIT_TILE,
                     T, T + 1], [T - 1]):
        B = len(lengths)
        assert tk.split_plan(B, KV, T, n_sm).splits > 1
        k, v = (_t(_rand(rng, (L, B, T, KV, HD))).to(cuda_device, dt)
                for _ in range(2))
        q = _t(_rand(rng, (B, 1, H, HD))).to(cuda_device, dt)
        lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
        got = tk.ragged_decode(q, k[1], v[1], lens)
        assert torch.equal(got, tk.ragged_decode(q, k[1], v[1], lens))
        want = mha_decode(q, k[1], v[1], lens)
        if dt == torch.float32:
            assert (got - want).abs().max().item() < 1e-4
        else:
            assert _within_one_ulp(got, want)


# cache-hit suffixes riding a mixed dispatch: (start, tokens) at
# page-aligned starts that are not multiples of the 512-token chunk, each
# padded to the chunk as the engine packs it
PREFIX_CHUNKS = ((1152, 64), (1280, 200), (1408, 120), (1152, 160))


def _verify_and_mixed_rows(case, cap):
    """(Qb, kv_lens, q_pos0, q_num, slot of each row) of the serving shapes:
    8 verify rows of W = 5 or 9 live queries, and the mixed program's rows
    at q_block 16 (8 decode rows of 9 queries, then ``mixed_qb16``: a
    chunk of 256 at 0 and a partial one of 200 at 512; ``mixed_prefix``:
    the cache-hit suffixes of ``PREFIX_CHUNKS`` in rows of 512; a chunk's
    last rows are idle with kv_len 0)."""
    dec = [9, 40, 200, 511, 640, 900, cap - 3, cap]
    if case.startswith("verify"):
        W = int(case[len("verify_qb"):])
        lens = [max(n, W) for n in dec]
        return W, lens, [n - W for n in lens], [W] * 8, list(range(8))
    lens = [max(n, 9) for n in dec]
    pos0, qnum, slots = [n - 9 for n in lens], [9] * 8, list(range(8))
    chunks, padded = ((((0, 256), (512, 200)), 256) if case == "mixed_qb16"
                      else (PREFIX_CHUNKS, 512))
    for slot, (start, n) in enumerate(chunks, start=8):
        for j in range(padded // 16):
            live = min(16, max(0, n - 16 * j))
            lens.append(start + n if live else 0)
            pos0.append(start + 16 * j)
            qnum.append(live)
            slots.append(slot)
    return 16, lens, pos0, qnum, slots


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["verify_qb5", "verify_qb9", "mixed_qb16",
                                  "mixed_prefix"])
@pytest.mark.parametrize("pool", ["bf16", "f32", "int8"])
def test_ragged_paged_verify_and_mixed_rows_on_the_card(cuda_device, pool,
                                                         case):
    """The ragged kernel's multi-query instances that speculative decoding
    (Qb = 5, 9: the QGB = 32 and 64 instances at G = 4) and the mixed
    program (Qb = 16, QG = 64) run, at llama3-8b heads over pages of 128,
    with the mixed chunks at chunk-aligned starts and as cache-hit
    suffixes: each live (query, head) against the plain version, idle
    rows zero."""
    _check_verify_and_mixed_rows(cuda_device, pool, case, H=32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["verify_qb9", "mixed_qb16"])
@pytest.mark.parametrize("pool", ["bf16", "f32", "int8"])
def test_ragged_paged_group8_query_tiles_on_the_card(cuda_device, pool,
                                                     case):
    """llama3-70b's heads (64 q, 8 KV, G = 8): a verify row of 9 queries
    holds 72 query vectors and a mixed row of 16 holds 128, past the 64 a
    block takes, so each row runs as two query tiles over the same KV
    walk; every live (query, head) against the plain version, idle rows
    zero, and two calls in a row bit-equal (each tile's tickets back at
    zero)."""
    _check_verify_and_mixed_rows(cuda_device, pool, case, H=64)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["verify_qb5", "verify_qb9", "mixed_qb16"])
@pytest.mark.parametrize("pool", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("heads", [(16, 16), (8, 1)], ids=["G1", "G8"])
def test_ragged_paged_head_dim_256_on_the_card(cuda_device, heads, pool,
                                               case):
    """Gemma's heads of 256: gemma-7b's (16 q, 16 KV, G = 1) rows fit one
    block; gemma-2b's (8 q, 1 KV, G = 8) verify rows of 5 and 9 and mixed
    rows of 16 hold 40, 72 and 128 query vectors, past the 32 a block
    takes at head_dim 256, so they run as query tiles of 4."""
    H, KV = heads
    _check_verify_and_mixed_rows(cuda_device, pool, case, H, KV=KV, HD=256)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("heads", [(16, 16), (8, 1)], ids=["G1", "G8"])
def test_ragged_decode_head_dim_256_on_the_card(cuda_device, heads, dt):
    """``ragged_decode`` at Gemma's heads over one layer of a dense cache:
    ragged lengths, a full slot and one past the cache; bf16 per (row,
    head) within one bf16 ulp, f32 within 1e-4."""
    H, KV = heads
    rng = np.random.default_rng(26 + H)
    L, B, T, HD = 2, 4, 640, 256
    k, v = (_t(_rand(rng, (L, B, T, KV, HD))).to(cuda_device, dt)
            for _ in range(2))
    q = _t(_rand(rng, (B, 1, H, HD))).to(cuda_device, dt)
    lens = torch.tensor([1, 200, T, T + 1], dtype=torch.int32,
                        device=cuda_device)
    tk.reset_launch_counts()
    got = tk.ragged_decode(q, k[1], v[1], lens)
    assert tk.launch_counts()["ragged_decode"] == 1
    want = mha_decode(q, k[1], v[1], lens)
    if dt == torch.float32:
        assert (got - want).abs().max().item() < 1e-4
    else:
        assert _within_one_ulp(got, want)


def _check_verify_and_mixed_rows(cuda_device, pool, case, H, KV=8, HD=128):
    rng = np.random.default_rng(70 + len(case) + (0 if H == 32 else 1000)
                                + (0 if HD == 128 else HD))
    ps = 128
    cap = 2048 if case == "mixed_prefix" else 1024
    maxp = cap // ps
    Qb, lens, pos0, qnum, slots = _verify_and_mixed_rows(case, cap)
    n_slots = max(slots) + 1
    P = n_slots * maxp + 1
    (kp, vp), (ks, vs) = _split_pool(rng, cuda_device, pool, 2 * P, ps, KV,
                                     HD)
    qdt = torch.float32 if pool == "f32" else torch.bfloat16
    R = len(lens)
    q = _t(_rand(rng, (R, Qb, H, HD))).to(cuda_device, qdt)
    slot_tables = rng.permutation(np.arange(1, P))[:n_slots * maxp]
    tables = torch.tensor(slot_tables.reshape(n_slots, maxp)[slots],
                          dtype=torch.int32, device=cuda_device)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=cuda_device)
    args = (tables, i32(lens), i32(pos0), i32(qnum))
    tk.reset_launch_counts()
    got = tk.ragged_paged_attention(q, kp, vp, *args, layer=1,
                                    pages_per_layer=P, k_scales=ks,
                                    v_scales=vs)
    key = ("ragged_paged_attention_int8" if pool == "int8"
           else "ragged_paged_attention")
    assert tk.launch_counts()[key] == 1
    want = tk.ragged_paged_attention_plain(q, kp, vp, *args, 1, P, ks, vs)
    assert torch.isfinite(got).all()
    if Qb * H // KV > tk.qg_max(HD):
        assert torch.equal(got, tk.ragged_paged_attention(
            q, kp, vp, *args, layer=1, pages_per_layer=P, k_scales=ks,
            v_scales=vs))
    for r, n in enumerate(qnum):
        if n == 0:
            assert (got[r] == 0).all()
        elif qdt == torch.float32:
            assert (got[r, :n] - want[r, :n]).abs().max().item() < 1e-4
        else:
            assert _within_one_ulp(got[r, :n], want[r, :n]), r


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_engine_spec_and_mixed_kernel_path_matches_plain_on_the_card(
        cuda_device, kv_quant):
    """The default engine on the card (speculation on, the mixed dispatch
    "auto", so on): a prompt arriving while another decodes rides the
    decode dispatch; the kernel path's greedy streams equal the plain
    path's (tiny model, f32), over both pools."""
    from generativeaiexamples_tpu_torch.core.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.engine import EngineCore
    from generativeaiexamples_tpu_torch.engine.scheduler import (
        Request, Scheduler)
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny(vocab_size=300)
    params = llama.init_params(
        torch.Generator(device=cuda_device).manual_seed(5), cfg)
    tok = ByteTokenizer()
    quote = ("the retrieved context says: alpha beta gamma delta. " * 2
             + "question: repeat the context. answer: the retrieved")
    prompts = [tok.encode("hello", add_bos=True),
               tok.encode(quote[:110], add_bos=True)]
    streams = {}
    for attn in ("kernel", "plain"):
        # no prefill hold, so the arriving prompt rides a decode dispatch
        core = EngineCore(cfg, EngineConfig(
            max_batch_size=4, max_seq_len=256, prefill_chunk=16, page_size=8,
            attention=attn, kv_quant=kv_quant, prefill_hold_chunks=0),
            params, tok.eos_id, device=cuda_device)
        assert core.mixed_supported and core.spec_widths == (2, 3, 5, 9)
        sched = Scheduler(core, tok)
        tk.reset_launch_counts()
        reqs = [Request(prompt_ids=prompts[0], max_tokens=40,
                        temperature=0.0),
                Request(prompt_ids=prompts[1], max_tokens=24,
                        temperature=0.0)]
        sched.submit(reqs[0])
        sched._tick()
        sched.submit(reqs[1])
        while sched._tick():
            pass
        assert all(r.error is None for r in reqs)
        assert sched.stats["mixed_dispatches"] > 0
        assert sched.stats["spec_steps"] > 0
        streams[attn] = [r.output_ids for r in reqs]
        if attn == "kernel":
            key = ("ragged_paged_attention_int8" if kv_quant == "int8"
                   else "ragged_paged_attention")
            assert tk.launch_counts()[key] > 0
    assert streams["kernel"] == streams["plain"]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_engine_prefix_cache_kernel_path_matches_plain_on_the_card(
        cuda_device, kv_quant):
    """The default engine with the prefix cache (tiny model, f32): a prompt
    alone, then, while it decodes, its repeat and a prompt sharing its
    context (cache hits riding mixed dispatches); the kernel path's greedy
    streams and hit tokens equal the plain path's, over both pools."""
    from generativeaiexamples_tpu_torch.core.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.engine import EngineCore
    from generativeaiexamples_tpu_torch.engine.scheduler import (
        Request, Scheduler)
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny(vocab_size=300)
    params = llama.init_params(
        torch.Generator(device=cuda_device).manual_seed(5), cfg)
    tok = ByteTokenizer()
    context = "the shared context of every request, " * 3
    prompts = [tok.encode(context + q, add_bos=True)
               for q in ("first?", "first?", "second one?")]
    runs = {}
    for attn in ("kernel", "plain"):
        core = EngineCore(cfg, EngineConfig(
            max_batch_size=4, max_seq_len=256, prefill_chunk=16, page_size=8,
            attention=attn, kv_quant=kv_quant, prefill_hold_chunks=0),
            params, tok.eos_id, device=cuda_device)
        sched = Scheduler(core, tok)
        reqs = [Request(prompt_ids=p, max_tokens=64 if i == 0 else 24,
                        temperature=0.0) for i, p in enumerate(prompts)]
        sched.submit(reqs[0])
        while not reqs[0].first_token_at:
            sched._tick()
        for r in reqs[1:]:
            sched.submit(r)
        while sched._tick():
            pass
        assert all(r.error is None for r in reqs)
        assert sched.stats["mixed_dispatches"] > 0
        runs[attn] = ([r.output_ids for r in reqs],
                      [r.prefix_hit_tokens for r in reqs])
    assert runs["kernel"] == runs["plain"]
    assert min(runs["kernel"][1][1:]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_engine_group8_int8_weights_kernel_path_matches_plain(
        cuda_device, kv_quant, monkeypatch):
    """A tiny model with llama3-70b's GQA group of 8 (16 q over 2 KV heads,
    f32) and int8 weights under the default engine on the card: the ladder
    of widths up to 9 (72 query vectors a row) is not refused and the
    mixed dispatch resolves on (q_block 16, 128 vectors); its greedy
    streams through the ragged kernel's query tiles and the W8A16 kernel
    equal the plain path's (plain attention, the GEMM's plain version)."""
    import dataclasses
    from generativeaiexamples_tpu_torch.core.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.engine import EngineCore
    from generativeaiexamples_tpu_torch.engine.scheduler import (
        Request, Scheduler)
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops.cuda import quant as cq

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=300),
                              n_heads=16, n_kv_heads=2)
    tok = ByteTokenizer()
    quote = ("the retrieved context says: alpha beta gamma delta. " * 2
             + "question: repeat the context. answer: the retrieved")
    prompts = [tok.encode("hello", add_bos=True),
               tok.encode(quote[:110], add_bos=True)]
    streams = {}
    for attn in ("kernel", "plain"):
        if attn == "plain":
            monkeypatch.setattr(cq, "w8a16_gemm", cq.w8a16_gemm_plain)
        params = llama.init_params(
            torch.Generator(device=cuda_device).manual_seed(7), cfg,
            quant="int8")
        core = EngineCore(cfg, EngineConfig(
            max_batch_size=4, max_seq_len=256, prefill_chunk=16, page_size=8,
            attention=attn, kv_quant=kv_quant, quant="int8",
            prefill_hold_chunks=0), params, tok.eos_id, device=cuda_device)
        assert core.mixed_supported and core.spec_widths == (2, 3, 5, 9)
        sched = Scheduler(core, tok)
        tk.reset_launch_counts()
        reqs = [Request(prompt_ids=prompts[0], max_tokens=40,
                        temperature=0.0),
                Request(prompt_ids=prompts[1], max_tokens=24,
                        temperature=0.0)]
        sched.submit(reqs[0])
        sched._tick()
        sched.submit(reqs[1])
        while sched._tick():
            pass
        assert all(r.error is None for r in reqs)
        assert sched.stats["mixed_dispatches"] > 0
        assert sched.stats["spec_steps"] > 0
        streams[attn] = [r.output_ids for r in reqs]
        launches = tk.launch_counts()
        assert (launches["w8a16_gemm"] > 0) == (attn == "kernel")
    assert streams["kernel"] == streams["plain"]


# the W8A16 GEMM's (N, K) weight shapes: llama3-8b's wq/wo, wk/wv,
# gate/up, down and lm_head, then llama3-70b's
GEMM_SHAPES = ((4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336),
               (128256, 4096), (8192, 8192), (1024, 8192), (28672, 8192),
               (8192, 28672), (128256, 8192))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("M", [1, 8, 9, 72, 73, 136, 4096])
@pytest.mark.parametrize("N,K", GEMM_SHAPES)
def test_w8a16_gemm_matches_plain_on_the_card(cuda_device, N, K, M, dtype):
    """The W8A16 GEMM against its plain version at every weight shape of
    llama3-8b and llama3-70b, decode to prefill rows (9, 73: a decode
    tile's rows past M; 136: the smallest prefill tile count), within
    ``chip_smoke.check_gemm``'s limit (bf16: one ulp of the unscaled
    product times s plus one of the result; f32: two f32 ulps; both plus
    2**-16 of |x| @ |q|^T times s for the summation order). Two calls are
    bit-equal (the cluster adds its partials in rank order); each call is
    one launch."""
    from generativeaiexamples_tpu_torch.ops.cuda import quant as cq
    cs = _smoke()
    x, q, s = cs.gemm_inputs(cuda_device, M, N, K, getattr(torch, dtype),
                             seed=N + K + M)
    tk.reset_launch_counts()
    got = cq.w8a16_gemm(x, q, s)
    assert torch.equal(got, cq.w8a16_gemm(x, q, s))
    assert tk.launch_counts()["w8a16_gemm"] == 2
    reading = cs.check_gemm("w8a16_gemm", x, q, s, got)
    assert reading["max_err_over_limit"] <= 1.0


@pytest.mark.cuda
def test_w8a16_gemm_refuses_what_it_cannot_take(cuda_device):
    from generativeaiexamples_tpu_torch.ops.cuda import quant as cq
    x = torch.zeros((4, 40), dtype=torch.bfloat16, device=cuda_device)
    q = torch.zeros((8, 40), dtype=torch.int8, device=cuda_device)
    s = torch.ones((8,), dtype=torch.float32, device=cuda_device)
    assert not cq.w8a16_supported(40, torch.bfloat16)
    with pytest.raises(ValueError, match="K=40"):
        cq.w8a16_gemm(x, q, s)
    with pytest.raises(ValueError):
        cq.w8a16_gemm(x.half(), q, s)
    # f32 takes any K
    assert cq.w8a16_supported(40, torch.float32)
    got = cq.w8a16_gemm(x.float() + 1, q + 1, s)
    assert torch.equal(got, torch.full((4, 8), 40.0, device=cuda_device))


def _smoke():
    """chip_smoke.py, whose ``check_sampler`` holds the sampling kernel to
    its plain version."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("V", [256_000, 128_256, 32_000, 1_000])
@pytest.mark.parametrize("R", [1, 8, 72, 136])
def test_sample_slots_matches_plain_on_the_card(cuda_device, R, V, dtype):
    """One launch a sampling call, at the engine's row counts (a slot, 8
    slots narrow, W = 9, the mixed dispatch's 136) and vocabularies, with
    the degenerate rows of ``chip_smoke.sampler_inputs`` (-inf entries, a
    span past 100 nats, a row of -inf, a -0.0 / +0.0 maximum, top-p 0,
    top-k past V, inactive slots): thr_k bit-equal, thr_p and tokens equal
    off the counted near-ties, logprobs within 1e-5, threefry bits exact,
    the debug cutoff entry not counted."""
    cs = _smoke()
    B = 1 if R == 1 else 8
    args = cs.sampler_inputs(cuda_device, B, R // B, V,
                             getattr(torch, dtype), R + V % 97)
    tk.reset_launch_counts()
    reading, _ = cs.check_sampler(args)
    torch.cuda.synchronize()
    assert tk.launch_counts()["sample_slots"] == 1
    assert reading["rows"] == R and reading["bits_exact"]


@pytest.mark.cuda
def test_threefry_bits_of_the_kernel_library_on_the_card(cuda_device):
    from generativeaiexamples_tpu_torch.ops import threefry
    from generativeaiexamples_tpu_torch.ops.cuda import sampling as ks
    keys = threefry.fold_in(threefry.prng_key(torch.arange(8)),
                            torch.arange(8) * 3)
    got = ks.threefry_bits(keys.to(cuda_device), 4099).cpu()
    assert torch.equal(got, threefry.random_bits(keys, 4099))


@pytest.mark.cuda
def test_engine_sampled_streams_kernel_sampler_match_plain(cuda_device,
                                                          monkeypatch):
    """Seeded sampled requests (temperature, top-k, top-p, the chain
    server's 0.2 / 0.7) through the Scheduler at the defaults, f32: the
    sampling kernel and its plain version give the same tokens."""
    from generativeaiexamples_tpu_torch.core.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.engine import EngineCore
    from generativeaiexamples_tpu_torch.engine.scheduler import (
        Request, Scheduler)
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops import sampling

    cfg = llama.LlamaConfig.tiny(vocab_size=300)
    params = llama.init_params(
        torch.Generator(device=cuda_device).manual_seed(5), cfg)
    tok = ByteTokenizer()
    streams = {}
    for sampler in ("kernel", "plain"):
        if sampler == "plain":
            monkeypatch.setattr(sampling, "sample_slots",
                                sampling.sample_slots_plain)
        sched = Scheduler(EngineCore(cfg, EngineConfig(
            max_batch_size=4, max_seq_len=256, prefill_chunk=16,
            page_size=8), params, tok.eos_id, device=cuda_device), tok)
        tk.reset_launch_counts()
        reqs = [Request(prompt_ids=tok.encode(p, add_bos=True),
                        max_tokens=32, temperature=0.7, top_k=k, top_p=p_,
                        seed=s)
                for s, (p, k, p_) in enumerate((("hello", 0, 1.0),
                                                ("a sampled prompt", 20, 1.0),
                                                ("another one", 0, 0.9)))]
        reqs.append(Request(prompt_ids=tok.encode("the chain", add_bos=True),
                            max_tokens=32, temperature=0.2, top_p=0.7,
                            seed=7))
        for r in reqs:
            sched.submit(r)
        while sched._tick():
            pass
        assert all(r.error is None and r.finished_at for r in reqs)
        streams[sampler] = [r.output_ids for r in reqs]
        launched = tk.launch_counts()["sample_slots"]
        assert launched == (sched.core.sample_calls
                            if sampler == "kernel" else 0)
    assert streams["kernel"] == streams["plain"]


def _grammar_inputs(rng, dev, R, V, S=40):
    """A random byte DFA (30% rejecting transitions), a byte table in the
    kernel's layout (uint8 bytes, int8 lengths -1..5) and R rows, a third
    of them unconstrained (states -1 and 0); state 7 is a dead end that
    does not accept, so a row there takes the fail-safe EOS."""
    from generativeaiexamples_tpu_torch.ops import sampling
    table = rng.integers(0, S, (S, 256)).astype(np.int32)
    table[rng.random((S, 256)) < 0.3] = 0
    table[0] = 0
    table[7] = 0
    accept = rng.random(S) < 0.3
    accept[7] = False
    dist = rng.integers(0, 6, S).astype(np.int32)
    tb, tl = sampling.mask_byte_table(
        rng.integers(0, 256, (V, 16)).astype(np.int32),
        rng.integers(-1, 6, V).astype(np.int32))
    state = rng.integers(1, S, R).astype(np.int32)
    state[::3] = np.where(np.arange(R)[::3] % 2, -1, 0)
    up = lambda a: torch.as_tensor(a).to(dev)
    return [up(state), up(rng.integers(0, 8, R).astype(np.int32)),
            int(rng.integers(0, V)), up(table), up(accept), up(dist),
            tb.to(dev), tl.to(dev)]


def _check_mask_launch(kg, sampling, args):
    """Zero the kernel's output buffer, launch, and hold the constrained
    rows to the packed plain set bit for bit; the unconstrained rows must
    stay zero (never written)."""
    state = args[0]
    R, V = state.shape[0], args[6].shape[0]
    kg.buffers(state.device, R, V)[0].zero_()
    got = kg.grammar_mask(*args).clone()
    want = sampling.pack_mask(sampling.grammar_mask_plain(*args))
    con = state > 0
    assert torch.equal(got[con], want[con])
    assert (got[~con] == 0).all()
    return want


@pytest.mark.cuda
def test_grammar_mask_matches_plain_on_the_card(cuda_device):
    """The grammar mask at a small vocabulary (1,000 entries: a partial
    last word) over 20 rows: the output filled with zeros before each
    launch, constrained rows bit-equal to the plain set, unconstrained
    rows never written; a fail-safe row (a dead-end state) gets EOS; two
    launches in a row on the same buffers, the second's fail-safe row
    allowed entries in the first (the flags reset between calls); then
    300 rows, past one staging chunk of 256, on buffers grown for them.
    One launch counted a call."""
    from generativeaiexamples_tpu_torch.ops import sampling
    from generativeaiexamples_tpu_torch.ops.cuda import grammar as kg
    rng = np.random.default_rng(13)
    args = _grammar_inputs(rng, cuda_device, 20, 1000)
    eos = args[2]
    args[0][1], args[1][1] = 7, 5           # the fail-safe row
    tk.reset_launch_counts()
    want = _check_mask_launch(kg, sampling, args)
    allowed = sampling.unpack_mask(want, 1000)
    assert allowed[1].sum() == 1 and allowed[1, eos]
    # the second launch: row 1 first at a state with entries allowed
    first = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    first[0][1], first[1][1] = 1, 7
    ok_first = sampling.unpack_mask(
        _check_mask_launch(kg, sampling, first), 1000)
    assert ok_first[1].sum() > 1
    _check_mask_launch(kg, sampling, args)
    big = _grammar_inputs(rng, cuda_device, 300, 1000)
    _check_mask_launch(kg, sampling, big)
    torch.cuda.synchronize()
    assert tk.launch_counts()["grammar_mask"] == 4


@pytest.mark.cuda
def test_grammar_mask_refuses_what_it_cannot_take(cuda_device):
    from generativeaiexamples_tpu_torch.ops.cuda import grammar as kg
    args = _grammar_inputs(np.random.default_rng(3), cuda_device, 8, 100)
    for i, bad in ((6, args[6].to(torch.int32)), (7, args[7].to(torch.int32)),
                   (0, args[0].cpu())):
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises(ValueError):
            kg.grammar_mask(*wrong)


@pytest.mark.cuda
def test_engine_grammared_greedy_streams_kernels_match_plain(cuda_device,
                                                             monkeypatch):
    """Greedy grammared requests (``json_value()`` and a schema) beside a
    free one through the Scheduler at the defaults, f32: the grammar mask
    and sampling kernels and their plain versions give the same streams,
    and every reply parses."""
    import json
    from generativeaiexamples_tpu_torch.core.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.engine import EngineCore
    from generativeaiexamples_tpu_torch.engine.grammar import Grammar
    from generativeaiexamples_tpu_torch.engine.scheduler import (
        Request, Scheduler)
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops import sampling

    cfg = llama.LlamaConfig.tiny(vocab_size=300)
    params = llama.init_params(
        torch.Generator(device=cuda_device).manual_seed(5), cfg)
    tok = ByteTokenizer()
    schema = {"type": "object", "properties": {
        "a": {"type": "integer"}, "b": {"type": "string", "maxLength": 6}},
        "required": ["a", "b"]}
    streams = {}
    for path in ("kernel", "plain"):
        if path == "plain":
            monkeypatch.setattr(sampling.kernels, "sample_slots",
                                sampling.sample_slots_plain)
            monkeypatch.setattr(
                sampling.grammar_kernels, "grammar_mask",
                lambda *a: sampling.pack_mask(sampling.grammar_mask_plain(*a)))
        sched = Scheduler(EngineCore(cfg, EngineConfig(
            max_batch_size=4, max_seq_len=256, prefill_chunk=16,
            page_size=8), params, tok.eos_id, device=cuda_device), tok)
        tk.reset_launch_counts()
        reqs = [Request(prompt_ids=tok.encode(p, add_bos=True),
                        max_tokens=n, temperature=0.0, grammar=g)
                for p, n, g in (("free text", 24, None),
                                ("emit json:", 32, Grammar.json_value()),
                                ("the schema:", 40,
                                 Grammar.from_schema(schema)))]
        for r in reqs:
            sched.submit(r)
        while sched._tick():
            pass
        assert all(r.error is None and r.finished_at for r in reqs)
        for r in reqs[1:]:
            json.loads(tok.decode(r.output_ids))
        streams[path] = [r.output_ids for r in reqs]
        launched = tk.launch_counts()["grammar_mask"]
        assert (launched > 0) if path == "kernel" else launched == 0
    assert streams["kernel"] == streams["plain"]


# the LoRA update's (K, O) shapes: llama3-8b's wq/wo, wk/wv, gate/up, down
LORA_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))


@pytest.mark.cuda
@pytest.mark.parametrize("mix", ["mixed", "one", "base", "global"])
@pytest.mark.parametrize("R,S", [(8, 1), (72, 9), (1024, 128)])
@pytest.mark.parametrize("K,O", LORA_SHAPES)
def test_lora_apply_matches_plain_on_the_card(cuda_device, K, O, R, S, mix):
    """The LoRA update at llama3-8b's projection shapes, decode to
    prefill rows, rank 16 (and 8 and 64 beside it), slots mixed with base
    rows, one adapter, all base and a global adapter: within
    ``chip_smoke.LORA_TOLERANCE`` of the plain version, rows of slot 0 bit
    for bit the input though slot 0 holds random values; one launch a
    call; two calls bit-equal."""
    from generativeaiexamples_tpu_torch.ops.cuda import lora as cl
    cs = _smoke()
    for r in (16, 8, 64) if (K, R) == (4096, 8) else (16,):
        y, x, a, b, slots = cs.lora_inputs(cuda_device, K, O, r, R, S, mix,
                                           torch.bfloat16, K + O + R)
        tk.reset_launch_counts()
        got = cl.lora_apply(y.clone(), x, a, b, slots)
        assert torch.equal(got, cl.lora_apply(y.clone(), x, a, b, slots))
        assert tk.launch_counts()["lora"] == 2
        reading = cs.check_lora("lora", y, x, a, b, slots, got)
        assert reading["base_rows_bit_equal"]


# the groups of targets that share an input, (K, (O of each target))
LORA_GROUPS = ((4096, (4096, 1024, 1024)), (4096, (14336, 14336)))


@pytest.mark.cuda
@pytest.mark.parametrize("mix", ["mixed", "one", "base", "global"])
@pytest.mark.parametrize("R,S", [(8, 1), (72, 9), (1024, 128)])
@pytest.mark.parametrize("K,Os", LORA_GROUPS)
def test_lora_apply_group_matches_plain_on_the_card(cuda_device, K, Os, R,
                                                    S, mix):
    """One call for the targets that share an input (wq|wk|wv, gate|up)
    at llama3-8b's serving shapes, rank 16 (and 8 and 64 at a narrow
    step): each target within ``chip_smoke.LORA_TOLERANCE`` of the plain
    version, rows of slot 0 bit for bit the input; one launch a call; two
    calls bit-identical (the split-K partials are added in a fixed
    order)."""
    from generativeaiexamples_tpu_torch.ops.cuda import lora as cl
    cs = _smoke()
    for r in (16, 8, 64) if R == 8 else (16,):
        ys, x, a, b, slots = cs.lora_group_inputs(
            cuda_device, K, Os, r, R, S, mix, torch.bfloat16, K + R + r)
        group = cl.ResidentGroup(a, b)
        tk.reset_launch_counts()
        got = cl.lora_apply_group([y.clone() for y in ys], x, group, slots)
        again = cl.lora_apply_group([y.clone() for y in ys], x, group, slots)
        assert tk.launch_counts()["lora"] == 2
        assert all(torch.equal(g, h) for g, h in zip(got, again))
        reading = cs.check_lora_group("lora", ys, x, a, b, slots, got)
        assert reading["base_rows_bit_equal"]


@pytest.mark.cuda
def test_lora_apply_f32_matches_plain_on_the_card(cuda_device):
    from generativeaiexamples_tpu_torch.ops.cuda import lora as cl
    cs = _smoke()
    for r, mix in ((16, "mixed"), (4, "mixed"), (12, "global")):
        y, x, a, b, slots = cs.lora_inputs(cuda_device, 4096, 1024, r, 72, 9,
                                           mix, torch.float32, r)
        got = cl.lora_apply(y.clone(), x, a, b, slots)
        cs.check_lora("lora", y, x, a, b, slots, got)
    # the grouped call of the f32 instance
    ys, x, a, b, slots = cs.lora_group_inputs(
        cuda_device, 4096, (4096, 1024, 1024), 16, 8, 1, "mixed",
        torch.float32, 5)
    got = cl.lora_apply_group([y.clone() for y in ys], x,
                              cl.ResidentGroup(a, b), slots)
    cs.check_lora_group("lora", ys, x, a, b, slots, got)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["rank", "dtype", "device", "contiguity",
                                  "slots", "layout", "depth"])
def test_lora_apply_refuses_what_it_cannot_take(cuda_device, what):
    from generativeaiexamples_tpu_torch.ops.cuda import lora as cl
    cs = _smoke()
    y, x, a, b, slots = cs.lora_inputs(cuda_device, 64, 32, 8, 8, 2, "mixed",
                                       torch.bfloat16, 0)
    bad = {
        "rank": (y, x, a[:, :4].contiguous(), b[:, :, :4].contiguous(),
                 slots),
        "dtype": (y.half(), x.half(), a.half(), b.half(), slots),
        "device": (y.cpu(), x.cpu(), a.cpu(), b.cpu(), slots.cpu()),
        "contiguity": (y, x.transpose(1, 2).contiguous().transpose(1, 2), a,
                       b, slots),
        "slots": (y, x, a, b, slots.long()),
        "layout": (y, x, a, b, None),
        "depth": (y, x[..., :60].contiguous(), a[..., :60].contiguous(), b,
                  slots),
    }
    with pytest.raises(ValueError):
        cl.lora_apply(*bad[what])
    tk.reset_launch_counts()
    cl.lora_apply(y, x, a, b, slots)
    assert tk.launch_counts()["lora"] == 1


@pytest.mark.cuda
def test_engine_lora_streams_kernel_match_plain(cuda_device, monkeypatch):
    """Two adapters (rank 8) registered on the tiny model, f32: a mixed
    batch's greedy and seeded streams through ``lora_apply_group`` equal
    those through the plain version, and the kernel launches once a group
    of targets that share an input (wq|wk|wv, wo) and a layer in each
    forward pass with an adapter row; a rank the kernel does not take is
    refused at registration, naming the ranks it takes."""
    from generativeaiexamples_tpu_torch.core.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.engine import EngineCore
    from generativeaiexamples_tpu_torch.engine.scheduler import (
        Request, Scheduler)
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops.cuda import lora as cl
    from generativeaiexamples_tpu_torch.train import lora

    cs = _smoke()
    cfg = llama.LlamaConfig.tiny(vocab_size=300)
    params = llama.init_params(
        torch.Generator(device=cuda_device).manual_seed(5), cfg)
    tok = ByteTokenizer()

    def tree(seed, rank=8):
        g = torch.Generator(device=cuda_device).manual_seed(seed)
        t = lora.init_adapters(g, cfg, lora.LoraConfig(rank=rank),
                               device=cuda_device)
        for ab in t.values():
            ab["b"] = torch.randn(ab["b"].shape, generator=g,
                                  device=cuda_device) * 0.5
        return t

    streams = {}
    for path in ("kernel", "plain"):
        if path == "plain":
            monkeypatch.setattr(cl, "lora_apply_group",
                                cs.lora_apply_group_plain_resident)
        core = EngineCore(cfg, EngineConfig(
            max_batch_size=4, max_seq_len=256, prefill_chunk=16,
            page_size=8), params, tok.eos_id, device=cuda_device)
        with pytest.raises(ValueError, match="ranks"):
            core.register_adapter("rank6", tree(9, rank=6))
        core.register_adapter("a", tree(1))
        core.register_adapter("b", tree(2))
        assert not core.mixed_supported
        sched = Scheduler(core, tok)
        tk.reset_launch_counts()
        reqs = [Request(prompt_ids=tok.encode("route this prompt",
                                              add_bos=True),
                        max_tokens=24, temperature=t, seed=i, adapter=ad)
                for i, (ad, t) in enumerate((("", 0.0), ("a", 0.0),
                                             ("b", 0.0), ("a", 0.7)))]
        for r in reqs:
            sched.submit(r)
        while sched._tick():
            pass
        assert all(r.error is None for r in reqs)
        streams[path] = [r.output_ids for r in reqs]
        launched = tk.launch_counts()["lora"]
        assert core.lora_groups == 2 and core.lora_passes > 0
        assert launched == (2 * cfg.n_layers * core.lora_passes
                            if path == "kernel" else 0)
    assert streams["kernel"] == streams["plain"]
    assert streams["kernel"][0] != streams["kernel"][1]


# ---------------------------------------------------------------------------
# KV movement on the card: the device-native handoff, its frame, and the
# spill through pinned host tensors (tiny model, f32, seeded weights)
# ---------------------------------------------------------------------------

_KV_GEOMETRY = dict(max_batch_size=4, max_seq_len=128, prefill_chunk=16,
                    page_size=16, prefill_hold_chunks=0, spec_decode="off",
                    mixed_phase_dispatch="off")


def _kv_sched(dev, role="unified", kv_quant="none", **kw):
    from generativeaiexamples_tpu_torch.core.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.engine import EngineCore
    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny(vocab_size=300)
    params = llama.init_params(torch.Generator(device=dev).manual_seed(5),
                               cfg)
    tok = ByteTokenizer()
    ecfg = EngineConfig(role=role, kv_quant=kv_quant,
                        **{**_KV_GEOMETRY, **kw})
    return Scheduler(EngineCore(cfg, ecfg, params, tok.eos_id, device=dev),
                     tok)


def _tick_all(sched, reqs, submit=True):
    if submit:
        for r in reqs:
            sched.submit(r)
    for _ in range(6000):
        sched._tick()
        if all(r.finished_at is not None for r in reqs):
            assert all(r.error is None for r in reqs), \
                [r.error for r in reqs]
            return reqs
    raise AssertionError("requests did not finish within the tick budget")


def _prefilled(dev, kv_quant, prompt, kw):
    """A prefill-role scheduler's device-native export of ``prompt``."""
    from generativeaiexamples_tpu_torch.engine.scheduler import Request

    pre = _kv_sched(dev, "prefill", kv_quant)
    rp = _tick_all(pre, [Request(prompt_ids=list(prompt), prefill_only=True,
                                 **kw)])[0]
    assert rp.finish_reason == "handoff"
    assert pre.stats["decode_dispatches"] == 0
    return rp.handoff


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_device_native_handoff_imports_bit_equal_on_the_card(cuda_device,
                                                             kv_quant):
    """``export_slot_kv(fetch=False)`` keeps the payload on the card, with
    the serving stream's event behind its gather; ``import_slot_kv``
    scatters those CUDA tensors into other pages of a second pool, whose
    re-export is bit-equal; and the decode-role scheduler fed the payload
    streams the unified stream's tokens with no ``flash_prefill`` launch."""
    from generativeaiexamples_tpu_torch.core import kv_wire
    from generativeaiexamples_tpu_torch.engine.scheduler import Request
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer

    prompt = ByteTokenizer().encode("the quick brown fox jumps over the "
                                    "lazy dog", add_bos=True)
    kw = dict(max_tokens=12, temperature=0.7, seed=123)
    payload = _prefilled(cuda_device, kv_quant, prompt, kw)
    arrays = ("k", "v", "k_s", "v_s") if kv_quant == "int8" else ("k", "v")
    for key in arrays:
        assert payload[key].is_cuda, key
    assert isinstance(payload[kv_wire.READY_KEY], torch.cuda.Event)

    dec = _kv_sched(cuda_device, "decode", kv_quant)
    core, n = dec.core, int(payload["n_pages"])
    pages = list(range(core.num_pages - n, core.num_pages))
    state = core.import_slot_kv(core.init_state(), 1, pages, payload)
    assert int(state.cache.lengths[1]) == payload["length"]
    back = core.export_slot_kv(state, pages, payload["length"])
    for key in arrays:
        assert back[key].dtype == payload[key].dtype
        assert torch.equal(back[key].view(torch.uint8),
                           payload[key].view(torch.uint8)), key

    ref = _tick_all(dec, [Request(prompt_ids=list(prompt), **kw)])[0]
    tk.reset_launch_counts()
    rd = dec.submit_prefilled(Request(prompt_ids=list(prompt), **kw),
                              payload)
    _tick_all(dec, [rd], submit=False)
    assert tk.launch_counts()["flash_prefill"] == 0
    key = ("ragged_paged_attention_int8" if kv_quant == "int8"
           else "ragged_paged_attention")
    assert tk.launch_counts()[key] > 0
    assert rd.output_ids == ref.output_ids


@pytest.mark.cuda
def test_frame_of_a_device_native_payload_on_the_card(cuda_device):
    """A frame encoded from a payload that still carries ``READY_KEY``
    waits on that event, ships no process-local key, and decodes to the
    payload's bits."""
    from generativeaiexamples_tpu_torch.core import kv_wire
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer

    prompt = ByteTokenizer().encode("voltage report for pump four",
                                    add_bos=True)
    for kv_quant in ("none", "int8"):
        payload = _prefilled(cuda_device, kv_quant, prompt,
                             dict(max_tokens=4, temperature=0.0))
        assert kv_wire.READY_KEY in payload
        body = kv_wire.encode_kv_frames(payload)
        assert kv_wire.READY_KEY not in kv_wire.peek_kv_frames_meta(body)
        out = kv_wire.decode_kv_frames(body)
        for key in kv_wire.PAYLOAD_ARRAYS:
            if payload.get(key) is None:
                assert out.get(key) is None
                continue
            assert torch.equal(out[key].view(torch.uint8),
                               payload[key].cpu().view(torch.uint8)), key


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_spill_round_trip_through_pinned_host_tensors_on_the_card(
        cuda_device, monkeypatch, kv_quant):
    """Page exhaustion with a spill budget: the victim's pages go to pinned
    host tensors, come back with no ``flash_prefill`` launch, and both
    streams equal the roomy pool's."""
    from generativeaiexamples_tpu_torch.engine.scheduler import Request
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    prompts = [tok.encode("the quick brown fox jumps over the lazy"),
               tok.encode("pack my box with five dozen liquor ju")]
    kws = [dict(max_tokens=60, temperature=0.7, seed=11),
           dict(max_tokens=60, temperature=0.0, seed=22)]

    def reqs():
        return [Request(prompt_ids=list(p), **kw)
                for p, kw in zip(prompts, kws)]

    monkeypatch.delenv("APP_KV_SPILL_MB", raising=False)
    roomy = _tick_all(_kv_sched(cuda_device, kv_quant=kv_quant,
                                max_batch_size=2, prefix_cache="off"),
                      reqs())
    monkeypatch.setenv("APP_KV_SPILL_MB", "64")
    # 2 slots x 3 prompt pages + 2 spares: decode growth exhausts the pool
    sched = _kv_sched(cuda_device, kv_quant=kv_quant, max_batch_size=2,
                      num_pages=8, prefix_cache="off")
    pinned = []
    admit = sched._spill.admit

    def spy(rid, payload):
        pinned.extend(payload[k].is_pinned()
                      for k in ("k", "v", "k_s", "v_s")
                      if payload.get(k) is not None)
        return admit(rid, payload)

    monkeypatch.setattr(sched._spill, "admit", spy)
    r1, r2 = reqs()
    sched.submit(r1)
    sched.submit(r2)
    for _ in range(6000):
        sched._tick()
        if r1.spill_resumes + r2.spill_resumes >= 1:
            break
    else:
        raise AssertionError("no spill resume under page pressure")
    tk.reset_launch_counts()
    _tick_all(sched, [r1, r2], submit=False)
    assert pinned and all(pinned)
    assert tk.launch_counts()["flash_prefill"] == 0, \
        "the spill promotion ran a prefill"
    assert sched.stats["spill_resumes"] >= 1
    assert sched.stats["kv_spill_spilled"] == sched.stats["kv_spill_promoted"]
    assert [r1.output_ids, r2.output_ids] == [r.output_ids for r in roomy]
