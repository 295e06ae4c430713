"""Paged KV pool and the paged prefill/decode passes.

Port of ``generativeaiexamples_tpu/engine/kv_cache.py`` for bf16/f32 and
int8 pools. The pool keeps the TPU package's flat layout, ``(L*P, page,
KV*HD)`` for K and for V, with layer l's physical page p at row
``l*P + p`` and page 0 the null page that no request owns (inactive slots
and padding rows write there). An int8 pool (``kv_quant="int8"``) adds
per-token-per-head f32 scales ``k_s``/``v_s`` of shape ``(L*P, KV,
page)``, the same layout as there, so KV can cross between the packages.
Unlike the JAX version, which threads the pool through functionally, these
passes **update the pool and the ``lengths`` vector in place**: PyTorch
has no donation, and a copy of a multi-GB pool per step would dominate the
step.

Attention in the passes follows :func:`llama.kernel_attention`: ``"auto"``
and ``"kernel"`` call the kernel wrappers (``ops/cuda/attention.py``),
which launch the hand-written kernels on CUDA tensors, ``"plain"`` the dense
gather (dequantized in the model dtype for an int8 pool) plus
:func:`mha_prefill` (the TPU package's XLA path). Prefill over an int8
pool writes the quantized chunk first and then attends to a dequantized
dense view, the chunk included, as the reference does.

LoRA: :func:`prefill_chunks`, :func:`prefill_chunk`,
:func:`decode_step_wide` and :func:`decode_step` take ``adapters`` (a
global tree, or the engine's stacked slots with each row's slot in
``adapter_ix``; either as a tree or prepared, ``ops.lora.prepare``) into
every projection (``llama.run_blocks``);
:func:`mixed_step` runs base weights only, as there, and refuses them.

The KV handoff: :func:`export_pages` gathers a slot's pages into fresh
dense tensors in the pool's dtype (an int8 pool's values and scales, never
a dequantized copy) and :func:`import_pages` scatters them into another
pool's pages in place and sets the slot's length. In the reference these
are XLA gathers and scatters outside any Pallas kernel, so one
``index_select`` and one ``index_copy_`` a pool tensor are their port.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

import torch

from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.ops.attention import mha_prefill
from generativeaiexamples_tpu_torch.ops.cuda import attention as kernels
from generativeaiexamples_tpu_torch.ops.layers import rotary_embedding


KV_QUANTS = ("none", "", "int8")   # pool storage: the model dtype, or int8


def pool_dtype(cfg: llama.LlamaConfig, kv_quant: str) -> torch.dtype:
    """The pool's element type: the model dtype, or int8 for
    ``kv_quant="int8"``; any other value raises."""
    if kv_quant not in KV_QUANTS:
        raise ValueError(f"unknown kv_quant {kv_quant!r} (none|int8)")
    return torch.int8 if kv_quant == "int8" else cfg.torch_dtype


@dataclass
class PagedKVCache:
    """k, v: (L*P, page_size, KV*HD); lengths: (B,) int32 live rows/slot;
    k_s, v_s: (L*P, KV, page_size) f32 scales of an int8 pool, else None."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    k_s: Optional[torch.Tensor] = None
    v_s: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_s is not None

    @property
    def nbytes(self) -> int:
        """Device bytes of the pool, scales included."""
        return sum(t.numel() * t.element_size()
                   for t in (self.k, self.v, self.k_s, self.v_s)
                   if t is not None)

    @staticmethod
    def create(cfg: llama.LlamaConfig, batch: int, num_pages: int,
               page_size: int, device=None,
               kv_quant: str = "none") -> "PagedKVCache":
        """Allocate the pool: the model dtype, or int8 with scales for
        ``kv_quant="int8"``; any other value raises."""
        shape = (cfg.n_layers * num_pages, page_size,
                 cfg.n_kv_heads * cfg.head_dim)
        dtype = pool_dtype(cfg, kv_quant)
        z = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)
        cache = PagedKVCache(k=z(shape, dtype), v=z(shape, dtype),
                             lengths=z((batch,), torch.int32))
        if kv_quant == "int8":
            s_shape = (shape[0], cfg.n_kv_heads, page_size)
            cache.k_s = z(s_shape, torch.float32)
            cache.v_s = z(s_shape, torch.float32)
        return cache


def _kv_quantize(x: torch.Tensor, KV: int, HD: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., KV*HD) -> int8 values + (..., KV) per-token-per-head scales:
    symmetric, ``s = max|x| / 127``, rounded half to even (as
    ``jnp.round``), so the values and scales equal the reference's."""
    shaped = x.reshape(x.shape[:-1] + (KV, HD)).float()
    s = shaped.abs().amax(dim=-1) / 127.0
    safe = s.clamp_min(1e-10)
    q = torch.round(shaped / safe[..., None]).clamp(-127, 127)
    return q.to(torch.int8).reshape(x.shape), s


def _kv_dequant_dense(q: torch.Tensor, s: torch.Tensor, KV: int, HD: int,
                      dtype: torch.dtype) -> torch.Tensor:
    """(B, T, KV*HD) int8 + (B, T, KV) scales -> (B, T, KV, HD) dense."""
    B, T = q.shape[:2]
    return (q.reshape(B, T, KV, HD).float() * s[..., None]).to(dtype)


def _scatter_pages(cache: PagedKVCache, flat_pages: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor) -> None:
    """Write a page-aligned chunk's K/V (G, C, KV, HD) into whole physical
    pages ``flat_pages`` (G*n_cp,), in place, quantizing per token and head
    for an int8 pool (scales go in transposed, as (rows, KV, page)).
    Padding rows all target the null page 0, so duplicate indices only
    ever hit it."""
    G, C, KV, HD = k.shape
    ps, width = cache.k.shape[1], cache.k.shape[2]
    n_cp = C // ps
    if not cache.quantized:
        cache.k[flat_pages] = k.to(cache.k.dtype).reshape(-1, ps, width)
        cache.v[flat_pages] = v.to(cache.v.dtype).reshape(-1, ps, width)
        return
    for pool, scales, x in ((cache.k, cache.k_s, k), (cache.v, cache.v_s, v)):
        xq, xs = _kv_quantize(x.reshape(G, C, width), KV, HD)
        pool[flat_pages] = xq.reshape(-1, ps, width)
        scales[flat_pages] = (xs.reshape(G, n_cp, ps, KV).permute(0, 1, 3, 2)
                              .reshape(G * n_cp, KV, ps))


def _gather_dense(cache: PagedKVCache, flat_rows: torch.Tensor, G: int,
                  T: int, KV: int, HD: int, dtype: torch.dtype
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (G, T, KV, HD) view of pool rows ``flat_rows`` (G, maxp),
    dequantized into ``dtype`` for an int8 pool."""
    if not cache.quantized:
        return (cache.k[flat_rows].reshape(G, T, KV, HD),
                cache.v[flat_rows].reshape(G, T, KV, HD))
    ps = cache.page_size

    def dense(pool, scales):
        s = (scales[flat_rows].reshape(G, -1, KV, ps).permute(0, 1, 3, 2)
             .reshape(G, T, KV))
        return _kv_dequant_dense(pool[flat_rows].reshape(G, T, -1), s, KV, HD,
                                 dtype)

    return dense(cache.k, cache.k_s), dense(cache.v, cache.v_s)


# ---------------------------------------------------------------------------
# KV-page handoff (disaggregated prefill/decode serving)
# ---------------------------------------------------------------------------

def _layer_rows(ids: torch.Tensor, L: int, num_pages: int) -> torch.Tensor:
    """Pool rows of pages ``ids`` (n,) in every layer, layer-major: layer
    l's j-th page at ``l*n + j``."""
    layers = torch.arange(L, dtype=torch.long, device=ids.device)
    return (layers[:, None] * num_pages + ids[None, :]).reshape(-1)


@torch.no_grad()
def export_pages(cache: PagedKVCache, page_ids: torch.Tensor, num_pages: int
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Gather a slot's pages into fresh dense tensors in the pool's dtype
    (one ``index_select`` a pool tensor): the prefill half of the handoff.
    An int8 pool exports its int8 values and f32 scales, never a
    dequantized copy.

    page_ids: (n,) physical pages of the slot's first n logical pages.
    Returns (k, v, k_s, v_s): k/v (L*n, page, KV*HD) with layer l's j-th
    page at row ``l*n + j``; k_s/v_s (L*n, KV, page) f32 for an int8 pool,
    else None. The tensors are new, so pages freed and reused after the
    gather was issued cannot change them."""
    L = cache.k.shape[0] // num_pages
    src = page_ids.to(device=cache.k.device, dtype=torch.long)
    rows = _layer_rows(src, L, num_pages)
    out = [t.index_select(0, rows) for t in (cache.k, cache.v)]
    if cache.quantized:
        return (*out, cache.k_s.index_select(0, rows),
                cache.v_s.index_select(0, rows))
    return (*out, None, None)


@torch.no_grad()
def import_pages(cache: PagedKVCache, page_ids: torch.Tensor, num_pages: int,
                 slot: int, length: int, k: torch.Tensor, v: torch.Tensor,
                 k_s: Optional[torch.Tensor] = None,
                 v_s: Optional[torch.Tensor] = None) -> PagedKVCache:
    """Scatter an exported page buffer into pages ``page_ids`` of this pool,
    in place (``index_copy_``), and set ``lengths[slot] = length``: the
    decode half of the handoff. k/v (L*n, page, KV*HD) in the pool's dtype
    and geometry, the scales (L*n, KV, page) for an int8 pool (the engine
    validates the payload first). The slot's first decode step then writes
    at position ``length``, as after a local prefill."""
    L = cache.k.shape[0] // num_pages
    dst = page_ids.to(device=cache.k.device, dtype=torch.long)
    rows = _layer_rows(dst, L, num_pages)
    cache.k.index_copy_(0, rows, k.to(cache.k.device, cache.k.dtype))
    cache.v.index_copy_(0, rows, v.to(cache.v.device, cache.v.dtype))
    if cache.quantized:
        if k_s is None or v_s is None:
            raise ValueError("int8 pool import needs k_s/v_s scales")
        cache.k_s.index_copy_(0, rows, k_s.to(cache.k_s.device,
                                              torch.float32))
        cache.v_s.index_copy_(0, rows, v_s.to(cache.v_s.device,
                                              torch.float32))
    cache.lengths[slot] = length
    return cache


@torch.no_grad()
def import_pages_partial(cache: PagedKVCache, page_ids: torch.Tensor,
                         num_pages: int, k: torch.Tensor, v: torch.Tensor,
                         k_s: Optional[torch.Tensor] = None,
                         v_s: Optional[torch.Tensor] = None) -> PagedKVCache:
    """Scatter an exported page buffer into pages ``page_ids`` in place
    (``index_copy_``) without touching any slot's state: the prefix tier's
    promotion (``engine/kv_tier.py``). Unlike :func:`import_pages` the run
    covers only the prefix of a prompt still being admitted; the chunked
    prefill of its tail owns ``lengths`` as a fresh admission does, so this
    never writes them. Shapes as :func:`import_pages`'s, the int8 pool's
    scales ``(L*n, KV, page)`` included."""
    L = cache.k.shape[0] // num_pages
    dst = page_ids.to(device=cache.k.device, dtype=torch.long)
    rows = _layer_rows(dst, L, num_pages)
    cache.k.index_copy_(0, rows, k.to(cache.k.device, cache.k.dtype))
    cache.v.index_copy_(0, rows, v.to(cache.v.device, cache.v.dtype))
    if cache.quantized:
        if k_s is None or v_s is None:
            raise ValueError("int8 pool import needs k_s/v_s scales")
        cache.k_s.index_copy_(0, rows, k_s.to(cache.k_s.device,
                                              torch.float32))
        cache.v_s.index_copy_(0, rows, v_s.to(cache.v_s.device,
                                              torch.float32))
    return cache


class PageAllocator:
    """Host-side free-list over physical pages 1..num_pages-1 (0 = null)."""

    def __init__(self, num_pages: int) -> None:
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self._free: deque = deque(range(1, num_pages))

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop n pages, or None (and no change) if fewer are free."""
        if n > len(self._free):
            return None
        return [self._free.popleft() for _ in range(n)]

    def free(self, pages: Iterable[int]) -> None:
        for p in pages:
            if not 1 <= p < self.num_pages:
                raise ValueError(f"freeing invalid page id {p}")
            self._free.append(p)


# ---------------------------------------------------------------------------
# Paged passes
# ---------------------------------------------------------------------------

def prefill_chunks(params: llama.Params, cfg: llama.LlamaConfig,
                   tokens: torch.Tensor, cache: PagedKVCache,
                   page_rows: torch.Tensor, slots: torch.Tensor,
                   start_pos: torch.Tensor, chunk_len: torch.Tensor,
                   num_pages: int, adapters: Optional[llama.Params] = None,
                   adapter_ix: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """One chunk each for G rows in one pass; updates ``cache`` in place.

    tokens: (G, C) right-padded chunks, C page-aligned; page_rows: (G,
    maxp); slots: (G,), used only for the lengths update: entries equal to
    the batch size (padding rows, or all but the newest chunk of a slot)
    are dropped. Consecutive chunks of one prompt may share a group: every
    layer writes all rows' K/V before any row's attention reads, so a later
    chunk sees the earlier one. start_pos, chunk_len: (G,); adapter_ix:
    (G,) each row's adapter slot under stacked ``adapters``. Returns logits
    at each row's last valid position, (G, V) float32.
    """
    G, C = tokens.shape
    ps = cache.page_size
    if C % ps:
        raise ValueError(f"chunk size {C} must be page-aligned (page={ps})")
    n_cp = C // ps
    maxp = page_rows.shape[1]
    T = maxp * ps
    KV, HD = cfg.n_kv_heads, cfg.head_dim
    dev = tokens.device
    start = start_pos.to(torch.int64)
    positions = start[:, None] + torch.arange(C, device=dev)[None]   # (G, C)
    h = llama.embed_tokens(params, cfg, tokens)
    cos, sin = rotary_embedding(positions, HD, cfg.rope_theta,
                                scaling=cfg.rope_scaling)
    valid_through = (start_pos + chunk_len).to(torch.int32)          # (G,)
    rows64 = page_rows.to(torch.int64)
    chunk_pages = rows64.gather(
        1, (start // ps)[:, None] + torch.arange(n_cp, device=dev)[None])
    cache_positions = torch.arange(T, device=dev)[None].expand(G, T)
    kv_mask = cache_positions < valid_through[:, None]
    use_kernel = llama.kernel_attention(cfg)

    def attn_for_layer(i):
        def attn(q, k, v):
            _scatter_pages(cache, (i * num_pages + chunk_pages).reshape(-1),
                           k, v)
            k_dense, v_dense = _gather_dense(cache, i * num_pages + rows64,
                                             G, T, KV, HD, q.dtype)
            if use_kernel:
                return kernels.flash_prefill(q, k_dense, v_dense,
                                             start_pos=start_pos,
                                             kv_valid_through=valid_through)
            return mha_prefill(q, k_dense, v_dense, q_positions=positions,
                               kv_positions=cache_positions, kv_mask=kv_mask,
                               causal=True)
        return attn

    h = llama.run_blocks(cfg, params, h, cos, sin, attn_for_layer, adapters,
                         adapter_ix)
    last = (chunk_len.to(torch.int64) - 1).clamp_min(0)
    h_last = h[torch.arange(G, device=dev), last][:, None]          # (G, 1, D)
    logits = llama._unembed(cfg, params, h_last)[:, 0]
    # rows whose slot is the batch size are dropped: they scatter into a
    # spare entry past the batch (no boolean indexing, so no host sync)
    B = cache.lengths.shape[0]
    ext = torch.cat([cache.lengths, cache.lengths.new_zeros(1)])
    ext.scatter_(0, slots.long().clamp(0, B), valid_through)
    cache.lengths.copy_(ext[:B])
    return logits


def prefill_chunk(params: llama.Params, cfg: llama.LlamaConfig,
                  tokens: torch.Tensor, cache: PagedKVCache,
                  page_row: torch.Tensor, slot: int, start_pos: int,
                  chunk_len: int, num_pages: int,
                  adapters: Optional[llama.Params] = None,
                  adapter_ix: Optional[int] = None) -> torch.Tensor:
    """One chunk for a single slot: :func:`prefill_chunks` with G = 1.
    tokens: (1, C); page_row: (maxp,); adapter_ix: the slot's adapter slot
    under stacked ``adapters``. Returns (1, V) logits at the last valid
    position; ``lengths[slot] = start_pos + chunk_len``."""
    dev = tokens.device
    i32 = lambda x: torch.tensor([x], dtype=torch.int32, device=dev)
    return prefill_chunks(params, cfg, tokens, cache, page_row[None],
                          i32(slot), i32(start_pos), i32(chunk_len),
                          num_pages, adapters,
                          None if adapter_ix is None else i32(adapter_ix))


def decode_step_wide(params: llama.Params, cfg: llama.LlamaConfig,
                     tokens: torch.Tensor, cache: PagedKVCache,
                     page_table: torch.Tensor, write_mask: torch.Tensor,
                     num_pages: int, adapters: Optional[llama.Params] = None,
                     adapter_ix: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Q-token decode step: tokens (B, Q) occupy positions lengths[b] ..
    lengths[b]+Q-1. Their K/V are written into the slot's pages in place
    (rows past the table's capacity, and every row of a masked-out slot,
    land on the null page); query qi attends positions < lengths[b]+qi+1.
    ``adapter_ix`` (B,): each slot's adapter slot under stacked
    ``adapters``. Returns logits (B, Q, V); ``lengths`` is left
    unchanged."""
    B, Q = tokens.shape
    ps = cache.page_size
    maxp = page_table.shape[1]
    T = maxp * ps
    KV, HD = cfg.n_kv_heads, cfg.head_dim
    dev = tokens.device
    L = cache.lengths.to(torch.int64)
    positions = L[:, None] + torch.arange(Q, device=dev)[None]     # (B, Q)
    h = llama.embed_tokens(params, cfg, tokens)
    cos, sin = rotary_embedding(positions, HD, cfg.rope_theta,
                                scaling=cfg.rope_scaling)
    # rows valid for attention INCLUDE this step's writes; not clamped to
    # the capacity (the kernel clamps its page loop itself)
    attn_len = (L + Q).to(torch.int32)
    table64 = page_table.to(torch.int64)
    ok = write_mask[:, None] & (positions < T)
    page_ix = (positions // ps).clamp_max(maxp - 1)
    rows = torch.where(ok, table64.gather(1, page_ix), torch.zeros_like(L)[:, None])
    offs = positions % ps
    cache_positions = torch.arange(T, device=dev)[None].expand(B, T)
    kv_mask = cache_positions < attn_len[:, None]
    use_kernel = llama.kernel_attention(cfg)

    def attn_for_layer(i):
        def attn(q, k, v):
            _write_rows(cache, i * num_pages + rows, offs,
                        k.reshape(B, Q, KV * HD), v.reshape(B, Q, KV * HD),
                        KV, HD)
            if use_kernel:
                return kernels.paged_decode(q, cache.k, cache.v, page_table,
                                            attn_len, layer=i,
                                            pages_per_layer=num_pages,
                                            k_scales=cache.k_s,
                                            v_scales=cache.v_s)
            k_dense, v_dense = _gather_dense(cache, i * num_pages + table64,
                                             B, T, KV, HD, q.dtype)
            return mha_prefill(q, k_dense, v_dense, q_positions=positions,
                               kv_positions=cache_positions, kv_mask=kv_mask,
                               causal=True)
        return attn

    h = llama.run_blocks(cfg, params, h, cos, sin, attn_for_layer, adapters,
                         adapter_ix)
    return llama._unembed(cfg, params, h)


def _write_rows(cache: PagedKVCache, flat: torch.Tensor, offs: torch.Tensor,
                k: torch.Tensor, v: torch.Tensor, KV: int, HD: int) -> None:
    """Write (B, Q, KV*HD) K/V rows at pool rows ``flat`` and in-page
    offsets ``offs`` (both (B, Q)), in place, quantizing for an int8 pool;
    ``(flat, :, offs)`` puts the (B, Q) index dims first: (B, Q, KV)."""
    if cache.quantized:
        for pool, scales, x in ((cache.k, cache.k_s, k),
                                (cache.v, cache.v_s, v)):
            xq, xs = _kv_quantize(x, KV, HD)
            pool[flat, offs] = xq
            scales[flat, :, offs] = xs
    else:
        cache.k[flat, offs] = k.to(cache.k.dtype)
        cache.v[flat, offs] = v.to(cache.v.dtype)


def mixed_step(params: llama.Params, cfg: llama.LlamaConfig,
               tokens: torch.Tensor, cache: PagedKVCache,
               page_table: torch.Tensor, write_mask: torch.Tensor,
               num_pages: int, chunk_tokens: torch.Tensor,
               chunk_page_rows: torch.Tensor, chunk_start: torch.Tensor,
               chunk_len: torch.Tensor, q_block: int = 8,
               adapters: Optional[llama.Params] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward of a Q-wide decode step for every slot plus up to G
    prefill chunks, as one token axis (the mixed-phase dispatch).

    tokens: (B, Q) decode inputs as in :func:`decode_step_wide`;
    chunk_tokens: (G, C) right-padded page-aligned chunks, one per distinct
    prefilling slot, each slot masked out of ``write_mask``;
    chunk_page_rows: (G, maxp); chunk_start, chunk_len: (G,) as in
    :func:`prefill_chunks`. Padding rows carry ``chunk_len`` 0 and page
    rows of zeros (their writes land on the null page).

    With kernel attention every row runs in one ``ragged_paged_attention``
    launch per layer, either pool: B decode rows of Q queries padded to
    ``q_block``, then C / q_block rows per chunk; the ragged metadata is
    built once. Otherwise the plain path attends over dense gathers, the
    two-dispatch math. Updates the pool in place; ``lengths`` is left
    unchanged (the engine sets it from accepted counts and chunk ends).
    Returns (decode logits (B, Q, V), logits at each chunk's last valid
    position (G, V)). Base weights only: ``adapters`` raises (the engine
    turns the mixed dispatch off while adapters are resident).
    """
    if adapters is not None:
        raise ValueError("mixed_step runs base weights only: the mixed "
                         "dispatch is off while adapters are resident")
    B, Q = tokens.shape
    G, C = chunk_tokens.shape
    ps = cache.page_size
    if C % ps:
        raise ValueError(f"chunk size {C} must be page-aligned (page={ps})")
    if q_block < 1 or C % q_block:
        raise ValueError(f"chunk size {C} must be a multiple of the ragged "
                         f"q_block ({q_block})")
    use_kernel = llama.kernel_attention(cfg)
    if use_kernel and q_block < Q:
        raise ValueError(f"decode width {Q} exceeds the ragged q_block "
                         f"({q_block})")
    n_cp = C // ps
    maxp = page_table.shape[1]
    T = maxp * ps
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_rows = C // q_block                                     # per chunk
    dev = tokens.device
    L = cache.lengths.to(torch.int64)
    dec_pos = L[:, None] + torch.arange(Q, device=dev)[None]          # (B, Q)
    start = chunk_start.to(torch.int64)
    ch_pos = start[:, None] + torch.arange(C, device=dev)[None]       # (G, C)
    positions = torch.cat([dec_pos.reshape(1, B * Q),
                           ch_pos.reshape(1, G * C)], dim=1)
    h = llama.embed_tokens(params, cfg, torch.cat(
        [tokens.reshape(1, B * Q), chunk_tokens.reshape(1, G * C)], dim=1))
    cos, sin = rotary_embedding(positions, HD, cfg.rope_theta,
                                scaling=cfg.rope_scaling)
    # decode rows: decode_step_wide's write and attention geometry
    attn_len = (L + Q).to(torch.int32)
    table64 = page_table.to(torch.int64)
    ok = write_mask[:, None] & (dec_pos < T)
    rows = torch.where(ok, table64.gather(
        1, (dec_pos // ps).clamp_max(maxp - 1)), torch.zeros_like(dec_pos))
    offs = dec_pos % ps
    # chunk pages: prefill_chunks' geometry
    chunk_rows64 = chunk_page_rows.to(torch.int64)
    chunk_pages = chunk_rows64.gather(
        1, (start // ps)[:, None] + torch.arange(n_cp, device=dev)[None])
    valid_through = (chunk_start + chunk_len).to(torch.int32)         # (G,)
    if use_kernel:
        jr = torch.arange(n_rows, device=dev)
        row_tables = torch.cat([page_table.to(torch.int32),
                                chunk_page_rows.to(torch.int32)
                                .repeat_interleave(n_rows, dim=0)])
        q_num_ch = (chunk_len.to(torch.int64)[:, None]
                    - jr[None] * q_block).clamp(0, q_block)
        # idle tail rows get kv_len 0, so the kernel walks no pages for them
        kv_lens = torch.cat([attn_len, torch.where(
            q_num_ch > 0, valid_through[:, None].to(torch.int64),
            torch.zeros_like(q_num_ch)).reshape(-1).to(torch.int32)])
        q_pos0 = torch.cat([L, (start[:, None] + jr[None] * q_block)
                            .reshape(-1)]).to(torch.int32)
        q_num = torch.cat([torch.full((B,), Q, dtype=torch.int64, device=dev),
                           q_num_ch.reshape(-1)]).to(torch.int32)
    else:
        cache_positions = torch.arange(T, device=dev)
        dec_mask = cache_positions[None] < attn_len[:, None]
        ch_mask = cache_positions[None] < valid_through[:, None]

    def attn_for_layer(i):
        def attn(q, k, v):
            # q/k/v: (1, N, H|KV, HD), B*Q decode rows then G*C chunk rows;
            # chunk pages go in first, then the decode rows (disjoint page
            # sets: every chunk's slot is masked out of the decode writes)
            _scatter_pages(cache, (i * num_pages + chunk_pages).reshape(-1),
                           k[0, B * Q:].reshape(G, C, KV, HD),
                           v[0, B * Q:].reshape(G, C, KV, HD))
            _write_rows(cache, i * num_pages + rows, offs,
                        k[0, :B * Q].reshape(B, Q, KV * HD),
                        v[0, :B * Q].reshape(B, Q, KV * HD), KV, HD)
            q_dec = q[0, :B * Q].reshape(B, Q, H, HD)
            q_ch = q[0, B * Q:].reshape(G, C, H, HD)
            if use_kernel:
                q_rows = torch.cat([
                    torch.nn.functional.pad(q_dec,
                                            (0, 0, 0, 0, 0, q_block - Q)),
                    q_ch.reshape(G * n_rows, q_block, H, HD)])
                ctx = kernels.ragged_paged_attention(
                    q_rows, cache.k, cache.v, row_tables, kv_lens, q_pos0,
                    q_num, layer=i, pages_per_layer=num_pages,
                    k_scales=cache.k_s, v_scales=cache.v_s)
                return torch.cat([ctx[:B, :Q].reshape(1, B * Q, H, HD),
                                  ctx[B:].reshape(1, G * C, H, HD)], dim=1)
            k_dense, v_dense = _gather_dense(cache, i * num_pages + table64,
                                             B, T, KV, HD, q.dtype)
            ctx_dec = mha_prefill(
                q_dec, k_dense, v_dense, q_positions=dec_pos,
                kv_positions=cache_positions[None].expand(B, T),
                kv_mask=dec_mask, causal=True)
            k_dense, v_dense = _gather_dense(cache,
                                             i * num_pages + chunk_rows64,
                                             G, T, KV, HD, q.dtype)
            ctx_ch = mha_prefill(
                q_ch, k_dense, v_dense, q_positions=ch_pos,
                kv_positions=cache_positions[None].expand(G, T),
                kv_mask=ch_mask, causal=True)
            return torch.cat([ctx_dec.reshape(1, B * Q, H, HD),
                              ctx_ch.reshape(1, G * C, H, HD)], dim=1)
        return attn

    h = llama.run_blocks(cfg, params, h, cos, sin, attn_for_layer)
    # unembed only what is read: every decode position and each chunk's
    # last valid position
    last = (B * Q + torch.arange(G, device=dev) * C
            + (chunk_len.to(torch.int64) - 1).clamp_min(0))
    h_sel = torch.cat([h[:, :B * Q], h[:, last]], dim=1)
    logits = llama._unembed(cfg, params, h_sel)[0]
    return logits[:B * Q].reshape(B, Q, -1), logits[B * Q:]


def decode_step(params: llama.Params, cfg: llama.LlamaConfig,
                tokens: torch.Tensor, cache: PagedKVCache,
                page_table: torch.Tensor, write_mask: torch.Tensor,
                num_pages: int, adapters: Optional[llama.Params] = None,
                adapter_ix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step for every slot, the Q == 1 case of
    :func:`decode_step_wide` (``adapters`` and ``adapter_ix`` as there).
    tokens: (B,). Returns logits (B, V) and advances every slot's
    ``lengths`` by one in place (the engine restores inactive slots')."""
    logits = decode_step_wide(params, cfg, tokens[:, None], cache,
                              page_table, write_mask, num_pages, adapters,
                              adapter_ix)
    cache.lengths += 1
    return logits[:, 0]
