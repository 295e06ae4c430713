"""The port's attention kernels: wrappers, plain versions, predicates.

Port of ``generativeaiexamples_tpu/ops/pallas/attention.py``, every kernel
of it, for a single card. Each kernel is CUDA C++ for ``sm_90a`` under
``csrc/`` (built by :mod:`.build`, bound with ``ctypes``) and has, beside
it here:

* a plain PyTorch version of the same signature (``*_plain``; for
  ``ragged_decode`` it is :func:`mha_decode` itself): the CPU path takes
  it, and ``chip_smoke.py`` holds the kernel against it on the card. A wrapper uses it only for tensors that lie on the CPU; for a CUDA
  tensor it launches the kernel or raises, never falls back;
* a launch count (:func:`launch_counts`, kept in :mod:`.build` with the
  sampling kernel's), raised by one where the wrapper launches, so a run
  can show that the serving path went through it.

``flash_prefill`` replaces ``flash_prefill``/``_flash_kernel``;
``ragged_paged_attention`` replaces ``ragged_paged_attention``/
``_ragged_paged_kernel`` for bf16/f32 pools and, given ``k_scales``/
``v_scales``, its int8-KV variant (one kernel, two instances, counted
apart), and ``paged_decode`` stays a wrapper over it; ``ragged_decode``
replaces ``ragged_decode``/``_decode_kernel``, the decode attention of the
dense-cache model API. What bounds each kernel on the H100 and what its
design does about that is written at the top of its ``.cu`` file.

The two decode-side kernels split each row's KV walk across blocks
(flash-decoding): :func:`split_plan` picks the number of splits from shapes
only, the wrapper allocates the partials' scratch with ``torch.empty``, and
one launch both walks and combines (the last block of each (row, KV head)
to finish combines, counted by a per-device ticket buffer that the kernel
leaves at zero; launches that share it run in one stream's order).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import torch

from generativeaiexamples_tpu_torch.ops.attention import (
    NEG_INF, mha_decode, mha_prefill)
# the launch counts of every kernel of the port, this module's and
# ops/cuda/sampling.py's, re-exported where the attention kernels live
from generativeaiexamples_tpu_torch.ops.cuda.build import (  # noqa: F401
    LAUNCHES, launch_counts, reset_launch_counts)

HEAD_DIMS = (16, 32, 64, 128, 256)
QG_MAX = 64   # query vectors (G * Qb) one block of the walk holds, at most
SPLIT_TILE = 64   # tokens per tile of the decode-side walk (csrc BT)
SPLIT_MAX = 32    # splits of one (row, KV head), at most
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def qg_max(head_dim: int) -> int:
    """Query vectors one block of the decode-side walk holds at
    ``head_dim`` (csrc ``qg_cap``): ``QG_MAX``, or 32 at head_dim 256,
    where a bf16 warp's 16 output rows take 128 registers."""
    return QG_MAX if head_dim <= 128 else 32


# ---------------------------------------------------------------------------
# Support predicates (same names and meaning as the TPU package's)
# ---------------------------------------------------------------------------

def prefill_supported(seq_len: int, kv_len: int, head_dim: int) -> bool:
    """The flash kernel takes any lengths (it masks ragged edges itself);
    head_dim must be one of its template instances."""
    return seq_len >= 1 and kv_len >= 1 and head_dim in HEAD_DIMS


def decode_supported(kv_len: int, head_dim: int) -> bool:
    """``ragged_decode`` takes any cache length (it clamps its walk to the
    cache and masks the ragged edge itself); head_dim must be one of its
    template instances."""
    return kv_len >= 1 and head_dim in HEAD_DIMS


def paged_decode_supported(page_size: int, head_dim: int) -> bool:
    return page_size >= 1 and head_dim in HEAD_DIMS


def ragged_paged_supported(page_size: int, head_dim: int,
                           q_block: int = 8) -> bool:
    """Same page/head limits as :func:`paged_decode_supported` by
    construction (one kernel); ``q_block`` adds a power-of-two row size."""
    return (paged_decode_supported(page_size, head_dim)
            and q_block >= 1 and q_block & (q_block - 1) == 0)


def query_tile(q_block: int, group: int, head_dim: int = 128) -> int:
    """Queries of a ragged row one block takes: the whole row when its
    ``q_block * group`` query vectors fit :func:`qg_max` of ``head_dim``,
    else ``qg_max // group`` (llama3-70b's G = 8 at 128: 8 queries, so a
    verify row of 9 is two tiles and a mixed row of 16 two; gemma-2b's G =
    8 at 256: 4 queries, so a verify row of 5 is two tiles and a mixed row
    of 16 four). Each tile is a block over the same KV walk with partials
    and a ticket of its own."""
    cap = qg_max(head_dim)
    if group > cap:
        raise ValueError(f"GQA group {group} exceeds the {cap} query "
                         f"vectors a block holds at head_dim {head_dim}")
    return q_block if q_block * group <= cap else cap // group


# ---------------------------------------------------------------------------
# Split plan of the decode-side kernels
# ---------------------------------------------------------------------------

class SplitPlan(NamedTuple):
    """``splits`` blocks per (row, KV head), each walking ``tiles``
    consecutive ``SPLIT_TILE``-token tiles of the row."""
    splits: int
    tiles: int

    def scratch_bytes(self, cells: int, qg: int, head_dim: int) -> int:
        """Bytes of f32 partials (m, l, acc) for ``cells`` (row, KV head)
        pairs of ``qg`` query vectors; 0 when the walk is not split."""
        if self.splits == 1:
            return 0
        return 4 * cells * self.splits * qg * (head_dim + 2)


def split_plan(rows: int, kv_heads: int, capacity: int,
               n_sm: int) -> SplitPlan:
    """Splits of the KV walk, from shapes only (never from lengths, so a
    launch reads nothing back to the host): at least two blocks per SM
    where the capacity has that many tiles, at most ``SPLIT_MAX`` per (row,
    KV head), one where a single tile covers the capacity. Every split
    holds at least one tile of ``[0, capacity)``."""
    n_tiles = max(1, -(-capacity // SPLIT_TILE))
    want = max(1, min(n_tiles, -(-2 * n_sm // max(1, rows * kv_heads)),
                      SPLIT_MAX))
    tiles = n_tiles // want
    if -(-n_tiles // tiles) > SPLIT_MAX:
        tiles = -(-n_tiles // SPLIT_MAX)
    return SplitPlan(-(-n_tiles // tiles), tiles)


_SM_COUNT: Dict[int, int] = {}
_TICKETS: Dict[int, torch.Tensor] = {}


def _split_args(device: torch.device, rows: int, kv_heads: int,
                capacity: int, qg: int, head_dim: int):
    """(plan, scratch, tickets) of one launch on a CUDA ``device``; scratch
    and tickets are None when the walk is not split."""
    idx = device.index
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            device).multi_processor_count
    plan = split_plan(rows, kv_heads, capacity, _SM_COUNT[idx])
    if plan.splits == 1:
        return plan, None, None
    cells = rows * kv_heads
    part = torch.empty(plan.scratch_bytes(cells, qg, head_dim) // 4,
                       dtype=torch.float32, device=device)
    tickets = _TICKETS.get(idx)
    if tickets is None or tickets.numel() < cells:
        tickets = torch.zeros(cells, dtype=torch.int32, device=device)
        _TICKETS[idx] = tickets
    return plan, part, tickets


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def flash_prefill_plain(q, k, v, start_pos=None, kv_valid_through=None):
    """Plain PyTorch flash prefill: causal GQA attention with query i of row
    b at ``start_pos[b] + i`` and keys masked to ``< kv_valid_through[b]``."""
    B, S = q.shape[:2]
    T = k.shape[1]
    dev = q.device
    if start_pos is None:
        start_pos = torch.zeros((B,), dtype=torch.int32, device=dev)
    if kv_valid_through is None:
        kv_valid_through = torch.full((B,), T, dtype=torch.int32, device=dev)
    qpos = start_pos[:, None].long() + torch.arange(S, device=dev)[None]
    kpos = torch.arange(T, device=dev)[None].expand(B, T)
    return mha_prefill(q, k, v, q_positions=qpos, kv_positions=kpos,
                       kv_mask=kpos < kv_valid_through[:, None].long(),
                       causal=True)


def ragged_paged_attention_plain(q, k_pages, v_pages, row_tables, kv_lens,
                                 q_pos0, q_num, layer=None,
                                 pages_per_layer: Optional[int] = None,
                                 k_scales=None, v_scales=None):
    """Plain PyTorch ragged paged attention: gathers each row's pages into a
    dense view and masks exactly as the kernel does (keys at positions
    ``<= q_pos0 + j`` and ``< kv_len``; query slots past ``q_num`` are fully
    masked and come out finite; rows with ``q_num == 0`` come out zero).

    With ``k_scales``/``v_scales`` (N, KV, page) the pools hold int8 and the
    math is the kernel's, in f32: scores ``(q.k)*scale*k_s``, probabilities
    times ``v_s`` before ``p @ v``, the denominator over the unscaled
    probabilities. The elements are never dequantized."""
    R, Qb, H, HD = q.shape
    N, ps, KVHD = k_pages.shape
    KV = KVHD // HD
    G = H // KV
    P = pages_per_layer if pages_per_layer is not None else N
    lyr = 0 if layer is None else int(layer)
    maxp = row_tables.shape[1]
    T = maxp * ps
    dev = q.device
    rows = lyr * P + row_tables.long()                       # (R, maxp)
    k = k_pages[rows].reshape(R, T, KV, HD).float()
    v = v_pages[rows].reshape(R, T, KV, HD).float()
    qg = q.reshape(R, Qb, KV, G, HD).float()
    s = torch.einsum("rqkgd,rtkd->rkgqt", qg, k) * (1.0 / HD ** 0.5)

    def per_token(scales):                                   # (R, KV, 1, 1, T)
        return (scales[rows].permute(0, 2, 1, 3).reshape(R, KV, T)
                [:, :, None, None, :].float())

    if k_scales is not None:
        s = s * per_token(k_scales)
    t = torch.arange(T, device=dev)
    qi = torch.arange(Qb, device=dev)
    qpos = q_pos0.long()[:, None] + qi[None]                 # (R, Qb)
    ok = ((t[None, None, :] <= qpos[:, :, None])
          & (t[None, None, :] < kv_lens.long()[:, None, None])
          & (qi[None, :, None] < q_num.long()[:, None, None]))   # (R, Qb, T)
    s = torch.where(ok[:, None, None], s, torch.tensor(NEG_INF, device=dev))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1).clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    if v_scales is not None:
        p = p * per_token(v_scales)
    out = torch.einsum("rkgqt,rtkd->rqkgd", p, v) / denom
    out = torch.where((q_num > 0)[:, None, None, None, None], out,
                      torch.zeros((), device=dev))
    return out.reshape(R, Qb, H, HD).to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _as_i32(x: torch.Tensor, device) -> torch.Tensor:
    return x.to(device=device, dtype=torch.int32).contiguous()


_FLASH_ARGS = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
               + [ctypes.c_void_p] * 2)
_RAGGED_ARGS = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 11
                + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 3)
_DECODE_ARGS = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                + [ctypes.c_void_p] * 4)


def _lib(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    from generativeaiexamples_tpu_torch.ops.cuda import build
    f = getattr(build.load(name), fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  start_pos: Optional[torch.Tensor] = None,
                  kv_valid_through: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Blockwise causal flash attention for (chunked) prefill.

    q: (B, S, H, HD), the chunk at positions ``start_pos[b] + i``; k, v:
    (B, T, KV, HD), the dense cache view; kv_valid_through: (B,) live rows.
    Read through their strides (head dim contiguous, every row on 16
    bytes: the kernel copies 16 bytes at a time). Returns a fresh
    (B, S, H, HD) tensor in q's dtype. CPU tensors take the plain version.
    """
    if not q.is_cuda:
        return flash_prefill_plain(q, k, v, start_pos, kv_valid_through)
    B, S, H, HD = q.shape
    T, KV = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_prefill takes bf16/f32 q, k, v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if HD not in HEAD_DIMS or k.shape != (B, T, KV, HD) or v.shape != k.shape:
        raise ValueError(f"flash_prefill: unsupported shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    if H % KV or any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_prefill: H % KV != 0 or head dim not "
                         "contiguous")
    if not (k.device == q.device == v.device):
        raise ValueError("flash_prefill: q, k, v on different devices")
    size = q.element_size()
    if any(t.data_ptr() % 16 or any(st * size % 16 for st in t.stride()[:3])
           for t in (q, k, v)):
        raise ValueError("flash_prefill: q, k, v rows must be 16-byte "
                         "aligned (the kernel copies 16 bytes at a time)")
    dev = q.device
    if start_pos is None:
        start_pos = torch.zeros((B,), dtype=torch.int32, device=dev)
    if kv_valid_through is None:
        kv_valid_through = torch.full((B,), T, dtype=torch.int32, device=dev)
    sp = _as_i32(start_pos, dev)
    vt = _as_i32(kv_valid_through, dev)
    out = torch.empty((B, S, H, HD), dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 9)(
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
        k.stride(2), v.stride(0), v.stride(1), v.stride(2))
    fn = _lib("flash_prefill", "gk_flash_prefill", _FLASH_ARGS)
    rc = fn(_DTYPES[q.dtype], HD, _ptr(q), _ptr(k), _ptr(v), _ptr(out),
            _ptr(sp), _ptr(vt), B, S, T, H, KV,
            ctypes.cast(strides, ctypes.c_void_p), _stream(dev))
    _check(rc, "flash_prefill")
    LAUNCHES["flash_prefill"] += 1
    return out


def ragged_paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, row_tables: torch.Tensor,
                           kv_lens: torch.Tensor, q_pos0: torch.Tensor,
                           q_num: torch.Tensor, layer=None,
                           pages_per_layer: Optional[int] = None,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Ragged attention straight off the flat paged KV pool.

    q: (R, Qb, H, HD), R independent rows of up to Qb queries; k_pages,
    v_pages: (L*P, page, KV*HD) with ``layer`` selecting rows
    ``layer*P + table[r, p]``; row_tables: (R, maxp); kv_lens, q_pos0,
    q_num: (R,). Query j of row r sits at ``q_pos0[r] + j``; query slots
    past ``q_num`` are finite garbage the caller discards. ``layer`` may be
    an int or a device tensor. ``k_scales``/``v_scales``, f32 (L*P, KV,
    page), switch to the int8 pool (its own launch count,
    ``ragged_paged_attention_int8``). A row of more than ``QG_MAX`` query
    vectors (:func:`qg_max`) is cut into query tiles (:func:`query_tile`).
    CPU tensors take the plain version.
    """
    if (k_scales is None) != (v_scales is None):
        raise ValueError("ragged_paged_attention: give both k_scales and "
                         "v_scales, or neither")
    if not q.is_cuda:
        return ragged_paged_attention_plain(q, k_pages, v_pages, row_tables,
                                            kv_lens, q_pos0, q_num, layer,
                                            pages_per_layer, k_scales,
                                            v_scales)
    quant = k_scales is not None
    R, Qb, H, HD = q.shape
    N, ps, KVHD = k_pages.shape
    pool_dtype = torch.int8 if quant else q.dtype
    if q.dtype not in _DTYPES or k_pages.dtype != pool_dtype \
            or v_pages.dtype != pool_dtype:
        raise ValueError(f"ragged_paged_attention takes bf16/f32 q and pools "
                         f"of q's dtype, or int8 pools with scales; got "
                         f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}, "
                         f"scales {'given' if quant else 'none'}")
    if HD not in HEAD_DIMS or KVHD % HD or v_pages.shape != k_pages.shape:
        raise ValueError(f"ragged_paged_attention: unsupported shapes q "
                         f"{tuple(q.shape)} pool {tuple(k_pages.shape)}")
    KV = KVHD // HD
    if H % KV or H // KV > qg_max(HD):
        raise ValueError(f"ragged_paged_attention: H={H}, KV={KV} outside "
                         f"the kernel's limits (H/KV <= {qg_max(HD)} at "
                         f"head_dim {HD})")
    if not (q.is_contiguous() and k_pages.is_contiguous()
            and v_pages.is_contiguous()):
        raise ValueError("ragged_paged_attention: q and pools must be "
                         "contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("ragged_paged_attention: pools must be 16-byte "
                         "aligned (the kernel loads them 16 bytes at a time)")
    if quant and any(s.dtype != torch.float32 or s.shape != (N, KV, ps)
                     or not s.is_contiguous() or s.device != q.device
                     for s in (k_scales, v_scales)):
        raise ValueError(f"ragged_paged_attention: scales must be contiguous "
                         f"f32 ({N}, {KV}, {ps}) on {q.device}, got "
                         f"{k_scales.dtype} {tuple(k_scales.shape)}, "
                         f"{v_scales.dtype} {tuple(v_scales.shape)}")
    dev = q.device
    P = pages_per_layer if pages_per_layer is not None else N
    maxp = row_tables.shape[1]
    if isinstance(layer, torch.Tensor):
        lyr = _as_i32(layer.reshape(1), dev)
    else:
        lyr = torch.full((1,), int(layer or 0), dtype=torch.int32, device=dev)
    tables = _as_i32(row_tables, dev)
    lens = _as_i32(kv_lens, dev)
    pos0 = _as_i32(q_pos0, dev)
    qnum = _as_i32(q_num, dev)
    out = torch.empty_like(q)
    # rows past qg_max query vectors: query tiles, each a cell of the grid
    tq = query_tile(Qb, H // KV, HD)
    n_qt = -(-Qb // tq)
    plan, part, tickets = _split_args(dev, R * n_qt, KV, maxp * ps,
                                      tq * (H // KV), HD)
    fn = _lib("ragged_paged", "gk_ragged_paged_attention", _RAGGED_ARGS)
    rc = fn(_DTYPES[q.dtype], HD, _ptr(q), _ptr(k_pages), _ptr(v_pages),
            _ptr(k_scales), _ptr(v_scales), _ptr(tables), _ptr(lens),
            _ptr(pos0), _ptr(qnum), _ptr(lyr), _ptr(out), R, Qb, tq, H, KV,
            ps, maxp, P, plan.tiles, plan.splits, _ptr(part), _ptr(tickets),
            _stream(dev))
    name = "ragged_paged_attention_int8" if quant else "ragged_paged_attention"
    _check(rc, name)
    LAUNCHES[name] += 1
    return out


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, page_table: torch.Tensor,
                 lengths: torch.Tensor, layer=None,
                 pages_per_layer: Optional[int] = None,
                 k_scales: Optional[torch.Tensor] = None,
                 v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode attention off the paged pool, 1..Q queries per slot: the
    uniform-row case of :func:`ragged_paged_attention` (query qi of slot b
    at ``lengths[b] - Q + qi``; ``lengths`` counts all Q writes), over a
    bf16/f32 pool or, with scales, an int8 one."""
    B, Q = q.shape[:2]
    lengths = lengths.to(torch.int32)
    return ragged_paged_attention(
        q, k_pages, v_pages, page_table, lengths, lengths - Q,
        torch.full((B,), Q, dtype=torch.int32, device=lengths.device),
        layer=layer, pages_per_layer=pages_per_layer, k_scales=k_scales,
        v_scales=v_scales)


def ragged_decode(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, lengths: torch.Tensor
                  ) -> torch.Tensor:
    """Single-token decode attention over a dense per-slot cache.

    q: (B, 1, H, HD), contiguous; k_cache, v_cache: (B, T, KV, HD), one
    layer of the dense cache, read in place through their strides (the
    same for both, head dim contiguous, 16-byte aligned rows); lengths:
    (B,) live rows including this step's write (values past T cover the
    whole cache). Returns a fresh (B, 1, H, HD) tensor in q's dtype. CPU
    tensors take the plain version, :func:`mha_decode`.
    """
    if not q.is_cuda:
        return mha_decode(q, k_cache, v_cache, lengths)
    B, one, H, HD = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"ragged_decode takes bf16/f32 q and caches of one "
                         f"dtype, got {q.dtype}, {k_cache.dtype}, "
                         f"{v_cache.dtype}")
    if (one != 1 or HD not in HEAD_DIMS or k_cache.shape != (B, T, KV, HD)
            or v_cache.shape != k_cache.shape):
        raise ValueError(f"ragged_decode: unsupported shapes q "
                         f"{tuple(q.shape)} k {tuple(k_cache.shape)} v "
                         f"{tuple(v_cache.shape)}")
    if H % KV or H // KV > qg_max(HD):
        raise ValueError(f"ragged_decode: H={H}, KV={KV} outside the "
                         f"kernel's limits (H/KV <= {qg_max(HD)} at "
                         f"head_dim {HD})")
    if (not q.is_contiguous() or k_cache.stride(-1) != 1
            or v_cache.stride() != k_cache.stride()):
        raise ValueError("ragged_decode: q must be contiguous, and the "
                         "caches' head dim contiguous with equal strides")
    size = q.element_size()
    if (k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16
            or any(st * size % 16 for st in k_cache.stride()[:3])):
        raise ValueError("ragged_decode: cache rows must be 16-byte aligned "
                         "(the kernel loads them 16 bytes at a time)")
    if not (k_cache.device == q.device == v_cache.device):
        raise ValueError("ragged_decode: q, k, v on different devices")
    dev = q.device
    lens = _as_i32(lengths, dev)
    out = torch.empty((B, 1, H, HD), dtype=q.dtype, device=dev)
    plan, part, tickets = _split_args(dev, B, KV, T, H // KV, HD)
    strides = (ctypes.c_longlong * 3)(*k_cache.stride()[:3])
    fn = _lib("ragged_decode", "gk_ragged_decode", _DECODE_ARGS)
    rc = fn(_DTYPES[q.dtype], HD, _ptr(q), _ptr(k_cache), _ptr(v_cache),
            _ptr(lens), _ptr(out), B, T, H, KV, plan.tiles, plan.splits,
            _ptr(part), _ptr(tickets), ctypes.cast(strides, ctypes.c_void_p),
            _stream(dev))
    _check(rc, "ragged_decode")
    LAUNCHES["ragged_decode"] += 1
    return out
