"""The port's W8A16 GEMM: int8 weights times bf16 (or f32) activations.

``w8a16_gemm(x (M, K), q (N, K) int8, s (N,) f32) -> (M, N)`` in x's
dtype computes the reference's quantized matmul,
``(x @ q.astype(x.dtype)) * s.astype(x.dtype)``
(``generativeaiexamples_tpu/ops/quant.py:98-104``, which XLA fuses; there
is no Pallas kernel), with the port's (out, in) weight layout. The kernel
is CUDA C++ for ``sm_90a`` (``csrc/w8a16_gemm.cu``: what bounds it and
what its design does about that are written there), built by :mod:`.build`
and bound with ``ctypes``.

Beside it: the plain version :func:`w8a16_gemm_plain` (the reference's
expression in PyTorch; the CPU path takes it and ``chip_smoke.py`` holds
the kernel to it on the card), the support predicate
:func:`w8a16_supported` that the engine checks at init, the split plan
:func:`gemm_plan` (from shapes only) and a launch count,
``launch_counts()["w8a16_gemm"]``. The wrapper takes the plain version
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from generativeaiexamples_tpu_torch.ops.cuda.build import LAUNCHES

GEMM_SPLIT_MAX = 16       # splits of the contraction, at most
DECODE_ROWS_MAX = 80      # rows the decode tile shapes hold (csrc BM <= 80)
# the decode tiles' (columns, depth) and the large-M tile (rows, columns,
# depth), the source's instances
DECODE_TILE = (128, 128)
LARGE_TILE = (128, 128, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
         + [ctypes.c_void_p] * 3)


class GemmPlan(NamedTuple):
    """A tile of ``bm`` x ``bn`` outputs, ``bk`` deep a stage, and
    ``splits`` of the contraction, each ``tiles`` ``bk``-deep tiles."""
    bm: int
    bn: int
    bk: int
    splits: int
    tiles: int

    def scratch_bytes(self, M: int, N: int) -> int:
        """Bytes of f32 partials; 0 when the contraction is not split."""
        return 0 if self.splits == 1 else 4 * self.splits * M * N


def gemm_plan(M: int, N: int, K: int, n_sm: int) -> GemmPlan:
    """Tile shape and split-K plan, from shapes only: a decode tile for
    M <= 80 (rows rounded up to 16, ``DECODE_TILE``), else
    ``LARGE_TILE``; the contraction split
    until the grid holds two blocks an SM, with at least 4 tiles a split
    and at most ``GEMM_SPLIT_MAX`` splits. Every split holds at least one
    tile."""
    if M <= DECODE_ROWS_MAX:
        bm = -(-M // 16) * 16
        bn, bk = DECODE_TILE
    else:
        bm, bn, bk = LARGE_TILE
    blocks = -(-M // bm) * -(-N // bn)
    k_tiles = max(1, -(-K // bk))
    want = max(1, min(-(-2 * n_sm // blocks), GEMM_SPLIT_MAX,
                      k_tiles // 4))
    tiles = -(-k_tiles // want)
    return GemmPlan(bm, bn, bk, -(-k_tiles // tiles), tiles)


def w8a16_supported(in_features: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes weights of ``in_features`` columns against
    activations of ``dtype``: bf16 rows are copied 16 bytes at a time
    (K % 16 == 0); the f32 instance takes any K."""
    if dtype == torch.float32:
        return in_features >= 1
    return dtype == torch.bfloat16 and in_features % 16 == 0


def w8a16_gemm_plain(x: torch.Tensor, q: torch.Tensor,
                     s: torch.Tensor) -> torch.Tensor:
    """The reference's expression: the int8 weight in x's dtype, the
    product in x's dtype, times the scales in x's dtype."""
    return F.linear(x, q.to(x.dtype)) * s.to(x.dtype)


_SM_COUNT: Dict[int, int] = {}
_TICKETS: Dict[int, torch.Tensor] = {}


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _fn():
    from generativeaiexamples_tpu_torch.ops.cuda import build
    f = build.load("w8a16_gemm").gk_w8a16_gemm
    f.argtypes = _ARGS
    f.restype = ctypes.c_int
    return f


def w8a16_gemm(x: torch.Tensor, q: torch.Tensor,
               s: torch.Tensor) -> torch.Tensor:
    """``(x @ q.T rounded to x's dtype) * s`` for x (..., K) bf16/f32, q
    (N, K) int8, s (N,) f32; returns (..., N) in x's dtype. CPU tensors
    take the plain version."""
    if not x.is_cuda:
        return w8a16_gemm_plain(x, q, s)
    N, K = q.shape
    if x.dtype not in _DTYPES or q.dtype != torch.int8 \
            or s.dtype != torch.float32:
        raise ValueError(f"w8a16_gemm takes bf16/f32 x, int8 q and f32 s, "
                         f"got {x.dtype}, {q.dtype}, {s.dtype}")
    if x.shape[-1] != K or s.shape != (N,):
        raise ValueError(f"w8a16_gemm: x {tuple(x.shape)}, q {tuple(q.shape)}"
                         f", s {tuple(s.shape)} do not agree")
    if not w8a16_supported(K, x.dtype):
        raise ValueError(f"w8a16_gemm: K={K} outside the kernel's limits for "
                         f"{x.dtype} (bf16 needs K % 16 == 0)")
    if not (q.device == x.device == s.device):
        raise ValueError("w8a16_gemm: x, q, s on different devices")
    if not (q.is_contiguous() and s.is_contiguous()) or q.data_ptr() % 16:
        raise ValueError("w8a16_gemm: q and s must be contiguous, q 16-byte "
                         "aligned (the kernel copies 16 bytes at a time)")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    M = x2.shape[0]
    dev = x.device
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    if M == 0:
        return y.reshape(*lead, N)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    if x.dtype == torch.float32:
        plan = GemmPlan(0, 0, 0, 1, 1)
    else:
        plan = gemm_plan(M, N, K, _SM_COUNT[idx])
    part = tickets = None
    if plan.splits > 1:
        part = torch.empty(plan.scratch_bytes(M, N) // 4,
                           dtype=torch.float32, device=dev)
        cells = -(-M // plan.bm) * -(-N // plan.bn)
        tickets = _TICKETS.get(idx)
        if tickets is None or tickets.numel() < cells:
            tickets = torch.zeros(cells, dtype=torch.int32, device=dev)
            _TICKETS[idx] = tickets
    rc = _fn()(_DTYPES[x.dtype], _ptr(x2), _ptr(q), _ptr(s), _ptr(y), M, N,
               K, plan.bm, plan.bn, plan.bk, plan.splits, plan.tiles,
               _ptr(part), _ptr(tickets),
               ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"w8a16_gemm kernel launch failed: CUDA error {rc}")
    LAUNCHES["w8a16_gemm"] += 1
    return y.reshape(*lead, N)
