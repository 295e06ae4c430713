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
:func:`w8a16_supported` that the engine checks at init, the tile plan
:func:`gemm_plan` (from shapes only), the weight tensor-map cache
(:func:`weight_map_key`) and the launch counts,
``launch_counts()["w8a16_gemm"]`` and, by activation rows,
``gemm_launches_by_rows()``. The wrapper takes the plain version only for
CPU tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from generativeaiexamples_tpu_torch.ops.cuda.build import GEMM_ROWS, LAUNCHES

# contraction depth of a ring stage: decode tiles (whole 128-byte weight
# row segments), prefill tiles
SPLIT_DEPTH, WIDE_DEPTH = 128, 64
CLUSTER_SIZES = (1, 2, 4, 8)   # CTAs a cluster (the depth split)
# a decode tile's fixed cost in stages of one rank: filling the ring and
# adding the partials across the cluster
TILE_COST = 5
# clusters of each size of the kernel the H100 SXM runs at once
# (cudaOccupancyMaxActiveClusters, chip_smoke.py's build phase): clusters
# of 4 or 8 reach 120 of its 132 SMs
H100_CLUSTER_SLOTS = {1: 132, 2: 66, 4: 30, 8: 15}
# activation rows of the instances (csrc GK_SPLIT_ROWS and the prefill
# tiles): decode tiles for M <= 128, prefill tiles above
SPLIT_ROWS = (8, 16, 24, 32, 40, 48, 56, 64, 72, 80, 96, 112, 128)
WIDE_ROWS = (128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
         + [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_ulonglong]
         + [ctypes.c_void_p])
_MAP_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


class GemmPlan(NamedTuple):
    """Output tiles of ``rows`` weight rows (y's columns) by ``bn``
    activation rows (wgmma's N), ``m_tiles`` x ``n_tiles`` of them, walked
    by ``clusters`` clusters of ``cluster`` CTAs. ``split``: a decode tile
    (64 rows, stages 128 deep, the two consumer warpgroups on alternate
    stages); rank r of a cluster takes the stages [r * ks_per_rank, (r +
    1) * ks_per_rank) of the contraction, and the f32 partials are added
    across the cluster through distributed shared memory. Else a prefill
    tile (128 rows, 64 a warpgroup, stages 64 deep), no cluster,
    ``ks_per_rank`` every stage."""
    split: bool
    bn: int
    m_tiles: int
    n_tiles: int
    cluster: int
    clusters: int
    ks_per_rank: int

    @property
    def rows(self) -> int:
        """Weight rows a tile."""
        return 64 if self.split else 128

    @property
    def depth(self) -> int:
        """Contraction depth of a stage."""
        return SPLIT_DEPTH if self.split else WIDE_DEPTH

    @property
    def ctas(self) -> int:
        return self.cluster * self.clusters

    @property
    def instance(self) -> str:
        return f"{'split' if self.split else 'wide'}_{self.rows}x{self.bn}"


def gemm_plan(M: int, N: int, K: int, n_sm: int,
              cluster_slots: Optional[Dict[int, int]] = None) -> GemmPlan:
    """The tile plan, from shapes only (and the card's SM count and
    ``cluster_slots``: how many clusters of each size it runs at once,
    ``n_sm // size`` when not given). M <= 128 (decode): one activation
    tile of M rounded up to an instance's rows, 64 weight rows a tile, and
    the contraction split over the cluster size (1, 2, 4 or 8 CTAs, each
    rank at least one stage) whose slowest CTA does the least: rounds of
    tiles times (stages a rank + ``TILE_COST``), the smaller cluster on a
    tie. Larger M (prefill): tiles of 128 weight rows by 256 activation
    rows where that still gives two tiles an SM, else by 128, no cluster.
    The persistent grid never holds more clusters than run at once."""
    slots = cluster_slots or {c: max(1, n_sm // c) for c in CLUSTER_SIZES}
    if M <= SPLIT_ROWS[-1]:
        ks = max(1, -(-K // SPLIT_DEPTH))
        bn = next(r for r in SPLIT_ROWS if r >= M)
        n_tiles = -(-N // 64)
        best = None
        for cluster in CLUSTER_SIZES:
            kpr = -(-ks // cluster)
            if cluster > 1 and (cluster - 1) * kpr >= ks:
                continue
            clusters = min(n_tiles, slots[cluster])
            cost = -(-n_tiles // clusters) * (kpr + TILE_COST)
            if best is None or cost < best[0]:
                best = (cost, cluster, clusters, kpr)
        _, cluster, clusters, kpr = best
        return GemmPlan(True, bn, 1, n_tiles, cluster, clusters, kpr)
    n_tiles = -(-N // 128)
    bn = WIDE_ROWS[1] if -(-M // WIDE_ROWS[1]) * n_tiles >= 2 * n_sm \
        else WIDE_ROWS[0]
    m_tiles = -(-M // bn)
    return GemmPlan(False, bn, m_tiles, n_tiles, 1,
                    min(m_tiles * n_tiles, slots[1]),
                    max(1, -(-K // WIDE_DEPTH)))


def rows_bucket(plan: GemmPlan, M: int) -> str:
    """The launch's key in ``gemm_launches_by_rows()``: a decode tile's
    rows ("m<=72"), or a prefill launch's rows ("m=4096")."""
    return f"m<={plan.bn}" if plan.split else f"m={M}"


def w8a16_supported(in_features: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes weights of ``in_features`` columns against
    activations of ``dtype``: bf16 rows are TMA boxes, whose row strides
    must be multiples of 16 bytes (K % 16 == 0: the int8 weight's); the
    f32 instance takes any K."""
    if dtype == torch.float32:
        return in_features >= 1
    return dtype == torch.bfloat16 and in_features % 16 == 0


def w8a16_gemm_plain(x: torch.Tensor, q: torch.Tensor,
                     s: torch.Tensor) -> torch.Tensor:
    """The reference's expression: the int8 weight in x's dtype, the
    product in x's dtype, times the scales in x's dtype."""
    return F.linear(x, q.to(x.dtype)) * s.to(x.dtype)


def weight_map_key(q: torch.Tensor, rows: int) -> Tuple:
    """The weight tensor-map cache's key: what the map encodes (the
    pointer, shape, strides, dtype and box rows), never the pointer alone
    (pointers are unique across the process's devices)."""
    return (q.data_ptr(), q.shape, q.stride(), q.dtype, rows)


_CARDS: Dict[int, Tuple[int, Dict[int, int]]] = {}
_PLANS: Dict[Tuple[int, int, int, int], GemmPlan] = {}
_PLANS_MAX = 4096
_WMAPS: Dict[Tuple, ctypes.Array] = {}
_WMAPS_MAX = 8192
_LIB = []


def _lib():
    if not _LIB:
        from generativeaiexamples_tpu_torch.ops.cuda import build
        lib = build.load("w8a16_gemm")
        lib.gk_w8a16_gemm.argtypes = _ARGS
        lib.gk_w8a16_gemm.restype = ctypes.c_int
        lib.gk_w8a16_weight_map.argtypes = _MAP_ARGS
        lib.gk_w8a16_weight_map.restype = ctypes.c_int
        lib.gk_w8a16_max_clusters.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.gk_w8a16_max_clusters.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def _card(idx: int) -> Tuple[int, Dict[int, int]]:
    """Device idx's SM count and cluster slots (the decode instance's),
    queried once."""
    if idx not in _CARDS:
        n_sm = torch.cuda.get_device_properties(idx).multi_processor_count
        slots = {}
        with torch.cuda.device(idx):
            for c in CLUSTER_SIZES:
                n = ctypes.c_int(0)
                rc = _lib().gk_w8a16_max_clusters(c, ctypes.byref(n))
                if rc != 0 or n.value < 1:
                    raise RuntimeError(f"w8a16_gemm: no slot for a cluster "
                                       f"of {c} (CUDA error {rc})")
                slots[c] = n.value
        _CARDS[idx] = (n_sm, slots)
    return _CARDS[idx]


def card_plan(M: int, N: int, K: int,
              device: Optional[torch.device] = None) -> GemmPlan:
    """The plan ``w8a16_gemm`` launches for bf16 x (M, K) on ``device``
    (the current one when not given)."""
    idx = torch.cuda.current_device() if device is None or \
        device.index is None else device.index
    plan = _PLANS.get((M, N, K, idx))
    if plan is None:
        if len(_PLANS) >= _PLANS_MAX:
            _PLANS.clear()
        plan = _PLANS[(M, N, K, idx)] = gemm_plan(M, N, K, *_card(idx))
    return plan


def _weight_map(q: torch.Tensor, rows: int) -> ctypes.Array:
    """q's TMA map with boxes of ``rows`` rows, encoded once."""
    key = weight_map_key(q, rows)
    wmap = _WMAPS.get(key)
    if wmap is None:
        if len(_WMAPS) >= _WMAPS_MAX:
            _WMAPS.clear()
        wmap = ctypes.create_string_buffer(128)
        rc = _lib().gk_w8a16_weight_map(q.data_ptr(), q.shape[0], q.shape[1],
                                        rows, wmap)
        if rc != 0:
            raise RuntimeError(f"w8a16_gemm: weight tensor map failed: CUDA "
                               f"error {rc}")
        _WMAPS[key] = wmap
    return wmap


def w8a16_gemm(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
               late_first_ns: int = 0) -> torch.Tensor:
    """``(x @ q.T rounded to x's dtype) * s`` for x (..., K) bf16/f32, q
    (N, K) int8, s (N,) f32; returns (..., N) in x's dtype. CPU tensors
    take the plain version. ``late_first_ns`` (0 in serving) runs the
    kernel's ring check, an instance for 72-row decode plans only: the
    loads of its first stage are issued last of the ring's first fill,
    that many ns after the others, and its barrier waits trap after 10 s
    instead of hanging."""
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
                         "aligned (TMA boxes)")
    flat = x.dim() == 2
    x2 = x if flat and x.is_contiguous() else x.reshape(-1, K).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    M = x2.shape[0]
    dev = x.device
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    if M == 0:
        return y if flat else y.reshape(*x.shape[:-1], N)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if x.dtype == torch.float32:
        rc = _lib().gk_w8a16_gemm(0, x2.data_ptr(), q.data_ptr(),
                                  s.data_ptr(), y.data_ptr(), M, N, K, None,
                                  0, 0, 1, 1, 1, 0, stream)
        bucket = None
    else:
        plan = card_plan(M, N, K, dev)
        rc = _lib().gk_w8a16_gemm(
            1, x2.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), M, N,
            K, ctypes.addressof(_weight_map(q, plan.rows)), plan.split,
            plan.bn, plan.cluster, plan.clusters, plan.ks_per_rank,
            int(late_first_ns), stream)
        bucket = rows_bucket(plan, M)
    if rc != 0:
        raise RuntimeError(f"w8a16_gemm kernel launch failed: CUDA error {rc}")
    LAUNCHES["w8a16_gemm"] += 1
    if bucket is not None:
        GEMM_ROWS[bucket] = GEMM_ROWS.get(bucket, 0) + 1
    return y if flat else y.reshape(*x.shape[:-1], N)
