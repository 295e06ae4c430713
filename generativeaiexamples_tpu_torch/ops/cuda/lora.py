"""The port's per-row LoRA kernel: the adapter update of one projection.

``lora_apply(y, x, a, b, slots)`` adds, into the projection's output y in
place, each row's low-rank update ``round(round(x . a[s]^T) . b[s]^T)``
(``s`` the row's adapter slot; slot 0 rows are neither read nor written),
the counterpart of the XLA program of the reference's ``_maybe_lora``
(``generativeaiexamples_tpu/models/llama.py:271-303``), not of a Pallas
kernel. The kernel is CUDA C++ for ``sm_90a`` (``csrc/lora.cu``: what
bounds it and its design are written there), built by :mod:`.build` and
bound with ``ctypes``.

Its plain version is ``ops/lora.py`` ``lora_apply_plain``, which
``ops.lora.lora_apply`` takes for CPU tensors; this wrapper takes CUDA
tensors only, launches the kernel or raises, and adds one to
``launch_counts()["lora"]`` a launch. :func:`lora_supported` is the
support predicate the engine checks when an adapter is registered, and
:func:`lora_plan` the output tiles of a launch (from shapes only).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from generativeaiexamples_tpu_torch.ops.cuda.build import LAUNCHES

ROWS = 16            # rows a block's tile (csrc ROWS)
MAX_RANK = 64
# 16-byte vectors of the working type: the contraction depth and the rank
# are whole vectors
VECTOR = {torch.float32: 4, torch.bfloat16: 8}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
         + [ctypes.c_void_p])
_LIB = []
_SMS: Dict[int, int] = {}


def _lib():
    if not _LIB:
        from generativeaiexamples_tpu_torch.ops.cuda import build
        lib = build.load("lora")
        lib.gk_lora_apply.argtypes = _ARGS
        lib.gk_lora_apply.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def supported_ranks(dtype: torch.dtype) -> Tuple[int, ...]:
    """The ranks the kernel takes for ``dtype``: whole 16-byte vectors up to
    ``MAX_RANK``."""
    v = VECTOR.get(dtype)
    return tuple(range(v, MAX_RANK + 1, v)) if v else ()


def lora_supported(rank: int, in_features: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes adapters of ``rank`` on a projection of
    ``in_features`` inputs in ``dtype`` (bf16 or f32): the rank and the
    contraction depth whole 16-byte vectors, the rank at most 64."""
    v = VECTOR.get(dtype)
    return bool(v) and rank in supported_ranks(dtype) and in_features % v == 0


def lora_plan(T: int, O: int, n_sm: int) -> int:
    """Output columns a block, from shapes only: enough column tiles that
    the grid holds about two blocks an SM (tiles of at least 256 columns),
    so a few decode rows still spread over the card while prefill row
    tiles each cover a long stretch of columns."""
    row_tiles = -(-T // ROWS)
    tiles = max(1, min(-(-O // 256), -(-2 * n_sm // row_tiles)))
    return -(-O // tiles)


def _n_sm(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def lora_apply(y: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, slots: Optional[torch.Tensor]
               ) -> torch.Tensor:
    """One launch: ``y += round(round(x . a[s]^T) . b[s]^T)`` in place for
    every row whose slot is not 0, and returns y. x (B, S, K) and y (B, S,
    O) contiguous, bf16 or f32 alike; stacked factors a (N, r, K), b (N, O,
    r) with slots (B,) int32 (row (i, j) takes slots[i]); or a global
    adapter a (r, K), b (O, r) with slots None (every row). Raises on
    anything else, and on a failed launch."""
    if not y.is_cuda:
        raise ValueError(f"lora_apply takes CUDA tensors, got {y.device}")
    stacked = a.dim() == 3
    if stacked != (slots is not None):
        raise ValueError("lora_apply: stacked factors take slots, a global "
                         "adapter none")
    if not stacked:
        a, b = a[None], b[None]
    N, r, K = a.shape
    O = y.shape[-1]
    dtype = y.dtype
    if (x.dtype != dtype or a.dtype != dtype or b.dtype != dtype
            or dtype not in _DTYPES):
        raise ValueError(f"lora_apply takes bf16 or f32 x, y, a and b alike, "
                         f"got {x.dtype}, {y.dtype}, {a.dtype}, {b.dtype}")
    if (x.dim() != 3 or y.shape[:2] != x.shape[:2] or x.shape[-1] != K
            or tuple(b.shape) != (N, O, r)):
        raise ValueError(f"lora_apply: x {tuple(x.shape)}, y "
                         f"{tuple(y.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} do not agree")
    if not lora_supported(r, K, dtype):
        raise ValueError(f"lora_apply: rank {r} with {K} inputs outside the "
                         f"kernel's limits for {dtype} (ranks "
                         f"{supported_ranks(dtype)}, inputs whole 16-byte "
                         f"vectors)")
    ts = (x, y, a, b) + ((slots,) if stacked else ())
    if any(t.device != y.device for t in ts):
        raise ValueError("lora_apply: tensors on different devices")
    if (not all(t.is_contiguous() for t in ts)
            or any(t.data_ptr() % 16 for t in (x, a, b))):
        raise ValueError("lora_apply: tensors must be contiguous, x, a and b "
                         "16-byte aligned")
    if stacked and (slots.dtype != torch.int32
                    or tuple(slots.shape) != (x.shape[0],)):
        raise ValueError(f"lora_apply: slots must be ({x.shape[0]},) int32, "
                         f"got {tuple(slots.shape)} {slots.dtype}")
    Bn, S = x.shape[:2]
    T = Bn * S
    if T == 0:
        return y
    dev = y.device
    rc = _lib().gk_lora_apply(
        _DTYPES[dtype], x.data_ptr(), a.data_ptr(), b.data_ptr(),
        y.data_ptr(), slots.data_ptr() if stacked else None, T, K, O, r, S,
        lora_plan(T, O, _n_sm(dev)),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lora_apply kernel launch failed: CUDA error {rc}")
    LAUNCHES["lora"] += 1
    return y
