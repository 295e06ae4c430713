"""The port's sampling kernel: Gumbel-argmax over threefry draws.

``gumbel_argmax(keys, logits)`` draws one token per row as
``jax.random.categorical`` does under ``jax.vmap`` (one raw threefry key a
row): the first-index argmax of each row's logits plus JAX's Gumbel noise.
It is the counterpart of that XLA fusion in the reference's
``sample_logits_per_slot`` (``generativeaiexamples_tpu/ops/sampling.py``),
not of a Pallas kernel. The kernel is CUDA C++ for ``sm_90a``
(``csrc/gumbel_argmax.cu``: what bounds it and what its design does about
that are written there), built by :mod:`.build` and bound with ``ctypes``.

Its plain version is :func:`generativeaiexamples_tpu_torch.ops.threefry.
categorical`; the wrapper takes it only for logits on the CPU. For CUDA
tensors it launches the kernel or raises. Each launch adds one to
``launch_counts()["gumbel_argmax"]``.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from generativeaiexamples_tpu_torch.ops import threefry
from generativeaiexamples_tpu_torch.ops.cuda.build import LAUNCHES

THREADS = 256        # csrc THREADS: a split's entries are a multiple of it
BLOCKS_PER_SM = 4    # splits aim at this many blocks per SM over all rows

_SM_COUNT: Dict[int, int] = {}
_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
         + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)
_BITS_ARGS = ([ctypes.c_void_p] + [ctypes.c_int] * 2
              + [ctypes.c_void_p] * 2)


def split_plan(rows: int, vocab: int, n_sm: int):
    """(splits, entries a split) of each row, from shapes only: about
    ``BLOCKS_PER_SM`` blocks per SM over all rows, each split a multiple of
    ``THREADS`` entries, together covering the row."""
    per_row = max(1, -(-BLOCKS_PER_SM * n_sm // max(1, rows)))
    seg = -(-vocab // per_row)
    seg = max(THREADS, -(-seg // THREADS) * THREADS)
    return -(-vocab // seg), seg


def _fn(name: str, argtypes):
    from generativeaiexamples_tpu_torch.ops.cuda import build
    f = getattr(build.load("gumbel_argmax"), name)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def _keys_on(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    R = logits.shape[0]
    if keys.shape != (R, 2) or keys.device != logits.device:
        raise ValueError(f"gumbel_argmax: keys must be ({R}, 2) on "
                         f"{logits.device}, got {tuple(keys.shape)} on "
                         f"{keys.device}")
    return keys.to(torch.int64).contiguous()


def gumbel_argmax(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row: ``argmax(logits[r] + gumbel(keys[r]))``, the first
    index on ties. keys: (R, 2) int64 raw threefry keys (uint32 words);
    logits: (R, V) float32 with contiguous entries (masked entries -inf).
    Returns (R,) int32. CPU tensors take the plain version."""
    if logits.dim() != 2:
        raise ValueError(f"gumbel_argmax takes (R, V) logits, got "
                         f"{tuple(logits.shape)}")
    if not logits.is_cuda:
        return threefry.categorical(keys, logits)
    if logits.dtype != torch.float32 or logits.stride(1) != 1:
        raise ValueError(f"gumbel_argmax takes float32 logits with "
                         f"contiguous entries, got {logits.dtype} strides "
                         f"{logits.stride()}")
    R, V = logits.shape
    if R > 65535 or V >= 2 ** 31:
        raise ValueError(f"gumbel_argmax: {R} rows of {V} outside the "
                         f"kernel's grid")
    keys = _keys_on(keys, logits)
    dev = logits.device
    if dev.index not in _SM_COUNT:
        _SM_COUNT[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    splits, seg = split_plan(R, V, _SM_COUNT[dev.index])
    best = torch.empty((R,), dtype=torch.int64, device=dev)
    out = torch.empty((R,), dtype=torch.int32, device=dev)
    rc = _fn("gk_gumbel_argmax", _ARGS)(
        ctypes.c_void_p(keys.data_ptr()), ctypes.c_void_p(logits.data_ptr()),
        R, V, logits.stride(0), splits, seg, ctypes.c_void_p(best.data_ptr()),
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"gumbel_argmax kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["gumbel_argmax"] += 1
    return out


def threefry_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """The kernel library's threefry bits of counters 0..n-1 under each
    (R, 2) key on the card, as (R, n) int64 (uint32 values): the check of
    the generator alone against :func:`threefry.random_bits`. Not a
    serving path, and not counted."""
    if not keys.is_cuda:
        raise ValueError("threefry_bits runs the kernel library: CUDA keys")
    keys = keys.to(torch.int64).contiguous()
    R = keys.shape[0]
    out = torch.empty((R, n), dtype=torch.int32, device=keys.device)
    rc = _fn("gk_threefry_bits", _BITS_ARGS)(
        ctypes.c_void_p(keys.data_ptr()), R, n,
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(keys.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"threefry_bits launch failed: CUDA error {rc}")
    return out.to(torch.int64) & threefry.MASK
