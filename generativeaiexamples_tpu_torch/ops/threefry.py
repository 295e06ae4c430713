"""Threefry-2x32 keys and draws, bit-equal to ``jax.random``.

The port's own copy of what the serving engine uses from ``jax.random``
(raw ``threefry2x32`` keys, JAX's default *partitionable* bit layout):
``prng_key`` (``jax.random.PRNGKey`` of an int32 seed), ``fold_in``,
``random_bits`` (32-bit), ``uniform``, ``gumbel`` (JAX's "low" mode) and
``categorical`` (Gumbel plus the first-index argmax). Keys, bits and
uniforms equal JAX's bit for bit; ``gumbel`` takes two float32 logs,
which may differ from XLA's by a few ulps.

Integers are uint32 values held in int64 tensors and masked to 32 bits
after every add and shift (torch has no uint32 add on the CPU). A key is
a ``(..., 2)`` int64 tensor (``k1``, ``k2``), on whatever device the
caller uses; nothing here syncs with the host. The CUDA kernel
``csrc/sample_slots.cu`` computes ``fold_in`` and :func:`categorical` for
every row of a sampling call; this module is the plain version of both.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

MASK = 0xFFFFFFFF
# the rotation schedule and the key-schedule parity of Threefry-2x32
# (Salmon et al. 2011), as jax._src.prng._threefry2x32_lowering has them
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA
FLOAT32_TINY = 1.1754943508222875e-38     # np.finfo(np.float32).tiny

Seed = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block function, 20 rounds, on broadcastable
    uint32-in-int64 tensors: key (k1, k2), counter (x0, x1)."""
    ks = (k1, k2, k1 ^ k2 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed: Seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` of an int32 seed (or an int tensor of
    seeds, as ``jax.vmap(PRNGKey)`` over an int32 array): ``(0, seed mod
    2**32)``, since JAX's shift of an int32 seed by 32 bits gives 0 and
    its low word is the seed's two's complement. Seeds outside int32
    raise, as JAX's int32 conversion does. Returns (..., 2) int64."""
    s = torch.as_tensor(seed, device=device)
    if s.dtype.is_floating_point or s.dtype == torch.bool:
        raise TypeError(f"PRNG key seed must be an integer, got {s.dtype}")
    s = s.to(torch.int64)
    if s.device.type == "cpu" and s.numel() and bool(
            ((s < -2 ** 31) | (s >= 2 ** 31)).any()):
        raise ValueError("PRNG key seed outside int32")
    return torch.stack([torch.zeros_like(s), s & MASK], dim=-1)


def fold_in(keys: torch.Tensor, data: Seed) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` per row: Threefry of the key over
    the counter ``(0, data mod 2**32)``. keys (..., 2); data broadcasts
    against keys[..., 0]."""
    d = torch.as_tensor(data, device=keys.device).to(torch.int64) & MASK
    k1, k2 = keys[..., 0], keys[..., 1]
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    y0, y1 = torch.broadcast_tensors(y0, y1)
    return torch.stack([y0, y1], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` per key in partitionable mode:
    counter i is the 64-bit index split (hi, lo) = (0, i), and the bits
    are the two output words xored. keys (..., 2) -> (..., n) int64."""
    if n >= 2 ** 32:
        raise ValueError("more than 2**32 counters a key")
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    k1, k2 = keys[..., 0, None], keys[..., 1, None]
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(i), i)
    return y0 ^ y1


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` per key:
    the top 23 bits as a mantissa of [1, 2), minus 1, scaled, then at least
    ``minval``. (..., n) float32."""
    bits = random_bits(keys, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # filled on the device (no host copy), so a CUDA graph can capture it
    lo = torch.full((), minval, dtype=torch.float32, device=keys.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=keys.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` per key, "low" mode:
    ``-log(-log(u))`` of a uniform on [tiny, 1)."""
    u = uniform(keys, n, FLOAT32_TINY, 1.0)
    return -torch.log(-torch.log(u))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, row)`` for each row of (R, V) float32
    ``logits`` with its own (R, 2) key: the argmax of Gumbel noise plus the
    logits, the first index on ties (a ``-inf`` entry is never drawn while
    a row has a finite one). Returns (R,) int32."""
    if logits.dim() != 2 or keys.shape != (logits.shape[0], 2):
        raise ValueError(f"categorical takes keys (R, 2) and logits (R, V), "
                         f"got {tuple(keys.shape)}, {tuple(logits.shape)}")
    g = gumbel(keys, logits.shape[1])
    return torch.argmax(g + logits.float(), dim=-1).to(torch.int32)
