"""Normalization, activation and rotary primitives (plain PyTorch).

Port of ``generativeaiexamples_tpu/ops/layers.py``. Moments and the rotary
mix are taken in float32 whatever the carrier dtype, as there; the tanh
GELU runs in the carrier dtype, as ``jax.nn.gelu`` does there.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm; the moment in f32, the result in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with affine weight and bias (StarCoder2 blocks): the
    moments in f32, weight and bias applied in f32, the result in x's
    dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * weight.float() + bias.float()).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * (1.0 / (1.0 + torch.exp(-xf)))).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` as the reference computes it:
    op for op in x's dtype, its constants rounded to that dtype (in bf16
    sqrt(2/pi) is 0.796875 and 0.044715 is 0.044677734375), so a bf16
    GeGLU rounds where the reference's does, not once from f32."""
    c = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)
    inner = x + c(0.044715) * (x * x * x)
    return x * (c(0.5) * (c(1.0) + torch.tanh(c(math.sqrt(2.0 / math.pi))
                                               * inner)))


def activate(x: torch.Tensor, act: str) -> torch.Tensor:
    """Ungated activation by name."""
    if act == "silu":
        return silu(x)
    if act == "gelu_tanh":
        return gelu_tanh(x)
    raise ValueError(f"unknown activation {act!r}")


def glu(gate: torch.Tensor, up: torch.Tensor,
        act: str = "silu") -> torch.Tensor:
    """Gated linear unit: act(gate) * up ("silu" is llama's SwiGLU)."""
    if act not in ("silu", "gelu_tanh"):
        raise ValueError(f"unknown gated activation {act!r}")
    return activate(gate, act) * up


def rotary_embedding(positions: torch.Tensor, head_dim: int,
                     theta: float = 500000.0,
                     scaling: Optional[Tuple[float, float, float, int]] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (..., S, head_dim) for ``positions`` (..., S), HF
    split-half layout. ``scaling`` is the llama3 rule ``(factor,
    low_freq_factor, high_freq_factor, original_max_position_embeddings)``.
    """
    half = head_dim // 2
    dev = positions.device
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=dev) / half))
    if scaling is not None:
        factor, low_f, high_f, original_max = scaling
        wavelen = 2.0 * math.pi / freqs
        low_wavelen = original_max / low_f
        high_wavelen = original_max / high_f
        smooth = (original_max / wavelen - low_f) / (high_f - low_f)
        mid = (1.0 - smooth) * freqs / factor + smooth * freqs
        freqs = torch.where(wavelen > low_wavelen, freqs / factor,
                            torch.where(wavelen < high_wavelen, freqs, mid))
    angles = positions.float()[..., None] * freqs
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding, split-half convention. x: (..., S, H, HD);
    cos/sin: (..., S, HD), broadcast over heads."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.float() * cos[..., None, :]
            + rotated.float() * sin[..., None, :]).to(x.dtype)
