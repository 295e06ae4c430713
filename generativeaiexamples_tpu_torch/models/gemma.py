"""Gemma-family decoder LM: config factories and the HF import.

Port of ``generativeaiexamples_tpu/models/gemma.py``. Gemma-1 is the llama
block with three deltas, each a :class:`~.llama.LlamaConfig` knob or a fold
at import time, so the paged engine, the dense-cache API and LoRA serve it
through ``models/llama.py`` unchanged:

  * GeGLU MLP: tanh-approximate GELU gating (``hidden_act="gelu_tanh"``);
  * embedding scaling: hidden states times sqrt(dim) after the lookup
    (``embed_scale``, rounded to the model dtype first);
  * RMSNorm offset: Gemma computes ``x_norm * (1 + w)``;
    :func:`params_from_hf` folds the +1 into the stored weights, so the
    shared ``rms_norm`` applies unchanged (random init draws ones, the
    folded identity).

Gemma ties its embeddings (no ``lm_head``) and has ``head_dim * n_heads !=
dim`` (2B: dim 2,048, 8 heads of 256), which the llama layout takes. Its
heads of 256 are instances of every attention kernel
(``ops/cuda/attention.py`` ``HEAD_DIMS``), and its 256,000-entry
vocabulary is within ``sample_slots``' ``MAX_VOCAB``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.models.llama import LlamaConfig, Params


def gemma_2b() -> LlamaConfig:
    return LlamaConfig(
        vocab_size=256000, dim=2048, n_layers=18, n_heads=8, n_kv_heads=1,
        hidden_dim=16384, head_dim=256, rope_theta=10000.0, norm_eps=1e-6,
        tie_embeddings=True, hidden_act="gelu_tanh",
        embed_scale=math.sqrt(2048.0))


def gemma_7b() -> LlamaConfig:
    return LlamaConfig(
        vocab_size=256000, dim=3072, n_layers=28, n_heads=16, n_kv_heads=16,
        hidden_dim=24576, head_dim=256, rope_theta=10000.0, norm_eps=1e-6,
        tie_embeddings=True, hidden_act="gelu_tanh",
        embed_scale=math.sqrt(3072.0))


def codegemma_7b() -> LlamaConfig:
    """CodeGemma shares the 7B architecture (code-specialised weights)."""
    return gemma_7b()


def tiny(vocab_size: int = 256) -> LlamaConfig:
    """Deterministic test-scale Gemma (f32, head_dim 16, MQA 4/1)."""
    return LlamaConfig(
        vocab_size=vocab_size, dim=64, n_layers=2, n_heads=4, n_kv_heads=1,
        hidden_dim=128, head_dim=16, rope_theta=10000.0, norm_eps=1e-6,
        tie_embeddings=True, hidden_act="gelu_tanh",
        embed_scale=math.sqrt(64.0), dtype="float32")


def params_from_hf(state: Dict[str, torch.Tensor], cfg: LlamaConfig,
                   device=None, quant: str = "none") -> Params:
    """Map an HF ``GemmaForCausalLM`` state dict into the llama layout.

    The tensor names are llama's, so :func:`.llama.params_from_hf` renames
    (and, with ``quant="int8"``, quantizes the matrices); the Gemma step is
    folding the RMSNorm ``(1 + w)`` offset into every norm weight, added
    in the norm's own dtype as the reference adds ``jnp.asarray(1.0,
    dtype)``.
    """
    params = llama.params_from_hf(state, cfg, device=device, quant=quant)

    def fold(w: torch.Tensor) -> torch.Tensor:
        return w + torch.tensor(1.0, dtype=w.dtype, device=w.device)

    for layer in params["layers"]:
        layer["attn_norm"] = fold(layer["attn_norm"])
        layer["mlp_norm"] = fold(layer["mlp_norm"])
    params["final_norm"] = fold(params["final_norm"])
    return params
