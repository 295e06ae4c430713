"""StarCoder2-family configs and the HF import.

Port of ``generativeaiexamples_tpu/models/starcoder2.py``. The
architecture is a set of :class:`~.llama.LlamaConfig` knobs, so the paged
engine, the dense-cache API, int8 weights and LoRA serve it through
``models/llama.py``:

  * ``norm="layernorm"``: LayerNorm with an affine bias (not RMSNorm);
  * ``use_bias=True``: biased q/k/v/o and MLP projections;
  * ``mlp="plain"``: the ungated c_fc -> gelu_tanh -> c_proj MLP
    (``w_up``/``w_down``);
  * ``sliding_window``: 4,096-token windowed attention. The plain
    attention of every path masks it; the hand-written kernels are
    full-causal, so on CUDA a windowed config raises until the window is
    inside them (ROADMAP A.12).

:func:`params_from_hf` maps an HF ``Starcoder2ForCausalLM`` state dict
through :func:`.llama.params_from_hf` with StarCoder2's names, biases and
norm biases included.
"""

from __future__ import annotations

from typing import Dict

import torch

from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.models.llama import LlamaConfig, Params


def starcoder2_3b() -> LlamaConfig:
    return LlamaConfig(
        vocab_size=49152, dim=3072, n_layers=30, n_heads=24, n_kv_heads=2,
        hidden_dim=12288, head_dim=128, rope_theta=999999.4420358813,
        norm_eps=1e-5, tie_embeddings=True, hidden_act="gelu_tanh",
        norm="layernorm", use_bias=True, mlp="plain", sliding_window=4096)


def starcoder2_7b() -> LlamaConfig:
    return LlamaConfig(
        vocab_size=49152, dim=4608, n_layers=32, n_heads=36, n_kv_heads=4,
        hidden_dim=18432, head_dim=128, rope_theta=1e6, norm_eps=1e-5,
        tie_embeddings=True, hidden_act="gelu_tanh", norm="layernorm",
        use_bias=True, mlp="plain", sliding_window=4096)


def tiny(vocab_size: int = 256) -> LlamaConfig:
    """Test-scale StarCoder2-shaped config (f32, window 16)."""
    return LlamaConfig(
        vocab_size=vocab_size, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        hidden_dim=128, head_dim=16, rope_theta=10000.0,
        tie_embeddings=True, dtype="float32", hidden_act="gelu_tanh",
        norm="layernorm", use_bias=True, mlp="plain", sliding_window=16)


# HF Starcoder2ForCausalLM names of a layer's leaves, under
# "model.layers.{i}."
HF_LAYER_KEYS = {
    "attn_norm": "input_layernorm.weight",
    "attn_norm_b": "input_layernorm.bias",
    "wq": "self_attn.q_proj.weight", "wq_b": "self_attn.q_proj.bias",
    "wk": "self_attn.k_proj.weight", "wk_b": "self_attn.k_proj.bias",
    "wv": "self_attn.v_proj.weight", "wv_b": "self_attn.v_proj.bias",
    "wo": "self_attn.o_proj.weight", "wo_b": "self_attn.o_proj.bias",
    "mlp_norm": "post_attention_layernorm.weight",
    "mlp_norm_b": "post_attention_layernorm.bias",
    "w_up": "mlp.c_fc.weight", "w_up_b": "mlp.c_fc.bias",
    "w_down": "mlp.c_proj.weight", "w_down_b": "mlp.c_proj.bias",
}


def params_from_hf(state: Dict[str, torch.Tensor], cfg: LlamaConfig,
                   device=None, quant: str = "none") -> Params:
    """Map an HF ``Starcoder2ForCausalLM`` state dict into the llama
    layout (no transpose: HF keeps (out, in) as the port does); biases and
    norm biases are read beside their weights, and ``quant="int8"``
    quantizes the matrices only."""
    return llama.params_from_hf(state, cfg, device=device, quant=quant,
                                hf_names=HF_LAYER_KEYS)
