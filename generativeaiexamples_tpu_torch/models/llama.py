"""Llama-3-family decoder LM in plain PyTorch.

Port of the dense-GLU Llama path of ``generativeaiexamples_tpu/models/
llama.py``: pre-norm blocks, RMSNorm, RoPE (HF split-half), GQA, SwiGLU.
Parameters are a plain dict of tensors, one dict per layer, with every
projection kept as ``nn.Linear`` stores it, (out, in), so the hot path is
``F.linear``. :func:`params_from_jax` carries the TPU package's pytree
(stacked ``(L, in, out)`` leaves as numpy arrays, or int8 ``(q, s)``
pairs) into this layout and is the one place that transposes. A Python
loop over layers takes the place of ``lax.scan``.

Int8 weights (``ops/quant.py``): any matrix may be a ``QTensor``; the
projections, the embedding gather and the unembedding go through the
quant seams (``quant.matmul``, ``quant.take``), as the reference's block
does, so one code path serves model-dtype and int8 weights.

The dense-cache model API is here too: :class:`KVCache` (k/v ``(L, B, T,
KV, HD)``), :func:`prefill` and :func:`decode_step`, whose attention is the
``flash_prefill`` and ``ragged_decode`` kernels unless ``attn_impl ==
"plain"`` asks for the plain :func:`mha_prefill`/:func:`mha_decode` (see
:func:`attention_kernels`). Like the paged passes they write the cache in
place.

:func:`params_from_hf` maps a HuggingFace ``LlamaForCausalLM`` state dict
(``models/hf_loader.py`` reads one from a checkpoint directory) into the
same layout: HF keeps projections as (out, in) too, so it only renames.

LoRA (``_maybe_lora`` there): every projection of a block takes the
low-rank update of ``ops/lora.py`` when an adapter tree names it, one
call for the projections that read one input (wq|wk|wv, wo,
w_gate|w_up, w_down), made after their base products. The dense API
(:func:`forward`, :func:`prefill`, :func:`decode_step`) takes a global
tree (``train/lora.py`` layout, leaves ``(L, r, in)`` / ``(L, out, r)``)
for every row; the paged passes (``engine/kv_cache.py``) also take the
engine's stacked slots ``(L, N, r, in)`` / ``(L, N, out, r)`` with each
batch row's slot in ``adapter_ix``. Either may come prepared
(``ops.lora.prepare``, as the engine keeps its resident tree), or is
prepared for the pass. Adapter leaves inside the *param* tree are refused
(:func:`params_from_jax`).

The Gemma family (``models/gemma.py``) rides this layout: GeGLU
(``hidden_act="gelu_tanh"``), the embedding scaled by ``embed_scale``,
tied embeddings and ``head_dim * n_heads != dim``.

The rest of the reference's block rides it too, as config knobs:
``norm="layernorm"`` (LayerNorm with a bias, ``*_norm_b`` leaves and
``final_norm_b``), ``use_bias`` (a bias after each projection's base
product and before its LoRA update, ``<name>_b`` leaves), ``mlp="plain"``
(the ungated ``w_up`` -> act -> ``w_down`` of StarCoder2,
``models/starcoder2.py``) and ``mlp="moe"`` (top-k routed GLU experts,
``ops/moe.py``: ``w_router`` (E, D) and the stacks ``w_gate``/``w_up``
(E, F, D) and ``w_down`` (E, D, F)). ``sliding_window`` masks the plain
attention of every path; the hand-written kernels are full-causal, so a
windowed config on CUDA raises (:func:`attention_kernels`, ROADMAP
A.12), and on the CPU it runs the plain windowed path, as the reference's
XLA path does.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from generativeaiexamples_tpu_torch.ops import lora as lora_ops
from generativeaiexamples_tpu_torch.ops import moe as moe_ops
from generativeaiexamples_tpu_torch.ops import quant as quant_ops
from generativeaiexamples_tpu_torch.ops.attention import (
    mha_decode, mha_prefill)
from generativeaiexamples_tpu_torch.ops.cuda import attention as kernels
from generativeaiexamples_tpu_torch.ops.layers import (
    activate, apply_rope, glu, layer_norm, rms_norm, rotary_embedding)

Params = Dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    hidden_dim: int = 14336
    head_dim: int = 128
    rope_theta: float = 500000.0
    # llama3 rope scaling (factor, low_freq_factor, high_freq_factor,
    # original_max_position_embeddings); None = plain RoPE
    rope_scaling: Optional[Tuple[float, float, float, int]] = None
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    hidden_act: str = "silu"
    # the token embedding's output scale (Gemma: sqrt(dim)), applied in the
    # model dtype
    embed_scale: float = 1.0
    # StarCoder2 knobs (models/starcoder2.py): "rms" | "layernorm" (with a
    # bias), biased projections, "glu" | "plain" (ungated w_up -> act ->
    # w_down) | "moe" (ops/moe.py), and the attention window (0 = full)
    norm: str = "rms"
    use_bias: bool = False
    mlp: str = "glu"
    sliding_window: int = 0
    # MoE knobs (mlp="moe"): top-k of n_experts routed GLU experts with
    # capacity_factor * k * tokens / n_experts slots each
    n_experts: int = 8
    n_experts_per_tok: int = 2
    capacity_factor: float = 1.25
    # "auto" | "kernel" | "plain": the attention of the paged passes and the
    # dense API (see attention_kernels)
    attn_impl: str = "auto"

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama3_70b() -> "LlamaConfig":
        return LlamaConfig(dim=8192, n_layers=80, n_heads=64, n_kv_heads=8,
                           hidden_dim=28672)

    @staticmethod
    def mixtral_8x7b() -> "LlamaConfig":
        """Mixtral-class sparse MoE: top-2 of 8 GLU experts a token."""
        return LlamaConfig(vocab_size=32000, dim=4096, n_layers=32,
                           n_heads=32, n_kv_heads=8, hidden_dim=14336,
                           rope_theta=1e6, mlp="moe", n_experts=8,
                           n_experts_per_tok=2)

    @staticmethod
    def tiny_moe(vocab_size: int = 300) -> "LlamaConfig":
        """:meth:`tiny` (f32) with the MLP swapped for top-2 of 4 routed
        experts."""
        return dataclasses.replace(LlamaConfig.tiny(vocab_size), mlp="moe",
                                   n_experts=4, n_experts_per_tok=2,
                                   capacity_factor=2.0)

    @staticmethod
    def tiny(vocab_size: int = 256) -> "LlamaConfig":
        """Deterministic test-scale config (f32, head_dim 16, GQA 4/2)."""
        return LlamaConfig(vocab_size=vocab_size, dim=64, n_layers=2,
                           n_heads=4, n_kv_heads=2, hidden_dim=128,
                           head_dim=16, rope_theta=10000.0,
                           tie_embeddings=True, dtype="float32")

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

MLPS = ("glu", "plain", "moe")
NORMS = ("rms", "layernorm")


def check_config(cfg: LlamaConfig) -> None:
    """The block knobs' values, and the reference's refusal of biases in
    an MoE block."""
    if cfg.mlp not in MLPS:
        raise ValueError(f"mlp must be one of {MLPS}, got {cfg.mlp!r}")
    if cfg.norm not in NORMS:
        raise ValueError(f"norm must be one of {NORMS}, got {cfg.norm!r}")
    if cfg.mlp == "moe" and cfg.use_bias:
        raise ValueError("mlp='moe' does not support use_bias")


def bias_widths(cfg: LlamaConfig) -> Dict[str, int]:
    """``<projection>_b`` leaf -> width, for ``use_bias`` configs."""
    D, F_ = cfg.dim, cfg.hidden_dim
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    widths = {"wq_b": q, "wk_b": kv, "wv_b": kv, "wo_b": D, "w_up_b": F_,
              "w_down_b": D}
    if cfg.mlp == "glu":
        widths["w_gate_b"] = F_
    return widths if cfg.use_bias else {}


def init_params(generator: torch.Generator, cfg: LlamaConfig,
                device=None, quant: str = "none") -> Params:
    """Random weights: scaled-normal fan-in init (normal / sqrt(fan_in)),
    norms at one, biases and norm biases at zero, drawn from ``generator``
    on ``device`` (the generator's device by default). ``quant="int8"``
    quantizes each matrix as soon as it is drawn (in the model dtype, so
    the result equals ``quant.quantize_params`` of the unquantized draw),
    so a model too large for the card in its dtype never holds more than
    one matrix unquantized: llama3-70b's largest, the (128,256, 8,192)
    embedding and head, for a moment in f32 (4.2 GB). An MoE block's
    router and expert stacks stay in the model dtype, as the reference's
    ``quantize_params`` leaves them."""
    check_config(cfg)
    device = torch.device(device or generator.device)
    D, H, KV, HD, F_ = (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                        cfg.hidden_dim)
    dt = cfg.torch_dtype
    if quant not in ("none", "", "int8"):
        raise ValueError(f"unknown quant mode {quant!r}; expected "
                         f"'none' or 'int8'")

    def normal(out_f, in_f):
        w = torch.randn((out_f, in_f), generator=generator,
                        dtype=torch.float32, device=device)
        w = w.mul_(1.0 / math.sqrt(in_f)).to(dt)
        return quant_ops.quantize(w) if quant == "int8" else w

    def ones(n):
        return torch.ones((n,), dtype=dt, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=device)

    layernorm = cfg.norm == "layernorm"
    params: Params = {"embed": normal(cfg.vocab_size, D),
                      "final_norm": ones(D), "layers": []}
    if layernorm:
        params["final_norm_b"] = zeros(D)
    for _ in range(cfg.n_layers):
        layer = {"attn_norm": ones(D),
                 "wq": normal(H * HD, D), "wk": normal(KV * HD, D),
                 "wv": normal(KV * HD, D), "wo": normal(D, H * HD),
                 "mlp_norm": ones(D)}
        if cfg.mlp == "moe":
            layer.update(moe_ops.init_moe_params(
                generator, D, F_, cfg.n_experts, dt, device))
        else:
            if cfg.mlp == "glu":
                layer["w_gate"] = normal(F_, D)
            layer.update(w_up=normal(F_, D), w_down=normal(D, F_))
        layer.update({name: zeros(w) for name, w in bias_widths(cfg).items()})
        if layernorm:
            layer.update(attn_norm_b=zeros(D), mlp_norm_b=zeros(D))
        params["layers"].append(layer)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(cfg.vocab_size, D)
    return params


_MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def layer_keys(cfg: LlamaConfig) -> Tuple[str, ...]:
    """The leaves of one layer of ``cfg``, in the block's order."""
    check_config(cfg)
    keys = ["attn_norm", "wq", "wk", "wv", "wo", "mlp_norm"]
    if cfg.mlp == "moe":
        keys += ["w_router", "w_gate", "w_up", "w_down"]
    else:
        keys += (["w_gate"] if cfg.mlp == "glu" else []) + ["w_up", "w_down"]
    keys += list(bias_widths(cfg))
    if cfg.norm == "layernorm":
        keys += ["attn_norm_b", "mlp_norm_b"]
    return tuple(keys)


def _qpair(leaf):
    """(q, s) numpy arrays of a quantized leaf: a ``(q, s)`` pair, or an
    object with ``q`` and ``s`` (the reference's QTensor with numpy
    leaves); None for a plain array."""
    if isinstance(leaf, (tuple, list)) and len(leaf) == 2:
        return np.asarray(leaf[0]), np.asarray(leaf[1], np.float32)
    if hasattr(leaf, "q") and hasattr(leaf, "s"):
        return np.asarray(leaf.q), np.asarray(leaf.s, np.float32)
    return None


def params_from_jax(tree: Dict[str, Any], cfg: LlamaConfig,
                    device=None) -> Params:
    """Carry the TPU package's parameter pytree into this layout.

    ``tree`` mirrors ``models/llama.init_params`` there with numpy leaves:
    ``embed`` (V, D), ``final_norm`` (D,), optional ``lm_head`` (D, V) and
    ``layers`` of stacked (L, ...) arrays with projections as (in, out).
    Projections become (out, in) per layer; this is the one transpose. A
    matrix quantized by the reference's ``quantize_params`` comes as int8
    ``q`` and keepdims f32 ``s`` (a pair or a QTensor of numpy arrays:
    layers (L, in, out) with s (L, 1, out), embed (V, D) with s (V, 1),
    lm_head (D, V) with s (1, V)) and becomes a ``quant.QTensor`` of the
    same int8 values, transposed the same way, its scales one per output
    row. An MoE block's ``w_router`` (L, D, E) becomes (E, D) and its
    expert stacks (L, E, in, out) become (E, out, in) per layer; biases
    (``<name>_b``, (L, out)), norm biases (``*_norm_b``) and
    ``final_norm_b`` carry over as they are.
    """
    dt = cfg.torch_dtype
    device = torch.device(device or "cpu")

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dt)

    def tq(q, s, transpose):
        q = np.array(q.T if transpose else q, dtype=np.int8, order="C")
        return quant_ops.QTensor(
            q=torch.from_numpy(q).to(device),
            s=torch.from_numpy(np.array(s, np.float32).reshape(-1)).to(device))

    def matrix(leaf, i=None, transpose=True):
        pair = _qpair(leaf)
        if pair is not None:
            q, s = pair
            if i is not None:
                q, s = q[i], s[i]
            return tq(q, s, transpose)
        a = np.asarray(leaf if i is None else leaf[i], dtype=np.float32)
        return t(a.T if transpose else a)

    layers = tree["layers"]
    keys = layer_keys(cfg)
    unknown = set(layers) - set(keys)
    if unknown:
        raise ValueError(
            f"layer leaves {sorted(unknown)} are not leaves of this config "
            f"(mlp={cfg.mlp!r}, use_bias={cfg.use_bias}, norm={cfg.norm!r}); "
            f"LoRA adapters are a tree of their own: "
            f"train/lora.adapters_from_jax")
    moe = cfg.mlp == "moe"
    params: Params = {"embed": matrix(tree["embed"], transpose=False),
                      "final_norm": t(tree["final_norm"]), "layers": []}
    if cfg.norm == "layernorm":
        params["final_norm_b"] = t(tree["final_norm_b"])
    for i in range(cfg.n_layers):
        layer = {}
        for key in keys:
            a = layers[key]
            if key == "w_router":
                layer[key] = t(np.asarray(a[i], np.float32).T)
            elif moe and key in quant_ops.MOE_LEAVES:
                # (E, in, out) -> (E, out, in): bmm's (out, in) stacks
                layer[key] = t(np.asarray(a[i], np.float32)
                               .transpose(0, 2, 1))
            elif key in _MATRICES:
                layer[key] = matrix(a, i)
            else:
                layer[key] = t(np.asarray(a[i], np.float32))
        params["layers"].append(layer)
    if not cfg.tie_embeddings:
        params["lm_head"] = matrix(tree["lm_head"])
    return params


# HF LlamaForCausalLM names of a layer's leaves, under "model.layers.{i}."
HF_LAYER_KEYS = {
    "attn_norm": "input_layernorm.weight",
    "wq": "self_attn.q_proj.weight", "wk": "self_attn.k_proj.weight",
    "wv": "self_attn.v_proj.weight", "wo": "self_attn.o_proj.weight",
    "mlp_norm": "post_attention_layernorm.weight",
    "w_gate": "mlp.gate_proj.weight", "w_up": "mlp.up_proj.weight",
    "w_down": "mlp.down_proj.weight",
}
# MixtralForCausalLM's MoE block, under "model.layers.{i}.block_sparse_moe.":
# the router, and each expert's w1 (gate), w3 (up) and w2 (down)
HF_MOE_ROUTER = "gate.weight"
HF_MOE_EXPERTS = {"w_gate": "w1", "w_up": "w3", "w_down": "w2"}


def params_from_hf(state: Dict[str, torch.Tensor], cfg: LlamaConfig,
                   device=None, quant: str = "none",
                   hf_names: Optional[Dict[str, str]] = None) -> Params:
    """Map an HF ``LlamaForCausalLM`` state dict into this layout.

    ``state`` maps HF names to CPU torch tensors, and to nothing else:
    ``hf_loader.read_state`` gives zero-copy views of the mapped shards, a
    ``state_dict()`` serves as well. HF keeps projections as (out, in), as
    this layout does, so nothing transposes (the reference's ``params_from_hf`` transposes into its (in, out)).
    Each leaf is copied to ``device`` (the CPU by default) in its stored
    dtype and converted there to the model dtype, rounding to nearest even
    as ``jnp.asarray(arr, dtype)`` does, so a file loads bit-equal to the
    reference. Without ``lm_head.weight`` (and untied) the head is the
    embedding, as in the reference. An MoE config reads Mixtral's
    ``block_sparse_moe`` names: the router ``gate`` (E, D) and each
    expert's ``w1``/``w3``/``w2`` (out, in), stacked on a leading expert
    axis (:data:`HF_MOE_EXPERTS`). ``hf_names`` maps leaves to HF names
    under ``model.layers.{i}.`` (:data:`HF_LAYER_KEYS` by default;
    StarCoder2's mapper passes its own, biases included); a LayerNorm
    config reads the final norm's bias from ``model.norm.bias``. A
    checkpoint whose MoE or bias tensors the config does not take is
    refused.

    ``quant="int8"`` quantizes each matrix as it lands on the device and
    drops its model-dtype copy before the next is read, as
    :func:`init_params` does as it draws: the result equals
    ``quant.quantize_params`` of the model-dtype load, and a model too
    large for the card in its dtype loads holding at most one of its
    matrices unquantized.
    """
    if quant not in ("none", "", "int8"):
        raise ValueError(f"unknown quant mode {quant!r}; expected "
                         f"'none' or 'int8'")
    check_config(cfg)
    names = hf_names or HF_LAYER_KEYS
    moe_keys = sorted(k for k in state if ".block_sparse_moe." in k)
    if moe_keys and cfg.mlp != "moe":
        raise ValueError(f"MoE weights ({moe_keys[0]}, ...) in a checkpoint for "
                         f"a mlp={cfg.mlp!r} config")
    biases = sorted(k for k in state if k.endswith(".bias"))
    if biases and not (cfg.use_bias or cfg.norm == "layernorm"):
        raise ValueError(f"biases ({biases[0]}, ...) in a checkpoint for a "
                         f"config without use_bias or LayerNorm")
    device = torch.device(device or "cpu")
    dt = cfg.torch_dtype

    def leaf(name):
        if name not in state:
            raise KeyError(f"the checkpoint has no tensor {name!r}")
        w = state[name].to(device, copy=True)
        return w if w.dtype == dt else w.to(dt)

    def matrix(name):
        w = leaf(name)
        return quant_ops.quantize(w) if quant == "int8" else w

    def experts(prefix, w):
        return torch.stack([leaf(f"{prefix}experts.{e}.{w}.weight")
                            for e in range(cfg.n_experts)])

    moe = cfg.mlp == "moe"
    params: Params = {"embed": matrix("model.embed_tokens.weight"),
                      "final_norm": leaf("model.norm.weight"), "layers": []}
    if cfg.norm == "layernorm":
        params["final_norm_b"] = leaf("model.norm.bias")
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        layer = {}
        for key in layer_keys(cfg):
            if moe and key == "w_router":
                layer[key] = leaf(f"{p}block_sparse_moe.{HF_MOE_ROUTER}")
            elif moe and key in HF_MOE_EXPERTS:
                layer[key] = experts(f"{p}block_sparse_moe.",
                                     HF_MOE_EXPERTS[key])
            else:
                layer[key] = (matrix if key in _MATRICES else leaf)(
                    p + names[key])
        params["layers"].append(layer)
    if not cfg.tie_embeddings:
        params["lm_head"] = (matrix("lm_head.weight")
                             if "lm_head.weight" in state
                             else params["embed"])
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def embed_tokens(params: Params, cfg: LlamaConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup times ``embed_scale``, the scale rounded to
    the model dtype first, as the reference's ``jnp.asarray(scale,
    h.dtype)`` does (bf16 sqrt(3072) is 55.5, not 55.4256)."""
    h = quant_ops.take(params["embed"], tokens, cfg.torch_dtype)
    if cfg.embed_scale != 1.0:
        h = h * torch.tensor(cfg.embed_scale, dtype=h.dtype, device=h.device)
    return h


def _norm(cfg: LlamaConfig, x: torch.Tensor, layer: Params,
          name: str) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, layer[name], layer[name + "_b"], cfg.norm_eps)
    return rms_norm(x, layer[name], cfg.norm_eps)


def _projs(x: torch.Tensor, layer: Params, names: Tuple[str, ...],
           lora: Optional[Dict[str, Any]] = None,
           adapter_ix: Optional[torch.Tensor] = None):
    """x @ W of the projections ``names`` that read x, through the quant
    seam, plus each one's bias where the layer has one, then the LoRA
    update of each of the layer's groups over x (one call a group,
    ``_maybe_lora`` there): the bias lands between the base product and
    the update, as the reference's ``_proj`` adds it, so bf16 rounds where
    it rounds there. Returns the outputs in order."""
    ys = {}
    for n in names:
        y = quant_ops.matmul(x, layer[n])
        b = layer.get(n + "_b")
        ys[n] = y if b is None else y + b.to(y.dtype)
    if lora:
        for n in names:
            for g in lora.get(n, ()):
                ys.update(zip(g.targets, lora_ops.lora_apply_group(
                    [ys[t] for t in g.targets], x, g, adapter_ix)))
    return [ys[n] for n in names]


def lora_layers(adapters: Optional[Params],
                n_layers: int) -> Optional[lora_ops.LoraLayers]:
    """An adapter tree (global or stacked slots) as each layer's groups
    (``ops.lora.prepare``), or None; a prepared one as it is."""
    if adapters is None or isinstance(adapters, lora_ops.LoraLayers):
        return adapters
    return lora_ops.prepare(adapters, n_layers)


AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _block(cfg: LlamaConfig, h: torch.Tensor, layer: Params,
           cos: torch.Tensor, sin: torch.Tensor, attn_fn: AttnFn,
           adapters: Optional[Dict[str, Any]] = None,
           adapter_ix: Optional[torch.Tensor] = None,
           token_mask: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One transformer block; ``attn_fn(q, k, v) -> ctx`` owns the cache
    write and the attention read, so every path shares this block.
    ``adapters``: the layer's groups (an entry of ``ops.lora.LoraLayers``),
    stacked slots selected per batch row by ``adapter_ix`` (B,).
    ``token_mask`` (B, S) bool: the tokens that take expert slots in an
    MoE block (``ops.moe``; all when None). Returns (h, the MoE
    load-balance loss, or None for a dense MLP)."""
    B, S, _ = h.shape
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ad = (adapters, adapter_ix)
    x = _norm(cfg, h, layer, "attn_norm")
    q, k, v = _projs(x, layer, ("wq", "wk", "wv"), *ad)
    q = apply_rope(q.reshape(B, S, H, HD), cos, sin)
    k = apply_rope(k.reshape(B, S, KV, HD), cos, sin)
    v = v.reshape(B, S, KV, HD)
    o, = _projs(attn_fn(q, k, v).reshape(B, S, H * HD), layer, ("wo",), *ad)
    h = h + o
    x = _norm(cfg, h, layer, "mlp_norm")
    if cfg.mlp == "moe":
        out, aux = moe_ops.moe_mlp(
            layer, x, k=cfg.n_experts_per_tok,
            capacity_factor=cfg.capacity_factor, hidden_act=cfg.hidden_act,
            valid=token_mask)
        return h + out, aux
    if cfg.mlp == "glu":
        gate, up = _projs(x, layer, ("w_gate", "w_up"), *ad)
        act = glu(gate, up, cfg.hidden_act)
    else:   # plain: c_fc -> act -> c_proj (StarCoder2)
        up, = _projs(x, layer, ("w_up",), *ad)
        act = activate(up, cfg.hidden_act)
    down, = _projs(act, layer, ("w_down",), *ad)
    return h + down, None


ATTN_IMPLS = ("auto", "kernel", "plain")


def attention_kernels(cfg: LlamaConfig, device: torch.device) -> bool:
    """Whether a pass on ``device`` goes through the kernel wrappers of
    ``ops/cuda/attention.py``: ``"auto"`` and ``"kernel"`` do, and a
    wrapper launches its kernel for CUDA tensors and takes its plain
    version only for CPU tensors; ``"plain"`` asks for the plain PyTorch
    attention on any device. The kernels are full-causal: a
    ``sliding_window`` config takes the plain windowed attention on the
    CPU, as the reference's XLA path does, and on CUDA raises (the window
    inside the kernels is ROADMAP A.12), unless the caller asked for
    ``attn_impl="plain"``."""
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                         f"{cfg.attn_impl!r}")
    if cfg.attn_impl == "plain":
        return False
    if cfg.sliding_window:
        if torch.device(device).type == "cuda":
            raise NotImplementedError(
                f"sliding_window={cfg.sliding_window}: the attention "
                f"kernels are full-causal; the window inside them is "
                f"ROADMAP A.12 (attn_impl='plain' runs the plain windowed "
                f"attention)")
        return False
    return True


def _unembed(cfg: LlamaConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    h = _norm(cfg, h, params, "final_norm")
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    if isinstance(head, quant_ops.QTensor):
        return quant_ops.matmul(h, head).float()
    return F.linear(h, head.to(h.dtype)).float()


def run_blocks(cfg: LlamaConfig, params: Params, h: torch.Tensor,
               cos: torch.Tensor, sin: torch.Tensor,
               attn_for_layer: Callable[[int], AttnFn],
               adapters: Optional[Params] = None,
               adapter_ix: Optional[torch.Tensor] = None, *,
               token_mask: Optional[torch.Tensor] = None,
               aux: Optional[list] = None) -> torch.Tensor:
    """The layer loop (``scan_blocks_inplace`` there): ``attn_for_layer(i)``
    gives layer i's attention, which may write the KV pool in place.
    ``adapters``: a global adapter tree, or stacked slots with each batch
    row's slot in ``adapter_ix`` (B,), as a tree or prepared
    (:func:`lora_layers`). ``token_mask`` (B, S): the tokens the pass
    computes for, which alone take MoE expert slots; ``aux``, a list, gets
    each MoE layer's load-balance loss."""
    lora = lora_layers(adapters, len(params["layers"]))
    for i, layer in enumerate(params["layers"]):
        h, layer_aux = _block(cfg, h, layer, cos, sin, attn_for_layer(i),
                              lora[i] if lora is not None else None,
                              adapter_ix, token_mask)
        if aux is not None and layer_aux is not None:
            aux.append(layer_aux)
    return h


def forward(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            attn_mask: Optional[torch.Tensor] = None,
            adapters: Optional[Params] = None, return_aux: bool = False):
    """Full-sequence causal LM: tokens (B, S) -> logits (B, S, V) f32.
    ``attn_mask`` (B, S) marks valid tokens of right-padded rows;
    ``adapters`` a global adapter tree. Attention is the plain one on
    every device (windowed for a ``sliding_window`` config), and every
    token is routed, as there. ``return_aux`` also returns the layer-mean
    MoE load-balance loss (0 for a dense MLP), a 0-d f32 tensor."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    h = embed_tokens(params, cfg, tokens)
    cos, sin = rotary_embedding(positions, cfg.head_dim, cfg.rope_theta,
                                scaling=cfg.rope_scaling)

    def attn(q, k, v):
        return mha_prefill(q, k, v, q_positions=positions,
                           kv_positions=positions, kv_mask=attn_mask,
                           causal=True, window=cfg.sliding_window)

    aux: list = []
    h = run_blocks(cfg, params, h, cos, sin, lambda _i: attn, adapters,
                   aux=aux)
    logits = _unembed(cfg, params, h)
    if return_aux:
        total = torch.stack(aux).sum() if aux else torch.zeros(
            (), dtype=torch.float32, device=logits.device)
        return logits, total / cfg.n_layers
    return logits


# ---------------------------------------------------------------------------
# Dense-cache API (the paged passes live in engine/kv_cache.py)
# ---------------------------------------------------------------------------

@dataclass
class KVCache:
    """Dense per-layer KV cache: k, v (L, B, T, KV, HD); lengths (B,) int32."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor

    @staticmethod
    def create(cfg: LlamaConfig, batch: int, max_seq: int,
               device=None) -> "KVCache":
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            v=torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=device))


def _cached_blocks(cfg: LlamaConfig, params: Params, h: torch.Tensor,
                   cos: torch.Tensor, sin: torch.Tensor, cache: KVCache,
                   write_pos: torch.Tensor, attn: AttnFn,
                   adapters: Optional[Params] = None) -> torch.Tensor:
    """The layer loop over the dense cache (``_scan_cached_blocks`` there):
    each layer writes its new K/V (B, S, KV, HD) into its cache slice at
    ``write_pos[b]``, in place, then ``attn(q, k_layer, v_layer)`` reads
    the whole slice. Like ``dynamic_update_slice`` the write start is
    clamped so that the S rows fit: a write at ``T - S + 1`` or later
    lands at ``T - S``."""
    B, S = h.shape[:2]
    T = cache.k.shape[2]
    start = write_pos.to(torch.int64).clamp(0, T - S)
    rows = start[:, None] + torch.arange(S, device=h.device)[None]   # (B, S)
    batch = torch.arange(B, device=h.device)[:, None]

    def attn_for_layer(i):
        def attn_i(q, k, v):
            cache.k[i][batch, rows] = k.to(cache.k.dtype)
            cache.v[i][batch, rows] = v.to(cache.v.dtype)
            return attn(q, cache.k[i], cache.v[i])
        return attn_i

    return run_blocks(cfg, params, h, cos, sin, attn_for_layer, adapters)


def prefill(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
            cache: KVCache, start_pos: torch.Tensor, seq_lens: torch.Tensor,
            last_only: bool = False, adapters: Optional[Params] = None
            ) -> Tuple[torch.Tensor, KVCache]:
    """Prompt pass that fills the dense cache, in place.

    tokens: (B, S) right-padded; start_pos: (B,) cache offset (0 for fresh
    sequences, > 0 for a later chunk); seq_lens: (B,) valid tokens of this
    chunk. Returns logits (B, S, V) f32, or (B, 1, V) at each row's last
    valid position when ``last_only``, and the cache with ``lengths =
    start_pos + seq_lens``. ``adapters``: a global adapter tree.
    """
    B, S = tokens.shape
    T = cache.k.shape[2]
    dev = tokens.device
    positions = start_pos.to(torch.int64)[:, None] + torch.arange(
        S, device=dev)[None]
    h = embed_tokens(params, cfg, tokens)
    cos, sin = rotary_embedding(positions, cfg.head_dim, cfg.rope_theta,
                                scaling=cfg.rope_scaling)
    valid_through = (start_pos + seq_lens).to(torch.int32)
    cache_positions = torch.arange(T, device=dev)[None].expand(B, T)
    kv_mask = cache_positions < valid_through[:, None]
    use_kernel = attention_kernels(cfg, dev)
    if (use_kernel and dev.type == "cuda"
            and not kernels.prefill_supported(S, T, cfg.head_dim)):
        raise ValueError(f"flash_prefill kernel does not take S={S}, T={T}, "
                         f"head_dim={cfg.head_dim}; attn_impl='plain' runs "
                         f"the plain attention")

    def attn(q, k, v):
        if use_kernel:
            return kernels.flash_prefill(q, k, v, start_pos=start_pos,
                                         kv_valid_through=valid_through)
        return mha_prefill(q, k, v, q_positions=positions,
                           kv_positions=cache_positions, kv_mask=kv_mask,
                           causal=True, window=cfg.sliding_window)

    h = _cached_blocks(cfg, params, h, cos, sin, cache, start_pos, attn,
                       adapters)
    if last_only:
        last = (seq_lens.to(torch.int64) - 1).clamp_min(0)
        h = h[torch.arange(B, device=dev), last][:, None]
    cache.lengths = valid_through
    return _unembed(cfg, params, h), cache


def decode_step(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
                cache: KVCache, adapters: Optional[Params] = None
                ) -> Tuple[torch.Tensor, KVCache]:
    """One decode step for every row, in place: token b goes to position
    ``lengths[b]`` (clamped to the last row once the cache is full) and
    attends rows ``< lengths[b] + 1``. tokens: (B,); ``adapters``: a
    global adapter tree. Returns logits (B, V) f32 and the cache with
    ``lengths + 1``."""
    T = cache.k.shape[2]
    positions = cache.lengths.to(torch.int64)[:, None]             # (B, 1)
    h = embed_tokens(params, cfg, tokens[:, None])
    cos, sin = rotary_embedding(positions, cfg.head_dim, cfg.rope_theta,
                                scaling=cfg.rope_scaling)
    new_lengths = cache.lengths + 1
    use_kernel = attention_kernels(cfg, tokens.device)
    if (use_kernel and tokens.is_cuda
            and not kernels.decode_supported(T, cfg.head_dim)):
        raise ValueError(f"ragged_decode kernel does not take T={T}, "
                         f"head_dim={cfg.head_dim}; attn_impl='plain' runs "
                         f"the plain attention")

    def attn(q, k, v):
        if use_kernel:
            return kernels.ragged_decode(q, k, v, new_lengths)
        return mha_decode(q, k, v, new_lengths, window=cfg.sliding_window)

    h = _cached_blocks(cfg, params, h, cos, sin, cache, cache.lengths, attn,
                       adapters)
    cache.lengths = new_lengths
    return _unembed(cfg, params, h)[:, 0], cache
