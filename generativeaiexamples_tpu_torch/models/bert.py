"""BERT-family encoder in plain PyTorch: bi-encoder embeddings and
cross-encoder reranking.

Port of ``generativeaiexamples_tpu/models/bert.py``, the in-tree
replacement for the models inside the reference's NeMo Retriever NIM
containers (the ``nv-embedqa-e5-v5`` embedder and the
``nv-rerankqa-mistral-4b-v3`` reranker): post-LN BERT with learned
positions and GELU, so HF ``BertModel`` state dicts load directly
(:func:`params_from_hf`).

Parameters are a plain dict of tensors, one dict per layer, every matrix
kept as ``nn.Linear`` stores it, (out, in); :func:`params_from_jax`
carries the TPU package's pytree (stacked ``(L, in, out)`` numpy leaves)
across and is the one place that transposes. A Python loop over layers
takes the place of ``lax.scan``.

The reference's numerics are kept: LayerNorm in f32, cast back to the
model dtype; exact-erf GELU in f32; q and k upcast to f32 for the scores,
the padding mask applied as ``-1e30`` before an f32 softmax and the
probabilities applied to f32 values; masked-mean (or CLS) pooling in f32,
then L2 normalisation clipped at 1e-9; the rank head on the f32 CLS
vector. Attention is a plain matmul and softmax, as the reference's
einsum is (no flash kernel at e5's 512 positions): no Pallas kernel sits
on this path, so none is ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    hidden_dim: int = 3072
    max_positions: int = 512
    type_vocab_size: int = 2
    norm_eps: float = 1e-12
    dtype: str = "float32"
    pooling: str = "mean"  # "mean" (e5) | "cls" (rerank head input)

    @staticmethod
    def e5_base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def tiny(vocab_size: int = 300) -> "BertConfig":
        return BertConfig(vocab_size=vocab_size, dim=32, n_layers=2, n_heads=2,
                          hidden_dim=64, max_positions=128)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


_LAYER_MATRICES = ("wq", "wk", "wv", "wo", "w_up", "w_down")
_LAYER_VECTORS = ("bq", "bk", "bv", "bo", "b_up", "b_down")


def init_params(generator: torch.Generator, cfg: BertConfig,
                with_rank_head: bool = False, device=None) -> Params:
    """Random weights: scaled-normal fan-in init (normal / sqrt(fan_in)),
    biases at zero and norms at one, drawn from ``generator`` on
    ``device`` (the generator's device by default)."""
    device = torch.device(device or generator.device)
    D, F_ = cfg.dim, cfg.hidden_dim
    dt = cfg.torch_dtype

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(1.0 / math.sqrt(fan_in)).to(dt)

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=device)

    def norm():
        return {"scale": torch.ones((D,), dtype=dt, device=device),
                "bias": zeros(D)}

    params: Params = {
        "tok_embed": normal((cfg.vocab_size, D), D),
        "pos_embed": normal((cfg.max_positions, D), D),
        "type_embed": normal((cfg.type_vocab_size, D), D),
        "embed_norm": norm(),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "wq": normal((D, D), D), "bq": zeros(D),
            "wk": normal((D, D), D), "bk": zeros(D),
            "wv": normal((D, D), D), "bv": zeros(D),
            "wo": normal((D, D), D), "bo": zeros(D),
            "attn_norm": norm(),
            "w_up": normal((F_, D), D), "b_up": zeros(F_),
            "w_down": normal((D, F_), F_), "b_down": zeros(D),
            "mlp_norm": norm(),
        })
    if with_rank_head:
        # cross-encoder relevance head on the pooled output -> scalar score
        params["rank_head"] = {"w": normal((1, D), D), "b": zeros(1)}
    return params


def cast_params(params: Params, device=None, dtype=None) -> Params:
    """The same tree with every tensor on ``device`` in ``dtype`` (either
    left as it is where None)."""
    if isinstance(params, dict):
        return {k: cast_params(v, device, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [cast_params(v, device, dtype) for v in params]
    return params.to(device=device, dtype=dtype)


def _layer_norm(x: torch.Tensor, norm: Dict[str, torch.Tensor],
                eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * norm["scale"].float() + norm["bias"].float()).to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x.float(), approximate="none").to(x.dtype)


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # the reference's `x @ w + b`: the product rounds to the model dtype,
    # then the bias adds
    return F.linear(x, w) + b


def encode(params: Params, cfg: BertConfig, tokens: torch.Tensor,
           attn_mask: Optional[torch.Tensor] = None,
           token_types: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, S) -> contextual embeddings (B, S, D)."""
    B, S = tokens.shape
    dev = tokens.device
    if attn_mask is None:
        attn_mask = torch.ones((B, S), dtype=torch.bool, device=dev)
    if token_types is None:
        token_types = torch.zeros((B, S), dtype=torch.long, device=dev)
    tokens, token_types = tokens.long(), token_types.long()
    h = (params["tok_embed"][tokens] + params["pos_embed"][:S][None]
         + params["type_embed"][token_types]).to(cfg.torch_dtype)
    h = _layer_norm(h, params["embed_norm"], cfg.norm_eps)
    H, HD = cfg.n_heads, cfg.head_dim
    keep = attn_mask.bool()[:, None, None, :]          # (B, 1, 1, S)
    scale = 1.0 / math.sqrt(HD)
    for layer in params["layers"]:
        q = _dense(h, layer["wq"], layer["bq"]).view(B, S, H, HD)
        k = _dense(h, layer["wk"], layer["bk"]).view(B, S, H, HD)
        v = _dense(h, layer["wv"], layer["bv"]).view(B, S, H, HD)
        scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
        scores = scores.masked_fill(~keep, -1e30)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhst,bthd->bshd", probs, v.float())
        ctx = ctx.reshape(B, S, H * HD).to(h.dtype)
        h = _layer_norm(h + F.linear(ctx, layer["wo"]) + layer["bo"],
                        layer["attn_norm"], cfg.norm_eps)
        up = _gelu(_dense(h, layer["w_up"], layer["b_up"]))
        h = _layer_norm(h + F.linear(up, layer["w_down"]) + layer["b_down"],
                        layer["mlp_norm"], cfg.norm_eps)
    return h


def embed(params: Params, cfg: BertConfig, tokens: torch.Tensor,
          attn_mask: Optional[torch.Tensor] = None,
          normalize: bool = True) -> torch.Tensor:
    """Sentence embeddings (B, D), f32: masked-mean pooling (e5) or CLS."""
    B, S = tokens.shape
    if attn_mask is None:
        attn_mask = torch.ones((B, S), dtype=torch.bool, device=tokens.device)
    h = encode(params, cfg, tokens, attn_mask)
    if cfg.pooling == "cls":
        pooled = h[:, 0]
    else:
        m = attn_mask[..., None].float()
        pooled = (h.float() * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
    if normalize:
        pooled = pooled / torch.linalg.vector_norm(
            pooled, dim=-1, keepdim=True).clamp(min=1e-9)
    return pooled.float()


def rank_score(params: Params, cfg: BertConfig, tokens: torch.Tensor,
               attn_mask: Optional[torch.Tensor] = None,
               token_types: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-encoder relevance: (query, passage) pairs (B, S) -> scores (B,)
    in f32.

    Pairs are packed as query, a 0 separator, passage, with token type 1
    on the passage segment (BERT's pair convention); the score is the rank
    head of the CLS (first) position."""
    h = encode(params, cfg, tokens, attn_mask, token_types)
    cls = h[:, 0].float()
    head = params["rank_head"]
    return (cls @ head["w"].float().t() + head["b"].float())[:, 0]


# ---------------------------------------------------------------------------
# Carrying weights across: the TPU package's pytree, HF state dicts
# ---------------------------------------------------------------------------

def _tensor(a, cfg: BertConfig, device) -> torch.Tensor:
    arr = a.detach().cpu().float().numpy() if hasattr(a, "detach") else a
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
        device=device, dtype=cfg.torch_dtype)


def params_from_jax(tree: Dict[str, Any], cfg: BertConfig,
                    device=None) -> Params:
    """Carry the TPU package's parameter pytree into this layout.

    ``tree`` mirrors ``models/bert.init_params`` there with numpy leaves:
    the embeddings, ``embed_norm``, ``layers`` of stacked (L, ...) arrays
    with matrices as (in, out), and an optional ``rank_head`` (``w`` (D,
    1)). Matrices become (out, in) per layer; this is the one transpose."""
    device = torch.device(device or "cpu")

    def t(a):
        return _tensor(a, cfg, device)

    def norm(n, i=None):
        return {"scale": t(n["scale"] if i is None else n["scale"][i]),
                "bias": t(n["bias"] if i is None else n["bias"][i])}

    lay = tree["layers"]
    params: Params = {
        "tok_embed": t(tree["tok_embed"]), "pos_embed": t(tree["pos_embed"]),
        "type_embed": t(tree["type_embed"]),
        "embed_norm": norm(tree["embed_norm"]), "layers": []}
    for i in range(cfg.n_layers):
        layer = {k: t(np.asarray(lay[k][i]).T) for k in _LAYER_MATRICES}
        layer.update({k: t(lay[k][i]) for k in _LAYER_VECTORS})
        layer["attn_norm"] = norm(lay["attn_norm"], i)
        layer["mlp_norm"] = norm(lay["mlp_norm"], i)
        params["layers"].append(layer)
    if "rank_head" in tree:
        params["rank_head"] = {"w": t(np.asarray(tree["rank_head"]["w"]).T),
                               "b": t(tree["rank_head"]["b"])}
    return params


def params_from_hf(state_dict: Dict[str, Any], cfg: BertConfig,
                   prefix: str = "", device=None) -> Params:
    """Map HF ``BertModel.state_dict()`` into this layout (tensors or numpy
    arrays). HF keeps its linear weights as (out, in), as this layout does,
    so nothing transposes. ``prefix`` handles nesting (e.g. ``bert.``)."""
    device = torch.device(device or "cpu")

    def t(name):
        return _tensor(state_dict[prefix + name], cfg, device)

    def norm(name):
        return {"scale": t(name + ".weight"), "bias": t(name + ".bias")}

    names = {"wq": "attention.self.query", "wk": "attention.self.key",
             "wv": "attention.self.value", "wo": "attention.output.dense",
             "w_up": "intermediate.dense", "w_down": "output.dense"}
    biases = dict(zip(_LAYER_VECTORS, _LAYER_MATRICES))
    params: Params = {
        "tok_embed": t("embeddings.word_embeddings.weight"),
        "pos_embed": t("embeddings.position_embeddings.weight"),
        "type_embed": t("embeddings.token_type_embeddings.weight"),
        "embed_norm": norm("embeddings.LayerNorm"),
        "layers": [],
    }
    for i in range(cfg.n_layers):
        p = f"encoder.layer.{i}."
        layer = {k: t(p + names[k] + ".weight") for k in _LAYER_MATRICES}
        layer.update({b: t(p + names[w] + ".bias")
                      for b, w in biases.items()})
        layer["attn_norm"] = norm(p + "attention.output.LayerNorm")
        layer["mlp_norm"] = norm(p + "output.LayerNorm")
        params["layers"].append(layer)
    return params
