"""LoRA adapters for the port's Llama layout.

Port of ``generativeaiexamples_tpu/train/lora.py``: the adapter spec
(:class:`LoraConfig`), the targets and their dimensions, a seeded
:func:`init_adapters` with the reference's refusals, and
:func:`merge_adapters`. An adapter tree is ``{target: {"a": (L, r, in),
"b": (L, out, r)}}`` of torch tensors: the reference's ``(L, in, r)`` /
``(L, r, out)`` leaves transposed into the port's (out, in) orientation,
as ``models/llama.params_from_jax`` turns the weights, so both of the
update's products read contiguous rows (``ops/lora.py``). The ``alpha /
rank`` scale is folded into ``a`` at init, as there: the update is ``x @
a^T @ b^T`` with no further factor.

:func:`adapters_from_jax` carries a reference tree (numpy leaves in its
layout) into this one; it is the one place that transposes. The engine
serves such a tree per request (``EngineCore.register_adapter``) or for
every row (its ``adapters=`` argument; the dense API's ``adapters``).

Saving and loading adapter directories waits for the port of the
reference's orbax checkpoints (ROADMAP A.15): :func:`save_adapters` and
:func:`load_adapters` raise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

Adapters = Dict[str, Dict[str, torch.Tensor]]

# target name -> (in_dim, out_dim) on a LlamaConfig
_TARGET_DIMS = {
    "wq": lambda c: (c.dim, c.n_heads * c.head_dim),
    "wk": lambda c: (c.dim, c.n_kv_heads * c.head_dim),
    "wv": lambda c: (c.dim, c.n_kv_heads * c.head_dim),
    "wo": lambda c: (c.n_heads * c.head_dim, c.dim),
    "w_gate": lambda c: (c.dim, c.hidden_dim),
    "w_up": lambda c: (c.dim, c.hidden_dim),
    "w_down": lambda c: (c.hidden_dim, c.dim),
}
TARGETS = tuple(_TARGET_DIMS)


@dataclass(frozen=True)
class LoraConfig:
    """Adapter spec; the defaults are the reference's (attention-only
    rank 8, alpha 16)."""

    rank: int = 8
    alpha: float = 16.0
    targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo")

    def __post_init__(self):
        unknown = set(self.targets) - set(_TARGET_DIMS)
        if unknown:
            raise ValueError(f"unknown LoRA targets {sorted(unknown)}; "
                             f"valid: {sorted(_TARGET_DIMS)}")


def target_dims(model_cfg, name: str) -> Tuple[int, int]:
    """(in, out) of target ``name`` on ``model_cfg``."""
    return _TARGET_DIMS[name](model_cfg)


def check_targets(model_cfg, targets) -> None:
    """The reference's refusals: ``w_gate`` needs a GLU MLP, and an MoE
    block's expert MLP takes no adapter."""
    mlp = getattr(model_cfg, "mlp", "glu")
    if mlp != "glu" and "w_gate" in targets:
        raise ValueError(
            f"LoRA target 'w_gate' does not exist in a mlp={mlp!r} "
            "model; drop it from targets")
    moe_mlp_targets = {"w_gate", "w_up", "w_down"} & set(targets)
    if mlp == "moe" and moe_mlp_targets:
        raise ValueError(
            f"LoRA MLP targets {sorted(moe_mlp_targets)} are not supported "
            "on mlp='moe' models; restrict targets to attention "
            "projections (wq/wk/wv/wo)")


def init_adapters(generator: torch.Generator, model_cfg, cfg: LoraConfig,
                  dtype: torch.dtype = torch.float32,
                  device=None) -> Adapters:
    """``{target: {"a": (L, r, in), "b": (L, out, r)}}``: ``a`` normal /
    sqrt(in) times ``alpha / rank``, ``b`` zeros (a new adapter changes
    nothing until trained), drawn from ``generator`` on ``device`` (the
    generator's by default)."""
    check_targets(model_cfg, cfg.targets)
    device = torch.device(device or generator.device)
    L = model_cfg.n_layers
    scale = cfg.alpha / cfg.rank
    adapters: Adapters = {}
    for name in cfg.targets:
        d_in, d_out = target_dims(model_cfg, name)
        a = torch.randn((L, cfg.rank, d_in), generator=generator,
                        dtype=torch.float32, device=device)
        a = (a / math.sqrt(d_in) * scale).to(dtype)
        adapters[name] = {"a": a, "b": torch.zeros((L, d_out, cfg.rank),
                                                   dtype=dtype, device=device)}
    return adapters


def adapters_from_jax(tree: Dict[str, Any], model_cfg, device=None,
                      dtype: torch.dtype = torch.float32) -> Adapters:
    """Carry a reference adapter tree (``{target: {"a": (L, in, r), "b":
    (L, r, out)}}`` with numpy leaves, ``train/lora.init_adapters``'s
    layout there) into this layout, in ``dtype`` on ``device`` (the CPU by
    default). Raises on an unknown target or a leaf whose shape does not
    fit ``model_cfg``."""
    device = torch.device(device or "cpu")
    check_targets(model_cfg, list(tree))
    out: Adapters = {}
    for name, ab in tree.items():
        if name not in _TARGET_DIMS:
            raise ValueError(f"unknown LoRA target {name!r}; valid: "
                             f"{sorted(_TARGET_DIMS)}")
        a = np.asarray(ab["a"], np.float32)
        b = np.asarray(ab["b"], np.float32)
        d_in, d_out = target_dims(model_cfg, name)
        L = model_cfg.n_layers
        r = a.shape[-1]
        if a.shape != (L, d_in, r) or b.shape != (L, r, d_out):
            raise ValueError(f"adapter {name!r}: a {a.shape}, b {b.shape} do "
                             f"not fit (L, in, r) = ({L}, {d_in}, r) and "
                             f"(L, r, out) = ({L}, r, {d_out})")
        t = lambda arr: torch.from_numpy(np.ascontiguousarray(
            arr.transpose(0, 2, 1))).to(device=device, dtype=dtype)
        out[name] = {"a": t(a), "b": t(b)}
    return out


def merge_adapters(params: Dict[str, Any], adapters: Adapters
                   ) -> Dict[str, Any]:
    """Fold each low-rank product into its base weight, ``W' = W + (a^T @
    b^T)^T = W + b @ a`` in the (out, in) layout, in f32 and back to the
    weight's dtype, as the reference's ``merge_adapters``: the merged dict
    serves with no adapter. ``params`` is left as it was."""
    layers = [dict(layer) for layer in params["layers"]]
    for name, ab in adapters.items():
        for i, layer in enumerate(layers):
            w = layer[name]
            if not isinstance(w, torch.Tensor):
                raise ValueError(f"merge_adapters: {name} of layer {i} is "
                                 f"quantized; merge into model-dtype weights")
            delta = ab["b"][i].float().to(w.device) @ ab["a"][i].float().to(
                w.device)
            layer[name] = (w.float() + delta).to(w.dtype)
    out = dict(params)
    out["layers"] = layers
    return out


def save_adapters(directory: str, adapters: Adapters, cfg: LoraConfig):
    """Not ported: adapter directories are the reference's orbax
    checkpoints (``train/checkpoints.py``), ROADMAP A.15."""
    raise NotImplementedError(
        "save_adapters writes an orbax checkpoint (train/checkpoints.py), "
        "which the PyTorch port does not have yet (ROADMAP A.15)")


def load_adapters(directory: str, model_cfg):
    """Not ported: adapter directories are the reference's orbax
    checkpoints (``train/checkpoints.py``), ROADMAP A.15."""
    raise NotImplementedError(
        "load_adapters reads an orbax checkpoint (train/checkpoints.py), "
        "which the PyTorch port does not have yet (ROADMAP A.15)")
