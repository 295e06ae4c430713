"""Serve a local HuggingFace Llama checkpoint directory.

Port of ``generativeaiexamples_tpu/models/hf_loader.py``: a directory with
``config.json`` and ``*.safetensors`` (and a ``tokenizer.json``, which
``engine/tokenizer.py`` reads) serves as it is, with the
:class:`~generativeaiexamples_tpu_torch.models.llama.LlamaConfig` derived
from ``config.json`` and the weights mapped by
:func:`~generativeaiexamples_tpu_torch.models.llama.params_from_hf`.

The shards are read by ``models/safetensors_io.py`` (standard library and
numpy; the serving machine has no ``safetensors`` package) as zero-copy
views of the mapped files, so a leaf is read from disk only when it is
copied to the device. ``quant="int8"`` quantizes each matrix as it lands
there, so llama3-70b loads onto one 80 GB card from its bf16 shards.
"""

from __future__ import annotations

import dataclasses
import json
import os
from glob import glob
from typing import Dict, Optional, Tuple

import torch

from generativeaiexamples_tpu_torch.core.runtime import resolve_device
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.models.safetensors_io import (
    SafetensorsFile)

INDEX_FILE = "model.safetensors.index.json"


def is_hf_dir(directory: str) -> bool:
    return (os.path.isfile(os.path.join(directory, "config.json"))
            and bool(glob(os.path.join(directory, "*.safetensors"))))


def config_from_hf(directory: str) -> llama.LlamaConfig:
    """LlamaConfig from an HF ``config.json`` (llama/llama3 families)."""
    with open(os.path.join(directory, "config.json"), encoding="utf-8") as fh:
        hc = json.load(fh)
    arch = (hc.get("architectures") or ["LlamaForCausalLM"])[0]
    if "Llama" not in arch:
        raise ValueError(f"unsupported HF architecture {arch!r} "
                         "(llama-family checkpoints only)")
    n_heads = int(hc["num_attention_heads"])
    head_dim = int(hc.get("head_dim")
                   or hc["hidden_size"] // n_heads)
    rope_scaling = _parse_rope_scaling(hc.get("rope_scaling"))
    return llama.LlamaConfig(
        vocab_size=int(hc["vocab_size"]),
        dim=int(hc["hidden_size"]),
        n_layers=int(hc["num_hidden_layers"]),
        n_heads=n_heads,
        n_kv_heads=int(hc.get("num_key_value_heads", n_heads)),
        hidden_dim=int(hc["intermediate_size"]),
        head_dim=head_dim,
        rope_theta=float(hc.get("rope_theta", 500000.0)),
        rope_scaling=rope_scaling,
        norm_eps=float(hc.get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(hc.get("tie_word_embeddings", False)),
        dtype="bfloat16",
    )


def _parse_rope_scaling(block) -> "tuple | None":
    """HF ``rope_scaling`` → the LlamaConfig tuple, or a loud failure.

    Llama-3.1/3.2 checkpoints ship ``rope_type: "llama3"``; serving one
    while ignoring the block would silently give wrong positional
    encodings, so any rope_scaling not implemented here raises."""
    if not block:
        return None
    rope_type = str(block.get("rope_type") or block.get("type") or "")
    if rope_type in ("default", "none"):
        return None
    if rope_type == "llama3":
        try:
            return (float(block["factor"]),
                    float(block["low_freq_factor"]),
                    float(block["high_freq_factor"]),
                    int(block["original_max_position_embeddings"]))
        except KeyError as exc:
            raise ValueError(
                f"rope_scaling of type 'llama3' is missing field {exc}; "
                f"got {sorted(block)}") from exc
    raise ValueError(
        f"unsupported rope_scaling type {rope_type!r} in config.json — "
        "implemented: 'llama3' (Llama-3.1/3.2), 'default'. Serving this "
        "checkpoint without its scaling rule would silently corrupt "
        "positional encodings.")


def read_state(directory: str) -> Dict[str, torch.Tensor]:
    """HF name -> zero-copy CPU tensor over every ``*.safetensors`` file of
    ``directory``, in sorted order (a later shard's tensor of the same name
    wins, as in the reference). With a ``model.safetensors.index.json``
    each tensor it names comes from the shard it names, and one that this
    shard does not hold raises."""
    shards = {os.path.basename(p): SafetensorsFile(p) for p in
              sorted(glob(os.path.join(directory, "*.safetensors")))}
    state = {}
    for f in shards.values():
        state.update({name: f for name in f})
    index = os.path.join(directory, INDEX_FILE)
    if os.path.isfile(index):
        with open(index, encoding="utf-8") as fh:
            weight_map = json.load(fh).get("weight_map") or {}
        for name, shard in weight_map.items():
            f = shards.get(shard)
            if f is None or name not in f:
                raise KeyError(f"{INDEX_FILE} places tensor {name!r} in "
                               f"{shard!r}, which does not hold it")
            state[name] = f
    return {name: f.tensor(name) for name, f in state.items()}


def load_hf_dir(directory: str, device=None, quant: str = "none",
                dtype: Optional[str] = None
                ) -> Tuple[llama.LlamaConfig, llama.Params]:
    """(config, params) from a local HF Llama directory, on ``device``
    (``cuda`` unless the caller asks for another; raises with no GPU), in
    ``dtype`` (the config's bfloat16 by default), int8 matrices with
    ``quant="int8"``."""
    dev = resolve_device(device)
    cfg = config_from_hf(directory)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    params = llama.params_from_hf(read_state(directory), cfg, device=dev,
                                  quant=quant)
    return cfg, params
