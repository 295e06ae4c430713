"""The port's HF checkpoint loader against the reference's.

A tiny HF directory written by ``transformers.LlamaForCausalLM
.save_pretrained`` (f32, 3 layers, dim 128, GQA 4/2, as the reference's
own fixture) loads through the port's ``load_hf_dir`` exactly as
``params_from_jax`` carries the reference's ``load_hf_dir`` of it: in
bf16 (the f32 file rounded to nearest even, bit-equal to the reference's
``jnp`` conversion), in f32 (equal to the HF state dict) and with
``quant="int8"`` (q and s bit-equal to the reference's
``quantize_params``). ``config_from_hf`` equals the reference's field by
field and raises its errors. Tied and headless directories, sharded ones
with an index, MoE keys and the safetensors reader's refusals are covered;
the reader equals ``safetensors.torch.load_file`` on every dtype it
knows, and ``chip_smoke.write_safetensors`` writes what the library
reads.
"""

import dataclasses
import json
import os
import shutil
import struct
import sys

import jax
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import hf_loader as ref_loader
from generativeaiexamples_tpu.ops import quant as ref_quant

from generativeaiexamples_tpu_torch.models import hf_loader, llama
from generativeaiexamples_tpu_torch.models.safetensors_io import (
    SafetensorsFile)

transformers = pytest.importorskip("transformers")
st_torch = pytest.importorskip("safetensors.torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 300


def _hf_model(tie=False, seed=7, **kw):
    cfg = transformers.LlamaConfig(
        vocab_size=VOCAB, hidden_size=128, intermediate_size=256,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=tie,
        **kw)
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(cfg)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("hf_llama"))
    model = _hf_model()
    model.save_pretrained(d, safe_serialization=True)
    return d, model


def _ref_params(d, cfg):
    """The reference's load of ``d``, carried into the port's layout."""
    _, jparams = ref_loader.load_hf_dir(d)
    return llama.params_from_jax(jax.tree.map(np.asarray, jparams), cfg)


def _assert_params_equal(got, want):
    assert set(got) == set(want)
    for key in ("embed", "final_norm", "lm_head"):
        if key in want:
            _assert_leaf_equal(got[key], want[key], key)
    assert len(got["layers"]) == len(want["layers"])
    for i, (g, w) in enumerate(zip(got["layers"], want["layers"])):
        assert set(g) == set(w)
        for key in w:
            _assert_leaf_equal(g[key], w[key], f"layers[{i}].{key}")


def _assert_leaf_equal(got, want, where):
    if hasattr(want, "q"):
        assert torch.equal(got.q, want.q), where
        assert torch.equal(got.s.view(torch.int32),
                           want.s.view(torch.int32)), where
        return
    assert got.dtype == want.dtype and got.shape == want.shape, where
    bits = torch.int16 if got.element_size() == 2 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits)), where


def test_is_hf_dir_and_config_match_reference(hf_dir, tmp_path):
    d, model = hf_dir
    assert hf_loader.is_hf_dir(d) and ref_loader.is_hf_dir(d)
    assert not hf_loader.is_hf_dir(str(tmp_path))
    got = dataclasses.asdict(hf_loader.config_from_hf(d))
    want = dataclasses.asdict(ref_loader.config_from_hf(d))
    # attn_impl names each package's own attention choices
    common = (set(got) & set(want)) - {"attn_impl"}
    assert {"vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
            "hidden_dim", "head_dim", "rope_theta", "rope_scaling",
            "norm_eps", "tie_embeddings", "dtype"} <= common
    assert {k: got[k] for k in common} == {k: want[k] for k in common}
    assert got["vocab_size"] == model.config.vocab_size


def _config_dir(tmp_path, **overrides):
    hc = {"architectures": ["LlamaForCausalLM"], "vocab_size": VOCAB,
          "hidden_size": 128, "intermediate_size": 256,
          "num_hidden_layers": 3, "num_attention_heads": 4}
    hc.update(overrides)
    for key, value in list(hc.items()):
        if value is None:
            del hc[key]
    (tmp_path / "config.json").write_text(json.dumps(hc))
    return str(tmp_path)


def test_rope_scaling_llama3_block_parses_as_reference(tmp_path):
    block = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
             "high_freq_factor": 4.0,
             "original_max_position_embeddings": 8192}
    d = _config_dir(tmp_path, rope_scaling=block)
    got = hf_loader.config_from_hf(d)
    assert got.rope_scaling == ref_loader.config_from_hf(d).rope_scaling
    assert got.rope_scaling == (8.0, 1.0, 4.0, 8192)
    assert got.n_kv_heads == 4 and got.head_dim == 32      # defaults


@pytest.mark.parametrize("overrides", [
    {"rope_scaling": {"rope_type": "yarn", "factor": 4.0}},
    {"rope_scaling": {"rope_type": "llama3", "factor": 8.0}},
    {"architectures": ["MistralForCausalLM"]},
    {"num_attention_heads": None},
], ids=["unknown_rope_type", "llama3_missing_field", "architecture",
        "missing_field"])
def test_config_errors_match_reference(tmp_path, overrides):
    d = _config_dir(tmp_path, **overrides)
    with pytest.raises(Exception) as ref_exc:
        ref_loader.config_from_hf(d)
    with pytest.raises(type(ref_exc.value)) as exc:
        hf_loader.config_from_hf(d)
    assert str(exc.value) == str(ref_exc.value)


def test_load_bf16_bit_equal_to_reference(hf_dir):
    """The f32 file into the bf16 model: each leaf rounded to nearest even,
    bit-equal to the reference's ``jnp.asarray(arr, bf16)``."""
    d, _ = hf_dir
    cfg, params = hf_loader.load_hf_dir(d, device="cpu")
    assert cfg.dtype == "bfloat16"
    assert params["embed"].dtype == torch.bfloat16
    _assert_params_equal(params, _ref_params(d, cfg))


def test_load_f32_equals_hf_state_dict(hf_dir):
    d, model = hf_dir
    cfg, params = hf_loader.load_hf_dir(d, device="cpu", dtype="float32")
    sd = model.state_dict()
    assert torch.equal(params["embed"], sd["model.embed_tokens.weight"])
    assert torch.equal(params["lm_head"], sd["lm_head.weight"])
    assert torch.equal(params["final_norm"], sd["model.norm.weight"])
    for i, layer in enumerate(params["layers"]):
        for key, hf in llama.HF_LAYER_KEYS.items():
            assert torch.equal(layer[key], sd[f"model.layers.{i}.{hf}"])


def test_load_int8_bit_equal_to_reference_quantize_params(hf_dir):
    """Each matrix quantized as it is read equals the reference's
    ``quantize_params`` of its bf16 load, the embedding and head
    included."""
    d, _ = hf_dir
    cfg, params = hf_loader.load_hf_dir(d, device="cpu", quant="int8")
    _, jparams = ref_loader.load_hf_dir(d)
    want = llama.params_from_jax(
        jax.tree.map(np.asarray, ref_quant.quantize_params(jparams)), cfg)
    assert hasattr(params["embed"], "q") and hasattr(params["lm_head"], "q")
    _assert_params_equal(params, want)


def test_load_refuses_cpu_fallback(hf_dir, monkeypatch):
    d, _ = hf_dir
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hf_loader.load_hf_dir(d)


@pytest.mark.parametrize("drop_head", [False, True], ids=["tied", "headless"])
def test_tied_and_headless_checkpoints(tmp_path, drop_head):
    """``tie_word_embeddings`` serves without a head; an untied directory
    without ``lm_head.weight`` takes the embedding as its head, as the
    reference does."""
    model = _hf_model(tie=not drop_head, seed=3)
    d = str(tmp_path)
    model.save_pretrained(d, safe_serialization=True)
    if drop_head:
        path = os.path.join(d, "model.safetensors")
        sd = st_torch.load_file(path)
        del sd["lm_head.weight"]
        st_torch.save_file(sd, path, metadata={"format": "pt"})
    cfg, params = hf_loader.load_hf_dir(d, device="cpu")
    assert cfg.tie_embeddings == (not drop_head)
    assert ("lm_head" in params) == drop_head
    if drop_head:
        assert torch.equal(params["lm_head"], params["embed"])
    _assert_params_equal(params, _ref_params(d, cfg))


def _shard(src, dst, index=True, missing=None):
    """``src``'s model.safetensors split into two shards in ``dst`` (with
    an index, naming ``missing`` as well when given)."""
    shutil.copy(os.path.join(src, "config.json"), dst)
    sd = st_torch.load_file(os.path.join(src, "model.safetensors"))
    names = list(sd)
    halves = (names[:len(names) // 2], names[len(names) // 2:])
    weight_map = {}
    for k, part in enumerate(halves, 1):
        fname = f"model-{k:05d}-of-00002.safetensors"
        st_torch.save_file({n: sd[n] for n in part},
                           os.path.join(dst, fname), metadata={"format": "pt"})
        weight_map.update({n: fname for n in part})
    if missing:
        weight_map[missing] = "model-00001-of-00002.safetensors"
    if index:
        with open(os.path.join(dst, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f)


def test_sharded_directory_with_index(hf_dir, tmp_path):
    d, _ = hf_dir
    _shard(d, str(tmp_path))
    cfg, params = hf_loader.load_hf_dir(str(tmp_path), device="cpu")
    _assert_params_equal(params, hf_loader.load_hf_dir(d, device="cpu")[1])
    _assert_params_equal(params, _ref_params(str(tmp_path), cfg))


def test_index_naming_a_missing_tensor_raises(hf_dir, tmp_path):
    d, _ = hf_dir
    _shard(d, str(tmp_path), missing="model.layers.9.mlp.up_proj.weight")
    with pytest.raises(KeyError, match="model.layers.9.mlp.up_proj.weight"):
        hf_loader.load_hf_dir(str(tmp_path), device="cpu")


def test_missing_tensor_raises_naming_it(hf_dir, tmp_path):
    d, _ = hf_dir
    shutil.copy(os.path.join(d, "config.json"), tmp_path)
    sd = st_torch.load_file(os.path.join(d, "model.safetensors"))
    del sd["model.layers.1.self_attn.k_proj.weight"]
    st_torch.save_file(sd, str(tmp_path / "model.safetensors"))
    with pytest.raises(KeyError, match="layers.1.self_attn.k_proj"):
        hf_loader.load_hf_dir(str(tmp_path), device="cpu")


@pytest.mark.parametrize("key", ["model.layers.0.block_sparse_moe.gate.weight",
                                 "model.layers.0.self_attn.q_proj.bias"],
                         ids=["moe", "bias"])
def test_moe_and_bias_keys_raise(hf_dir, key):
    d, _ = hf_dir
    cfg = hf_loader.config_from_hf(d)
    state = hf_loader.read_state(d)
    state[key] = torch.zeros(4)
    # the dense, unbiased Llama config refuses MoE and bias tensors (the
    # MoE and StarCoder2 configs take them since A.11)
    with pytest.raises(ValueError, match="in a checkpoint for a"):
        llama.params_from_hf(state, cfg)


# ------------------------------------------------------- safetensors reader

ALL_DTYPES = (torch.float32, torch.float16, torch.bfloat16, torch.int8,
              torch.int32, torch.int64, torch.uint8, torch.bool)


def _mixed_tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dt in enumerate(ALL_DTYPES):
        x = torch.randn((3 + i, 5), generator=g) * 100
        out[f"t.{i}.{str(dt)[6:]}"] = (x > 0) if dt == torch.bool else x.to(dt)
    out["empty"] = torch.zeros((0, 4), dtype=torch.bfloat16)
    out["scalar"] = torch.tensor(2.5, dtype=torch.float32)
    return out


def test_reader_equals_safetensors_load_file(tmp_path):
    path = str(tmp_path / "x.safetensors")
    st_torch.save_file(_mixed_tensors(), path, metadata={"k": "v"})
    f = SafetensorsFile(path)
    want = st_torch.load_file(path)
    assert sorted(f) == sorted(want) and f.metadata == {"k": "v"}
    for name, w in want.items():
        got = f.tensor(name)
        assert got.dtype == w.dtype and got.shape == w.shape, name
        assert torch.equal(got, w), name
    bf16 = f.tensor("t.2.bfloat16")       # zero-copy view of the mapping
    assert f.numpy("t.2.bfloat16").dtype == np.uint16
    bf16.add_(1)                          # a private copy-on-write page
    assert torch.equal(SafetensorsFile(path).tensor("t.2.bfloat16"),
                       want["t.2.bfloat16"])


def test_smoke_writer_is_read_by_the_library(tmp_path):
    sys.path.insert(0, ROOT)
    import chip_smoke
    path = str(tmp_path / "w.safetensors")
    tensors = _mixed_tensors(seed=1)
    n = chip_smoke.write_safetensors(path, tensors, {"format": "pt"})
    assert n == os.path.getsize(path)
    got = st_torch.load_file(path)
    for name, t in tensors.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name


def _header_file(tmp_path, header, data=b"\0" * 16, length=None):
    raw = json.dumps(header).encode() if isinstance(header, dict) else header
    path = tmp_path / "bad.safetensors"
    path.write_bytes(struct.pack("<Q", len(raw) if length is None else length)
                     + raw + data)
    return str(path)


@pytest.mark.parametrize("header,length,match", [
    (b"{}", 1 << 40, "header length"),
    (b"not json", None, "not JSON"),
    (b"[1, 2]", None, "not a JSON object"),
    ({"w": {"dtype": "F64", "shape": [2], "data_offsets": [0, 16]}}, None,
     "'w': unknown dtype 'F64'"),
    ({"w": {"dtype": "F32", "shape": [2]}}, None, "'w': needs"),
    ({"w": {"dtype": "F32", "shape": [-2], "data_offsets": [0, 8]}}, None,
     "'w': bad shape"),
    ({"w": {"dtype": "F32", "shape": [8], "data_offsets": [0, 32]}}, None,
     "'w': data_offsets .* out of range"),
    ({"w": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}}, None,
     "'w': F32 \\[3\\] needs 12 bytes"),
    ({"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
      "b": {"dtype": "F32", "shape": [2], "data_offsets": [4, 12]}}, None,
     "'b' overlaps tensor 'a'"),
    ({"__metadata__": {"k": 1}}, None, "__metadata__"),
], ids=["length", "json", "not_object", "dtype", "fields", "shape", "range",
        "size", "overlap", "metadata"])
def test_reader_refuses_malformed_headers(tmp_path, header, length, match):
    path = _header_file(tmp_path, header, length=length)
    with pytest.raises(ValueError, match=match):
        SafetensorsFile(path)


def test_reader_refuses_a_short_file(tmp_path):
    path = tmp_path / "short.safetensors"
    path.write_bytes(b"\1\0\0")
    with pytest.raises(ValueError, match="shorter than"):
        SafetensorsFile(str(path))
