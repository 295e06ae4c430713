"""Port's Llama forward against the JAX package's on the CPU: the JAX tiny
config's ``PRNGKey(0)`` weights carried over by ``params_from_jax`` give
logits within 1e-4 of JAX's (f32 on both sides; only the summation order
of the matmuls differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu_torch.models import llama as tl

ATOL = 1e-4


@pytest.mark.parametrize("tie", [True, False])
def test_forward_logits_match_jax(tie):
    import dataclasses
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), tie_embeddings=tie,
                               rope_scaling=None if tie else (8.0, 1.0, 4.0,
                                                              64))
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), tie_embeddings=tie,
                               rope_scaling=jcfg.rope_scaling)
    params = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, size=(2, 12)).astype(np.int32)
    mask = np.ones((2, 12), bool)
    mask[1, 9:] = False
    want = np.asarray(jl.forward(params, jcfg, jnp.asarray(tokens),
                                 attn_mask=jnp.asarray(mask)))
    got = tl.forward(tparams, tcfg, torch.from_numpy(tokens),
                     attn_mask=torch.from_numpy(mask)).numpy()
    assert got.shape == (2, 12, 256) and got.dtype == np.float32
    np.testing.assert_allclose(got[0], want[0], atol=ATOL)
    np.testing.assert_allclose(got[1, :9], want[1, :9], atol=ATOL)


def test_params_layout_and_init():
    cfg = tl.LlamaConfig.tiny()
    p = tl.init_params(torch.Generator().manual_seed(0), cfg)
    layer = p["layers"][0]
    assert layer["wq"].shape == (cfg.n_heads * cfg.head_dim, cfg.dim)
    assert layer["w_down"].shape == (cfg.dim, cfg.hidden_dim)
    # fan-in scaled: a (out, in) weight has std ~ 1/sqrt(in)
    assert abs(layer["w_gate"].std().item() * cfg.dim ** 0.5 - 1) < 0.05
    again = tl.init_params(torch.Generator().manual_seed(0), cfg)
    assert torch.equal(again["layers"][1]["wo"], p["layers"][1]["wo"])
    assert len(p["layers"]) == cfg.n_layers and "lm_head" not in p


def test_params_from_jax_refuses_unported_leaves():
    cfg = tl.LlamaConfig.tiny()
    tree = {"embed": np.zeros((256, 64)), "final_norm": np.ones(64),
            "layers": {"wq_b": np.zeros((2, 64))}}
    # a bias leaf for a config without use_bias (biases, LayerNorm and MoE
    # are ported since A.11: the refusal is of a tree the config lacks)
    with pytest.raises(ValueError, match="not leaves of this config"):
        tl.params_from_jax(tree, cfg)
