"""The port's top-k capacity MoE (``ops/moe.py``) against the reference's.

Inputs come from numpy seeds; the weights are the reference's
``init_moe_params`` draw carried into the port's (out, in) layout. The
reference returns only (out, aux), so its routing is taken from
``_jax_routing``, the lines of ``generativeaiexamples_tpu/ops/moe.py``
that compute it, op for op (top_k, the rank-major cumsum, the capacity
gate).

* Routing (choices, slots, keep) exactly equal, with and without drops,
  in f32 and bf16 activations; out within ``TOL`` (f32) or ``TOL_BF16``
  (bf16, where the expert products round), aux within ``TOL``.
* Ties: a zero input (all logits equal) and a router with two equal
  columns give the reference's order, lower expert first.
* The per-token dense loop of the reference's
  ``test_moe_matches_dense_reference_without_drops``.
* The port's own rule: a token outside ``valid`` takes no expert slot, so
  padding rows ahead of real tokens never displace them.
* ``chip_smoke.py``'s acceptance of a kernel-vs-plain MoE stream split:
  only at a router near-tie of the plain run.
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.ops import moe as jmoe

from generativeaiexamples_tpu_torch.ops import moe

TOL = 1e-5
TOL_BF16 = 3e-2
D, F, E, K = 32, 64, 4, 2


def _params(seed=0, e=E):
    """(reference params, port params): ``init_moe_params`` there, the
    router and the stacks transposed into the port's (out, in) layout."""
    jp = jmoe.init_moe_params(jax.random.PRNGKey(seed), dim=D,
                              hidden_dim=F, n_experts=e)
    return jp, _to_port(jp)


def _to_port(jp, dtype=torch.float32):
    np_ = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    return {"w_router": t(np_["w_router"].T),
            "w_gate": t(np_["w_gate"].transpose(0, 2, 1)),
            "w_up": t(np_["w_up"].transpose(0, 2, 1)),
            "w_down": t(np_["w_down"].transpose(0, 2, 1))}


def _jax_routing(jp, x, k, capacity_factor):
    """The reference's routing, its lines op for op: (expert_ix, slot,
    keep, C) as numpy."""
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    N = xf.shape[0]
    n_e = jp["w_router"].shape[-1]
    C = jmoe.capacity(N, n_e, k, capacity_factor)
    logits = xf.astype(jnp.float32) @ jp["w_router"].astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_ix = jax.lax.top_k(probs, k)
    choice_oh = jax.nn.one_hot(expert_ix, n_e)
    flat = choice_oh.transpose(1, 0, 2).reshape(k * N, n_e)
    pos = jnp.cumsum(flat, axis=0) - flat
    pos = pos.reshape(k, N, n_e).transpose(1, 0, 2)
    slot = (pos * choice_oh).sum(-1).astype(jnp.int32)
    keep = slot < C
    return (np.asarray(expert_ix), np.asarray(slot), np.asarray(keep), C)


def _compare(jp, tp, x, k, cf, dtype):
    """Routing equal, out and aux within tolerance; returns the drops."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    xj = jnp.asarray(x, jdt)
    want, want_aux = jmoe.moe_mlp(jp, xj, k=k, capacity_factor=cf)
    xt = torch.from_numpy(x).to(tdt)
    got, got_aux = moe.moe_mlp(tp, xt, k=k, capacity_factor=cf)
    assert got.dtype == tdt and got.shape == xt.shape
    ix, slot, keep, C = _jax_routing(jp, np.asarray(xj.astype(jnp.float32)),
                                     k, cf)
    r = moe.route(xt.reshape(-1, D), tp["w_router"], k, C)
    np.testing.assert_array_equal(r.expert_ix.numpy(), ix)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    tol = TOL if dtype == "float32" else TOL_BF16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(float(got_aux), float(want_aux), atol=TOL,
                               rtol=TOL)
    return int((~keep).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf,drops", [(2.0, False), (0.5, True)],
                         ids=["no_drops", "drops"])
def test_moe_mlp_matches_reference(cf, drops, dtype):
    jp, tp = _params(0)
    x = np.random.default_rng(1).standard_normal((3, 16, D)).astype(
        np.float32)
    n_dropped = _compare(jp, tp, x, K, cf, dtype)
    assert (n_dropped > 0) == drops


def test_tied_probabilities_pick_the_lower_expert_first():
    """A zero input gives every expert the same probability, and a router
    with two equal columns ties those two for every token: the port picks
    the lower index first, as ``jax.lax.top_k`` does, and routes as the
    reference does."""
    jp, tp = _params(2)
    x = np.zeros((10, D), np.float32)
    _compare(jp, tp, x, K, 0.5, "float32")
    r = moe.route(torch.zeros((10, D)), tp["w_router"], K, 8)
    assert r.expert_ix.tolist() == [[0, 1]] * 10
    # experts 1 and 3 share a router column: every token ties them
    w = np.asarray(jp["w_router"]).copy()
    w[:, 3] = w[:, 1]
    jp2 = dict(jp, w_router=jnp.asarray(w))
    tp2 = _to_port(jp2)
    x = np.random.default_rng(3).standard_normal((24, D)).astype(np.float32)
    _compare(jp2, tp2, x, K, 0.5, "float32")
    r = moe.route(torch.from_numpy(x), tp2["w_router"], K, 16)
    both = (r.expert_ix == 1).any(1) & (r.expert_ix == 3).any(1)
    assert both.any()
    assert (r.expert_ix[both] == torch.tensor([1, 3])).all()


def _dense_reference(jp, x, k):
    """The reference test's per-token loop: softmax router, top-k, the
    chosen experts run densely, gates renormalized."""
    N = x.shape[0]
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jp["w_router"],
                                      axis=-1))
    out = np.zeros((N, D), np.float32)
    for n in range(N):
        top = np.argsort(-probs[n])[:k]
        gates = probs[n][top] / probs[n][top].sum()
        for g, e in zip(gates, top):
            h = x[n] @ np.asarray(jp["w_gate"][e])
            u = x[n] @ np.asarray(jp["w_up"][e])
            act = h / (1 + np.exp(-h)) * u
            out[n] += g * (act @ np.asarray(jp["w_down"][e]))
    return out


def test_moe_matches_dense_reference_without_drops():
    jp, tp = _params(0)
    x = np.random.default_rng(4).standard_normal((12, D)).astype(np.float32)
    out, aux = moe.moe_mlp(tp, torch.from_numpy(x), k=2,
                           capacity_factor=8.0)
    np.testing.assert_allclose(out.numpy(), _dense_reference(jp, x, 2),
                               atol=1e-4, rtol=1e-4)
    assert float(aux) > 0.0


def test_padded_tokens_never_displace_valid_ones():
    """Eight identical padding rows ahead of 32 real tokens, with a
    capacity that drops: without ``valid`` the pads' choices take their
    experts' first slots and push real tokens out; with it, the real
    tokens route exactly as if the pads were absent (same C), and their
    outputs equal a pass over the real tokens alone (capacity(40) ==
    capacity(32) here)."""
    _, tp = _params(5)
    rng = np.random.default_rng(6)
    real = torch.from_numpy(rng.standard_normal((32, D)).astype(np.float32))
    pads = torch.zeros((8, D)) + real[0]
    x = torch.cat([pads, real])
    valid = torch.arange(40) >= 8
    C = moe.capacity(40, E, K, 0.5)
    assert C == moe.capacity(32, E, K, 0.5)
    alone = moe.route(real, tp["w_router"], K, C)
    masked = moe.route(x, tp["w_router"], K, C, valid=valid)
    unmasked = moe.route(x, tp["w_router"], K, C)
    for name in ("expert_ix", "slot", "keep", "gates"):
        assert torch.equal(getattr(masked, name)[8:], getattr(alone, name))
    assert not masked.keep[:8].any()
    assert (~alone.keep).any()                       # the case drops
    assert (unmasked.keep[8:] != alone.keep).any()   # pads would displace
    out, _ = moe.moe_mlp(tp, x, k=K, capacity_factor=0.5, valid=valid)
    out_alone, _ = moe.moe_mlp(tp, real, k=K, capacity_factor=0.5)
    np.testing.assert_allclose(out[8:].numpy(), out_alone.numpy(),
                               atol=1e-6, rtol=1e-6)
    assert torch.equal(out[:8], torch.zeros_like(out[:8]))


@pytest.mark.parametrize("n", [1, 7, 8, 48, 512, 4096])
@pytest.mark.parametrize("cf", [0.5, 1.25, 2.0])
def test_capacity_matches_reference(n, cf):
    assert moe.capacity(n, 8, 2, cf) == jmoe.capacity(n, 8, 2, cf)


def test_init_moe_params_layout():
    g = torch.Generator().manual_seed(0)
    p = moe.init_moe_params(g, dim=D, hidden_dim=F, n_experts=E,
                            dtype=torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w_router": (E, D), "w_gate": (E, F, D), "w_up": (E, F, D),
        "w_down": (E, D, F)}
    assert all(v.dtype == torch.bfloat16 for v in p.values())
    x = torch.randn((5, D), generator=g).bfloat16()
    out, aux = moe.moe_mlp(p, x)
    assert out.shape == x.shape and torch.isfinite(out.float()).all()
    assert float(aux) > 0


def _smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("kernel_margin,plain_margin,accepted", [
    (1e-7, 0.1, False),     # near a tie only in the kernel run
    (0.1, 1e-7, True),      # near a tie in the plain run
    (0.1, 0.1, False)])
def test_moe_stream_split_accepted_only_at_a_plain_near_tie(
        kernel_margin, plain_margin, accepted):
    """Two runs' routing logs (two layers, four tokens, the last a pad)
    that part at the second layer's third token: the split is excused only
    when the plain run's margin there is under ``ROUTER_NEAR_TIE``,
    whatever the kernel run's margin, and a pad routed apart is no
    split."""
    smoke = _smoke()
    ix = torch.tensor([[0, 1], [2, 3], [1, 0], [3, 2]])
    valid = torch.tensor([True, True, True, False])
    apart = ix.clone()
    apart[2] = torch.tensor([2, 0])
    apart[3] = torch.tensor([0, 1])

    def log(second, margin):
        m = torch.full((4,), 0.5)
        m[2] = margin
        return [(ix, valid, torch.full((4,), 0.5)), (second, valid, m)]

    logs = [log(apart, kernel_margin), log(ix, plain_margin)]
    split = smoke._first_routing_split(*logs)
    assert split == (1, pytest.approx(plain_margin))
    cfg = types.SimpleNamespace(n_layers=2)
    args = (None, cfg, [[1], [2]], [[5, 6], [7]], [[5, 6], [8]], logs,
            torch.device("cpu"), "planted split")
    if accepted:
        report = smoke._moe_parity_report(*args)
        assert [r["identical"] for r in report] == [True, False]
        assert report[1]["routing_split_layer"] == 1
    else:
        with pytest.raises(AssertionError, match="router margin"):
            smoke._moe_parity_report(*args)
    only_pad = log(ix.clone(), kernel_margin)
    only_pad[1][0][3] = torch.tensor([0, 1])
    assert smoke._first_routing_split(only_pad, log(ix, plain_margin)) is None
