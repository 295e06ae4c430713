"""Per-request multi-LoRA in the PyTorch port, against the JAX package on
the CPU.

The same tiny model (``PRNGKey(5)`` weights) and the same trained adapters
(the reference's ``init_adapters`` plus seeded noise, as
``tests/test_multi_lora.py`` makes them) go to both packages, the weights
through ``params_from_jax`` and the adapters through ``adapters_from_jax``:

* ``lora_apply_plain`` equals the reference's ``_maybe_lora`` (stacked
  slots with base rows among them, and a global tree) to 1e-5 in f32,
  base rows bit-equal; ``merge_adapters``, the dense API and ``forward``
  with a global tree equal the reference's;
* through the ``Scheduler``, a mixed batch (base and two adapters)
  streams the JAX ``Scheduler``'s tokens, greedy and seeded, with
  speculation on and with int8 weights too, and equals the
  global-adapter engines' streams;
* every test of ``tests/test_multi_lora.py`` has its counterpart here: an
  unknown adapter fails loudly, the prefix cache is isolated per adapter,
  slot capacity and global exclusivity, the idempotent re-register, the
  refused rebind and rank mismatch;
* the mixed dispatch is off once an adapter is registered (a base-only
  engine keeps it and never calls the update), and every forward pass
  with an adapter row calls the update once a group of targets that share
  an input and a layer, a pass without one never; a base-only batch with
  adapters resident, and a batch in which an adapter'd request finishes
  while base rows go on, stream the JAX ``Scheduler``'s tokens.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.core.config import EngineConfig as JaxEngineConfig
from generativeaiexamples_tpu.engine.engine import EngineCore as JaxCore
from generativeaiexamples_tpu.engine.scheduler import Request as JaxRequest
from generativeaiexamples_tpu.engine.scheduler import Scheduler as JaxScheduler
from generativeaiexamples_tpu.engine.tokenizer import ByteTokenizer
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.train import lora as jlora

from generativeaiexamples_tpu_torch.core.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import kv_cache
from generativeaiexamples_tpu_torch.engine.engine import EngineCore
from generativeaiexamples_tpu_torch.engine.scheduler import Request, Scheduler
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.ops import lora as lora_ops
from generativeaiexamples_tpu_torch.ops.cuda import lora as lora_kernels
from generativeaiexamples_tpu_torch.train import lora

GEOMETRY = dict(max_batch_size=4, max_seq_len=128, page_size=8,
                prefill_chunk=16)
# both packages on the narrow two-dispatch path, prefix cache off
JAX_NARROW = dict(spec_decode="off", prefix_cache="off")
NARROW = dict(spec_decode="off", mixed_phase_dispatch="off",
              prefix_cache="off")
PROMPTS = ["the adapter determines the continuation",
           "route me to a fine-tune, then keep going for a while"]
# (prompt index, adapter name) of the mixed batch: base and two adapters
BATCH = [(0, ""), (0, "ad-a"), (1, "ad-b"), (1, "ad-a")]
TOKENS = 12
TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    cfg = jllama.LlamaConfig.tiny(vocab_size=300)
    jparams = jllama.init_params(jax.random.PRNGKey(5), cfg)
    lcfg = jlora.LoraConfig(rank=4, alpha=8.0)

    def trained(seed):
        # init_adapters zeroes "b"; real weight makes the adapters matter
        ad = jlora.init_adapters(jax.random.PRNGKey(seed), cfg, lcfg)
        return jax.tree.map(
            lambda x: x + 0.8 * jax.random.normal(
                jax.random.PRNGKey(seed + 100), x.shape, x.dtype), ad)

    jtrees = {"ad-a": trained(1), "ad-b": trained(2)}
    tcfg = llama.LlamaConfig.tiny(vocab_size=300)
    np_params = jax.tree.map(np.asarray, jparams)
    trees = {name: lora.adapters_from_jax(jax.tree.map(np.asarray, t), tcfg)
             for name, t in jtrees.items()}
    return types.SimpleNamespace(
        cfg=cfg, jparams=jparams, tcfg=tcfg, np_params=np_params,
        params=lambda: llama.params_from_jax(np_params, tcfg),
        jtrees=jtrees, trees=trees, tok=ByteTokenizer())


def _jax_streams(s, batch, temperature=0.0, adapters=None, lens=None,
                 **engine_kw):
    core = JaxCore(s.cfg, JaxEngineConfig(**GEOMETRY, **engine_kw),
                   dict(s.jparams), eos_id=s.tok.eos_id, adapters=adapters)
    if adapters is None:
        for name, tree in s.jtrees.items():
            core.register_adapter(name, tree)
    sched = JaxScheduler(core, s.tok)
    reqs = [JaxRequest(prompt_ids=s.tok.encode(PROMPTS[p], add_bos=True),
                       max_tokens=lens[i] if lens else TOKENS,
                       temperature=temperature, seed=10 + i, adapter=name,
                       logprobs=True)
            for i, (p, name) in enumerate(batch)]
    for r in reqs:
        sched.submit(r)
    while sched._tick():
        pass
    assert [r.error for r in reqs] == [None] * len(reqs)
    return [[t for t, _lp, _top in r.logprob_data] for r in reqs]


def _core(s, params=None, adapters=None, register=True, **engine_kw):
    core = EngineCore(s.tcfg, EngineConfig(**GEOMETRY, **engine_kw),
                      params or s.params(), eos_id=s.tok.eos_id,
                      device="cpu", adapters=adapters)
    if register and adapters is None:
        for name, tree in s.trees.items():
            core.register_adapter(name, tree)
    return core


def _run(sched, reqs):
    for r in reqs:
        sched.submit(r)
    while sched._tick():
        pass
    return reqs


def _torch_streams(s, batch, temperature=0.0, core=None, lens=None,
                   **engine_kw):
    sched = Scheduler(core or _core(s, **engine_kw), s.tok)
    reqs = _run(sched, [
        Request(prompt_ids=s.tok.encode(PROMPTS[p], add_bos=True),
                max_tokens=lens[i] if lens else TOKENS,
                temperature=temperature, seed=10 + i, adapter=name)
        for i, (p, name) in enumerate(batch)])
    assert [r.error for r in reqs] == [None] * len(reqs)
    return [r.output_ids for r in reqs], sched


# ---------------------------------------------------------------- the update

def _ref_maybe_lora(x, y, a, b, ix):
    name = "wq"
    tree = {name: {"a": jnp.asarray(a), "b": jnp.asarray(b)}}
    out = jllama._maybe_lora(jnp.asarray(x), jnp.asarray(y), tree, name,
                             None if ix is None else jnp.asarray(ix))
    return np.asarray(out)


@pytest.mark.parametrize("layout", ["stacked", "global"])
def test_lora_apply_plain_matches_maybe_lora(layout):
    rng = np.random.default_rng(0)
    B, S, K, O, r, N = 4, 3, 24, 20, 4, 3
    x = rng.standard_normal((B, S, K)).astype(np.float32)
    y = rng.standard_normal((B, S, O)).astype(np.float32)
    a = rng.standard_normal((N, K, r)).astype(np.float32)   # reference (in, r)
    b = rng.standard_normal((N, r, O)).astype(np.float32)   # reference (r, out)
    a[0] = b[0] = 0.0                       # slot 0: the base model
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))
    if layout == "stacked":
        ix = np.array([0, 2, 1, 0], np.int32)
        want = _ref_maybe_lora(x, y, a, b, ix)
        got = lora_ops.lora_apply_plain(t(y), t(x), t(a.transpose(0, 2, 1)),
                                        t(b.transpose(0, 2, 1)), t(ix))
        base = ix == 0
        np.testing.assert_array_equal(got.numpy()[base], y[base])
    else:
        want = _ref_maybe_lora(x, y, a[1], b[1], None)
        got = lora_ops.lora_apply_plain(t(y), t(x), t(a[1].T), t(b[1].T))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    # the dispatcher takes the plain version for CPU tensors
    args = (t(y), t(x), t(a.transpose(0, 2, 1)), t(b.transpose(0, 2, 1)),
            t(np.array([0, 2, 1, 0], np.int32)))
    assert torch.equal(lora_ops.lora_apply(*args),
                       lora_ops.lora_apply_plain(*args))


@pytest.mark.parametrize("layout", ["stacked", "global"])
def test_lora_apply_group_plain_matches_maybe_lora(layout):
    """The grouped plain version (wq|wk|wv over one x, S > 1, slot 0 among
    the rows) against the reference's ``_maybe_lora`` for each target, in
    f32 to 1e-5; base rows bit-equal; a group of CPU factors takes it."""
    rng = np.random.default_rng(3)
    B, S, K, r, N = 4, 3, 24, 4, 3
    outs = {"wq": 20, "wk": 8, "wv": 8}
    x = rng.standard_normal((B, S, K)).astype(np.float32)
    ys = {n: rng.standard_normal((B, S, o)).astype(np.float32)
          for n, o in outs.items()}
    # the reference's (N, in, r) / (N, r, out) slots, slot 0 the base model
    jab = {n: (rng.standard_normal((N, K, r)).astype(np.float32),
               rng.standard_normal((N, r, o)).astype(np.float32))
           for n, o in outs.items()}
    for a, b in jab.values():
        a[0] = b[0] = 0.0
    ix = np.array([0, 2, 1, 0], np.int32) if layout == "stacked" else None
    pick = (lambda v: v) if layout == "stacked" else (lambda v: v[1])
    tree = {n: {"a": jnp.asarray(pick(a)), "b": jnp.asarray(pick(b))}
            for n, (a, b) in jab.items()}
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))
    a_group = [t(np.swapaxes(pick(a), -1, -2)) for a, _ in jab.values()]
    b_group = [t(np.swapaxes(pick(b), -1, -2)) for _, b in jab.values()]
    slots = None if ix is None else t(ix)
    got = lora_ops.lora_apply_group_plain([t(y) for y in ys.values()], t(x),
                                          a_group, b_group, slots)
    for (n, y), g in zip(ys.items(), got):
        want = np.asarray(jllama._maybe_lora(
            jnp.asarray(x), jnp.asarray(y), tree, n,
            None if ix is None else jnp.asarray(ix)))
        np.testing.assert_allclose(g.numpy(), want, atol=TOL, rtol=TOL)
        if ix is not None:
            np.testing.assert_array_equal(g.numpy()[ix == 0], y[ix == 0])
    group = lora_ops.lora_group(list(outs), a_group, b_group)
    assert group.kernel is None
    for g, w in zip(lora_ops.lora_apply_group([t(y) for y in ys.values()],
                                              t(x), group, slots), got):
        assert torch.equal(g, w)


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_ranks():
    y = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        lora_kernels.lora_apply(y, torch.zeros((1, 2, 8)),
                                torch.zeros((2, 8, 8)),
                                torch.zeros((2, 8, 8)),
                                torch.zeros((1,), dtype=torch.int32))
    assert lora_kernels.supported_ranks(torch.bfloat16) == tuple(
        range(8, 65, 8))
    assert lora_kernels.supported_ranks(torch.float32) == tuple(
        range(4, 65, 4))
    assert lora_kernels.supported_ranks(torch.float16) == ()
    assert lora_kernels.lora_supported(16, 4096, torch.bfloat16)
    assert lora_kernels.lora_supported(8, 14336, torch.bfloat16)
    assert not lora_kernels.lora_supported(4, 4096, torch.bfloat16)
    assert not lora_kernels.lora_supported(72, 4096, torch.bfloat16)
    assert not lora_kernels.lora_supported(16, 4100, torch.bfloat16)
    assert lora_kernels.lora_supported(4, 64, torch.float32)


@pytest.mark.parametrize("T,O", [(8, 4096), (8, 14336), (72, 1024),
                                 (4096, 14336), (4096, 4096)])
def test_lora_plan_covers_every_column(T, O):
    """The grouped kernel's plan (ops/cuda/lora.py lora_plan): the expand's
    column tiles cover every column once and its row blocks every row,
    the shrink's row tiles every row; a decode batch stages every adapter
    slot at once, a prefill batch (one slot a chunk) one. The split-K
    partitions and the other shapes: tests/test_torch_lora_plan.py."""
    plan = lora_kernels.lora_plan(T, 4096, (O,), 132, 4)
    cols, rows = lora_kernels.TILE_COLS, lora_kernels.TILE_ROWS
    assert (plan.col_tiles - 1) * cols < O <= plan.col_tiles * cols
    assert (plan.row_blocks - 1) * plan.RT * rows < T \
        <= plan.row_blocks * plan.RT * rows
    assert (plan.tiles - 1) * 16 * plan.G < T <= plan.tiles * 16 * plan.G
    assert plan.SB == (3 if T <= 4 * rows else 1)


def test_merge_adapters_matches_reference(setup):
    s = setup
    jmerged = jlora.merge_adapters(s.jparams, s.jtrees["ad-a"])
    merged = lora.merge_adapters(s.params(), s.trees["ad-a"])
    want = llama.params_from_jax(jax.tree.map(np.asarray, jmerged), s.tcfg)
    for got_l, want_l in zip(merged["layers"], want["layers"]):
        for key in want_l:
            np.testing.assert_allclose(got_l[key].numpy(), want_l[key].numpy(),
                                       atol=TOL, rtol=TOL)


def test_adapters_from_jax_layout_and_refusals(setup):
    s = setup
    tree = s.trees["ad-a"]
    jtree = s.jtrees["ad-a"]
    assert sorted(tree) == sorted(jtree)
    for name in tree:
        np.testing.assert_array_equal(
            tree[name]["a"].numpy(),
            np.asarray(jtree[name]["a"]).transpose(0, 2, 1))
        np.testing.assert_array_equal(
            tree[name]["b"].numpy(),
            np.asarray(jtree[name]["b"]).transpose(0, 2, 1))
    bad = {"wq": {"a": np.zeros((2, 64, 4)), "b": np.zeros((2, 4, 63))}}
    with pytest.raises(ValueError, match="do not fit"):
        lora.adapters_from_jax(bad, s.tcfg)
    with pytest.raises(ValueError, match="unknown LoRA target"):
        lora.adapters_from_jax({"w_router": bad["wq"]}, s.tcfg)


def test_init_adapters_layout_and_refusals(setup):
    s = setup
    cfg = lora.LoraConfig(rank=16, alpha=32.0, targets=lora.TARGETS)
    tree = lora.init_adapters(torch.Generator().manual_seed(0), s.tcfg, cfg)
    for name in lora.TARGETS:
        d_in, d_out = lora.target_dims(s.tcfg, name)
        assert tree[name]["a"].shape == (2, 16, d_in)
        assert tree[name]["b"].shape == (2, d_out, 16)
        assert not tree[name]["b"].any()
    with pytest.raises(ValueError, match="unknown LoRA targets"):
        lora.LoraConfig(targets=("wq", "w_router"))
    plain_mlp = types.SimpleNamespace(mlp="plain", n_layers=1)
    with pytest.raises(ValueError, match="w_gate"):
        lora.init_adapters(torch.Generator(), plain_mlp, cfg)
    moe = types.SimpleNamespace(mlp="moe", n_layers=1)
    with pytest.raises(ValueError, match="moe"):
        lora.init_adapters(torch.Generator(), moe,
                           lora.LoraConfig(targets=("wq", "w_up")))


def test_adapter_checkpoints_wait_for_a15(setup):
    with pytest.raises(NotImplementedError, match="A.15"):
        lora.save_adapters("/nonexistent", setup.trees["ad-a"],
                           lora.LoraConfig())
    with pytest.raises(NotImplementedError, match="A.15"):
        lora.load_adapters("/nonexistent", setup.tcfg)


def test_forward_and_dense_api_with_global_adapter_match_reference(setup):
    s = setup
    rng = np.random.default_rng(1)
    B, T = 2, 40
    tokens = rng.integers(0, 259, size=(B, 10)).astype(np.int32)
    t = lambda v: torch.from_numpy(np.asarray(v))
    jtree, tree = s.jtrees["ad-b"], s.trees["ad-b"]
    params = s.params()
    np.testing.assert_allclose(
        llama.forward(params, s.tcfg, t(tokens), adapters=tree).numpy(),
        np.asarray(jllama.forward(s.jparams, s.cfg, jnp.asarray(tokens),
                                  adapters=jtree)), atol=1e-4)
    jc = jllama.KVCache(
        k=jnp.zeros((2, B, T, 2, 16)), v=jnp.zeros((2, B, T, 2, 16)),
        lengths=jnp.zeros((B,), jnp.int32))
    tc = llama.KVCache.create(s.tcfg, B, T)
    seq = np.array([10, 7], np.int32)
    start = np.zeros((B,), np.int32)
    jlog, jc = jllama.prefill(s.jparams, s.cfg, jnp.asarray(tokens), jc,
                              jnp.asarray(start), jnp.asarray(seq),
                              adapters=jtree, last_only=True)
    tlog, tc = llama.prefill(params, s.tcfg, t(tokens), tc, t(start), t(seq),
                             last_only=True, adapters=tree)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    tok = np.asarray(jlog[:, 0].argmax(-1)).astype(np.int32)
    for _ in range(3):
        jlog, jc = jllama.decode_step(s.jparams, s.cfg, jnp.asarray(tok), jc,
                                      adapters=jtree)
        tlog, tc = llama.decode_step(params, s.tcfg, t(tok), tc,
                                     adapters=tree)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
        tok = np.asarray(jlog.argmax(-1)).astype(np.int32)


# ------------------------------------------------------------- the engine

@pytest.fixture(scope="module")
def greedy(setup):
    """The JAX Scheduler's greedy streams of the mixed batch, and each
    adapter alone on a global-adapter JAX engine."""
    s = setup
    mixed = _jax_streams(s, BATCH, **JAX_NARROW)
    solo = {name: _jax_streams(s, [(p, "") for p, n in BATCH if n == name],
                               adapters=s.jtrees[name], **JAX_NARROW)
            for name in s.jtrees}
    return mixed, solo


def test_mixed_batch_greedy_streams_match_jax(setup, greedy):
    s = setup
    want, solo = greedy
    got, sched = _torch_streams(s, BATCH, **NARROW)
    assert got == want
    assert len({tuple(g) for g in got[:2]}) == 2, \
        "the adapter must change the greedy continuation"
    assert sched.core.mixed_supported is False
    # each adapter'd request equals its own run on a global-adapter engine
    for name in s.trees:
        rows = [i for i, (_, n) in enumerate(BATCH) if n == name]
        got_solo, _ = _torch_streams(
            s, [(BATCH[i][0], "") for i in rows],
            core=_core(s, adapters=s.trees[name], **NARROW))
        assert got_solo == [got[i] for i in rows] == solo[name]


def test_mixed_batch_seeded_streams_match_jax(setup):
    s = setup
    want = _jax_streams(s, BATCH, temperature=0.7, **JAX_NARROW)
    got, _ = _torch_streams(s, BATCH, temperature=0.7, **NARROW)
    assert got == want


def test_speculative_streams_match_jax_under_adapters(setup):
    """Speculation on (verify rows W > 1 through the same update), greedy
    and seeded, the mixed dispatch off on both sides once adapters are
    resident."""
    s = setup
    for temperature in (0.0, 0.7):
        want = _jax_streams(s, BATCH, temperature, prefix_cache="off",
                            prefill_hold_chunks=0)
        got, sched = _torch_streams(s, BATCH, temperature,
                                    prefix_cache="off", prefill_hold_chunks=0,
                                    mixed_phase_dispatch="on")
        assert got == want
        assert sched.stats["spec_steps"] > 0
        assert sched.stats["mixed_dispatches"] == 0


def test_int8_weights_streams_match_jax_under_adapters(setup):
    """int8 weights: the update adds to the W8A16 product, adapters stay in
    the model dtype, as the reference keeps them."""
    s = setup
    want = _jax_streams(s, BATCH, quant="int8", **JAX_NARROW)
    got, sched = _torch_streams(s, BATCH, quant="int8", **NARROW)
    assert sched.core.quant == "int8"
    assert got == want


def test_unknown_adapter_fails_loudly(setup):
    s = setup
    core = _core(s, register=False, **NARROW)
    core.register_adapter("known", s.trees["ad-a"])
    sched = Scheduler(core, s.tok)
    req, ok = _run(sched, [
        Request(prompt_ids=s.tok.encode("hi", add_bos=True), max_tokens=4,
                adapter="typo"),
        Request(prompt_ids=s.tok.encode("hi", add_bos=True), max_tokens=4,
                adapter="known")])
    assert req.error and "typo" in req.error and "known" in req.error
    assert ok.error is None and len(ok.output_ids) == 4


def test_prefix_cache_isolated_per_adapter(setup):
    s = setup
    sched = Scheduler(_core(s, spec_decode="off", mixed_phase_dispatch="off"),
                      s.tok)
    prompt = s.tok.encode("shared template text that spans several pages "
                          "easily here", add_bos=True)
    mk = lambda ad: Request(prompt_ids=list(prompt), max_tokens=6,
                            temperature=0.0, adapter=ad)
    _run(sched, [mk("ad-a")])
    hit0 = sched.stats["prefix_hit_tokens"]
    (b,) = _run(sched, [mk("ad-b")])
    # another adapter: other weights, other KV, no sharing despite equal
    # tokens
    assert sched.stats["prefix_hit_tokens"] == hit0 and not \
        b.prefix_hit_tokens
    (a2,) = _run(sched, [mk("ad-a")])
    assert sched.stats["prefix_hit_tokens"] > hit0 and a2.prefix_hit_tokens
    (a3,) = _run(sched, [mk("ad-a")])
    assert a2.output_ids == a3.output_ids
    assert b.output_ids != a2.output_ids


def test_adapter_capacity_and_global_exclusivity(setup):
    s = setup
    core = _core(s, register=False, max_adapters=2, **NARROW)
    assert core.register_adapter("only", s.trees["ad-a"]) == 1
    with pytest.raises(ValueError, match="slots"):
        core.register_adapter("overflow", s.trees["ad-b"])
    gcore = _core(s, adapters=s.trees["ad-a"], **NARROW)
    with pytest.raises(ValueError, match="global"):
        gcore.register_adapter("late", s.trees["ad-b"])
    with pytest.raises(ValueError, match="non-empty"):
        core.register_adapter("", s.trees["ad-b"])


def test_reregister_is_idempotent_rebind_and_rank_mismatch_refused(setup):
    s = setup
    core = _core(s, register=False, **NARROW)
    assert core.register_adapter("ad-a", s.trees["ad-a"]) == 1
    assert core.register_adapter("ad-b", s.trees["ad-b"]) == 2
    # a bit-equal copy is the same adapter
    copy = {t: {k: v.clone() for k, v in ab.items()}
            for t, ab in s.trees["ad-a"].items()}
    assert core.register_adapter("ad-a", copy) == 1
    assert core.adapter_names == ["ad-a", "ad-b"]
    assert core.adapter_index("ad-b") == 2 and core.adapter_index("") == 0
    with pytest.raises(KeyError):
        core.adapter_index("typo")
    # a delta under any tolerance is still a rebind
    nudged = {t: {k: v.clone() for k, v in ab.items()}
              for t, ab in s.trees["ad-a"].items()}
    nudged["wq"]["b"][0, 0, 0] += 1e-6
    with pytest.raises(ValueError, match="rebinding"):
        core.register_adapter("ad-a", nudged)
    # another rank than the first registration's layout
    rank8 = lora.adapters_from_jax(jax.tree.map(np.asarray, jlora.init_adapters(
        jax.random.PRNGKey(3), s.cfg, jlora.LoraConfig(rank=8))), s.tcfg)
    with pytest.raises(ValueError, match="rank/targets"):
        core.register_adapter("rank8", rank8)
    # other targets than the resident ones
    fewer = {t: ab for t, ab in s.trees["ad-b"].items() if t != "wo"}
    with pytest.raises(ValueError, match="rank/targets"):
        core.register_adapter("fewer", fewer)
    assert core.adapter_names == ["ad-a", "ad-b"]


def test_mixed_dispatch_off_once_adapters_are_resident(setup, monkeypatch):
    s = setup
    calls = []
    real = lora_ops.lora_apply_group
    monkeypatch.setattr(lora_ops, "lora_apply_group",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    base = _core(s, register=False, mixed_phase_dispatch="on",
                 prefill_hold_chunks=0)
    assert base.mixed_supported
    got, sched = _torch_streams(s, [(0, ""), (1, "")], core=base)
    assert not calls, "a base-only engine never calls the update"
    base.register_adapter("ad-a", s.trees["ad-a"])
    assert not base.mixed_supported
    assert sched.load_stats()["mixed"] is False
    job = types.SimpleNamespace(adapter_ix=1, prefilled=0, ids=[1] * 4,
                                request=types.SimpleNamespace(adapter="ad-a"))
    assert not sched._mixed_eligible(job)
    with pytest.raises(ValueError, match="base weights only"):
        kv_cache.mixed_step(base.params, base.model_cfg,
                            torch.zeros((4, 1), dtype=torch.int32), None,
                            None, None, 1, None, None, None, None,
                            adapters=base.adapters)


def test_update_runs_once_a_target_and_layer_a_forward(setup, monkeypatch):
    """The card's launch rule at the tiny size: one update call a group of
    targets that share an input (wq|wk|wv and wo at the reference's four
    targets) and a layer in every forward pass that has an adapter row
    (the warmup's included, which visits the adapter path), none in a pass
    without one; the engine counts the passes that made them."""
    s = setup
    calls, passes = [], []
    real, real_blocks = lora_ops.lora_apply_group, llama.run_blocks
    monkeypatch.setattr(lora_ops, "lora_apply_group",
                        lambda *a, **k: calls.append(1) or real(*a, **k))

    def blocks(*a, **k):
        passes.append(k.get("adapters", a[6] if len(a) > 6 else None)
                      is not None)
        return real_blocks(*a, **k)

    monkeypatch.setattr(llama, "run_blocks", blocks)
    core = _core(s, **NARROW)
    assert core.lora_groups == 2
    core.warmup()
    assert passes and all(passes)
    assert len(calls) == 2 * 2 * len(passes) == 2 * 2 * core.lora_passes
    for batch, with_adapters in ((BATCH, True), ([(0, ""), (1, "")], False)):
        calls.clear()
        passes.clear()
        done = core.lora_passes
        _torch_streams(s, batch, core=core)
        assert passes and any(passes) == with_adapters
        assert len(calls) == 2 * 2 * sum(passes) \
            == 2 * 2 * (core.lora_passes - done)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_base_only_batch_streams_match_jax_without_an_update(
        setup, monkeypatch, temperature):
    """Adapters resident and only base-model requests: the JAX
    ``Scheduler``'s streams, greedy and seeded, and no update call."""
    s = setup
    batch = [(0, ""), (1, ""), (1, "")]
    want = _jax_streams(s, batch, temperature, **JAX_NARROW)
    calls = []
    real = lora_ops.lora_apply_group
    monkeypatch.setattr(lora_ops, "lora_apply_group",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    core = _core(s, **NARROW)
    got, _ = _torch_streams(s, batch, temperature, core=core)
    assert got == want
    assert not calls and core.lora_passes == 0


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_adapter_request_finishing_while_base_rows_continue(setup,
                                                            temperature):
    """An adapter'd request of 3 tokens beside base requests of 12: once
    it ends its slot returns to the base model, so the passes after it
    make no update call (``lora_passes`` stays where it was when the
    request finished), and every stream equals the JAX ``Scheduler``'s,
    greedy and seeded."""
    s = setup
    batch, lens = [(0, ""), (1, "ad-a"), (1, "")], [TOKENS, 3, TOKENS]
    want = _jax_streams(s, batch, temperature, lens=lens, **JAX_NARROW)
    sched = Scheduler(_core(s, **NARROW), s.tok)
    reqs = [Request(prompt_ids=s.tok.encode(PROMPTS[p], add_bos=True),
                    max_tokens=n, temperature=temperature, seed=10 + i,
                    adapter=name)
            for i, ((p, name), n) in enumerate(zip(batch, lens))]
    for r in reqs:
        sched.submit(r)
    at_end, ticks_after = None, 0
    while sched._tick():
        if reqs[1].finished_at is None:
            continue
        if at_end is None:
            at_end = sched.core.lora_passes
        else:
            ticks_after += 1
    assert [r.error for r in reqs] == [None] * len(reqs)
    got = [r.output_ids for r in reqs]
    assert got == want
    assert [len(g) for g in got] == lens
    assert at_end > 0 and ticks_after > 0
    assert sched.core.lora_passes == at_end
    assert not sched._state.adapter_host.any()


def test_config_max_adapters_defaults_to_the_reference(monkeypatch):
    from generativeaiexamples_tpu.core.config import EngineConfig as JaxCfg

    from generativeaiexamples_tpu_torch.core.config import (NOT_PORTED,
                                                            load_config)
    assert EngineConfig().max_adapters == JaxCfg().max_adapters == 4
    assert "max_adapters" not in NOT_PORTED
    monkeypatch.setenv("APP_ENGINE_MAX_ADAPTERS", "2")
    assert load_config().engine.max_adapters == 2


def test_adapter_directories_exit_naming_a15(monkeypatch):
    from generativeaiexamples_tpu_torch.engine.__main__ import build_scheduler
    monkeypatch.setenv("APP_ENGINE_ADAPTERS", "tuned=/tmp/adapters")
    with pytest.raises(SystemExit, match="A.15"):
        build_scheduler(tiny=True, device="cpu")
