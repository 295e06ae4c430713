"""Logprobs, top logprobs and ``n`` in the port, on the CPU, against the
JAX package.

* ``top_logprobs_plain`` equals ``jax.lax.top_k`` minus logsumexp on
  bf16-rounded rows with forced ties (ids exact, ties to the lower index;
  values within 1e-5), and ``sample_slots_plain(want_top=True)`` returns
  it beside the draw.
* ``unpack_decode_out`` splits a block with top rows as the reference's
  does; a ``want_top`` dispatch appends them in the reference's order.
* Through both ``Scheduler``s on the same bridged weights: the
  ``logprob_data`` triples of greedy and seeded requests (top 5, top 3 and
  none) over narrow, widened and mixed dispatches are equal, tokens and
  top ids exactly, logprobs within 1e-5; the fused first token has no top
  rows; ``n`` = 2 choices seeded ``seed`` and ``seed + 1`` stream what the
  reference streams for them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.core.config import EngineConfig as JaxEngineConfig
from generativeaiexamples_tpu.engine import engine as jengine
from generativeaiexamples_tpu.engine.engine import EngineCore as JaxCore
from generativeaiexamples_tpu.engine.scheduler import Request as JaxRequest
from generativeaiexamples_tpu.engine.scheduler import Scheduler as JaxScheduler
from generativeaiexamples_tpu.engine.tokenizer import ByteTokenizer
from generativeaiexamples_tpu.models import llama as jllama

from generativeaiexamples_tpu_torch.core.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import engine as tengine
from generativeaiexamples_tpu_torch.engine.engine import EngineCore
from generativeaiexamples_tpu_torch.engine.scheduler import Request, Scheduler
from generativeaiexamples_tpu_torch.engine.tokenizer import (
    ByteTokenizer as TorchByteTokenizer)
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.ops import sampling, threefry

GEOMETRY = dict(max_batch_size=4, max_seq_len=256, page_size=8,
                prefill_chunk=16)
QUOTE = ("the retrieved context says: alpha beta gamma delta. "
         "the retrieved context says: alpha beta gamma delta. "
         "question: repeat the context. answer: the retrieved")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tied_rows(seed, R, V):
    """bf16-rounded N(0, 2) rows where some rows' top entries tie: three
    at the top value and two at the next."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, V)).astype(np.float32) * 2
    for r in range(0, R, 2):
        ix = rng.choice(V, 5, replace=False)
        x[r, ix[:3]] = x[r].max() + 1.0
        x[r, ix[3:]] = x[r].max() - 0.5
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("V", [300, 4096])
@pytest.mark.parametrize("seed", range(4))
def test_top_logprobs_plain_equals_jax_top_k(seed, V):
    raw = _tied_rows(seed, 6, V)
    vals, ids = jax.lax.top_k(jnp.asarray(raw), 5)
    want = np.asarray(vals - jax.nn.logsumexp(jnp.asarray(raw), axis=-1,
                                              keepdims=True))
    got_ids, got_lps = sampling.top_logprobs_plain(
        torch.from_numpy(raw).to(torch.bfloat16))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ids))
    np.testing.assert_allclose(got_lps.numpy(), want, atol=1e-5)
    assert got_ids.dtype == torch.int32
    # the tied rows really tie, and the lower index comes first
    tied = raw[0, np.asarray(ids)[0]]
    assert tied[0] == tied[1] == tied[2]
    assert list(np.asarray(ids)[0, :3]) == sorted(np.asarray(ids)[0, :3])


def test_sample_slots_plain_returns_the_top_rows_beside_the_draw():
    raw = torch.from_numpy(_tied_rows(7, 6, 300))
    keys = threefry.prng_key(torch.arange(3))
    args = (keys, torch.zeros(3, dtype=torch.int32), 2, raw,
            torch.tensor([0.0, 0.7, 1.0]), torch.zeros(3, dtype=torch.int32),
            torch.ones(3), torch.ones(3, dtype=torch.bool))
    tok, lp, extra = sampling.sample_slots(*args, want_top=True)
    base = sampling.sample_slots(*args)
    assert torch.equal(tok, base[0]) and torch.equal(lp, base[1])
    ids, lps = sampling.top_logprobs_plain(raw)
    assert torch.equal(extra["top_ids"], ids)
    assert torch.equal(extra["top_lps"], lps)
    assert set(extra) == {"top_ids", "top_lps"} and base[2] == {}


def test_unpack_decode_out_equals_reference():
    rng = np.random.default_rng(0)
    for rows in (len(tengine._PACKED_FIELDS),
                 len(tengine._PACKED_FIELDS) + 2 * tengine.TOP_LP):
        packed = rng.integers(-2 ** 31, 2 ** 31, (rows, 6, 4)).astype(
            np.int32)
        got = tengine.unpack_decode_out(packed)
        want = jengine.unpack_decode_out(packed)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].view(np.int32),
                                          want[k].view(np.int32))
    assert tengine.TOP_LP == jengine.TOP_LP == sampling.TOP_LP
    assert tengine.bits_to_f32(np.float32(1.5).view(np.int32)) == 1.5


@pytest.fixture(scope="module")
def tiny():
    cfg = jllama.LlamaConfig.tiny(vocab_size=300)
    jparams = jllama.init_params(jax.random.PRNGKey(5), cfg)
    tcfg = llama.LlamaConfig.tiny(vocab_size=300)
    tparams = llama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return cfg, jparams, tcfg, tparams


def _core(tiny, **kw):
    _, _, tcfg, tparams = tiny
    return EngineCore(tcfg, EngineConfig(**{**GEOMETRY, **kw}), tparams,
                      eos_id=ByteTokenizer().eos_id, device="cpu")


def _jax_core(tiny, **kw):
    cfg, jparams, _, _ = tiny
    return JaxCore(cfg, JaxEngineConfig(**{**GEOMETRY, **kw}), jparams,
                   eos_id=ByteTokenizer().eos_id)


def test_want_top_dispatch_packs_the_reference_rows(tiny):
    """A decode with ``want_top`` appends TOP_LP id rows and TOP_LP
    logprob rows, each (steps * W, B), equal to the top rows of the logits
    the step drew from."""
    core = _core(tiny, prefix_cache="off", spec_decode="off")
    sched = Scheduler(core, TorchByteTokenizer())
    req = sched.submit(Request(prompt_ids=ByteTokenizer().encode(
        "hello", add_bos=True), max_tokens=6, temperature=0.0,
        logprobs=True, top_logprobs=5))
    for _ in range(50):
        if not sched._tick() and req.finished_at:
            break
    assert req.error is None
    first, *rest = req.logprob_data
    assert first[2] is None              # the fused first token: no top rows
    for tok, lp, top in rest:
        assert len(top) == 5 and top[0][0] == tok   # greedy: the argmax
        assert abs(top[0][1] - lp) < 1e-6
        assert [l for _, l in top] == sorted((l for _, l in top),
                                             reverse=True)


def _requests(make, seed=21):
    tok = ByteTokenizer()
    return [make(prompt_ids=tok.encode("hello", add_bos=True), max_tokens=40,
                 temperature=0.0, logprobs=True, top_logprobs=5),
            make(prompt_ids=tok.encode(QUOTE[:110], add_bos=True),
                 max_tokens=32, temperature=0.7, top_p=0.9, seed=seed,
                 logprobs=True, top_logprobs=3),
            make(prompt_ids=tok.encode(QUOTE[:90], add_bos=True),
                 max_tokens=20, temperature=0.0, logprobs=True),
            make(prompt_ids=tok.encode("two choices", add_bos=True),
                 max_tokens=16, temperature=0.8, seed=seed + 5,
                 logprobs=True),
            make(prompt_ids=tok.encode("two choices", add_bos=True),
                 max_tokens=16, temperature=0.8, seed=seed + 6,
                 logprobs=True)]


def _drive(sched, reqs, first_ticks=2, cap=1500):
    sched.submit(reqs[0])
    for _ in range(first_ticks):
        sched._tick()
    for r in reqs[1:]:
        sched.submit(r)
    for _ in range(cap):
        if not sched._tick() and all(r.finished_at for r in reqs):
            break
    for r in reqs:
        assert r.error is None and r.finished_at, r.error
    return reqs


def _assert_logprob_data_equal(got, want):
    for g, w in zip(got, want):
        assert len(g.logprob_data) == len(w.logprob_data) > 0
        assert [t for t, _, _ in g.logprob_data] == \
            [t for t, _, _ in w.logprob_data]
        np.testing.assert_allclose([lp for _, lp, _ in g.logprob_data],
                                   [lp for _, lp, _ in w.logprob_data],
                                   atol=1e-5)
        for (_, _, gt), (_, _, wt) in zip(g.logprob_data, w.logprob_data):
            assert (gt is None) == (wt is None)
            if gt is not None:
                assert [i for i, _ in gt] == [i for i, _ in wt]
                np.testing.assert_allclose([l for _, l in gt],
                                           [l for _, l in wt], atol=1e-5)


@pytest.mark.parametrize("fields", [
    dict(spec_decode="off", mixed_phase_dispatch="off"),
    dict(mixed_phase_dispatch="off"), dict(mixed_phase_dispatch="on")],
    ids=["narrow", "widened", "mixed"])
def test_logprob_data_equals_jax_scheduler(tiny, fields):
    kw = dict(prefix_cache="off", prefill_hold_chunks=0, **fields)
    want = _drive(JaxScheduler(_jax_core(tiny, **kw), ByteTokenizer()),
                  _requests(JaxRequest))
    sched = Scheduler(_core(tiny, **kw), TorchByteTokenizer())
    got = _drive(sched, _requests(Request))
    _assert_logprob_data_equal(got, want)
    tops = [t for r in got[:2] for _, _, t in r.logprob_data[1:]]
    assert tops and all(t is not None for t in tops)
    assert all(len(t) == 5 for _, _, t in got[0].logprob_data[1:])
    assert all(len(t) == 3 for _, _, t in got[1].logprob_data[1:])
    assert all(t is None for r in got[2:] for _, _, t in r.logprob_data)
    if fields.get("spec_decode") != "off":
        assert sched.stats["spec_steps"] > 0
    if fields["mixed_phase_dispatch"] == "on":
        assert sched.stats["mixed_dispatches"] > 0
    # the n = 2 pair: two seeds, two streams
    assert got[3].output_ids != got[4].output_ids


def test_logprob_data_with_the_pipeline_defaults(tiny):
    """The defaults (two dispatches in flight, the hold, the width
    ladder, the prefix cache): a top-logprob request pins its dispatches
    to the full batch and the ceiling width; the triples still equal the
    JAX Scheduler's at its defaults."""
    want = _drive(JaxScheduler(_jax_core(tiny), ByteTokenizer()),
                  _requests(JaxRequest))
    sched = Scheduler(_core(tiny), TorchByteTokenizer())
    got = _drive(sched, _requests(Request))
    _assert_logprob_data_equal(got, want)
