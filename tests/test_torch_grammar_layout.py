"""The grammar mask's layout on the port, on the CPU, against the JAX package.

* The mask's byte table (``ops/sampling.py`` ``mask_byte_table``: uint8
  bytes, int8 lengths) that ``EngineCore.ensure_token_bytes`` uploads
  equals the int32 table entry for entry, padding included, for the byte
  tokenizer (whose int32 table is the reference's) and for a seeded
  byte-level BPE tokenizer; values that do not fit are refused.
* The mask over that table is the reference's ``grammar_mask`` set.
* A row whose grammar state is <= 0 is unconstrained: ``sample_slots``
  with ``mask_states`` ignores its words, so zeros or random words there
  draw what ones draw (greedy and seeded, W = 1 and W = 5): the same
  tokens, logprobs, advanced states and top rows, and the tokens the
  reference's sampler draws from ``grammar_mask``'s ``-inf`` logits. The
  card's kernel leaves those words unwritten, so this is what makes a
  CPU run and a card run draw alike.
* End to end: grammared streams through the port's ``Scheduler`` (narrow,
  speculative and mixed dispatches) are the same when every unconstrained
  row's words are zeroed, and every mask call hands the sampler its row
  states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.engine import grammar as jgrammar
from generativeaiexamples_tpu.engine.tokenizer import ByteTokenizer
from generativeaiexamples_tpu.ops import sampling as jsampling

from generativeaiexamples_tpu_torch.engine import grammar as tgrammar
from generativeaiexamples_tpu_torch.engine.scheduler import Request, Scheduler
from generativeaiexamples_tpu_torch.engine.tokenizer import (
    ByteTokenizer as TorchByteTokenizer)
from generativeaiexamples_tpu_torch.ops import sampling, threefry

# helpers and fixtures (tiny, bpe, the autouse one_thread) of the grammar
# tests
from test_torch_grammar import (  # noqa: F401
    _core, _drive, _random_dfa, _requests, bpe, one_thread, tiny)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ----------------------------------------------------------- the byte table

def _assert_narrow_copy(core, V, n_tok):
    tb8, tl8 = core._tok_bytes8, core._tok_lens8
    assert tb8.dtype == torch.uint8 and tl8.dtype == torch.int8
    assert tuple(tb8.shape) == (V, 16) and tuple(tl8.shape) == (V,)
    assert tb8.is_contiguous() and tl8.is_contiguous()
    np.testing.assert_array_equal(tb8.numpy().astype(np.int32),
                                  core._tok_bytes.numpy())
    np.testing.assert_array_equal(tl8.numpy().astype(np.int32),
                                  core._tok_lens.numpy())
    # ids past the tokenizer's vocabulary: never allowed, no bytes
    assert (tl8[n_tok:] == -1).all() and (tb8[n_tok:] == 0).all()


def test_mask_byte_table_of_the_byte_tokenizer_equals_the_reference(tiny):
    """The byte tokenizer's table on a model of 300 entries (padded past
    the tokenizer's 259): the uint8 / int8 copy equals the int32 table,
    which equals the reference's."""
    core = _core(tiny)
    tok = TorchByteTokenizer()
    core.ensure_token_bytes(tok)
    _assert_narrow_copy(core, 300, tok.vocab_size)
    rb, rl = jgrammar.token_byte_table(ByteTokenizer())
    n = tok.vocab_size
    np.testing.assert_array_equal(core._tok_bytes8.numpy()[:n], rb)
    np.testing.assert_array_equal(core._tok_lens8.numpy()[:n], rl)


def test_mask_byte_table_of_a_bpe_tokenizer_equals_the_int32_table(bpe):
    """A seeded byte-level BPE tokenizer on a model with 7 entries past
    its vocabulary: every id as it decodes, in one byte an entry."""
    from generativeaiexamples_tpu_torch.core.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.engine import EngineCore
    from generativeaiexamples_tpu_torch.models import llama
    V = bpe.vocab_size + 7
    cfg = llama.LlamaConfig.tiny(vocab_size=V)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg)
    core = EngineCore(cfg, EngineConfig(max_batch_size=2, max_seq_len=64,
                                        page_size=8, prefill_chunk=16),
                      params, eos_id=bpe.eos_id, device="cpu")
    core.ensure_token_bytes(bpe)
    _assert_narrow_copy(core, V, bpe.vocab_size)
    tb, tl = tgrammar.token_byte_table(bpe)
    assert (tl > 1).any() and tb.max() > 127     # multi-byte, high bytes
    np.testing.assert_array_equal(core._tok_bytes8.numpy()[:len(tl)], tb)


@pytest.mark.parametrize("bad", ["byte", "length"])
def test_mask_byte_table_refuses_what_does_not_fit(bad):
    tb = np.zeros((4, 16), np.int32)
    tl = np.array([1, -1, 16, 3], np.int32)
    if bad == "byte":
        tb[2, 5] = 256
    else:
        tl[1] = 17
    with pytest.raises(ValueError):
        sampling.mask_byte_table(tb, tl)


@pytest.mark.parametrize("seed", range(4))
def test_mask_over_the_narrow_table_equals_reference(seed):
    """``grammar_mask`` (the CPU dispatch, packed) over the uint8 / int8
    table is the reference's set over the int32 one."""
    d = _random_dfa(seed, R=8)
    want = np.isfinite(np.asarray(jsampling.grammar_mask(
        jnp.asarray(d["logits"]), jnp.asarray(d["state"]),
        jnp.asarray(d["budget"]), d["eos"], jnp.asarray(d["table"]),
        jnp.asarray(d["accept"]), jnp.asarray(d["dist"]),
        jnp.asarray(d["tok_bytes"]), jnp.asarray(d["tok_lens"]))))
    tb, tl = sampling.mask_byte_table(d["tok_bytes"], d["tok_lens"])
    bits = sampling.grammar_mask(
        _t(d["state"]), _t(d["budget"]), d["eos"], _t(d["table"]),
        _t(d["accept"]), _t(d["dist"]), tb, tl)
    np.testing.assert_array_equal(sampling.unpack_mask(bits, 300).numpy(),
                                  want)


# ------------------------------------------- unconstrained rows in the draw

def _case(seed, W, temperature):
    """4 slots of W rows over a random DFA: slots 0 and 2 constrained at
    position 0, slot 1 at state -1, slot 3 at 0; rows w > 0
    unconstrained, as a widened step. Returns the inputs."""
    B = 4
    d = _random_dfa(seed, S=40, V=300, R=B * W)
    rng = np.random.default_rng(seed + 50)
    slot_state = np.array([rng.integers(1, 40), -1, rng.integers(1, 40), 0],
                          np.int32)
    rows = np.zeros((B, W), np.int32)
    rows[:, 0] = slot_state
    budget = rng.integers(0, 8, (B, W)).astype(np.int32)
    return dict(d, B=B, W=W, slot_state=slot_state,
                row_state=rows.reshape(-1), budget=budget.reshape(-1),
                seeds=np.arange(B, dtype=np.int32) + 3 * seed,
                ctr=np.arange(B, dtype=np.int32) * 5,
                temp=np.full(B, temperature, np.float32),
                top_k=np.array([0, 7, 0, 3], np.int32),
                top_p=np.array([1.0, 1.0, 0.8, 0.9], np.float32))


def _reference(c):
    """The reference's draw: grammar_mask's -inf logits, each row under
    fold_in(PRNGKey(seed_b), ctr_b + w) with its slot's settings, the
    logprob of the raw row, the advance of position 0."""
    B, W = c["B"], c["W"]
    masked = jsampling.grammar_mask(
        jnp.asarray(c["logits"]), jnp.asarray(c["row_state"]),
        jnp.asarray(c["budget"]), c["eos"], jnp.asarray(c["table"]),
        jnp.asarray(c["accept"]), jnp.asarray(c["dist"]),
        jnp.asarray(c["tok_bytes"]), jnp.asarray(c["tok_lens"]))
    rep = lambda a: jnp.asarray(np.repeat(a, W))
    ctr = np.repeat(c["ctr"], W) + np.tile(np.arange(W, dtype=np.int32), B)
    keys = jax.vmap(jax.random.fold_in)(
        jax.vmap(jax.random.PRNGKey)(rep(c["seeds"])), jnp.asarray(ctr))
    tok = np.asarray(jsampling.sample_logits_per_slot(
        keys, masked, rep(c["temp"]), rep(c["top_k"]), rep(c["top_p"])))
    lp = np.asarray(jsampling.token_logprob(jnp.asarray(c["logits"]),
                                            jnp.asarray(tok)))
    adv = np.asarray(jsampling.grammar_advance(
        jnp.asarray(c["slot_state"]), jnp.asarray(tok.reshape(B, W)[:, 0]),
        jnp.asarray(c["table"]), jnp.asarray(c["tok_bytes"]),
        jnp.asarray(c["tok_lens"])))
    return tok, lp, adv


def _port(c, bits):
    tb, tl = sampling.mask_byte_table(c["tok_bytes"], c["tok_lens"])
    keys = threefry.prng_key(_t(c["seeds"].astype(np.int64)))
    return sampling.sample_slots(
        keys, _t(c["ctr"]), c["W"], _t(c["logits"]), _t(c["temp"]),
        _t(c["top_k"]), _t(c["top_p"]), torch.ones(c["B"], dtype=torch.bool),
        allowed=bits, grammar=(_t(c["slot_state"]), _t(c["table"]),
                               _t(c["tok_bytes"]), _t(c["tok_lens"])),
        want_top=True, mask_states=_t(c["row_state"]))


@pytest.mark.parametrize("fill", ["zeros", "random"])
@pytest.mark.parametrize("W", [1, 5])
@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("seed", range(2))
def test_unconstrained_rows_ignore_their_mask_words(seed, temperature, W,
                                                    fill):
    c = _case(seed, W, temperature)
    tb, tl = sampling.mask_byte_table(c["tok_bytes"], c["tok_lens"])
    ones = sampling.grammar_mask(
        _t(c["row_state"]), _t(c["budget"]), c["eos"], _t(c["table"]),
        _t(c["accept"]), _t(c["dist"]), tb, tl)
    free = _t(c["row_state"] <= 0)
    assert free.any() and (~free).any()
    # the plain mask: every entry of an unconstrained row
    assert sampling.unpack_mask(ones[free], 300).all()
    other = ones.clone()
    g = torch.Generator().manual_seed(seed)
    other[free] = (torch.zeros_like(other[free]) if fill == "zeros" else
                   torch.randint(-2 ** 31, 2 ** 31, other[free].shape,
                                 generator=g, dtype=torch.int64).to(
                                     torch.int32))
    tok, lp, extra = _port(c, other)
    tok1, lp1, extra1 = _port(c, ones)
    assert torch.equal(tok, tok1) and torch.equal(lp, lp1)
    for key in ("next_state", "top_ids", "top_lps"):
        assert torch.equal(extra[key], extra1[key])
    want_tok, want_lp, want_adv = _reference(c)
    np.testing.assert_array_equal(tok.numpy(), want_tok)
    np.testing.assert_allclose(lp.numpy(), want_lp, atol=1e-5)
    np.testing.assert_array_equal(extra["next_state"].numpy(), want_adv)


def test_the_mask_comes_with_its_row_states():
    """``allowed`` and ``mask_states`` come together. A row at a state > 0
    reads its words: zero words draw from all -inf, index 0, as the
    reference's sampler over an all -inf row; the same row at state 0
    draws unmasked."""
    c = _case(0, 1, 0.0)
    bits = torch.zeros((4, 10), dtype=torch.int32)
    bits[:, 0] = 1 << 5            # entry 5 only, on every row
    bits[3] = 0
    keys = threefry.prng_key(_t(c["seeds"].astype(np.int64)))
    args = (keys, _t(c["ctr"]), 1, _t(c["logits"]), _t(c["temp"]),
            _t(c["top_k"]), _t(c["top_p"]), torch.ones(4, dtype=torch.bool))
    ones = torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        sampling.sample_slots(*args, allowed=bits)
    with pytest.raises(ValueError):
        sampling.sample_slots(*args, mask_states=ones)
    tok, _, _ = sampling.sample_slots(*args, allowed=bits, mask_states=ones)
    assert tok.tolist() == [5, 5, 5, 0]
    tok, _, _ = sampling.sample_slots(
        *args, allowed=bits,
        mask_states=torch.tensor([1, 1, 1, 0], dtype=torch.int32))
    assert tok.tolist()[:3] == [5, 5, 5]
    assert int(tok[3]) == int(_t(c["logits"])[3].argmax())


# ------------------------------------------------------------- end to end

@pytest.mark.parametrize("mixed", ["off", "on"])
def test_grammared_streams_alike_with_unconstrained_words_zeroed(
        tiny, monkeypatch, mixed):
    """The port's Scheduler over grammared and free requests (speculation
    on, so widened steps carry unconstrained rows w > 0): zeroing every
    unconstrained row's words after each mask call, as the card leaves
    them unwritten, streams what the plain ones stream; every mask call
    takes the uint8 / int8 table and hands its row states to the
    sampler."""
    kw = dict(prefix_cache="off", prefill_hold_chunks=0,
              mixed_phase_dispatch=mixed)
    want = _drive(Scheduler(_core(tiny, **kw), TorchByteTokenizer()),
                  _requests(Request, tgrammar, 0.8))
    mask, draw = sampling.grammar_mask, sampling.sample_slots
    seen = {"masks": 0, "free_rows": 0}

    def zeroing_mask(state, *args):
        assert args[-2].dtype == torch.uint8 and args[-1].dtype == torch.int8
        bits = mask(state, *args).clone()
        bits[state <= 0] = 0
        seen["masks"] += 1
        seen["free_rows"] += int((state <= 0).sum())
        seen["state"] = state
        return bits

    def checked_draw(*args, **opts):
        if "allowed" in opts:
            assert opts["mask_states"] is seen.pop("state")
        return draw(*args, **opts)
    monkeypatch.setattr(sampling, "grammar_mask", zeroing_mask)
    monkeypatch.setattr(sampling, "sample_slots", checked_draw)
    sched = Scheduler(_core(tiny, **kw), TorchByteTokenizer())
    got = _drive(sched, _requests(Request, tgrammar, 0.8))
    assert seen["masks"] > 0 and seen["free_rows"] > 0
    assert sched.stats["spec_steps"] > 0
    for g, w in zip(got, want):
        assert g.output_ids == w.output_ids
        assert g.logprob_data == w.logprob_data
