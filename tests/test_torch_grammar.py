"""Constrained decoding in the port, on the CPU, against the JAX package.

* ``grammar_mask_plain`` and ``grammar_advance_plain`` equal the
  reference's ``grammar_mask`` / ``grammar_advance`` exactly on random
  DFAs, states (unconstrained ones among them) and budgets; the bitmask
  the kernels take round-trips; a masked ``sample_slots_plain`` draws what
  the reference's sampler draws from its ``-inf`` logits, and takes the
  logprob from the raw row.
* The port's copies of ``engine/grammar.py`` and ``engine/tools.py`` equal
  the reference's on the cases of ``tests/test_constrained.py`` and
  ``tests/test_tool_calling.py``: the same DFAs (table, accept, dist,
  start, key), token byte tables, prompts, parses and streamer events.
* The grammar stack registers, pins and evicts as the reference's, with
  the same flat tables.
* C7, the reference's own fault: its byte table reads ids 0..255 of a
  byte-level BPE vocabulary as raw bytes; the port reads every id of such
  a tokenizer as it decodes, and a grammared reply over one parses.
* End to end through both ``Scheduler``s on the same bridged weights:
  grammared greedy and seeded streams (``json_value`` and a schema, beside
  an unconstrained request, narrow, speculative and mixed dispatches) are
  equal token for token, their ``logprob_data`` within 1e-5, and every
  reply parses and validates; a preempted grammared request re-walks its
  tokens and streams what it streams unpreempted.
"""

import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.core.config import EngineConfig as JaxEngineConfig
from generativeaiexamples_tpu.engine import grammar as jgrammar
from generativeaiexamples_tpu.engine import tools as jtools
from generativeaiexamples_tpu.engine.engine import EngineCore as JaxCore
from generativeaiexamples_tpu.engine.scheduler import Request as JaxRequest
from generativeaiexamples_tpu.engine.scheduler import Scheduler as JaxScheduler
from generativeaiexamples_tpu.engine.tokenizer import ByteTokenizer
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.ops import sampling as jsampling

from generativeaiexamples_tpu_torch.core.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import engine as tengine
from generativeaiexamples_tpu_torch.engine import grammar as tgrammar
from generativeaiexamples_tpu_torch.engine import tools as ttools
from generativeaiexamples_tpu_torch.engine.engine import (EngineCore,
                                                          GrammarStack)
from generativeaiexamples_tpu_torch.engine.scheduler import Request, Scheduler
from generativeaiexamples_tpu_torch.engine.tokenizer import (
    ByteTokenizer as TorchByteTokenizer)
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.ops import sampling, threefry

from test_constrained import random_schema, validates
from test_tool_calling import CALC_TOOL, WEATHER_TOOL

GEOMETRY = dict(max_batch_size=4, max_seq_len=256, page_size=8,
                prefill_chunk=16)
SCHEMA = {"type": "object",
          "properties": {"a": {"type": "integer"},
                         "b": {"type": "string", "maxLength": 6},
                         "c": {"type": "array", "maxItems": 2,
                               "items": {"type": "boolean"}}},
          "required": ["a", "b"]}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _random_dfa(seed, S=40, V=300, L=16, R=6):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, S, (S, 256)).astype(np.int32)
    table[rng.random((S, 256)) < 0.3] = 0
    table[0] = 0
    return dict(
        table=table, accept=rng.random(S) < 0.3,
        dist=rng.integers(0, 6, S).astype(np.int32),
        tok_lens=rng.integers(-1, 6, V).astype(np.int32),
        tok_bytes=rng.integers(0, 256, (V, L)).astype(np.int32),
        state=rng.integers(-1, S, R).astype(np.int32),
        budget=rng.integers(-1, 8, R).astype(np.int32),
        logits=rng.standard_normal((R, V)).astype(np.float32),
        eos=int(rng.integers(0, V)))


# ------------------------------------------------------------- the mask math

@pytest.mark.parametrize("seed", range(6))
def test_grammar_mask_plain_equals_reference(seed):
    d = _random_dfa(seed)
    want = np.isfinite(np.asarray(jsampling.grammar_mask(
        jnp.asarray(d["logits"]), jnp.asarray(d["state"]),
        jnp.asarray(d["budget"]), d["eos"], jnp.asarray(d["table"]),
        jnp.asarray(d["accept"]), jnp.asarray(d["dist"]),
        jnp.asarray(d["tok_bytes"]), jnp.asarray(d["tok_lens"]))))
    args = (_t(d["state"]), _t(d["budget"]), d["eos"], _t(d["table"]),
            _t(d["accept"]), _t(d["dist"]), _t(d["tok_bytes"]),
            _t(d["tok_lens"]))
    got = sampling.grammar_mask_plain(*args)
    np.testing.assert_array_equal(got.numpy(), want)
    # the CPU dispatch is the same set, packed as the kernel packs it
    bits = sampling.grammar_mask(*args)
    assert bits.shape == (6, 10) and bits.dtype == torch.int32
    np.testing.assert_array_equal(
        sampling.unpack_mask(bits, 300).numpy(), want)


@pytest.mark.parametrize("seed", range(6))
def test_grammar_advance_plain_equals_reference(seed):
    d = _random_dfa(seed)
    sampled = np.random.default_rng(seed + 100).integers(
        0, 300, d["state"].shape).astype(np.int32)
    want = np.asarray(jsampling.grammar_advance(
        jnp.asarray(d["state"]), jnp.asarray(sampled),
        jnp.asarray(d["table"]), jnp.asarray(d["tok_bytes"]),
        jnp.asarray(d["tok_lens"])))
    got = sampling.grammar_advance_plain(
        _t(d["state"]), _t(sampled), _t(d["table"]), _t(d["tok_bytes"]),
        _t(d["tok_lens"]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


@pytest.mark.parametrize("V", [1, 31, 32, 33, 300, 1027])
def test_pack_mask_round_trips(V):
    g = torch.Generator().manual_seed(V)
    allowed = torch.rand((5, V), generator=g) < 0.5
    allowed[0] = True
    bits = sampling.pack_mask(allowed)
    assert bits.shape == (5, -(-V // 32))
    assert torch.equal(sampling.unpack_mask(bits, V), allowed)
    # an all-allowed row sets exactly V bits: bits past V stay 0
    assert sum(bin(int(w) & 0xFFFFFFFF).count("1") for w in bits[0]) == V
    # bit j of word w is entry 32 w + j
    one = torch.zeros((1, V), dtype=torch.bool)
    one[0, V - 1] = True
    assert int(sampling.pack_mask(one)[0, (V - 1) // 32]) & 0xFFFFFFFF == \
        1 << ((V - 1) % 32)


@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("seed", range(3))
def test_masked_draw_equals_reference(seed, temperature):
    """A grammared row draws from the masked logits exactly as the
    reference's sampler draws from grammar_mask's -inf logits (greedy and
    seeded, top-k and top-p rows); the logprob reads the raw row."""
    d = _random_dfa(seed, R=4)
    R = 4
    jmasked = jsampling.grammar_mask(
        jnp.asarray(d["logits"]), jnp.asarray(d["state"]),
        jnp.asarray(d["budget"]), d["eos"], jnp.asarray(d["table"]),
        jnp.asarray(d["accept"]), jnp.asarray(d["dist"]),
        jnp.asarray(d["tok_bytes"]), jnp.asarray(d["tok_lens"]))
    seeds = np.arange(R, dtype=np.int32) + 7 * seed
    ctr = np.arange(R, dtype=np.int32) * 3
    temp = np.full(R, temperature, np.float32)
    top_k = np.array([0, 5, 0, 3], np.int32)
    top_p = np.array([1.0, 1.0, 0.8, 0.9], np.float32)
    jkeys = jax.vmap(jax.random.fold_in)(jax.vmap(jax.random.PRNGKey)(
        jnp.asarray(seeds)), jnp.asarray(ctr))
    want = np.asarray(jsampling.sample_logits_per_slot(
        jkeys, jmasked, jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p)))
    want_lp = np.asarray(jsampling.token_logprob(jnp.asarray(d["logits"]),
                                                 jnp.asarray(want)))
    bits = sampling.grammar_mask(
        _t(d["state"]), _t(d["budget"]), d["eos"], _t(d["table"]),
        _t(d["accept"]), _t(d["dist"]), _t(d["tok_bytes"]),
        _t(d["tok_lens"]))
    keys = threefry.prng_key(_t(seeds.astype(np.int64)))
    tok, lp, extra = sampling.sample_slots(
        keys, _t(ctr), 1, _t(d["logits"]), _t(temp), _t(top_k), _t(top_p),
        torch.ones(R, dtype=torch.bool), allowed=bits,
        grammar=(_t(d["state"]), _t(d["table"]), _t(d["tok_bytes"]),
                 _t(d["tok_lens"])), mask_states=_t(d["state"]))
    np.testing.assert_array_equal(tok.numpy(), want)
    np.testing.assert_allclose(lp.numpy(), want_lp, atol=1e-5)
    adv = np.asarray(jsampling.grammar_advance(
        jnp.asarray(d["state"]), jnp.asarray(want), jnp.asarray(d["table"]),
        jnp.asarray(d["tok_bytes"]), jnp.asarray(d["tok_lens"])))
    np.testing.assert_array_equal(extra["next_state"].numpy(), adv)


def test_advance_keeps_inactive_slots_and_position_zero_only():
    d = _random_dfa(3, R=2)
    W = 3
    logits = _t(np.random.default_rng(0).standard_normal(
        (2 * W, 300)).astype(np.float32))
    state = _t(np.array([5, 7], np.int32))
    active = torch.tensor([True, False])
    keys = threefry.prng_key(torch.tensor([1, 2]))
    tok, _, extra = sampling.sample_slots_plain(
        keys, torch.zeros(2, dtype=torch.int32), W, logits,
        torch.zeros(2), torch.zeros(2, dtype=torch.int32), torch.ones(2),
        active, grammar=(state, _t(d["table"]), _t(d["tok_bytes"]),
                         _t(d["tok_lens"])))
    want = sampling.grammar_advance_plain(
        state, tok.reshape(2, W)[:, 0], _t(d["table"]), _t(d["tok_bytes"]),
        _t(d["tok_lens"]))
    assert int(extra["next_state"][0]) == int(want[0])
    assert int(extra["next_state"][1]) == 7


# -------------------------------------------------- the copies of the modules

def _schemas():
    rng = random.Random(0xBEEF)
    cases = [("random", random_schema(rng)) for _ in range(12)]
    cases += [("bare_object", {"type": "object"}),
              ("empty_object", {"type": "object",
                                "additionalProperties": False}),
              ("optional", {"type": "object", "properties": {
                  "a": {"type": "integer"}, "b": {"type": "boolean"}}}),
              ("required", {"type": "object", "properties": {
                  "a": {"type": "integer"}, "b": {"type": "boolean"}},
                  "required": ["a"]}),
              ("nested", SCHEMA)]
    return cases


def _dfa_equal(a, b):
    assert a.key == b.key
    assert a.dfa.start == b.dfa.start and a.dfa.n_states == b.dfa.n_states
    np.testing.assert_array_equal(a.dfa.table, b.dfa.table)
    np.testing.assert_array_equal(a.dfa.accept, b.dfa.accept)
    np.testing.assert_array_equal(a.dfa.dist, b.dfa.dist)


@pytest.mark.parametrize("name,schema", _schemas(),
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(_schemas())])
def test_schema_dfas_equal_reference(name, schema):
    _dfa_equal(tgrammar.Grammar.from_schema(schema),
               jgrammar.Grammar.from_schema(schema))


@pytest.mark.parametrize("tools,forced", [
    ([WEATHER_TOOL, CALC_TOOL], None), ([WEATHER_TOOL, CALC_TOOL],
                                        "calculator"),
    ([{"function": {"name": "search"}}], "search")])
def test_tool_and_json_dfas_equal_reference(tools, forced):
    _dfa_equal(tgrammar.Grammar.for_tools(tools, forced),
               jgrammar.Grammar.for_tools(tools, forced))
    _dfa_equal(tgrammar.Grammar.for_tools_cached(tools, forced),
               jgrammar.Grammar.for_tools_cached(tools, forced))


def test_json_value_dfa_and_byte_table_equal_reference():
    _dfa_equal(tgrammar.Grammar.json_value(), jgrammar.Grammar.json_value())
    for got, want in zip(tgrammar.token_byte_table(TorchByteTokenizer()),
                         jgrammar.token_byte_table(ByteTokenizer())):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(tgrammar.UnsupportedSchema):
        tgrammar.Grammar.from_schema({"$ref": "#/x"})


@pytest.fixture(scope="module")
def bpe(tmp_path_factory):
    """A small Llama-3-shaped byte-level BPE tokenizer (the smoke's maker:
    ids 0..255 are GPT-2's byte alphabet, 300 merges, 256 specials) read
    by the port's native core."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer
    spec = chip_smoke.llama3_tokenizer_json(
        '{"city": "Oslo", "days": 3} ' * 40 + chip_smoke.PROMPT_TEXT,
        n_merges=300, seed=0, learned=100)
    d = tmp_path_factory.mktemp("bpe")
    (d / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False))
    return get_tokenizer(str(d))


def test_reference_reads_bpe_byte_ids_as_raw_bytes(bpe):
    """C7, the reference's own fault: its token_byte_table takes ids 0..255
    of any tokenizer whose EOS id is >= 256 as the raw bytes 0..255, but a
    byte-level BPE vocabulary's ids 0..255 are GPT-2's byte alphabet in
    another order, so the DFA walks bytes the tokens never emit."""
    ref_bytes, ref_lens = jgrammar.token_byte_table(bpe)
    wrong = [t for t in range(256)
             if ref_lens[t] > 0 and bytes(ref_bytes[t, :ref_lens[t]])
             != bpe.decode([t]).encode("utf-8")]
    assert len(wrong) > 150
    assert bpe.decode([0]) == "!" and list(ref_bytes[0, :1]) == [0]


def test_port_byte_table_reads_each_id_as_the_tokenizer_decodes_it(bpe):
    tb, tl = tgrammar.token_byte_table(bpe)
    specials = {bpe.bos_id, bpe.eos_id, bpe.pad_id}
    for t in range(bpe.vocab_size):
        text = bpe.decode([t])
        data = text.encode("utf-8")
        if (t in specials or not data or len(data) > 16
                or "\ufffd" in text):
            assert tl[t] == -1, t
        else:
            assert bytes(int(b) for b in tb[t, :tl[t]]) == data, t
    # beyond the first 256 ids both packages read the same table
    rb, rl = jgrammar.token_byte_table(bpe)
    np.testing.assert_array_equal(tb[256:], rb[256:])
    np.testing.assert_array_equal(tl[256:], rl[256:])


def test_bpe_grammared_reply_parses(bpe):
    """A schema grammar over the BPE vocabulary: the detokenized reply is
    the bytes the DFA walked, so it parses and validates."""
    cfg = llama.LlamaConfig.tiny(vocab_size=bpe.vocab_size)
    params = llama.init_params(torch.Generator().manual_seed(3), cfg)
    core = EngineCore(cfg, EngineConfig(**GEOMETRY, spec_decode="off",
                                        prefix_cache="off"),
                      params, eos_id=bpe.eos_id, device="cpu")
    sched = Scheduler(core, bpe)
    reqs = [Request(prompt_ids=bpe.apply_chat_template(
        [{"role": "user", "content": "city?"}]), max_tokens=48,
        temperature=t, seed=5, grammar=tgrammar.Grammar.from_schema(SCHEMA))
        for t in (0.0, 1.0)]
    for r in reqs:
        sched.submit(r)
    for _ in range(400):
        if not sched._tick() and all(r.finished_at for r in reqs):
            break
    for r in reqs:
        assert r.grammar_attached and r.error is None
        assert validates(json.loads(bpe.decode(r.output_ids)), SCHEMA)


EXTRACT_TEXTS = ['{"a": 1}', 'prose before {"a": [1, 2]} prose after',
                 '```json\n{"a": "with } brace in string"}\n```',
                 "[1, 2, 3] trailing", "no json here", '{"unterminated": ',
                 '{oops} then {"ok": true}']
CALL_TEXTS = [
    '{"tool_calls": [{"name": "get_weather", "arguments": '
    '{"city": "Oslo"}}]}',
    '{"name": "get_weather", "arguments": {"city": "Oslo"}}',
    '{"name": "get_weather", "parameters": {"city": "Oslo"}}',
    'Sure! {"tool_calls": [{"name": "get_weather", "arguments": '
    '{"city": "Oslo"}}]}',
    "It is sunny in Oslo.", '{"name": "rm_rf", "arguments": {}}',
    '{"random": "json"}',
    '{"tool_calls": [{"name": "get_weather", "arguments": {"city": "A"}}, '
    '{"name": "get_weather", "arguments": {"city": "B"}}]}',
    'Answer: {"temp": 12} done',
    '{"tool_calls": [{"name": "nope", "arguments": {}}]}']


@pytest.mark.parametrize("text", EXTRACT_TEXTS)
def test_extract_json_value_equals_reference(text):
    assert ttools.extract_json_value(text) == jtools.extract_json_value(text)


def _no_ids(calls):
    return None if calls is None else [
        {k: v for k, v in c.items() if k != "id"} for c in calls]


@pytest.mark.parametrize("text", CALL_TEXTS)
def test_tool_parse_and_stream_equal_reference(text):
    tools = [WEATHER_TOOL, CALC_TOOL]
    assert _no_ids(ttools.parse_tool_calls(text, tools)) == \
        _no_ids(jtools.parse_tool_calls(text, tools))
    for chunk in (1, 5, 7):
        events = []
        for mod in (ttools, jtools):
            st = mod.ToolCallStreamer([WEATHER_TOOL])
            ev = []
            for i in range(0, len(text), chunk):
                ev += st.feed(text[i:i + chunk])
            events.append((ev + st.finish(), st.committed))
        assert events[0] == events[1]


@pytest.mark.parametrize("choice", ["auto", "required", "none",
                                    {"type": "function",
                                     "function": {"name": "get_weather"}}])
def test_prompt_contracts_equal_reference(choice):
    msgs = [{"role": "system", "content": "base"},
            {"role": "user", "content": "weather?"},
            {"role": "assistant", "tool_calls": [
                {"id": "call_1", "type": "function",
                 "function": {"name": "get_weather",
                              "arguments": '{"city": "Oslo"}'}}]},
            {"role": "tool", "tool_call_id": "call_1",
             "name": "get_weather", "content": "12C, rain"}]
    assert ttools.normalize_messages(msgs) == jtools.normalize_messages(msgs)
    norm = ttools.normalize_messages(msgs)
    assert (ttools.inject_tool_prompt(norm, [WEATHER_TOOL], choice)
            == jtools.inject_tool_prompt(norm, [WEATHER_TOOL], choice))
    for rf in ({"type": "json_object"},
               {"type": "json_schema", "json_schema": {"schema": SCHEMA}}):
        for with_tools in (False, True):
            assert (ttools.inject_json_prompt(norm, rf, with_tools)
                    == jtools.inject_json_prompt(norm, rf, with_tools))
    assert ttools.forced_name(choice) == jtools.forced_name(choice)


# ------------------------------------------------------------ the stack

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


def test_grammar_stack_registers_pins_and_evicts_as_the_reference(tiny):
    core, jcore = _core(tiny), _jax_core(tiny)
    core.ensure_token_bytes(TorchByteTokenizer())
    jcore.ensure_token_bytes(ByteTokenizer())
    np.testing.assert_array_equal(core._tok_bytes.numpy(),
                                  np.asarray(jcore._tok_bytes))
    np.testing.assert_array_equal(core._tok_lens.numpy(),
                                  np.asarray(jcore._tok_lens))
    specs = [{"type": "boolean"}, {"type": "integer"}, SCHEMA,
             {"enum": ["a", "b"]}, {"type": "string", "maxLength": 3}]
    tg = [tgrammar.Grammar.from_schema(s) for s in specs]
    jg = [jgrammar.Grammar.from_schema(s) for s in specs]
    for i in range(4):
        assert core.register_grammar(tg[i]) == jcore.register_grammar(jg[i])
    # every slot pinned: both refuse
    with pytest.raises(tgrammar.UnsupportedSchema):
        core.register_grammar(tg[4], [g.key for g in tg[:4]])
    with pytest.raises(jgrammar.UnsupportedSchema):
        jcore.register_grammar(jg[4], [g.key for g in jg[:4]])
    # one unpinned: evicted and its slot reused
    pinned = [tg[i].key for i in (0, 2, 3)]
    assert core.register_grammar(tg[4], pinned) == jcore.register_grammar(
        jg[4], [jg[i].key for i in (0, 2, 3)])
    table, accept, dist = core.grammars.tensors()
    np.testing.assert_array_equal(table.numpy(),
                                  np.asarray(jcore._gram_table))
    np.testing.assert_array_equal(accept.numpy(),
                                  np.asarray(jcore._gram_accept))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jcore._gram_dist))
    ids = ByteTokenizer().encode('{"a": 12, "b"')
    assert (core.walk_grammar(tg[2], ids, pinned)
            == jcore.walk_grammar(jg[2], ids, [jg[i].key for i in (0, 2, 3)]))
    assert core.walk_grammar(tg[2], ByteTokenizer().encode("[")) == 0
    assert (tengine.GRAM_STATES, tengine.GRAM_SLOTS) == (
        jcore.GRAM_STATES, jcore.GRAM_SLOTS)
    assert GrammarStack("cpu").table.shape == (
        tengine.GRAM_SLOTS * tengine.GRAM_STATES, 256)


# ------------------------------------------------ end to end, both schedulers

# the unconstrained request decodes first; the grammared ones arrive while
# it does (so their finals may ride a mixed dispatch)
PROMPTS = [("free text here", 32, None), ("emit json:", 40, "json"),
           ("the schema, please", 48, "schema")]


def _requests(make, gmod, temperature, seed=11):
    tok = ByteTokenizer()
    out = []
    for i, (text, n, kind) in enumerate(PROMPTS):
        gram = (gmod.Grammar.json_value() if kind == "json" else
                gmod.Grammar.from_schema(SCHEMA) if kind == "schema"
                else None)
        out.append(make(prompt_ids=tok.encode(text, add_bos=True),
                        max_tokens=n, temperature=temperature,
                        seed=seed + i, grammar=gram, logprobs=True))
    return out


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


def _assert_streams_equal(got, want):
    for g, w in zip(got, want):
        assert [t for t, _, _ in g.logprob_data] == \
            [t for t, _, _ in w.logprob_data]
        assert g.output_ids == [t for t, _, _ in w.logprob_data]
        np.testing.assert_allclose([lp for _, lp, _ in g.logprob_data],
                                   [lp for _, lp, _ in w.logprob_data],
                                   atol=1e-5)
        assert g.grammar_attached == w.grammar_attached


def _assert_valid(reqs):
    tok = ByteTokenizer()
    for r, (_, _, kind) in zip(reqs, PROMPTS):
        if kind is None:
            assert r.grammar_attached is None
            continue
        assert r.grammar_attached is True
        # the budget mask leaves even a reply cut at max_tokens complete
        text = tok.decode(r.output_ids)
        value = json.loads(text)
        if kind == "schema":
            assert validates(value, SCHEMA), text


@pytest.mark.parametrize("mixed", ["off", "on"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_grammared_streams_equal_jax_scheduler(tiny, temperature, mixed):
    kw = dict(prefix_cache="off", prefill_hold_chunks=0,
              mixed_phase_dispatch=mixed)
    jsched = JaxScheduler(_jax_core(tiny, **kw), ByteTokenizer())
    want = _drive(jsched, _requests(JaxRequest, jgrammar, temperature))
    sched = Scheduler(_core(tiny, **kw), TorchByteTokenizer())
    got = _drive(sched, _requests(Request, tgrammar, temperature))
    _assert_streams_equal(got, want)
    _assert_valid(got)
    assert sched.stats["spec_steps"] > 0
    if mixed == "on":
        assert sched.stats["mixed_dispatches"] > 0


def test_grammared_narrow_streams_equal_jax_scheduler(tiny):
    kw = dict(prefix_cache="off", prefill_hold_chunks=0, spec_decode="off",
              mixed_phase_dispatch="off", pipeline_depth=1)
    jsched = JaxScheduler(_jax_core(tiny, **kw), ByteTokenizer())
    want = _drive(jsched, _requests(JaxRequest, jgrammar, 0.0))
    got = _drive(Scheduler(_core(tiny, **kw), TorchByteTokenizer()),
                 _requests(Request, tgrammar, 0.0))
    _assert_streams_equal(got, want)


def test_preempted_grammared_request_rewalks_and_streams_alike(tiny):
    """A pool too small for every request preempts the youngest: the
    grammared resume re-walks what it emitted and streams what it streams
    on a roomy pool, and what the JAX Scheduler streams."""
    kw = dict(prefix_cache="off", prefill_hold_chunks=0,
              mixed_phase_dispatch="off", spec_decode="off")
    roomy = _drive(Scheduler(_core(tiny, **kw), TorchByteTokenizer()),
                   _requests(Request, tgrammar, 0.0))
    sched = Scheduler(_core(tiny, num_pages=10, **kw), TorchByteTokenizer())
    tight = _drive(sched, _requests(Request, tgrammar, 0.0))
    assert sched.stats["preemptions"] > 0
    assert any(r.preemptions and r.grammar is not None for r in tight)
    for g, w in zip(tight, roomy):
        assert g.output_ids == w.output_ids
        assert g.grammar_attached == w.grammar_attached
    jsched = JaxScheduler(_jax_core(tiny, **kw), ByteTokenizer())
    want = _drive(jsched, _requests(JaxRequest, jgrammar, 0.0))
    for g, w in zip(tight, want):
        assert g.output_ids == [t for t, _, _ in w.logprob_data]


def test_failed_registration_degrades_to_unconstrained(tiny, monkeypatch):
    core = _core(tiny, prefix_cache="off", prefill_hold_chunks=0)

    def refuse(grammar, active_keys=()):
        raise tgrammar.UnsupportedSchema("every slot pinned")
    monkeypatch.setattr(core, "register_grammar", refuse)
    sched = Scheduler(core, TorchByteTokenizer())
    reqs = _drive(sched, _requests(Request, tgrammar, 0.0))
    assert [r.grammar_attached for r in reqs] == [
        None if kind is None else False for _, _, kind in PROMPTS]
    plain = _drive(Scheduler(_core(tiny, prefix_cache="off",
                                   prefill_hold_chunks=0),
                             TorchByteTokenizer()),
                   [Request(prompt_ids=list(r.prompt_ids),
                            max_tokens=r.max_tokens, temperature=0.0,
                            seed=r.seed) for r in reqs])
    for r, p in zip(reqs, plain):
        assert r.output_ids == p.output_ids
