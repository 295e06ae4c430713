"""Multi-step decode and the adaptive dispatch depth in the PyTorch port,
against the JAX package on the CPU (the tiny model, ``PRNGKey(2)`` weights
through ``params_from_jax``, each package's byte tokenizer).

Every case of ``tests/test_decode_multistep.py`` has its counterpart here:

* the M ladder's gate, validation, env override and config loading equal
  the reference's, and ``decode_multi`` on an engine with it off raises;
* ``decode_multistep=8`` streams equal the JAX ``Scheduler``'s per-step
  streams token for token, greedy and seeded with top-k / top-p rows, over
  both KV pools, with speculation off (multi-step from the start) and on
  and adaptive (it engages once the drafts collapse);
* the (K, M) dispatch sequence equals the JAX ``Scheduler``'s at
  ``pipeline_depth=1``, and so does the depth ladder's ``_steps``;
* ``stop_suspect_mask`` equals the reference's; every token that gives a
  byte to a stop match is flagged (a property); a stop string straddling
  the first K·M block edge ends where the per-step stream ends it, with
  ``"stop"``, and the next dispatch is per-step; a suspect token pauses
  its slot for the rest of the block, which keeps its activation and
  resumes token-identically (seeded too);
* a tight pool preempts with multi-step dispatches in flight and its
  streams equal the roomy pool's; host fetches per generated token drop at
  least 4x; LoRA rows ride ``decode_multi`` with the JAX ``Scheduler``'s
  streams; grammared, top-logprob and widened fleets make no multi call; a
  first token resolves between the steps of a multi dispatch;
* ``warmup`` visits every depth and M rung and leaves the first request's
  stream unchanged; the new engine and scheduler code reads nothing back
  from the device;
* a slot evacuated with multi-step dispatches in flight resumes on a peer
  through ``submit_prefilled`` and the joined stream equals the
  unevacuated one.
"""

import concurrent.futures
import inspect
import re

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from generativeaiexamples_tpu.core.config import EngineConfig as JaxEngineConfig
from generativeaiexamples_tpu.engine import grammar as jgrammar
from generativeaiexamples_tpu.engine.engine import EngineCore as JaxCore
from generativeaiexamples_tpu.engine.scheduler import Request as JaxRequest
from generativeaiexamples_tpu.engine.scheduler import Scheduler as JaxScheduler
from generativeaiexamples_tpu.engine.tokenizer import (
    ByteTokenizer as JaxByteTokenizer)
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.ops import sampling as jsampling
from generativeaiexamples_tpu.train import lora as jlora

from generativeaiexamples_tpu_torch.core.config import (NOT_PORTED,
                                                        EngineConfig,
                                                        load_config)
from generativeaiexamples_tpu_torch.engine import grammar as grammar_mod
from generativeaiexamples_tpu_torch.engine.engine import EngineCore, HostCopy
from generativeaiexamples_tpu_torch.engine.scheduler import Request, Scheduler
from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.ops import sampling
from generativeaiexamples_tpu_torch.train import lora

GEOMETRY = dict(max_batch_size=4, max_seq_len=256, page_size=8,
                prefill_chunk=16)
# the reference's multi-step cases: speculation off, K = 2
PLAIN = dict(spec_decode="off", decode_steps_per_dispatch=2)
# each package's byte tokenizer: the same ids, and byte tables that read
# ids 0..255 as the raw bytes in both
TOK, JTOK = ByteTokenizer(), JaxByteTokenizer()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny-model passes run faster on one thread than on threads that
    contend with the other test workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    # PRNGKey(2): its greedy streams vary more than PRNGKey(5)'s, whose
    # repeat one byte that decodes to U+FFFD (no stop string could start
    # at a chosen token in them)
    cfg = jllama.LlamaConfig.tiny(vocab_size=300)
    jparams = jllama.init_params(jax.random.PRNGKey(2), cfg)
    tcfg = llama.LlamaConfig.tiny(vocab_size=300)
    np_params = jax.tree.map(np.asarray, jparams)
    return cfg, jparams, tcfg, np_params


def _core(tiny, **kw):
    _, _, tcfg, np_params = tiny
    return EngineCore(tcfg, EngineConfig(**{**GEOMETRY, **kw}),
                      llama.params_from_jax(np_params, tcfg),
                      eos_id=TOK.eos_id, device="cpu")


def _jax_core(tiny, **kw):
    cfg, jparams, _, _ = tiny
    return JaxCore(cfg, JaxEngineConfig(**{**GEOMETRY, **kw}), jparams,
                   eos_id=TOK.eos_id)


def _ids(text):
    return TOK.encode(text, add_bos=True)


class _SyncFetcher:
    """The JAX ``Scheduler``'s fetcher run in the calling thread: a result
    has landed by the next tick, as the port's on the CPU, so both
    schedulers plan their dispatches from the same host view."""

    def submit(self, fn, *args, **kw):
        fut = concurrent.futures.Future()
        fut.set_result(fn(*args, **kw))
        return fut

    def shutdown(self, wait=True):
        pass


def _jax_sched(core):
    sched = JaxScheduler(core, JTOK)
    sched._fetcher = _SyncFetcher()
    return sched


def _spy(core):
    """Record every decode dispatch of ``core`` in order: ("multi", K, M)
    or ("step", K)."""
    calls = []
    multi, decode = core.decode_multi, core.decode

    def spying_multi(state, table, steps=None, m=None, **kw):
        calls.append(("multi", steps, m))
        return multi(state, table, steps, m, **kw)

    def spying_decode(state, table, steps=1, *args, **kw):
        calls.append(("step", steps))
        return decode(state, table, steps, *args, **kw)

    core.decode_multi, core.decode = spying_multi, spying_decode
    return calls


def _run(sched, reqs):
    for r in reqs:
        sched.submit(r)
    for _ in range(5000):
        if not sched._tick():
            break
    assert [r.error for r in reqs] == [None] * len(reqs)
    assert all(r.finished_at for r in reqs)
    return reqs


def _jax_tokens(reqs):
    return [[t for t, _lp, _top in r.logprob_data] for r in reqs]


def _text(req):
    parts = []
    while not req.out_queue.empty():
        item = req.out_queue.get_nowait()
        if isinstance(item, str):
            parts.append(item)
    return "".join(parts)


def _traffic(make, **extra):
    """A greedy request, a seeded one at temperature 0.9 and a seeded one
    with top-k and top-p rows."""
    return [
        make(prompt_ids=_ids("entropy soup 9a8b7c6d5e4f no repeats here"),
             max_tokens=48, temperature=0.0, **extra),
        make(prompt_ids=_ids("zq xv 13 57 91"), max_tokens=40,
             temperature=0.9, seed=23, **extra),
        make(prompt_ids=_ids("top k and top p rows"), max_tokens=36,
             temperature=0.9, top_k=20, top_p=0.9, seed=7, **extra)]


# ----------------------------------------------------------------- knobs

def test_ladder_gate_and_validation_equal_the_reference(tiny):
    for mm, rungs in ((0, ()), (1, ()), (8, (2, 4, 8))):
        assert _core(tiny, decode_multistep=mm).multi_ms == rungs
        assert _jax_core(tiny, decode_multistep=mm).multi_ms == rungs
    assert _core(tiny).multi_ms == ()                     # default: off
    assert (_core(tiny).decode_multi_bucket(2, 4)
            == _jax_core(tiny).decode_multi_bucket(2, 4) == "s2m4")
    for bad in (6, -2):
        for make in (_core, _jax_core):
            with pytest.raises(ValueError, match="power of two"):
                make(tiny, decode_multistep=bad)
    # decode_steps_max: a power of two >= the base K (8 by default)
    for bad in (12, 4):
        for make in (_core, _jax_core):
            with pytest.raises(ValueError, match="decode_steps_max"):
                make(tiny, decode_steps_max=bad)
    assert _core(tiny, decode_steps_max=32).cfg.decode_steps_max == 32
    # an engine with the feature off refuses a multi-step dispatch, and
    # one with it on refuses a rung or a K it was not built for
    core = _core(tiny)
    with pytest.raises(ValueError, match="multi-step decode is off"):
        core.decode_multi(core.init_state(), None)
    core = _core(tiny, decode_multistep=4, decode_steps_per_dispatch=2)
    table = core.put_table(np.zeros((4, core.max_pages_per_slot), np.int32))
    with pytest.raises(ValueError, match="not a ladder rung"):
        core.decode_multi(core.init_state(), table, m=8)
    with pytest.raises(ValueError, match="base K"):
        core.decode_multi(core.init_state(), table, steps=4, m=2)


def test_env_override_and_config_load(tiny, monkeypatch):
    monkeypatch.setenv("APP_DECODE_MULTISTEP", "4")
    assert _core(tiny).multi_ms == _jax_core(tiny).multi_ms == (2, 4)
    monkeypatch.setenv("APP_DECODE_MULTISTEP", "0")
    assert _core(tiny, decode_multistep=8).multi_ms == ()
    assert _jax_core(tiny, decode_multistep=8).multi_ms == ()
    monkeypatch.setenv("APP_DECODE_MULTISTEP", "three")
    for make in (_core, _jax_core):
        with pytest.raises(ValueError, match="APP_DECODE_MULTISTEP"):
            make(tiny)
    monkeypatch.delenv("APP_DECODE_MULTISTEP")
    # both knobs load like every APP_ENGINE_* knob, with the reference's
    # defaults; the knobs still not ported stay refused
    for key in ("decode_multistep", "decode_steps_max"):
        assert key not in NOT_PORTED
        assert getattr(EngineConfig(), key) == getattr(JaxEngineConfig(),
                                                       key) == 0
    monkeypatch.setenv("APP_ENGINE_DECODE_MULTISTEP", "8")
    monkeypatch.setenv("APP_ENGINE_DECODE_STEPS_MAX", "32")
    eng = load_config().engine
    assert (eng.decode_multistep, eng.decode_steps_max) == (8, 32)
    monkeypatch.setenv("APP_ENGINE_LONG_PREFILL", "on")
    with pytest.raises(NotImplementedError, match="sequence-parallel"):
        load_config()


# ---------------------------------------------------- stream equivalence

@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("spec", ["off", "on"])
def test_streams_equal_the_jax_per_step_streams(tiny, kv_quant, spec):
    """With speculation off the multi-step path runs from the first
    dispatch; with it on and adaptive, a non-repetitive workload collapses
    the drafts and it engages mid-generation. Either way the streams are
    the JAX engine's per-step streams."""
    kw = (dict(PLAIN, kv_quant=kv_quant) if spec == "off" else
          dict(spec_decode="on", spec_adaptive="on",
               decode_steps_per_dispatch=1, kv_quant=kv_quant))
    want = _jax_tokens(_run(_jax_sched(_jax_core(tiny, **kw)),
                            _traffic(JaxRequest, logprobs=True)))
    core = _core(tiny, decode_multistep=8, **kw)
    calls = _spy(core)
    sched = Scheduler(core, TOK)
    got = [r.output_ids for r in _run(sched, _traffic(Request))]
    assert got == want
    multi = [c for c in calls if c[0] == "multi"]
    assert multi, "multi-step never engaged"
    assert sched.stats["multi_dispatches"] == len(multi)
    if spec == "on":
        # mid-generation: widened dispatches came first
        assert calls[0][0] == "step" and sched.stats["spec_steps"] > 0


def test_dispatch_sequence_equals_the_jax_scheduler(tiny):
    """Budgets that walk the M ladder down, a late arrival and a
    stop-bearing request: the (K, M) of every dispatch, and the streams,
    equal the JAX ``Scheduler``'s at ``pipeline_depth=1``."""
    kw = dict(PLAIN, decode_multistep=8, pipeline_depth=1)

    def drive(sched, make, **extra):
        first = [make(prompt_ids=_ids("a long budget walks down"),
                      max_tokens=45, temperature=0.0, **extra),
                 make(prompt_ids=_ids("a shorter one"), max_tokens=19,
                      temperature=0.7, seed=4, **extra),
                 make(prompt_ids=_ids("with a stop"), max_tokens=30,
                      temperature=0.0, stop=["\x07"], **extra)]
        for r in first:
            sched.submit(r)
        for _ in range(6):
            sched._tick()
        late = make(prompt_ids=_ids("late"), max_tokens=11,
                    temperature=0.9, seed=8, **extra)
        _run(sched, [late])
        assert all(r.finished_at and r.error is None for r in first)
        return first + [late]

    jcore = _jax_core(tiny, **kw)
    jcalls = _spy(jcore)
    jreqs = drive(_jax_sched(jcore), JaxRequest, logprobs=True)
    core = _core(tiny, **kw)
    calls = _spy(core)
    reqs = drive(Scheduler(core, TOK), Request)
    assert [r.output_ids for r in reqs] == _jax_tokens(jreqs)
    assert [r.finish_reason for r in reqs] == [r.finish_reason
                                               for r in jreqs]
    assert calls == jcalls
    assert len({c[2] for c in calls if c[0] == "multi"}) >= 2


# ---------------------------------------------------------------- stops

def _random_table(rng, V=300, L=6):
    tb = rng.integers(0, 256, (V, L)).astype(np.int32)
    tl = rng.integers(-1, L + 1, V).astype(np.int32)
    return tb, tl


def test_stop_suspect_mask_equals_the_reference():
    tables = [grammar_mod.token_byte_table(TOK),
              _random_table(np.random.default_rng(0))]
    # the byte tokenizer's table is the reference's
    jtb, jtl = jgrammar.token_byte_table(JTOK)
    np.testing.assert_array_equal(tables[0][0], jtb)
    np.testing.assert_array_equal(tables[0][1], jtl)
    rng = np.random.default_rng(1)
    sets = [frozenset(), frozenset(b"\n"), frozenset("</s>".encode()),
            frozenset("stop ✓".encode())] + [
        frozenset(rng.integers(0, 256, n).tolist()) for n in (1, 3, 9, 40)]
    for tb, tl in tables:
        for stop_bytes in sets:
            got = sampling.stop_suspect_mask(tb, tl, stop_bytes)
            want = jsampling.stop_suspect_mask(tb, tl, stop_bytes)
            assert got.dtype == np.bool_ and got.shape == (tb.shape[0],)
            np.testing.assert_array_equal(got, want)


def test_engine_suspect_table(tiny):
    core = _core(tiny, **PLAIN, decode_multistep=2)
    V = core.model_cfg.vocab_size
    # no byte table yet: every real token is suspect, the pad never
    table = core._stop_suspect(("ab",)).numpy()
    assert table.shape == (V + 1,) and table[:V].all() and not table[V]
    assert not core._stop_suspect(()).numpy().any()
    core.ensure_token_bytes(TOK)
    table = core._stop_suspect(("ab", "b!")).numpy()
    want = np.zeros((V + 1,), np.bool_)
    want[[ord("a"), ord("b"), ord("!")]] = True
    np.testing.assert_array_equal(table, want)
    assert core._stop_suspect(["ba", "!"]) is core._stop_suspect(("ab!",))


@settings(max_examples=60, deadline=None)
@given(pieces=st.lists(st.binary(min_size=1, max_size=4), min_size=1,
                       max_size=24),
       seq=st.lists(st.integers(0, 23), min_size=1, max_size=40),
       span=st.tuples(st.integers(0, 200), st.integers(1, 6)))
def test_every_token_giving_a_byte_to_a_match_is_flagged(pieces, seq, span):
    """A vocabulary of byte pieces, a token stream, and a stop string cut
    from the stream's bytes: every token whose bytes overlap any match of
    the stop in the stream is suspect."""
    V, L = len(pieces), 4
    tb = np.zeros((V, L), np.int32)
    tl = np.zeros((V,), np.int32)
    for i, p in enumerate(pieces):
        tb[i, :len(p)] = list(p)
        tl[i] = len(p)
    ids = [t % V for t in seq]
    data = b"".join(pieces[t] for t in ids)
    start = span[0] % len(data)
    stop = data[start:start + span[1]]
    mask = sampling.stop_suspect_mask(tb, tl, frozenset(stop))
    ends = np.cumsum([len(pieces[t]) for t in ids])
    at = data.find(stop)
    while at >= 0:
        for t, end in zip(ids, ends):
            if end > at and end - len(pieces[t]) < at + len(stop):
                assert mask[t], (t, stop, at)
        at = data.find(stop, at + 1)


def _oracle(tiny, prompt, rkw, max_tokens=16):
    """The per-step ids and text of one request."""
    req = Request(prompt_ids=_ids(prompt), max_tokens=max_tokens, **rkw)
    _run(Scheduler(_core(tiny, **PLAIN), TOK), [req])
    return req.output_ids, TOK.decode(req.output_ids)


def _straddling_stop(tiny, rkw):
    """A prompt, a block and a stop that straddles its edge. The first
    multi dispatch of K = 2 emits tokens 1..K·M after the fused first
    token, M the largest rung whose K·M fits the budget. The tiny model's
    streams are mostly bytes that decode to U+FFFD, so the search takes
    the first prompt whose per-step text is decodable at the block's last
    token and the two after it, for K·M of 4, 8 or 16: the stop is those
    three characters, its first occurrence in the text starts at the
    block's last token, and no earlier token of the block shares a byte
    with it (nothing pauses the block before its edge). Returns the
    prompt, K·M, the budget and the stop."""
    for i in range(80):
        prompt = f"straddle the block edge {i}"
        ids, text = _oracle(tiny, prompt, rkw, max_tokens=19)
        for km in (4, 8, 16):
            head = TOK.decode(ids[:km + 1])
            start = len(head) - 1
            stop = text[start:start + 3]
            if (text.startswith(head) and len(stop) == 3
                    and "\ufffd" not in stop and text.find(stop) == start
                    and not set(stop.encode()) & set(ids[1:km])):
                return prompt, km, km + 3, stop
    raise AssertionError("no prompt with decodable text at a block edge")


@pytest.mark.parametrize("rkw", [dict(temperature=0.0),
                                 dict(temperature=0.9, seed=31)],
                         ids=["greedy", "seeded"])
def test_stop_straddling_the_first_block_edge(tiny, rkw):
    """The stop's first character is the first block's last token: the
    host holds it back, the next dispatch is per-step, and the stream
    ends where the per-step stream ends it, with ``"stop"``."""
    prompt, km, budget, stop = _straddling_stop(tiny, rkw)

    def mk():
        return [Request(prompt_ids=_ids(prompt), max_tokens=budget,
                        stop=[stop], **rkw)]

    base = mk()
    _run(Scheduler(_core(tiny, **PLAIN), TOK), base)
    core = _core(tiny, decode_multistep=8, **PLAIN)
    calls = _spy(core)
    fast = _run(Scheduler(core, TOK), mk())
    text = _text(fast[0])
    assert text == _text(base[0])
    assert text == TOK.decode(base[0].output_ids).split(stop)[0]
    assert fast[0].output_ids == base[0].output_ids
    assert fast[0].finish_reason == base[0].finish_reason == "stop"
    assert calls[0] == ("multi", 2, km // 2)
    assert calls[1][0] == "step"


def _char_with_byte(b):
    """A character whose UTF-8 encoding holds byte ``b``."""
    return next(chr(c) for c in range(1, 0xD800) if b in chr(c).encode())


def test_a_suspect_token_pauses_its_slot(tiny):
    """A stop string that never matches but one of whose bytes the greedy
    stream draws often: each multi dispatch emits nothing past a stop-bearing
    slot's first suspect token, the slot stays active, and greedy and
    seeded streams equal the per-step ones."""
    ids, text = _oracle(tiny, "pause me", dict(temperature=0.0), 40)
    common = max(set(ids[1:]) & set(range(256)), key=ids.count)
    stop = _char_with_byte(common) + "\x01\x02\x03"
    assert stop not in text

    def mk():
        return [Request(prompt_ids=_ids("pause me"), max_tokens=40,
                        temperature=0.0, stop=[stop]),
                Request(prompt_ids=_ids("pause me"), max_tokens=40,
                        temperature=0.9, seed=5, stop=[stop]),
                Request(prompt_ids=_ids("no stop here"), max_tokens=40,
                        temperature=0.0)]

    base = _run(Scheduler(_core(tiny, **PLAIN), TOK), mk())
    core = _core(tiny, decode_multistep=4, **PLAIN)
    suspect = core._stop_suspect
    blocks = []
    multi = core.decode_multi

    def recording(state, table, steps=None, m=None, **kw):
        state, out = multi(state, table, steps, m, **kw)
        blocks.append((kw["has_stop"].copy(), out, state.active.clone(),
                       suspect(kw["stops"]).clone()))
        return state, out

    core.decode_multi = recording
    fast = _run(Scheduler(core, TOK), mk())
    assert [r.output_ids for r in fast] == [r.output_ids for r in base]
    assert [_text(r) for r in fast] == [_text(r) for r in base]
    paused = 0
    for has_stop, out, active_after, table in blocks:
        rows = out["sampled"].shape[0]
        assert out["packed"].shape == (7, rows, core.batch)
        for s in np.flatnonzero(has_stop):
            em = out["emitted"][:, s].numpy()
            sus = table[out["sampled"][:, s].long()].numpy() & em
            if not sus.any():
                continue
            k = int(np.flatnonzero(sus)[0])
            assert not em[k + 1:].any(), "a suspect token did not pause"
            if k + 1 < rows and not out["done"][:, s].any():
                paused += 1
                assert active_after[s], "a paused slot lost its activation"
        # the slot without a stop is never paused
        free = np.flatnonzero(~has_stop & out["emitted"][0].numpy())
        for s in free:
            em = out["emitted"][:, s].numpy()
            assert em.all() or out["done"][:, s].any()
    assert paused >= 2


# ------------------------------------------------------------- preemption

@pytest.fixture
def late_copies(monkeypatch):
    """A device whose copies land one look late: a result is never ready
    the first time the host asks, so multi-step dispatches stay in flight
    into the next tick, when page pressure can find them."""
    done = HostCopy.done

    def late(self):
        if not getattr(self, "_asked", False):
            self._asked = True
            return False
        return done(self)

    monkeypatch.setattr(HostCopy, "done", late)


def test_preemption_with_multi_dispatches_in_flight(tiny, late_copies):
    kw = dict(PLAIN, decode_multistep=4)

    def mk():
        return [Request(prompt_ids=_ids("first request with a fairly long "
                                        "prompt here ok"),
                        max_tokens=24, temperature=0.0),
                Request(prompt_ids=_ids("second one"), max_tokens=24,
                        temperature=0.7, seed=9)]

    roomy = [r.output_ids for r in _run(Scheduler(_core(tiny, **kw), TOK),
                                        mk())]
    core = _core(tiny, num_pages=12, **kw)
    calls = _spy(core)
    sched = Scheduler(core, TOK)
    drained = []
    process = sched._process_decode

    def processing():
        drained.append(sched._inflight[0].positions)
        process()

    sched._process_decode = processing
    tight = [r.output_ids for r in _run(sched, mk())]
    assert sched.stats["preemptions"] > 0
    assert tight == roomy
    assert any(c[0] == "multi" for c in calls)
    assert max(drained) > 2     # a K·M block was in flight and drained


# ------------------------------------------------------ fetch amortization

def test_host_fetches_per_token_drop_4x(tiny):
    def fetches_per_token(core):
        sched = Scheduler(core, TOK)
        req = _run(sched, [Request(prompt_ids=_ids("amortize me"),
                                   max_tokens=96, temperature=0.0)])[0]
        assert req.completion_tokens == 96
        return sched.stats["host_fetches"] / req.completion_tokens

    off = fetches_per_token(_core(tiny, **PLAIN))
    on = fetches_per_token(_core(tiny, decode_multistep=8, **PLAIN))
    assert on <= off / 4.0, (off, on)


# ------------------------------------------------------------------ LoRA

def test_lora_rows_ride_decode_multi(tiny):
    cfg, jparams, tcfg, _ = tiny
    lcfg = jlora.LoraConfig(rank=4, alpha=8.0)

    def trained(seed):
        ad = jlora.init_adapters(jax.random.PRNGKey(seed), cfg, lcfg)
        return jax.tree.map(
            lambda x: x + 0.8 * jax.random.normal(
                jax.random.PRNGKey(seed + 100), x.shape, x.dtype), ad)

    jtrees = {"ad-a": trained(1), "ad-b": trained(2)}
    kw = dict(PLAIN, decode_multistep=8, prefix_cache="off")
    batch = [("the adapter determines", ""), ("the adapter determines",
                                              "ad-a"),
             ("route me to a fine-tune", "ad-b"),
             ("route me to a fine-tune", "ad-a")]

    def mk(make, **extra):
        return [make(prompt_ids=_ids(p), max_tokens=20,
                     temperature=0.8 if i % 2 else 0.0, seed=10 + i,
                     adapter=name, **extra)
                for i, (p, name) in enumerate(batch)]

    jcore = _jax_core(tiny, **kw)
    for name, tree in jtrees.items():
        jcore.register_adapter(name, tree)
    want = _jax_tokens(_run(_jax_sched(jcore),
                            mk(JaxRequest, logprobs=True)))
    core = _core(tiny, **kw)
    for name, tree in jtrees.items():
        core.register_adapter(name, lora.adapters_from_jax(
            jax.tree.map(np.asarray, tree), tcfg))
    passes = []
    multi = core.decode_multi

    def counting(state, table, steps=None, m=None, **k):
        before = core.lora_passes
        res = multi(state, table, steps, m, **k)
        passes.append(core.lora_passes - before)
        return res

    core.decode_multi = counting
    got = [r.output_ids for r in _run(Scheduler(core, TOK), mk(Request))]
    assert got == want
    assert passes and max(passes) > 0


# ------------------------------------------------------------- fallbacks

@pytest.mark.parametrize("fleet", ["grammar", "top_logprobs", "widened"])
def test_fleets_outside_the_eligibility_make_no_multi_call(tiny, fleet):
    kw = dict(PLAIN, decode_multistep=8)
    extra = {}
    if fleet == "grammar":
        extra = dict(grammar=grammar_mod.Grammar.from_schema(
            {"type": "string"}))
    elif fleet == "top_logprobs":
        extra = dict(logprobs=True, top_logprobs=2)
    else:
        kw.update(spec_decode="on", spec_adaptive="off")
    core = _core(tiny, **kw)
    calls = _spy(core)
    reqs = _run(Scheduler(core, TOK), [
        Request(prompt_ids=_ids(p), max_tokens=24, temperature=0.0, **extra)
        for p in ("a fleet that", "stays per-step")])
    assert calls and all(c[0] == "step" for c in calls)
    assert all(r.completion_tokens > 1 for r in reqs)


# ------------------------------------------------- mid-dispatch first tokens

def test_first_token_resolves_inside_a_multi_dispatch(tiny):
    kw = dict(PLAIN, decode_multistep=8, mixed_phase_dispatch="off",
              prefill_hold_chunks=0, prefix_cache="off")

    def late_stream(core, watch=False):
        sched = Scheduler(core, TOK)
        mids = []
        if watch:
            multi = core.decode_multi

            def watching(state, table, steps=None, m=None, **k):
                before = sched.stats["first_mid_dispatch"]
                res = multi(state, table, steps, m, **k)
                mids.append(sched.stats["first_mid_dispatch"] - before)
                return res

            core.decode_multi = watching
        first = sched.submit(Request(prompt_ids=_ids("a decoder that runs"),
                                     max_tokens=60, temperature=0.0))
        for _ in range(50):
            if sched.stats["decode_dispatches"]:
                break
            sched._tick()
        late = sched.submit(Request(prompt_ids=_ids("a late prompt"),
                                    max_tokens=12, temperature=0.2,
                                    top_p=0.7, seed=3))
        _run(sched, [])
        assert first.error is None and late.error is None
        assert first.finished_at and late.finished_at
        return (late.output_ids, first.output_ids), mids

    got, mids = late_stream(_core(tiny, **kw), watch=True)
    assert sum(mids) >= 1, "no first token resolved inside a multi dispatch"
    assert len(got[0]) == 12
    want, _ = late_stream(_core(tiny, **{**kw, "decode_multistep": 0}))
    assert got == want


# ------------------------------------------------------------ depth ladder

def test_depth_ladder_equals_the_reference_on_a_ramp(tiny):
    """``decode_steps_max=32`` over K = 2: dispatches deepen once the batch
    is half full and every budget covers the depth, and come back down near
    the end; every dispatch's depth equals the JAX ``Scheduler``'s."""
    kw = dict(PLAIN, decode_steps_max=32, pipeline_depth=1)

    def traffic(make, **extra):
        return [make(prompt_ids=_ids(p), max_tokens=n,
                     temperature=0.0 if n % 2 else 0.8, seed=n, **extra)
                for p, n in (("one", 80), ("two and two", 71),
                             ("three", 64), ("four four", 45))]

    jcore = _jax_core(tiny, **kw)
    jcalls = _spy(jcore)
    jreqs = _run(_jax_sched(jcore), traffic(JaxRequest, logprobs=True))
    core = _core(tiny, **kw)
    calls = _spy(core)
    sched = Scheduler(core, TOK)
    reqs = _run(sched, traffic(Request))
    assert [r.output_ids for r in reqs] == _jax_tokens(jreqs)
    assert calls == jcalls
    depths = {c[1] for c in calls}
    assert max(depths) >= 16 and 2 in depths
    for k in (2, 4, 8, 16, 32):
        assert sched.stats[f"decode_depth_{k}"] == calls.count(("step", k))


# ----------------------------------------------------------------- warmup

def test_warmup_visits_every_rung_and_keeps_the_stream(tiny):
    kw = dict(decode_steps_per_dispatch=2, decode_steps_max=8,
              decode_multistep=4)

    def run(warm):
        core = _core(tiny, **kw)
        seen = []
        decode, multi = core.decode, core.decode_multi
        core.decode = lambda state, table, steps=1, *a, **k: (
            seen.append(("step", steps, k.get("spec_width"),
                         k.get("width"))) or decode(state, table, steps, *a,
                                                    **k))
        core.decode_multi = lambda state, table, steps=None, m=None, **k: (
            seen.append(("multi", m)) or multi(state, table, steps, m, **k))
        if warm:
            assert core.warmup() > 0
        grid = list(seen)
        core.decode, core.decode_multi = decode, multi
        reqs = _run(Scheduler(core, TOK), _traffic(Request))
        return [r.output_ids for r in reqs], grid, core

    cold, _, _ = run(False)
    warm, grid, core = run(True)
    assert warm == cold
    want = {("step", d, w, b) for d in (2, 4, 8) for w in core.spec_widths
            for b in core.decode_widths}
    assert {g for g in grid if g[0] == "step"} == want
    assert [g for g in grid if g[0] == "multi"] == [("multi", 2),
                                                    ("multi", 4)]


# ---------------------------------------------------------- no read-back

def test_new_step_code_reads_nothing_back_from_the_device():
    """The multi-step dispatch and its planning read no device value on
    the host and never wait on a result copy: one copy a K·M block, taken
    by the in-flight queue."""
    fns = (EngineCore.decode_multi, EngineCore._stop_suspect,
           Scheduler._multi_plan, Scheduler._steps.fget,
           Scheduler._dispatch_decode)
    for fn in fns:
        src = inspect.getsource(fn)
        assert not re.search(
            r"\.(cpu|item|tolist|numpy|result|synchronize|query)\(", src), \
            fn.__qualname__
        assert "bool(" not in src, fn.__qualname__


# ------------------------------------------------------------- evacuation

def test_multistep_evacuation_resumes_token_identical(tiny, late_copies):
    """A slot evacuated mid-generation with multi-step dispatches in flight
    (a device whose copies land late keeps them in flight into the
    evacuation's tick) resumes via ``submit_prefilled`` on a peer, and the
    joined stream equals the unevacuated one, and the JAX
    ``Scheduler``'s."""
    kw = dict(PLAIN, decode_multistep=4)
    rkw = dict(max_tokens=20, temperature=0.7, seed=123)
    prompt = _ids("the quick brown fox jumps over")
    (ref,) = _run(Scheduler(_core(tiny, **kw), TOK),
                  [Request(prompt_ids=list(prompt), **rkw)])
    oracle = _text(ref)
    assert oracle
    (jref,) = _run(_jax_sched(_jax_core(tiny, **kw)),
                   [JaxRequest(prompt_ids=list(prompt), logprobs=True, **rkw)])
    assert ref.output_ids == _jax_tokens([jref])[0]

    src_core = _core(tiny, **kw)
    calls = _spy(src_core)
    src = Scheduler(src_core, TOK)
    r = Request(prompt_ids=list(prompt), **rkw)
    src.submit(r)
    for _ in range(4000):
        src._tick()
        if r.completion_tokens >= 4:
            break
        assert r.finished_at is None
    assert any(c[0] == "multi" for c in calls), \
        "evacuation raced nothing: multi-step never dispatched"
    assert any(d.positions > 2 for d in src._inflight), \
        "no multi-step block in flight at the evacuation"
    res = src.request_evacuation(wait_s=0.0)
    assert res.get("queued")
    for _ in range(50):
        src._tick()
        if not src._evac_reqs:
            break
    assert r.finish_reason == "evacuated" and r.error is None
    pre = _text(r)
    assert oracle.startswith(pre) and pre != oracle
    payload = src.take_evacuated(r.request_id)
    assert payload is not None
    peer = Scheduler(_core(tiny, **kw), TOK)
    rd = Request(prompt_ids=[int(t) for t in payload["prompt_ids"]], **rkw)
    peer.submit_prefilled(rd, dict(payload))
    for _ in range(4000):
        peer._tick()
        if rd.finished_at is not None:
            break
    assert rd.error is None, rd.error
    assert pre + _text(rd) == oracle
    assert rd.output_ids == ref.output_ids
